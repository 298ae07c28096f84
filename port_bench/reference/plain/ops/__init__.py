"""Sampling ops."""
