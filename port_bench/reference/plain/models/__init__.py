"""Gaussian model and environment map."""
