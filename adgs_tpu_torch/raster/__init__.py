"""Rasterizer: preprocess, binning, compositing."""
