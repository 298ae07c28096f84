"""Core math: quaternions, spherical harmonics, covariance, camera, splines."""
