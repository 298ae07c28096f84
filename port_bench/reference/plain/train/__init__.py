"""Training: losses, per-group Adam and the training step."""
