"""Training utilities: checkpoints and metrics logging."""
