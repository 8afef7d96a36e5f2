"""Plain references of the configurations and the training step."""
