"""Entry points: the training loop."""
