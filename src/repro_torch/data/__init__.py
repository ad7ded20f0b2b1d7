"""The paper's preprocessing pipeline feeding the training loop."""
