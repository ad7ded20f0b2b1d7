"""Durable training state: object stores and checkpoints."""
