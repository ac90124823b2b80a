"""Utilities: train-state checkpoints."""
