"""Captions and training data."""
