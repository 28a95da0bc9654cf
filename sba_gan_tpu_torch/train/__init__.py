"""Inference over the generator."""
