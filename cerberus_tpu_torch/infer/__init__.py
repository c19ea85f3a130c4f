"""Inference: per-batch step, manager, tile engine."""
