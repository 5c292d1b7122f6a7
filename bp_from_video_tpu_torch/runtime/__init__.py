"""The batched per-frame engine."""
