"""Serving: the wave engine over the slot scheduler."""
