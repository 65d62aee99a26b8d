"""Observability: spans and counters (the subset the serving runtime uses)."""
