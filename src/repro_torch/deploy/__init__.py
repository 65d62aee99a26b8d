"""Deployment plans (per-layer precision policy)."""
