"""Fused attention (attn_core's kernel)."""
