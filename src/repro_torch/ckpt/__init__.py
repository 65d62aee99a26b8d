"""Checkpoints: one ``.npy`` per leaf plus a manifest, written atomically."""
