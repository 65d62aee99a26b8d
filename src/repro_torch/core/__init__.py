"""Storage and quantization formats (packing, eq. 1-4 algebra)."""
