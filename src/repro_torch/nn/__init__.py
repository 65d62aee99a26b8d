"""Layer settings shared by the quantized models."""
