"""phi3-mini-3.8b [dense] — RoPE SwiGLU GQA [arXiv:2404.14219].
32L, d=3072, 32H (kv=32), ff=8192, vocab=32064."""
from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import register

CONFIG = register(ModelConfig(
    name="phi3-mini-3.8b", family="lm",
    n_layers=32, d_model=3072, n_heads=32, kv_heads=32, d_ff=8192,
    vocab=32064, act="swiglu", norm="rmsnorm",
))


def smoke_config():
    return ModelConfig(
        name="phi3-smoke", family="lm",
        n_layers=2, d_model=64, n_heads=4, kv_heads=4, d_ff=128,
        vocab=128, act="swiglu", norm="rmsnorm", remat=False)
