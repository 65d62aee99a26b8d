"""olmo-1b [dense] — non-parametric LayerNorm [arXiv:2402.00838; hf].
16L, d=2048, 16H (kv=16), ff=8192, vocab=50304."""
from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import register

CONFIG = register(ModelConfig(
    name="olmo-1b", family="lm",
    n_layers=16, d_model=2048, n_heads=16, kv_heads=16, d_ff=8192,
    vocab=50304, act="swiglu", norm="nonparam_ln",
))


def smoke_config():
    return ModelConfig(
        name="olmo-smoke", family="lm",
        n_layers=2, d_model=64, n_heads=4, kv_heads=4, d_ff=128,
        vocab=128, act="swiglu", norm="nonparam_ln", remat=False)
