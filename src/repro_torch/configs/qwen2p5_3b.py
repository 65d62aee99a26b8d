"""qwen2.5-3b [dense] — GQA with QKV bias [hf:Qwen/Qwen2.5].
36L, d=2048, 16H (kv=2), ff=11008, vocab=151936."""
from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import register

CONFIG = register(ModelConfig(
    name="qwen2.5-3b", family="lm",
    n_layers=36, d_model=2048, n_heads=16, kv_heads=2, d_ff=11008,
    vocab=151936, act="swiglu", norm="rmsnorm", qkv_bias=True,
))


def smoke_config():
    return ModelConfig(
        name="qwen-smoke", family="lm",
        n_layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=128,
        vocab=128, act="swiglu", norm="rmsnorm", qkv_bias=True, remat=False)
