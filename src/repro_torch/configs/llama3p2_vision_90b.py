"""llama-3.2-vision-90b [vlm] — cross-attn image layers
[hf:meta-llama/Llama-3.2-Vision]. 100L total = 80 self + 20 cross
(1 cross after every 4 self), d=8192, 64H (kv=8), ff=28672,
vocab=128256. Vision frontend stubbed (patch embeddings provided as
``src_embed``)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import register

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-90b", family="lm",
    n_layers=100, d_model=8192, n_heads=64, kv_heads=8, d_ff=28672,
    vocab=128256, act="swiglu", norm="rmsnorm",
    cross_every=4, src_len=4096, tie_embeddings=False,
    param_dtype="bfloat16",
))


def smoke_config():
    return ModelConfig(
        name="vision-smoke", family="lm",
        n_layers=5, d_model=64, n_heads=4, kv_heads=2, d_ff=128,
        vocab=128, act="swiglu", norm="rmsnorm",
        cross_every=4, src_len=16, tie_embeddings=False, remat=False)
