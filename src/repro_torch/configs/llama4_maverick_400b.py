"""llama4-maverick-400b-a17b [moe] — 128 experts top-1 + shared expert,
early fusion [hf:meta-llama/Llama-4]. 48L, d=5120, 40H (kv=8), ff=8192
per expert, vocab=202048; plain GQA (full attention). One full-width
layer's routed experts are 32.2 GB of bfloat16, so one card serves it
with its depth cut (``--layers 1``)."""
from repro_torch.configs.base import ModelConfig, MoeSpec
from repro_torch.models.api import register

CONFIG = register(ModelConfig(
    name="llama4-maverick-400b-a17b", family="lm",
    n_layers=48, d_model=5120, n_heads=40, kv_heads=8, d_ff=8192,
    vocab=202048, act="swiglu", norm="rmsnorm",
    moe=MoeSpec(n_experts=128, top_k=1, d_ff=8192, group_size=1024),
    param_dtype="bfloat16",
))


def smoke_config():
    return ModelConfig(
        name="llama4-smoke", family="lm",
        n_layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=128,
        vocab=128, act="swiglu", norm="rmsnorm",
        moe=MoeSpec(n_experts=4, top_k=1, d_ff=128, group_size=64),
        remat=False)
