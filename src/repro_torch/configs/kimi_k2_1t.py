"""kimi-k2-1t-a32b [moe] — the JAX reference's stand-in for Kimi-K2: its
depth, width, experts and vocabulary (61L, d=7168, 384 experts of 2048,
top-8, vocab=163840) on grouped-query attention (64 heads, kv=8,
head_dim 112) with softmax routing and capacity-dropping dispatch, float
routed experts, copied field for field from the reference. It is not
Kimi-K2's published block (latent attention, a leading dense layer,
sigmoid noaux routing): that is `kimi_k2_instruct.py`. One full-width
layer's routed experts are 33.8 GB of bfloat16, so one card serves it
with its depth cut (``--layers 1``)."""
from repro_torch.configs.base import ModelConfig, MoeSpec
from repro_torch.models.api import register

CONFIG = register(ModelConfig(
    name="kimi-k2-1t-a32b", family="lm",
    n_layers=61, d_model=7168, n_heads=64, kv_heads=8, head_dim=112,
    d_ff=2048, vocab=163840, act="swiglu", norm="rmsnorm",
    moe=MoeSpec(n_experts=384, top_k=8, d_ff=2048, group_size=1024),
    param_dtype="bfloat16",
))


def smoke_config():
    return ModelConfig(
        name="kimi-smoke", family="lm",
        n_layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=64,
        vocab=128, act="swiglu", norm="rmsnorm",
        moe=MoeSpec(n_experts=8, top_k=2, d_ff=64, group_size=64),
        remat=False)
