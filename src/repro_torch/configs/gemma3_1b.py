"""gemma3-1b [dense] — 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt]. 26L, d=1152, 4H (GQA kv=1), head_dim=256,
ff=6912, vocab=262144; local window 512; dual rope theta (10k local /
1M global); gemma rmsnorm + scaled embeddings."""
from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import register

CONFIG = register(ModelConfig(
    name="gemma3-1b", family="lm",
    n_layers=26, d_model=1152, n_heads=4, kv_heads=1, head_dim=256,
    d_ff=6912, vocab=262144,
    act="geglu", norm="gemma_rmsnorm", scale_embed=True,
    window=512, pattern=("local",) * 5 + ("global",),
    rope_theta=1_000_000.0, rope_theta_local=10_000.0,
))


def smoke_config():
    return ModelConfig(
        name="gemma3-smoke", family="lm",
        n_layers=6, d_model=64, n_heads=4, kv_heads=1, head_dim=16,
        d_ff=128, vocab=128, act="geglu", norm="gemma_rmsnorm",
        scale_embed=True, window=8, pattern=("local",) * 5 + ("global",),
        rope_theta=1_000_000.0, rope_theta_local=10_000.0, remat=False)
