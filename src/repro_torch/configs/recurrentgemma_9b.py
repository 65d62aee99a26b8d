"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2 rec : 1 attn
[arXiv:2402.19427]. 38L, d=4096, 16H (kv=1), ff=12288, vocab=256000,
local window 2048."""
from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import register

CONFIG = register(ModelConfig(
    name="recurrentgemma-9b", family="griffin",
    n_layers=38, d_model=4096, n_heads=16, kv_heads=1, head_dim=256,
    d_ff=12288, vocab=256000, act="geglu", norm="gemma_rmsnorm",
    scale_embed=True, window=2048, rnn_pattern=("rec", "rec", "attn"),
    lru_width=4096,
))


def smoke_config():
    return ModelConfig(
        name="rgemma-smoke", family="griffin",
        n_layers=8, d_model=64, n_heads=4, kv_heads=1, head_dim=16,
        d_ff=128, vocab=128, act="geglu", norm="gemma_rmsnorm",
        scale_embed=True, window=8, rnn_pattern=("rec", "rec", "attn"),
        lru_width=64, remat=False)
