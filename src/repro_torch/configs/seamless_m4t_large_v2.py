"""seamless-m4t-large-v2 [audio] — enc-dec multimodal backbone
[arXiv:2308.11596; hf]. 24 encoder + 24 decoder layers (hf card per-stack
depth), d=1024, 16H (kv=16), ff=8192, vocab=256206. Audio frontend
stubbed: callers pass precomputed frame embeddings (``src_embed``)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import register

CONFIG = register(ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=48, enc_layers=24, dec_layers=24,
    d_model=1024, n_heads=16, kv_heads=16, d_ff=8192, vocab=256206,
    act="gelu", norm="layernorm", tie_embeddings=True, src_len=4096,
))


def smoke_config():
    return ModelConfig(
        name="seamless-smoke", family="encdec",
        n_layers=4, enc_layers=2, dec_layers=2,
        d_model=64, n_heads=4, kv_heads=4, d_ff=128, vocab=128,
        act="gelu", norm="layernorm", src_len=16, remat=False)
