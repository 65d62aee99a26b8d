"""mamba2-370m [ssm] — SSD state-space duality [arXiv:2405.21060].
48L, d=1024, attn-free, ssm_state=128, vocab=50280."""
from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import register

CONFIG = register(ModelConfig(
    name="mamba2-370m", family="mamba",
    n_layers=48, d_model=1024, n_heads=0, kv_heads=0, d_ff=0,
    vocab=50280, norm="rmsnorm",
    d_state=128, d_conv=4, expand=2, headdim=64,
))


def smoke_config():
    return ModelConfig(
        name="mamba-smoke", family="mamba",
        n_layers=2, d_model=64, n_heads=0, kv_heads=0, d_ff=0,
        vocab=128, norm="rmsnorm",
        d_state=16, d_conv=4, expand=2, headdim=16, ssd_chunk=8,
        remat=False)
