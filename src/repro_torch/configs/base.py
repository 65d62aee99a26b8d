"""Config dataclasses: model, shapes.

Every architecture file (``repro_torch/configs/<id>.py``) builds a
`ModelConfig` with its exact published numbers plus a reduced
``smoke_config()`` of the same family for CPU tests. The fields are the
reference's, so a reference config and the port's describe the same
model.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.deploy.policy import PrecisionPlan
from repro_torch.nn.layers import QOFF, QuantConfig, Yarn


@dataclasses.dataclass(frozen=True)
class MoeSpec:
    n_experts: int             # routed experts the router scores
    top_k: int
    d_ff: int                  # per-expert hidden
    capacity_factor: float = 1.25
    group_size: int = 1024
    shared_expert: bool = True
    # router: "softmax" (top-k of the softmax) | "sigmoid_noaux"
    # (DeepSeek-V3's noaux_tc: top-k of sigmoid + a selection-only bias,
    # the chosen sigmoids as weights)
    scoring: str = "softmax"
    norm_topk: bool = False    # chosen weights renormalised to sum 1
    routed_scale: float = 1.0  # routed_scaling_factor
    # expert parallelism's share: experts [offset, offset + held) live
    # here and run dropless, every choice of one computed; 0: the
    # reference's capacity-dropping dispatch over all n_experts
    experts_held: int = 0
    experts_offset: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # lm | encdec | mamba | griffin
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0          # 0 -> d_model // n_heads
    act: str = "swiglu"
    norm: str = "rmsnorm"      # rmsnorm|layernorm|nonparam_ln|gemma_rmsnorm
    qkv_bias: bool = False
    tie_embeddings: bool = True
    scale_embed: bool = False  # gemma family: embed * sqrt(d)
    rope_theta: float = 10000.0
    # sliding-window schedule: window size used on "local" layers; pattern
    # gives the repeating layer kinds, e.g. ("local",)*5 + ("global",) for
    # gemma3. Empty pattern -> all-global.
    window: int = 0
    pattern: Tuple[str, ...] = ()
    rope_theta_local: Optional[float] = None
    # MoE
    moe: Optional[MoeSpec] = None
    # leading dense layers of a MoE arch (first_k_dense_replace), each
    # with a dense FFN of width dense_d_ff, before the MoE layers
    first_dense_layers: int = 0
    dense_d_ff: int = 0
    # multi-head latent attention (DeepSeek-V3 / Kimi-K2) when
    # kv_lora_rank > 0: q and kv through low-rank latents, per-head
    # scores of qk_nope_dim + qk_rope_dim against values of v_head_dim
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # YaRN rope scaling (None: plain rope)
    rope_scaling: Optional[Yarn] = None
    # vision cross-attn: one cross layer after every `cross_every` self
    # layers; n_layers counts both kinds (llama-3.2-vision: 80 self + 20
    # cross)
    cross_every: int = 0
    # enc-dec
    enc_layers: int = 0
    dec_layers: int = 0
    # mamba
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    ssd_chunk: int = 256
    # griffin (recurrentgemma)
    lru_width: int = 0
    rnn_pattern: Tuple[str, ...] = ()
    # quantization (the paper's technique): `quant` is the uniform QuantConfig;
    # `quant_plan` overrides it per dense param path
    # (repro_torch/deploy/policy.py). Packed param shapes follow the
    # resolved bits.
    quant: QuantConfig = QOFF
    quant_plan: Optional[PrecisionPlan] = None
    kv_quant_bits: int = 16
    # training
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    # modality frontend stub (audio/vlm): src embeddings length
    src_len: int = 0

    @property
    def mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def head_dim_(self):
        return self.head_dim or (self.d_model // self.n_heads
                                 if self.n_heads else 0)

    def layer_kinds(self):
        """Expanded per-layer kind list for pattern-scheduled archs."""
        if not self.pattern:
            return ["global"] * self.n_layers
        reps = (self.n_layers + len(self.pattern) - 1) // len(self.pattern)
        return list((self.pattern * reps)[: self.n_layers])


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# archs whose attention is sub-quadratic enough for long_500k decode
# (SSM / hybrid / mostly-local); pure full-attention archs skip it
LONG_CONTEXT_OK = {"gemma3-1b", "recurrentgemma-9b", "mamba2-370m"}


def cells_for(arch_name: str):
    """The (arch x shape) cells this arch runs in the dry-run matrix."""
    return [s for s in SHAPES.values()
            if s.name != "long_500k" or arch_name in LONG_CONTEXT_OK]
