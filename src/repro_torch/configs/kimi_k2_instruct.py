"""kimi-k2-instruct [moe, MLA] — Kimi-K2-Instruct as published
(https://huggingface.co/moonshotai/Kimi-K2-Instruct/blob/main/config.json),
the DeepSeek-V3 block (arXiv:2412.19437): 61 layers, d=7168, 64 heads of
multi-head latent attention (q_lora_rank 1536, kv_lora_rank 512, nope
128 + rope 64 against values of 128), rope theta 50,000 with YaRN
(factor 32 over 4,096 original positions, beta_fast = beta_slow = 1,
mscale = mscale_all_dim = 1); the first layer (first_k_dense_replace 1)
a dense SwiGLU of 18,432, the other 60 MoE layers of 384 routed experts
of 2,048, top-8 by sigmoid with a selection-only bias (noaux_tc, one
group), the weights renormalised and scaled by 2.827, plus one shared
expert of 2,048; rms_norm_eps 1e-6; vocab 163,840, untied head.

The experts are dispatched dropless and packed W4 per expert in int
mode. The config holds all 384 (``experts_held``); an expert-parallel
deployment sets its share (48 of 384 on each of 8 cards, from
``experts_offset``) and the layer computes that share's part of the
routed output."""
from repro_torch.configs.base import ModelConfig, MoeSpec, Yarn
from repro_torch.models.api import register

CONFIG = register(ModelConfig(
    name="kimi-k2-instruct", family="lm",
    n_layers=61, d_model=7168, n_heads=64, kv_heads=64, d_ff=2048,
    vocab=163840, act="swiglu", norm="rmsnorm", tie_embeddings=False,
    rope_theta=50000.0,
    rope_scaling=Yarn(factor=32.0, original_max_position=4096,
                      beta_fast=1.0, beta_slow=1.0, mscale=1.0,
                      mscale_all_dim=1.0),
    q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128,
    first_dense_layers=1, dense_d_ff=18432,
    moe=MoeSpec(n_experts=384, top_k=8, d_ff=2048, shared_expert=True,
                scoring="sigmoid_noaux", norm_topk=True, routed_scale=2.827,
                experts_held=384),
))


def smoke_config():
    return ModelConfig(
        name="kimi-instruct-smoke", family="lm",
        n_layers=3, d_model=64, n_heads=4, kv_heads=4, d_ff=32,
        vocab=128, act="swiglu", norm="rmsnorm", tie_embeddings=False,
        rope_theta=50000.0,
        rope_scaling=Yarn(factor=32.0, original_max_position=64,
                          beta_fast=1.0, beta_slow=1.0, mscale=1.0,
                          mscale_all_dim=1.0),
        q_lora_rank=48, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
        v_head_dim=16,
        first_dense_layers=1, dense_d_ff=96,
        moe=MoeSpec(n_experts=16, top_k=4, d_ff=32, shared_expert=True,
                    scoring="sigmoid_noaux", norm_topk=True,
                    routed_scale=2.827, experts_held=16),
        remat=False)
