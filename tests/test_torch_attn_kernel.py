"""The fused attention kernel (``csrc/attn.cu``) on the card, against
`nn/attention.py::_sdpa` (the oracle: the plain path every other call
takes) and against its own plain version, in bf16. Marked ``cuda``;
each test skips where torch sees no GPU (decided inside the fixture,
never at import). Run on a GPU machine with
``PYTHONPATH=src python -m pytest -m cuda tests/``.

Tolerance, |got - want| <= 2^-8 max|v| + 2^-7 |want|, from where the
two round: `_sdpa` rounds each normalised probability to bf16, the
kernel each unnormalised one (the sum divided out after the value
product), each within 2^-9 relative, so each term of the value sum may
move by 2^-8 of its weight and the sum by 2^-8 max|v|; both round the
output to bf16 (2^-9 |want| each, 2^-7 for two ulps at a rounding
boundary). The float32 score sums run in another order (about 1e-6 of a
score, far below both).
"""
import itertools

import pytest
import torch

from repro_torch.kernels import api as kapi
from repro_torch.kernels.attn import kernel as attn_k
from repro_torch.nn.attention import _mask_full, _sdpa, attn_core
from repro_torch.obs import trace as obs

pytestmark = pytest.mark.cuda

MODES = ("causal", "local", "bidir")
WIDTHS = ((16, 16), (64, 64), (96, 96), (112, 112), (128, 128),
          (192, 128), (256, 256))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _oracle(q, k, v, mode, window, scale=None):
    b, s = q.shape[:2]
    mask = _mask_full(s, k.shape[1], mode, window, q.device)
    return _sdpa(q, k, v, mask[None, None, None], scale).reshape(b, s, -1)


def _inputs(dev, b, s, t, hk, g, dh, dv, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, s, hk, g, dh), generator=gen, device=dev) * 2
    k = torch.randn((b, t, hk, dh), generator=gen, device=dev)
    v = torch.randn((b, t, hk, dv), generator=gen, device=dev)
    return (x.to(torch.bfloat16) for x in (q, k, v))


def _close(got, want, v):
    gap = (got.float() - want.float()).abs()
    bound = 2 ** -8 * v.float().abs().max() + 2 ** -7 * want.float().abs()
    return float((gap / bound).max())


def _check(q, k, v, mode, window, scale=None):
    got = attn_k.attention_fused_cuda(q, k, v, mode=mode, window=window,
                                      scale=scale)
    torch.cuda.synchronize()
    assert got.shape == (q.shape[0], q.shape[1],
                         q.shape[2] * q.shape[3] * v.shape[-1])
    assert torch.isfinite(got.float()).all()
    want = _oracle(q, k, v, mode, window, scale)
    plain = attn_k.attention_fused_torch(q, k, v, mode=mode, window=window,
                                         scale=scale)
    assert _close(got, want, v) <= 1.0
    assert _close(got, plain, v) <= 1.0


@pytest.mark.parametrize("s", [1, 17, 255, 2048])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("dh,dv", WIDTHS)
@pytest.mark.parametrize("mode", MODES)
def test_kernel_matches_sdpa(dev, mode, dh, dv, g, s):
    """Causal, a window shorter than T, and cross attention with S != T;
    lengths that do not fill a 128-row query tile or a key tile."""
    t = s if mode != "bidir" else s + 77
    window = max(1, s // 3) if mode == "local" else None
    b, hk = (1, 2) if s == 2048 else (2, 3)
    q, k, v = _inputs(dev, b, s, t, hk, g, dh, dv, seed=s * 7 + g + dh)
    _check(q, k, v, mode, window)


@pytest.mark.parametrize("mode", ["causal", "bidir"])
def test_kernel_reads_a_strided_v_and_a_scale(dev, mode):
    """MLA's shapes at a smaller length: v a strided view of the
    expansion's output (values after the 128 key columns), the scores
    scaled by a value other than Dh^-0.5."""
    b, s, h = 2, 300, 4
    gen = torch.Generator(device=dev).manual_seed(5)
    kv = torch.randn((b, s, h, 256), generator=gen,
                     device=dev).to(torch.bfloat16)
    v = kv[..., 128:]
    assert not v.is_contiguous()
    q = torch.randn((b, s, h, 1, 192), generator=gen,
                    device=dev).to(torch.bfloat16)
    k = torch.randn((b, s, h, 192), generator=gen,
                    device=dev).to(torch.bfloat16)
    _check(q, k, v, mode, None, scale=0.1234)


def test_kernel_raises_outside_its_domain(dev):
    q, k, v = _inputs(dev, 1, 16, 16, 2, 1, 64, 64, seed=1)
    with pytest.raises(ValueError, match="bf16"):
        attn_k.attention_fused_cuda(q.float(), k.float(), v.float(),
                                    mode="causal")
    with pytest.raises(ValueError, match="head widths"):
        attn_k.attention_fused_cuda(q[..., :20], k[..., :20], v,
                                    mode="causal")
    with pytest.raises(ValueError, match="keys"):
        attn_k.attention_fused_cuda(q, k[:, :8], v[:, :8], mode="local",
                                    window=4)
    with pytest.raises(ValueError, match="grad"):
        attn_k.attention_fused_cuda(q.requires_grad_(), k, v, mode="causal")


def test_attn_core_takes_the_kernel_on_the_card(dev):
    """bf16 on the card: the kernel, counted; float32 on the card and an
    input that requires grad: `_sdpa`, counted as plain."""
    q, k, v = _inputs(dev, 2, 64, 64, 2, 2, 96, 96, seed=3)
    before = attn_k.KERNEL.launches[attn_k.STAGES]
    with obs.enabled_scope():
        obs.reset()
        got = attn_core(q, k, v, mode="local", window=64)
        attn_core(q.float(), k.float(), v.float(), mode="local", window=64)
        attn_core(q.float().requires_grad_(), k.float(), v.float(),
                  mode="causal", window=None)
        counts = obs.counter_values()
    assert counts["attn.kernel_calls"] == 1
    assert counts["attn.plain_calls"] == 2
    assert attn_k.KERNEL.launches[attn_k.STAGES] == before + 1
    assert _close(got, _oracle(q, k, v, "local", 64), v) <= 1.0
    assert kapi.attention_takes(q, k, v)


@pytest.mark.parametrize("fault", ["odd_stride", "misaligned"])
def test_attn_core_raises_on_a_layout_the_kernel_refuses(dev, fault):
    """A bf16 call on the card that needs no grad is the kernel's by the
    dispatch; a layout the kernel refuses raises there and never runs
    `_sdpa` in its place."""
    q, k, _ = _inputs(dev, 1, 32, 32, 2, 1, 64, 64, seed=9)
    if fault == "odd_stride":
        v = torch.zeros((1, 32, 2, 68), dtype=torch.bfloat16,
                        device=dev)[..., :64]
        match = "strides"
    else:
        flat = torch.zeros(1 * 32 * 2 * 64 + 8, dtype=torch.bfloat16,
                           device=dev)
        v = flat[1:1 + 32 * 2 * 64].view(1, 32, 2, 64)
        match = "aligned"
    assert kapi.attention_takes(q, k, v)
    with obs.enabled_scope():
        obs.reset()
        with pytest.raises(ValueError, match=match):
            attn_core(q, k, v, mode="causal", window=None)
        counts = obs.counter_values()
    assert "attn.plain_calls" not in counts


def test_kernel_on_a_prefill_layer_shape(dev):
    """Phi-3-mini's layer (8 x 2048, 32 heads of 96, window 2047) and
    Kimi-K2's (64 heads of 192 / 128, causal), checked at two of the
    batch rows to keep the oracle's float32 scores small."""
    for (h, dh, dv, mode, window) in ((32, 96, 96, "local", 2047),
                                     (64, 192, 128, "causal", None)):
        q, k, v = _inputs(dev, 8, 2048, 2048, h, 1, dh, dv, seed=h)
        got = attn_k.attention_fused_cuda(q, k, v, mode=mode, window=window)
        for i in (0, 7):
            want = _oracle(q[i:i + 1], k[i:i + 1], v[i:i + 1], mode, window)
            assert _close(got[i:i + 1], want, v) <= 1.0


def test_every_instantiation_launches(dev):
    """Each (padded value width, key tile) of the kernel at a width that
    plans to it."""
    seen = set()
    for dh, dv in itertools.product((16, 64, 96, 192, 256),
                                    (16, 48, 64, 96, 112, 128, 160, 256)):
        plan = attn_k.attn_plan(dh, dv)
        if plan in seen:
            continue
        seen.add(plan)
        q, k, v = _inputs(dev, 1, 130, 130, 2, 2, dh, dv, seed=dh + dv)
        _check(q, k, v, "causal", None)
    assert seen == set(attn_k.ATTN_TILES)
