"""The fused attention kernel's CPU side: `attn_core`'s dispatch and its
counters, the kernel's domain and launch plan, its plain version against
`_sdpa`, and the binding and generated header the card build reads. The
kernel itself runs only on the card (`test_torch_attn_kernel.py`).

The plain version is held to `_sdpa` within the card tests' tolerance,
|got - want| <= 2^-8 max|v| + 2^-7 |want|: in bf16 the two round the
probabilities on either side of the division by their sum (each within
2^-9 relative, so the value sum moves by at most 2^-8 max|v|) and round
the output once each; in float32 nothing rounds to bf16, and they agree
to float32 rounding (1e-5 of values of order 1).
"""
import ctypes
import itertools
import os
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.kernels import api as kapi
from repro_torch.kernels.attn import kernel as attn_k
from repro_torch.models import api as model_api
from repro_torch.nn import attention as attn
from repro_torch.obs import trace as obs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("causal", "local", "bidir")
WIDTHS = ((16, 16), (24, 16), (64, 64), (96, 96), (112, 112), (128, 128),
          (192, 128), (256, 256))


def _inputs(b, s, t, hk, g, dh, dv, seed, dtype=torch.bfloat16):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((b, s, hk, g, dh), generator=gen) * 2
    k = torch.randn((b, t, hk, dh), generator=gen)
    v = torch.randn((b, t, hk, dv), generator=gen)
    return tuple(x.to(dtype) for x in (q, k, v))


def _oracle(q, k, v, mode, window, scale=None):
    b, s = q.shape[:2]
    mask = attn._mask_full(s, k.shape[1], mode, window, q.device)
    return attn._sdpa(q, k, v, mask[None, None, None],
                      scale).reshape(b, s, -1)


def _of_tolerance(got, want, v):
    gap = (got.float() - want.float()).abs()
    return float((gap / (2 ** -8 * v.float().abs().max()
                         + 2 ** -7 * want.float().abs())).max())


# --------------------------------------------------------- dispatch ---

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", MODES)
def test_attn_core_on_the_cpu_is_sdpa(mode, dtype):
    """Every CPU call runs `_sdpa` as before, bit for bit, and counts as
    plain."""
    q, k, v = _inputs(2, 9, 9 if mode != "bidir" else 13, 2, 3, 16, 16,
                      seed=1, dtype=dtype)
    window = 4 if mode == "local" else None
    with obs.enabled_scope():
        obs.reset()
        got = attn.attn_core(q, k, v, mode=mode, window=window)
        counts = obs.counter_values()
    assert torch.equal(got, _oracle(q, k, v, mode, window))
    assert counts.get("attn.plain_calls") == 1
    assert "attn.kernel_calls" not in counts


def test_refusal_names_every_reason():
    """The kernel refuses the CPU, float32 and an input that requires
    grad, each named; a bf16 CPU call is refused for its device alone."""
    q, k, v = _inputs(1, 8, 8, 2, 1, 64, 64, seed=2)
    why = attn_k.refusal(q, k, v, mode="causal")
    assert "CUDA" in why and "bf16" not in why and "grad" not in why
    why = attn_k.refusal(q.float(), k.float(), v.float(), mode="causal")
    assert "CUDA" in why and "bf16" in why
    why = attn_k.refusal(q.clone().requires_grad_(), k, v, mode="causal")
    assert "grad" in why
    assert not kapi.attention_takes(q, k, v)


def test_attn_core_keeps_sdpa_for_grad_and_float32():
    """Training through `attn_core` on the CPU: the gradient flows through
    `_sdpa`, and the call counts as plain."""
    q, k, v = _inputs(1, 6, 6, 1, 2, 16, 16, seed=3, dtype=torch.float32)
    q.requires_grad_()
    with obs.enabled_scope():
        obs.reset()
        attn.attn_core(q, k, v, mode="causal", window=None).sum().backward()
        counts = obs.counter_values()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    assert counts.get("attn.plain_calls") == 1


def test_counters_count_each_path(monkeypatch):
    """With the kernel's test forced true (its plain version standing in
    for the launch on the CPU), `attn_core` counts a kernel call and
    returns what `_sdpa` returns within tolerance; forced false, plain."""
    q, k, v = _inputs(2, 40, 40, 2, 2, 32, 32, seed=4)
    monkeypatch.setattr(kapi, "attention", attn_k.attention_fused_torch)
    with obs.enabled_scope():
        obs.reset()
        monkeypatch.setattr(kapi, "attention_takes", lambda *a: True)
        got = attn.attn_core(q, k, v, mode="local", window=9)
        monkeypatch.setattr(kapi, "attention_takes", lambda *a: False)
        attn.attn_core(q, k, v, mode="local", window=9)
        attn.attn_core(q, k, v, mode="causal", window=None)
        counts = obs.counter_values()
    assert counts["attn.kernel_calls"] == 1
    assert counts["attn.plain_calls"] == 2
    assert _of_tolerance(got, _oracle(q, k, v, "local", 9), v) <= 1.0


@pytest.mark.parametrize("dh,dv,takes", [
    (16, 16, True), (96, 96, True), (192, 128, True), (256, 256, True),
    (12, 16, False), (264, 64, False), (64, 0, False)])
def test_attention_takes_reads_the_head_widths(monkeypatch, dh, dv, takes):
    """Past device, dtype and grad (``is_cuda`` forced true here), the
    dispatch reads only whether the head widths have a plan: a layout
    the kernel refuses, such as an odd stride, is still the kernel's
    call, and raises there."""
    q, k, v = _inputs(1, 8, 8, 2, 1, dh, dh, seed=8)
    v = torch.zeros((1, 8, 2, dv + 1), dtype=torch.bfloat16)[..., :dv]
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda x: True))
    assert kapi.attention_takes(q, k, v) is takes
    assert not kapi.attention_takes(q.float(), k.float(), v.float())
    assert not kapi.attention_takes(q.clone().requires_grad_(), k, v)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "kimi-k2-instruct"])
def test_prefill_counts_one_attention_call_a_layer(arch):
    """A smoke-size prefill on the CPU: one plain `attn_core` call per
    layer (latent attention included), none on the kernel."""
    cfg = model_api.get_smoke_config(arch)
    model = model_api.build(cfg)
    params = model.init(seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 8),
                         generator=torch.Generator().manual_seed(0))
    with obs.enabled_scope():
        obs.reset()
        model.prefill(params, {"tokens": toks})
        counts = obs.counter_values()
    assert counts["attn.plain_calls"] == cfg.n_layers
    assert "attn.kernel_calls" not in counts


def test_modules_import_without_nvcc(tmp_path):
    """The kernel's module, the API and the attention layer import, and
    a CPU call runs, on a machine without nvcc: nothing builds at
    import."""
    code = ("import torch\n"
            "from repro_torch.kernels import build\n"
            "from repro_torch.kernels.attn import kernel as k\n"
            "from repro_torch.nn import attention\n"
            "try:\n"
            "    build.nvcc_path()\n"
            "    raise SystemExit('nvcc found')\n"
            "except RuntimeError:\n"
            "    pass\n"
            "q = torch.zeros(1, 4, 1, 1, 16)\n"
            "kv = torch.zeros(1, 4, 1, 16)\n"
            "attention.attn_core(q, kv, kv, mode='causal', window=None)\n"
            "assert k.KERNEL._fn is None\n"
            "print('ok')\n")
    env = dict(os.environ, PATH=str(tmp_path),
               CUDA_HOME=str(tmp_path / "no-cuda"),
               PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ------------------------------------------------ domain and plan ---

@pytest.mark.parametrize("dh,dv,plan", [
    (96, 96, (96, 128)), (192, 128, (128, 128)), (256, 256, (256, 64)),
    (24, 16, (32, 128)), (112, 112, (128, 128)), (64, 64, (64, 128)),
    (256, 96, (128, 64)), (16, 160, (192, 64)), (12, 16, None),
    (264, 64, None), (64, 0, None)])
def test_attn_plan(dh, dv, plan):
    """Phi-3 runs its values at 96 with 128-key tiles, Kimi its 192-wide
    scores against 128-wide values; widths outside multiples of 8 up to
    256 have no plan."""
    assert attn_k.attn_plan(dh, dv) == plan


def test_every_plan_fits_and_holds_its_widths():
    for dh, dv in itertools.product(range(8, 257, 8), repeat=2):
        dvp, bc = attn_k.attn_plan(dh, dv)
        assert dvp >= dv and (dvp, bc) in attn_k.ATTN_TILES
        assert attn_k.smem_bytes(dh, dvp, bc) <= attn_k.SMEM_MAX


def test_layout_refusal():
    q, k, v = _inputs(2, 16, 16, 2, 2, 64, 64, seed=5)
    assert attn_k.layout_refusal(q, k, v, mode="causal") is None
    assert attn_k.layout_refusal(q, k, v, mode="local", window=3) is None
    assert "window" in attn_k.layout_refusal(q, k, v, mode="local")
    assert "head widths" in attn_k.layout_refusal(
        q[..., :20], k[..., :20], v, mode="causal")
    assert "keys" in attn_k.layout_refusal(q, k[:, :8], v[:, :8],
                                           mode="causal")
    assert attn_k.layout_refusal(q, k[:, :8], v[:, :8], mode="bidir") is None
    assert "disagree" in attn_k.layout_refusal(q, k[:, :, :1], v,
                                               mode="causal")
    assert "strides" in attn_k.layout_refusal(
        q, k, v.transpose(1, 2).contiguous().transpose(1, 2)[..., ::2],
        mode="bidir")
    wide = torch.zeros((2, 16, 2, 68), dtype=torch.bfloat16)
    assert "strides" in attn_k.layout_refusal(q, k, wide[..., :64],
                                              mode="causal")
    flat = torch.zeros(v.numel() + 8, dtype=torch.bfloat16)
    shifted = flat[1:1 + v.numel()].view(v.shape)
    assert "aligned" in attn_k.layout_refusal(q, k, shifted, mode="causal")
    # a strided v as latent attention passes it: a view of wider rows
    kv = torch.zeros((2, 16, 2, 128), dtype=torch.bfloat16)
    assert attn_k.layout_refusal(q, k, kv[..., 64:], mode="causal") is None


# ------------------------------------------------- plain version ---

@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("dh,dv", WIDTHS)
@pytest.mark.parametrize("mode", MODES)
def test_plain_version_matches_sdpa_in_bf16(mode, dh, dv, g):
    for s in (1, 17, 130):
        t = s + 37 if mode == "bidir" else s
        window = max(1, s // 3) if mode == "local" else None
        q, k, v = _inputs(2, s, t, 2, g, dh, dv, seed=s + g + dh)
        got = attn_k.attention_fused_torch(q, k, v, mode=mode,
                                           window=window)
        assert got.dtype == torch.bfloat16
        assert _of_tolerance(got, _oracle(q, k, v, mode, window), v) <= 1.0


@pytest.mark.parametrize("mode", MODES)
def test_plain_version_is_sdpa_in_float32(mode):
    """Tile by tile with the online softmax is the same function: in
    float32 only rounding separates them; a scale and a strided v as
    latent attention passes them."""
    s, t = 150, 150 if mode != "bidir" else 190
    q, k, v = _inputs(2, s, t, 3, 2, 24, 32, seed=6, dtype=torch.float32)
    wide = torch.cat([v, v], dim=-1)[..., 32:]
    got = attn_k.attention_fused_torch(q, k, wide, mode=mode, window=40,
                                       scale=0.3)
    want = _oracle(q, k, wide, mode, 40, scale=0.3)
    assert float((got - want).abs().max()) < 1e-5


def test_api_attention_raises_on_the_cpu():
    """`kapi.attention` is the kernel alone: a CPU call raises, naming
    the device, and runs no plain version in its place."""
    q, k, v = _inputs(1, 20, 20, 2, 2, 16, 16, seed=7)
    with pytest.raises(ValueError, match="CUDA"):
        kapi.attention(q, k, v, mode="causal")


# ------------------------------------------------ build and binding ---

def test_ctypes_binding_matches_the_c_entry_point():
    """ctypes passes arguments past ``argtypes`` unconverted, so a
    missing entry would shift the stream pointer and crash the launch."""
    kernel = attn_k.KERNEL
    src = kernel.source.read_text()
    params = re.search(r'extern "C" int ' + kernel.entry + r"\((.*?)\)\s*\{",
                       src, re.S).group(1)
    ctype = {"int": ctypes.c_int, "float": ctypes.c_float,
             "long": ctypes.c_longlong}
    want = [ctypes.c_void_p if "*" in p else ctype[p.split()[-2]]
            for p in (q.strip() for q in params.split(","))]
    assert kernel.argtypes == want


def test_instantiations_match_the_plan_and_the_header():
    """attn.cu instantiates the (value width, key tile) pairs the plan
    chooses from, and the generated header has a wgmma for each width."""
    src = attn_k.KERNEL.source.read_text()
    body = re.search(r"#define RQ_FOR_EACH_TILE\(X\)(.*?)\n\n", src,
                     re.S).group(1)
    tiles = tuple((int(a), int(b))
                  for a, b in re.findall(r"X\((\d+), (\d+)\)", body))
    assert tiles == attn_k.ATTN_TILES
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import gen_wgmma_bf16 as gen
    finally:
        sys.path.pop(0)
    assert {bc for _, bc in tiles} <= set(gen.SS_WIDTHS)
    assert {dvp for dvp, _ in tiles} <= set(gen.RS_WIDTHS)
    assert gen.main(["--check"]) == 0
    assert "wgmma_bf16.cuh" in attn_k.KERNEL.headers


def test_library_name_follows_its_headers(tmp_path, monkeypatch):
    """An edit to a header the kernel includes names a new library; the
    integer kernels' names do not read the attention header."""
    from repro_torch.kernels import build
    from repro_torch.kernels.qmatmul.kernel import KERNEL as QMATMUL
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    assert "wgmma_bf16.cuh" not in QMATMUL.headers
    before = attn_k.KERNEL.library_path()
    assert before.parent == tmp_path and before.name.startswith("libattn-")
    assert QMATMUL.library_path().name.startswith("libqmatmul-")
    assert build.HEADERS == ("common.cuh", "mma_s8.cuh")
