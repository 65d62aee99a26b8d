"""The port's `qdot` (the `torch` backend, on CPU) against the reference.

Held against `repro.kernels.api.qdot` with the `xla` and `eager_ref`
backends and the Pallas kernels under the interpreter in both pipeline
modes (`pallas_interpret`, 'off' and 'double_buffer'). Integer outputs
must be identical; `dequant` must match bf16 bit for bit. `eager_ref`
takes a scalar scale only, so per-channel scales go against `xla`.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import api as r_api
from repro_torch.core import packing as p_pack
from repro_torch.core.quantize import QuantizedLinearParams as PParams
from repro_torch.kernels import api as p_api
from repro_torch.kernels.qmatmul.kernel import (gemm_launch_plan,
                                                qmatmul_packed,
                                                qmatmul_packed_cuda)

from torch_bridge import assert_artifacts_equal, assert_same

r_q = importlib.import_module("repro.core.quantize")
p_q = importlib.import_module("repro_torch.core.quantize")

# ragged everywhere: M spans several 64-row tiles, K two CHUNKs after
# padding (200 -> 256), N two 64-wide tiles plus a ragged edge
M, K, N = 70, 200, 140
SCALE = 0.0123


def _params(seed, a_bits, w_bits, n=N, k=K):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(k, n)).astype(np.float32)
    bn_s = (rng.normal(size=(n,)) * 0.2 + 0.6).astype(np.float32)
    bn_b = (rng.normal(size=(n,)) * 0.1).astype(np.float32)
    spec_w = r_q.QuantSpec.weight(w_bits, float(np.abs(w).max()))
    spec_x = r_q.QuantSpec.activation(a_bits, 1.0)
    spec_y = r_q.QuantSpec.activation(a_bits, 0.25)
    ref = r_q.quantize_linear(jnp.asarray(w), spec_w, bn_s, bn_b, spec_x,
                              spec_y)
    # the port's own pipeline, from the same floats: the same artifact
    port = p_q.quantize_linear(
        torch.from_numpy(w), p_q.QuantSpec(**dataclasses.asdict(spec_w)),
        bn_s, bn_b, p_q.QuantSpec(**dataclasses.asdict(spec_x)),
        p_q.QuantSpec(**dataclasses.asdict(spec_y)))
    assert isinstance(port, PParams)
    assert_artifacts_equal(port, ref, "quantize_linear")
    hi = p_pack.int_range(a_bits, False)[1]
    x = rng.integers(0, hi + 1, size=(M, k)).astype(np.int8)
    return ref, port, x


BITS = [(a, w) for a in (8, 4, 2) for w in (8, 4, 2)]


@pytest.mark.parametrize("epilogue", ["int", "raw", "dequant"])
@pytest.mark.parametrize("a_bits,w_bits", BITS)
def test_qdot_matches_xla_and_eager(a_bits, w_bits, epilogue):
    ref, port, x = _params(a_bits * 10 + w_bits, a_bits, w_bits)
    out = p_api.qdot(port, torch.from_numpy(x), epilogue=epilogue,
                     scale=SCALE)
    assert out.dtype == {"int": torch.int8, "raw": torch.int32,
                         "dequant": torch.bfloat16}[epilogue]
    for backend in ("xla", "eager_ref"):
        want = r_api.qdot(ref, jnp.asarray(x), epilogue=epilogue,
                          scale=SCALE, backend=backend)
        assert_same(out, want, backend)


@pytest.mark.parametrize("pipeline", ["off", "double_buffer"])
@pytest.mark.parametrize("epilogue", ["int", "raw", "dequant"])
@pytest.mark.parametrize("a_bits,w_bits", BITS)
def test_qdot_matches_pallas_interpret(a_bits, w_bits, epilogue, pipeline):
    ref, port, x = _params(a_bits * 10 + w_bits, a_bits, w_bits)
    out = p_api.qdot(port, torch.from_numpy(x), epilogue=epilogue,
                     scale=SCALE, pipeline=pipeline)
    # a (32, 128, 128) block gives the reference kernel 3x2x2 grid tiles
    want = r_api.qdot(ref, jnp.asarray(x), epilogue=epilogue, scale=SCALE,
                      backend="pallas_interpret", pipeline=pipeline,
                      block=(32, 128, 128))
    assert_same(out, want, pipeline)


@pytest.mark.parametrize("a_bits,w_bits", BITS)
def test_qdot_per_channel_dequant_scale_matches_xla(a_bits, w_bits):
    ref, port, x = _params(a_bits + w_bits, a_bits, w_bits)
    scale = np.random.default_rng(3).uniform(1e-3, 1e-1, N).astype(
        np.float32)
    out = p_api.qdot(port, torch.from_numpy(x), epilogue="dequant",
                     scale=torch.from_numpy(scale))
    want = r_api.qdot(ref, jnp.asarray(x), epilogue="dequant",
                      scale=jnp.asarray(scale), backend="xla")
    assert_same(out, want, "per-channel dequant")


def test_qdot_leading_dims_and_signed_activations():
    ref, port, _ = _params(7, 4, 4, n=10, k=64)
    rng = np.random.default_rng(8)
    x = rng.integers(-7, 8, size=(2, 3, 64)).astype(np.int8)
    ref = r_q.QuantizedLinearParams(**{**ref.__dict__, "a_signed": True})
    port = PParams(**{**port.__dict__, "a_signed": True})
    for epilogue in ("int", "raw"):
        out = p_api.qdot(port, torch.from_numpy(x), epilogue=epilogue)
        assert out.shape == (2, 3, 10)
        assert_same(out, r_api.qdot(ref, jnp.asarray(x), epilogue=epilogue,
                                    backend="xla"), epilogue)


def test_backend_resolution_is_tied_to_the_device(monkeypatch):
    """The wrappers dispatch on the tensor's device; a backend name from a
    plan or the CLI is only held against the device the net goes to."""
    _, port, x = _params(1, 8, 8, n=10, k=64)
    xt = torch.from_numpy(x[:, :64])
    assert p_api.BACKENDS == ("cuda", "torch")
    p_api.check_backend(None, "cpu")
    p_api.check_backend("torch", xt.device)
    p_api.check_backend("cuda", "cuda")
    with pytest.raises(ValueError, match="does not run on cpu"):
        p_api.check_backend("cuda", xt.device)
    with pytest.raises(ValueError, match="does not run on cuda"):
        p_api.check_backend("torch", "cuda")
    with pytest.raises(ValueError, match="port's backends"):
        p_api.check_backend("xla", "cpu")
    # a plan that names the other device's backend is refused at quantize
    from repro_torch.launch.vision import uniform_plan
    from repro_torch.vision import models
    from repro_torch.vision.configs import get_vision_config
    cfg = get_vision_config("resnet8", smoke=True)
    absmax = {k: 1.0 for k in ["__input__"] + [L.path for L in cfg.layers]}
    fp = models.init_fp(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="does not run on cpu"):
        models.quantize_net(cfg, fp, absmax, device="cpu",
                            plan=uniform_plan(cfg, 8, 8, backend="cuda"))
    models.quantize_net(cfg, fp, absmax, device="cpu",
                        plan=uniform_plan(cfg, 8, 8, backend="torch"))
    monkeypatch.setenv(p_api.ENV_PIPELINE, "triple")
    # the env-knob registry refuses the value (repro_torch.obs.env)
    with pytest.raises(ValueError, match="not a valid value"):
        p_api.qdot(port, xt)
    # an explicit pipeline shadows the environment
    p_api.qdot(port, xt, pipeline="off")
    assert p_api.resolve_pipeline("double_buffer") == "double_buffer"
    monkeypatch.delenv(p_api.ENV_PIPELINE)
    assert p_api.resolve_pipeline() == "off"


def test_kernel_wrapper_refuses_cpu_tensors_and_tile_fits():
    _, port, x = _params(2, 4, 2, n=10, k=64)
    xp = p_pack.pack(p_pack.pad_to_chunk(torch.from_numpy(x)), 4)
    args = (xp, port.w_packed, port.kappa, port.lam, port.m)
    kw = dict(a_bits=4, a_signed=False, w_bits=2, d=port.d, out_bits=4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        qmatmul_packed_cuda(*args, **kw)
    # the dispatching wrapper runs the plain version for CPU tensors, the
    # same for both pipelines and over the real K
    off = qmatmul_packed(*args, **kw)
    assert off.shape == (M, 10)
    assert_same(qmatmul_packed(*args, pipeline="double_buffer", **kw), off)
    assert_same(qmatmul_packed(*args, k_logical=64, **kw), off)
    # on the card this call is one 128 x 16 tile (N = 10 rounded up to a
    # wgmma width) with one stage of K = 64: no split
    plan = gemm_launch_plan(M, 10, 64, 4, 132)
    assert (plan.nt, plan.tiles, plan.stages, plan.splits) == (16, 1, 1, 1)
    with pytest.raises(ValueError, match="pipeline"):
        qmatmul_packed(*args, pipeline="triple", **kw)
