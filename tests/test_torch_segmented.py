"""The port's fine-grain mixed-precision slice against the reference, on
the CPU: segment maps and segmented containers, `SegmentedLinearParams`,
`qdot` on segmented params (the mixed-operand GEMM's plain version), and
qat-cnn at full width served with a channel-group plan.

Every comparison is exact: packed bytes, descriptors, integer outputs,
and bf16 bit patterns for 'dequant'. The reference's mixed-operand Pallas
kernel runs under the interpreter in both pipeline modes; its `eager_ref`
backend takes a scalar scale only, so per-channel scales go against
`xla`.
"""
import importlib
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import packing as r_pack
from repro.deploy import policy as r_policy
from repro.kernels import api as r_api
from repro.vision import models as r_models
from repro.vision.configs import get_vision_config as r_config
from repro_torch import convert
from repro_torch.core import packing as p_pack
from repro_torch.core.quantize import \
    quantize_linear_segmented as p_quantize_seg
from repro_torch.deploy import policy as p_policy
from repro_torch.kernels import api as p_api
from repro_torch.kernels.qmatmul import kernel as p_gemm
from repro_torch.kernels.qmatmul.ref import qmatmul_segmented_ref
from repro_torch.nn.layers import QuantConfig
from repro_torch.vision import layers as p_vl
from repro_torch.vision import models as p_models
from repro_torch.vision.configs import get_vision_config as p_config

from torch_bridge import (assert_artifacts_equal, assert_same, neutral,
                          np_tree, port_segmented)

r_q = importlib.import_module("repro.core.quantize")
CHUNK = r_pack.CHUNK
MIXES = {"8|4": (8, 4), "8|2": (8, 2), "4|2": (4, 2), "8|4|2": (8, 4, 2)}
# ragged everywhere: M not a tile multiple, K not a CHUNK multiple, and N
# ends in a ragged tail panel (pad_segmented runs)
M, K, N = 33, 200, 300
SCALE = 0.0123
# qat-cnn c3's channel-group plan: half W8, half W4, every other layer W8
PLAN_A = ((0, 128, 8), (128, 256, 4))


def _random_segmap(rng, max_runs=4):
    """A valid map: interior runs CHUNK multiples wide, the final run
    ragged about half the time (the reference suite's generator)."""
    n_runs = int(rng.integers(1, max_runs + 1))
    runs, pos = [], 0
    for i in range(n_runs):
        width = int(rng.integers(1, 4)) * CHUNK
        if i == n_runs - 1 and rng.integers(0, 2):
            width = int(rng.integers(1, 2 * CHUNK))
        runs.append((pos, pos + width, int(rng.choice(r_pack.WIDTHS))))
        pos += width
    return tuple(runs)


def _values(rng, k, runs):
    """int8 values on each run's signed grid."""
    w = np.zeros((k, runs[-1][1]), np.int8)
    for s, e, b in runs:
        lo, hi = r_pack.int_range(b, True)
        w[:, s:e] = rng.integers(lo, hi + 1, size=(k, e - s))
    return w


def _mix_runs(widths, n):
    """One run per width: interior boundaries every CHUNK, ragged tail."""
    runs, pos = [], 0
    for i, b in enumerate(widths):
        end = n if i == len(widths) - 1 else pos + CHUNK
        runs.append((pos, end, b))
        pos = end
    return tuple(runs)


# ------------------------------------------------------------- packing ---

@pytest.mark.parametrize("seed", range(12))
def test_segment_map_and_packers_match_reference(seed):
    rng = np.random.default_rng(seed)
    runs = _random_segmap(rng)
    rmap, pmap = r_pack.SegmentMap(runs), p_pack.SegmentMap(runs)
    k = int(rng.integers(1, 3 * CHUNK))
    w = _values(rng, k, runs)
    assert pmap.runs == rmap.runs and pmap.n == rmap.n
    assert pmap.widths() == rmap.widths()
    assert pmap.run_lengths() == rmap.run_lengths()
    assert pmap.is_uniform == rmap.is_uniform
    assert pmap.packed_bytes(k) == rmap.packed_bytes(k)
    assert pmap.seg_offsets(k) == rmap.seg_offsets(k)
    buf = p_pack.pack_segmented(torch.from_numpy(w), pmap, assert_range=True)
    rbuf = r_pack.pack_segmented(jnp.asarray(w), rmap, assert_range=True)
    assert_same(buf, rbuf, "flat buffer")
    for i in range(len(runs)):
        assert_same(p_pack.segment_packed(buf, pmap, i, k),
                    r_pack.segment_packed(rbuf, rmap, i, k), f"run {i}")
    assert_same(p_pack.unpack_segmented(buf, pmap, k),
                r_pack.unpack_segmented(rbuf, rmap, k), "unpack")
    pbuf, pmap_p = p_pack.pad_segmented(buf, pmap, k)
    rbuf_p, rmap_p = r_pack.pad_segmented(rbuf, rmap, k)
    assert_same(pbuf, rbuf_p, "padded buffer")
    assert pmap_p.runs == rmap_p.runs
    for got, want in zip(pmap_p.tile_table(k), rmap_p.tile_table(k)):
        np.testing.assert_array_equal(got, want)
    obj = pmap.to_json_obj()
    assert obj == rmap.to_json_obj()
    assert p_pack.SegmentMap.from_json_obj(json.loads(json.dumps(obj))) \
        == pmap


@pytest.mark.parametrize("runs", [
    (),
    ((0, 128, 3),),
    ((0, 128, 8), (256, 384, 4)),
    ((0, 256, 8), (128, 384, 4)),
    ((0, 0, 8),),
    ((0, 128, 8), (128, 100, 4)),
    ((128, 256, 8),),
    ((0, 100, 8), (100, 256, 4)),
    ((0, 130, 8), (130, 256, 2)),
], ids=str)
def test_malformed_maps_raise_as_the_reference(runs):
    with pytest.raises(ValueError) as want:
        r_pack.SegmentMap(runs)
    with pytest.raises(ValueError) as got:
        p_pack.SegmentMap(runs)
    assert str(got.value) == str(want.value)


def test_packer_guards_match_reference():
    pmap = p_pack.SegmentMap(((0, 128, 8), (128, 256, 2)))
    with pytest.raises(ValueError, match="weight N=100"):
        p_pack.pack_segmented(torch.zeros((64, 100), dtype=torch.int8), pmap)
    w = torch.zeros((32, 256), dtype=torch.int8)
    w[0, 200] = 5                      # off the signed 2-bit grid
    with pytest.raises(ValueError, match="2-bit range"):
        p_pack.pack_segmented(w, pmap, assert_range=True)
    with pytest.raises(ValueError, match="pad the container"):
        p_pack.SegmentMap(((0, 128, 8), (128, 200, 4))).tile_table(64)
    # a single run is byte-identical to the uniform packer
    for bits in p_pack.WIDTHS:
        v = torch.from_numpy(_values(np.random.default_rng(bits), 70,
                                     ((0, 140, bits),)))
        one = p_pack.SegmentMap.uniform(140, bits)
        want = p_pack.pack(p_pack.pad_to_chunk(v, axis=0), bits, axis=0)
        assert torch.equal(p_pack.segment_packed(
            p_pack.pack_segmented(v, one), one, 0, 70), want)
    # QuantConfig and PlanRule validate segments through SegmentMap
    assert QuantConfig(segments=[[0, 128, 8], [128, 200, 4]]).segments == \
        ((0, 128, 8), (128, 200, 4))
    with pytest.raises(ValueError, match="interior boundary"):
        QuantConfig(segments=((0, 100, 8), (100, 200, 4)))
    with pytest.raises(ValueError, match="gap"):
        p_policy.PlanRule(pattern="c3", w_bits=8,
                          segments=((0, 128, 8), (256, 384, 4)))


# ------------------------------------------------- SegmentedLinearParams ---

def _ref_params(rng, widths, *, a_bits, a_signed=False, n=N, k=K):
    runs = _mix_runs(widths, n)
    w = _values(rng, k, runs)
    kappa = rng.integers(-127, 128, size=(n,)).astype(np.int32)
    lam = rng.integers(-2**18, 2**18, size=(n,)).astype(np.int32)
    m = rng.integers(0, 2**15, size=(n,)).astype(np.int32)
    ref = r_q.quantize_linear_segmented(
        jnp.asarray(w), r_pack.SegmentMap(runs), kappa, lam, m,
        a_bits=a_bits, a_signed=a_signed, d=18, out_bits=a_bits,
        assert_range=True)
    return ref, w, (kappa, lam, m)


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_quantize_linear_segmented_matches_reference(mix):
    rng = np.random.default_rng(len(mix))
    ref, w, (kappa, lam, m) = _ref_params(rng, MIXES[mix], a_bits=4)
    port = p_quantize_seg(torch.from_numpy(w),
                          p_pack.SegmentMap(ref.segmap.runs), kappa, lam, m,
                          a_bits=4, a_signed=False, d=18, out_bits=4,
                          assert_range=True)
    assert_artifacts_equal(port, ref, "segmented params")
    for i in range(len(ref.segmap.runs)):
        assert_artifacts_equal(port.segment_params(i),
                               ref.segment_params(i), f"segment {i}")
    # the reference's artifact carried across without re-packing
    assert_artifacts_equal(port_segmented(ref), ref, "bridged")


# -------------------------------------------------------- qdot (mixed) ---

def _x(rng, a_bits, m=M, k=K):
    hi = r_pack.int_range(a_bits, False)[1]
    return rng.integers(0, hi + 1, size=(m, k)).astype(np.int8)


@pytest.mark.parametrize("epilogue", ["int", "raw", "dequant"])
@pytest.mark.parametrize("a_bits", [8, 4, 2])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_qdot_mixed_matches_xla_and_eager(mix, a_bits, epilogue):
    rng = np.random.default_rng(a_bits * 7 + len(mix))
    ref, _, _ = _ref_params(rng, MIXES[mix], a_bits=a_bits)
    port, x = port_segmented(ref), _x(rng, a_bits)
    out = p_api.qdot(port, torch.from_numpy(x), epilogue=epilogue,
                     scale=SCALE)
    assert out.shape == (M, N)
    for backend in ("xla", "eager_ref"):
        want = r_api.qdot(ref, jnp.asarray(x), epilogue=epilogue,
                          scale=SCALE, backend=backend)
        assert_same(out, want, backend)


@pytest.mark.parametrize("pipeline", ["off", "double_buffer"])
@pytest.mark.parametrize("epilogue", ["int", "raw", "dequant"])
@pytest.mark.parametrize("a_bits", [8, 4, 2])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_qdot_mixed_matches_pallas_interpret(mix, a_bits, epilogue,
                                             pipeline):
    rng = np.random.default_rng(a_bits * 7 + len(mix))
    ref, _, _ = _ref_params(rng, MIXES[mix], a_bits=a_bits)
    port, x = port_segmented(ref), _x(rng, a_bits)
    out = p_api.qdot(port, torch.from_numpy(x), epilogue=epilogue,
                     scale=SCALE, pipeline=pipeline)
    want = r_api.qdot(ref, jnp.asarray(x), epilogue=epilogue, scale=SCALE,
                      backend="pallas_interpret", pipeline=pipeline)
    assert_same(out, want, pipeline)


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_qdot_mixed_per_channel_scale_and_signed_x_match_xla(mix):
    rng = np.random.default_rng(11)
    ref, _, _ = _ref_params(rng, MIXES[mix], a_bits=8, a_signed=True)
    port = port_segmented(ref)
    x = rng.integers(-127, 128, size=(2, 5, K)).astype(np.int8)
    scale = rng.uniform(1e-3, 1e-1, N).astype(np.float32)
    out = p_api.qdot(port, torch.from_numpy(x), epilogue="dequant",
                     scale=torch.from_numpy(scale))
    assert out.shape == (2, 5, N)
    assert_same(out, r_api.qdot(ref, jnp.asarray(x), epilogue="dequant",
                                scale=jnp.asarray(scale), backend="xla"),
                "per-channel dequant")
    for epilogue in ("int", "raw"):
        assert_same(p_api.qdot(port, torch.from_numpy(x), epilogue=epilogue),
                    r_api.qdot(ref, jnp.asarray(x), epilogue=epilogue,
                               backend="xla"), epilogue)


@pytest.mark.parametrize("a_bits", [8, 4, 2])
def test_plain_segmented_gemm_matches_numpy_oracle(a_bits):
    """The plain version reads the flat buffer through tile_table's
    descriptors; the oracle composes per-run uniform GEMMs."""
    rng = np.random.default_rng(a_bits)
    runs = ((0, 256, 2), (256, 384, 8), (384, 512, 4))
    pmap = p_pack.SegmentMap(runs)
    w = _values(rng, 384, runs)
    kappa, lam, m = (torch.from_numpy(v) for v in (
        rng.integers(-127, 128, 512).astype(np.int32),
        rng.integers(-2**18, 2**18, 512).astype(np.int32),
        rng.integers(0, 2**15, 512).astype(np.int32)))
    w_flat = p_pack.pack_segmented(torch.from_numpy(w), pmap)
    xp = p_pack.pack(torch.from_numpy(_x(rng, a_bits, 70, 384)), a_bits)
    for epilogue in ("int", "raw", "dequant"):
        kw = dict(k_logical=384, a_bits=a_bits, a_signed=False, d=20,
                  out_bits=a_bits, epilogue=epilogue, scale=SCALE)
        got = p_gemm.qmatmul_segmented(xp, w_flat, pmap, kappa, lam, m,
                                       **kw)
        want = qmatmul_segmented_ref(xp.numpy(), w_flat.numpy(), pmap,
                                     kappa.numpy(), lam.numpy(), m.numpy(),
                                     **kw)
        if epilogue == "dequant":
            want = torch.from_numpy(want).to(torch.bfloat16)
        assert_same(got, want, epilogue)
    with pytest.raises(ValueError, match="CHUNK multiple"):
        p_gemm.qmatmul_segmented_torch(
            xp, w_flat[:-1], p_pack.SegmentMap(((0, 500, 8),)), kappa, lam,
            m, k_logical=384, a_bits=a_bits, a_signed=False, d=20,
            out_bits=8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        p_gemm.qmatmul_segmented_cuda(xp, w_flat, pmap, kappa, lam, m,
                                      **kw)


# ------------------------------------------- qat-cnn, channel-group plan ---

def _plan_a(policy):
    return policy.PrecisionPlan(rules=(
        policy.PlanRule(pattern="c3", w_bits=8, segments=PLAN_A),))


@pytest.fixture(scope="module")
def qat():
    """qat-cnn at full width: reference and port nets under plan (a)."""
    rcfg, pcfg = r_config("qat-cnn"), p_config("qat-cnn")
    rng = np.random.default_rng(0)
    batches = [rng.uniform(0, 1, size=(4, 16, 16, 1)).astype(np.float32)
               for _ in range(2)]
    rfp = r_models.init_fp(rcfg, seed=0)
    absmax = r_models.collect_absmax(rcfg, rfp, batches)
    rq = r_models.quantize_net(rcfg, rfp, absmax, plan=_plan_a(r_policy))
    pq = p_models.quantize_net(
        pcfg, convert.fp_params_from_numpy(np_tree(rfp), "cpu"), absmax,
        plan=_plan_a(p_policy), device="cpu")
    images = rng.uniform(0, 1, size=(6, 16, 16, 1)).astype(np.float32)
    return dict(rq=rq, pq=pq, images=images)


def test_qat_cnn_plan_a_artifacts_byte_identical(qat):
    rq, pq = qat["rq"], qat["pq"]
    seg = [q for L, q in pq.qlayers if L.path == "c3"][0]
    assert isinstance(seg, p_vl.QSegmentedConv2D) and seg.runs == PLAN_A
    assert [p.conv.gemm.w_bits for p in seg.parts] == [8, 4]
    assert_artifacts_equal(pq.qlayers, rq.qlayers, "qlayers")
    assert pq.layer_bits() == rq.layer_bits() == {
        "c1": 8, "c2": 8, "c3": 8, "head": 8}
    assert (p_models.streamed_weight_bytes(pq)
            == r_models.streamed_weight_bytes(rq))
    assert (p_models.vision_artifact_bytes(pq)
            == r_models.vision_artifact_bytes(rq))


def test_qat_cnn_plan_a_logits_identical(qat):
    rq, pq = qat["rq"], qat["pq"]
    rx = r_models.quantize_input(rq, qat["images"])
    px = p_models.quantize_input(pq, qat["images"])
    r_edges, p_edges = {}, {}
    rl = r_models.forward_int(rq, rx, backend="xla",
                              collect=lambda k, v: r_edges.setdefault(k, v))
    pl = p_models.forward_int(pq, px,
                              collect=lambda k, v: p_edges.setdefault(k, v))
    for k in r_edges:
        assert_same(p_edges[k], r_edges[k], k)
    assert_same(pl, rl, "logits")
    # the reference's own net, carried across without re-quantizing
    bridged = convert.qnet_from_numpy(neutral(rq), "cpu")
    assert_artifacts_equal(bridged.qlayers, rq.qlayers, "bridged")
    assert_same(p_models.forward_int(bridged, px), rl, "bridged logits")


def test_segmented_plans_refuse_what_the_reference_refuses(qat):
    pcfg = p_config("qat-cnn", smoke=True)
    fp = p_models.init_fp(pcfg, 0, device="cpu")
    absmax = {k: 1.0 for k in ["__input__"] + [L.path for L in pcfg.layers]}
    head = p_policy.PrecisionPlan(rules=(p_policy.PlanRule(
        pattern="head", w_bits=8, segments=((0, 10, 8),)),))
    with pytest.raises(NotImplementedError, match="classifier head"):
        p_models.quantize_net(pcfg, fp, absmax, plan=head, device="cpu")
    bad = p_policy.PrecisionPlan(rules=(p_policy.PlanRule(
        pattern="c3", w_bits=8, segments=((0, 16, 8),)),))
    with pytest.raises(ValueError, match="do not tile"):
        p_models.quantize_net(pcfg, fp, absmax, plan=bad, device="cpu")
