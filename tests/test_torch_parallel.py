"""The port's cluster path (`repro_torch.parallel`, `kernels.api.qdot` /
`qconv` with ``mesh=``) against the reference, on the CPU.

Port meshes repeat the ``cpu`` device at every position; the reference's
run on the eight host devices `tests/conftest.py` forces.

* sharding rules: `shard_spec_for`, `batch_sharding`, `params_shardings`,
  `cache_shardings`, `packed_linear_specs` / `packed_conv_specs` equal
  the reference's PartitionSpecs as tuples, over the mesh shapes of
  `tests/test_cluster.py::_mesh_shapes` and more;
* sharded `qdot` / `qconv` on every mesh layout at A{8,4,2} x W{8,4,2}
  equal the reference's **meshless** `eager_ref` integers exactly,
  ragged rows and batches, lead dims and presharded artifacts included;
  a per-channel dequant scale equals the reference's `xla` bf16 bits
  (its sharded path raises `ShardingTypeError` under jax 0.9.0 on ragged
  rows, lead dims and every conv, so the meshless results are the
  reference);
* the reference's refusals: segmented params on a mesh, N not divisible
  by tp;
* op counters of a sharded call equal the reference's;
* `ring_decode_attention`, `collective_matmul` and `pipeline_apply`
  against the reference's on its mesh (float; tolerances below);
* `attn_strategy` under an active mesh, `ckpt.restore` onto a mesh.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as r_pack
from repro.core.quantize import QuantizedLinearParams as RParams
from repro.kernels import api as r_api
from repro.nn import attention as r_attn
from repro.obs import counters as r_counters
from repro.obs import trace as r_obs
from repro.parallel import ctx as r_ctx
from repro.parallel import pipeline as r_pipe
from repro.parallel import ring as r_ring
from repro.parallel import sharding as r_sh
from repro_torch import convert
from repro_torch.ckpt import checkpoint as p_ckpt
from repro_torch.core import packing
from repro_torch.core.quantize import QuantizedLinearParams as PParams
from repro_torch.kernels import api
from repro_torch.kernels import tune
from repro_torch.kernels.qconv.ops import QuantizedConvParams
from repro_torch.launch import mesh as p_lmesh
from repro_torch.nn import attention as p_attn
from repro_torch.obs import counters as p_counters
from repro_torch.obs import trace as p_obs
from repro_torch.parallel import ctx as p_ctx
from repro_torch.parallel import mesh as pm
from repro_torch.parallel import pipeline as p_pipe
from repro_torch.parallel import ring as p_ring
from repro_torch.parallel import sharding as p_sh

from torch_bridge import assert_same, neutral

BITS = (8, 4, 2)
GRID = [(a, w) for a in BITS for w in BITS]
# every (data, model) layout of eight cores and fewer
LAYOUTS = [(1, 1), (8, 1), (1, 8), (2, 4), (4, 2), (2, 2), (4, 1), (1, 2)]
NDEV = len(jax.devices())


def _meshes(dp, tp):
    """(reference jax mesh, port mesh) of the same (data, model) shape."""
    r = jax.make_mesh((dp, tp), ("data", "model"),
                      devices=jax.devices()[:dp * tp])
    return r, pm.make_mesh((dp, tp), ("data", "model"), "cpu")


def _linear(rng, a_bits, w_bits, K=256, N=128):
    """The same random artifact in both packages."""
    lo, hi = r_pack.int_range(w_bits, True)
    w = rng.integers(lo, hi + 1, size=(K, N)).astype(np.int8)
    kappa = rng.integers(-64, 64, (N,)).astype(np.int32)
    lam = rng.integers(-2**16, 2**16, (N,)).astype(np.int32)
    m = rng.integers(0, 2**15, (N,)).astype(np.int32)
    common = dict(w_bits=w_bits, a_bits=a_bits, a_signed=False, d=18,
                  out_bits=8, k_logical=K)
    ref = RParams(w_packed=r_pack.pack(jnp.asarray(w), w_bits, axis=0),
                  kappa=jnp.asarray(kappa), lam=jnp.asarray(lam),
                  m=jnp.asarray(m), **common)
    port = PParams(w_packed=packing.pack(torch.from_numpy(w), w_bits,
                                         axis=0),
                   kappa=torch.from_numpy(kappa), lam=torch.from_numpy(lam),
                   m=torch.from_numpy(m), **common)
    return ref, port


def _acts(rng, a_bits, M=16, K=256):
    lo, hi = r_pack.int_range(a_bits, False)
    return rng.integers(lo, hi + 1, (M, K)).astype(np.int8)


def _conv(rng, a_bits, w_bits, cin=24, cout=32, batch=2, hw=8):
    """A reference conv artifact (the `tests/test_cluster.py` recipe),
    the port's copy of its bytes, and integer images."""
    import importlib

    from repro.core import calibrate_activation, calibrate_weight
    from repro.kernels.qconv import quantize_conv
    r_q = importlib.import_module("repro.core.quantize")

    x = np.maximum(rng.normal(size=(batch, hw, hw, cin)), 0).astype(
        np.float32)
    w = rng.normal(size=(3, 3, cin, cout)).astype(np.float32) * 0.08
    sw = calibrate_weight(jnp.asarray(w), w_bits)
    sx = calibrate_activation(x, a_bits, 100.0)
    sy = r_q.QuantSpec.activation(a_bits, 8.0)
    rq = quantize_conv(jnp.asarray(w), sw,
                       rng.normal(size=(cout,)).astype(np.float32) * .05
                       + .3, np.zeros((cout,), np.float32), sx, sy, 1, 1)
    pq = convert._build(neutral(rq), torch.device("cpu"))
    assert isinstance(pq, QuantizedConvParams)
    xq = np.asarray(r_q.quantize(jnp.asarray(x), sx))
    return rq, pq, xq


# ------------------------------------------------------ sharding rules ---

RULE_CASES = [((8, 16), ("batch", "mlp")), ((6, 10), ("batch", "heads")),
              ((4, 32, 8), ("batch", None, "kv_heads")),
              ((16,), ("vocab",)), ((64, 48), ("embed", "mlp")),
              ((3, 7), ("batch", "experts")),
              ((2, 128, 64), ("batch", "kv_seq", None)),
              ((8, 8), ("batch_full", None)), ((12, 4), ("layers", "seq"))]
MESH_SHAPES = [(NDEV, 1), (1, NDEV), (2, NDEV // 2), (2, 2), (4, 2)]


@pytest.mark.parametrize("dp,tp", MESH_SHAPES)
def test_spec_rules_equal_reference(dp, tp):
    rmesh, pmesh = _meshes(dp, tp)
    for shape, axes in RULE_CASES:
        assert tuple(p_sh.shard_spec_for(shape, axes, pmesh)) == tuple(
            r_sh.shard_spec_for(shape, axes, rmesh)), (shape, axes)
        assert tuple(p_sh.DEFAULT_RULES.spec(axes, pmesh)) == tuple(
            r_sh.DEFAULT_RULES.spec(axes, rmesh))
    for ndim, shape in ((1, None), (3, None), (2, (6, 5)), (2, (1, 4))):
        assert tuple(p_sh.batch_sharding(pmesh, ndim, shape=shape).spec) \
            == tuple(r_sh.batch_sharding(rmesh, ndim, shape=shape).spec)
    specs = {"a": ("embed", "mlp"), "b": {"c": ("vocab",)}}
    shapes = {"a": np.zeros((64, 48)), "b": {"c": np.zeros((10,))}}
    got = p_sh.params_shardings(specs, shapes, pmesh)
    want = r_sh.params_shardings(specs, shapes, rmesh)
    assert tuple(got["a"].spec) == tuple(want["a"].spec)
    assert tuple(got["b"]["c"].spec) == tuple(want["b"]["c"].spec)
    for axis in ("data", "model", "pod", None):
        assert p_sh.cluster_axis_size(pmesh, axis) == \
            r_sh.cluster_axis_size(rmesh, axis)
        assert p_sh.axis_entry(pmesh, axis) == r_sh.axis_entry(rmesh, axis)


@pytest.mark.parametrize("dp,tp", MESH_SHAPES)
def test_cache_shardings_equal_reference(dp, tp):
    rmesh, pmesh = _meshes(dp, tp)
    cache = {"kv": {"k": np.zeros((2, 8, 16, 4, 8)),
                    "v": np.zeros((2, 8, 16, 3, 8)),
                    "k_scale": np.zeros((2, 8, 16, 4))},
             "cross_kv": np.zeros((2, 2, 8, 12, 4, 8)),
             "ssm": {"ssm": np.zeros((3, 8, 4, 2, 16)),
                     "conv": np.zeros((3, 8, 3, 40))},
             "rec": {"h": np.zeros((3, 6, 5))}, "odd": np.zeros((2, 3))}
    got = p_sh.cache_shardings(cache, pmesh)
    want = r_sh.cache_shardings(cache, rmesh)
    flat_g = jax.tree.leaves(jax.tree.map(
        lambda s: tuple(s.spec), got, is_leaf=lambda s: isinstance(
            s, pm.NamedSharding)), is_leaf=lambda t: isinstance(t, tuple))
    flat_w = jax.tree.leaves(jax.tree.map(lambda s: tuple(s.spec), want),
                             is_leaf=lambda t: isinstance(t, tuple))
    assert flat_g == flat_w


@pytest.mark.parametrize("dp,tp", MESH_SHAPES)
def test_packed_specs_equal_reference(dp, tp, rng):
    rmesh, pmesh = _meshes(dp, tp)
    ref, port = _linear(rng, 8, 4)
    got = p_sh.packed_linear_specs(port, pmesh)
    want = r_sh.packed_linear_specs(ref, rmesh)
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}
    assert tuple(got["w_packed"])[0] is None      # never the packed K axis
    rq, pq, _ = _conv(rng, 8, 4)
    got = p_sh.packed_conv_specs(pq, pmesh)
    want = r_sh.packed_conv_specs(rq, rmesh)
    assert tuple(got["w_packed_fused"]) == tuple(want["w_packed_fused"])
    assert {k: tuple(v) for k, v in got["gemm"].items()} == \
        {k: tuple(v) for k, v in want["gemm"].items()}


def test_device_put_and_gather_round_trip(rng):
    mesh = pm.make_mesh((2, 4), ("data", "model"), "cpu")
    x = torch.from_numpy(rng.integers(-9, 9, (6, 8, 4)).astype(np.int32))
    for spec in (pm.P(), pm.P("data"), pm.P(None, "model"),
                 pm.P("data", "model"), pm.P(("data", "model")),
                 pm.P(None, ("model", "data"))):
        if spec == pm.P(("data", "model")):
            continue                 # 6 rows do not divide 8 positions
        s = pm.device_put(x, pm.NamedSharding(mesh, spec))
        assert len(s.shards) == 8 and s.shape == (6, 8, 4)
        assert torch.equal(pm.gather(s), x), spec
    with pytest.raises(ValueError, match="does not divide"):
        pm.device_put(x, pm.NamedSharding(mesh, pm.P(("data", "model"))))
    # every shard starts 16-byte aligned (the kernels' cp.async copies):
    # the second half of 10 int32 channels is a copy, not a view at +20
    v = torch.arange(10, dtype=torch.int32)
    halves = pm.device_put(v, pm.NamedSharding(
        pm.make_mesh((1, 2), ("data", "model")), pm.P("model")))
    for t in halves.shards:
        assert t.storage_offset() * t.element_size() % 16 == 0
    assert torch.equal(pm.gather(halves), v)
    # replicas on one device share one tensor
    s = pm.device_put(x, pm.NamedSharding(mesh, pm.P("data")))
    assert s.shards[0] is s.shards[3] and s.shards[0] is not s.shards[4]
    # a different sharding re-splits the gathered tensor
    t = pm.device_put(s, pm.NamedSharding(mesh, pm.P(None, "model")))
    assert torch.equal(pm.gather(t), x)
    assert tuple(p_lmesh.make_host_mesh(1, "cpu").shape.values()) == (1, 1)
    assert p_lmesh.parse_mesh("2,4", "cpu").describe() == "cpu x8"
    with pytest.raises(SystemExit):
        p_lmesh.parse_mesh("2x4", "cpu")


# --------------------------------------------------------- qdot / qconv ---

@pytest.mark.parametrize("a_bits,w_bits", GRID)
def test_qdot_sharded_equals_meshless_reference(a_bits, w_bits, rng):
    ref, port = _linear(rng, a_bits, w_bits)
    for m in (16, 13, 1):
        x = _acts(rng, a_bits, M=m)
        want = r_api.qdot(ref, jnp.asarray(x), backend="eager_ref")
        for dp, tp in LAYOUTS:
            mesh = pm.make_mesh((dp, tp), ("data", "model"), "cpu")
            assert_same(api.qdot(port, torch.from_numpy(x), mesh=mesh),
                        want, f"M={m} mesh=({dp},{tp})")
        pre = p_sh.shard_packed_linear(port, mesh)
        assert isinstance(pre.w_packed, pm.Sharded)
        assert_same(api.qdot(pre, torch.from_numpy(x), mesh=mesh), want,
                    f"presharded M={m}")


def test_qdot_sharded_lead_dims_and_scale(rng):
    ref, port = _linear(rng, 4, 4)
    x3 = _acts(rng, 4, M=12).reshape(3, 4, 256)
    scale = rng.uniform(0.5, 2.0, size=(128,)).astype(np.float32)
    want_int = r_api.qdot(ref, jnp.asarray(x3), backend="eager_ref")
    want_deq = r_api.qdot(ref, jnp.asarray(x3), backend="xla",
                          epilogue="dequant", scale=jnp.asarray(scale))
    for dp, tp in LAYOUTS:
        mesh = pm.make_mesh((dp, tp), ("data", "model"), "cpu")
        assert_same(api.qdot(port, torch.from_numpy(x3), mesh=mesh),
                    want_int, f"lead dims ({dp},{tp})")
        got = api.qdot(port, torch.from_numpy(x3), mesh=mesh,
                       epilogue="dequant", scale=torch.from_numpy(scale))
        assert got.shape == (3, 4, 128)
        assert_same(got, want_deq, f"per-channel scale ({dp},{tp})")
        got = api.qdot(port, torch.from_numpy(x3), mesh=mesh,
                       epilogue="raw")
        assert_same(got, r_api.qdot(ref, jnp.asarray(x3),
                                    backend="eager_ref", epilogue="raw"))


@pytest.mark.parametrize("a_bits,w_bits", GRID)
def test_qconv_sharded_equals_meshless_reference(a_bits, w_bits, rng):
    rq, pq, xq = _conv(rng, a_bits, w_bits, batch=3)
    want = r_api.qconv(rq, jnp.asarray(xq), backend="eager_ref")
    for dp, tp in LAYOUTS:
        mesh = pm.make_mesh((dp, tp), ("data", "model"), "cpu")
        assert_same(api.qconv(pq, torch.from_numpy(xq), mesh=mesh), want,
                    f"mesh=({dp},{tp})")
    mesh = pm.make_mesh((2, 4), ("data", "model"), "cpu")
    pre = p_sh.shard_packed_conv(pq, mesh)
    assert isinstance(pre.w_packed_fused, pm.Sharded)
    assert_same(api.qconv(pre, torch.from_numpy(xq), mesh=mesh), want,
                "presharded")
    # one image over four data blocks: three pad images, sliced back
    one = xq[:1]
    assert_same(api.qconv(pq, torch.from_numpy(one),
                          mesh=pm.make_mesh((4, 1), ("data", "model"))),
                r_api.qconv(rq, jnp.asarray(one), backend="eager_ref"),
                "ragged batch")


def test_refusals_match_reference(rng):
    from repro_torch.core.quantize import quantize_linear_segmented

    mesh = pm.make_mesh((1, 8), ("data", "model"), "cpu")
    rmesh, _ = _meshes(1, NDEV)
    ref, port = _linear(rng, 8, 8, N=130)
    x = torch.from_numpy(_acts(rng, 8))
    with pytest.raises(ValueError, match="not divisible"):
        p_sh.packed_linear_specs(port, mesh)
    with pytest.raises(ValueError, match="not divisible"):
        api.qdot(port, x, mesh=mesh)
    with pytest.raises(ValueError, match="not divisible"):
        r_sh.packed_linear_specs(ref, rmesh)
    _, pq, xq = _conv(rng, 8, 8, cout=20)
    with pytest.raises(ValueError, match="not divisible"):
        api.qconv(pq, torch.from_numpy(xq), mesh=mesh)
    seg = quantize_linear_segmented(
        torch.from_numpy(rng.integers(-7, 8, (256, 256)).astype(np.int8)),
        packing.SegmentMap(((0, 128, 8), (128, 256, 4))),
        torch.zeros(256, dtype=torch.int32),
        torch.zeros(256, dtype=torch.int32),
        torch.ones(256, dtype=torch.int32), a_bits=8, a_signed=False, d=16,
        out_bits=8)
    with pytest.raises(NotImplementedError, match="SegmentedLinearParams"):
        api.qdot(seg, x, mesh=mesh)
    with pytest.raises(ValueError, match="one device type"):
        pm.Mesh(["cpu", "meta"], ("data",))


def _renamed(snap):
    out = {}
    for k, v in snap.items():
        d = r_counters.parse_key(k)
        out[p_counters.key(d["op"], d["w_bits"], d["a_bits"], "torch",
                           d["pipeline"])] = v
    return out


@pytest.fixture
def _obs_clean():
    def clear():
        for o in (p_obs, r_obs):
            o.disable()
            o.reset()
        p_counters.reset()
        r_counters.reset()
        tune.clear()
    clear()
    yield
    clear()


def test_op_counters_of_a_sharded_call_equal_reference(rng, _obs_clean):
    """Counted once per call, at the global (row-padded) shape; the
    dispatch event carries the shard-local one."""
    ref, port = _linear(rng, 8, 4)
    x = _acts(rng, 8, M=16)
    rmesh, pmesh = _meshes(2, 2)
    with r_obs.enabled_scope():
        r_api.qdot(ref, jnp.asarray(x), mesh=rmesh)
    with p_obs.enabled_scope():
        api.qdot(port, torch.from_numpy(x), mesh=pmesh)
    assert p_counters.snapshot() == _renamed(r_counters.snapshot())
    (ev,) = p_obs.dispatch_log()
    (rev,) = r_obs.dispatch_log()
    assert ev["shape"] == rev["shape"] == (8, 256, 64)
    # the reference's sharded conv raises under jax 0.9.0; its sharded
    # count is its meshless count at the dp-padded batch
    r_counters.reset()
    p_counters.reset()
    rq, pq, xq = _conv(rng, 8, 8, batch=3)
    pad = np.concatenate([xq, np.zeros_like(xq[:1])])
    with r_obs.enabled_scope():
        r_api.qconv(rq, jnp.asarray(pad), backend="eager_ref")
    with p_obs.enabled_scope():
        api.qconv(pq, torch.from_numpy(xq),
                  mesh=pm.make_mesh((2, 2), ("data", "model")))
    assert p_counters.snapshot() == _renamed(r_counters.snapshot())


# ---------------------------------------------------- ring and pipeline ---

RING_TOL = dict(rtol=1e-5, atol=1e-6)   # float32, other summation orders


def test_ring_decode_attention_equals_reference():
    n = NDEV
    rng = np.random.default_rng(1)
    B, T, H, Dh = 2, 16 * n, 4, 32
    q = rng.normal(size=(B, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, T, H, Dh)).astype(np.float32)
    v = rng.normal(size=(B, T, H, Dh)).astype(np.float32)
    mask = np.arange(T)[None, :] < rng.integers(1, T, size=(B,))[:, None]
    rmesh, pmesh = _meshes(1, n)
    with r_ctx.use_mesh(rmesh):
        want = r_ring.ring_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(mask), rmesh)
    got = p_ring.ring_decode_attention(*(torch.from_numpy(a) for a in (
        q, k, v, mask)), pmesh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RING_TOL)
    # a shard with no valid key contributes zeros, not NaNs
    mask[:] = False
    mask[:, :3] = True
    got = p_ring.ring_decode_attention(*(torch.from_numpy(a) for a in (
        q, k, v, mask)), pmesh)
    assert torch.isfinite(got).all()
    with r_ctx.use_mesh(rmesh):
        want = r_ring.ring_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(mask), rmesh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RING_TOL)


@pytest.mark.parametrize("n", [NDEV, 2])
def test_collective_matmul_equals_reference(n):
    rng = np.random.default_rng(0)
    M, K, N = 16, 32 * n, 24 * n
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(K, N)).astype(np.float32)
    rmesh, pmesh = _meshes(1, n)
    with r_ctx.use_mesh(rmesh):
        want = r_ring.collective_matmul(jnp.asarray(x), jnp.asarray(w),
                                        rmesh)
    got = p_ring.collective_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                   pmesh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(got.numpy(), x @ w, rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("n_stages", [1, 2, 4])
def test_pipeline_apply_equals_reference(n_stages):
    rng = np.random.default_rng(0)
    L, d, n_micro, mb = 4 * n_stages, 16, 4, 3
    w = (rng.normal(size=(L, d, d)) * 0.3).astype(np.float32)
    x = rng.normal(size=(n_micro, mb, d)).astype(np.float32)

    def r_stage(sp, h):
        def body(h, wi):
            return jnp.tanh(h @ wi), None
        return jax.lax.scan(body, h, sp["w"])[0]

    def p_stage(sp, h):
        for wi in sp["w"]:
            h = torch.tanh(h @ wi)
        return h

    rmesh = jax.make_mesh((n_stages,), ("pod",),
                          devices=jax.devices()[:n_stages])
    pmesh = pm.make_mesh((n_stages,), ("pod",), "cpu")
    with r_ctx.use_mesh(rmesh):
        want = r_pipe.pipeline_apply(
            r_stage, r_pipe.stage_stack({"w": jnp.asarray(w)}, n_stages),
            jnp.asarray(x), rmesh)
    staged = p_pipe.stage_stack({"w": torch.from_numpy(w)}, n_stages)
    assert staged["w"].shape == (n_stages, 4, d, d)
    got = p_pipe.pipeline_apply(p_stage, staged, torch.from_numpy(x), pmesh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


# --------------------------------------------- attn_strategy, restore ---

@pytest.mark.parametrize("dp,tp", [(1, 1), (1, 2), (2, 4), (1, 8)])
def test_attn_strategy_equals_reference(dp, tp):
    rmesh, pmesh = _meshes(dp, tp)
    cases = [(8, 1, 16, 16), (2, 4, 16, 16), (1, 8, 1, 64), (3, 2, 5, 7),
             (1, 8, 6, 6), (2, 2, 1, 3)]
    assert p_attn.attn_strategy(8, 1, 4, 4) == "none"
    with r_ctx.activation_sharding(rmesh), p_ctx.use_mesh(pmesh):
        assert p_ctx.active_mesh() is pmesh
        for c in cases:
            assert p_attn.attn_strategy(*c) == r_attn.attn_strategy(*c), c
        x = torch.ones(2, 3)
        assert p_ctx.constrain(x, ("batch", None)) is x
        assert p_ctx.constrain_first(x, [("batch", "mlp")]) is x
    assert p_ctx.active_mesh() is None


def test_restore_onto_another_mesh(tmp_path, rng):
    tree = {"params": {"w": torch.from_numpy(
        rng.normal(size=(8, 16)).astype(np.float32)),
        "codes": torch.from_numpy(rng.integers(-8, 8, (4, 32)).astype(
            np.int8))}, "step": torch.tensor(3)}
    p_ckpt.save(tmp_path, 7, tree)          # saved meshless
    mesh = pm.make_mesh((2, 2), ("data", "model"), "cpu")
    shardings = {"params": {
        "w": pm.NamedSharding(mesh, pm.P("data", "model")),
        "codes": pm.NamedSharding(mesh, pm.P(None, ("data", "model")))},
        "step": pm.NamedSharding(mesh, pm.P())}
    got, step = p_ckpt.restore(tmp_path, shardings=shardings)
    assert step == 7
    for path in (("params", "w"), ("params", "codes"), ("step",)):
        a, b = got, tree
        for k in path:
            a, b = a[k], b[k]
        assert isinstance(a, pm.Sharded) and a.mesh == mesh
        assert torch.equal(pm.gather(a), b), path
    assert got["params"]["w"].local_shape() == (4, 8)
    # a mesh alone replicates every leaf, and another mesh takes the
    # same files
    other = pm.make_mesh((4, 1), ("data", "model"), "cpu")
    rep, _ = p_ckpt.restore(tmp_path, mesh=other)
    assert rep["params"]["codes"].local_shape() == (4, 32)
    assert torch.equal(pm.gather(rep["params"]["codes"]),
                       tree["params"]["codes"])
    # re-placing a restored leaf onto a third mesh
    third = pm.make_mesh((1, 8), ("data", "model"), "cpu")
    moved = pm.device_put(got["params"]["w"],
                          pm.NamedSharding(third, pm.P(None, "model")))
    assert torch.equal(pm.gather(moved), tree["params"]["w"])


def test_dataclass_replace_keeps_sharded_fields(rng):
    """A presharded artifact stays a plain dataclass of `Sharded` leaves
    (meshless code paths reject it instead of reading one shard)."""
    _, port = _linear(rng, 8, 8)
    mesh = pm.make_mesh((1, 4), ("data", "model"), "cpu")
    pre = p_sh.shard_packed_linear(port, mesh)
    assert dataclasses.replace(pre, d=pre.d).w_packed is pre.w_packed
    assert pre.w_packed.local_shape() == (256, 32)
    assert torch.equal(pm.gather(pre.kappa), port.kappa)
