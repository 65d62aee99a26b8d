"""The dry run on torch's ``meta`` device (`repro_torch.launch.dryrun`,
`costs`, `report`, `breakdown`, `launch.mesh.make_production_mesh`)
against the reference's cell list, parameter counts and cost-walker
contracts, and its per-position figures against real CPU placements.
"""
import dataclasses
import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import cells_for as r_cells_for
from repro.models import api as r_api
from repro.nn.module import param_count as r_param_count
from repro_torch.configs.base import ShapeConfig, cells_for
from repro_torch.core import packing
from repro_torch.kernels import api as kapi
from repro_torch.launch import breakdown, costs, dryrun, report
from repro_torch.launch import mesh as lmesh
from repro_torch.models import api as p_api
from repro_torch.nn.module import leaf_paths
from repro_torch.parallel import mesh as pm
from repro_torch.train import step as st

ARCHS = dryrun.dry_run_archs()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cells_match_the_reference():
    """The reference's matrix: 10 archs x 4 shapes, 7 long_500k skips;
    the port's one arch beyond them (kimi-k2-instruct) is not modelled."""
    assert ARCHS == r_api.list_archs()
    assert set(p_api.list_archs()) - set(ARCHS) == {"kimi-k2-instruct"}
    with pytest.raises(NotImplementedError, match="dry run"):
        dryrun.run_cell("kimi-k2-instruct", "prefill_32k", "pod",
                        save=False)
    for a in ARCHS:
        assert [s.name for s in cells_for(a)] == [
            s.name for s in r_cells_for(a)]
    n = sum(len(cells_for(a)) for a in ARCHS)
    assert n == 33 and 40 - n == 7


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_the_reference(arch):
    rm = r_api.build(r_api.get_config(arch))
    shapes = jax.eval_shape(rm.init, jax.ShapeDtypeStruct((2,), jnp.uint32))
    model = p_api.build(arch)
    assert sum(int(np.prod(d.shape)) for _, d in leaf_paths(model.defs())) \
        == r_param_count(shapes)


def test_active_params_match_the_reference():
    """`repro.launch.dryrun` forces 512 host devices through XLA_FLAGS at
    import; the flags are restored so nothing else in this process (or
    its children) sees them."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        r_dry = importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    for arch in ARCHS:
        assert dryrun.active_params(p_api.build(arch)) == pytest.approx(
            r_dry.active_params(r_api.build(r_api.get_config(arch))),
            rel=1e-12), arch


# ---------------------------------------------------------- the costs ---

def test_matmul_flops_exact():
    """`tests/test_hlo_costs.py::test_dot_flops_exact`'s contract."""
    m, k, n = 64, 128, 32
    a = torch.empty(m, k, device="meta")
    b = torch.empty(k, n, device="meta")
    with costs.Recorder(1) as rec:
        a @ b
    pc = rec.positions[0]
    assert pc.flops == 2 * m * k * n
    assert pc.io_bytes == 4 * (m * k + k * n + m * n)


def test_a_loop_of_matmuls_counts_each():
    """`test_scan_trip_count_multiplies`'s contract: 7 steps count 7x."""
    x = torch.empty(8, 64, device="meta")
    w = torch.empty(64, 64, device="meta")
    with costs.Recorder(1) as rec:
        for _ in range(7):
            x = torch.tanh(x @ w)
    assert rec.positions[0].flops == 7 * 2 * 8 * 64 * 64
    # the last step's input, product and tanh are live at once
    assert rec.positions[0].peak == 3 * 8 * 64 * 4


@pytest.mark.parametrize("w_bits", [8, 4, 2])
def test_a_packed_qdot_counts_once(w_bits):
    """One packed call: 2 x its MACs (K padded to CHUNK, as
    `obs.counters.qdot_costs`), its packed operands', vectors' and
    output's bytes, and none of its plain version's float64 GEMM."""
    from repro_torch.core.quantize import QuantizedLinearParams
    m, k, n = 16, 200, 96
    kp = packing.padded_size(k)
    w = QuantizedLinearParams(
        w_packed=torch.empty(kp // packing.pack_factor(w_bits), n,
                             dtype=torch.int8, device="meta"),
        kappa=torch.empty(n, dtype=torch.int32, device="meta"),
        lam=torch.empty(n, dtype=torch.int32, device="meta"),
        m=torch.empty(n, dtype=torch.int32, device="meta"),
        d=20, a_bits=8, w_bits=w_bits, out_bits=8, a_signed=False,
        k_logical=k)
    xp = torch.empty(m, kp, dtype=torch.int8, device="meta")
    with costs.Recorder(1, breakdown=True) as rec:
        kapi.qdot_packed(w, xp)
    pc = rec.positions[0]
    assert pc.int_ops == 2 * m * kp * n and pc.flops == 0
    assert pc.io_bytes == (m * kp + w.w_packed.numel() + 3 * 4 * n + m * n)
    assert set(rec.by_op) == {"packed.qmatmul"}


@pytest.mark.parametrize("grad", [False, True])
def test_the_sampled_recurrence_counts_as_the_loop(grad):
    """`nn.rglru._scan` under a recorder runs one step counted T times:
    the forward's IO and peak equal the loop's; the backward's IO within
    1% and its peak within 20% (the loop's first and last steps differ
    from the one sampled)."""
    from repro_torch.nn import rglru

    def run(fn):
        a = torch.empty(2, 32, 16, device="meta", requires_grad=grad)
        bx = torch.empty(2, 32, 16, device="meta", requires_grad=grad)
        rec = costs.Recorder(1)
        rec.own([a, bx], 0)
        with rec:
            h = fn(a, bx)
            if grad:
                torch.autograd.grad(h, (a, bx), torch.empty_like(h))
        return rec.positions[0]

    loop = run(rglru._scan)
    sampled = run(lambda a, bx: rglru._scan(a, bx))   # swapped inside
    if grad:
        assert sampled.io_bytes == pytest.approx(loop.io_bytes, rel=1e-2)
        assert sampled.peak == pytest.approx(loop.peak, rel=0.2)
    else:
        assert (sampled.io_bytes, sampled.peak) == (loop.io_bytes,
                                                    loop.peak)


# ----------------------------------------------- placements and blocks ---

SMOKE = "qwen2.5-3b"
MESHES = [((2, 4), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]


def _smoke(quant=None):
    cfg = p_api.get_smoke_config(SMOKE)
    if quant:
        cfg = dryrun.quant_config(cfg, quant, "decode_32k")
    return cfg, p_api.build(cfg)


def _real_argument(model, cfg, shape, mesh):
    """Per-position bytes of the inputs placed for real on a CPU mesh:
    `Model.place` / `place_cache` per block, `device_put` of the rows."""
    from repro_torch.deploy.apply import int_skeleton
    from repro_torch.parallel import tp
    n = mesh.size
    groups = [tp.TPGroup(mesh, b) for b in range(len(pm.data_blocks(mesh)))]
    shard = pm.NamedSharding(mesh, pm.P(pm.block_entry(mesh)))
    out = {}
    if shape.kind == "train":
        init, _, _ = st.make_train_fns(model, mesh, shape, device="cpu")
        state = init(0)
        out["state"] = [sum(t.nbytes for _, t in leaf_paths(state))
                        if p == 0 else 0 for p in range(n)]
        ins = st.input_shapes(model, shape)
        tokens = torch.zeros(ins["tokens"].shape, dtype=torch.int32)
        batch = pm.device_put(tokens, shard)
        out["batch"] = [2 * batch.shards[p].nbytes for p in range(n)]
        return out
    params = (model.init(0, device="cpu") if cfg.quant.mode == "off" else
              {k: v for k, v in _zeros(int_skeleton(model.defs())).items()})
    per = shape.global_batch // len(groups)
    out["params"] = [0] * n
    out["cache"] = [0] * n
    for g in groups:
        for key, tree in (("params", model.place(params, g)),
                          ("cache", model.place_cache(model.init_cache(
                              per, shape.seq_len, device="cpu"), g))):
            for _, leaf in leaf_paths(tree):
                if isinstance(leaf, tp.Split):
                    for i, t in enumerate(leaf.parts):
                        if t is not None:
                            out[key][g.positions[i]] += t.nbytes
                else:
                    out[key][g.positions[0]] += leaf.nbytes
    tok = pm.device_put(torch.zeros((shape.global_batch, 1),
                                    dtype=torch.int32), shard)
    out["batch"] = [tok.shards[p].nbytes for p in range(n)]
    return out


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=tree.dtype)


@pytest.mark.parametrize("kind", ["decode", "train"])
@pytest.mark.parametrize("shape_axes", MESHES, ids=["2x4", "2x2x2"])
def test_argument_bytes_equal_a_real_cpu_placement(shape_axes, kind):
    """The dry run's per-position argument, from meta placements, equals
    the bytes real CPU tensors take on a CPU mesh of the same shape."""
    cfg, model = _smoke("w4a8" if kind == "decode" else None)
    shape = ShapeConfig("s", 16, 8, kind)
    dims, axes = shape_axes
    meta = pm.make_mesh(dims, axes, "meta")
    cpu = pm.make_mesh(dims, axes, "cpu")
    tr = dryrun.trace_cell(model, cfg, shape, meta, all_blocks=True)
    assert tr["argument"] == _real_argument(model, cfg, shape, cpu)


def _figures(rec, positions):
    return [(pc.flops, pc.int_ops, pc.io_bytes, pc.peak, pc.sent,
             pc.received) for pc in (rec.positions[p] for p in positions)]


@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("shape_axes", MESHES, ids=["2x4", "2x2x2"])
def test_one_block_traces_as_all_blocks(shape_axes, kind):
    """Every data block has the same per-position shapes: tracing block 0
    alone gives the figures of block 0's positions in a trace of all,
    but for what position 0 adds as the controller: the concatenation of
    every block's output rows, and the per-device cached constants
    (`nn.layers.const`, `_freqs`) the other blocks read from it, on
    ``meta`` one device standing for all."""
    cfg, model = _smoke("w4a8")
    shape = ShapeConfig("s", 16, 8, kind)
    dims, axes = shape_axes
    mesh = pm.make_mesh(dims, axes, "meta")
    one = dryrun.trace_cell(model, cfg, shape, mesh)
    every = dryrun.trace_cell(model, cfg, shape, mesh, all_blocks=True)
    m = dims[-1]
    assert one["mesh"].size == m and one["rows"] == 8 // (mesh.size // m)
    assert _figures(one["recorder"], range(1, m)) == \
        _figures(every["recorder"], range(1, m))
    a, b = (tr["recorder"].positions[0] for tr in (one, every))
    assert (a.flops, a.int_ops) == (b.flops, b.int_ops)
    assert {k: v[:m] for k, v in every["argument"].items()} == \
        one["argument"]
    assert one["recorder"].positions[0].int_ops > 0


def test_a_decode_cell_runs_with_an_int_and_a_per_slot_index():
    cfg, model = _smoke()
    mesh = pm.make_mesh((1, 4), ("data", "model"), "meta")
    shape = ShapeConfig("d", 32, 4, "decode")
    ins = st.input_shapes(model, shape)
    assert ins["index"] == 31
    step, _ = st.make_decode_fns(model, mesh, shape)
    params = st.place_blocks(model, mesh, st._meta_tree(model.defs()))
    cache = st.place_blocks(model, mesh, ins["cache"], cache=True)
    figures = []
    for index in (31, torch.empty(4, dtype=torch.int64, device="meta")):
        with costs.Recorder(4) as rec:
            logits, _ = step(params, cache, ins["token"], index)
        assert logits.shape[:2] == (4, 1) and logits.is_meta
        figures.append(rec.positions[1].flops)
    assert figures[0] == figures[1] > 0


# ------------------------------------------------------ the CLIs, mesh ---

def test_dryrun_report_and_breakdown_on_a_pod_cell(tmp_path, capsys):
    """One full-config cell on the 16x16 pod, written to ``--out``; the
    report renders it and the breakdown prints its ops."""
    assert dryrun.main(["--arch", "mamba2-370m", "--shape", "decode_32k",
                        "--mesh", "pod", "--out", str(tmp_path)]) == 0
    text = capsys.readouterr().out
    assert "PASS mamba2-370m" in text and "dom=" in text
    rec = json.loads((tmp_path / "mamba2-370m__decode_32k__pod.json")
                     .read_text())
    assert rec["devices"] == 256 and rec["traced_blocks"] == 1
    assert rec["data_blocks"] == 16 and rec["rows_per_block"] == 8
    assert len(rec["per_position"]) == 16
    assert rec["bytes_per_device"]["total"] > 0
    assert rec["roofline"]["memory_s"] > 0
    rows = report.table("pod", out_dir=tmp_path).splitlines()
    assert len(rows) == 3 and rows[2].startswith("| mamba2-370m |")
    breakdown.main(["--arch", "mamba2-370m", "--shape", "decode_32k",
                    "--top", "5"])
    text = capsys.readouterr().out
    assert text.startswith("flops/dev ") and "packed." not in text
    assert len(text.splitlines()) == 3 + 5


def test_production_meshes_need_their_cards():
    pod, multi = (lmesh.make_production_mesh(multi_pod=f)
                  for f in (False, True))
    assert (pod.shape, pod.size) == ({"data": 16, "model": 16}, 256)
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert len(pm.data_blocks(multi)) == 32
    with pytest.raises(ValueError, match="needs 256 cuda devices"):
        lmesh.make_production_mesh(device="cuda")
    with pytest.raises(ValueError, match="needs 512 cpu devices"):
        lmesh.make_production_mesh(multi_pod=True, device="cpu")


def test_train_cli_on_a_pod_mesh_exits_without_its_cards():
    from repro_torch.launch import train
    with pytest.raises(SystemExit, match="needs 256 cpu devices"):
        train.main(["--arch", "olmo-1b", "--smoke", "--mesh", "pod",
                    "--device", "cpu"])
