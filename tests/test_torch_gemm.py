"""The uniform packed GEMM at ragged shapes.

The port's `qdot` (the plain path, on CPU) against `repro.kernels.api.qdot`
with the `xla` and `eager_ref` backends over a wall of real K and N:
K in {1, 31, 33, 64, 200, 1000}, N in {1, 10, 17, 100, 128, 200, 384}.
Both sides take the same artifact (the reference packs seeded numpy
integers; the port takes its bytes unchanged). Integer outputs must be
identical and `dequant` bf16 bit for bit; `eager_ref` takes a scalar
scale only, so a per-channel scale goes against `xla`. Then the plain
version's `k_logical` and the kernel's launch planning (column tile, K
split, register budget), which run on the CPU too.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import api as r_api
from repro_torch.core import packing as p_pack
from repro_torch.core.quantize import QuantizedLinearParams as PParams
from repro_torch.kernels import api as p_api
from repro_torch.kernels.qmatmul import kernel as gk

from torch_bridge import assert_same

r_q = importlib.import_module("repro.core.quantize")
r_pack = importlib.import_module("repro.core.packing")

K_WALL = (1, 31, 33, 64, 200, 1000)
N_WALL = (1, 10, 17, 100, 128, 200, 384)
BITS = [(a, w) for a in (8, 4, 2) for w in (8, 4, 2)]
EPILOGUES = ("int", "raw", "dequant")
SCALE = 0.0123


def _ints(rng, bits, signed, shape):
    lo, hi = p_pack.int_range(bits, signed)
    return rng.integers(lo, hi + 1, size=shape).astype(np.int8)


def _artifact(rng, k, n, a_bits, w_bits):
    """(reference params, port params) of one seeded weight matrix."""
    w_packed = r_pack.pack(r_pack.pad_to_chunk(
        jnp.asarray(_ints(rng, w_bits, True, (k, n))), axis=0), w_bits,
        axis=0)
    vecs = {"kappa": rng.integers(-127, 128, n).astype(np.int32),
            "lam": rng.integers(-2**20, 2**20, n).astype(np.int32),
            "m": rng.integers(0, 2**15, n).astype(np.int32)}
    meta = dict(w_bits=w_bits, a_bits=a_bits, a_signed=False, d=23,
                out_bits=a_bits, k_logical=k)
    ref = r_q.QuantizedLinearParams(
        w_packed=w_packed, **{f: jnp.asarray(v) for f, v in vecs.items()},
        **meta)
    port = PParams(w_packed=torch.from_numpy(np.array(w_packed)),
                   **{f: torch.from_numpy(v) for f, v in vecs.items()},
                   **meta)
    return ref, port


@pytest.mark.parametrize("n", N_WALL)
@pytest.mark.parametrize("k", K_WALL)
def test_qdot_at_ragged_k_and_n_matches_reference(k, n):
    i = K_WALL.index(k) * len(N_WALL) + N_WALL.index(n)
    rng = np.random.default_rng(1000 + i)
    m = (1, 5, 9)[i % 3]
    # one weight width per case, at every activation width; the wall's
    # cases cycle through the widths
    for a_bits, w_bits in (BITS[i % 9], BITS[(i + 3) % 9],
                           BITS[(i + 6) % 9]):
        ref, port = _artifact(rng, k, n, a_bits, w_bits)
        x = _ints(rng, a_bits, False, (m, k))
        what = f"A{a_bits}W{w_bits} m={m} k={k} n={n}"
        for epilogue in EPILOGUES:
            out = p_api.qdot(port, torch.from_numpy(x), epilogue=epilogue,
                             scale=SCALE)
            assert out.shape == (m, n)
            for backend in ("xla", "eager_ref"):
                want = r_api.qdot(ref, jnp.asarray(x), epilogue=epilogue,
                                  scale=SCALE, backend=backend)
                assert_same(out, want, f"{backend} {epilogue} {what}")
    scale = rng.uniform(1e-3, 1e-1, n).astype(np.float32)
    out = p_api.qdot(port, torch.from_numpy(x), epilogue="dequant",
                     scale=torch.from_numpy(scale))
    assert_same(out, r_api.qdot(ref, jnp.asarray(x), epilogue="dequant",
                                scale=jnp.asarray(scale), backend="xla"),
                f"per-channel dequant {what}")


@pytest.mark.parametrize("k", K_WALL)
def test_plain_version_over_k_logical_equals_the_padded_k(k):
    rng = np.random.default_rng(k)
    n = 17
    vecs = [torch.from_numpy(v) for v in (
        rng.integers(-127, 128, n).astype(np.int32),
        rng.integers(-2**20, 2**20, n).astype(np.int32),
        rng.integers(0, 2**15, n).astype(np.int32))]
    for a_bits, w_bits in BITS:
        x = p_pack.pack(p_pack.pad_to_chunk(torch.from_numpy(
            _ints(rng, a_bits, False, (6, k)))), a_bits)
        w = p_pack.pack(p_pack.pad_to_chunk(torch.from_numpy(
            _ints(rng, w_bits, True, (k, n))), axis=0), w_bits, axis=0)
        for epilogue in EPILOGUES:
            kw = dict(a_bits=a_bits, a_signed=False, w_bits=w_bits, d=23,
                      out_bits=a_bits, epilogue=epilogue, scale=SCALE)
            full = gk.qmatmul_packed_torch(x, w, *vecs, **kw)
            assert_same(gk.qmatmul_packed_torch(x, w, *vecs, k_logical=k,
                                                **kw), full, epilogue)
            assert_same(gk.qmatmul_packed(x, w, *vecs, k_logical=k, **kw),
                        full, epilogue)
    k_pad = p_pack.padded_size(k)
    for bad in (0, k_pad + 1):
        with pytest.raises(ValueError, match="k_logical"):
            gk.qmatmul_packed_torch(x, w, *vecs, k_logical=bad, **kw)


def test_gemm_tile_is_n_rounded_up_to_a_wgmma_width():
    ns = (1, 10, 16, 17, 32, 33, 64, 65, 100, 128, 129, 200, 384)
    assert [gk.gemm_tile_n(n) for n in ns] == [16, 16, 16, 32, 32, 64, 64,
                                               128, 128, 128, 128, 128, 128]


# (M, N, k_logical, a_bits) -> (nt, tiles, stages, splits, min_blocks) on
# 132 SMs
PLANS = {
    # the ResNet-8 head at a wave: one tile, one stage
    (64, 10, 64, 8): (16, 1, 1, 1, 1),
    # the qat-cnn head: one tile, two stages, one per block
    (64, 10, 256, 8): (16, 1, 2, 2, 1),
    # 4096x1152x64: 32 tiles of 128 x 64, 9 stages in 5 blocks of <= 2
    (4096, 64, 1152, 8): (64, 32, 9, 5, 1),
    # fig8 256x2048x256: 4 tiles, a cluster of 8 blocks each, 2 stages
    # per block
    (256, 256, 2048, 8): (128, 4, 16, 8, 1),
    # 4096x2048x1024: 256 tiles fill the card; two blocks per SM at A8
    (4096, 1024, 2048, 8): (128, 256, 16, 1, 2),
    (4096, 1024, 2048, 4): (128, 256, 16, 1, 1),
    # 132 tiles, one per SM: no split, and no second block to overlap
    (128 * 132, 128, 1000, 8): (128, 132, 8, 1, 1),
    (1, 384, 1000, 2): (128, 3, 8, 8, 1),
    # the card wall's A8 grids wider than the card: two blocks per SM
    (4096, 1024, 200, 8): (128, 256, 2, 1, 2),
    (4100, 1000, 1000, 8): (128, 264, 8, 1, 2),
}


@pytest.mark.parametrize("shape", list(PLANS))
def test_gemm_launch_plan_per_grid(shape):
    m, n, k, a_bits = shape
    plan = gk.gemm_launch_plan(m, n, k, a_bits, 132)
    assert (plan.nt, plan.tiles, plan.stages, plan.splits,
            plan.min_blocks) == PLANS[shape]
    # every block of a split keeps at least one stage; a tile's blocks
    # fit one cluster
    per = -(-plan.stages // plan.splits)
    assert (plan.splits - 1) * per < plan.stages
    assert plan.splits <= gk.MAX_SPLITS


def test_gemm_launch_plan_overrides_are_checked():
    plan = gk.gemm_launch_plan(4096, 64, 1152, 8, 132, splits=1)
    assert plan.splits == 1 and plan.min_blocks == 1
    assert gk.gemm_launch_plan(64, 10, 256, 8, 132, splits=1).splits == 1
    assert gk.gemm_launch_plan(4096, 1024, 2048, 8, 132,
                               min_blocks=1).min_blocks == 1
    with pytest.raises(ValueError, match="splits"):
        gk.gemm_launch_plan(64, 10, 64, 8, 132, splits=2)
    with pytest.raises(ValueError, match="splits"):
        gk.gemm_launch_plan(64, 10, 64, 8, 132, splits=0)
    with pytest.raises(ValueError, match="splits"):
        gk.gemm_launch_plan(256, 256, 2048, 8, 132, splits=9)
    with pytest.raises(ValueError, match="min_blocks"):
        gk.gemm_launch_plan(64, 10, 64, 8, 132, min_blocks=2)
    with pytest.raises(ValueError, match="min_blocks"):
        gk.gemm_launch_plan(4096, 1024, 2048, 4, 132, min_blocks=2)
