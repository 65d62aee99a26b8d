"""`repro_torch.ckpt.checkpoint` against `repro.ckpt.checkpoint`: the same
files byte for byte, each package restoring the other's checkpoints, the
atomic rename, step listing and the asynchronous writer.

The reference cannot restore its own bfloat16 leaves under jax 0.9.0
(`np.load` gives raw ``|V2`` words, which `jnp.asarray` refuses); the
port reads the manifest's dtype and restores them bit for bit, and that
direction is held against the reference's files only.
"""
import json

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as r_ckpt
from repro_torch.ckpt import checkpoint as p_ckpt

from torch_bridge import assert_same

DTYPES = ["float32", "int8", "bfloat16"]


def _np_tree(dtype, seed=0):
    """A nested tree of numpy leaves in ``dtype`` (a 0-dim, a 1-dim and
    stacked leaves), from a seed."""
    rng = np.random.default_rng(seed)

    def leaf(*shape):
        if dtype == "int8":
            return rng.integers(-128, 128, size=shape).astype(np.int8)
        a = rng.normal(size=shape).astype(np.float32)
        return a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else a

    return {"params": {"embed": {"table": leaf(16, 8)},
                       "layers": {"attn": {"wq": {"w": leaf(2, 8, 8)}},
                                  "ln1": {"scale": leaf(2, 8)}}},
            "step": leaf()}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(tree.copy())


def _pairs(a, b, path=""):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), path
        for k in b:
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    else:
        yield path, a, b


def _files(d):
    return {str(f.relative_to(d)): f.read_bytes()
            for f in sorted(d.rglob("*")) if f.is_file()}


@pytest.mark.parametrize("dtype", DTYPES)
def test_round_trip(tmp_path, dtype):
    tree = _to_torch(_np_tree(dtype))
    final = p_ckpt.save(tmp_path, 7, tree)
    assert final == tmp_path / "step_00000007"
    got, step = p_ckpt.restore(tmp_path, device="cpu")
    assert step == 7
    for path, g, w in _pairs(got, tree):
        assert g.dtype == w.dtype and g.device.type == "cpu", path
        assert torch.equal(g, w), path


@pytest.mark.parametrize("dtype", DTYPES)
def test_files_byte_identical_to_reference(tmp_path, dtype):
    tree = _np_tree(dtype)
    r_ckpt.save(tmp_path / "ref", 3, tree)
    p_ckpt.save(tmp_path / "port", 3, _to_torch(tree))
    want, got = _files(tmp_path / "ref"), _files(tmp_path / "port")
    assert sorted(got) == sorted(want)
    for name, data in want.items():
        assert got[name] == data, name
    manifest = json.loads(want["step_00000003/manifest.json"])
    assert {m["dtype"] for m in manifest["leaves"].values()} == {dtype}


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_restores_reference_checkpoint(tmp_path, dtype):
    tree = _np_tree(dtype, seed=1)
    r_ckpt.save(tmp_path, 0, tree)
    got, step = p_ckpt.restore(tmp_path, device="cpu")
    assert step == 0
    for path, g, w in _pairs(got, tree):
        assert_same(g, w, path)
        assert str(g.dtype) == f"torch.{dtype}", path


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_reference_restores_port_checkpoint(tmp_path, dtype):
    tree = _np_tree(dtype, seed=2)
    p_ckpt.save(tmp_path, 5, _to_torch(tree))
    got, step = r_ckpt.restore(tmp_path)
    assert step == 5
    for path, g, w in _pairs(got, tree):
        assert isinstance(g, jnp.ndarray) and g.dtype == w.dtype, path
        np.testing.assert_array_equal(np.asarray(g), w, err_msg=path)


def test_reference_cannot_restore_its_own_bfloat16(tmp_path):
    """Why the port is not held against the reference's bfloat16
    restore: it raises on its own files."""
    r_ckpt.save(tmp_path, 0, _np_tree("bfloat16"))
    with pytest.raises(TypeError, match="V2"):
        r_ckpt.restore(tmp_path)


def test_save_is_atomic(tmp_path):
    tree = _to_torch(_np_tree("float32"))
    # a crashed writer's directory is neither listed nor restored
    (tmp_path / "step_00000009.tmp").mkdir(parents=True)
    (tmp_path / "step_00000009.tmp" / "junk.npy").write_bytes(b"x")
    assert p_ckpt.list_steps(tmp_path) == []
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        p_ckpt.restore(tmp_path, device="cpu")
    # the next save of that step clears it and renames into place
    p_ckpt.save(tmp_path, 9, tree)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000009"]
    assert not (tmp_path / "step_00000009" / "junk.npy").exists()
    # saving a step again replaces it whole
    p_ckpt.save(tmp_path, 9, {"only": torch.ones(2)})
    got, _ = p_ckpt.restore(tmp_path, 9, device="cpu")
    assert list(got) == ["only"]


def test_list_and_latest_step(tmp_path):
    assert p_ckpt.list_steps(tmp_path / "missing") == []
    assert p_ckpt.latest_step(tmp_path) is None
    for s in (10, 2, 30):
        p_ckpt.save(tmp_path, s, {"x": torch.full((2,), float(s))})
    (tmp_path / "step_00000040").mkdir()          # no manifest: not a step
    (tmp_path / "notes").mkdir()
    assert p_ckpt.list_steps(tmp_path) == [2, 10, 30]
    assert p_ckpt.latest_step(tmp_path) == 30
    got, step = p_ckpt.restore(tmp_path, device="cpu")
    assert step == 30 and torch.equal(got["x"], torch.full((2,), 30.0))
    got, step = p_ckpt.restore(tmp_path, 10, device="cpu")
    assert step == 10 and torch.equal(got["x"], torch.full((2,), 10.0))


def test_async_checkpointer_keeps_the_last_and_snapshots(tmp_path):
    ck = p_ckpt.AsyncCheckpointer(tmp_path, keep=2)
    x = torch.zeros(4)
    for s in range(4):
        x.fill_(float(s))
        ck.save_async(s, {"x": x})
        x.fill_(-1.0)                # written after the call: not saved
    ck.wait()
    assert ck._thread is None
    assert p_ckpt.list_steps(tmp_path) == [2, 3]
    for s in (2, 3):
        got, _ = p_ckpt.restore(tmp_path, s, device="cpu")
        assert torch.equal(got["x"], torch.full((4,), float(s)))


def test_async_checkpointer_surfaces_a_failed_write(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = p_ckpt.AsyncCheckpointer(blocker, keep=1)
    ck.save_async(0, {"x": torch.ones(2)})
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                        # the error is raised once
    assert ck._thread is None and ck.last_error is None


def test_async_checkpointer_matches_reference_files(tmp_path):
    tree = _np_tree("bfloat16", seed=4)
    ck = p_ckpt.AsyncCheckpointer(tmp_path / "port")
    ck.save_async(1, _to_torch(tree))
    ck.wait()
    r_ckpt.save(tmp_path / "ref", 1, tree)
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")


def test_restore_defaults_to_cuda_and_raises_without_it(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p_ckpt.save(tmp_path, 0, {"x": torch.ones(2)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_ckpt.restore(tmp_path)
