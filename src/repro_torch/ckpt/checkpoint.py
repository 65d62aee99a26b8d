"""Atomic checkpoints of a tree of tensors, in the reference's format.

Layout:  <dir>/step_<N:08d>/
            manifest.json      — step, and per leaf its file, shape, dtype
            <leaf-path>.npy    — one file per leaf ("/" in the path -> "__")

Writes go to ``step_<N:08d>.tmp/``, which is renamed when complete, so a
crashed writer never leaves a directory that `list_steps` counts.
`AsyncCheckpointer.save_async` copies the leaves to the host on the call
and writes the files on a worker thread.

The files are the reference's byte for byte, so each package restores
the other's checkpoints. A bfloat16 leaf is written as the reference's
ml_dtypes arrays are, with the header ``'descr': '<V2'`` and the
manifest's ``"dtype": "bfloat16"``; `restore` reads that dtype and
reinterprets the 2-byte words as ``torch.bfloat16`` (numpy alone loads
them as raw ``|V2`` bytes).

The files hold global arrays, so any mesh can take them: `restore`
with ``shardings=`` (a tree of `NamedSharding` like the checkpoint's, or
one for every leaf) or ``mesh=`` (every leaf replicated on it) places
each leaf as a `repro_torch.parallel.mesh.Sharded`, on a mesh other than
the one that saved if need be (the reference's elastic restore).
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.parallel.mesh import NamedSharding, P, device_put

# the 2-byte header descr the reference's ml_dtypes bfloat16 arrays carry
_BF16_DESCR = "<V2"


def _flatten(tree, path=()):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree.keys()):
            out.extend(_flatten(tree[k], path + (str(k),)))
        return out
    return [(path, tree)]


def _unflatten(leaves: dict):
    out: dict = {}
    for path, value in leaves.items():
        d = out
        parts = path.split("/")
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = value
    return out


def _host(leaf, copy: bool = False):
    """A leaf on the host: a numpy array, or a CPU bfloat16 tensor (numpy
    has no bfloat16). ``copy`` snapshots CPU data the caller may still
    write."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        elif copy:
            t = t.clone()
        t = t.contiguous()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return np.array(leaf, copy=copy) if copy else np.asarray(leaf)


def _write_leaf(path: pathlib.Path, arr) -> tuple:
    """Write one host leaf as ``.npy``; returns (shape, dtype name)."""
    if isinstance(arr, torch.Tensor):        # bfloat16
        shape = tuple(arr.shape)
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(f, {
                "descr": _BF16_DESCR, "fortran_order": False,
                "shape": shape})
            f.write(arr.view(torch.int16).numpy().tobytes())
        return shape, "bfloat16"
    np.save(path, arr)
    return arr.shape, str(arr.dtype)


def save(ckpt_dir, step: int, tree) -> pathlib.Path:
    """Synchronous atomic save of a tree (nested dicts) of tensors or
    arrays; device tensors are copied to the host first."""
    return _save_host(ckpt_dir, step, [(p, _host(leaf))
                                       for p, leaf in _flatten(tree)])


def _save_host(ckpt_dir, step: int, leaves) -> pathlib.Path:
    ckpt_dir = pathlib.Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "leaves": {}}
    for path, arr in leaves:
        key = "/".join(path)
        fname = key.replace("/", "__") + ".npy"
        shape, dtype = _write_leaf(tmp / fname, arr)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(shape), "dtype": dtype}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


class AsyncCheckpointer:
    """Overlap checkpoint I/O with the caller: the copy to the host
    happens on the call (blocking), the file writes on a worker thread.
    A failed write is raised by the next `wait` (or `save_async`).
    After `wait`, ``last_save`` holds the last save's step, bytes and
    seconds of host copy and of file writes."""

    def __init__(self, ckpt_dir, keep: int = 3):
        self.ckpt_dir = pathlib.Path(ckpt_dir)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None
        self.last_save: Optional[dict] = None

    def save_async(self, step: int, tree) -> None:
        self.wait()
        t0 = time.perf_counter()
        leaves = [(p, _host(leaf, copy=True)) for p, leaf in _flatten(tree)]
        copy_s = time.perf_counter() - t0

        def _work():
            try:
                t1 = time.perf_counter()
                _save_host(self.ckpt_dir, step, leaves)
                self.last_save = {
                    "step": step, "copy_s": copy_s,
                    "write_s": time.perf_counter() - t1,
                    "bytes": sum(a.numel() * a.element_size()
                                 if isinstance(a, torch.Tensor) else a.nbytes
                                 for _, a in leaves)}
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self.last_error = e

        self._thread = threading.Thread(target=_work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(list_steps(self.ckpt_dir))
        for s in steps[: -self.keep]:
            shutil.rmtree(self.ckpt_dir / f"step_{s:08d}",
                          ignore_errors=True)


def list_steps(ckpt_dir) -> list:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    out = []
    for p in ckpt_dir.iterdir():
        if p.is_dir() and p.name.startswith("step_") and \
                (p / "manifest.json").exists():
            out.append(int(p.name[5:]))
    return sorted(out)


def latest_step(ckpt_dir) -> Optional[int]:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _read_leaf(path: pathlib.Path, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir, step: Optional[int] = None, device="cuda",
            shardings=None, mesh=None):
    """Load a checkpoint (the latest step by default) as a tree of
    tensors on ``device``; returns (tree, step). With ``shardings`` or
    ``mesh`` each leaf is read on the CPU and placed on the mesh as a
    `Sharded` (module docstring); ``device`` is then not read."""
    if shardings is not None or mesh is not None:
        tree, step = restore(ckpt_dir, step, device="cpu")
        if shardings is None:
            shardings = NamedSharding(mesh, P())
        return _place(tree, shardings), step
    dev = resolve_device(device)
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    leaves = {key: _read_leaf(d / meta["file"], meta["dtype"]).to(dev)
              for key, meta in manifest["leaves"].items()}
    return _unflatten(leaves), manifest["step"]


def _place(tree, shardings):
    if isinstance(tree, dict):
        return {k: _place(v, shardings if isinstance(shardings,
                                                     NamedSharding)
                          else shardings[k]) for k, v in tree.items()}
    return device_put(tree, shardings)
