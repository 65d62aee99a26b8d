"""Test-side bridge from the JAX reference to the PyTorch port.

The port never imports ``repro``; the parity tests do, and hand artifacts
across as numpy. `neutral` turns any reference artifact (dataclasses,
tuples, jax/numpy arrays) into the neutral description that
`repro_torch.convert.qnet_from_numpy` reads: a dataclass becomes a dict
with a ``"__type__"`` key, tuples become lists, arrays numpy arrays. That
covers the segmented artifacts too: a `SegmentMap`, a
`SegmentedLinearParams` (`port_segmented`) and a `QSegmentedConv2D`
inside a net cross as they are.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch


def neutral(obj):
    if isinstance(obj, (jax.Array, np.ndarray)):
        return np.asarray(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {"__type__": type(obj).__name__}
        for f in dataclasses.fields(obj):
            # the reference's deprecated boolean, always None once
            # normalized onto `backend`; the port has no such field
            if f.name != "use_kernel":
                out[f.name] = neutral(getattr(obj, f.name))
        return out
    if isinstance(obj, (tuple, list)):
        return [neutral(v) for v in obj]
    if isinstance(obj, dict):
        return {k: neutral(v) for k, v in obj.items()}
    return obj


def port_segmented(ref, device="cpu"):
    """A reference `SegmentedLinearParams` as the port's, bytes as they
    are."""
    from repro_torch.convert import segmented_params_from_numpy
    return segmented_params_from_numpy(neutral(ref), device)


def np_tree(tree):
    """Nested dict of jax arrays -> nested dict of numpy arrays."""
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def jax_tree(tree):
    """Nested dict of port tensors -> nested dict of jax arrays."""
    if isinstance(tree, dict):
        return {k: jax_tree(v) for k, v in tree.items()}
    return jax.numpy.asarray(tree.numpy())


def to_np(t) -> np.ndarray:
    """A port tensor (bf16 as its bit pattern) or reference array -> numpy
    for exact comparison."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    a = np.asarray(t)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a


def assert_same(port, ref, what=""):
    """Exact equality of values, shape and integer width."""
    p, r = to_np(port), to_np(ref)
    assert p.shape == r.shape, (what, p.shape, r.shape)
    assert p.dtype.itemsize == r.dtype.itemsize, (what, p.dtype, r.dtype)
    np.testing.assert_array_equal(p, r, err_msg=what)


def assert_artifacts_equal(port, ref, path="net"):
    """Walk a port artifact and the reference's side by side: every array
    byte-identical, every scalar field equal. Port-only fields (e.g. a
    layer's ``pipeline``) are skipped."""
    if isinstance(port, torch.Tensor):
        assert_same(port, ref, path)
    elif dataclasses.is_dataclass(port) and not isinstance(port, type):
        assert type(port).__name__ == type(ref).__name__, path
        for f in dataclasses.fields(ref):
            if f.name in ("plan", "backend"):
                continue
            assert_artifacts_equal(getattr(port, f.name),
                                   getattr(ref, f.name), f"{path}.{f.name}")
    elif isinstance(port, (tuple, list)):
        assert len(port) == len(ref), path
        for i, (p, r) in enumerate(zip(port, ref)):
            assert_artifacts_equal(p, r, f"{path}[{i}]")
    else:
        assert port == ref, (path, port, ref)


def fp_numpy(defs, seed=1):
    """fp weights for a ParamDef tree (the port's or the reference's: the
    same keys and shapes) from a numpy generator: fan-in scaled normals;
    norms and biases random too, so every leaf matters."""
    rng = np.random.default_rng(seed)
    out = {}
    for k in sorted(defs):
        d = defs[k]
        if isinstance(d, dict):
            out[k] = fp_numpy(d, int(rng.integers(2 ** 31)))
            continue
        fan = d.shape[-2] if len(d.shape) >= 2 and d.init == "normal" else 1
        out[k] = (rng.normal(size=d.shape) * 0.5 / fan ** 0.5
                  + (1.0 if d.init == "ones" else 0.0)).astype(np.float32)
    return out
