"""Host and production mesh builders. Importing this module touches no
device.

A mesh position is one core of the paper's cluster. On a host with fewer
devices than positions, positions share devices round-robin: one card
carries a whole (data, model) cluster, each position launching on its
own stream (`repro_torch.parallel.mesh`), and the CPU stands in for
every position in tests.

The production meshes are the reference's: a pod of (data=16, model=16),
256 positions, and a multipod of (pod=2, data=16, model=16), 512, the
``pod`` axis carrying data parallelism. On ``meta`` (the dry run,
`repro_torch.launch.dryrun`) every position is ``meta``; on cards each
position needs a card of its own.
"""
from __future__ import annotations

import math
from typing import List

import torch

from repro_torch.device import resolve_device
from repro_torch.parallel.mesh import Mesh, make_mesh


def host_devices(device="cuda") -> List[torch.device]:
    """Every device of ``device``'s type on this host: each card, or the
    one CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def make_host_mesh(model: int = 1, device="cuda") -> Mesh:
    """A (data, model) mesh over the host's distinct devices, data =
    devices // model (the reference's tiny mesh for tests and examples)."""
    devs = host_devices(device)
    data = len(devs) // model
    if data < 1:
        raise ValueError(f"model={model} exceeds the {len(devs)} "
                         f"device(s) of type {devs[0].type}")
    return make_mesh((data, model), ("data", "model"), devs)


def make_production_mesh(*, multi_pod: bool = False,
                         device="meta") -> Mesh:
    """The pod (16, 16) or multipod (2, 16, 16) mesh: every position
    ``meta`` on ``meta``, else one distinct device per position (the
    reference's launcher likewise requires the matching device count);
    raises where the host has fewer."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if torch.device(device).type == "meta":
        return make_mesh(shape, axes, "meta")
    n = math.prod(shape)
    dev = torch.device(device)
    have = (torch.cuda.device_count() if dev.type == "cuda"
            else len(host_devices(dev)))
    if have < n:
        raise ValueError(
            f"the {'multipod' if multi_pod else 'pod'} mesh {shape} needs "
            f"{n} {dev.type} devices, one per position; this host has "
            f"{have} (the dry run builds it on 'meta': python -m "
            "repro_torch.launch.dryrun)")
    return make_mesh(shape, axes, host_devices(dev))


def make_cluster_mesh(dp: int, tp: int, device="cuda") -> Mesh:
    """A (data=dp, model=tp) mesh whose positions take the host's devices
    round-robin, so any shape fits one card."""
    devs = host_devices(device)
    n = dp * tp
    return make_mesh((dp, tp), ("data", "model"),
                     [devs[i % len(devs)] for i in range(n)])


def parse_mesh(arg: str, device="cuda") -> Mesh:
    """``--mesh DP,TP`` -> `make_cluster_mesh`; a malformed value exits."""
    try:
        dp, tp = (int(v) for v in arg.split(","))
    except ValueError:
        raise SystemExit(f"--mesh {arg!r}: expected DP,TP (two comma-"
                         "separated ints), e.g. --mesh 2,2 or --mesh 4,1")
    if dp < 1 or tp < 1:
        raise SystemExit(f"--mesh {arg!r}: both sizes must be >= 1")
    return make_cluster_mesh(dp, tp, device)


def mesh_line(mesh: Mesh) -> str:
    """The CLIs' ``mesh:`` line body, naming the devices."""
    return (f"data={mesh.shape['data']} model={mesh.shape['model']} "
            f"({mesh.size} positions on {mesh.describe()})")
