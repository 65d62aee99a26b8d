"""Build the Hopper kernels with nvcc and bind them with ctypes.

Each CUDA source in ``repro_torch/csrc/`` compiles on first use into a
plain-C shared library under ``build/repro_torch_kernels/`` at the root
of the checkout (or under ``$REPRO_TORCH_BUILD_DIR`` when set, which an
installed package outside a checkout needs), named by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. `build_all` starts one nvcc per source at once and keeps
each build's ptxas report (registers, shared memory and spills of every
kernel) beside its library as ``.log``. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Sequence

from repro_torch.obs import env as obsenv

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HEADERS = ("common.cuh", "mma_s8.cuh")


def build_dir() -> pathlib.Path:
    """Where the kernel libraries go: ``$REPRO_TORCH_BUILD_DIR``, else
    ``build/repro_torch_kernels/`` of the checkout the package runs from."""
    env = obsenv.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    here = pathlib.Path(__file__).resolve()
    root = here.parents[3]
    if here.parents[2].name != "src" or not (root / "pyproject.toml").exists():
        raise RuntimeError(
            f"repro_torch at {here.parents[1]} does not run from a checkout "
            "(src/repro_torch); set REPRO_TORCH_BUILD_DIR to a directory for "
            "the built CUDA kernels")
    return root / "build" / "repro_torch_kernels"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be "
                       "built on this machine")


class CudaKernel:
    """One CUDA source bound through ctypes, with its launch counts.

    ``headers``: the ``csrc/`` headers the source includes, hashed into
    the library's name with it.

    ``launches[stages]`` counts the launches of each pipeline
    instantiation; the wrapper adds one where it launches, nowhere else.
    """

    def __init__(self, name: str, source: str, entry: str,
                 argtypes: Sequence, headers: Sequence[str] = HEADERS):
        self.name = name
        self.source = CSRC / source
        self.entry = entry
        self.headers = tuple(headers)
        self.argtypes = list(argtypes)
        self.launches: Dict[int, int] = {1: 0, 2: 0}
        self._fn = None

    def reset_launches(self):
        self.launches = {1: 0, 2: 0}

    def library_path(self) -> pathlib.Path:
        h = hashlib.sha256()
        for p in (self.source, *(CSRC / n for n in self.headers)):
            h.update(p.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return build_dir() / f"lib{self.name}-{h.hexdigest()[:12]}.so"

    def build_log(self) -> pathlib.Path:
        """nvcc's output (the ptxas report) of the library's build."""
        return self.library_path().with_suffix(".log")

    def compile_command(self, out: pathlib.Path):
        return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(self.source)]

    def fn(self):
        """The bound C entry point, building the library if needed."""
        if self._fn is None:
            build_all([self])
            lib = ctypes.CDLL(str(self.library_path()))
            fn = getattr(lib, self.entry)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, stages: int, *args):
        """Call the C entry point; it launches on the current stream and
        returns `cudaGetLastError()`, which must be 0."""
        err = self.fn()(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.name} kernel (STAGES={stages}) launch failed: "
                f"CUDA error {err}")
        self.launches[stages] += 1


def build_all(kernels: Sequence[CudaKernel]) -> float:
    """Compile every kernel whose library is missing, one nvcc per source,
    all started together. Returns the seconds spent."""
    t0 = time.perf_counter()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = []
    for k in kernels:
        out = k.library_path()
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs.append((k, out, tmp, subprocess.Popen(
            k.compile_command(tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for k, out, tmp, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{k.name}: nvcc exited {proc.returncode}\n{text}")
            continue
        out.with_suffix(".log").write_text(text)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0
