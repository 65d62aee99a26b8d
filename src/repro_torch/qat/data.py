"""Hermetic MNIST-scale datasets behind one iterator API (the port's own
copy of the reference's numpy-only `qat/data.py`; batches are
byte-identical to the reference's for the same arguments).

The default is a procedurally rendered 16x16 digit dataset (16x16x1, 10
classes): a 5x7 glyph per class, 2x up-scaled onto the canvas with
per-sample position jitter, intensity scaling and additive Gaussian
noise, all seeded, so replaying a split is byte-identical.
`MNISTDigits` reads the classic IDX ``.gz`` files from a directory the
caller gives (nothing is downloaded), nearest-resampled to 16x16:

    ds = make_dataset("synthetic", split="train", seed=0)
    for x, y in ds.batches(64, 100):   # x (64,16,16,1) f32, y (64,) i32
        ...

`batches()` re-derives its rng from (seed, split) on every call.
"""
from __future__ import annotations

import dataclasses
import gzip
import pathlib
import struct
from typing import Iterator, Optional, Tuple

import numpy as np

SIDE = 16
NUM_CLASSES = 10

# 5x7 digit glyphs ('#' = on) — rendered, not copied from any font file.
_GLYPHS = (
    (" ### ", "#   #", "#  ##", "# # #", "##  #", "#   #", " ### "),  # 0
    ("  #  ", " ##  ", "  #  ", "  #  ", "  #  ", "  #  ", " ### "),  # 1
    (" ### ", "#   #", "    #", "  ## ", " #   ", "#    ", "#####"),  # 2
    (" ### ", "#   #", "    #", "  ## ", "    #", "#   #", " ### "),  # 3
    ("   # ", "  ## ", " # # ", "#  # ", "#####", "   # ", "   # "),  # 4
    ("#####", "#    ", "#### ", "    #", "    #", "#   #", " ### "),  # 5
    (" ### ", "#    ", "#    ", "#### ", "#   #", "#   #", " ### "),  # 6
    ("#####", "    #", "   # ", "  #  ", "  #  ", " #   ", " #   "),  # 7
    (" ### ", "#   #", "#   #", " ### ", "#   #", "#   #", " ### "),  # 8
    (" ### ", "#   #", "#   #", " ####", "    #", "    #", " ### "),  # 9
)

_SPLIT_IDS = {"train": 0, "test": 1, "val": 2}


def _glyph_arrays() -> np.ndarray:
    """(10, 14, 10) f32 — each 5x7 glyph 2x nearest-upscaled."""
    out = np.zeros((NUM_CLASSES, 14, 10), np.float32)
    for d, rows in enumerate(_GLYPHS):
        g = np.array([[1.0 if ch == "#" else 0.0 for ch in r]
                      for r in rows], np.float32)
        out[d] = np.kron(g, np.ones((2, 2), np.float32))
    return out


_GLYPH_CACHE = _glyph_arrays()


@dataclasses.dataclass(frozen=True)
class SyntheticDigits:
    """Seeded procedural 16x16 digit classes (the hermetic default)."""

    split: str = "train"
    seed: int = 0
    noise: float = 0.18
    jitter: int = 2
    side: int = SIDE
    classes: int = NUM_CLASSES

    def __post_init__(self):
        if self.split not in _SPLIT_IDS:
            raise ValueError(f"unknown split {self.split!r}; expected one "
                             f"of {sorted(_SPLIT_IDS)}")

    def _rng(self) -> np.random.Generator:
        # re-derived per batches() call => byte-identical replay
        return np.random.default_rng(
            (int(self.seed), _SPLIT_IDS[self.split], 0xD161))

    def batches(self, batch_size: int, n_batches: int
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        rng = self._rng()
        gh, gw = _GLYPH_CACHE.shape[1:]
        base_r = (self.side - gh) // 2
        base_c = (self.side - gw) // 2
        for _ in range(n_batches):
            y = rng.integers(0, self.classes, size=batch_size)
            x = np.zeros((batch_size, self.side, self.side, 1), np.float32)
            dr = rng.integers(-self.jitter, self.jitter + 1,
                              size=batch_size)
            dc = rng.integers(-self.jitter, self.jitter + 1,
                              size=batch_size)
            inten = rng.uniform(0.6, 1.0, size=batch_size)
            for i in range(batch_size):
                r = int(np.clip(base_r + dr[i], 0, self.side - gh))
                c = int(np.clip(base_c + dc[i], 0, self.side - gw))
                x[i, r:r + gh, c:c + gw, 0] = \
                    _GLYPH_CACHE[y[i]] * inten[i]
            x += rng.normal(0.0, self.noise,
                            size=x.shape).astype(np.float32)
            np.clip(x, 0.0, 1.0, out=x)
            yield x, y.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class MNISTDigits:
    """Real-MNIST loader (classic IDX gz files in ``data_dir``),
    nearest-resampled 28 -> 16 so the same nets apply. Optional — raises
    FileNotFoundError when the files are absent."""

    data_dir: str
    split: str = "train"
    seed: int = 0
    side: int = SIDE
    classes: int = NUM_CLASSES

    def _load(self) -> Tuple[np.ndarray, np.ndarray]:
        stem = "train" if self.split == "train" else "t10k"
        d = pathlib.Path(self.data_dir)
        imgs = _read_idx(d / f"{stem}-images-idx3-ubyte.gz")
        labels = _read_idx(d / f"{stem}-labels-idx1-ubyte.gz")
        sel = np.round(np.linspace(0, imgs.shape[1] - 1,
                                   self.side)).astype(int)
        x = imgs[:, sel][:, :, sel].astype(np.float32) / 255.0
        return x[..., None], labels.astype(np.int32)

    def batches(self, batch_size: int, n_batches: int
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        x, y = self._load()
        rng = np.random.default_rng(
            (int(self.seed), _SPLIT_IDS.get(self.split, 1), 0xFEED))
        for _ in range(n_batches):
            idx = rng.integers(0, len(x), size=batch_size)
            yield x[idx], y[idx]


def _read_idx(path: pathlib.Path) -> np.ndarray:
    with gzip.open(path, "rb") as f:
        magic = struct.unpack(">HBB", f.read(4))
        ndim = magic[2]
        shape = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(shape)


def make_dataset(name: str = "synthetic", *, split: str = "train",
                 seed: int = 0, data_dir: Optional[str] = None):
    """One constructor for both sources behind the iterator API."""
    if name == "synthetic":
        return SyntheticDigits(split=split, seed=seed)
    if name == "mnist":
        if not data_dir:
            raise ValueError("dataset 'mnist' needs data_dir with the "
                             "IDX .gz files")
        return MNISTDigits(data_dir=data_dir, split=split, seed=seed)
    raise KeyError(f"unknown dataset {name!r}; expected 'synthetic' or "
                   "'mnist'")
