"""Mel-feature storage: flat float16/float32 memmap shards plus a ``.json``
sidecar ``{"dim", "dtype", "frames"}`` (port of
``megatts2_tpu/data/features.py``; the same file format, so either package
reads the other's shards).

A writer appends (T, dim) arrays to one flat file and returns each one's
frame offset; a reader memmaps a shard once and slices it.
"""
from __future__ import annotations

import json
from typing import Dict, Tuple

import numpy as np


class FeatureWriter:
    """Appends (T, dim) float arrays to a flat shard; returns offsets."""

    def __init__(self, path: str, dim: int = 80, dtype: str = "float16"):
        self.path = path
        self.dim = dim
        self.dtype = np.dtype(dtype)
        self._f = open(path, "wb")
        self._offset = 0  # in frames

    def add(self, feats: np.ndarray) -> Tuple[str, int]:
        if feats.ndim != 2 or feats.shape[1] != self.dim:
            raise ValueError(f"features of shape {feats.shape}, expected (T, {self.dim})")
        arr = np.ascontiguousarray(feats, dtype=self.dtype)
        self._f.write(arr.tobytes())
        off = self._offset
        self._offset += arr.shape[0]
        return self.path, off

    def close(self) -> None:
        self._f.close()
        meta = {"dim": self.dim, "dtype": self.dtype.name, "frames": self._offset}
        with open(self.path + ".json", "w") as f:
            json.dump(meta, f)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class FeatureReader:
    """Memmap cache over feature shards."""

    def __init__(self):
        self._maps: Dict[str, np.memmap] = {}

    def _get(self, path: str) -> np.memmap:
        if path not in self._maps:
            with open(path + ".json") as f:
                meta = json.load(f)
            self._maps[path] = np.memmap(path, dtype=meta["dtype"], mode="r",
                                         shape=(meta["frames"], meta["dim"]))
        return self._maps[path]

    def read(self, path: str, offset: int, num_frames: int) -> np.ndarray:
        """(num_frames, dim) float32 from frame ``offset`` of a shard."""
        m = self._get(path)
        return np.asarray(m[offset: offset + num_frames], dtype=np.float32)
