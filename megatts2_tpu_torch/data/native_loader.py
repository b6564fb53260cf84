"""ctypes bindings for the port's native data loader
(``megatts2_tpu_torch/native/dataloader.cpp``; port of
``megatts2_tpu/data/native_loader.py``).

* ``NativeFeatureReader``: mmap'd shard reads with a threaded padded-batch
  gather (``read``, ``read_batch``) and same-speaker timbre assembly in one
  call (``concat_slices``);
* ``BatchRing``: an async ring of batch buffers, filled by the library's
  worker pool while the caller assembles the rest of a batch.

The library is built at first use with ``g++ -O3 -std=c++17 -fPIC -shared
-pthread`` into ``build/native_loader/<hash>/`` at the root of the
checkout, keyed on a hash of the source and the flags (as ``csrc/build.py``
builds the kernels), and never from or into ``native/``, the JAX
package's.  Unlike the JAX binding there is no fallback: a build or load
that fails raises with the compiler's output, and callers that want the
numpy path ask for it (``GANBatchBuilder(use_native=False)``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "dataloader.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native_loader"
LIB_NAME = "libmegatts2_dataloader.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")


def library_path(source: Path, build_root: Path) -> Path:
    """Where the library built from ``source`` lives (built or not)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(source.read_bytes())
    return build_root / h.hexdigest()[:16] / LIB_NAME


def build(source: Path, build_root: Path) -> Path:
    """Compile ``source`` unless its library exists; returns the library's
    path.  Written under a temporary name and renamed, so concurrent builds
    never load a partial file.  Raises with the compiler's output."""
    lib = library_path(source, build_root)
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("native loader: g++ not found on PATH")
    lib.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmpdir:
        tmp = os.path.join(tmpdir, LIB_NAME)
        cmd = [cxx, *CXX_FLAGS, "-o", tmp, str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"native loader: {' '.join(cmd)} failed ({proc.returncode}):\n"
                               f"{(proc.stdout + proc.stderr)[-4000:]}")
        os.replace(tmp, lib)
    return lib


_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_F32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_P, _i32, _i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
# entry point → (restype, argtypes)
SIGNATURES = {
    "mtl_open_shard": (_P, [ctypes.c_char_p, _i64, _i32, _i32]),
    "mtl_close_shard": (None, [_P]),
    "mtl_fill_batch": (_i32, [_P, _I64, _I32, _i32, _i32, _F32]),
    "mtl_concat_slices": (_i32, [_P, _I64, _I32, _i32, _i32, _F32]),
    "mtl_version": (_i32, []),
    "mtl_ring_create": (_P, [_i32, _i64]),
    "mtl_ring_destroy": (None, [_P]),
    "mtl_ring_submit": (_i32, [_P, _P, _I64, _I32, _i32, _i32]),
    "mtl_ring_wait": (ctypes.POINTER(ctypes.c_float), [_P, _i32]),
    "mtl_ring_release": (None, [_P, _i32]),
}


@functools.lru_cache(maxsize=None)
def load_library(source: Path, build_root: Path) -> ctypes.CDLL:
    """Build ``source`` if needed, load it once per process, declare every
    signature.  Raises if it cannot be built or loaded."""
    lib = ctypes.CDLL(str(build(source, build_root)))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


class NativeFeatureReader:
    """Shard reader backed by the C++ mmap / thread-pool loader; a superset
    of ``features.FeatureReader``'s interface."""

    def __init__(self):
        self._lib = load_library(SOURCE, BUILD_ROOT)
        self._handles: Dict[str, int] = {}
        self._meta: Dict[str, dict] = {}

    def _get(self, path: str) -> int:
        if path not in self._handles:
            with open(path + ".json") as f:
                meta = json.load(f)
            if meta["dtype"] not in ("float16", "float32"):
                raise ValueError(f"{path}: shard dtype {meta['dtype']} (float16 or float32)")
            h = self._lib.mtl_open_shard(path.encode(), meta["frames"], meta["dim"],
                                         1 if meta["dtype"] == "float16" else 0)
            if not h:
                raise OSError(f"mtl_open_shard failed for {path}")
            self._handles[path] = h
            self._meta[path] = meta
        return self._handles[path]

    def read(self, path: str, offset: int, num_frames: int) -> np.ndarray:
        return self.read_batch(path, [offset], [num_frames], num_frames)[0]

    def read_batch(self, path: str, offsets: Sequence[int], lens: Sequence[int],
                   pad_to: int) -> np.ndarray:
        """Padded batch gather: (N, pad_to, dim) float32, zero-padded.  A
        slice longer than ``pad_to`` or past the end of the shard raises."""
        h = self._get(path)
        out = np.empty((len(offsets), pad_to, self._meta[path]["dim"]), np.float32)
        rc = self._lib.mtl_fill_batch(h, np.ascontiguousarray(offsets, np.int64),
                                      np.ascontiguousarray(lens, np.int32), len(offsets),
                                      pad_to, out)
        if rc != 0:
            raise ValueError(f"mtl_fill_batch error {rc}")
        return out

    def concat_slices(self, path: str, offsets: Sequence[int], lens: Sequence[int],
                      cap: int) -> np.ndarray:
        """The slices concatenated (timbre-mel assembly), cut to ``cap`` frames."""
        h = self._get(path)
        out = np.empty((cap, self._meta[path]["dim"]), np.float32)
        written = self._lib.mtl_concat_slices(h, np.ascontiguousarray(offsets, np.int64),
                                              np.ascontiguousarray(lens, np.int32),
                                              len(offsets), cap, out)
        if written < 0:
            raise ValueError(f"mtl_concat_slices error {written}")
        return out[:written]

    def ring_create(self, slots: int, max_floats: int) -> "BatchRing":
        """A bounded ring of native batch buffers: ``submit`` starts a
        padded-batch gather on the C++ worker pool and returns at once;
        ``wait`` blocks only if the fill is still running."""
        return BatchRing(self, slots, max_floats)

    def close(self) -> None:
        for h in self._handles.values():
            self._lib.mtl_close_shard(h)
        self._handles.clear()

    def __del__(self):
        if getattr(self, "_handles", None):
            self.close()


class BatchRing:
    """The native async ring (``mtl_ring_*``)::

        t = ring.submit(path, offsets, lens, pad_to)   # the fill starts
        ...assemble the rest of the batch...
        mel = ring.wait(t, n, pad_to)                  # blocks only if slow
        ring.release(t)
    """

    def __init__(self, reader: NativeFeatureReader, slots: int, max_floats: int):
        self._reader = reader
        self._lib = reader._lib
        self._h = self._lib.mtl_ring_create(slots, max_floats)
        if not self._h:
            raise RuntimeError("mtl_ring_create failed")
        self.max_floats = max_floats
        self._dim = 0

    def submit(self, path: str, offsets: Sequence[int], lens: Sequence[int], pad_to: int) -> int:
        """A ticket (a slot index), or -1 when every slot is taken."""
        shard = self._reader._get(path)
        self._dim = self._reader._meta[path]["dim"]
        t = self._lib.mtl_ring_submit(self._h, shard, np.ascontiguousarray(offsets, np.int64),
                                      np.ascontiguousarray(lens, np.int32), len(offsets), pad_to)
        if t == -2:
            raise ValueError("mtl_ring_submit: bad slice or buffer too small")
        return t

    def wait(self, ticket: int, n: int, pad_to: int) -> np.ndarray:
        """(n, pad_to, dim) float32, a copy of the slot's buffer (the slot
        may be released right after)."""
        ptr = self._lib.mtl_ring_wait(self._h, ticket)
        if not ptr:
            raise ValueError(f"mtl_ring_wait: bad ticket {ticket}")
        flat = np.ctypeslib.as_array(ptr, shape=(n * pad_to * self._dim,))
        return flat.reshape(n, pad_to, self._dim).copy()

    def release(self, ticket: int) -> None:
        self._lib.mtl_ring_release(self._h, ticket)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.mtl_ring_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
