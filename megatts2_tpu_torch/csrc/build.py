"""Build the CUDA kernels of ``csrc/`` into one shared library and load it.

The sources have a plain C interface, so ``nvcc`` compiles them in seconds
without PyTorch's headers, one process per source in parallel; the library
is loaded with ``ctypes``.  The
build happens at first use, into ``build/torch_kernels/<hash>/`` at the
root of the checkout, keyed on a hash of the sources and flags, so a fresh
checkout builds once and later processes reuse the library.

Nothing here runs at import time: this module is imported on machines that
have no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent
BUILD_ROOT = CSRC.parents[1] / "build" / "torch_kernels"
LIB_NAME = "libmegatts2_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry point → argument types; each returns a cudaError_t as int.
SIGNATURES = {
    "mt_mel_forward": [_P] * 6 + [_I] * 4 + [_P],
    "mt_mel_backward": [_P] * 4 + [_I] * 5 + [_P],
    "mt_flash_attn_fwd": [_P] * 7 + [_I] * 5 + [_L] * 12 + [_I, ctypes.c_float, _I, _P],
    "mt_flash_attn_bwd": [_P] * 11 + [_I] * 5
    + [ctypes.POINTER(_L), _I, ctypes.c_float, _I, _P],
    "mt_pump": [_P, _L, _I, _I, _I, _I, _P, _P, _P],
}


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME or /usr/local/cuda")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the sources unless the library for them exists; returns its path.

    One ``nvcc -c`` per source, all started together, then one link.  The
    compiler's register and shared-memory report goes to ``build.log``
    beside the library.  Objects and library are written under a temporary
    directory and name and renamed, so concurrent builds never load a
    partial file."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    log = []
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmpdir:
        jobs = []
        for src in _sources():
            if src.suffix != ".cu":
                continue
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(Path(tmpdir) / f"{src.stem}.o")]
            jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.PIPE, text=True)))
        done = [(cmd, proc, *proc.communicate()) for cmd, proc in jobs]  # wait for all
        log += [" ".join(cmd) + "\n" + out + err for cmd, _, out, err in done]
        for cmd, proc, _, err in done:
            if proc.returncode != 0:
                _write_log(lib, log)
                raise RuntimeError(f"nvcc failed ({proc.returncode}) on {cmd[-3]}:\n{err[-4000:]}")
        objs = [cmd[-1] for cmd, *_ in done]
        tmp = str(Path(tmpdir) / LIB_NAME)
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        _write_log(lib, log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, lib)
    return lib


def _write_log(lib: Path, log: list[str]) -> None:
    (lib.parent / "build.log").write_text("\n".join(log))


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every signature."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mt_error_string.argtypes = [_I]
    lib.mt_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        name = load_library().mt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({name})")
