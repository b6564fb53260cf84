"""Where a block of kernel A's backward spends its time, stage by stage.

    python -m megatts2_tpu_torch.tools.mel_bwd_stages [--batch 8 16] [--cluster 4 1]

Builds ``csrc/mel.cu`` with ``-DMEL_BWD_STAGES`` into its own library
(``build/mel_bwd_stages/<hash>/``; the package's library is never built so).
Under that macro thread 0 of each block of ``mel_bwd_kernel`` writes the
card's nanosecond clock (``%globaltimer``, in steps of 32 ns on an H100) when
it has passed each stage.  One warm call at (B, 16384), the vocoder
trainer's crops with a gradient for each of their 65 mels, then one JSON line
for each batch and cluster size: each stage's median and largest ns over the
blocks that own frames, a block's median total, and the span from the first
block's start to the last block's end.  Stages that end at a block-wide
barrier include the wait for the block's slowest warp; ``cluster_barrier``
the wait for the cluster's slowest block.  Needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import hashlib
import json
import subprocess

import torch

from ..csrc import build
from ..ops import mel
from .bw_ceiling import card_name

# what each stamp (1 .. 13 in csrc/mel.cu) closes: stamp 0 is the block's start
STAGES = ("load", "fft", "split", "mels", "G", "adjoint", "fft_adjoint", "window", "carry",
          "cluster_barrier", "peer_carry", "samples", "leave")
N, N_MELS = 16384, 80


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build (once for these sources) and load the stage-clock library."""
    sources = [build.CSRC / "mel.cu", build.CSRC / "errors.cu"]
    flags = [*build.NVCC_FLAGS, "-DMEL_BWD_STAGES"]
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.read_bytes())
    lib = build.BUILD_ROOT.parent / "mel_bwd_stages" / h.hexdigest()[:16] / "libmel_bwd_stages.so"
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(".tmp")
        proc = subprocess.run([build._nvcc(), *flags, "-shared", "-o", str(tmp), *map(str, sources)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        tmp.replace(lib)
    out = ctypes.CDLL(str(lib))
    out.mt_mel_backward.argtypes = build.SIGNATURES["mt_mel_backward"]
    out.mt_mel_bwd_stage_buffer.argtypes = [ctypes.c_void_p]
    out.mt_error_string.argtypes = [ctypes.c_int]
    out.mt_error_string.restype = ctypes.c_char_p
    return out


def stages(B: int, cluster: int, seed: int = 0) -> dict:
    """Stage times of one warm call at (B, 16384) with clusters of ``cluster``."""
    lib, dev = load(), torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    y = (torch.randn(B, N, generator=gen) * 0.1).to(dev)
    T = mel.num_frames(N)
    g_mel = torch.randn(B, T, N_MELS, generator=gen).to(dev)
    table = mel.bwd_table(N_MELS, dev)
    g_sig = torch.empty_like(y)
    blocks = mel.bwd_clusters(T, cluster=cluster) * cluster * B
    clock = torch.zeros(blocks, len(STAGES) + 1, dtype=torch.int64, device=dev)

    def check(err: int, what: str) -> None:
        if err:
            raise RuntimeError(f"{what}: CUDA error {err} ({lib.mt_error_string(err).decode()})")

    check(lib.mt_mel_bwd_stage_buffer(clock.data_ptr()), "stage buffer")
    for _ in range(3):  # warm; the last call's stamps stay
        check(lib.mt_mel_backward(y.data_ptr(), g_mel.data_ptr(), table.data_ptr(), g_sig.data_ptr(),
                                  B, N, N_MELS, table.numel(), cluster,
                                  torch.cuda.current_stream().cuda_stream), "mel backward kernel")
    torch.cuda.synchronize()
    st = clock.cpu()
    st = st[st[:, 1] > 0]  # blocks that own frames (the others skip the stages between)
    d = (st[:, 1:] - st[:, :-1]).double()
    return {"B": B, "n": N, "cluster": cluster, "blocks": int(st.shape[0]),
            "median_ns": {name: float(d[:, k].median()) for k, name in enumerate(STAGES)},
            "max_ns": {name: float(d[:, k].max()) for k, name in enumerate(STAGES)},
            "block_total_ns": float((st[:, -1] - st[:, 0]).double().median()),
            "span_ns": int(st[:, -1].max() - st[:, 0].min())}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 16])
    ap.add_argument("--cluster", type=int, nargs="+", default=[mel.BWD_CLUSTER, 1])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mel_bwd_stages: needs a CUDA device")
    card = card_name(torch.device("cuda"))
    out = []
    for B in args.batch:
        for cluster in args.cluster:
            rec = {**stages(B, cluster), "card": card}
            print(json.dumps(rec), flush=True)
            out.append(rec)
    return out


if __name__ == "__main__":
    main()
