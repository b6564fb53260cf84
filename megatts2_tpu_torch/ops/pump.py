"""The HBM copy pump of the bandwidth tool (port of ``pallas_pump`` /
``_pump_kernel_factory`` in ``tools/bw_ceiling.py``).

The pump streams every byte of W (n_chunks, ch, cols) int8 from device
memory ``steps`` times; what it returns proves the bytes arrived:

* ``head`` — (1, 1) fp32, the TPU kernel's output: the sum over steps and
  chunks of ``sum(chunk[0:8, 0:128])``.  Summed in integers and converted
  once, which equals the TPU's fp32 running sum while the partial sums stay
  below 2**24.
* ``total`` — int64 scalar, the sum of every byte streamed: steps * sum(W).

:func:`pump_plain` computes both from W with torch reductions (it reads W
once); :func:`pump_cuda` is kernel D (``csrc/pump.cu``), which moves
steps x |W| bytes; :func:`pump` dispatches by device.
"""
from __future__ import annotations

import torch

HEAD_ROWS, HEAD_COLS = 8, 128
MAX_TILE_BYTES = 32768  # one stage of the kernel's shared-memory ring


def pump_plain(w: torch.Tensor, steps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(head (1, 1) fp32, total int64 scalar) in plain torch ops."""
    head = torch.sum(w[:, :HEAD_ROWS, :HEAD_COLS], dtype=torch.int64) * steps
    total = torch.sum(w, dtype=torch.int64) * steps
    return head.to(torch.float32).reshape(1, 1), total


def tile_bytes(ch: int, cols: int) -> int:
    """Bytes of one copy: whole rows, at most MAX_TILE_BYTES, dividing the
    chunk and holding its first HEAD_ROWS rows."""
    rows = min(ch, MAX_TILE_BYTES // cols)
    if rows < HEAD_ROWS or ch % rows:
        raise ValueError(f"pump: no tile of whole rows fits a ({ch}, {cols}) chunk")
    return rows * cols


def pump_cuda(w: torch.Tensor, steps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel D: (head, total) as :func:`pump_plain`, after streaming W
    from device memory ``steps`` times."""
    if not w.is_cuda or w.dtype != torch.int8 or w.dim() != 3 or not w.is_contiguous():
        raise ValueError("pump_cuda takes a contiguous (n_chunks, ch, cols) int8 CUDA tensor")
    n_chunks, ch, cols = w.shape
    if ch < HEAD_ROWS or cols < HEAD_COLS or cols % 16:
        raise ValueError(f"pump_cuda: chunk ({ch}, {cols}) needs ch >= {HEAD_ROWS}, "
                         f"cols >= {HEAD_COLS} and cols a multiple of 16")
    if steps < 1:
        raise ValueError(f"pump_cuda: steps must be >= 1, got {steps}")
    tile = tile_bytes(ch, cols)
    from ..csrc.build import check, load_library

    lib = load_library()
    out = torch.zeros(2, dtype=torch.int64, device=w.device)  # head, total
    with torch.cuda.device(w.device):
        err = lib.mt_pump(w.data_ptr(), n_chunks, ch, cols, tile, steps, out[0:1].data_ptr(),
                          out[1:2].data_ptr(), torch.cuda.current_stream().cuda_stream)
    check(err, "pump kernel")
    pump_cuda.launches += 1
    return out[0].to(torch.float32).reshape(1, 1), out[1]


pump_cuda.launches = 0


def pump(w: torch.Tensor, steps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel D on a CUDA tensor, the plain version on a CPU tensor."""
    if w.is_cuda:
        return pump_cuda(w, steps)
    if w.device.type == "cpu":
        return pump_plain(w, steps)
    raise ValueError(f"pump: no implementation for device {w.device}")
