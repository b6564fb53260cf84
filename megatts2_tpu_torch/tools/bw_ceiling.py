"""Measured device-memory streaming ceiling against the rate the int8 PLM
decode reaches (port of ``tools/bw_ceiling.py``).

    python -m megatts2_tpu_torch.tools.bw_ceiling [--steps 64] [--device cuda] [--n-chunks 144]

Runs on the card unless given ``--device cpu`` (then every time is a CPU
time).  Cases, one JSON line each, every line with the device's name and,
on the card, its name and power limit as ``nvidia-smi`` gives them:

* ``read_reduce`` — int32 sums over the per-layer slices of int8 weights
  the size of the 12-layer PLM's (qkv, out, ff1, ff2), ``steps`` times.
* ``dots`` — the same bytes through int8 → bf16 converts and products at
  the decode's B = 8, fp32 results, no attention or LayerNorm.
* ``pump_16``, ``pump_64`` — kernel D (``ops/pump.py``) streaming
  W (N_CHUNKS, CH, W_COLS) int8 16 and 64 times; ``pump_fit`` — the
  two-point fit that cancels the fixed cost of a call: the ceiling.
* ``decode`` — the int8 ``plm_fast_decode`` at B = 8, T = 64, full width,
  bf16 compute: ms per step, the bytes a step moves (int8 weights, fp32
  scales and biases, the KV cache it reads at positions <= t, averaged
  over the T steps), their rate, and its share of the ``pump_fit`` ceiling.

Times are warm: on the card CUDA events around ``iters`` calls, on the CPU
the host clock.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Callable, Optional

import torch

from ..config import MegaPLMConfig
from ..models.fast_decode import plm_fast_decode
from ..models.megatts import init_random_
from ..models.plm import MegaPLM
from ..ops.pump import pump
from ..quantization.weight_only import QuantLinear, cast_float_, matmul_f32, quantize_

D, FF, L = 1024, 4096, 12
CH, W_COLS, N_CHUNKS = 256, 4096, 144  # 151 MB int8, the 12-layer PLM's weights


def card_name(device: torch.device) -> str:
    """``name, power.limit`` from nvidia-smi on the card, else the device type."""
    if device.type != "cuda":
        return device.type
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn: Callable, device: torch.device, iters: int = 3) -> float:
    """Mean milliseconds per warm call of ``fn``."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def int8_layers(d: int, ff: int, n_layers: int, device, seed: int = 0) -> tuple:
    """Seeded int8 (qkv (L, d, 3d), out (L, d, d), ff1 (L, d, ff), ff2 (L, ff, d)),
    in the flax (in, out) layout, values in [-127, 127)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = ((n_layers, d, 3 * d), (n_layers, d, d), (n_layers, d, ff), (n_layers, ff, d))
    return tuple(torch.randint(-127, 127, s, generator=gen, dtype=torch.int8, device=device)
                 for s in shapes)


def read_reduce(qkv, out, ff1, ff2, steps: int) -> torch.Tensor:
    """``bw_ceiling.py``'s read_reduce: per step, s = the fp32 sum of every
    per-layer int32 sum; c += s * 1e-9.  Returns c, fp32."""
    c = torch.zeros((), dtype=torch.float32, device=qkv.device)
    for _ in range(steps):
        s = torch.zeros((), dtype=torch.float32, device=qkv.device)
        for a in (qkv, out, ff1, ff2):
            for layer in a:
                s = s + torch.sum(layer, dtype=torch.int32).to(torch.float32)
        c = c + s * 1e-9
    return c


def dots(qkv, out, ff1, ff2, x0: torch.Tensor, steps: int) -> torch.Tensor:
    """``bw_ceiling.py``'s dots: per step and layer, x (B, d) in x0's dtype
    times each int8 kernel converted to that dtype, fp32 results;
    x = (h[:, :d] + h1 + g) in x0's dtype, g = (x @ ff1) @ ff2.  Returns
    the fp32 sum of the final x."""
    d = x0.shape[-1]
    x = x0
    for _ in range(steps):
        for l in range(qkv.shape[0]):
            h = matmul_f32(x, qkv[l].T)
            h1 = matmul_f32(x, out[l].T)
            f = matmul_f32(x, ff1[l].T)
            g = matmul_f32(f.to(x0.dtype), ff2[l].T)
            x = (h[:, :d] + h1 + g).to(x0.dtype)
    return torch.sum(x.to(torch.float32))


def decode_step_bytes(model: MegaPLM, B: int, T: int) -> float:
    """Bytes one decode step moves, averaged over T steps: every quantized
    layer's int8 weights and fp32 scales and biases, and the KV cache read
    at positions <= t in the compute dtype."""
    w = 0
    for m in model.modules():
        if isinstance(m, QuantLinear):
            w += m.weight_q.numel() * m.weight_q.element_size()
            w += sum(b.numel() * 4 for b in (m.scale, m.bias) if b is not None)
    D2 = 2 * model.cfg.d_model
    elt = torch.finfo(model.plm.dtype).bits // 8
    mean_len = (T + 1) / 2  # positions 0..t read at step t
    return w + len(model.plm.layers) * B * D2 * elt * mean_len


def run(device: str | torch.device = "cuda", steps: int = 64, d: int = D, ff: int = FF,
        n_layers: int = L, ch: int = CH, w_cols: int = W_COLS, n_chunks: int = N_CHUNKS,
        pump_steps: tuple = (16, 64), plm_cfg: Optional[MegaPLMConfig] = None, B: int = 8,
        T: int = 64, dtype: torch.dtype = torch.bfloat16, iters: int = 3,
        card: Optional[str] = None, emit: Callable = print) -> list[dict]:
    """Every case at the given shapes; each record is passed to ``emit`` as
    one JSON line and returned.  The card unless ``device`` is the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bw_ceiling: device 'cuda' requested but no CUDA device is available")
    card = card or card_name(device)
    records = []

    def out(rec: dict) -> None:
        rec["device"] = card
        records.append(rec)
        emit(json.dumps(rec))

    ws = int8_layers(d, ff, n_layers, device)
    total_mb = sum(a.numel() for a in ws) / 1e6
    x0 = torch.randn(8, d, generator=torch.Generator(device=device).manual_seed(1),
                     device=device).to(dtype)
    for name, fn in (("read_reduce", lambda: read_reduce(*ws, steps)),
                     ("dots", lambda: dots(*ws, x0, steps))):
        ms = time_ms(fn, device, iters)
        out({"case": name, "total_ms": ms, "us_per_step": ms * 1e3 / steps, "MB": total_mb,
             "eff_GBps": total_mb / (ms / steps)})
    del ws

    w = torch.randint(-127, 127, (n_chunks, ch, w_cols), dtype=torch.int8, device=device,
                      generator=torch.Generator(device=device).manual_seed(0))
    points = []
    for s in pump_steps:
        ms = time_ms(lambda s=s: pump(w, s), device, iters)
        gb = w.numel() * s / 1e9
        points.append((gb, ms))
        out({"case": f"pump_{s}", "wall_ms": ms, "GB": gb, "GBps": gb / ms * 1e3})
    (g1, w1), (g2, w2) = points
    ceiling = (g2 - g1) / (w2 - w1) * 1e3  # GB/s
    out({"case": "pump_fit", "GBps": ceiling, "intercept_ms": w1 - g1 / ceiling * 1e3})
    del w

    cfg = plm_cfg or MegaPLMConfig()
    gen = torch.Generator().manual_seed(2)
    model = init_random_(MegaPLM(cfg), gen).to(device).eval()
    cast_float_(quantize_(model, 8), dtype)
    tc = torch.randn(B, T, cfg.tc_latent_dim, generator=gen).to(device)
    ms = time_ms(lambda: plm_fast_decode(model, tc), device, iters)
    step_bytes = decode_step_bytes(model, B, T)
    rate = step_bytes / (ms / T) / 1e6  # GB/s
    out({"case": "decode", "B": B, "T": T, "total_ms": ms, "ms_per_step": ms / T,
         "MB_per_step": step_bytes / 1e6, "GBps": rate, "share_of_pump_fit": rate / ceiling})
    return records


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--steps", type=int, default=64, help="read_reduce and dots passes")
    p.add_argument("--iters", type=int, default=3, help="timed calls per case")
    p.add_argument("--d", type=int, default=D)
    p.add_argument("--ff", type=int, default=FF)
    p.add_argument("--layers", type=int, default=L)
    p.add_argument("--ch", type=int, default=CH)
    p.add_argument("--w-cols", type=int, default=W_COLS)
    p.add_argument("--n-chunks", type=int, default=N_CHUNKS)
    a = p.parse_args(argv)
    run(device=a.device, steps=a.steps, d=a.d, ff=a.ff, n_layers=a.layers, ch=a.ch,
        w_cols=a.w_cols, n_chunks=a.n_chunks, iters=a.iters)


if __name__ == "__main__":
    main()
