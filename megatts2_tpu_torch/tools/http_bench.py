"""Online-serving latency under load (port of ``tools/http_bench.py``).

    python -m megatts2_tpu_torch.tools.http_bench --requests 32 --clients 8 --rps 8 [--device cuda]

Builds a full-size stack of seeded random weights (``MegaGConfig()``,
``MegaPLMConfig()`` quantized to int8, ``MegaADMConfig(tc_emb_dim=512)``,
Vocos; bf16; latency does not depend on the weights), serves it in process
through ``serve.run_http`` (the continuous engine underneath), and from its
``_ready_cb`` fires one warm request and then ``--requests`` POST
/synthesize calls of ``--n_phones`` phones from ``--clients`` threads,
with ~Poisson arrivals at ``--rps`` (kernel A makes the prompt's mel).
Prints one JSON line: per-request latency percentiles, the worst, the
achieved throughput, and the card's name and power limit.  Every answer
must be a 200 with a wav; a failed request raises.  Runs on the card
unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import config as c
from ..training.lm_trainers import train_device
from .bw_ceiling import card_name


def build_stack(g_cfg: c.MegaGConfig, plm_cfg: c.MegaPLMConfig, adm_cfg: c.MegaADMConfig,
                voc_cfg, seed: int = 0) -> tuple:
    """(G, PLM, ADM, vocoder) with seeded random weights, on the CPU, fp32."""
    from ..models import HiFiGAN, MegaADM, MegaG, MegaPLM, Vocos, init_random_

    gen = torch.Generator().manual_seed(seed)
    voc = Vocos(voc_cfg) if isinstance(voc_cfg, c.VocosConfig) else HiFiGAN(voc_cfg)
    return tuple(init_random_(m, gen) for m in (MegaG(g_cfg), MegaPLM(plm_cfg), MegaADM(adm_cfg), voc))


def run(requests: int = 32, clients: int = 8, rps: float = 8.0, slots: int = 8,
        max_frames: int = 512, chunk_frames: int = 128, n_phones: int = 48, device="cuda",
        cfgs: Optional[tuple] = None, emit: Callable = print) -> dict:
    """Serve the stack at ``cfgs`` = (G, PLM, ADM, vocoder configs; default
    the full-size ones) and drive it as the module docstring says; returns
    the report."""
    from .. import serve as serve_mod
    from ..models import Megatts
    from ..utils.audio import save_wav

    device = train_device(device)
    cfgs = cfgs or (c.MegaGConfig(), c.MegaPLMConfig(), c.MegaADMConfig(tc_emb_dim=512),
                    c.VocosConfig())
    g, plm, adm, voc = build_stack(*cfgs)
    with tempfile.TemporaryDirectory(prefix="httpbench_") as d:
        sym = os.path.join(d, "sym")
        words = ["w%d" % i for i in range(40)]
        with open(sym, "w") as f:
            f.write("<eps> 0\n")
            for i, w in enumerate(words):
                f.write(f"{w} {i + 1}\n")
        prompts = os.path.join(d, "prompts")
        os.makedirs(prompts)
        t = np.arange(16000 * 3) / 16000
        save_wav(os.path.join(prompts, "p.wav"),
                 (0.2 * np.sin(2 * np.pi * 220 * t)).astype(np.float32))
        tts = Megatts(g, plm, adm, voc, sym, max_frames=max_frames, dtype=torch.bfloat16,
                      device=device, quant_int8=True)
        rng = np.random.RandomState(0)
        texts = [" ".join(rng.choice(words, size=n_phones)) for _ in range(requests)]
        lat: list = []
        report: dict = {}
        failure: list = []

        def drive(server):
            import urllib.request
            from concurrent.futures import ThreadPoolExecutor

            port = server.server_address[1]

            def post(txt, timeout=600):
                body = json.dumps({"text": txt, "wavs_dir": prompts}).encode()
                t0 = time.perf_counter()
                req = urllib.request.Request(f"http://127.0.0.1:{port}/synthesize", data=body,
                                             headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=timeout) as r:
                    status, wav = r.status, r.read()
                if status != 200 or wav[:4] != b"RIFF":
                    raise RuntimeError(f"http_bench: status {status}, body {wav[:16]!r}")
                return time.perf_counter() - t0, len(wav)

            try:
                post(texts[0], timeout=3600)  # warm: the first call pays allocations and autotuning
                t_start = time.perf_counter()
                with ThreadPoolExecutor(clients) as ex:
                    futs = []
                    for txt in texts:
                        futs.append(ex.submit(post, txt))
                        time.sleep(rng.exponential(1.0 / rps))
                    for f in futs:
                        lat.append(f.result()[0])
                wall = time.perf_counter() - t_start
                ls = np.sort(lat)
                report.update({
                    "requests": len(lat), "clients": clients, "offered_rps": rps, "slots": slots,
                    "achieved_rps": round(len(lat) / wall, 2),
                    "p50_ms": round(float(np.percentile(ls, 50)) * 1e3, 1),
                    "p90_ms": round(float(np.percentile(ls, 90)) * 1e3, 1),
                    "p99_ms": round(float(np.percentile(ls, 99)) * 1e3, 1),
                    "max_ms": round(float(ls[-1]) * 1e3, 1),
                })
            except Exception as e:  # re-raised after the server stops
                failure.append(e)
            finally:
                server.shutdown()

        # start from serve.py's own argparse defaults, so a new server knob
        # cannot leave this namespace behind
        ns = serve_mod.parse_args([])
        ns.http = 0
        ns.slots = slots
        ns.max_frames = max_frames
        ns.chunk_frames = chunk_frames
        ns.quant_int8 = True
        ns.device = str(device)
        serve_mod.run_http(ns, tts, _ready_cb=drive)
    if failure:
        raise failure[0]
    rec = {"metric": "http_serving_latency", **report, "device": card_name(device)}
    emit(json.dumps(rec))
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--rps", type=float, default=8.0, help="offered load")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max_frames", type=int, default=512)
    ap.add_argument("--chunk_frames", type=int, default=128)
    ap.add_argument("--n_phones", type=int, default=48)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    return run(a.requests, a.clients, a.rps, a.slots, a.max_frames, a.chunk_frames, a.n_phones,
               a.device)


if __name__ == "__main__":
    main()
