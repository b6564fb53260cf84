"""Serving CLI of the port (port of ``megatts2_tpu/serve.py``), on one card.

Three modes, as the JAX CLI:

* batch (default): a JSONL manifest of requests, length-bucketed (estimated
  frames = ``--frames_per_phone`` × phones, rounded up to the next of
  ``--buckets``), grouped in fixed-size batches per (prompt dir, bucket,
  prosody prompt), one ``Megatts.synthesize_batch`` a batch;
* ``--continuous``: the same manifest through the continuous slot engine
  (``continuous.ContinuousEngine``);
* ``--http PORT``: a live server on the engine: ``POST /synthesize``
  ``{"text", "wavs_dir"[, "prompt_cuts" | "prompt_speaker"]}`` → audio/wav,
  ``GET /healthz``, ``GET /metrics``; 413 above ``--max_body_bytes``, 504
  after ``--request_timeout``.

::

    python -m megatts2_tpu_torch.serve --requests reqs.jsonl --out_dir out/ \\
        --g_ckpt G.ckpt --plm_ckpt plm.ckpt --adm_ckpt adm.ckpt --symbol_table ...

A request line is ``{"id": "u1", "text": "...", "wavs_dir": "prompts/spk1"}``
(requests of one ``wavs_dir`` share its prompt mel).  It runs on the card
unless ``--device cpu`` is given; without a card it raises.  Batch and
continuous modes print one JSON line of throughput and return it.

Under ``torchrun`` the batch mode runs on the (N / ``--n_model`` data ×
``--n_model``) mesh as JAX's does: the weights whole on every rank, each
padded batch split over the data axis (``Megatts.synthesize_batch(mesh=)``);
rank 0 writes the wavs and prints the record.  The continuous engine and
the HTTP server take no mesh in JAX either; here they refuse a world of
more than one rank rather than serve on one of them.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from collections import OrderedDict, defaultdict

import numpy as np
import torch

from . import HIFIGAN_SR

def pick_bucket(n_phones: int, frames_per_phone: float, buckets: list) -> int:
    """Smallest bucket covering the estimated frame budget (last = cap)."""
    est = n_phones * frames_per_phone
    for b in buckets:
        if est <= b:
            return b
    return buckets[-1]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="megatts2_tpu_torch serving")
    p.add_argument("--requests", default=None, help="JSONL of {id, text, wavs_dir} (batch modes)")
    p.add_argument("--out_dir", default=None, help="wav output dir (batch modes)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_frames", type=int, default=1024)
    p.add_argument("--buckets", default="256,512,1024,2048",
                   help="comma-separated frame buckets for length grouping")
    p.add_argument("--frames_per_phone", type=float, default=16.0,
                   help="frame-budget estimate per phone; a request longer than its bucket "
                        "is truncated at the bucket")
    p.add_argument("--n_model", type=int, default=1)
    p.add_argument("--g_ckpt", default=None)
    p.add_argument("--g_config", default="configs/config_gan.yaml")
    p.add_argument("--plm_ckpt", default=None)
    p.add_argument("--plm_config", default="configs/config_plm.yaml")
    p.add_argument("--adm_ckpt", default=None)
    p.add_argument("--adm_config", default="configs/config_adm.yaml")
    p.add_argument("--hifigan_ckpt", default=None)
    p.add_argument("--vocoder", choices=["hifigan", "vocos"], default="hifigan")
    p.add_argument("--vocoder_ckpt", default=None,
                   help="checkpoint of the port's vocoder training stage")
    p.add_argument("--vocoder_config", default="configs/config_vocoder.yaml")
    p.add_argument("--symbol_table", default="data/ds/unique_text_tokens.k2symbols")
    p.add_argument("--pinyin_dict", default=None)
    p.add_argument("--quant_int8", action="store_true", help="int8 weight-only PLM decode")
    p.add_argument("--plm_temperature", type=float, default=0.0,
                   help=">0: sample prosody codes instead of greedy argmax")
    p.add_argument("--plm_top_k", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="run a live HTTP server on the continuous engine instead of batch mode")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--continuous", action="store_true",
                   help="continuous-batching engine (slots; admits requests at tick boundaries)")
    p.add_argument("--slots", type=int, default=8, help="concurrent decode slots of the engine")
    p.add_argument("--chunk_frames", type=int, default=128, help="the engine's emit granularity")
    p.add_argument("--prompt_ds", default=None,
                   help="prepared dataset root with stage-2 latents/: requests may carry "
                        "prompt_cuts: [ids] or prompt_speaker")
    p.add_argument("--prompt_tokens", type=int, default=256,
                   help="static prosody-prompt token budget (tiled + tail-truncated)")
    p.add_argument("--prompt_n", type=int, default=3,
                   help="utterances per speaker prompt (prompt_speaker)")
    p.add_argument("--request_timeout", type=float, default=600.0,
                   help="seconds an HTTP request waits for synthesis before a 504")
    p.add_argument("--max_body_bytes", type=int, default=1 << 20,
                   help="reject HTTP bodies above this size with 413")
    p.add_argument("--admit_tp_bucket", type=int, default=0,
                   help=">0: the engine pads every admission to this phone bucket")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def make_prompt_resolver(args):
    """request dict → (tc, codes) or None, memoized by (cut ids, speaker).
    Requests choose the prompt with ``prompt_cuts`` (explicit ids) or
    ``prompt_speaker`` (the first ``--prompt_n`` cuts of the speaker).

    Called from the HTTP handler threads: the cache is an LRU of 128 entries
    mutated under one lock, and a resolve runs outside it behind a per-key
    event, so concurrent requests for one new key resolve it once (the
    followers wait on the event) while other keys never wait for it."""
    if args.prompt_ds is None:
        def no_prompt(r):
            if r.get("prompt_cuts") or r.get("prompt_speaker"):
                raise ValueError("request has a prosody prompt but the server was started "
                                 "without --prompt_ds")
            return None
        return no_prompt
    import threading

    from .data import load_prompt_manifest, resolve_prompt

    manifest = load_prompt_manifest(args.prompt_ds)
    cache = OrderedDict()
    pending: dict = {}
    max_entries = 128
    mu = threading.Lock()

    def resolver(r):
        ids = tuple(r.get("prompt_cuts") or ())
        spk = r.get("prompt_speaker")
        if not ids and not spk:
            return None
        key = (ids, spk)
        while True:
            with mu:
                if key in cache:
                    cache.move_to_end(key)
                    return cache[key]
                ev = pending.get(key)
                leader = ev is None
                if leader:
                    ev = pending[key] = threading.Event()
            if not leader:
                ev.wait()
                continue  # re-check the cache, or lead if the leader failed
            try:
                val = resolve_prompt(args.prompt_ds, cut_ids=list(ids) or None, speaker=spk,
                                     n=args.prompt_n, manifest=manifest)
                with mu:
                    cache[key] = val
                    while len(cache) > max_entries:
                        cache.popitem(last=False)
                return val
            finally:
                with mu:
                    pending.pop(key, None)
                ev.set()

    return resolver


def _engine(args, tts):
    from .continuous import ContinuousEngine

    return ContinuousEngine(tts.g, tts.plm, tts.adm, tts.vocoder, slots=args.slots,
                            max_frames=args.max_frames, chunk_frames=args.chunk_frames,
                            prompt_tokens=args.prompt_tokens if args.prompt_ds else 0,
                            admit_tp_bucket=args.admit_tp_bucket, device=tts.device)


def _request(tts, r, mel, prompt_of, rid):
    ids = tts.phone_ids(r["text"])[None]
    if ids.shape[1] == 0:
        raise ValueError(f"request {rid}: the text gives no phones")
    req = {"id": rid, "phone": ids, "lens": np.array([ids.shape[1]]), "mels_prompt": mel[None]}
    pf = prompt_of(r)
    if pf is not None:
        req["prompt_tc"], req["prompt_codes"] = pf
    return req


def _device_name(tts) -> str:
    return torch.cuda.get_device_name(tts.device) if tts.device.type == "cuda" else "cpu"


def run_http(args, tts, _ready_cb=None):
    """Live HTTP serving on the continuous engine: requests are admitted
    into free slots at the next tick while others decode.  ``_ready_cb(server)``
    is called in a thread once the socket is bound (tests and the smoke
    run drive requests from it, then shut the server down)."""
    import queue as qmod
    import threading
    import uuid
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from .utils.audio import wav_bytes

    eng = _engine(args, tts)
    prompt_of = make_prompt_resolver(args)
    rq: "qmod.Queue" = qmod.Queue()
    stop = threading.Event()
    results = {}
    results_mu = threading.Lock()
    prompt_cache = {}
    prompt_mu = threading.Lock()

    def prompt_mel(wavs_dir):
        with prompt_mu:
            if wavs_dir not in prompt_cache:
                prompt_cache[wavs_dir] = tts.prompt_mel(wavs_dir)[0]
            return prompt_cache[wavs_dir]

    stats = {"served": 0, "audio_s": 0.0, "started": time.time()}

    def engine_loop():
        for rid, wav in eng.run_live(rq, stop):
            stats["served"] += 1
            stats["audio_s"] += wav.shape[0] / HIFIGAN_SR
            with results_mu:
                entry = results.get(rid)
                if entry is None:
                    continue  # the client timed out and dropped its entry
                results[rid] = (entry[0], wav)
            entry[0].set()

    eng_thread = threading.Thread(target=engine_loop, daemon=True)
    eng_thread.start()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self.send_response(200)
                self.end_headers()
                self.wfile.write(b"ok")
            elif self.path == "/metrics":
                up = max(time.time() - stats["started"], 1e-9)
                with results_mu:
                    in_flight = len(results)
                body = json.dumps({
                    "served": stats["served"], "audio_seconds": stats["audio_s"],
                    "in_flight": in_flight, "queue_depth": rq.qsize(),
                    "engine_ticks": eng.n_ticks, "uptime_s": up,
                    "utt_per_sec": stats["served"] / up, "slots": args.slots,
                    "slots_busy": eng.slots_busy,
                }).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_error(404)

        def do_POST(self):
            if self.path != "/synthesize":
                return self.send_error(404)
            try:
                n = int(self.headers.get("Content-Length", 0))
            except ValueError:
                return self.send_error(400, "bad Content-Length")
            if n > args.max_body_bytes:
                # drain (bounded) first: closing on an unread upload resets the
                # connection and the client would never see the 413
                remaining = min(n, 8 * args.max_body_bytes)
                while remaining > 0:
                    chunk = self.rfile.read(min(remaining, 1 << 16))
                    if not chunk:
                        break
                    remaining -= len(chunk)
                self.close_connection = True
                return self.send_error(413, "request body too large")
            try:
                body = json.loads(self.rfile.read(n))
                req = _request(tts, body, prompt_mel(body["wavs_dir"]), prompt_of,
                               uuid.uuid4().hex)
            except Exception as e:
                return self.send_error(400, str(e))
            ev = threading.Event()
            with results_mu:
                results[req["id"]] = (ev, None)
            rq.put(req)
            if not ev.wait(timeout=args.request_timeout):
                with results_mu:  # drop the entry so the table cannot leak
                    results.pop(req["id"], None)
                return self.send_error(504, "synthesis timed out")
            with results_mu:
                wav = results.pop(req["id"])[1]
            payload = wav_bytes(wav, HIFIGAN_SR)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

    server = ThreadingHTTPServer((args.host, args.http), Handler)
    print(json.dumps({"mode": "http", "host": args.host, "port": server.server_address[1],
                      "slots": args.slots, "device": _device_name(tts)}), flush=True)
    if _ready_cb is not None:
        threading.Thread(target=_ready_cb, args=(server,), daemon=True).start()
    try:
        server.serve_forever()
    finally:
        stop.set()
        eng_thread.join(timeout=60)
        server.server_close()


def _report(record: dict, done: int, audio_s: float, wall: float) -> dict:
    record.update(requests=done, wall_s=wall, utt_per_sec=done / wall, audio_s=audio_s,
                  rtf=wall / max(audio_s, 1e-9))
    print(json.dumps(record), flush=True)
    return record


def main(argv=None):
    args = parse_args(argv)
    from .models import megatts_from_pretrained
    from .utils.audio import save_wav

    if not (args.g_ckpt and args.plm_ckpt and args.adm_ckpt):
        raise SystemExit("serving requires --g_ckpt/--plm_ckpt/--adm_ckpt")
    if args.http is None and not (args.requests and args.out_dir):
        raise SystemExit("batch serving requires --requests/--out_dir")
    from .parallel import make_mesh, maybe_initialize_distributed

    maybe_initialize_distributed(device=args.device)
    mesh = make_mesh(n_model=args.n_model)
    if mesh.size > 1 and (args.http is not None or args.continuous):
        raise SystemExit("--http and --continuous serve on one rank; run them without torchrun "
                         f"(this world has {mesh.size} ranks)")
    t_load = time.perf_counter()
    tts = megatts_from_pretrained(
        args.g_ckpt, args.g_config, args.plm_ckpt, args.plm_config, args.adm_ckpt,
        args.adm_config, args.symbol_table, hifigan_ckpt=args.hifigan_ckpt,
        vocoder=args.vocoder, vocoder_ckpt=args.vocoder_ckpt, vocoder_config=args.vocoder_config,
        pinyin_dict_path=args.pinyin_dict, max_frames=args.max_frames,
        device=args.device, quant_int8=args.quant_int8,
        plm_temperature=args.plm_temperature, plm_top_k=args.plm_top_k, seed=args.seed)
    load_s = time.perf_counter() - t_load
    if args.http is not None:
        return run_http(args, tts)
    if mesh.is_main:
        os.makedirs(args.out_dir, exist_ok=True)
    buckets = sorted(int(b) for b in args.buckets.split(",") if int(b) <= args.max_frames)
    if not buckets or buckets[-1] < args.max_frames:
        buckets.append(args.max_frames)
    with open(args.requests) as f:
        requests = [json.loads(line) for line in f if line.strip()]
    prompt_of = make_prompt_resolver(args)
    prompt_cache = {}

    def prompt_mel(wavs_dir):
        if wavs_dir not in prompt_cache:
            prompt_cache[wavs_dir] = tts.prompt_mel(wavs_dir)[0]
        return prompt_cache[wavs_dir]

    record = {"device": _device_name(tts), "load_s": load_s}
    t0 = time.perf_counter()
    done, audio_s = 0, 0.0
    if args.continuous:
        eng = _engine(args, tts)
        reqs = [_request(tts, r, prompt_mel(r["wavs_dir"]), prompt_of, r["id"]) for r in requests]
        for rid, wav in eng.run(reqs):
            save_wav(os.path.join(args.out_dir, f"{rid}.wav"), wav)
            audio_s += wav.shape[0] / HIFIGAN_SR
            done += 1
        record.update(mode="continuous", slots=args.slots)
        return _report(record, done, audio_s, time.perf_counter() - t0)

    # (wavs_dir, frame bucket, prosody-prompt key) -> requests: one batch
    # shares one prompt mel and one static-length prosody prompt
    by_group = defaultdict(list)
    for r in requests:
        bucket = pick_bucket(len(tts.phone_ids(r["text"])), args.frames_per_phone, buckets)
        pkey = (tuple(r.get("prompt_cuts") or ()), r.get("prompt_speaker") or "")
        by_group[(r["wavs_dir"], bucket, pkey)].append(r)
    for (wavs_dir, bucket, _), reqs in sorted(by_group.items()):
        mel = prompt_mel(wavs_dir)
        pf = prompt_of(reqs[0])
        if pf is not None:
            from .data import fit_prompt

            pf = fit_prompt(pf[0], pf[1], args.prompt_tokens)
        for i in range(0, len(reqs), args.batch_size):
            chunk = reqs[i: i + args.batch_size]
            # pad the last batch to the batch size: one batch shape a bucket
            texts = [r["text"] for r in chunk] + [chunk[-1]["text"]] * (args.batch_size - len(chunk))
            wavs = tts.synthesize_batch(texts, mel[None].expand(len(texts), *mel.shape),
                                        max_frames=bucket, prompt_features=pf, mesh=mesh)
            for r, wav in zip(chunk, wavs):
                if mesh.is_main:
                    save_wav(os.path.join(args.out_dir, f"{r['id']}.wav"), wav)
                audio_s += wav.shape[0] / HIFIGAN_SR
                done += 1
    record.update(mode="batch", batch_size=args.batch_size)
    if mesh.size > 1:
        record.update(mesh=mesh.shape)
        if not mesh.is_main:
            return record
    return _report(record, done, audio_s, time.perf_counter() - t0)


if __name__ == "__main__":
    main()
