"""Continuous-batching synthesis engine (port of ``megatts2_tpu/continuous.py``).

LLM engines' iteration-level scheduling adapted to the TTS cascade:

* ``S`` fixed slots share one per-slot KV cache (:func:`engine_init`);
  every slot decodes at its own position (``plm_fast_tick``: per-row
  positions, cache writes by ``index_put_``, per-row causal masks).
* A request is admitted into a free slot at any tick: its content path
  (MRTE → ADM → length regulation, ``streaming.stream_prep``) runs once,
  then the slot's content, codes and counters are reset in place
  (:func:`admit_slots`); with an in-context prosody prompt its prompt is
  prefilled first (:func:`prefill_slots`, kernel B causal on the card)
  and its k and v installed into the slot's cache
  (:func:`admit_slots_prompted`).
* A tick advances every live slot F/8 codes (:func:`engine_tick`) and
  emits one F-frame chunk per slot whose codes are ready
  (:func:`emit_slots`), with the receptive-field-exact windows of
  ``models/streaming.py``, batched over slots.

Each request's output equals the one-shot ``synthesize`` at the engine's
frame budget (``Tmax``), whatever shares the engine with it: admission
batches are padded to the slot count by repeating a request (a repeated
slot write is idempotent), so every prep runs at one batch size, and
phones are padded to each request's own multiple of 16 (or to the
engine-wide ``admit_tp_bucket``), since the MRTE's convolutional
feed-forward reaches a few positions past a sequence's length.

The engine runs on ``device`` (the card by default; tests pass ``"cpu"``)
with the modules as they are given, cast as ``Megatts`` casts them.  The
host syncs once per admission wave (the wave's frame counts) and once per
tick (the previous tick's audio, copied while the next tick runs).

The scheduler takes the tracer's spans (``utils/tracing.py``):
``engine.admit`` a wave, ``engine.tick`` and ``engine.emit`` a tick, and
per request ``engine.queue_wait`` and ``engine.first_chunk``, both from
its ``t_submit_ns`` (``time.perf_counter_ns`` when it was submitted: the
HTTP server stamps it, ``run`` stamps a list's requests); while the tracer
is off it reads no clock.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from . import HIFIGAN_HOP_LENGTH
from .data import fit_prompt
from .models.fast_decode import plm_fast_tick
from .models.megatts import vocode
from .models.streaming import emit_window, stream_geometry, stream_prep
from .utils import tracing


def engine_init(plm, S: int, L: int, like: torch.Tensor) -> list[torch.Tensor]:
    """The per-slot KV cache: one zeroed (S, L, 2D) buffer per PLM layer,
    ``L`` the generated-code budget plus the prompt budget."""
    return plm.plm.new_cache(S, L, like)


@torch.inference_mode()
def prefill_slots(plm, prompt_tc: torch.Tensor, prev_prompt: torch.Tensor, L: int):
    """A wave's prompts prefilled in one causal pass (``MegaPLM.prefill``;
    kernel B under ``use_flash``): prompt_tc (A, Pe, D), prev_prompt (A, Pe)
    = BOS ++ prompt_codes[:, :-1] → per-layer caches (A, L, 2D) holding the
    prompts' k and v at positions [0, Pe)."""
    caches = plm.plm.new_cache(prompt_tc.shape[0], L, prompt_tc.to(plm.plm.dtype))
    plm.prefill(prompt_tc, prev_prompt, caches)
    return caches


def _first_rows(slots: List[int]) -> Tuple[List[int], List[int]]:
    """(distinct target slots, the wave row that writes each): the first
    row naming a slot wins (repeated padding rows are idempotent)."""
    seen: Dict[int, int] = {}
    for row, s in enumerate(slots):
        seen.setdefault(s, row)
    return list(seen), list(seen.values())


def total_codes(nf: torch.Tensor, Tc: int, Tmax: int, rv: int, rd: int) -> torch.Tensor:
    """Codes a slot generates to emit ``nf`` frames, the receptive fields'
    lookahead included."""
    return torch.clamp(torch.div(torch.clamp(nf + rv + rd, max=Tmax) + 7, 8,
                                 rounding_mode="floor"), max=Tc)


@torch.inference_mode()
def admit_slots(carry: dict, slots: List[int], tc_plm_a: torch.Tensor,
                tc_expand_a: torch.Tensor, nf_a: torch.Tensor, bos: int, Tc: int, Tmax: int,
                rv: int, rd: int) -> None:
    """Reset the wave's slots in place and install their requests' content.
    Cache rows need no zeroing: a slot attends positions up to its own,
    every one of which its own steps rewrite first."""
    dst, rows = _first_rows(slots)
    dev = carry["prev"].device
    d = torch.tensor(dst, device=dev)
    r = torch.tensor(rows, device=dev)
    carry["tc_plm"].index_copy_(0, d, tc_plm_a[r].to(carry["tc_plm"].dtype))
    carry["tc_expand"].index_copy_(0, d, tc_expand_a[r].to(carry["tc_expand"].dtype))
    carry["codes"][d] = 0
    carry["prev"][d] = bos
    carry["pos"][d] = 0
    carry["plen"][d] = 0
    carry["total"][d] = total_codes(nf_a[r].long(), Tc, Tmax, rv, rd)


@torch.inference_mode()
def admit_slots_prompted(carry: dict, slots: List[int], tc_plm_a: torch.Tensor,
                         tc_expand_a: torch.Tensor, nf_a: torch.Tensor, prev_a: torch.Tensor,
                         plen_a: torch.Tensor, pf_caches: list, Pe: int, Tc: int, Tmax: int,
                         rv: int, rd: int) -> None:
    """:func:`admit_slots` with in-context prompts: also the prompts' k and
    v (``prefill_slots``) into the slots' cache positions [0, Pe), each
    slot's prompt length and its first input code (the prompt's last).  An
    unprompted row (plen 0) carries junk prompt rows, which its decode
    rewrites before it attends them."""
    admit_slots(carry, slots, tc_plm_a, tc_expand_a, nf_a, 0, Tc, Tmax, rv, rd)
    dst, rows = _first_rows(slots)
    dev = carry["prev"].device
    d = torch.tensor(dst, device=dev)
    r = torch.tensor(rows, device=dev)
    for ckv, pf in zip(carry["cache"], pf_caches):
        ckv[d, :Pe] = pf[r, :Pe].to(ckv.dtype)
    carry["prev"][d] = prev_a[r].long()
    carry["plen"][d] = plen_a[r].long()


@torch.inference_mode()
def engine_tick(plm, carry: dict, K: int) -> None:
    """Advance every live slot K greedy prosody codes, in place."""
    carry["prev"], carry["pos"] = plm_fast_tick(
        plm, carry["tc_plm"], carry["cache"], carry["codes"], carry["prev"], carry["pos"],
        carry["plen"], carry["total"], K)


def _gather(x: torch.Tensor, starts: List[int], n: int) -> torch.Tensor:
    """Rows' windows x[s, starts[s] : starts[s] + n] of x (S, T, ...) → (S, n, ...)."""
    idx = torch.tensor(starts, device=x.device)[:, None] + torch.arange(n, device=x.device)
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


@torch.inference_mode()
def emit_slots(g, vocoder, carry: dict, a_vec: List[int], F: int, rv: int,
               rd: int) -> torch.Tensor:
    """One F-frame chunk per slot, frames [a_s, a_s + F) (a_s multiples of
    F; a slot with no chunk due passes any a and its row is discarded):
    the batched ``streaming.emit_chunk``.  → (S, F*hop) fp32."""
    Tmax = carry["tc_expand"].shape[1]
    W = F + 2 * (rv + rd)
    wins = [emit_window(a, F, rv, rd, Tmax) for a in a_vec]
    s_vec = [s for s, _ in wins]
    tc_win = _gather(carry["tc_expand"], s_vec, W)  # (S, W, H)
    codes_win = _gather(carry["codes"], [s // 8 for s in s_vec], W // 8)  # (S, W/8)
    zq = g.vqpe.vq.decode(codes_win[None]).repeat_interleave(8, dim=1)
    mel = g.decode_latents(tc_win, zq)  # (S, W, 80)
    mel_v = _gather(mel, [mv - s for s, mv in wins], F + 2 * rv)
    wav = vocode(vocoder, mel_v.float())  # (S, (F + 2rv) * hop)
    hop = HIFIGAN_HOP_LENGTH
    return _gather(wav[..., None], [(a - mv) * hop for a, (_, mv) in zip(a_vec, wins)],
                   F * hop)[..., 0]


class ContinuousEngine:
    """Host-side scheduler over the engine's slot state.

    >>> eng = ContinuousEngine(g, plm, adm, vocoder, slots=4, max_frames=1024)
    >>> for req_id, wav in eng.run(requests):
    ...     ...

    A request is ``{"id", "phone": (1, Tp) int, "lens": (1,), "mels_prompt":
    (1, Tm, 80)}``, optionally with ``prompt_tc`` (P, D) and
    ``prompt_codes`` (P,), an in-context prosody prompt (the engine needs
    ``prompt_tokens`` > 0; prompts are fitted to that budget by tiling and
    tail truncation).  ``run`` yields ``(id, wav)`` in completion order."""

    def __init__(self, g, plm, adm, vocoder, slots: int = 8, max_frames: int = 2048,
                 chunk_frames: int = 256, prompt_tokens: int = 0, admit_tp_bucket: int = 0,
                 device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ContinuousEngine: device 'cuda' requested but no CUDA device "
                               "is available")
        self.g, self.plm, self.adm, self.vocoder = (m.to(self.device).eval()
                                                    for m in (g, plm, adm, vocoder))
        self.S = slots
        self.F, self.rv, self.rd, self.Tmax = stream_geometry(g.cfg, vocoder.cfg, max_frames,
                                                              chunk_frames)
        self.Tc = self.Tmax // 8
        self.Pe = -(-prompt_tokens // 8) * 8 if prompt_tokens > 0 else 0
        self.admit_tp_bucket = int(admit_tp_bucket)
        dtype = plm.plm.dtype
        like = torch.zeros((), dtype=dtype, device=self.device)
        D, H = plm.cfg.tc_latent_dim, g.cfg.mrte.hidden_size
        dev = self.device
        self.carry = dict(
            cache=engine_init(plm, slots, self.Tc + self.Pe, like),
            tc_plm=torch.zeros((slots, self.Tc, D), dtype=dtype, device=dev),
            tc_expand=torch.zeros((slots, self.Tmax, H), dtype=g.decoder.first_layer.weight.dtype,
                                  device=dev),
            codes=torch.zeros((slots, self.Tc), dtype=torch.long, device=dev),
            prev=torch.full((slots,), plm.cfg.bos_id, dtype=torch.long, device=dev),
            pos=torch.zeros((slots,), dtype=torch.long, device=dev),
            total=torch.zeros((slots,), dtype=torch.long, device=dev),
            plen=torch.zeros((slots,), dtype=torch.long, device=dev),
        )
        self.slot_req: List[Optional[dict]] = [None] * slots
        self.slot_emitted = [0] * slots
        self.slot_frames = [0] * slots
        self.slot_codes = [0] * slots
        self.n_ticks = 0

    @property
    def slots_busy(self) -> int:
        return sum(r is not None for r in self.slot_req)

    # ------------------------------------------------------------ admission

    def _prompt_arrays(self, reqs: List[dict]):
        """(ptc (A, Pe, D), prev_prompt (A, Pe), prev (A,), plen (A,)) of a
        wave, each prompt fitted to the budget (zeros / BOS when unprompted)."""
        D, bos = self.plm.cfg.tc_latent_dim, self.plm.cfg.bos_id
        A = len(reqs)
        ptc = np.zeros((A, self.Pe, D), np.float32)
        pcodes = np.zeros((A, self.Pe), np.int64)
        plen = np.zeros((A,), np.int64)
        prev = np.full((A,), bos, np.int64)
        for k, r in enumerate(reqs):
            if r.get("prompt_codes") is None:
                continue
            t, c = fit_prompt(r["prompt_tc"], r["prompt_codes"], self.Pe)
            ptc[k], pcodes[k] = t[0], c[0]
            plen[k] = self.Pe
            prev[k] = c[0, -1]
        prev_prompt = np.concatenate([np.full((A, 1), bos, np.int64), pcodes[:, :-1]], axis=1)
        return (torch.from_numpy(x).to(self.device) for x in (ptc, prev_prompt, prev, plen))

    def _prep(self, reqs: List[dict], Tp: int):
        """The content path of a group of requests at one phone length,
        padded to S rows by repeating its first request."""
        rows = reqs + [reqs[0]] * (self.S - len(reqs))
        phone = np.zeros((self.S, Tp), np.int64)
        lens = np.zeros((self.S,), np.int64)
        for k, r in enumerate(rows):
            phone[k, : r["phone"].shape[1]] = np.asarray(r["phone"])[0]
            lens[k] = int(np.asarray(r["lens"])[0])
        mels = torch.stack([torch.as_tensor(r["mels_prompt"])[0] for r in rows]).to(
            self.device, torch.float32)
        tce, tcp, nf = stream_prep(self.g, self.adm, torch.from_numpy(phone).to(self.device),
                                   torch.from_numpy(lens).to(self.device), mels, self.Tmax)
        return tce[: len(reqs)], tcp[: len(reqs)], nf[: len(reqs)]

    def _admit(self, pairs: List[Tuple[int, dict]]) -> None:
        """Admit a wave: content prep per group of one phone bucket and one
        prompt-mel length, [the prompts' prefill,] one slot install."""
        if tracing.enabled():
            now = time.perf_counter_ns()
            for _, r in pairs:
                if "t_submit_ns" in r:
                    tracing.record("engine.queue_wait", r["t_submit_ns"], now)
        wave_prompted = any(r.get("prompt_codes") is not None for _, r in pairs)
        if wave_prompted and self.Pe == 0:
            raise ValueError("request carries a prosody prompt but the engine was built with "
                             "prompt_tokens=0")
        groups: Dict[tuple, List[int]] = {}
        for i, (_, r) in enumerate(pairs):
            tp = int(r["phone"].shape[1])
            if self.admit_tp_bucket:
                if tp > self.admit_tp_bucket:
                    raise ValueError(f"request has {tp} phones > admit_tp_bucket="
                                     f"{self.admit_tp_bucket}")
                bucket = self.admit_tp_bucket
            else:
                bucket = -(-tp // 16) * 16
            groups.setdefault((bucket, int(r["mels_prompt"].shape[1])), []).append(i)
        parts = [None] * len(pairs)
        for (Tp, _), idxs in groups.items():
            tce, tcp, nf = self._prep([pairs[i][1] for i in idxs], Tp)
            for k, i in enumerate(idxs):
                parts[i] = (tce[k], tcp[k], nf[k])
        order = list(range(len(pairs))) + [0] * (self.S - len(pairs))
        slots = [pairs[i][0] for i in order]
        tce, tcp, nf = (torch.stack([parts[i][j] for i in order]) for j in range(3))
        if wave_prompted:
            ptc, prev_prompt, prev, plen = self._prompt_arrays([pairs[i][1] for i in order])
            pf = prefill_slots(self.plm, ptc, prev_prompt, self.Tc + self.Pe)
            admit_slots_prompted(self.carry, slots, tcp, tce, nf, prev, plen, pf, self.Pe,
                                 self.Tc, self.Tmax, self.rv, self.rd)
        else:
            admit_slots(self.carry, slots, tcp, tce, nf, self.plm.cfg.bos_id, self.Tc,
                        self.Tmax, self.rv, self.rd)
        frames = nf.cpu().tolist()  # the wave's one sync: its frame counts plan the emits
        for k, (slot, req) in enumerate(pairs):
            self.slot_req[slot] = req
            self.slot_emitted[slot] = 0
            self.slot_codes[slot] = 0
            self.slot_frames[slot] = int(frames[k])

    # ------------------------------------------------------------ ticks

    def _tick_plan(self) -> Tuple[list, list]:
        """Plan one tick: advance the host's code counters, pick each slot's
        emit start, free the slots that take their last chunk.  Returns
        ``(a_vec, [(req, chunk j, slot)])``."""
        Cc = self.F // 8
        a_vec, items = [0] * self.S, []
        for s in range(self.S):
            req = self.slot_req[s]
            if req is None:
                continue
            self.slot_codes[s] = min(self.slot_codes[s] + Cc, self.Tc)
            j = self.slot_emitted[s]
            need = min(self.Tc, -(-min((j + 1) * self.F + self.rv + self.rd, self.Tmax) // 8))
            if self.slot_codes[s] >= need and j * self.F < self.slot_frames[s]:
                a_vec[s] = j * self.F
                items.append((req, j, s))
                self.slot_emitted[s] = j + 1
                if (j + 1) * self.F >= self.slot_frames[s]:
                    self.slot_req[s] = None
        return a_vec, items

    def run(self, requests: List[dict]) -> Iterator[Tuple[Any, np.ndarray]]:
        """Drive the engine over a list of requests, yielding ``(id, wav)``
        in completion order; each is submitted when the run starts."""
        if tracing.enabled():
            now = time.perf_counter_ns()
            requests = [{"t_submit_ns": now, **r} for r in requests]
        yield from self._run(list(requests), live=None)

    def run_live(self, rq, stop) -> Iterator[Tuple[Any, np.ndarray]]:
        """The serving loop: requests arrive on ``rq`` (a ``queue.Queue``)
        while the engine runs and are admitted at the next tick; ends when
        ``stop`` (a ``threading.Event``) is set and the work in flight has
        drained."""
        yield from self._run([], live=(rq, stop))

    def _run(self, queue: List[dict], live) -> Iterator[Tuple[Any, np.ndarray]]:
        bufs: Dict[int, List[np.ndarray]] = {}
        totals: Dict[int, int] = {}  # frames of each request in flight
        pending = None  # (device wavs (S, F*hop), [(req, chunk j, slot)])
        hop = HIFIGAN_HOP_LENGTH

        def busy():
            return any(r is not None for r in self.slot_req)

        def flush(p):
            wavs = p[0].cpu().numpy()
            now = time.perf_counter_ns() if tracing.enabled() else None
            for req, j, s in p[1]:
                if j == 0 and now is not None and "t_submit_ns" in req:
                    tracing.record("engine.first_chunk", req["t_submit_ns"], now)
                total = totals[id(req)]
                w = wavs[s]
                if (j + 1) * self.F > total:
                    w = w[: (total - j * self.F) * hop]
                bufs[id(req)].append(w)
                if (j + 1) * self.F >= total:
                    totals.pop(id(req))
                    yield req["id"], np.concatenate(bufs.pop(id(req)))

        def drain_live() -> bool:
            if live is None:
                return False
            rq, stop = live
            while True:
                try:
                    queue.append(rq.get_nowait())
                except Exception:
                    break
            return not stop.is_set()

        more = drain_live()
        while queue or busy() or pending or more:
            more = drain_live()
            if live is not None and not queue and not busy() and not pending:
                try:  # idle: wait briefly for the next request
                    queue.append(live[0].get(timeout=0.05))
                except Exception:
                    pass
                if not queue:
                    continue
            pairs = [(s, queue.pop(0)) for s in range(self.S)
                     if self.slot_req[s] is None and queue]
            if pairs:
                with tracing.span("engine.admit", len(pairs)):
                    self._admit(pairs)
                for s, req in pairs:
                    bufs[id(req)] = []
                    totals[id(req)] = self.slot_frames[s]
            new_pending = None
            if busy():
                a_vec, items = self._tick_plan()
                with tracing.span("engine.tick", self.F // 8):
                    engine_tick(self.plm, self.carry, self.F // 8)
                self.n_ticks += 1
                if items:
                    with tracing.span("engine.emit", len(items)):
                        new_pending = (emit_slots(self.g, self.vocoder, self.carry, a_vec,
                                                  self.F, self.rv, self.rd), items)
            if pending is not None:  # the previous tick's audio, while this one runs
                yield from flush(pending)
            pending = new_pending
        if pending is not None:
            yield from flush(pending)
