"""Zero-shot cloning on held-out speakers (port of ``tools/heldout_eval.py``).

    python -m megatts2_tpu_torch.tools.heldout_eval --train_root DIR \\
        --ckpt_root DIR/ckpts50k --gan_config DIR/gan50k.yaml --out OUT [--quant_int8] [--device cuda]

Evaluates a stack trained by ``at_scale_stack`` on speakers it never saw:

* held-out speakers generated fresh (the files byte for byte those of
  the JAX tool), then prepared through the user's data path
  (``prepare_ds`` stages 0-2 with the trained generator) so that
  ``resolve_prompt`` works on them as on a training dataset;
* disjoint f0 bands: speakers log-spaced at ratio 1.23 from 75 Hz with a
  ±8% band, so an in-band hit is evidence, not chance (checked: the run
  raises when two measured bands overlap); formants on an F1-linear ×
  F2-permuted grid;
* n > 1 a cell: each speaker × ``TEXTS`` (word permutations) × one greedy
  and ``--n_seeds`` sampled decodes (``Megatts``' seeded
  ``torch.Generator``; JAX's PRNG streams are not reproduced), each
  metric reported as mean ± std.

Also measures the generator and vocoder ceiling: a decode from the
ground-truth stage-2 codes and durations, bypassing the PLM and ADM, so
that a failure points at a stage.  Metrics as ``e2e_quality``'s, the
f0 by autocorrelation.  Prints a JSON line for the ceiling, one a
speaker and the report, each with the card's name and power limit under
``device``.  Runs on the card unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import time
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from .e2e_quality import (dtw_mcd, duration_mae, load_tts, log_mel, mean_cepstra, mfcc_from_mel,
                          phone_ids)


def f0_acf(y: np.ndarray, sr: int = 16000, lo: float = 60.0, hi: float = 400.0) -> float:
    """Autocorrelation f0: robust where the harmonic-product estimator
    octave-errors.  Picks the smallest lag whose ACF local maximum is
    within 95% of the largest, then refines it by a parabola."""
    y = np.asarray(y, np.float64)
    if y.size < sr // 4:
        return 0.0
    y = y - y.mean()
    n = y.size
    f = np.fft.rfft(y, 2 * n)
    acf = np.fft.irfft(f * np.conj(f))[:n]
    acf /= acf[0] + 1e-12
    lag_min, lag_max = int(sr / hi), min(int(sr / lo), n - 2)
    seg = acf[lag_min:lag_max + 1]
    peaks = [i for i in range(1, seg.size - 1) if seg[i] >= seg[i - 1] and seg[i] >= seg[i + 1]]
    if not peaks:
        return 0.0
    best = max(seg[i] for i in peaks)
    i = next(i for i in peaks if seg[i] >= 0.95 * best)
    a, b, c = seg[i - 1], seg[i], seg[i + 1]
    denom = a - 2 * b + c
    di = 0.5 * (a - c) / denom if abs(denom) > 1e-12 else 0.0
    return float(sr / (lag_min + i + di))


SR = 16000
WORDS = ["hello", "world", "nice", "day", "of", "speech"]
# word permutations: the same 6 phones in other orders
TEXTS = [
    "hello world nice day of speech",
    "speech of day nice world hello",
    "nice day of speech hello world",
    "world hello speech of day nice",
]


def build_heldout_corpus(root: str, n_speakers: int = 8, n_per_spk: int = 8, seed: int = 999,
                         dur_s: float = 3.2) -> tuple:
    """Held-out speakers with disjoint f0 bands and separated formants.

    With band tolerance t (band = measured median × (1 ± t)) and an
    utterance's f0 wobble in [0, +5%], adjacent bands are disjoint iff the
    speakers' spacing ratio r exceeds (1 + t) / (1 - t): 1.174 at t = 0.08;
    r = 1.23 (75..320 Hz for 8 speakers), inside the estimators' 60..400 Hz."""
    from ..utils.audio import save_wav

    wavs = os.path.join(root, "wavs")
    tgs = os.path.join(root, "textgrids")
    ds = os.path.join(root, "ds")
    os.makedirs(ds, exist_ok=True)
    rng = np.random.RandomState(seed)
    n = int(dur_s * SR)
    t = np.arange(n) / SR
    seg = dur_s / len(WORDS)
    iv = "".join(
        f"""        intervals [{j+1}]:
            xmin = {j*seg}
            xmax = {(j+1)*seg}
            text = "{w}"
"""
        for j, w in enumerate(WORDS)
    )
    tg_body = (
        'File type = "ooTextFile"\nObject class = "TextGrid"\n'
        f"xmin = 0\nxmax = {dur_s}\ntiers? <exists>\nsize = 1\nitem []:\n"
        "    item [1]:\n"
        '        class = "IntervalTier"\n        name = "phones"\n'
        f"        xmin = 0\n        xmax = {dur_s}\n"
        f"        intervals: size = {len(WORDS)}\n" + iv
    )
    # F1 linear, F2 on a shuffled grid: adjacent-F1 speakers differ in F2
    f2_perm = [3, 7, 1, 5, 0, 4, 2, 6]
    speakers = {}
    for spk_i in range(n_speakers):
        spk = f"eval{spk_i:02d}"
        os.makedirs(os.path.join(wavs, spk), exist_ok=True)
        os.makedirs(os.path.join(tgs, spk), exist_ok=True)
        f0_base = 75.0 * 1.23 ** spk_i
        F1 = 320.0 + 70.0 * spk_i
        F2 = 1250.0 + 1650.0 * f2_perm[spk_i % 8] / 7.0

        def env(f, F1=F1, F2=F2):
            return (0.08 + np.exp(-((f - F1) ** 2) / (2 * 140.0 ** 2))
                    + 0.8 * np.exp(-((f - F2) ** 2) / (2 * 260.0 ** 2)))

        speakers[spk] = {"f0_base": f0_base, "F1": F1, "F2": F2}
        for i in range(n_per_spk):
            f0 = f0_base * (1 + 0.05 * rng.rand())
            n_harm = max(3, int(3800.0 / f0))
            # the fundamental has an amplitude floor: far from F1 the plain
            # envelope leaves it nearly silent, and the harmonic-product
            # estimator octave-errs; a strong fundamental is also the
            # shape of voiced speech
            y = sum(
                (max(env(h * f0), 0.5 if h == 1 else 0.0) / np.sqrt(h))
                * np.sin(2 * np.pi * f0 * h * t + rng.rand() * 6.28)
                for h in range(1, n_harm + 1)
            )
            y *= 0.5 + 0.5 * np.sin(2 * np.pi * (2 + rng.rand()) * t) ** 2
            y = (y + 0.01 * rng.randn(n)).astype(np.float32)
            y /= np.abs(y).max() + 1e-6
            uid = f"{spk}_u{i}"
            save_wav(os.path.join(wavs, spk, uid + ".wav"), y)
            with open(os.path.join(wavs, spk, uid + ".txt"), "w") as f:
                f.write(" ".join(WORDS))
            with open(os.path.join(tgs, spk, uid + ".TextGrid"), "w") as f:
                f.write(tg_body)
    return wavs, tgs, ds, speakers


def prepare_heldout(root: str, gan_ckpt: str, gan_config: str, train_ds: str,
                    device="cuda") -> str:
    """The user's data path over the held-out corpus: stages 0 and 1, then
    stage 2 with the trained generator, so ``resolve_prompt`` works on it."""
    from ..prepare_ds import main as prep_main

    wavs = os.path.join(root, "wavs")
    tgs = os.path.join(root, "textgrids")
    ds = os.path.join(root, "ds")
    if not os.path.exists(os.path.join(ds, "cuts_train.jsonl.gz")):
        prep_main(["--stage", "0", "--wavtxt_path", wavs, "--num_workers", "1"])
        prep_main(["--stage", "1", "--wavtxt_path", wavs, "--text_grid_path", tgs,
                   "--ds_path", ds, "--test_set_ratio", "0.0", "--device", str(device)])
    # the same 6 words: the same sorted symbol table, so the trained
    # models' phone ids hold
    with open(os.path.join(ds, "unique_text_tokens.k2symbols")) as f:
        own = f.read()
    with open(os.path.join(train_ds, "unique_text_tokens.k2symbols")) as f:
        train = f.read()
    if own != train:
        raise ValueError("held-out symbol table diverged from training's")
    if not os.path.isdir(os.path.join(ds, "latents")):
        prep_main(["--stage", "2", "--ds_path", ds, "--generator_ckpt", gan_ckpt,
                   "--generator_config", gan_config, "--device", str(device)])
    return ds


def _agg(xs):
    xs = [x for x in xs if np.isfinite(x)]
    if not xs:
        return {"mean": float("nan"), "std": float("nan"), "n": 0}
    return {"mean": round(float(np.mean(xs)), 3), "std": round(float(np.std(xs)), 3),
            "n": len(xs)}


@torch.no_grad()
def ceiling_decode(g, vocoder, phone: torch.Tensor, mel_prompt: torch.Tensor,
                   phone_len: torch.Tensor, p_code: torch.Tensor, dt: torch.Tensor,
                   max_frames: int) -> torch.Tensor:
    """A waveform (B, max_frames * hop) from ground-truth codes (B, T8) and
    durations (B, Tp): the MRTE's latents, length-regulated to
    ``max_frames``; the codebook's vectors repeated ×8 to frame rate, then
    zero-padded or cut to that budget; the mel decoder; the vocoder."""
    from ..models.megatts import vocode
    from ..ops import regulate_length

    tc = g.mrte.tc_latent(phone, mel_prompt, phone_len)
    tc_expand = regulate_length(tc, dt, max_frames)
    # RVQ.decode takes (n_q, B, T): one quantizer
    zq = g.vqpe.vq.decode(p_code[None]).repeat_interleave(8, dim=1)
    T = tc_expand.shape[1]
    zq = F.pad(zq, (0, 0, 0, T - zq.shape[1])) if zq.shape[1] < T else zq[:, :T]
    mel_hat = g.decode_latents(tc_expand, zq)
    return vocode(vocoder, mel_hat.float())


def run(train_root: str, ckpt_root: str, gan_config: str, out: str, n_speakers: int = 8,
        n_seeds: int = 3, temperature: float = 0.7, top_k: int = 32, band_tol: float = 0.08,
        max_frames: int = 512, quant_int8: bool = False, skip_ceiling: bool = False,
        device="cuda", report_path: str = None, emit: Callable = print) -> dict:
    """The held-out evaluation; returns the report it prints."""
    from ..data import LatentReader, load_prompt_manifest, resolve_prompt
    from ..training.checkpoints import best_checkpoint
    from ..training.lm_trainers import train_device
    from ..utils.audio import load_wav
    from .bw_ceiling import card_name

    dev = train_device(device)
    card = card_name(dev)
    t_start = time.time()
    root = out
    if not os.path.isdir(os.path.join(root, "wavs")):
        build_heldout_corpus(root, n_speakers=n_speakers)
    gan_ck = best_checkpoint(os.path.join(ckpt_root, "gan"))
    ds = prepare_heldout(root, gan_ck, gan_config, os.path.join(train_root, "ds"), device)
    sym = os.path.join(ds, "unique_text_tokens.k2symbols")

    def make_tts(temp: float, seed: int):
        return load_tts(gan_ck, gan_config, ckpt_root, train_root, sym, dev, max_frames,
                        quant_int8, plm_temperature=temp, plm_top_k=top_k if temp > 0 else 0,
                        seed=seed)

    # ---- per-speaker statistics from the held-out corpus itself ----
    speakers = sorted(os.path.basename(p) for p in glob.glob(os.path.join(root, "wavs", "*"))
                      if os.path.isdir(p))
    spk_wavs = {s: sorted(glob.glob(os.path.join(root, "wavs", s, "*.wav"))) for s in speakers}
    spk_f0 = {s: float(np.median([f0_acf(load_wav(w)) for w in ws[:6]]))
              for s, ws in spk_wavs.items()}
    # the property this corpus exists for: disjoint bands
    meds = sorted(spk_f0.values())
    for a, b in zip(meds, meds[1:]):
        if not a * (1 + band_tol) < b * (1 - band_tol):
            raise ValueError(f"eval bands overlap: {a:.1f} vs {b:.1f} at tol {band_tol}")
    spk_env = {s: np.mean([mean_cepstra(load_wav(w), dev) for w in ws[:6]], axis=0)
               for s, ws in spk_wavs.items()}

    manifest = load_prompt_manifest(ds)
    cut_by_spk = {}
    for c in manifest:
        cut_by_spk.setdefault(c.speaker, []).append(c)

    def line(rec: dict) -> None:
        emit(json.dumps({**rec, "device": card}))

    report = {
        "mode": "int8" if quant_int8 else "fp32",
        "train_root": train_root, "heldout_root": root,
        "design": {
            "n_speakers": len(speakers), "n_texts": len(TEXTS), "n_seeds": n_seeds,
            "temperature": temperature, "top_k": top_k, "band_tol": band_tol,
            "f0_spacing_ratio": 1.23,
            "bands_disjoint": True,  # checked above
        },
        "speaker_f0_hz": {s: round(f, 1) for s, f in spk_f0.items()},
        "ckpts": {"gan": gan_ck},
    }

    tts_greedy = make_tts(0.0, 0)

    # ---- ceiling: decode from the ground-truth codes and durations (no
    # PLM, no ADM): the MRTE, the codebook, the mel decoder, the vocoder ----
    if not skip_ceiling:
        reader = LatentReader(ds)
        ceil_rows = []
        for spk in speakers:
            # the ground-truth codes of the utterance the MCD reference is
            # (the last wav, held out of the prompt set)
            ref_uid = os.path.splitext(os.path.basename(spk_wavs[spk][-1]))[0]
            cut = next(c for c in cut_by_spk[spk] if c.id == ref_uid)
            lat = reader.read(cut)
            p_code = np.asarray(lat["p_code"]).reshape(1, -1).astype(np.int64)
            ids = phone_ids(cut, tts_greedy.token2idx)[None]
            dt = np.asarray(cut.duration_tokens, np.int64)[None][:, : ids.shape[1]]
            # 2 prompt utterances = 400 frames, inside the GAN's 512-frame
            # timbre window
            prompt_mels = np.concatenate([log_mel(load_wav(w), dev) for w in spk_wavs[spk][:2]],
                                         axis=0)[None]
            wav = ceiling_decode(
                tts_greedy.g, tts_greedy.vocoder, torch.from_numpy(ids).to(dev),
                torch.from_numpy(prompt_mels).to(dev), torch.tensor([ids.shape[1]], device=dev),
                torch.from_numpy(p_code).to(dev), torch.from_numpy(dt).to(dev),
                max_frames).cpu().numpy()[0]
            wav = wav[: int(dt.sum()) * 256]
            f0 = f0_acf(wav)
            lo, hi = spk_f0[spk] * (1 - band_tol), spk_f0[spk] * (1 + band_tol)
            c_wav = mean_cepstra(wav, dev)
            pred = min(spk_env, key=lambda s: float(np.linalg.norm(spk_env[s] - c_wav)))
            mcd = dtw_mcd(mfcc_from_mel(log_mel(load_wav(spk_wavs[spk][-1]), dev)),
                          mfcc_from_mel(log_mel(wav, dev)))
            ceil_rows.append({"spk": spk, "f0": round(f0, 1), "in_band": bool(lo <= f0 <= hi),
                              "classified_as": pred, "mcd_db": round(mcd, 2)})
        report["ceiling_gt_codes"] = {
            "rows": ceil_rows,
            "in_band_frac": round(float(np.mean([r["in_band"] for r in ceil_rows])), 3),
            "classification_acc": round(
                float(np.mean([r["classified_as"] == r["spk"] for r in ceil_rows])), 3),
            "mcd_db": _agg([r["mcd_db"] for r in ceil_rows]),
        }
        line({"phase": "ceiling", **report["ceiling_gt_codes"]})

    # ---- the grid: speakers × texts × (greedy + n_seeds sampled) ----
    out_dir = os.path.join(root, "gen_" + report["mode"])
    os.makedirs(out_dir, exist_ok=True)
    tts_sampled = make_tts(temperature, 12345)
    rows = []
    dur_maes = []
    for spk in speakers:
        lo, hi = spk_f0[spk] * (1 - band_tol), spk_f0[spk] * (1 + band_tol)
        pdir = os.path.join(out_dir, f"prompt_{spk}")
        os.makedirs(pdir, exist_ok=True)
        # 2 mel-prompt utterances; the prosody prompt is u0..u2, so the MCD
        # reference (the last utterance) stays out of every prompt
        prompt_wavs = spk_wavs[spk][:2]
        for w in prompt_wavs:
            dst = os.path.join(pdir, os.path.basename(w))
            if not os.path.exists(dst):
                shutil.copy(w, dst)
        prompt_len = load_wav(prompt_wavs[0]).shape[0]
        pf = resolve_prompt(ds, cut_ids=[f"{spk}_u{i}" for i in range(3)], manifest=manifest)
        c_ref = mfcc_from_mel(log_mel(load_wav(spk_wavs[spk][-1]), dev))
        # duration MAE: deterministic, once a speaker on corpus phones
        dur_maes.append(duration_mae(tts_greedy, cut_by_spk[spk][0], prompt_wavs))

        for ti, text in enumerate(TEXTS):
            for mode_i in range(1 + n_seeds):  # 0 = greedy
                sampled = mode_i > 0
                tts = tts_sampled if sampled else tts_greedy
                tag = f"{spk}_t{ti}_{'s%d' % mode_i if sampled else 'greedy'}"
                full = tts(pdir, text, out_path=os.path.join(out_dir, f"gen_{tag}.wav"),
                           prompt_features=pf)
                gen = full[prompt_len:]
                f0 = f0_acf(gen)
                c_gen = mfcc_from_mel(log_mel(gen, dev))
                c_mean = c_gen.mean(axis=0)
                pred = min(spk_env, key=lambda s: float(np.linalg.norm(spk_env[s] - c_mean)))
                mcd = dtw_mcd(c_ref, c_gen) if c_gen.shape[0] > 8 else float("nan")
                rows.append({"spk": spk, "text": ti, "decode": "sampled" if sampled else "greedy",
                             "f0": round(f0, 1), "in_band": bool(lo <= f0 <= hi),
                             "classified": pred == spk, "classified_as": pred,
                             "mcd_db": round(mcd, 2)})
        done = [r for r in rows if r["spk"] == spk]
        line({"phase": "speaker_done", "spk": spk,
              "in_band": round(float(np.mean([r["in_band"] for r in done])), 3),
              "cls": round(float(np.mean([r["classified"] for r in done])), 3),
              "elapsed_s": round(time.time() - t_start, 1)})

    for decode in ("greedy", "sampled"):
        sel = [r for r in rows if r["decode"] == decode]
        per_spk_cls = [np.mean([r["classified"] for r in sel if r["spk"] == s]) for s in speakers]
        per_spk_band = [np.mean([r["in_band"] for r in sel if r["spk"] == s]) for s in speakers]
        report[decode] = {"n_decodes": len(sel), "envelope_classification": _agg(per_spk_cls),
                          "prompted_f0_in_band": _agg(per_spk_band),
                          "mcd_db": _agg([r["mcd_db"] for r in sel])}
    report["duration_mae_frames"] = _agg(dur_maes)
    report["rows"] = rows
    report["wall_s"] = round(time.time() - t_start, 1)
    report["device"] = card
    text = json.dumps(report)
    emit(text)
    if report_path:
        with open(report_path, "w") as f:
            f.write(text + "\n")
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train_root", default="/tmp/pipe10k")
    ap.add_argument("--ckpt_root", default="/tmp/pipe10k/ckpts50k")
    ap.add_argument("--gan_config", default="/tmp/pipe10k/gan50k.yaml")
    ap.add_argument("--out", default="/tmp/heldout")
    ap.add_argument("--n_speakers", type=int, default=8)
    ap.add_argument("--n_seeds", type=int, default=3)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--top_k", type=int, default=32)
    ap.add_argument("--band_tol", type=float, default=0.08,
                    help="f0 band = measured median * (1 +/- tol); 0.08 is "
                         "disjoint at the 1.23 speaker spacing (see "
                         "build_heldout_corpus docstring)")
    ap.add_argument("--max_frames", type=int, default=512)
    ap.add_argument("--quant_int8", action="store_true")
    ap.add_argument("--skip_ceiling", action="store_true")
    ap.add_argument("--report", default=None, help="also write JSON here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    return run(a.train_root, a.ckpt_root, a.gan_config, a.out, a.n_speakers, a.n_seeds,
               a.temperature, a.top_k, a.band_tol, a.max_frames, a.quant_int8, a.skip_ceiling,
               a.device, a.report)


if __name__ == "__main__":
    main()
