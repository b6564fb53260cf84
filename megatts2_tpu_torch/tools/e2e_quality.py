"""End-to-end quality of a self-trained stack (port of ``tools/e2e_quality.py``).

    python -m megatts2_tpu_torch.tools.e2e_quality --root DIR [--quant_int8] [--device cuda]

Takes the root of a ``train_curve --stages gan,vocoder,plm,adm`` run
(every stage trained from scratch in the repo) and measures zero-shot
synthesis through ``Megatts``, built by ``megatts_from_pretrained`` from
each stage's best checkpoint (the GAN's EMA generator when it has one),
in bf16, for every corpus speaker:

* timbre transfer: each speaker's envelope centroid (mean c1..c13
  cepstra of corpus utterances); the generated audio must classify to
  the prompt speaker by nearest centroid;
* prosody cloning: the f0 of the decode with a same-speaker prosody
  prompt (``resolve_prompt``) inside the speaker's band (corpus median ±
  ``--band_tol``), and that decode differing from the one from BOS;
* DTW mel-cepstral distortion against a corpus rendition of the same words;
* duration MAE: the ADM's durations on a corpus cut's phones against its
  ground-truth duration tokens.

Every mel is the port's ``mel_spectrogram`` on the device (kernel A on
the card).  Prints one JSON line with the JAX tool's keys and the card's
name and power limit under ``device``.  Runs on the card unless given
``--device cpu``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
from typing import Callable

import numpy as np
import torch


def dominant_f0(y: np.ndarray, sr: int = 16000, lo: float = 60.0, hi: float = 400.0) -> float:
    """Fundamental estimate within [lo, hi] Hz via the harmonic product
    spectrum (spectra downsampled ×1..×4 multiplied): robust when formant
    resonances make a harmonic the strongest FFT peak."""
    y = np.asarray(y, np.float64)
    if y.size < sr // 4:
        return 0.0
    spec = np.abs(np.fft.rfft(y * np.hanning(y.size)))
    freqs = np.fft.rfftfreq(y.size, 1.0 / sr)
    n = spec.size
    hps = np.log(spec + 1e-12).copy()
    for k in (2, 3, 4):
        hps[: n // k] += np.log(spec[::k][: n // k] + 1e-12)
    band = (freqs >= lo) & (freqs <= hi) & (freqs < freqs[n // 4 - 1])
    return float(freqs[band][np.argmax(hps[band])])


def mfcc_from_mel(logmel: np.ndarray, n_coef: int = 13) -> np.ndarray:
    """(T, n_mels) log-mel → (T, n_coef) cepstra via DCT-II (c1..c13)."""
    from scipy.fftpack import dct

    return dct(logmel, type=2, axis=-1, norm="ortho")[:, 1 : n_coef + 1]


def dtw_mcd(c_ref: np.ndarray, c_gen: np.ndarray) -> float:
    """Mel-cepstral distortion (dB): mean frame distance along the DTW
    alignment path (standard 10*sqrt(2)/ln10 scaling)."""
    Tr, Tg = c_ref.shape[0], c_gen.shape[0]
    d = np.sqrt(((c_ref[:, None, :] - c_gen[None, :, :]) ** 2).sum(-1))  # (Tr, Tg)
    acc = np.full((Tr + 1, Tg + 1), np.inf)
    steps = np.zeros((Tr + 1, Tg + 1), np.int64)
    acc[0, 0] = 0.0
    for i in range(1, Tr + 1):
        ai, ai1, di = acc[i], acc[i - 1], d[i - 1]
        si, si1 = steps[i], steps[i - 1]
        for j in range(1, Tg + 1):
            best = ai1[j - 1]
            sbest = si1[j - 1]
            if ai1[j] < best:
                best, sbest = ai1[j], si1[j]
            if ai[j - 1] < best:
                best, sbest = ai[j - 1], si[j - 1]
            ai[j] = di[j - 1] + best
            si[j] = sbest + 1
    return float(10.0 * np.sqrt(2.0) / np.log(10.0) * acc[Tr, Tg] / max(steps[Tr, Tg], 1))


def log_mel(wav: np.ndarray, device) -> np.ndarray:
    """(T, 80) log-mel of a waveform: the port's ``mel_spectrogram`` on
    ``device`` (kernel A on the card), brought back to the host."""
    from ..ops import mel_spectrogram

    sig = torch.from_numpy(np.ascontiguousarray(wav, dtype=np.float32)).to(device)
    with torch.no_grad():
        return mel_spectrogram(sig).cpu().numpy()


def mean_cepstra(wav: np.ndarray, device) -> np.ndarray:
    """A waveform's envelope: its mean c1..c13 cepstra."""
    return mfcc_from_mel(log_mel(wav, device)).mean(axis=0)


def phone_ids(cut, token2idx: dict) -> np.ndarray:
    """A cut's phone ids, skipping separators the symbol table lacks, as
    ``Megatts.phone_ids`` does."""
    return np.array([token2idx[p] for p in cut.phone_tokens
                     if not (p in ("_", "-") and p not in token2idx)], np.int64)


@torch.no_grad()
def duration_mae(tts, cut, prompt_wavs: list) -> float:
    """The ADM's durations on ``cut``'s phones (the MRTE's latents against
    the prompt wavs' mels) against its ground-truth duration tokens."""
    from ..models.adm import adm_infer
    from ..utils.audio import load_wav

    ids = phone_ids(cut, tts.token2idx)
    mel = np.concatenate([log_mel(load_wav(w), tts.device) for w in prompt_wavs], axis=0)[None]
    dev = tts.device
    tc = tts.g.mrte.tc_latent(torch.from_numpy(ids[None]).to(dev), torch.from_numpy(mel).to(dev),
                              torch.tensor([ids.size], device=dev))
    dt = adm_infer(tts.adm, tc.float()).cpu().numpy()[0, : ids.size]
    true_dt = np.asarray(cut.duration_tokens[: ids.size], np.float64)
    return float(np.abs(dt[: true_dt.size] - true_dt).mean())


def load_tts(gan_ckpt: str, gan_config: str, ckpt_root: str, config_root: str, symbol_table: str,
             device, max_frames: int, quant_int8: bool, **kwargs):
    """``Megatts`` from the best checkpoint of each stage under
    ``ckpt_root/{plm,adm,vocoder}``, the generator from ``gan_ckpt``, the
    configs ``config_root/{plm,adm,vocoder}.yaml``; bf16 on ``device``."""
    from ..config import VocosConfig, load_vocoder_config
    from ..models.pretrained import megatts_from_pretrained
    from ..training.checkpoints import best_checkpoint

    voc_config = os.path.join(config_root, "vocoder.yaml")
    voc_cfg, _, _ = load_vocoder_config(voc_config)
    return megatts_from_pretrained(
        gan_ckpt, gan_config,
        best_checkpoint(os.path.join(ckpt_root, "plm")), os.path.join(config_root, "plm.yaml"),
        best_checkpoint(os.path.join(ckpt_root, "adm")), os.path.join(config_root, "adm.yaml"),
        symbol_table,
        vocoder="vocos" if isinstance(voc_cfg, VocosConfig) else "hifigan",
        vocoder_ckpt=best_checkpoint(os.path.join(ckpt_root, "vocoder")),
        vocoder_config=voc_config, max_frames=max_frames, dtype=torch.bfloat16, device=device,
        quant_int8=quant_int8, **kwargs)


def run(root: str, out_dir: str = None, text: str = "hello world nice day of speech",
        max_frames: int = 512, n_prompt_wavs: int = 3, band_tol: float = 0.25,
        quant_int8: bool = False, device="cuda", emit: Callable = print) -> dict:
    """Measure the stack under ``root``; returns the record it prints."""
    from ..data import load_prompt_manifest, resolve_prompt
    from ..training.checkpoints import best_checkpoint
    from ..training.lm_trainers import train_device
    from ..utils.audio import load_wav
    from .bw_ceiling import card_name

    device = train_device(device)
    card = card_name(device)
    ds = os.path.join(root, "ds")
    out_dir = out_dir or os.path.join(root, "e2e_out")
    os.makedirs(out_dir, exist_ok=True)
    tts = load_tts(best_checkpoint(os.path.join(root, "ckpts", "gan")),
                   os.path.join(root, "gan.yaml"), os.path.join(root, "ckpts"), root,
                   os.path.join(ds, "unique_text_tokens.k2symbols"), device, max_frames,
                   quant_int8)

    # per-speaker statistics from the corpus itself
    speakers = sorted(os.path.basename(p) for p in glob.glob(os.path.join(root, "wavs", "*"))
                      if os.path.isdir(p))
    spk_wavs = {s: sorted(glob.glob(os.path.join(root, "wavs", s, "*.wav"))) for s in speakers}
    spk_f0 = {s: float(np.median([dominant_f0(load_wav(w)) for w in ws[:6]]))
              for s, ws in spk_wavs.items()}
    # timbre is the spectral envelope (the MRTE's job), f0 prosody (the
    # codes' job, checked on the prompted decode)
    spk_env = {s: np.mean([mean_cepstra(load_wav(w), device) for w in ws[:6]], axis=0)
               for s, ws in spk_wavs.items()}

    manifest = load_prompt_manifest(ds)
    cut_by_spk = {}
    for c in manifest:
        cut_by_spk.setdefault(c.speaker, c)

    report = {"root": root, "text": text, "plm_decode": "int8" if quant_int8 else "fp32",
              "speaker_f0_hz": {s: round(f, 1) for s, f in spk_f0.items()}}
    per_spk = {}
    correct = 0
    mcds, dur_maes = [], []
    prompted_ok = prompted_diff = 0
    for spk in speakers:
        lo, hi = spk_f0[spk] * (1 - band_tol), spk_f0[spk] * (1 + band_tol)
        wavs = spk_wavs[spk][:n_prompt_wavs]
        pdir = os.path.join(out_dir, f"prompt_{spk}")
        os.makedirs(pdir, exist_ok=True)
        for w in wavs:
            dst = os.path.join(pdir, os.path.basename(w))
            if not os.path.exists(dst):
                shutil.copy(w, dst)
        full = tts(pdir, text, out_path=os.path.join(out_dir, f"gen_{spk}.wav"))
        prompt_len = load_wav(wavs[0]).shape[0]
        gen = full[prompt_len:]
        f0 = dominant_f0(gen)
        in_band = lo <= f0 <= hi
        c_env = mean_cepstra(gen, device)
        pred = min(spk_env, key=lambda s: float(np.linalg.norm(spk_env[s] - c_env)))
        correct += pred == spk

        # MCD against a same-speaker corpus rendition (13 cepstra, DTW)
        c_ref = mfcc_from_mel(log_mel(load_wav(spk_wavs[spk][-1]), device))
        c_gen = mfcc_from_mel(log_mel(gen, device))
        mcd = dtw_mcd(c_ref, c_gen) if c_gen.shape[0] > 8 else float("nan")
        mcds.append(mcd)

        dur_mae = duration_mae(tts, cut_by_spk[spk], wavs)
        dur_maes.append(dur_mae)

        # the prompted decode must stay in band and differ from BOS-only
        pf = resolve_prompt(ds, speaker=spk, n=3)
        full_p = tts(pdir, text, out_path=os.path.join(out_dir, f"gen_{spk}_prompted.wav"),
                     prompt_features=pf)
        gen_p = full_p[prompt_len:]
        f0_p = dominant_f0(gen_p)
        in_band_p = lo <= f0_p <= hi
        nmin = min(gen.shape[0], gen_p.shape[0])
        differs = not np.allclose(gen[:nmin], gen_p[:nmin])
        prompted_ok += in_band_p
        prompted_diff += differs

        per_spk[spk] = {
            "band_hz": [round(lo, 1), round(hi, 1)],
            "generated_f0_hz": round(f0, 1),
            "in_band": bool(in_band),
            "classified_as": pred,
            "mcd_db": round(mcd, 2),
            "duration_mae_frames": round(dur_mae, 2),
            "prompted_f0_hz": round(f0_p, 1),
            "prompted_in_band": bool(in_band_p),
            "prompted_differs": bool(differs),
        }

    n = len(speakers)
    report["speakers"] = per_spk
    report["n_speakers"] = n
    report["timbre_classification_acc"] = round(correct / n, 3)
    report["mcd_db_mean"] = round(float(np.nanmean(mcds)), 2)
    report["duration_mae_frames_mean"] = round(float(np.mean(dur_maes)), 2)
    report["prompted_in_band_frac"] = round(prompted_ok / n, 3)
    report["prompted_differs_frac"] = round(prompted_diff / n, 3)
    report["timbre_transfer_ok"] = bool(correct / n >= 0.75)
    report["timbre_transfer_ok_threshold"] = 0.75
    report["device"] = card
    emit(json.dumps(report))
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="train_curve --root dir")
    ap.add_argument("--out_dir", default=None)
    ap.add_argument("--text", default="hello world nice day of speech",
                    help="default = the corpus sentence (enables MCD vs "
                         "ground truth)")
    ap.add_argument("--max_frames", type=int, default=512)
    ap.add_argument("--n_prompt_wavs", type=int, default=3)
    ap.add_argument("--band_tol", type=float, default=0.25,
                    help="speaker band = corpus median f0 ± tol (fraction)")
    ap.add_argument("--quant_int8", action="store_true",
                    help="int8 weight-only PLM decode; run once without and "
                         "once with this flag for the float-vs-int8 rows")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    return run(a.root, a.out_dir, a.text, a.max_frames, a.n_prompt_wavs, a.band_tol,
               a.quant_int8, a.device)


if __name__ == "__main__":
    main()
