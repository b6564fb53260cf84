"""Dataset preparation of the port (port of ``megatts2_tpu/prepare_ds.py``),
three stages with JAX's flags and defaults plus ``--device``:

  stage 0: tokenize ``{id}.txt`` → ``{id}.lab`` beside each wav (for MFA),
           over a process pool;
  stage 1: TextGrids → per-phone frame durations, cut manifests (train and
           valid interleaved), mel features into memmap shards,
           ``unique_text_tokens.k2symbols``; prints ``max_duration_token``;
  stage 2: the trained generator's ``s2_latent`` over every cut, saved as
           ``{ds_path}/latents/{spk}/{id}.npy`` (``tc_latent``, ``p_code``).

    python -m megatts2_tpu_torch.prepare_ds --stage 1 --wavtxt_path data/wavs \\
        --text_grid_path data/textgrids --ds_path data/ds

Stage 1 computes the mels on ``--device`` in same-bucket batches of up to 8
signals padded to a multiple of 32768 samples: on the card, kernel A.
Stage 2 reads ``--generator_ckpt``, a ``.ckpt`` / ``.pt`` / ``.pth`` file
in the reference's layout or the port's (or a directory of the port's
``step_*.ckpt``, whose latest is read; an orbax directory raises), and runs
``s2_latent`` in fp32 on ``--device`` over length-sorted batches of 8 from
the port's ``GANBatchBuilder``.  Stages 1 and 2 run on the card unless
``--device cpu`` is given, and raise without one; stage 0 is host work.
"""
from __future__ import annotations

import argparse
import glob
import multiprocessing
import os
from functools import partial
from typing import List

import numpy as np

from . import HIFIGAN_HOP_LENGTH, HIFIGAN_SR
from .data import Cut, CutManifest, FeatureWriter
from .text import SymbolTable, TextTokenizer, read_textgrid
from .utils.audio import load_wav, peak_normalize, save_wav

MEL_BATCH = 8  # signals a mel launch
SAMPLE_BUCKET = 32768  # signals pad to a multiple of this many samples
LATENT_BATCH = 8  # cuts an s2_latent call


def make_lab(tt: TextTokenizer, wav: str) -> None:
    base = os.path.splitext(wav)[0]
    with open(base + ".txt", encoding="utf-8") as f:
        txt = f.read()
    with open(base + ".lab", "w", encoding="utf-8") as f:
        f.write(" ".join(tt.tokenize(txt)))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="megatts2_tpu_torch dataset preparation")
    p.add_argument("--stage", type=int, default=0, help="Stage to run (0/1/2)")
    p.add_argument("--wavtxt_path", type=str, default="data/wavs/")
    p.add_argument("--text_grid_path", type=str, default="data/textgrids/")
    p.add_argument("--ds_path", type=str, default="data/ds/")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--test_set_ratio", type=float, default=0.03)
    p.add_argument("--trim_wav", type=bool, default=False)
    p.add_argument("--generator_ckpt", type=str, default="generator.ckpt")
    p.add_argument("--generator_config", type=str, default="configs/config_gan.yaml")
    p.add_argument("--pinyin_dict", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="stages 1 and 2: cuda (default) or cpu")
    return p.parse_args(argv)


def _device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("prepare_ds: device 'cuda' requested but no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return device


class DatasetMaker:
    def __init__(self, args):
        self.args = args
        # 0 disables the valid split (a prompt-only dataset)
        self.test_set_interval = (max(1, int(1 / args.test_set_ratio))
                                  if args.test_set_ratio > 0 else 0)

    # ----------------------------------------------------------- stage 0
    def make_labs(self) -> dict:
        wavs = glob.glob(f"{self.args.wavtxt_path}/**/*.wav", recursive=True)
        tt = TextTokenizer(self.args.pinyin_dict)
        with multiprocessing.get_context("spawn").Pool(max(1, self.args.num_workers)) as p:
            list(p.imap(partial(make_lab, tt), wavs))
        return {"labs": len(wavs)}

    # ----------------------------------------------------------- stage 1
    def _parse_one(self, n: int, tg: str):
        """Host work of one file (on a thread pool): TextGrid → phone and
        duration tokens, wav → bucket-padded signal.  A record dict, or None
        for a file without phone intervals."""
        from .ops.mel import num_frames  # here: the stage-0 workers need no torch

        frame_shift = HIFIGAN_HOP_LENGTH / HIFIGAN_SR
        cut_id = os.path.splitext(os.path.basename(tg))[0]
        speaker = os.path.basename(os.path.dirname(tg))
        wav_path = os.path.join(self.args.wavtxt_path, speaker, cut_id + ".wav")
        txt_path = os.path.join(self.args.wavtxt_path, speaker, cut_id + ".txt")

        intervals = [e for e in read_textgrid(tg) if e.tier == "phones"]
        if not intervals:
            return None
        if intervals[0].name == "":
            intervals = intervals[1:]
        if intervals[-1].name == "":
            intervals = intervals[:-1]

        y = load_wav(wav_path, HIFIGAN_SR)
        if self.args.trim_wav:
            start_i = int(intervals[0].start * HIFIGAN_SR)
            stop_i = int(intervals[-1].stop * HIFIGAN_SR)
            y = peak_normalize(y[start_i:stop_i])
            save_wav(wav_path, y, HIFIGAN_SR)

        start = intervals[0].start
        n_fr = num_frames(y.shape[-1])
        duration_tokens: List[int] = []
        phone_tokens: List[str] = []
        for e in intervals:
            n_frame_interval = int((e.stop - start) / frame_shift)
            duration_tokens.append(n_frame_interval - sum(duration_tokens))
            phone_tokens.append(e.name if e.name else "<sil>")
        if sum(duration_tokens) > n_fr:
            raise ValueError(f"{cut_id}: sum(duration_tokens)={sum(duration_tokens)} > "
                             f"n_frames={n_fr}")

        # pad the signal to a sample bucket: one launch shape per (bucket, batch)
        bucket = -(-y.shape[-1] // SAMPLE_BUCKET) * SAMPLE_BUCKET
        text = ""
        if os.path.exists(txt_path):
            with open(txt_path, encoding="utf-8") as f:
                text = f.read()
        return {
            "id": cut_id, "speaker": speaker, "text": text,
            "split": ("train" if self.test_set_interval == 0
                      or n % self.test_set_interval else "valid"),
            "n_samples": y.shape[-1], "n_fr": n_fr, "bucket": bucket,
            "y_pad": np.pad(y, (0, bucket - y.shape[-1])),
            "phone_tokens": phone_tokens, "duration_tokens": duration_tokens,
            "wav_path": wav_path,
        }

    def make_ds(self) -> dict:
        """Stage 1: TextGrid and wav parsing on a ``--num_workers`` thread
        pool while this thread batches same-bucket signals through the mel
        (kernel A on the card) and appends features and manifests in order."""
        from concurrent.futures import ThreadPoolExecutor

        import torch

        from .ops.mel import mel_spectrogram

        device = _device(self.args.device)
        tgs = sorted(glob.glob(f"{self.args.text_grid_path}/**/*.TextGrid", recursive=True))
        os.makedirs(self.args.ds_path, exist_ok=True)
        manifests = {"train": CutManifest(), "valid": CutManifest()}
        writers = {split: FeatureWriter(os.path.join(self.args.ds_path, f"feats_{split}.bin"))
                   for split in manifests}
        unique_symbols = set()
        stats = {"max_duration_token": 0, "mel_batches": 0}
        groups: dict = {}  # bucket size → pending records

        def flush(recs: List[dict]) -> None:
            sigs = torch.from_numpy(np.stack([r["y_pad"] for r in recs])).to(device)
            with torch.no_grad():
                mels = mel_spectrogram(sigs).cpu().numpy()
            stats["mel_batches"] += 1
            for r, mel in zip(recs, mels):
                mel = mel[: r["n_fr"]]
                path, off = writers[r["split"]].add(mel)
                manifests[r["split"]].cuts.append(Cut(
                    id=r["id"], speaker=r["speaker"], duration=r["n_samples"] / HIFIGAN_SR,
                    num_frames=mel.shape[0], phone_tokens=r["phone_tokens"],
                    duration_tokens=r["duration_tokens"], text=r["text"], feats_path=path,
                    feats_offset=off, wav_path=r["wav_path"]))
                unique_symbols.update(r["phone_tokens"])
                stats["max_duration_token"] = max(stats["max_duration_token"],
                                                  len(r["duration_tokens"]))

        with ThreadPoolExecutor(max(1, self.args.num_workers)) as ex:
            for rec in ex.map(self._parse_one, range(len(tgs)), tgs):
                if rec is None:
                    continue
                pending = groups.setdefault(rec["bucket"], [])
                pending.append(rec)
                if len(pending) >= MEL_BATCH:
                    flush(pending)
                    groups[rec["bucket"]] = []
        for bucket in sorted(groups):
            if groups[bucket]:
                flush(groups[bucket])

        for split, m in manifests.items():
            writers[split].close()
            m.save(os.path.join(self.args.ds_path, f"cuts_{split}.jsonl.gz"))
        table = SymbolTable()
        for s in sorted(unique_symbols):
            table.add(s)
        table.to_file(os.path.join(self.args.ds_path, "unique_text_tokens.k2symbols"))
        print(f"max_duration_token: {stats['max_duration_token']}")
        return {"cuts": sum(len(m) for m in manifests.values()), **stats}

    # ----------------------------------------------------------- stage 2
    def extract_latent(self) -> dict:
        """Stage 2: ``MegaG.s2_latent`` in fp32 over length-sorted batches of
        8 (the reference extracts one cut a call, prepare_ds.py:240-258)."""
        import torch

        from .data import GANBatchBuilder
        from .models.pretrained import megag_from_pretrained

        device = _device(self.args.device)
        _, g = megag_from_pretrained(self.args.generator_ckpt, self.args.generator_config)
        g = g.to(device).eval()

        ds = self.args.ds_path
        cuts_all = CutManifest.load(os.path.join(ds, "cuts_train.jsonl.gz"))
        cuts_all.cuts.extend(CutManifest.load(os.path.join(ds, "cuts_valid.jsonl.gz")).cuts)
        builder = GANBatchBuilder(cuts_all, ds)
        order = sorted(range(len(cuts_all)), key=lambda i: cuts_all[i].num_frames)
        n_batches = 0
        for start in range(0, len(order), LATENT_BATCH):
            idxs = order[start: start + LATENT_BATCH]
            batch = builder(idxs)
            with torch.no_grad():
                tc, codes = g.s2_latent(
                    torch.from_numpy(batch["phone_tokens"]).long().to(device),
                    torch.from_numpy(batch["tokens_lens"]).to(device),
                    # the builder's fp16 wire cast back: extraction runs in fp32
                    torch.from_numpy(batch["mel_timbres"]).float().to(device),
                    torch.from_numpy(batch["mel_targets"]).float().to(device))
            tc = tc.float().cpu().numpy()
            codes = codes.cpu().numpy().astype(np.int32)  # (n_q, B, T8)
            n_batches += 1
            for b, i in enumerate(idxs):
                cut = cuts_all[i]
                os.makedirs(os.path.join(ds, "latents", cut.speaker), exist_ok=True)
                tl = int(batch["tokens_lens"][b])
                n_codes = -(-int(batch["mel_target_lens"][b]) // 8)
                out = {"tc_latent": tc[b: b + 1, :tl],
                       "p_code": codes[:, b: b + 1, :n_codes].transpose(1, 0, 2)}
                np.save(os.path.join(ds, "latents", cut.speaker, f"{cut.id}.npy"), out)
        return {"cuts": len(cuts_all), "batches": n_batches}


def main(argv=None) -> dict:
    """Run one stage; returns what it counted (files, cuts, launches)."""
    args = parse_args(argv)
    dm = DatasetMaker(args)
    if args.stage == 0:
        return dm.make_labs()
    if args.stage == 1:
        return dm.make_ds()
    if args.stage == 2:
        return dm.extract_latent()
    raise ValueError(f"unknown stage {args.stage}")


if __name__ == "__main__":
    main()
