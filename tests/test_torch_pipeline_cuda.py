"""The port's dataset preparation and training CLI on the card.  Marked
``gpu``: without a CUDA device every test here skips.  On a machine with a
card and no JAX, run with

    python -m pytest --noconftest -m gpu tests/test_torch_pipeline_cuda.py

Stage 1 on the card (kernel A, one launch a mel batch) against stage 1 on
the CPU (the plain mel): manifests and symbols equal, features within one
fp16 ulp plus 1e-3, kernel A's tolerance against the plain mel (its FFT
and ``torch.fft`` sum in other orders, and log magnifies that near the
clamp), with at least 99.9% of values within one ulp.  Then stages 0-2 on
the card and one tiny ``fit`` of each stage there."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from megatts2_tpu_torch import cli
from megatts2_tpu_torch.data import CutManifest
from megatts2_tpu_torch.tools.synth_corpus import build_corpus
from pipeline_fixtures import DURS, N_SPK, N_UTT, config, prepare_dataset, stage1

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_stage1_on_card_matches_cpu(cuda, tmp_path):
    from megatts2_tpu_torch.ops import mel

    build_corpus(str(tmp_path), N_SPK, N_UTT, seed=0, dur_range=DURS)
    cpu = stage1(str(tmp_path), str(tmp_path / "ds_cpu"), "cpu")
    mel.mel_spectrogram_cuda.launches = 0
    gpu = stage1(str(tmp_path), str(tmp_path / "ds_gpu"), "cuda")
    assert gpu == cpu and mel.mel_spectrogram_cuda.launches == gpu["mel_batches"] > 0
    for split in ("train", "valid"):
        m = [[dataclasses.asdict(c) for c in CutManifest.load(
            str(tmp_path / d / f"cuts_{split}.jsonl.gz"))] for d in ("ds_cpu", "ds_gpu")]
        for a, b in zip(*m):
            assert os.path.basename(a.pop("feats_path")) == os.path.basename(b.pop("feats_path"))
            assert a == b
        a, b = (np.fromfile(str(tmp_path / d / f"feats_{split}.bin"), np.float16)
                for d in ("ds_cpu", "ds_gpu"))
        ulp = np.spacing(np.maximum(np.abs(a), np.abs(b))).astype(np.float32)
        err = np.abs(a.astype(np.float32) - b.astype(np.float32))
        assert a.shape == b.shape and (err <= ulp + 1e-3).all()
        assert (err <= ulp).mean() > 0.999
    syms = [open(str(tmp_path / d / "unique_text_tokens.k2symbols")).read()
            for d in ("ds_cpu", "ds_gpu")]
    assert syms[0] == syms[1]


@pytest.fixture(scope="module")
def dataset(cuda, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pipeline_cuda"))
    return prepare_dataset(root, "cuda")


@pytest.mark.parametrize("stage", ["gan", "plm", "adm", "vocoder"])
def test_fit_on_card(dataset, tmp_path, stage):
    logs = str(tmp_path / "logs")
    st = cli.main(["fit", "-c", config(str(tmp_path), stage, dataset, 2, val=2),
                   "--log_dir", logs, "--ckpt_dir", str(tmp_path / "ck")])
    assert st.step == 2
    with open(os.path.join(logs, f"{stage}_metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    train = [r for r in rows if any(k.startswith("train/") for k in r)]
    assert len(train) == 2 and all(np.isfinite(v) for r in train for v in r.values())
