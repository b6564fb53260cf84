"""The port's dataset preparation against the JAX package's, on the CPU,
on a synthetic corpus (2 speakers × 5 utterances of 2.5-3.0 s, harmonic
stacks with a ``phones`` tier of 4-20 frame phones, from a seed).

Stage 0: the ``.lab`` files are equal.  Stage 1: manifests (every field
but the paths, which name each run's own directory), splits, duration
tokens, ``max_duration_token`` and the symbol table are equal; the float16
features are within one fp16 ulp of JAX's plus 1e-4: the plain mel and
JAX's jnp golden agree to 1e-4 in fp32 before storage, and a value may
round the other way; near 0, where fp16's ulp is below that agreement,
the fp32 difference itself remains (seen: 1.2e-7 at 9.3e-5, two ulps).  Stage 2 runs on one dataset from one G ``.ckpt``:
``tc_latent`` within 1e-4 at fp32 (sums in another order) and ``p_code``
equal; each package's ``LatentReader`` reads the other's files.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from megatts2_tpu import prepare_ds as jprep
from megatts2_tpu.data import CutManifest as JManifest
from megatts2_tpu.data import LatentReader as JLatentReader
from megatts2_tpu.text import TextTokenizer as JTokenizer
from megatts2_tpu_torch import prepare_ds as tprep
from megatts2_tpu_torch.data import CutManifest, LatentReader
from megatts2_tpu_torch.tools.synth_corpus import build_corpus
from pipeline_fixtures import DURS, GAN_YAML, N_SPK, N_UTT, RATIO, stage1, write_g_ckpt
from pipeline_fixtures import one_torch_thread  # noqa: F401 (module fixture)


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """The corpus twice (one per package); stage 0 and 1 by each; one G
    checkpoint."""
    out = {}
    for side in ("jax", "port"):
        root = str(tmp_path_factory.mktemp(side))
        build_corpus(root, N_SPK, N_UTT, seed=0, dur_range=DURS)
        out[side] = root
    # JAX's stage 0 is make_lab over a forked pool; the same function here
    tt = JTokenizer(None)
    for spk in sorted(os.listdir(os.path.join(out["jax"], "wavs"))):
        d = os.path.join(out["jax"], "wavs", spk)
        for n in sorted(os.listdir(d)):
            if n.endswith(".wav"):
                jprep.make_lab(tt, os.path.join(d, n))
    jargs = jprep.parse_args(["--stage", "1", "--wavtxt_path", os.path.join(out["jax"], "wavs"),
                              "--text_grid_path", os.path.join(out["jax"], "textgrids"),
                              "--ds_path", os.path.join(out["jax"], "ds"),
                              "--test_set_ratio", RATIO, "--num_workers", "2"])
    jprep.DatasetMaker(jargs).make_ds()
    out["stats"] = stage1(out["port"], os.path.join(out["port"], "ds"))
    gan = os.path.join(out["port"], "gan.yaml")
    with open(gan, "w") as f:
        f.write(GAN_YAML.format(steps=1, val=1, ds=os.path.join(out["port"], "ds")))
    out["gan_yaml"] = gan
    out["g_ckpt"] = os.path.join(out["port"], "g.ckpt")
    write_g_ckpt(gan, out["g_ckpt"])
    return out


def _labs(root):
    out = {}
    for dirpath, _, names in os.walk(os.path.join(root, "wavs")):
        for n in names:
            if n.endswith(".lab"):
                with open(os.path.join(dirpath, n), encoding="utf-8") as f:
                    out[n] = f.read()
    return out


def test_stage0_labs_equal(prepared):
    j, t = _labs(prepared["jax"]), _labs(prepared["port"])
    assert len(t) == N_SPK * N_UTT and t == j and all(t.values())


def _cuts(root, split):
    m = CutManifest.load(os.path.join(root, "ds", f"cuts_{split}.jsonl.gz"))
    return [dataclasses.asdict(c) for c in m]


@pytest.mark.parametrize("split", ["train", "valid"])
def test_stage1_manifests_and_symbols_equal(prepared, split):
    j, t = _cuts(prepared["jax"], split), _cuts(prepared["port"], split)
    assert len(t) == {"train": 8, "valid": 2}[split] and len(j) == len(t)
    for a, b in zip(j, t):
        for path_key in ("feats_path", "wav_path"):
            assert os.path.relpath(a.pop(path_key), prepared["jax"]) == \
                os.path.relpath(b.pop(path_key), prepared["port"])
        assert a == b
    sym = [open(os.path.join(prepared[s], "ds", "unique_text_tokens.k2symbols")).read()
           for s in ("jax", "port")]
    assert sym[0] == sym[1] and len(sym[1].splitlines()) > 10
    every = _cuts(prepared["port"], "train") + _cuts(prepared["port"], "valid")
    assert prepared["stats"]["max_duration_token"] == max(len(c["duration_tokens"]) for c in every)
    assert prepared["stats"]["cuts"] == N_SPK * N_UTT


@pytest.mark.parametrize("split", ["train", "valid"])
def test_stage1_features_within_one_fp16_ulp(prepared, split):
    shards = [np.fromfile(os.path.join(prepared[s], "ds", f"feats_{split}.bin"), np.float16)
              for s in ("jax", "port")]
    a, b = shards
    assert a.shape == b.shape and a.size > 0
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b))).astype(np.float32)
    err = np.abs(a.astype(np.float32) - b.astype(np.float32))
    assert (err <= ulp + 1e-4).all(), float((err - ulp).max())
    assert (err <= ulp).mean() > 0.9999  # beyond one ulp only near 0
    assert (err > 0).mean() < 0.05  # most stored values agree exactly


def test_stage2_latents_match_jax(prepared, tmp_path):
    """Both packages' stage 2 on the port's stage-1 dataset (a copy each)
    from one G checkpoint."""
    ds = {}
    for side in ("jax", "port"):
        ds[side] = str(tmp_path / side)
        shutil.copytree(os.path.join(prepared["port"], "ds"), ds[side])
    argv = ["--stage", "2", "--generator_ckpt", prepared["g_ckpt"],
            "--generator_config", prepared["gan_yaml"]]
    jprep.DatasetMaker(jprep.parse_args(argv + ["--ds_path", ds["jax"]])).extract_latent()
    got = tprep.main(argv + ["--ds_path", ds["port"], "--device", "cpu"])
    assert got == {"cuts": N_SPK * N_UTT, "batches": 2}
    cuts = JManifest.load(os.path.join(ds["jax"], "cuts_train.jsonl.gz")).cuts + \
        JManifest.load(os.path.join(ds["jax"], "cuts_valid.jsonl.gz")).cuts
    n_codes = set()
    for c in cuts:
        a = JLatentReader(ds["port"]).read(c)  # each reads the other's files
        b = LatentReader(ds["jax"]).read(c)
        assert a["tc_latent"].shape == b["tc_latent"].shape == (1, len(c.phone_tokens), 16)
        np.testing.assert_allclose(a["tc_latent"], b["tc_latent"], rtol=0, atol=1e-4)
        assert a["p_code"].dtype == b["p_code"].dtype == np.int32
        np.testing.assert_array_equal(a["p_code"], b["p_code"])
        assert a["p_code"].shape == (1, 1, -(-sum(c.duration_tokens) // 8))
        n_codes.update(a["p_code"].ravel().tolist())
    assert len(n_codes) > 3  # the codebook is live


def test_stage2_refuses_a_directory_without_checkpoints(prepared, tmp_path):
    (tmp_path / "orbax_like").mkdir()
    with pytest.raises(ValueError, match="torch checkpoints"):
        tprep.main(["--stage", "2", "--generator_ckpt", str(tmp_path / "orbax_like"),
                    "--generator_config", prepared["gan_yaml"],
                    "--ds_path", os.path.join(prepared["port"], "ds"), "--device", "cpu"])


@pytest.mark.parametrize("stage", ["1", "2"])
def test_stages_default_to_the_card(prepared, stage, monkeypatch):
    """Without ``--device`` stages 1 and 2 ask for the card, and raise
    where there is none: no quiet CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprep.main(["--stage", stage, "--ds_path", os.path.join(prepared["port"], "ds"),
                    "--generator_ckpt", prepared["g_ckpt"],
                    "--generator_config", prepared["gan_yaml"]])
