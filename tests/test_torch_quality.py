"""The port's quality tools (``megatts2_tpu_torch/tools``) held against the
JAX tools (``tools/*.py``, imported by path) on the CPU, and the
generator loader's EMA weights:

* ``megag_from_pretrained`` on a GAN train state with ``g_ema`` gives the
  EMA generator (each parameter from ``g_ema``, the codebook buffers from
  ``state_dict``), as JAX's ``load_generator_from_orbax``; without
  ``g_ema`` it gives ``state_dict``; ``prepare_ds`` stage 2 from such a
  checkpoint writes the EMA generator's latents;
* ``train_curve.build_corpus`` and ``heldout_eval.build_heldout_corpus``
  write the JAX tools' files byte for byte;
* ``dominant_f0``, ``f0_acf``, ``mfcc_from_mel`` and ``dtw_mcd`` agree
  with JAX's within 1e-9 on seeded inputs, and ``mean_cepstra`` through
  the port's plain mel with JAX's ``mel_spectrogram`` within 1e-4;
* ``quality_table`` prints JAX's tables for the same two records;
* ``at_scale_stack.write_stage_config`` writes the dicts of the JAX
  tool's ``yaml.safe_dump``, and ``metrics_last_step`` reads a log as it does;
* each tool keeps the JAX tool's flags and defaults plus ``--device``, and
  asks for the card unless given ``--device cpu``;
* the held-out ceiling decode (ground-truth codes and durations through
  the MRTE, the codebook, the mel decoder and the vocoder) at tiny widths
  on weights carried across by ``bridge.load_flax_params``, against the
  same chain of ``megatts2_tpu`` functions: within 1e-4 relative at fp32.
"""
import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from megatts2_tpu_torch import cli, prepare_ds
from megatts2_tpu_torch.config import load_gan_config, yaml_load
from megatts2_tpu_torch.models import MegaG
from megatts2_tpu_torch.models.pretrained import megag_from_pretrained
from megatts2_tpu_torch.tools import (at_scale_stack, e2e_quality, heldout_eval, int8_margins,
                                      quality_table, train_curve)
from megatts2_tpu_torch.training.checkpoints import (latest_checkpoint, load_model_state_dict,
                                                     read_checkpoint)
from pipeline_fixtures import GAN_YAML, N_SPK, N_UTT, DURS, stage1
from pipeline_fixtures import one_torch_thread  # noqa: F401 (module fixture)
from test_torch_tools import REPO, _files, _flags, _jax_tool

EMA_STEPS = 3
TOOLS = ["train_curve", "e2e_quality", "int8_margins", "at_scale_stack", "heldout_eval"]


# ------------------------------------------------------------ the EMA loader


@pytest.fixture(scope="module")
def ema_run(tmp_path_factory):
    """A tiny GAN fit on the CPU with ``g_ema_decay`` 0.9 (lr 1e-2, so the
    EMA and the raw weights differ by far more than rounding) over the
    pipeline corpus: (root, ds, config, checkpoint)."""
    from megatts2_tpu_torch.tools.synth_corpus import build_corpus

    root = str(tmp_path_factory.mktemp("ema"))
    build_corpus(root, N_SPK, N_UTT, seed=0, dur_range=DURS)
    ds = os.path.join(root, "ds")
    stage1(root, ds)
    text = GAN_YAML.format(steps=EMA_STEPS, val=100, ds=ds)
    text = text.replace("trainer:\n", "trainer:\n  g_ema_decay: 0.9\n", 1)
    text = text.replace("initial_learning_rate: 1.0e-4", "initial_learning_rate: 1.0e-2")
    cfg = os.path.join(root, "gan_ema.yaml")
    with open(cfg, "w") as f:
        f.write(text)
    ck_dir = os.path.join(root, "ck")
    cli.main(["fit", "-c", cfg, "--log_dir", os.path.join(root, "logs"), "--ckpt_dir", ck_dir,
              "--device", "cpu"])
    return root, ds, cfg, latest_checkpoint(ck_dir)


def _raw(cfg: str, obj: dict) -> MegaG:
    return load_model_state_dict(MegaG(load_gan_config(cfg)[0]), obj["state_dict"]).eval()


def test_megag_from_pretrained_returns_the_ema_generator(ema_run):
    _, _, cfg, ckpt = ema_run
    obj = read_checkpoint(ckpt)
    assert obj["global_step"] == EMA_STEPS and set(obj["g_ema"]) == set(dict(MegaG(
        load_gan_config(cfg)[0]).named_parameters()))
    _, g = megag_from_pretrained(ckpt, cfg)
    raw = _raw(cfg, obj)
    params, raw_params = dict(g.named_parameters()), dict(raw.named_parameters())
    for name, value in obj["g_ema"].items():
        assert torch.equal(params[name], value), name
    moved = [n for n in params if not torch.equal(params[n], raw_params[n])]
    assert len(moved) > len(params) // 2  # the EMA lags every trained weight
    buffers, raw_buffers = dict(g.named_buffers()), dict(raw.named_buffers())
    assert buffers.keys() == raw_buffers.keys()
    for name, value in raw_buffers.items():
        assert torch.equal(buffers[name], value), name
    cb = g.vqpe.vq.layers[0]._codebook
    assert cb.inited.item() == 1.0 and cb.embed.abs().sum() > 0  # the kmeans-initialised codebook


def test_megag_from_pretrained_without_ema_gives_the_state_dict(ema_run, tmp_path):
    _, _, cfg, ckpt = ema_run
    obj = read_checkpoint(ckpt)
    path = str(tmp_path / "no_ema.ckpt")
    torch.save({k: v for k, v in obj.items() if k != "g_ema"}, path)
    _, g = megag_from_pretrained(path, cfg)
    want = _raw(cfg, obj).state_dict()
    got = g.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_stage2_writes_the_ema_generators_latents(ema_run):
    from megatts2_tpu_torch.data import CutManifest, GANBatchBuilder

    _, ds, cfg, ckpt = ema_run
    prepare_ds.main(["--stage", "2", "--ds_path", ds, "--generator_ckpt", ckpt,
                     "--generator_config", cfg, "--device", "cpu"])
    obj = read_checkpoint(ckpt)
    raw = _raw(cfg, obj)
    ema = _raw(cfg, obj)
    missing, unexpected = ema.load_state_dict(obj["g_ema"], strict=False)
    buffers = {k for k in ema.state_dict() if k not in dict(ema.named_parameters())}
    assert not unexpected and set(missing) == buffers  # the codebook stays state_dict's
    # stage 2's first batch: the 8 shortest cuts of train + valid
    cuts = CutManifest.load(os.path.join(ds, "cuts_train.jsonl.gz"))
    cuts.cuts.extend(CutManifest.load(os.path.join(ds, "cuts_valid.jsonl.gz")).cuts)
    idxs = sorted(range(len(cuts)), key=lambda i: cuts[i].num_frames)[:prepare_ds.LATENT_BATCH]
    b = GANBatchBuilder(cuts, ds)(idxs)
    args = (torch.from_numpy(b["phone_tokens"]).long(), torch.from_numpy(b["tokens_lens"]),
            torch.from_numpy(b["mel_timbres"]).float(), torch.from_numpy(b["mel_targets"]).float())
    with torch.no_grad():
        (tc_ema, codes_ema), (tc_raw, _) = ema.s2_latent(*args), raw.s2_latent(*args)
    for row, i in enumerate(idxs):
        cut = cuts[i]
        lat = np.load(os.path.join(ds, "latents", cut.speaker, f"{cut.id}.npy"),
                      allow_pickle=True).item()
        tl = int(b["tokens_lens"][row])
        np.testing.assert_allclose(lat["tc_latent"][0], tc_ema[row, :tl].numpy(), rtol=1e-5,
                                   atol=1e-5)
        assert not np.allclose(lat["tc_latent"][0], tc_raw[row, :tl].numpy(), rtol=1e-3, atol=1e-3)
        n_codes = lat["p_code"].shape[-1]
        assert np.array_equal(lat["p_code"][0, 0], codes_ema[0, row, :n_codes].numpy())


# ------------------------------------------------------------ against JAX


def test_corpora_are_the_jax_tools_files_byte_for_byte(tmp_path):
    jtool = _jax_tool("train_curve")
    jtool.build_corpus(str(tmp_path / "jax"), 2)
    assert train_curve.build_corpus(str(tmp_path / "port"), 2) == tuple(
        str(tmp_path / "port" / d) for d in ("wavs", "textgrids", "ds"))
    jheld = _jax_tool("heldout_eval")
    want = jheld.build_heldout_corpus(str(tmp_path / "hjax"), n_speakers=2, n_per_spk=2)
    got = heldout_eval.build_heldout_corpus(str(tmp_path / "hport"), n_speakers=2, n_per_spk=2)
    assert got[3] == want[3]
    for a, b in (("jax", "port"), ("hjax", "hport")):
        jax_files, port_files = _files(tmp_path / a), _files(tmp_path / b)
        assert len(port_files) == 2 * 2 * 3 and port_files.keys() == jax_files.keys()
        for name, data in jax_files.items():
            assert port_files[name] == data, name


def _voiced(rng, f0: float, n: int) -> np.ndarray:
    t = np.arange(n) / 16000
    y = sum(np.sin(2 * np.pi * f0 * h * t + rng.rand() * 6.28) / h for h in range(1, 8))
    return (y + 0.05 * rng.randn(n)).astype(np.float32)


@pytest.mark.parametrize("f0", [82.0, 131.5, 247.0])
def test_metric_functions_agree_with_jax(f0):
    je2e, jheld = _jax_tool("e2e_quality"), _jax_tool("heldout_eval")
    rng = np.random.RandomState(int(f0))
    y = _voiced(rng, f0, 20000)
    assert abs(e2e_quality.dominant_f0(y) - je2e.dominant_f0(y)) <= 1e-9
    assert abs(heldout_eval.f0_acf(y) - jheld.f0_acf(y)) <= 1e-9
    assert abs(heldout_eval.f0_acf(y) - f0) < 0.05 * f0  # a voiced stack: the estimator finds f0
    assert e2e_quality.dominant_f0(y[:3000]) == je2e.dominant_f0(y[:3000]) == 0.0  # under sr / 4
    logmel = rng.randn(37, 80)
    np.testing.assert_allclose(e2e_quality.mfcc_from_mel(logmel), je2e.mfcc_from_mel(logmel),
                               rtol=0, atol=1e-9)
    c_ref, c_gen = rng.randn(23, 13), rng.randn(31, 13)
    assert abs(e2e_quality.dtw_mcd(c_ref, c_gen) - je2e.dtw_mcd(c_ref, c_gen)) <= 1e-9


def test_mean_cepstra_through_the_plain_mel_agrees_with_jax():
    import jax.numpy as jnp

    from megatts2_tpu.ops import mel_spectrogram

    je2e = _jax_tool("e2e_quality")
    y = _voiced(np.random.RandomState(3), 140.0, 51200) * 0.3
    want = je2e.mfcc_from_mel(np.asarray(mel_spectrogram(jnp.asarray(y)))).mean(axis=0)
    np.testing.assert_allclose(e2e_quality.mean_cepstra(y, "cpu"), want, rtol=0, atol=1e-4)


def _record(decode: str, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    spk = {s: {"band_hz": [round(90.0 * (i + 1), 1), round(140.0 * (i + 1), 1)],
               "generated_f0_hz": round(float(rng.uniform(80, 300)), 1), "in_band": bool(i),
               "classified_as": ["spkA", "spkB", "spkA"][i], "mcd_db": round(float(rng.uniform(5, 40)), 2),
               "duration_mae_frames": round(float(rng.uniform(0, 5)), 2),
               "prompted_f0_hz": round(float(rng.uniform(80, 300)), 1),
               "prompted_in_band": bool(i % 2), "prompted_differs": True}
           for i, s in enumerate(("spkC", "spkA", "spkB"))}
    return {"plm_decode": decode, "speakers": spk, "timbre_classification_acc": 0.667,
            "mcd_db_mean": 21.5, "duration_mae_frames_mean": float("nan"),
            "prompted_in_band_frac": 0.333, "prompted_differs_frac": 1.0}


def test_quality_table_prints_the_jax_tables(tmp_path, monkeypatch):
    paths = []
    for decode, seed in (("fp32", 0), ("int8", 1)):
        paths.append(str(tmp_path / f"{decode}.json"))
        with open(paths[-1], "w") as f:
            json.dump(_record(decode, seed), f)
    jtool = _jax_tool("quality_table")
    monkeypatch.setattr("sys.argv", ["quality_table.py", *paths])
    want, got = io.StringIO(), io.StringIO()
    with redirect_stdout(want):
        jtool.main()
    with redirect_stdout(got):
        quality_table.main(paths)
    assert got.getvalue() == want.getvalue() and len(want.getvalue().splitlines()) == 13


@pytest.mark.parametrize("stage, args", [
    ("gan", ("gan50k.yaml", 30_000, 2000,
             {"min_duration": 1.0, "max_duration_batch": 40, "max_timbre_frames": 512},
             {"g_ema_decay": 0.999})),
    ("plm", ("plm.yaml", 14_000, 1000, {"max_n_cuts": 8}, {})),
    ("adm", ("adm.yaml", 24_000, 2000, {"max_duration_batch": 200}, {})),
    ("vocoder", ("vocoder.yaml", 10_000, 1000, {"batch_size": 16}, {}))])
def test_write_stage_config_writes_the_jax_tools_dicts(stage, args, tmp_path, monkeypatch):
    import yaml

    jtool = _jax_tool("at_scale_stack")
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(REPO)  # the JAX tool reads configs/ from the working directory
    jpath = jtool.write_stage_config(str(tmp_path / "jax"), stage, *args)
    path = at_scale_stack.write_stage_config(str(tmp_path / "port"), stage, *args)
    assert os.path.basename(path) == args[0]
    with open(jpath) as f:
        want = yaml.safe_load(f)
    with open(path) as f:
        got = yaml_load(f.read())
    assert want["data"].pop("ds_path") == os.path.join(str(tmp_path / "jax"), "ds") + "/"
    assert got["data"].pop("ds_path") == os.path.join(str(tmp_path / "port"), "ds") + "/"
    assert got == want


def test_metrics_last_step_reads_a_log_as_the_jax_tool(tmp_path):
    jtool = _jax_tool("at_scale_stack")
    path = tmp_path / "gan_metrics.jsonl"
    assert at_scale_stack.metrics_last_step(str(path)) == jtool.metrics_last_step(str(path)) == 0
    rows = [{"step": 100, "train/x": 1.0}, {"step": 300, "val/y": 2.0}, {"step": 200},
            {"loop/steps": 5}]
    path.write_text("".join(json.dumps(r) + "\n" for r in rows) + '{"step": 40')  # a line being written
    assert at_scale_stack.metrics_last_step(str(path)) == jtool.metrics_last_step(str(path)) == 300


@pytest.mark.parametrize("name", TOOLS + ["quality_table"])
def test_tools_keep_the_jax_flags_and_defaults_plus_device(name):
    port = _flags(REPO / "megatts2_tpu_torch" / "tools" / f"{name}.py")
    want = _flags(REPO / "tools" / f"{name}.py")
    if name in TOOLS:
        assert port == want + [("--device", "cuda")]
    else:  # quality_table reads files and touches no device: no flags in either
        assert port == want == []


@pytest.mark.parametrize("argv", [
    ["train_curve", "--root", "ROOT"], ["e2e_quality", "--root", "ROOT"],
    ["int8_margins", "--train_root", "ROOT"], ["at_scale_stack", "--root", "ROOT"],
    ["heldout_eval", "--train_root", "ROOT", "--ckpt_root", "ROOT", "--gan_config", "ROOT",
     "--out", "ROOT"]])
def test_tools_ask_for_the_card_by_default(argv, tmp_path, monkeypatch):
    """Without a card each tool raises before it writes or reads a file."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = {"train_curve": train_curve, "e2e_quality": e2e_quality, "int8_margins": int8_margins,
           "at_scale_stack": at_scale_stack, "heldout_eval": heldout_eval}[argv[0]]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([str(tmp_path) if a == "ROOT" else a for a in argv[1:]])
    assert list(tmp_path.iterdir()) == []


def test_int8_margins_cpu_flag_is_device_cpu(monkeypatch):
    seen = []
    monkeypatch.setattr(int8_margins, "run", lambda *a: seen.append(a[5]))
    int8_margins.main(["--cpu"])
    int8_margins.main([])
    assert seen == ["cpu", "cuda"]


def test_ceiling_decode_agrees_with_the_jax_chain():
    import jax
    import jax.numpy as jnp

    from megatts2_tpu.models import MegaG as JMegaG
    from megatts2_tpu.models.megatts import vocode as jvocode
    from megatts2_tpu.ops import regulate_length as jregulate
    from test_torch_streaming import build_cascade

    c = build_cascade()
    g_vars, voc_params = c["vars"][0], c["vars"][3]
    g_cfg, voc_cfg = c["jcfgs"][0], c["jcfgs"][3]
    g, _, _, voc = c["port"]()
    rng = np.random.RandomState(5)
    Tp, Tm, max_frames = 7, 48, 64
    phone = rng.randint(1, g_cfg.mrte.phone_vocab_size, (1, Tp)).astype(np.int32)
    mel = rng.randn(1, Tm, 80).astype(np.float32)
    dt = rng.randint(1, 6, (1, Tp)).astype(np.int32)
    p_code = rng.randint(0, g_cfg.vqpe.vq_bins, (1, 5)).astype(np.int32)  # 40 frames: padded
    jg = JMegaG(g_cfg, dtype=jnp.float32)

    def jax_chain(frames):
        tc = jg.apply(g_vars, jnp.asarray(phone), jnp.asarray(mel), jnp.asarray([Tp]),
                      method=lambda m, p, x, pl: m.mrte.tc_latent(p, x, pl))
        tc_expand = jregulate(tc, jnp.asarray(dt), frames)
        zq = jnp.repeat(jg.apply(g_vars, jnp.asarray(p_code)[None],
                                 method=lambda m, x: m.vqpe.vq.decode(x)), 8, axis=1)
        zq = jnp.pad(zq, ((0, 0), (0, frames - zq.shape[1]), (0, 0))) if zq.shape[1] < frames \
            else zq[:, :frames]
        mel_hat = jg.apply(g_vars, tc_expand, zq, method=lambda m, a, b: m.decode_latents(a, b))
        return jvocode(voc_params, voc_cfg, mel_hat.astype(jnp.float32), jnp.float32)

    wavs = {}
    for frames in (max_frames, 24):  # 24: the codes cut to the budget
        got = heldout_eval.ceiling_decode(
            g, voc, torch.from_numpy(phone).long(), torch.from_numpy(mel), torch.tensor([Tp]),
            torch.from_numpy(p_code).long(), torch.from_numpy(dt).long(), frames).numpy()
        want = np.asarray(jax.jit(jax_chain, static_argnums=0)(frames))
        assert got.shape == want.shape == (1, frames * 256)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
        wavs[frames] = got
    assert np.abs(wavs[24]).max() > 0
