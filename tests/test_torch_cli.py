"""The port's training CLI on the CPU, on a dataset its own ``prepare_ds``
made (stages 0-2 over a synthetic corpus of 2 speakers × 5 utterances).

``infer_stage`` agrees with JAX's on the four shipped configs; each stage
fits 2 steps and resumes to 4 from its checkpoint directory; the GAN
stage's validation artifacts come as a PNG with matplotlib and as an
``.npz`` pair without (with HiFi-GAN audio when given a checkpoint);
``--trace_dir`` writes a ``torch.profiler`` trace; a directory without
checkpoints given to ``--ckpt_path`` raises; without ``--device`` the CLI
asks for the card; the flags and defaults are JAX's, ``--device``
added.  Two gloo ranks fit the PLM at (2, 1) with ZeRO-1, resume at
(1, 2), and log and write what one process does (train loss rtol 1e-5,
weights atol 1e-6; dropout 0, fp32).  PLM and ADM: 3 steps from one reference ``.ckpt``
through ``--init_from_torch`` at fp32 with dropout 0 log the train metrics
of JAX's CLI within rtol 1e-4 (fp32 sums in another order over 3 AdamW
updates); the batch plans of the two samplers (divisor 1 here, 8 under
JAX's 8 host devices) are asserted equal first.
"""
import json
import os

import numpy as np
import pytest
import torch

from megatts2_tpu import cli as jcli
from megatts2_tpu.data import CutManifest as JManifest
from megatts2_tpu.data import DurationBucketSampler as JSampler
from megatts2_tpu_torch import cli
from megatts2_tpu_torch.data import CutManifest, DurationBucketSampler
from megatts2_tpu_torch.training.checkpoints import latest_checkpoint, read_checkpoint
from megatts2_tpu_torch.utils import plotting
from pipeline_fixtures import config as _config
from pipeline_fixtures import one_torch_thread  # noqa: F401 (module fixture)
from pipeline_fixtures import prepare_dataset

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Stages 0-2 of the port on the CPU; returns (root, ds)."""
    root = str(tmp_path_factory.mktemp("cli"))
    return root, prepare_dataset(root, "cpu")


def _rows(log_dir, stage):
    with open(os.path.join(log_dir, f"{stage}_metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("stage", ["gan", "plm", "adm", "vocoder"])
def test_infer_stage_on_shipped_configs(stage):
    path = f"configs/config_{stage}.yaml"
    assert cli.infer_stage(path) == jcli.infer_stage(path) == stage


@pytest.mark.parametrize("stage", ["gan", "plm", "adm", "vocoder"])
def test_fit_then_resume(dataset, tmp_path, stage):
    _, ds = dataset
    logs, ck = str(tmp_path / "logs"), str(tmp_path / "ck")
    argv = ["--log_dir", logs, "--ckpt_dir", ck, "--device", "cpu"]
    st = cli.main(["fit", "-c", _config(tmp_path, stage, ds, 2, val=2), *argv])
    assert st.step == 2 and latest_checkpoint(ck).endswith("step_2.ckpt")
    st = cli.main(["fit", "-c", _config(tmp_path, stage, ds, 4, val=2), *argv])
    assert st.step == 4 and latest_checkpoint(ck).endswith("step_4.ckpt")
    assert read_checkpoint(latest_checkpoint(ck))["global_step"] == 4
    rows = _rows(logs, stage)
    train = [r["step"] for r in rows if any(k.startswith("train/") for k in r)]
    val = [r["step"] for r in rows if any(k.startswith("val/") for k in r)]
    loop = [r for r in rows if "loop/steps" in r]
    assert train == [1, 2, 3, 4] and val == [2, 4]
    assert [r["loop/steps"] for r in loop] == [2, 2]
    assert all(r["loop/loader_wait_ms_median"] >= 0 and r["loop/step_ms_median"] > 0 for r in loop)
    if stage == "gan":
        assert sorted(os.listdir(os.path.join(logs, "val_artifacts"))) == \
            ["mel_step2.png", "mel_step4.png"]


def test_gan_artifacts_png_with_matplotlib(dataset, tmp_path):
    _, ds = dataset
    logs = str(tmp_path / "logs")
    cli.main(["fit", "-c", _config(tmp_path, "gan", ds, 1, val=1), "--log_dir", logs,
              "--ckpt_dir", str(tmp_path / "ck"), "--device", "cpu"])
    with open(os.path.join(logs, "val_artifacts", "mel_step1.png"), "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_gan_artifacts_npz_without_matplotlib_and_hifigan_audio(dataset, tmp_path, monkeypatch):
    """The card's machine has no matplotlib: the mel pair goes to an
    ``.npz``; ``--hifigan_ckpt`` adds the vocoded target and output."""
    from megatts2_tpu_torch.models import HiFiGAN, init_random_
    from megatts2_tpu_torch.training.checkpoints import model_state_dict
    from megatts2_tpu_torch.utils.audio import load_wav

    _, ds = dataset
    monkeypatch.setattr(plotting, "_pyplot", lambda: None)
    hifi = str(tmp_path / "hifigan.ckpt")
    torch.save({"state_dict": model_state_dict(init_random_(HiFiGAN(), torch.Generator()))}, hifi)
    logs = str(tmp_path / "logs")
    cli.main(["fit", "-c", _config(tmp_path, "gan", ds, 1, val=1), "--log_dir", logs,
              "--ckpt_dir", str(tmp_path / "ck"), "--hifigan_ckpt", hifi, "--device", "cpu"])
    art = os.path.join(logs, "val_artifacts")
    assert sorted(os.listdir(art)) == ["audio_hat_step1.wav", "audio_target_step1.wav",
                                       "mel_step1.npz"]
    z = np.load(os.path.join(art, "mel_step1.npz"))
    assert z["target"].shape == z["output"].shape and z["target"].shape[0] == 80
    assert np.isfinite(z["output"]).all() and not np.array_equal(z["target"], z["output"])
    for name in ("audio_hat_step1.wav", "audio_target_step1.wav"):
        assert load_wav(os.path.join(art, name)).shape == (z["target"].shape[1] * 256,)


def test_trace_dir_writes_a_trace(dataset, tmp_path):
    _, ds = dataset
    trace = str(tmp_path / "trace")
    cli.main(["fit", "-c", _config(tmp_path, "adm", ds, 13), "--log_dir", str(tmp_path / "logs"),
              "--ckpt_dir", str(tmp_path / "ck"), "--trace_dir", trace, "--device", "cpu"])
    assert os.listdir(trace) == ["trace_steps_10-13.json"]
    with open(os.path.join(trace, "trace_steps_10-13.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_ckpt_path_directory_without_checkpoints_raises(dataset, tmp_path):
    _, ds = dataset
    (tmp_path / "orbax_like").mkdir()
    with pytest.raises(FileNotFoundError, match="step_"):
        cli.main(["fit", "-c", _config(tmp_path, "plm", ds, 1), "--log_dir", str(tmp_path),
                  "--ckpt_path", str(tmp_path / "orbax_like"), "--device", "cpu"])


def test_fit_defaults_to_the_card(dataset, tmp_path, monkeypatch):
    _, ds = dataset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["fit", "-c", _config(tmp_path, "adm", ds, 1), "--log_dir", str(tmp_path),
                  "--ckpt_dir", str(tmp_path / "ck")])


@pytest.mark.parametrize("stage", ["gan", "plm", "adm"])
def test_init_from_torch_loads_the_reference_weights(dataset, tmp_path, stage):
    """A fit of 0 steps from ``--init_from_torch`` saves the reference
    checkpoint's weights as they are (G and D for gan)."""
    from megatts2_tpu_torch.config import load_adm_config, load_gan_config, load_plm_config
    from megatts2_tpu_torch.training import create_adm_state, create_gan_state, create_plm_state
    from megatts2_tpu_torch.training.checkpoints import model_state_dict

    _, ds = dataset
    cfg = _config(tmp_path, stage, ds, 0)
    if stage == "gan":
        g_cfg, d_cfg, tcfg = load_gan_config(cfg)
        st = create_gan_state(g_cfg, d_cfg, tcfg.__class__(seed=5), device="cpu")
        models = [st.g, st.d]
    else:
        m_cfg, tcfg = (load_plm_config if stage == "plm" else load_adm_config)(cfg)
        create = create_plm_state if stage == "plm" else create_adm_state
        models = [create(m_cfg, tcfg.__class__(seed=5), device="cpu").model]
    ref = {k: v for m in models for k, v in model_state_dict(m).items()}
    torch.save({"state_dict": ref}, str(tmp_path / "ref.ckpt"))
    ck = str(tmp_path / "ck")
    cli.main(["fit", "-c", cfg, "--init_from_torch", str(tmp_path / "ref.ckpt"), "--log_dir",
              str(tmp_path / "logs"), "--ckpt_dir", ck, "--device", "cpu"])
    got = read_checkpoint(os.path.join(ck, "step_0.ckpt"))["state_dict"]
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert torch.equal(got[k], v), k
    fresh = cli.main(["fit", "-c", cfg, "--log_dir", str(tmp_path / "logs"), "--ckpt_dir",
                      str(tmp_path / "ck_fresh"), "--device", "cpu"])
    assert not all(torch.equal(a, ref[k]) for k, a in model_state_dict(
        fresh.g if stage == "gan" else fresh.model).items())  # the seeds differ: a real load


def _plans(manifest_cls, sampler_cls, path, divisor, kw):
    m = manifest_cls.load(path).filter_duration(0.5, 30)
    out = []
    for epoch in range(3):
        s = sampler_cls(m, batch_divisor=divisor, **kw)
        s.set_epoch(epoch)
        out.append(list(s))
    return out


@pytest.mark.parametrize("stage", ["plm", "adm"])
def test_fit_matches_jax_cli(dataset, tmp_path, stage):
    """3 steps of each CLI from one reference checkpoint: the logged train
    metrics agree within rtol 1e-4."""
    from megatts2_tpu_torch.config import load_adm_config, load_plm_config
    from megatts2_tpu_torch.training import create_adm_state, create_plm_state
    from megatts2_tpu_torch.training.checkpoints import model_state_dict

    _, ds = dataset
    kw = (dict(max_duration_batch=None, max_cuts=8, num_buckets=1) if stage == "plm"
          else dict(max_duration_batch=400, num_buckets=1))
    train = os.path.join(ds, "cuts_train.jsonl.gz")
    plan = _plans(CutManifest, DurationBucketSampler, train, 1, kw)
    assert plan == _plans(JManifest, JSampler, train, 8, kw)
    assert all(len(p) == 1 and len(p[0]) == 8 for p in plan)

    cfg = _config(tmp_path, stage, ds, 3)
    if stage == "plm":
        m_cfg, tcfg = load_plm_config(cfg)
        model = create_plm_state(m_cfg, tcfg, device="cpu").model
    else:
        m_cfg, tcfg = load_adm_config(cfg)
        model = create_adm_state(m_cfg, tcfg, device="cpu").model
    ref = str(tmp_path / "ref.ckpt")
    torch.save({"state_dict": model_state_dict(model)}, ref)
    rows = {}
    for side, main in (("jax", jcli.main), ("port", cli.main)):
        logs = str(tmp_path / f"logs_{side}")
        extra = ["--device", "cpu"] if side == "port" else []
        main(["fit", "-c", cfg, "--init_from_torch", ref, "--log_dir", logs,
              "--ckpt_dir", str(tmp_path / f"ck_{side}"), *extra])
        rows[side] = [r for r in _rows(logs, stage) if "train/loss" in r]
    keys = ["train/loss", "train/loss_sum"] + (["train/ac10"] if stage == "plm" else [])
    assert [r["step"] for r in rows["port"]] == [r["step"] for r in rows["jax"]] == [1, 2, 3]
    for a, b in zip(rows["port"], rows["jax"]):
        for k in keys:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=f"{k} step {a['step']}")
    assert rows["port"][0]["train/loss"] != rows["port"][-1]["train/loss"]  # it trained


def test_parse_args_keeps_the_jax_flags_and_defaults():
    """Every flag of JAX's ``fit`` with its default (``--n_model`` and
    ``--zero_opt`` included), plus ``--device``."""
    argv = ["fit", "-c", "configs/config_plm.yaml"]
    got, want = vars(cli.parse_args(argv)), vars(jcli.parse_args(argv))
    assert {k: got[k] for k in want} == want
    assert set(got) - set(want) == {"device"} and got["device"] == "cuda"


def test_fit_on_two_ranks_resumes_at_another_mesh(dataset, tmp_path):
    """``fit`` under a group of 2 ranks (gloo, CPU): 2 steps at (2, 1) with
    ``--zero_opt``, then a resume at (1, 2) to step 3, against one process
    doing the same (a resume starts at epoch 0, as in JAX): the logged
    train losses rtol 1e-5 and the written weights atol 1e-6 (fp32,
    dropout 0; the one batch of 8 cuts splits evenly, so the batch plan
    is the one process's)."""
    import parallel_workers as pw
    from megatts2_tpu_torch.training.checkpoints import read_checkpoint

    _, ds = dataset
    cfg2, cfg3 = _config(tmp_path, "plm", ds, 2), _config(tmp_path, "plm", ds, 3)
    logs, ck = str(tmp_path / "logs"), str(tmp_path / "ck")
    out = pw.run(2, [("cli_fit_meshes", dict(cfg2=cfg2, cfg3=cfg3, logs=logs, ck=ck))],
                 str(tmp_path))
    assert out["cli_fit_meshes"] is None, out["cli_fit_meshes"]
    ref_logs = str(tmp_path / "logs_ref")
    for cfg in (cfg2, cfg3):
        cli.main(["fit", "-c", cfg, "--log_dir", ref_logs, "--ckpt_dir", str(tmp_path / "ck_ref"),
                  "--device", "cpu"])
    got = [r for r in _rows(logs, "plm") if "train/loss" in r]
    want = [r for r in _rows(ref_logs, "plm") if "train/loss" in r]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    for a, b in zip(got, want):
        for k in ("train/loss", "train/loss_sum", "train/ac10"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=f"{k} step {a['step']}")
    a = read_checkpoint(os.path.join(ck, "step_3.ckpt"))["state_dict"]
    b = read_checkpoint(os.path.join(str(tmp_path / "ck_ref"), "step_3.ckpt"))["state_dict"]
    assert a.keys() == b.keys()
    for k in b:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=0, atol=1e-6, err_msg=k)
