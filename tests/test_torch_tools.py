"""The port's measurement tools (``megatts2_tpu_torch/tools``) on the CPU at
tiny widths, held against the JAX tools where they compute the same thing:

* ``bench_input_pipeline.build_corpus`` writes the JAX tool's files byte
  for byte (the JAX tool imported by path);
* ``long_run_summary`` prints the JAX tool's record for the same jsonl;
* ``bench_train``'s four stages print records with the JAX tool's keys, the
  GAN's ``gflop_per_step`` JAX's count;
* ``http_bench``: every request answers 200 with a wav, the report has the
  JAX tool's keys;
* ``long_train`` on a 2 × 4 corpus: killed, resumed, the log reaches
  ``--steps``; then ``bench_input_pipeline``'s loader, loader-fed GAN steps,
  stage 2 from that run's checkpoint and loader-fed PLM and ADM steps;
* the flags and defaults of the JAX tools, plus ``--device``; every tool
  asks for the card unless given ``--device cpu``; the config writer's
  YAML reads back as written; ``profile_train``'s summary of a trace.
"""
import ast
import importlib.util
import json
import os
import sys
from pathlib import Path

import pytest
import torch

from megatts2_tpu_torch import config as c
from megatts2_tpu_torch.config import yaml_load
from megatts2_tpu_torch.tools import (bench_input_pipeline, bench_train, http_bench,
                                      long_run_summary, long_train, profile_train)
from pipeline_fixtures import ADM_YAML, GAN_YAML, PLM_YAML
from pipeline_fixtures import one_torch_thread  # noqa: F401 (module fixture)

REPO = Path(__file__).resolve().parents[1]
TINY_MRTE = dict(mel_stride=16, mel_n_layer=1, mel_n_stack=1, mel_n_block=1, content_ff_dim=32,
                 content_n_heads=2, content_n_layers=1, hidden_size=16, dropout=0.0)
# the GAN of the bench_train test: an MRTE wide enough that a step counts
# over 0.1 GFLOP, the record's one decimal
WIDE_MRTE = {**TINY_MRTE, "content_ff_dim": 64, "hidden_size": 64}
TINY_VQPE = dict(hidden_size=16, kernel_size=3, n_layers=1, n_stacks=1, n_blocks=1, vq_bins=32,
                 vq_dim=8)
TINY_DECODER = dict(kernel_size=3, hidden_size=16, decoder_n_stack=1, decoder_n_block=1)
TINY_G = c.MegaGConfig(mrte=c.MRTEConfig(**TINY_MRTE), vqpe=c.VQPEConfig(**TINY_VQPE), **TINY_DECODER)
TINY_D = c.DiscriminatorConfig(time_lengths=(8, 16), hidden_size=8)
TINY_PLM = c.MegaPLMConfig(n_layers=2, n_heads=2, vq_dim=8, tc_latent_dim=16, vq_bins=32)
TINY_ADM = c.MegaADMConfig(n_layers=2, n_heads=2, emb_dim=8, tc_latent_dim=16, tc_emb_dim=8)
TINY_VOC = c.VocosConfig(dim=16, intermediate_dim=32, num_layers=1)
TINY_WD = c.WaveDiscConfig(periods=(2, 3), msd_scales=2, mpd_base_ch=4, msd_base_ch=8, max_ch=16)
# long_train: checkpoints every 4 steps, killed once the log reaches step 6,
# so the resumed run logs again from step 5 (a backward jump), then to 10
STEPS, VAL_EVERY, KILL_AT = 10, 4, 6


def _jax_tool(name: str):
    """The JAX package's ``tools/<name>.py`` as a module (it is not a package)."""
    path = REPO / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved  # the tool puts "." first on the path
    return mod


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def test_build_corpus_writes_the_jax_tools_files_byte_for_byte(tmp_path, capsys):
    jtool = _jax_tool("bench_input_pipeline")
    jtool.build_corpus(str(tmp_path / "jax"), 2, 2)
    out = bench_input_pipeline.build_corpus(str(tmp_path / "port"), 2, 2, device="cpu")
    assert out == tuple(str(tmp_path / "port" / d) for d in ("wavs", "textgrids", "ds"))
    jax_files, port_files = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert len(port_files) == 2 * 2 * 3  # a wav, a .txt and a TextGrid each
    assert port_files.keys() == jax_files.keys()
    for name, data in jax_files.items():
        assert port_files[name] == data, name
    jrec, prec = (json.loads(line) for line in capsys.readouterr().out.splitlines())
    assert set(prec) - {"device"} == set(jrec) and prec["utterances"] == jrec["utterances"] == 4
    assert prec["audio_hours"] == jrec["audio_hours"]


def _metrics_log(path: Path, jumps: list) -> None:
    """A gan_metrics.jsonl as the CLI appends it: train rows every 100 steps,
    val rows every 500, a loop row at the end of the run; at each
    (killed_after, restored_to) of ``jumps`` the trainer is killed and the
    next launch logs again the steps after the checkpoint it restores."""
    rows, t, step = [], 1000.0, 0
    plan = sorted(jumps) + [(2500, None)]
    for killed_after, restored_to in plan:
        while step < killed_after:
            step += 100
            t += 37.5
            rows.append({"step": step, "time": t, "train/G_loss_re": 1.0 / (1 + step / 700),
                         "train/steps_per_sec": 2.5 + (step % 300) / 1000, "train/host_rss_gb": 3.1})
            if step % 500 == 0:
                rows.append({"step": step, "time": t + 1, "val/loss_re": 0.9 / (1 + step / 900)})
        if restored_to is None:
            rows.append({"step": step, "time": t + 2, "loop/steps": 9, "loop/step_ms_median": 400.0})
        else:
            step, t = restored_to, t + 60
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))


@pytest.mark.parametrize("jumps", [[], [(1700, 1500)], [(900, 500), (2300, 2000)]])
def test_long_run_summary_prints_the_jax_tools_record(tmp_path, capsys, monkeypatch, jumps):
    path = tmp_path / "gan_metrics.jsonl"
    _metrics_log(path, jumps)
    jtool = _jax_tool("long_run_summary")
    monkeypatch.setattr(sys, "argv", ["long_run_summary.py", str(path)])
    jtool.main()
    want = json.loads(capsys.readouterr().out)
    got = long_run_summary.main([str(path)])
    assert json.loads(capsys.readouterr().out) == want
    assert got["max_step"] == 2500 and len(got["resume_events"]) == len(jumps)
    assert [e["restored_to"] for e in got["resume_events"]] == [r for _, r in jumps]


JAX_LM_KEYS = {"batch", "tokens_per_sec", "step_ms", "device"}


@pytest.mark.parametrize("stage", ["plm", "adm", "vocoder", "gan"])
def test_bench_train_stage_records_have_the_jax_keys(stage, capsys):
    from megatts2_tpu import config as jcfg
    from megatts2_tpu.utils.flops import gan_step_flops

    if stage == "plm":
        rec = bench_train.bench_lm("plm", 2, "cpu", TINY_PLM, length=32)
        keys = JAX_LM_KEYS
    elif stage == "adm":
        rec = bench_train.bench_lm("adm", 2, "cpu", TINY_ADM, length=16)
        keys = JAX_LM_KEYS
    elif stage == "vocoder":
        rec = bench_train.bench_vocoder(2, "cpu", TINY_VOC, TINY_WD)
        keys = {"batch", "audio_sec_per_sec", "step_ms", "device"}
    else:
        g = c.MegaGConfig(mrte=c.MRTEConfig(**WIDE_MRTE), vqpe=c.VQPEConfig(**TINY_VQPE),
                          **TINY_DECODER)
        rec = bench_train.bench_gan(2, "cpu", g, TINY_D, Tm=128, Tp=16, Tt=128)
        keys = {"batch", "mel_frames_per_sec", "step_ms", "gflop_per_step", "mfu", "device"}
        jg = jcfg.MegaGConfig(mrte=jcfg.MRTEConfig(**WIDE_MRTE), vqpe=jcfg.VQPEConfig(**TINY_VQPE),
                              **TINY_DECODER)
        want = round(gan_step_flops(jg, 2, 16, 128, 128) / 1e9, 1)
        assert rec["detail"]["gflop_per_step"] == want > 0
        assert rec["detail"]["mfu"] is None  # no device peak off the card
    assert json.loads(capsys.readouterr().out) == rec
    assert set(rec) == {"metric", "value", "unit", "detail"} and set(rec["detail"]) == keys
    assert rec["metric"] == f"{stage}_train_steps_per_sec" and rec["unit"] == "steps/s"
    assert rec["value"] > 0 and rec["detail"]["step_ms"] > 0 and rec["detail"]["device"] == "cpu"


def test_http_bench_answers_every_request_with_a_wav(capsys):
    rec = http_bench.run(requests=3, clients=2, rps=50.0, slots=2, max_frames=64, chunk_frames=32,
                         n_phones=6, device="cpu", cfgs=(TINY_G, TINY_PLM, TINY_ADM, TINY_VOC))
    assert set(rec) - {"device"} == {"metric", "requests", "clients", "offered_rps", "slots",
                                     "achieved_rps", "p50_ms", "p90_ms", "p99_ms", "max_ms"}
    assert rec["metric"] == "http_serving_latency" and rec["requests"] == 3 and rec["clients"] == 2
    assert 0 < rec["p50_ms"] <= rec["p90_ms"] <= rec["p99_ms"] <= rec["max_ms"]
    assert rec["achieved_rps"] > 0 and rec["device"] == "cpu"
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == rec


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``long_train`` on a 2 × 4 corpus with the tiny GAN, on the CPU: killed
    once its log reaches KILL_AT, resumed to STEPS."""
    root = tmp_path_factory.mktemp("long_train")
    bench_input_pipeline.build_corpus(str(root), 2, 4, device="cpu")
    shipped = root / "tiny_gan.yaml"
    shipped.write_text(GAN_YAML.format(steps=1, val=1, ds="unused"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")  # the trainer's subprocesses
        summary = long_train.run(str(root), STEPS, VAL_EVERY, KILL_AT, device="cpu",
                                 shipped=str(shipped), log_every=1, emit=lambda line: None)
    return root, shipped, summary


def test_long_train_is_killed_resumed_and_reaches_its_steps(trained):
    root, shipped, summary = trained
    assert [x["rc"] for x in summary["launches"]] == [-9, 0], summary
    assert KILL_AT <= summary["killed_at_step"] < 2 * VAL_EVERY
    assert summary["launches"][1]["reached_step"] == STEPS
    mpath = root / "logs50k" / "gan_metrics.jsonl"
    assert long_train.metrics_step(str(mpath)) == STEPS
    assert [s for s, _ in summary["val_curve"]] == [VAL_EVERY, 2 * VAL_EVERY]
    rec = long_run_summary.summarize(str(mpath), emit=lambda line: None)
    assert rec["max_step"] == STEPS
    assert rec["resume_events"] == [{"restored_to": VAL_EVERY, "killed_after": summary["killed_at_step"]}]
    cfg = yaml_load((root / "gan50k.yaml").read_text())
    assert cfg["trainer"] == {"max_steps": STEPS, "log_every_n_steps": 1, "val_check_interval": VAL_EVERY}
    assert cfg["data"]["max_duration_batch"] == 40 and cfg["data"]["max_timbre_frames"] == 512
    assert cfg["model"] == yaml_load(shipped.read_text())["model"]


def test_loader_and_loader_fed_steps_on_the_prepared_corpus(trained):
    root, shipped, _ = trained
    ds = str(root / "ds")
    recs = bench_input_pipeline.bench_loader(ds, 2, "cpu", emit=lambda line: None)
    assert [r["native_ring"] for r in recs] == [True, False]
    # the 7 train cuts of 3.2 s fit one batch of 25.7 s, the warm one, and
    # the timed loop stops at the epoch's end, as the JAX tool's does
    assert all(r["batch_mb"] > 0 and r["batches"] == 0 for r in recs)
    rec = bench_input_pipeline.bench_gan_steps(ds, 2, "cpu", TINY_G, TINY_D, emit=lambda line: None)
    assert rec["bench"] == "gan_loader_fed_steps" and rec["steps"] == 2 and rec["steps_per_s"] > 0


def test_stage2_and_lm_steps_from_the_long_runs_checkpoint(trained, tmp_path):
    from megatts2_tpu_torch.training.checkpoints import latest_checkpoint

    root, shipped, _ = trained
    ds = str(root / "ds")
    ckpt = latest_checkpoint(str(root / "ckpts50k" / "gan"))
    assert ckpt.endswith(f"step_{STEPS}.ckpt")
    rec = bench_input_pipeline.bench_stage2(ds, ckpt, str(shipped), "cpu", emit=lambda line: None)
    assert rec["result"]["cuts"] == rec["latents"] == 8
    for stage, yaml in (("plm", PLM_YAML), ("adm", ADM_YAML)):
        cfg = tmp_path / f"{stage}.yaml"
        cfg.write_text(yaml.format(steps=1, val=1, ds=ds))
        rec = bench_input_pipeline.bench_lm_steps(stage, ds, 2, str(cfg), "cpu", emit=lambda line: None)
        assert rec["bench"] == f"{stage}_loader_fed_steps" and rec["steps"] == 2 and rec["steps_per_s"] > 0


def _flags(path: Path) -> list:
    """(flag, default) of every ``add_argument`` call in a script."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument":
            default = [ast.literal_eval(k.value) for k in node.keywords if k.arg == "default"]
            out.append((node.args[0].value, default[0] if default else None))
    return out


@pytest.mark.parametrize("name", ["bench_train", "http_bench", "bench_input_pipeline", "long_train"])
def test_tools_keep_the_jax_flags_and_defaults_plus_device(name):
    port = _flags(REPO / "megatts2_tpu_torch" / "tools" / f"{name}.py")
    assert port == _flags(REPO / "tools" / f"{name}.py") + [("--device", "cuda")]


@pytest.mark.parametrize("argv", [
    ["bench_train", "8", "--stages", "plm"], ["profile_train", "gan"], ["http_bench"],
    ["bench_input_pipeline", "--root", "ROOT"], ["long_train", "--root", "ROOT"]])
def test_tools_ask_for_the_card_by_default(argv, tmp_path, monkeypatch):
    """Without a card each tool raises before it builds a model or a corpus."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = {"bench_train": bench_train, "profile_train": profile_train, "http_bench": http_bench,
           "bench_input_pipeline": bench_input_pipeline, "long_train": long_train}[argv[0]]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([str(tmp_path) if a == "ROOT" else a for a in argv[1:]])
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("name", ["gan", "plm", "adm", "vocoder"])
def test_config_writer_reads_back_every_shipped_config(name):
    cfg = yaml_load((REPO / "configs" / f"config_{name}.yaml").read_text())
    assert yaml_load(long_train.yaml_dump(cfg)) == cfg


def test_profile_summary_of_a_trace(tmp_path):
    """Busy time is the union of the device ops' spans; the window runs from
    the first op's start to the last one's end; host ops are left out."""
    events = [{"ph": "X", "cat": "kernel", "name": "a", "ts": 0, "dur": 100},
              {"ph": "X", "cat": "kernel", "name": "b", "ts": 50, "dur": 100},
              {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 400, "dur": 100},
              {"ph": "X", "cat": "kernel", "name": "a", "ts": 900, "dur": 100},
              {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 5000}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    recs = profile_train.summarize(str(path), top=2, card="card", emit=lambda line: None)
    assert recs[0] == {"plane": "cuda", "total_ms": 0.4, "busy_ms": 0.35, "window_ms": 1.0,
                       "idle_share": 0.65, "ops": 3, "device": "card"}
    assert [(r["op"], r["ms"], r["count"]) for r in recs[1:]] == [("a", 0.2, 2), ("b", 0.1, 1)]
