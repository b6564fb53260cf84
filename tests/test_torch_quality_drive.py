"""The port's quality tools (``megatts2_tpu_torch/tools``) driven as one
chain on the CPU at tiny widths (the stage configs of
``pipeline_fixtures``, 2 steps a stage): ``train_curve`` on a 2 × 4
corpus → ``e2e_quality`` float and int8 → ``quality_table`` →
``int8_margins`` → ``at_scale_stack`` on a 2 × 4 corpus with the EMA
generator (its fits and stage 2 as subprocesses) → ``heldout_eval`` on
two held-out speakers with one sampled decode.  Each record has the JAX
tool's keys (plus ``device``); its numbers are finite, but for the MCD
of a tail of 8 frames or fewer, which is NaN as in JAX (the ADMs of 2
steps give a frame or so a phone)."""
import json
import math

import pytest

from megatts2_tpu_torch.tools import (at_scale_stack, e2e_quality, heldout_eval, int8_margins,
                                      quality_table, train_curve)
from megatts2_tpu_torch.training.checkpoints import best_checkpoint, read_checkpoint
from pipeline_fixtures import YAMLS
from pipeline_fixtures import one_torch_thread  # noqa: F401 (module fixture)

STEPS = 2
E2E_KEYS = {"root", "text", "plm_decode", "speaker_f0_hz", "speakers", "n_speakers",
            "timbre_classification_acc", "mcd_db_mean", "duration_mae_frames_mean",
            "prompted_in_band_frac", "prompted_differs_frac", "timbre_transfer_ok",
            "timbre_transfer_ok_threshold"}
E2E_SPEAKER_KEYS = {"band_hz", "generated_f0_hz", "in_band", "classified_as", "mcd_db",
                    "duration_mae_frames", "prompted_f0_hz", "prompted_in_band",
                    "prompted_differs"}
HELDOUT_KEYS = {"mode", "train_root", "heldout_root", "design", "speaker_f0_hz", "ckpts",
                "ceiling_gt_codes", "greedy", "sampled", "duration_mae_frames", "rows", "wall_s"}


def _numbers(x, skip=()):
    """The numbers in a record, but for those under a key in ``skip``."""
    if isinstance(x, dict):
        return [v for k, val in x.items() if k not in skip for v in _numbers(val, skip)]
    if isinstance(x, (list, tuple)):
        return [v for val in x for v in _numbers(val, skip)]
    return [x] if isinstance(x, (int, float)) and not isinstance(x, bool) else []


def _finite(rec) -> bool:
    return all(math.isfinite(v) for v in _numbers(rec, skip=("mcd_db", "mcd_db_mean")))


def _quiet(line: str) -> None:
    json.loads(line)  # every line the tools print is one JSON record


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    """A directory of tiny ``config_<stage>.yaml`` files in the shipped layout."""
    d = tmp_path_factory.mktemp("configs")
    for stage, text in YAMLS.items():
        (d / f"config_{stage}.yaml").write_text(text.format(steps=1, val=1, ds="unused"))
    return d


@pytest.fixture(scope="module")
def curve(tmp_path_factory, configs):
    root = tmp_path_factory.mktemp("curve")
    rec = train_curve.run(str(root), STEPS, STEPS, "gan,vocoder,plm,adm", STEPS, n_per_spk=4,
                          device="cpu", configs=configs, emit=_quiet)
    return root, rec


def test_train_curve_trains_every_stage(curve):
    root, rec = curve
    assert set(rec) == {"corpus", "steps", "gan", "vocoder", "plm", "adm", "device"}
    assert rec["corpus"] == str(root) and rec["steps"] == STEPS and rec["device"] == "cpu"
    assert rec["gan"]["val/loss_re"][0][0] == STEPS
    assert [s for s, _ in rec["plm"]["val/ac10"]] == [STEPS]
    assert set(rec["vocoder"]) == {"train/G_loss_mel", "train/D_loss_total", "val/loss"}
    assert all(math.isfinite(v) for v in _numbers(rec))
    for stage in ("gan", "vocoder", "plm", "adm"):
        assert best_checkpoint(str(root / "ckpts" / stage)).endswith(f"step_{STEPS}.ckpt")


def test_e2e_quality_float_and_int8_then_the_table(curve, tmp_path, capsys):
    root, _ = curve
    paths = []
    for quant in (False, True):
        rec = e2e_quality.run(str(root), quant_int8=quant, device="cpu", emit=_quiet)
        assert set(rec) == E2E_KEYS | {"device"} and rec["device"] == "cpu"
        assert rec["plm_decode"] == ("int8" if quant else "fp32") and rec["n_speakers"] == 2
        assert sorted(rec["speakers"]) == ["spkA", "spkB"]
        assert all(set(s) == E2E_SPEAKER_KEYS for s in rec["speakers"].values())
        assert _finite(rec), rec
        paths.append(tmp_path / f"{rec['plm_decode']}.json")
        paths[-1].write_text(json.dumps(rec))
    capsys.readouterr()
    quality_table.main([str(p) for p in paths])
    table = capsys.readouterr().out.splitlines()
    assert table[0].startswith("| speaker | f0 band (Hz) | fp32: ") and "| int8: " in table[0]
    assert [line.split(" | ")[0] for line in table[2:4]] == ["| spkA", "| spkB"]
    assert table[-1].startswith("| prompted decode differs from BOS | ")


def test_int8_margins_on_the_trained_plm(curve):
    root, _ = curve
    rec = int8_margins.run(str(root), n_batches=2, device="cpu", emit=_quiet)
    assert set(rec) == {"ckpt", "positions", "batches", "margin_logits", "int8_perturbation_logits",
                        "teacher_forced_argmax_agreement", "at_risk_fraction_p99",
                        "at_risk_fraction_2x_p99", "device"}
    assert rec["ckpt"] == best_checkpoint(str(root / "ckpts" / "plm"))
    assert rec["positions"] > 0 and rec["batches"] >= 1
    assert 0 <= rec["teacher_forced_argmax_agreement"] <= 1
    assert 0 <= rec["at_risk_fraction_p99"] <= rec["at_risk_fraction_2x_p99"] <= 1
    assert all(math.isfinite(v) for v in _numbers(rec))


@pytest.fixture(scope="module")
def stack(tmp_path_factory, configs):
    """``at_scale_stack`` on a 2 × 4 corpus, its fits as subprocesses."""
    root = tmp_path_factory.mktemp("stack")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")  # the subprocesses
        rec = at_scale_stack.run(str(root), 2, 4, STEPS, STEPS, STEPS, STEPS, 0.999,
                                 device="cpu", configs=configs, emit=_quiet)
    return root, rec


def test_at_scale_stack_trains_every_stage_with_the_ema_generator(stack):
    root, rec = stack
    assert set(rec) == {"phase", "total_wall_s", "gan", "plm", "adm", "vocoder", "device"}
    assert rec["phase"] == "summary" and rec["device"] == "cpu"
    for stage in ("gan", "plm", "adm", "vocoder"):
        assert at_scale_stack.metrics_last_step(str(root / "logs50k" / f"{stage}_metrics.jsonl")) \
            == STEPS
    ckpt = read_checkpoint(best_checkpoint(str(root / "ckpts50k" / "gan")))
    assert ckpt["global_step"] == STEPS and "g_ema" in ckpt
    assert (root / "ds" / "latents").is_dir()


def test_heldout_eval_on_the_stack(stack, tmp_path):
    root, _ = stack
    rec = heldout_eval.run(str(root), str(root / "ckpts50k"), str(root / "gan50k.yaml"),
                           str(tmp_path / "heldout"), n_speakers=2, n_seeds=1, device="cpu",
                           emit=_quiet)
    assert set(rec) == HELDOUT_KEYS | {"device"} and rec["device"] == "cpu"
    assert rec["design"]["n_speakers"] == 2 and rec["design"]["bands_disjoint"]
    assert len(rec["rows"]) == 2 * len(heldout_eval.TEXTS) * 2
    assert rec["greedy"]["n_decodes"] == rec["sampled"]["n_decodes"] == 2 * len(heldout_eval.TEXTS)
    assert [r["spk"] for r in rec["ceiling_gt_codes"]["rows"]] == ["eval00", "eval01"]
    assert _finite(rec), rec
