"""The comparison that decides ``correct``, at test size on the CPU: under
each cell's limits the control (the reference one precision step below
the configuration, in the program's place) and every fault a cell can
have make ``correct`` false, and the program reads below the control on
every number the cell compares.  The fault runs go through everything of
a run but the look for the card.  (The limits were set from readings at
the cells' own sizes on the chip, where the program passes them;
``PERF.md`` gives them.)"""
import pytest

from benchmark import faults, harness
from benchmark.runners import synth, train

from .tiny import TINY, TINY_TRAIN, TRAFFIC_SYNTH, TRAFFIC_TRAIN

BENCH = harness.load_benchmark()
SYNTH, TRAIN = "int8-vocos.synth-b8", "plm-train.fit-b15"


def context(cell: str, cfg: dict, traffic: dict, seed: int, seconds: float = 1.0):
    """A run's context at test size, under the cell's limits."""
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    return harness.Context(entry, cfg, traffic, seed, seconds, False, device="cpu",
                           limits=harness.load_limits(cell))


def _correct(ctx) -> bool:
    out, _ = harness.run_cell(BENCH, ctx)
    return out["correct"]


def _program_below_control(rec):
    for k in rec["checks"]:
        assert rec["readings"][k] < rec["control_readings"][k], k
    assert not harness.judge(rec["control_checks"]), rec["control_checks"]


def test_synthesis_control_fails():
    _program_below_control(synth.run(context(SYNTH, TINY, TRAFFIC_SYNTH, 2**31 + 9), control=True))


@pytest.mark.parametrize("cell, cfg, traffic, seconds, fault", [
    (SYNTH, TINY, TRAFFIC_SYNTH, 1.0, "altered_code"),
    (TRAIN, TINY_TRAIN, TRAFFIC_TRAIN, 1.0, "state_unchanged"),
    (TRAIN, TINY_TRAIN, TRAFFIC_TRAIN, 1.0, "half_batch"),
])
def test_a_planted_fault_makes_the_run_incorrect(cell, cfg, traffic, seconds, fault):
    with faults.planted(fault, cfg["plm"]["vq_bins"]):
        assert not _correct(context(cell, cfg, traffic, 31, seconds))


def test_training_control_fails():
    rec = train.run(context(TRAIN, TINY_TRAIN, TRAFFIC_TRAIN, 2**31 + 5), control=True)
    assert rec["readings"]["grad_err"] < rec["control_readings"]["grad_err"]  # PERF.md §6
    assert not harness.judge(rec["control_checks"]), rec["control_checks"]


def test_the_training_reference_in_blocks_of_rows_is_the_whole(monkeypatch):
    """The reference sums a step's loss and gradient over blocks of rows;
    that is the whole batch's to rounding."""
    from megatts2_tpu_torch.config import MegaPLMConfig
    from megatts2_tpu_torch.models import MegaPLM

    from benchmark import reference as R
    from benchmark.weights import layout_of

    layout = layout_of(MegaPLM(MegaPLMConfig(**TINY_TRAIN["plm"])))
    batches = train.make_batches(7, TRAFFIC_TRAIN, TINY_TRAIN["plm"])
    ctx = context(TRAIN, TINY_TRAIN, TRAFFIC_TRAIN, 7)
    assert TRAFFIC_TRAIN["batch"] % train.REFERENCE_ROWS  # a short last block too
    blocked = train.reference_steps(ctx, layout, batches, R.Precision("fp32"))
    monkeypatch.setattr(train, "REFERENCE_ROWS", None)
    whole = train.reference_steps(ctx, layout, batches, R.Precision("fp32"))
    assert blocked["losses"] == pytest.approx(whole["losses"], rel=1e-5)
    for k, g in whole["grad"].items():
        assert float((blocked["grad"][k] - g).norm()) <= 1e-4 * max(float(g.norm()), 1e-6), k
