"""The port's spans in a run's record (``benchmark/program_spans.py``) and
the metrics that read them, on synthetic records.

* ``by_span`` counts a device op that started inside a span and not one
  that started outside, and leaves out a span the slice's edge cuts.
* The span metrics read what the synthetic record holds, and nothing from
  a record without the program's spans.
* Every declared metric reads the same number with and without the new
  keys (``program``, ``trace.by_span``).
* The harness, the runners, the probe and the port's tracer load no JAX.
"""
import copy
import json

import pytest

from benchmark import harness
from benchmark import program_spans as P

from .test_bench_imports import _loaded

BENCH = harness.load_benchmark()
MS = 1_000_000  # ns


def test_by_span_counts_the_ops_that_start_inside_whole_spans():
    ops = [("k", 0.10, 0.12), ("k", 0.115, 0.13), ("k", 0.19, 0.25),  # in a
           ("k", 0.05, 0.11),  # starts before a
           ("k", 0.30, 0.31),  # in b
           ("k", 0.95, 0.99)]  # in the cut span
    spans = [("a", 0.10, 0.20, 4), ("b", 0.29, 0.40, 2), ("a", 0.50, 0.60, 3),
             ("cut", 0.90, 1.10, 5), ("early", -0.1, 0.05, 1)]
    got = P.by_span(ops, spans, 1.0)
    assert set(got) == {"a", "b"}  # spans across the slice's edges are left out
    a = got["a"]
    assert (a["spans"], a["n"], a["ops"]) == (2, 7, 3)
    assert a["host_s"] == pytest.approx(0.2)
    assert a["busy_s"] == pytest.approx(0.03 + 0.06)  # union of [.10, .13] and [.19, .25]
    assert (got["b"]["ops"], got["b"]["n"]) == (1, 2)
    assert got["b"]["busy_s"] == pytest.approx(0.01)


# ---------------------------------------------------------------- records


def _cfg(name):
    entry = harness.find(BENCH["configs"], name, "config")
    with open(harness.ROOT / entry["file"]) as f:
        return json.load(f)


def synth_record():
    cfg = _cfg("megatts2-int8-vocos")
    return {"setup_s": 14.0, "window_s": 51.0, "batches": 64, "utterances": 512,
            "untraced_s": 48.5, "untraced_batches": 60,
            "stage_times": {"mrte": [0.02, 0.021], "adm": [0.27, 0.28], "plm": [0.58, 0.6],
                            "decoder": [0.01, 0.01], "vocoder": [0.01, 0.01]},
            "work": {"batch": 8, "phones": 64, "prompt_frames": 512, "max_frames": 512,
                     "cfg": cfg},
            "trace": {"busy_s": 0.14, "window_s": 1.0, "op_s": {"nvjet_tss_64x8": 0.017},
                      "op_count": {"nvjet_tss_64x8": 900}}}


def train_record():
    plm = _cfg("megatts2-plm-train")["plm"]
    lens = [[900, 1100, 700], [1200, 800, 650]]
    return {"setup_s": 22.0, "window_s": 51.0, "steps": 610, "untraced_s": 49.0,
            "work": {"plm": plm, "step_lens": lens * 3, "untraced_lens": lens * 2,
                     "traced_lens": lens},
            "trace": {"busy_s": 1.9, "window_s": 2.0,
                      "op_s": {"flash_fwd_tc_kernel<64>": 0.06, "flash_bwd_dq_tc": 0.11,
                               "flash_bwd_dkdv_tc": 0.14},
                      "op_count": {"flash_fwd_tc_kernel<64>": 24, "flash_bwd_dq_tc": 24,
                                   "flash_bwd_dkdv_tc": 24}}}


def with_spans(rec, spans, by_span):
    rec = copy.deepcopy(rec)
    rec["program"] = {"spans": spans, "slice_ns": [1000 * MS, 1100 * MS]}
    rec["trace"]["by_span"] = by_span
    return rec


SYNTH_SPANS = [
    ["plm.decode", 10 * MS, 10 * MS + 64 * 9 * MS, 64],  # before the slice: 9 ms a step
    ["adm.decode", 5 * MS, 5 * MS + 64 * 4 * MS, 64],
    ["plm.decode", 1050 * MS, 1060 * MS, 64],  # inside the slice: not host-timed
    ["adm.decode", 990 * MS, 1010 * MS, 64],  # across its start: neither
    ["plm.decode", 1200 * MS, 1200 * MS + 64 * 8 * MS, 64],  # after: 8 ms a step
    ["synth.plm", 9 * MS, 900 * MS, 0],
]
SYNTH_BY_SPAN = {"plm.decode": {"spans": 2, "host_s": 1.1, "n": 128, "ops": 128 * 400,
                                "busy_s": 0.128},
                 "adm.decode": {"spans": 2, "host_s": 0.5, "n": 128, "ops": 128 * 150,
                                "busy_s": 0.0384}}
TRAIN_SPANS = [["train.batch_to_device", 0, 3 * MS, 4_000_000],
               ["train.batch_to_device", 1050 * MS, 1090 * MS, 4_000_000],  # in the slice
               ["train.batch_to_device", 1250 * MS, 1255 * MS, 4_000_000],
               ["train.forward", 3 * MS, 20 * MS, 0]]

EXPECTED = {
    "decode_step_ms.plm.synth": (9 * 64 + 8 * 64) / 128,
    "decode_step_ms.adm.synth": 4.0,
    "decode_step_kernels.plm.synth": 400.0,
    "decode_step_kernels.adm.synth": 150.0,
    "decode_step_busy_ms.plm.synth": 1.0,
    "decode_step_busy_ms.adm.synth": 0.3,
    "batch_copy_ms.train": 4.0,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_a_span_metric_reads_the_program_spans(name):
    synth = name.endswith(".synth")
    base = synth_record() if synth else train_record()
    rec = with_spans(base, SYNTH_SPANS if synth else TRAIN_SPANS, SYNTH_BY_SPAN if synth else {})
    read = harness.load_reader(name)
    assert read(rec) == pytest.approx(EXPECTED[name])
    assert read(base) is None  # a run without the program's spans reads nothing
    empty = copy.deepcopy(base)
    empty["program"] = {"spans": [], "slice_ns": None}
    assert read(empty) is None


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_declared_metric_reads_the_same_with_the_program_spans(cell):
    synth = cell == "int8-vocos.synth-b8"
    base = synth_record() if synth else train_record()
    rec = with_spans(base, SYNTH_SPANS if synth else TRAIN_SPANS, SYNTH_BY_SPAN if synth else {})
    for section in ("end_to_end", "per_layer"):
        for m in harness.metrics_of(BENCH, section, cell):
            read = harness.load_reader(m["name"])
            value = read(copy.deepcopy(base))
            assert value is not None, m["name"]
            assert read(rec) == value, m["name"]


def test_the_harness_the_probe_and_the_tracer_load_no_jax():
    loaded = _loaded("import benchmark.harness, benchmark.trace, benchmark.program_spans\n"
                     "import benchmark.span_probe\n"
                     "from benchmark.runners import synth, train\n"
                     "from megatts2_tpu_torch.utils import tracing\n"
                     "import megatts2_tpu_torch.models, megatts2_tpu_torch.training")
    assert not loaded & set(harness.FORBIDDEN)
    assert "megatts2_tpu_torch" in loaded


def test_the_probe_runs_the_readers_no_declared_metric_uses():
    from benchmark.span_probe import undeclared_readers

    assert undeclared_readers(BENCH) == sorted(EXPECTED)
