"""The VQ-GAN cell (``gan-train.fit-b64``): its entries and files, its
traffic at full size, its readers on synthetic records, its count of
work, and the comparison that decides ``correct`` at test size on the CPU
(the control and each fault of ``gan_faults.py`` fail it; the program
reads below the control on every number compared)."""
import copy
import json

import numpy as np
import pytest

from benchmark import gan_faults, harness
from benchmark import yardstick as Y
from benchmark import yardstick_gan as YG
from benchmark.runners import gan

BENCH = harness.load_benchmark()
CELL = "gan-train.fit-b64"
METRICS = ["mfu.gan", "idle_share.gan", "g_forward_busy_ms.gan", "d_step_busy_ms.gan",
           "g_step_busy_ms.gan", "g_forward_host_ms.gan", "d_step_host_ms.gan",
           "g_step_host_ms.gan", "conv_layout_share.gan"]
CHECKS = ["loss_gap", "grad_err_median", "change_gap", "codebook_gap", "bn_gap", "assign_gap",
          "ref_assign_gap"]  # compared

TINY = {
    "g": {"mrte": {"mel_bins": 80, "mel_activation": "ReLU", "mel_kernel_size": 3,
                   "mel_stride": 4, "mel_n_layer": 2, "mel_n_stack": 1, "mel_n_block": 2,
                   "content_ff_dim": 32, "content_n_heads": 2, "content_n_layers": 2,
                   "hidden_size": 16, "phone_vocab_size": 40, "dropout": 0.1},
          "vqpe": {"mel_bins": 20, "stride": 8, "hidden_size": 16, "kernel_size": 3,
                   "n_layers": 2, "n_stacks": 1, "n_blocks": 2, "vq_bins": 16, "vq_dim": 8},
          "kernel_size": 3, "hidden_size": 16, "decoder_n_stack": 1, "decoder_n_block": 2},
    "d": {"time_lengths": [8, 16, 64], "freq_length": 80, "kernel": [3, 3], "c_in": 1,
          "hidden_size": 8},
    "train": {"initial_learning_rate": 3e-5, "warmup_steps": 200, "max_steps": 600000,
              "G_commit_loss_coeff": 0.15, "G_vq_loss_coeff": 0.05, "G_adv_loss_coeff": 1.0,
              "g_ema_decay": 0.0, "train_dtype": "bfloat16", "start_step": 200, "b1": 0.9,
              "b2": 0.999, "eps": 1e-8, "weight_decay": 0.01},
}
TRAFFIC = {"runner": "gan", "batch": 5, "cut_seconds": [0.5, 0.9], "frame_rate": 62.5,
           "phones_per_second": 12, "phone_pad": 16, "mel_pad": 64, "min_mel_frames": 16,
           "timbre_frames": 32, "phone_ids": [1, 39], "sizes_seed": 1, "pool_batches": 3,
           "checked_steps": 2, "trace_start_s": 0.0}


def _config():
    entry = harness.find(BENCH["configs"], "megatts2-gan-train", "config")
    with open(harness.ROOT / entry["file"]) as f:
        return entry, json.load(f)


def test_the_cell_and_its_entries():
    cell = harness.find(BENCH["workloads"], CELL, "workload")
    assert cell["chips"] == 1 and cell["config"] == "megatts2-gan-train"
    entry, cfg = _config()
    assert entry["reduced"] == [] and cfg["reduced"] == []
    assert cfg["g"]["mrte"]["hidden_size"] == 512 and cfg["g"]["vqpe"]["vq_bins"] == 1024
    assert cfg["d"]["time_lengths"] == [32, 64, 128] and cfg["d"]["hidden_size"] == 192
    assert "use_flash" not in cfg["g"]["mrte"] and cfg["train"]["train_dtype"] == "bfloat16"
    assert {"start_step", "codebook", "batch", "phone rate", "timbre length"} <= set(cfg["assumed"])
    e2e = {m["name"] for m in harness.metrics_of(BENCH, "end_to_end", CELL)}
    assert e2e == {"train_step_ms", "setup_s"}
    per_layer = harness.metrics_of(BENCH, "per_layer", CELL)
    assert sorted(m["name"] for m in per_layer) == sorted(METRICS)
    for m in per_layer:
        assert m["workloads"] == [CELL] and m["moves"] == "train_step_ms"
        assert harness.reader_path(m["name"]).is_file()


def test_the_limits_file_holds_every_number_compared():
    limits = harness.load_limits(CELL)
    assert sorted(limits) == sorted(CHECKS)
    assert all(np.isfinite(v) and v > 0 for v in limits.values())


def test_the_traffic_at_full_size():
    _, cfg, traffic = harness.load_cell(BENCH, CELL)
    frames, phones = gan.row_sizes(traffic)
    assert frames.shape == (4, 64) and traffic["checked_steps"] == 2
    secs = (frames - 1) / 62.5
    assert secs.min() >= 11.0 - 0.02 and secs.max() <= 13.0
    a, b = gan.make_batches(3, traffic), gan.make_batches(2**40 + 9, traffic)
    for x in a:
        assert x["mel_targets"].shape == (64, 832, 80) and x["mel_targets"].dtype == np.float16
        assert x["mel_timbres"].shape == (64, 1024, 80)
        assert x["phone_tokens"].shape[1] % 16 == 0 and x["phone_tokens"].shape[1] >= 156
        assert (x["duration_tokens"].sum(1) == x["mel_target_lens"]).all()
    sizes = lambda p: sorted(tuple(x["mel_target_lens"].tolist()) for x in p)  # noqa: E731
    assert sizes(a) == sizes(b)  # the seed draws the values and the order, not the work
    assert not np.array_equal(a[0]["mel_targets"], b[0]["mel_targets"])


# ---------------------------------------------------------------- readers

MS = 1_000_000


def gan_record(with_program: bool):
    _, cfg = _config()
    rec = {"setup_s": 40.0, "window_s": 50.0, "steps": 48, "untraced_s": 45.0,
           "work": {"cfg": {"g": cfg["g"], "d": cfg["d"]},
                    "shapes": [[64, 832, 160, 1024]] * 4, "untraced_passes": 11, "passes": 12},
           "trace": {"busy_s": 3.6, "window_s": 4.0,
                     "op_s": {"void cudnn::nchwToNhwcKernel<bf16>": 0.3,
                              "void cudnn::nhwcToNchwKernel<bf16>": 0.06, "other": 3.24},
                     "op_count": {"void cudnn::nchwToNhwcKernel<bf16>": 40,
                                  "void cudnn::nhwcToNchwKernel<bf16>": 12, "other": 900}}}
    if with_program:
        rec["program"] = {"spans": [["gan.g_forward", 0, 100 * MS, 53248],
                                    ["gan.d_step", 100 * MS, 130 * MS, 64],
                                    ["gan.g_step", 130 * MS, 300 * MS, 0],
                                    ["gan.g_forward", 5000 * MS, 5500 * MS, 53248],  # in the slice
                                    ["gan.g_forward", 9000 * MS, 9080 * MS, 53248]],
                          "slice_ns": [4000 * MS, 8000 * MS]}
        rec["trace"]["by_span"] = {
            "gan.g_forward": {"spans": 4, "host_s": 0.4, "n": 4 * 53248, "ops": 4000,
                              "busy_s": 0.8},
            "gan.d_step": {"spans": 4, "host_s": 0.1, "n": 256, "ops": 900, "busy_s": 0.1},
            "gan.g_step": {"spans": 4, "host_s": 0.9, "n": 0, "ops": 9000, "busy_s": 1.2}}
    return rec


EXPECTED = {"g_forward_busy_ms.gan": 200.0, "d_step_busy_ms.gan": 25.0,
            "g_step_busy_ms.gan": 300.0, "g_forward_host_ms.gan": 90.0,
            "d_step_host_ms.gan": 30.0, "g_step_host_ms.gan": 170.0,
            "conv_layout_share.gan": 10.0, "idle_share.gan": 10.0}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_a_reader_reads_the_record_and_nothing_without_its_data(name):
    read = harness.load_reader(name)
    assert read(gan_record(True)) == pytest.approx(EXPECTED[name])
    bare = gan_record(False)
    if name.endswith(("busy_ms.gan", "host_ms.gan")):
        assert read(bare) is None  # the parent's record: no gan.* spans
    assert read({"setup_s": 1.0, "window_s": 1.0, "steps": 1}) is None


def test_mfu_reads_the_untraced_passes():
    rec = gan_record(False)
    _, cfg = _config()
    flops = 4 * YG.train_step_flops(cfg, 64, 832, 160, 1024) * 11
    got = harness.load_reader("mfu.gan")(rec)
    assert got == pytest.approx(100 * flops / (45.0 * Y.PEAK_FLOPS["bf16"]))
    assert 0.5 < got < 20  # a share, at the predicted step of about a second


def test_the_flop_count_by_hand():
    """One row of 16 target frames (2 latents), 4 phones, 32 timbre frames,
    every width 2, kernels 3, one block of one stack, the MRTE's stride 16."""
    cfg = {"g": {"mrte": {"mel_bins": 2, "mel_stride": 16, "mel_n_layer": 1, "mel_n_stack": 1,
                          "mel_n_block": 1, "mel_kernel_size": 3, "content_ff_dim": 2,
                          "content_n_layers": 1, "hidden_size": 2},
                 "vqpe": {"mel_bins": 2, "stride": 8, "hidden_size": 2, "kernel_size": 3,
                          "n_layers": 1, "n_stacks": 1, "n_blocks": 1, "vq_bins": 3, "vq_dim": 2},
                 "kernel_size": 3, "hidden_size": 2, "decoder_n_stack": 1, "decoder_n_block": 1},
           "d": {"time_lengths": [4], "freq_length": 4, "kernel": [3, 3], "c_in": 1,
                 "hidden_size": 2}}
    conv = lambda t, k, i, o: 2 * t * k * i * o  # noqa: E731
    vq = (conv(16, 3, 2, 2) + conv(16, 3, 2, 2) + conv(2, 3, 2, 2) + conv(2, 3, 2, 2)
          + 2 * 2 * 3 * 2)
    mel = conv(32, 3, 2, 2) + conv(32, 3, 2, 2) + conv(2, 17, 2, 2) + conv(2, 3, 2, 2) \
        + conv(2, 3, 2, 2)
    layer = 2 * (4 * 4 * 2 * 2 + 2 * 4 * 4 * 2) + 2 * conv(4, 5, 2, 2)
    xattn = 2 * (2 * 4 * 4 + 2 * 2 * 4 + 2 * 4 * 2 * 2)
    dec = conv(16, 3, 4, 2) + conv(16, 3, 2, 2) + conv(16, 3, 2, 2)
    assert YG.g_forward_flops(cfg, 1, 16, 4, 32) == vq + mel + layer + xattn + dec
    d = 2 * (2 * 2 * 9 * 1 * 2 + 1 * 1 * 9 * 2 * 2 + 1 * 1 * 9 * 2 * 2 + 1 * 1 * 2)
    assert YG.d_pass_flops(cfg, 1) == d
    assert YG.train_step_flops(cfg, 1, 16, 4, 32) == 3 * (vq + mel + layer + xattn + dec) + 8 * d


# ---------------------------------------------------------------- the check


def context(seed: int, dtype: str = "bfloat16"):
    cell = harness.find(BENCH["workloads"], CELL, "workload")
    cfg = dict(TINY, train=dict(TINY["train"], train_dtype=dtype))
    return harness.Context(cell, cfg, TRAFFIC, seed, 1.0, False, device="cpu",
                           limits=harness.load_limits(CELL))


def test_the_control_fails_and_the_program_reads_below_it():
    """bf16 at test size: the control fails, and the program reads below
    it on the numbers whose cell-size readings the limits separate."""
    rec = gan.run(context(2**31 + 5), control=True)
    assert not harness.judge(rec["control_checks"]), rec["control_checks"]
    for k in ("loss_gap", "grad_err_median", "codebook_gap", "bn_gap"):
        assert rec["readings"][k] < rec["control_readings"][k], k


@pytest.mark.parametrize("fault", gan_faults.NAMES)
def test_a_planted_fault_makes_the_run_incorrect(fault):
    """fp32 at test size, where the program passes every limit."""
    out, _ = harness.run_cell(BENCH, context(31, "float32"))
    assert out["correct"], out["checks"]
    with gan_faults.planted(fault):
        out, rec = harness.run_cell(BENCH, context(31, "float32"))
    assert not out["correct"], rec["readings"]


def test_the_runner_loads_no_jax():
    from .test_bench_imports import _loaded

    loaded = _loaded("import benchmark.harness, benchmark.reference_gan, benchmark.gan_faults\n"
                     "from benchmark.runners import gan\n"
                     "import megatts2_tpu_torch.training")
    assert not loaded & set(harness.FORBIDDEN)
    assert "megatts2_tpu_torch" in loaded
    assert "megatts2_tpu_torch" not in _loaded("import benchmark.reference_gan, "
                                               "benchmark.yardstick_gan")


def test_a_record_is_the_same_after_reading():
    rec = gan_record(True)
    before = copy.deepcopy(rec)
    for name in METRICS:
        harness.load_reader(name)(rec)
    assert rec == before
