"""The port's VQ-GAN train step (``training/gan_trainer.py``) held against
the benchmark's plain reference (``benchmark/reference_gan.py``) on the CPU
at tiny widths, fp32 on both sides, over 2 steps from the same seeded
weights (``benchmark/runners/gan.py`` ``gan_weights``: the codebook as a
resumed run leaves it) with the same injected draws (dropout masks,
codebook sample rows, window starts; ``make_draws``), each side assigning
its own codes.  The widest window is longer than
the batch's mel, so it scores zero while its BatchNorm still updates.

Tolerances, each for fp32 sums taken in another order: the nine metrics
rtol 1e-5; each leaf's first gradient and the codebook's and BatchNorm's
statistics within 1e-5 of the leaf's norm (or the median leaf's, when
larger); each leaf's change within 1e-4 of its norm over the elements
whose gradient is at least 1e-3 of the median leaf's RMS gradient (Adam
turns a gradient that is nought to rounding, as a key projection's bias
has under softmax, into a step of up to lr either way).

Also: the reference in blocks of rows is the whole batch's; the codebook
reads ``inited`` from the device once and keeps it on the host (a fresh
codebook runs k-means on the first train step only; one loaded with
``inited`` 1 never); the reference imports nothing of the port.
"""
import ast
import statistics
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import reference as R
from benchmark import reference_gan as RG
from benchmark.harness import Context
from benchmark.runners import gan

ROOT = Path(__file__).resolve().parent.parent
CFG = {
    "g": {"mrte": {"mel_bins": 80, "mel_activation": "ReLU", "mel_kernel_size": 3,
                   "mel_stride": 4, "mel_n_layer": 2, "mel_n_stack": 1, "mel_n_block": 2,
                   "content_ff_dim": 32, "content_n_heads": 2, "content_n_layers": 2,
                   "hidden_size": 16, "phone_vocab_size": 40, "dropout": 0.1},
          "vqpe": {"mel_bins": 20, "stride": 8, "hidden_size": 16, "kernel_size": 3,
                   "n_layers": 2, "n_stacks": 1, "n_blocks": 2, "vq_bins": 16, "vq_dim": 8},
          "kernel_size": 3, "hidden_size": 16, "decoder_n_stack": 1, "decoder_n_block": 2},
    "d": {"time_lengths": [8, 16, 64], "freq_length": 80, "kernel": [3, 3], "c_in": 1,
          "hidden_size": 8},
    "train": {"initial_learning_rate": 1e-3, "warmup_steps": 200, "max_steps": 100000,
              "G_commit_loss_coeff": 0.15, "G_vq_loss_coeff": 0.05, "G_adv_loss_coeff": 1.0,
              "g_ema_decay": 0.0, "train_dtype": "float32", "start_step": 200, "b1": 0.9,
              "b2": 0.999, "eps": 1e-8, "weight_decay": 0.01},
}
TRAFFIC = {"runner": "gan", "batch": 5, "cut_seconds": [0.5, 0.9], "frame_rate": 62.5,
           "phones_per_second": 12, "phone_pad": 16, "mel_pad": 64, "min_mel_frames": 16,
           "timbre_frames": 32, "phone_ids": [1, 39], "sizes_seed": 1, "pool_batches": 2,
           "checked_steps": 2, "trace_start_s": 0.0}
SEED = 2**31 + 17


@pytest.fixture(scope="module")
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ctx():
    return Context({"name": "tiny", "chips": 1}, CFG, TRAFFIC, SEED, 1.0, False, device="cpu")


def _tensors(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def port_steps(ctx):
    """The port's 2 steps: metrics, first gradients, changes, statistics."""
    from megatts2_tpu_torch.nn import Draws

    step, state, layout = gan.build_state(ctx)
    batches = gan.make_batches(ctx.seed, ctx.traffic)
    params = gan.params_of(state)
    p0 = {k: p.detach().clone() for k, p in params.items()}
    out = {"metrics": [], "codes": []}
    state.g.vqpe.vq.register_forward_hook(lambda m, a, o: out["codes"].append(o[1][0].clone()))
    for i in range(2):
        state.draws = Draws(replay=gan.make_draws(ctx.seed, i, batches[i], CFG, "cpu"))
        out["metrics"].append({k: float(v) for k, v in step(state, batches[i]).items()})
        assert not any(state.draws.replay.values()), "the step left injected draws unused"
        if i == 0:
            out["grad"] = {k: p.grad.detach().clone() for k, p in params.items()}
    out["change"] = {k: p.detach() - p0[k] for k, p in params.items()}
    out["stats"] = gan.statistics_of(state)
    return out, layout, batches


def reference_steps(ctx, layout, batches, rows=None):
    W = gan.gan_weights(layout, CFG, ctx.seed, "cpu")
    tb = [_tensors(b) for b in batches]
    draws = [gan.make_draws(ctx.seed, i, b, CFG, "cpu") for i, b in enumerate(tb)]
    return RG.train_gan(W, CFG, tb, draws, CFG["train"]["start_step"], R.Precision("fp32"), rows)


def _close_leaves(a, b, rel, keys=None):
    keys = list(b) if keys is None else keys
    med = statistics.median(float(b[k].norm()) for k in keys)
    for k in keys:
        err = float((a[k].float() - b[k].float()).norm())
        assert err <= rel * max(float(b[k].norm()), med, 1e-12), (k, err, float(b[k].norm()))


@pytest.fixture(scope="module")
def both(torch_threads):
    ctx = _ctx()
    port, layout, batches = port_steps(ctx)
    return port, reference_steps(ctx, layout, batches), layout, batches


def test_the_nine_metrics_agree(both):
    port, ref = both[:2]
    for a, b in zip(port["metrics"], ref["metrics"]):
        assert set(a) == set(b) and len(a) == 9
        for k in b:
            assert a[k] == pytest.approx(b[k], rel=1e-5, abs=1e-9), k


def test_the_first_gradients_of_g_and_d_agree(both):
    port, ref = both[:2]
    assert {k.split(".")[0] for k in ref["first_grad"]} == {"g", "d"}
    _close_leaves(port["grad"], ref["first_grad"], 1e-5)


def test_the_parameter_changes_agree(both):
    port, ref = both[:2]
    grad = ref["first_grad"]
    rms = {k: float(g.norm()) / g.numel() ** 0.5 for k, g in grad.items()}
    floor = 1e-3 * statistics.median(rms.values())
    lr = CFG["train"]["initial_learning_rate"]
    for k, g in grad.items():
        keep = g.abs() >= floor
        a, b = port["change"][k], ref["change"][k]
        if keep.any():
            err = float((a[keep] - b[keep]).norm())
            assert err <= 1e-4 * float(b[keep].norm()), (k, err)
        assert float((a - b).abs().max()) <= 2.5 * lr, k  # the rest: at most a step each way


@pytest.mark.parametrize("kind", ["codebook", "batch_norm"])
def test_the_statistics_agree(both, kind):
    port, ref = both[:2]
    keys = [k for k in ref["stats"] if (k.startswith(RG.CODEBOOK)) == (kind == "codebook")]
    assert len(keys) == (4 if kind == "codebook" else 4 * (len(CFG["d"]["time_lengths"])))
    _close_leaves(port["stats"], ref["stats"], 1e-5, keys)
    if kind == "codebook":
        assert float(port["stats"][RG.CODEBOOK + "inited"]) == 1.0


def test_the_reference_in_blocks_of_rows_is_the_whole(both):
    _, whole, layout, batches = both
    blocked = reference_steps(_ctx(), layout, batches, rows=2)
    assert TRAFFIC["batch"] % 2  # a short last block too
    for a, b in zip(blocked["metrics"], whole["metrics"]):
        for k in b:
            assert a[k] == pytest.approx(b[k], rel=1e-5, abs=1e-9), k
    _close_leaves(blocked["first_grad"], whole["first_grad"], 1e-5)
    _close_leaves(blocked["stats"], whole["stats"], 1e-6)
    for a, b in zip(blocked["codes"], whole["codes"]):
        assert torch.equal(a, b)


def test_the_codes_agree(both):
    port, ref = both[:2]
    assert len(port["codes"]) == len(ref["codes"]) == 2
    for a, b in zip(port["codes"], ref["codes"]):
        assert torch.equal(a, b)


def test_the_teacher_forced_reference_takes_the_given_codes(both):
    _, whole, layout, batches = both
    ctx = _ctx()
    W = gan.gan_weights(layout, CFG, ctx.seed, "cpu")
    tb = [_tensors(b) for b in batches]
    draws = [gan.make_draws(ctx.seed, i, b, CFG, "cpu") for i, b in enumerate(tb)]
    moved = [(c + 1) % CFG["g"]["vqpe"]["vq_bins"] for c in whole["codes"]]
    forced = RG.train_gan(W, CFG, tb, draws, 200, R.Precision("fp32"), None, moved)
    for a, b in zip(forced["codes"], moved):
        assert torch.equal(a, b)
    assert RG.code_gap(whole["ze"][0], whole["embed"][0], whole["codes"][0]) == 0.0
    assert RG.code_gap(whole["ze"][0], whole["embed"][0], moved[0]) > 0.05
    # codes of fewer rows than the latents (a step over part of the batch) lie infinitely far
    assert RG.code_gap(whole["ze"][0], whole["embed"][0], whole["codes"][0][:2]) == float("inf")


# ---------------------------------------------------------------- the codebook's flag


def _codebook_step(cb, n=40, seed=0):
    from megatts2_tpu_torch.nn import Draws

    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, cb.dim, generator=gen)
    return cb(x, train=True, draws=Draws(torch.Generator().manual_seed(seed + 1)))


def test_a_fresh_codebook_kmeans_initialises_once_and_then_reads_no_device(monkeypatch):
    from megatts2_tpu_torch.quantization import vq

    calls = []
    kmeans = vq._kmeans
    monkeypatch.setattr(vq, "_kmeans", lambda *a: calls.append(1) or kmeans(*a))
    cb = vq.EuclideanCodebook(4, 8)
    _codebook_step(cb)
    assert len(calls) == 1 and float(cb.inited) == 1.0

    def no_item(self):
        raise AssertionError("a train step read the device")

    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "item", no_item)
        for s in (1, 2):
            _codebook_step(cb, seed=s)
    assert len(calls) == 1


@pytest.mark.parametrize("how", ["load_state_dict", "bridge", "in_place"])
def test_a_codebook_loaded_inited_does_not_reinitialise(monkeypatch, how):
    from megatts2_tpu_torch.quantization import vq

    calls = []
    kmeans = vq._kmeans
    monkeypatch.setattr(vq, "_kmeans", lambda *a: calls.append(1) or kmeans(*a))
    from megatts2_tpu_torch.config import VQPEConfig
    from megatts2_tpu_torch.models import VQProsodyEncoder

    small = VQPEConfig(hidden_size=8, n_layers=1, n_stacks=1, n_blocks=1, vq_bins=8, vq_dim=4)
    fresh, done = VQProsodyEncoder(small), VQProsodyEncoder(small)
    cb, trained = (m.vq.layers[0]._codebook for m in (fresh, done))
    assert not cb.is_inited()  # read once while empty
    _codebook_step(trained)
    calls.clear()
    if how == "load_state_dict":
        cb.load_state_dict(trained.state_dict())
    elif how == "bridge":  # a checkpoint restore writes each buffer in place
        from megatts2_tpu_torch.bridge import export_flax_params, load_flax_params

        load_flax_params(fresh, export_flax_params(done))
    else:  # as a broadcast from rank 0 writes it
        with torch.no_grad():
            for name, buf in cb.named_buffers():
                buf.copy_(dict(trained.named_buffers())[name])
    _codebook_step(cb)
    assert calls == []
    # and back: a codebook emptied again initialises on its next step
    with torch.no_grad():
        cb.inited.zero_()
    _codebook_step(cb)
    assert calls == [1]


def test_the_reference_loads_nothing_of_the_port():
    names = set()
    for f in ("reference_gan.py", "yardstick_gan.py"):
        tree = ast.parse((ROOT / "benchmark" / f).read_text())
        names |= {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                  for a in n.names}
        names |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module and not n.level}
        rel = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level}
        assert rel <= {"reference"}, rel
    assert names <= {"__future__", "typing", "torch", "numpy"}, names


def test_the_batches_follow_the_seed_and_keep_their_sizes():
    a, b, c = (gan.make_batches(s, TRAFFIC) for s in (5, 5, 2**40 + 3))
    for x, y in zip(a, b):
        assert all(np.array_equal(x[k], y[k]) for k in x)
    assert any(not np.array_equal(x["mel_targets"], y["mel_targets"]) for x, y in zip(a, c))
    sizes = lambda p: sorted(tuple(x["mel_target_lens"].tolist()) for x in p)  # noqa: E731
    assert sizes(a) == sizes(c)
    for x in a:
        assert (x["duration_tokens"].sum(1) == x["mel_target_lens"]).all()
        assert ((x["duration_tokens"] > 0).sum(1) == x["tokens_lens"]).all()
        assert x["mel_targets"].dtype == np.float16 and x["mel_timbres"].dtype == np.float16
