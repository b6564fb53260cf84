"""The port's EMA codebook (``megatts2_tpu_torch/quantization/vq.py``) held
against ``megatts2_tpu/quantization/vq.py`` on the CPU, fp32 on both sides.

JAX draws the kmeans seeds and the expiry replacements from PRNG keys that
torch cannot reproduce, so the JAX side runs under ``jax.disable_jit()``
with ``_sample_vectors`` wrapped to record the row indices it draws
(:func:`record_jax_draws`, which also records the dropout masks of the
larger tests), and the port replays them through a ``Draws``.

Tolerances: codes equal; ``inited``, ``cluster_size``, ``embed`` and
``embed_avg`` within 1e-5 relative (fp32 sums of the EMA in another order);
the straight-through gradient within 1e-6.
"""
import contextlib

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from megatts2_tpu_torch.bridge import load_flax_params
from megatts2_tpu_torch.nn import Draws
from megatts2_tpu_torch.quantization import vq as tvq

KEY = jax.random.PRNGKey(0)


@contextlib.contextmanager
def record_jax_draws(monkeypatch):
    """Record what JAX draws, in order: the keep mask of every ``nn.Dropout``
    that drops (under ``nn.intercept_methods``; the probe call consumes the
    module's one PRNG draw, and a debug callback hands the mask over) and
    the row indices of every
    ``quantization.vq._sample_vectors``.  Yields {"masks": [...],
    "indices": [...]} of numpy arrays; run the JAX code under
    ``jax.disable_jit()`` so that they are concrete."""
    from megatts2_tpu.quantization import vq as jvq

    rec = {"masks": [], "indices": []}

    def sample_vectors(rng, samples, num):
        n = samples.shape[0]
        idx = (jax.random.permutation(rng, n)[:num] if n >= num
               else jax.random.randint(rng, (num,), 0, n))
        rec["indices"].append(np.asarray(idx))
        return samples[idx]

    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if not (isinstance(mod, fnn.Dropout) and context.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        x = args[0]
        if kwargs.get("deterministic", mod.deterministic) or mod.rate == 0.0:
            return next_fun(*args, **kwargs)
        keep = next_fun(jnp.ones(x.shape, x.dtype), *args[1:], **kwargs) != 0
        # inside nn.scan (the transformer's layers) the body is traced even
        # without jit: the callback hands over the concrete mask as it runs
        jax.debug.callback(lambda k: rec["masks"].append(np.asarray(k)), keep)
        return jax.lax.select(keep, x / (1.0 - mod.rate), jnp.zeros_like(x))

    monkeypatch.setattr(jvq, "_sample_vectors", sample_vectors)
    with fnn.intercept_methods(intercept), jax.disable_jit():
        yield rec


def _stats_close(cb: tvq.EuclideanCodebook, stats: dict) -> None:
    for name in ("inited", "cluster_size", "embed", "embed_avg"):
        want = np.asarray(stats[name])
        np.testing.assert_allclose(getattr(cb, name).numpy(), want, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(want).max(), 1e-30), err_msg=name)


# (samples a batch, codebook size): a permutation draws the seeds when
# samples >= codes, randint with replacement otherwise
BRANCHES = {"permutation": (40, 16), "randint": (12, 32)}


@pytest.mark.parametrize("fixed_expiry", [True, False])
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_codebook_train_steps_match_jax(branch, fixed_expiry, monkeypatch):
    """The kmeans init on the first batch, then EMA steps with dead-code
    expiry: codes and statistics after one and after three steps."""
    from megatts2_tpu.quantization.vq import EuclideanCodebook

    n, K = BRANCHES[branch]
    dim = 8
    rng = np.random.RandomState(1)
    xs = [rng.randn(2, n // 2, dim).astype(np.float32) for _ in range(3)]
    jcb = EuclideanCodebook(dim, K, fixed_expiry=fixed_expiry)
    stats = jcb.init({"params": KEY, "vq": KEY}, jnp.asarray(xs[0]))["vq_stats"]
    cb = load_flax_params(tvq.EuclideanCodebook(dim, K, fixed_expiry=fixed_expiry),
                          jax.tree_util.tree_map(np.asarray, stats))
    assert float(cb.inited) == 0.0
    for i, x in enumerate(xs):
        with record_jax_draws(monkeypatch) as rec:
            (jq, jcodes), mut = jcb.apply({"vq_stats": stats}, jnp.asarray(x), train=True,
                                          rngs={"vq": jax.random.fold_in(KEY, i)},
                                          mutable=["vq_stats"])
        stats = mut["vq_stats"]
        assert len(rec["indices"]) == (2 if i == 0 else 1)  # kmeans seeds, then expiry
        draws = Draws(replay=rec)
        q, codes = cb(torch.from_numpy(x), train=True, draws=draws)
        assert draws.calls["indices"] == len(rec["indices"])
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
        np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-5, atol=1e-6)
        if i in (0, 2):
            _stats_close(cb, stats)


def test_rvq_encode_decode_and_eval_match_jax():
    """Two residual codebooks with random statistics: ``encode``, ``decode``
    and the eval forward (zero commitment loss)."""
    from megatts2_tpu.quantization.vq import ResidualVectorQuantizer

    rng = np.random.RandomState(2)
    x = rng.randn(3, 11, 8).astype(np.float32)
    jrvq = ResidualVectorQuantizer(dimension=8, n_q=2, bins=16)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(rng.randn(*np.shape(a)), np.float32),
        jrvq.init({"params": KEY, "vq": KEY}, jnp.asarray(x))["vq_stats"])
    rvq = load_flax_params(tvq.ResidualVectorQuantizer(8, n_q=2, bins=16), stats)
    codes = jrvq.apply({"vq_stats": stats}, jnp.asarray(x), method=lambda m, v: m.encode(v))
    got = rvq.encode(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(codes))
    np.testing.assert_allclose(rvq.decode(got).numpy(), np.asarray(jrvq.apply(
        {"vq_stats": stats}, codes, method=lambda m, c: m.decode(c))), rtol=0, atol=1e-6)
    jq, jc, jl = jrvq.apply({"vq_stats": stats}, jnp.asarray(x))
    q, c, loss = rvq(torch.from_numpy(x))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=0, atol=1e-6)
    assert float(loss) == float(jl) == 0.0


def test_straight_through_gradient_and_commit_loss_match_jax(monkeypatch):
    """Train mode: quantized = x + sg(q - x) passes the gradient to x
    unchanged, and the commitment loss mean((sg(q) - x)^2) adds its own."""
    from megatts2_tpu.quantization.vq import VectorQuantization

    rng = np.random.RandomState(3)
    x = rng.randn(2, 9, 8).astype(np.float32)
    w = rng.randn(2, 9, 8).astype(np.float32)
    jvq_mod = VectorQuantization(dim=8, codebook_size=8)
    stats = jvq_mod.init({"params": KEY, "vq": KEY}, jnp.asarray(x))["vq_stats"]

    def loss(xx):
        (q, _, commit), _ = jvq_mod.apply({"vq_stats": stats}, xx, train=True,
                                          rngs={"vq": KEY}, mutable=["vq_stats"])
        return jnp.sum(q * w) + commit, commit

    with record_jax_draws(monkeypatch) as rec:
        (jl, jcommit), jgrad = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(x))
    vqm = load_flax_params(tvq.VectorQuantization(8, 8), jax.tree_util.tree_map(np.asarray, stats))
    xt = torch.from_numpy(x).requires_grad_()
    q, _, commit = vqm(xt, train=True, draws=Draws(replay=rec))
    total = (q * torch.from_numpy(w)).sum() + commit
    total.backward()
    np.testing.assert_allclose(commit.item(), float(jcommit), rtol=1e-6)
    np.testing.assert_allclose(total.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), rtol=0, atol=1e-6)


def test_draws_replay_records_and_runs_dry():
    """A recorded run replays exactly; a replay asked for more than it holds raises."""
    gen = torch.Generator().manual_seed(0)
    rec = Draws(generator=gen, host_generator=torch.Generator().manual_seed(1), record=True)
    masks = [rec.keep_mask((2, 3), 0.5, "cpu") for _ in range(2)]
    idx = rec.indices(5, 3, "cpu"), rec.indices(2, 4, "cpu")
    starts = rec.starts([0, 7])
    assert len(set(idx[0].tolist())) == 3 and starts[0] == 0 and 0 <= starts[1] <= 7
    rep = Draws(replay=rec.recorded)
    assert all(torch.equal(m, rep.keep_mask((2, 3), 0.5, "cpu")) for m in masks)
    assert all(torch.equal(i, rep.indices(0, 0, "cpu")) for i in idx)
    assert rep.starts([0, 7]) == starts
    with pytest.raises(IndexError, match="masks"):
        rep.keep_mask((1,), 0.5, "cpu")
