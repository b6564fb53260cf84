"""The port's data and tensor parallelism (``megatts2_tpu_torch/parallel/``)
on the CPU: two ranks over gloo, spawned once for the module
(``tests/parallel_workers.py``, which holds the ranks' checks), at tiny
widths (2 layers, d_model 64, 4 heads, fp32, one torch thread a rank).

Mirrors ``tests/test_sharding.py``: the mesh and the batch split with its
replicate fallback; the tensor-parallel rules (the fused qkv split by head,
the ADM's one-output head whole); a tensor-parallel forward equal to the
unsharded one; the PLM step at (2, 1) and at (1, 2) and the ADM step at
(2, 1), each held directly against JAX's UNSHARDED step on the same global
batch and weights (the PLM's dropout masks recorded in JAX and replayed,
each rank taking its rows, and under tensor parallelism its FF columns);
the GAN step at (2, 1) with its kmeans init, VQ EMA and BatchNorm
statistics, and at (1, 2) (the MRTE's attention and conv FF split),
against the port's one-process step (which
``tests/test_torch_gan.py`` holds against JAX); ZeRO-1 against plain AdamW;
a checkpoint written at (2, 1) with ZeRO restored at (1, 1); and
``synthesize_batch(mesh=)`` against one process.  Every train step's
gradients, after the reduction over the data ranks, are also held against
the port's one-process step's: AdamW's update cannot tell a summed
gradient from an averaged one (it is invariant to the gradient's scale),
nor any gradient at the first update (lr 0 in warmup).  A batch that does
not split over the data ranks is refused in training, and the sampler
pads every remainder to the data axis.

Tolerances (fp32): metrics rtol 1e-5 and parameters atol 1e-6 against JAX
and gradients rtol 1e-4 with atol 1e-6 of the module's largest gradient
(the sums of the all-reduce and of one process differ in order only, ~1e-7
relative); the key projection's bias, whose true gradient is 0, 2.1 lr a
step (``tests/test_torch_train.py``); the GAN and the tensor-parallel
forward atol 1e-5 (the discriminator's BatchNorm statistics sum in another
order); ZeRO against plain AdamW exactly.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

import parallel_workers as pw
from megatts2_tpu_torch.models import MegaADM, MegaPLM
from megatts2_tpu_torch.parallel import tp_plan

KEY = jax.random.PRNGKey(0)
N_STEPS = 2


def _jax_cfg(cfg):
    from megatts2_tpu import config as jc

    return getattr(jc, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _jax_lm_run(create, make_step, cfg, batch) -> dict:
    """JAX's unsharded LM step, jitted: initial params, metrics of each of
    N_STEPS steps, params after them, and the keep mask of every
    ``nn.Dropout`` that drops, in order (an ``nn.intercept_methods`` probe,
    as ``test_torch_vq.record_jax_draws``, handing each mask over through
    an ordered debug callback, so that the step stays jitted)."""
    import flax.linen as fnn
    import jax.numpy as jnp

    from megatts2_tpu.config import TrainConfig

    masks = []

    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if not (isinstance(mod, fnn.Dropout) and context.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        x = args[0]
        if kwargs.get("deterministic", mod.deterministic) or mod.rate == 0.0:
            return next_fun(*args, **kwargs)
        keep = next_fun(jnp.ones(x.shape, x.dtype), *args[1:], **kwargs) != 0
        jax.debug.callback(lambda k: masks.append(np.asarray(k)), keep, ordered=True)
        return jax.lax.select(keep, x / (1.0 - mod.rate), jnp.zeros_like(x))

    jtc = TrainConfig(max_steps=100, warmup_steps=1,
                      initial_learning_rate=pw.TRAIN.initial_learning_rate, train_dtype="float32")
    state, tx = create(KEY, _jax_cfg(cfg), jtc, batch)
    params0 = jax.tree_util.tree_map(np.asarray, state.params)
    step = jax.jit(make_step(_jax_cfg(cfg), jtc, tx)[0])
    metrics = []
    with fnn.intercept_methods(intercept):
        for _ in range(N_STEPS):
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
    jax.effects_barrier()
    return {"params0": params0, "params": jax.tree_util.tree_map(np.asarray, state.params),
            "metrics": metrics, "masks": masks, "batch": batch, "n_steps": N_STEPS}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from megatts2_tpu.training import create_adm_state, create_plm_state
    from megatts2_tpu.training import make_adm_train_step, make_plm_train_step

    tmp = str(tmp_path_factory.mktemp("ranks"))
    plm = _jax_lm_run(create_plm_state, make_plm_train_step, pw.PLM, pw.plm_batch())
    assert len(plm["masks"]) == 2 * pw.PLM.n_layers * N_STEPS  # attention out and FF, a layer
    adm = _jax_lm_run(create_adm_state, make_adm_train_step, pw.ADM, pw.adm_batch())
    symbols = os.path.join(tmp, "symbols")
    with open(symbols, "w") as f:
        for i, s in enumerate(["<eps>", "_", "-", "hello", "world"]):
            f.write(f"{s} {i}\n")
    checks = [("mesh_and_shard_batch", {}),
              ("plm_step_vs_jax", {"ref": plm, "n_model": 1}),
              ("adm_step_vs_jax", {"ref": adm}),
              ("zero_equals_plain", {"ref": plm, "tmp": tmp}),
              ("gan_step", {}),
              ("synthesize_batch_dp", {"symbols": symbols}),
              ("tp_forward_equals_whole", {}),
              ("plm_step_vs_jax:tp", {"ref": plm, "n_model": 2}),
              ("gan_step:tp", {"n_model": 2})]
    return pw.run(2, checks, tmp)


def _ok(results, name):
    assert results[name] is None, results[name]


def test_mesh_shapes_and_shard_batch(results):
    _ok(results, "mesh_and_shard_batch")


def test_plm_step_at_2x1_matches_jax_unsharded(results):
    _ok(results, "plm_step_vs_jax")


def test_plm_step_at_1x2_matches_jax_unsharded(results):
    _ok(results, "plm_step_vs_jax:tp")


def test_adm_step_at_2x1_matches_jax_unsharded(results):
    _ok(results, "adm_step_vs_jax")


def test_zero_matches_adamw_and_its_checkpoint_restores_unsharded(results):
    _ok(results, "zero_equals_plain")


def test_gan_step_at_2x1_matches_one_process(results):
    _ok(results, "gan_step")


def test_gan_step_at_1x2_matches_one_process(results):
    _ok(results, "gan_step:tp")


def test_synthesize_batch_sharded_matches_one_process(results):
    _ok(results, "synthesize_batch_dp")


def test_tp_forward_and_gradients_match_unsharded(results):
    _ok(results, "tp_forward_equals_whole")


def test_tp_rules_split_qkv_by_head_and_keep_indivisible_heads_whole():
    """JAX's ``_spec_for`` by name: q/k/v (the fused qkv in three parts, so
    a rank takes its heads of each), FF1 and the code head column parallel,
    out_proj and FF2 row parallel; the ADM's one-output head and an
    attention whose heads do not divide stay whole; nothing splits at 1."""
    plan = tp_plan(MegaPLM(pw.PLM), 2)
    for i in range(pw.PLM.n_layers):
        assert plan[f"plm.layers.{i}.attn.qkv"] == ("column", 3, False)
        assert plan[f"plm.layers.{i}.attn.out_proj"] == ("row", 1, False)
        assert plan[f"plm.layers.{i}.ff_linear1"] == ("column", 1, False)
        assert plan[f"plm.layers.{i}.ff_linear2"] == ("row", 1, False)
    assert plan["predict_layer"] == ("column", 1, True)
    assert not any(k.startswith("pc_embedding") or "norm" in k for k in plan)
    adm = tp_plan(MegaADM(pw.ADM), 2)
    assert "predict_layer" not in adm and "dt_linear_emb" not in adm
    assert adm["adm.layers.0.attn.qkv"] == ("column", 3, False)
    assert not any("attn" in k for k in tp_plan(MegaPLM(pw.PLM), 8))  # 4 heads over 8
    assert tp_plan(MegaPLM(pw.PLM), 1) == {}


def test_shard_spec_takes_each_ranks_heads_of_q_k_and_v():
    from megatts2_tpu_torch.parallel.layers import ShardSpec

    D, n = 8, 2
    full = torch.arange(3 * D * 3).reshape(3 * D, 3)  # rows: q 0-7, k 8-15, v 16-23
    for r in range(n):
        spec = ShardSpec(0, r, n, None, parts=3)
        local = spec.local(full)
        rows = [b * D + r * D // n + i for b in range(3) for i in range(D // n)]
        assert torch.equal(local, full[rows])
    with pytest.raises(RuntimeError):
        ShardSpec(0, 0, 2, None, parts=3).local(torch.zeros(3 * D + 1, 3))


def test_sampler_pads_a_lone_remainder_to_the_data_axis():
    """Under ``batch_divisor`` 2, a bucket whose only batch has an odd count
    (a small split) is padded to an even one, cycling through a bucket
    shorter than the pad, so that every batch splits over the data ranks;
    at divisor 1 the plan is as before."""
    from megatts2_tpu_torch.data import CutManifest, DurationBucketSampler
    from megatts2_tpu_torch.data.manifest import Cut

    cuts = [Cut(id=f"c{i}", speaker="s", duration=1.0 + i, num_frames=1) for i in range(3)]
    for divisor, n, want in ((2, 3, 4), (4, 1, 4), (1, 3, 3)):
        s = DurationBucketSampler(CutManifest(cuts[:n]), max_duration_batch=None, max_cuts=8,
                                  num_buckets=1, batch_divisor=divisor)
        plan = list(s)
        assert [len(b) for b in plan] == [want], (divisor, plan)
        assert set(plan[0]) == set(range(n))
