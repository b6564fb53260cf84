"""The ranks of the port's data- and tensor-parallel tests: no JAX, so that
the ranks ``tests/test_torch_parallel.py`` spawns start fast (a spawned
child re-imports the module that holds its function).

:func:`run` spawns ``world`` ranks over gloo on the CPU (rendezvous
through a ``FileStore`` in a temporary directory, so that test processes
running side by side never share a port), one torch thread each; each rank
runs the named checks in order and records, per check, None or its
traceback.  A check fails when it fails on any rank.  A rank that raises
stops its group (the others would wait in a collective), so the checks
after it are reported as not run.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

from megatts2_tpu_torch import config as tcfg

TRAIN = tcfg.TrainConfig(max_steps=100, warmup_steps=1, initial_learning_rate=1e-3,
                         train_dtype="float32")
PLM = tcfg.MegaPLMConfig(n_layers=2, n_heads=4, vq_dim=32, tc_latent_dim=32, vq_bins=16,
                         dropout=0.1)
ADM = tcfg.MegaADMConfig(n_layers=2, n_heads=4, emb_dim=32, tc_latent_dim=16, tc_emb_dim=32,
                         dropout=0.0)
G = tcfg.MegaGConfig(
    mrte=tcfg.MRTEConfig(mel_bins=80, mel_stride=4, mel_n_layer=1, mel_n_stack=1, mel_n_block=1,
                         content_ff_dim=32, content_n_heads=2, content_n_layers=1, hidden_size=16,
                         phone_vocab_size=40, dropout=0.1),
    vqpe=tcfg.VQPEConfig(mel_bins=20, stride=8, hidden_size=16, kernel_size=3, n_layers=1,
                         n_stacks=1, n_blocks=1, vq_bins=32, vq_dim=8),
    kernel_size=3, hidden_size=16, decoder_n_stack=1, decoder_n_block=1)
D = tcfg.DiscriminatorConfig(time_lengths=(8, 16), freq_length=80, hidden_size=8)


def plm_batch(B: int = 4, T: int = 12, lens=(12, 7, 3, 10), seed: int = 1) -> dict:
    """PLMBatchBuilder's layout at ``PLM``: BOS, codes, eos padding; fp16 latents."""
    rng = np.random.RandomState(seed)
    p_codes = np.full((B, T + 1), PLM.eos_id, np.int32)
    tc = np.zeros((B, T, PLM.tc_latent_dim), np.float16)
    for i, n in enumerate(lens):
        p_codes[i, 0] = PLM.bos_id
        p_codes[i, 1:1 + n] = rng.randint(0, PLM.vq_bins, n)
        tc[i, :n] = rng.randn(n, PLM.tc_latent_dim)
    return {"tc_latents": tc, "p_codes": p_codes, "lens": np.asarray(lens, np.int32)}


def adm_batch(B: int = 4, T: int = 9, seed: int = 3) -> dict:
    rng = np.random.RandomState(seed)
    lens = np.asarray([9, 4, 7, 1], np.int32)
    dur = np.zeros((B, T + 1, 1), np.float32)
    dur[:, 1:, 0] = rng.randint(1, 20, (B, T))
    return {"tc_latents": rng.randn(B, T, ADM.tc_latent_dim).astype(np.float16),
            "duration_tokens": dur, "lens": lens}


def gan_batch(B: int = 4) -> dict:
    rng = np.random.RandomState(0)
    return {"duration_tokens": rng.randint(1, 8, (B, 6)).astype(np.int32),
            "phone_tokens": rng.randint(1, 40, (B, 6)).astype(np.int32),
            "tokens_lens": np.asarray([6, 5, 6, 4], np.int32),
            "mel_timbres": rng.randn(B, 48, 80).astype(np.float32),
            "mel_targets": rng.randn(B, 64, 80).astype(np.float32),
            "mel_target_lens": np.asarray([64, 50, 40, 60], np.int32)}


# ------------------------------------------------------------------ spawning


def run(world: int, checks: list, tmp: str, timeout_s: int = 120) -> dict:
    """Run ``checks`` ([(name, kwargs)]: the function ``check_<name>`` of
    this module, ``name`` up to a ``:`` that tells two runs of one check
    apart) on ``world`` ranks; returns {name: None | failure text}."""
    import torch.multiprocessing as mp

    error = None
    try:
        mp.start_processes(_rank, args=(world, checks, tmp, timeout_s), nprocs=world,
                           start_method="spawn")
    except Exception as e:  # a rank raised; its checks' records say which
        error = f"{type(e).__name__}: {e}"
    out = {}
    for name, _ in checks:
        fails = []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.json")
            rec = json.load(open(path)) if os.path.exists(path) else {}
            if name not in rec:
                fails.append(f"rank {r}: not run ({error})")
            elif rec[name] is not None:
                fails.append(f"rank {r}: {rec[name]}")
        out[name] = "\n".join(fails) or None
    return out


def _rank(rank: int, world: int, checks: list, tmp: str, timeout_s: int) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    rec, path = {}, os.path.join(tmp, f"rank{rank}.json")
    try:
        for name, kwargs in checks:
            try:
                globals()[f"check_{name.split(':')[0]}"](**kwargs)
                rec[name] = None
            except BaseException:
                rec[name] = traceback.format_exc()
                raise
            finally:
                with open(path, "w") as f:
                    json.dump(rec, f)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ helpers


def _mesh(n_model: int):
    from megatts2_tpu_torch.parallel import make_mesh

    return make_mesh(n_model=n_model)


def _plm_state(params=None, cfg=PLM):
    from megatts2_tpu_torch.bridge import load_flax_params
    from megatts2_tpu_torch.training import create_plm_state

    st = create_plm_state(cfg, TRAIN, device="cpu")
    if params is not None:
        load_flax_params(st.model, params)
    return st


# parameters whose true gradient is 0 (the key projection's bias, a conv
# bias that a train-mode BatchNorm removes again): both sides hold rounding
# residue that Adam's normalisation turns into steps of up to ~lr, so they
# are held to 2.1 lr a step, as in tests/test_torch_gan.py
ZERO_GRAD = ("w_k.bias", "conv.0.bias", "conv.1.bias")


def _assert_state_close(a: torch.nn.Module, b: torch.nn.Module, atol: float, what: str,
                        n_steps: int = 0) -> None:
    """Parameters and buffers of ``a`` (each sharded one against its slice
    of ``b``'s) against those of ``b``; after ``n_steps`` updates, the
    ZERO_GRAD parameters to 2.1 lr a step."""
    from megatts2_tpu_torch.parallel import param_specs

    specs = param_specs(a)
    want = dict(b.named_parameters())
    want.update(b.named_buffers())
    got = dict(a.named_parameters())
    got.update(a.named_buffers())
    for name, t in got.items():
        zero_grad = n_steps and name.endswith(ZERO_GRAD)
        tol = 2.1 * TRAIN.initial_learning_rate * n_steps if zero_grad else atol
        w = want[name].detach()
        w = specs[name].local(w) if name in specs else w
        np.testing.assert_allclose(t.detach().numpy(), w.numpy(), rtol=0, atol=tol,
                                   err_msg=f"{what}: {name}")


def _grads(modules: dict) -> dict:
    """The gradients the last step left on each module's parameters (after
    the reduction over the data ranks), cloned: {module: {name: grad}}."""
    return {m: {n: p.grad.detach().clone() for n, p in mod.named_parameters()
                if p.grad is not None} for m, mod in modules.items()}


def _assert_grads(modules: dict, got: dict, want: dict, what: str) -> None:
    """A step's gradients on the mesh (``got``, each rank's slices of the
    sharded parameters) against the one-process step's (``want``), before
    the optimizer reads them: rtol 1e-4, atol 1e-6 of the module's largest
    gradient (fp32 sums in another order; a parameter whose true gradient
    is 0 holds rounding residue).  A data-rank reduction that averages
    where it should sum, drops a rank or a collective's backward is off by
    half a gradient or more; AdamW's update cannot tell (it is invariant to
    the gradient's scale, and the first update has lr 0)."""
    from megatts2_tpu_torch.parallel import param_specs

    for m, mod in modules.items():
        specs = param_specs(mod)
        assert set(got[m]) == set(want[m]), (what, m, sorted(set(got[m]) ^ set(want[m])))
        scale = max(g.abs().max().item() for g in want[m].values())
        for n, g in got[m].items():
            w = specs[n].local(want[m][n]) if n in specs else want[m][n]
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-6 * scale,
                                       err_msg=f"{what}: gradient of {m}.{n}")


def _assert_metrics(got: dict, want: dict, rtol: float, what: str) -> None:
    assert set(got) == set(want), (what, sorted(got), sorted(want))
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=rtol, atol=1e-7,
                                   err_msg=f"{what}: {k}")


# ------------------------------------------------------------------ checks


def check_mesh_and_shard_batch() -> None:
    """The mesh's shape and place, JAX's divisibility assert, and the batch
    split with its replicate fallback."""
    from megatts2_tpu_torch.parallel import full_batch, shard_batch

    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = _mesh(1)
    assert mesh.shape == {"data": world, "model": 1} and mesh.rank == rank
    assert (mesh.data_rank, mesh.model_rank) == (rank, 0) and mesh.model_group is None
    tp = _mesh(world)
    assert tp.shape == {"data": 1, "model": world} and tp.model_rank == rank
    assert tp.data_group is None and tp.rows is None and mesh.rows == (rank, world)
    try:
        _mesh(world + 1)
        raise AssertionError("make_mesh accepted a model axis that does not divide the world")
    except ValueError:
        pass
    batch = {"x": np.arange(4 * 3).reshape(4, 3), "odd": np.arange(3), "t": torch.arange(8)}
    sb = shard_batch(batch, mesh)
    b = 4 // world
    np.testing.assert_array_equal(sb["x"], batch["x"][rank * b:(rank + 1) * b])
    np.testing.assert_array_equal(sb["odd"], batch["odd"])  # indivisible: whole
    assert torch.equal(sb["t"], batch["t"][rank * 8 // world:(rank + 1) * 8 // world])
    assert full_batch(sb) is batch and full_batch(batch) is batch
    assert shard_batch(batch, tp) is batch  # one data row: the batch as it is
    assert shard_batch(batch, tp, replicate=False) is batch
    three = plm_batch(B=3, lens=(12, 7, 3))  # 3 rows over 2 data ranks
    for strict in (lambda: shard_batch(three, mesh, replicate=False),
                   lambda: _run_three_rows(three)):
        try:
            strict()
            raise AssertionError("a 3-row batch was replicated over the data ranks")
        except ValueError as e:
            assert "do not split" in str(e), e


def _run_three_rows(batch: dict) -> None:
    """``run_training`` at (world, 1) on a batch of 3 rows: the LM step
    would sum the replicated rows' gradients over the data ranks."""
    import tempfile

    from megatts2_tpu_torch.parallel import place_train_state
    from megatts2_tpu_torch.training import make_plm_train_step, run_training

    st = place_train_state(_plm_state(), _mesh(1))
    with tempfile.TemporaryDirectory() as d:
        run_training("plm", st, make_plm_train_step(PLM, TRAIN)[0], lambda e: [batch], 1,
                     log_dir=d)


def _plm_run(ref: dict, n_model, zero: bool = False):
    """The PLM state from JAX's initial weights placed at (world / n_model,
    n_model), or in one process for ``n_model`` None, after ``ref``'s steps
    on its global batch (JAX's masks replayed); returns (state, metrics of
    each step, gradients of each step)."""
    from megatts2_tpu_torch.nn import Draws
    from megatts2_tpu_torch.parallel import place_train_state, shard_batch
    from megatts2_tpu_torch.training import make_plm_train_step

    st = _plm_state(ref["params0"])
    st.draws = Draws(replay={"masks": list(ref["masks"])})
    if n_model is not None:
        place_train_state(st, _mesh(n_model), zero=zero)
    step = make_plm_train_step(PLM, TRAIN)[0]
    metrics, grads = [], []
    for _ in range(ref["n_steps"]):
        metrics.append(step(st, shard_batch(ref["batch"], st.mesh) if st.mesh else ref["batch"]))
        grads.append(_grads({"model": st.model}))
    return st, metrics, grads


def check_plm_step_vs_jax(ref: dict, n_model: int) -> None:
    """The PLM train step at (world / n_model, n_model) against JAX's
    unsharded step on the same global batch, weights and dropout masks:
    metrics of every step rtol 1e-5, parameters after the steps (each
    rank's slice of them) atol 1e-6, the key bias 2.1 lr a step (its true
    gradient is 0, see tests/test_torch_train.py); the gradients of every
    step against the port's one-process step (``_assert_grads``), which
    tests/test_torch_train.py holds against JAX's gradients."""
    from megatts2_tpu_torch.bridge import load_flax_params
    from megatts2_tpu_torch.models import MegaPLM

    st, metrics, grads = _plm_run(ref, n_model)
    one = _plm_run(ref, None)
    for i, (m, want) in enumerate(zip(metrics, ref["metrics"])):
        _assert_metrics(m, want, 1e-5, f"PLM step {i} at n_model {n_model}")
        _assert_grads({"model": st.model}, grads[i], one[2][i], f"PLM step {i} at n_model {n_model}")
    assert not st.draws.replay["masks"], "masks left unreplayed"
    _assert_lm_params(st.model, load_flax_params(MegaPLM(PLM), ref["params"]), PLM.d_model,
                      ref["n_steps"])


def _assert_lm_params(model, whole, D: int, n_steps: int) -> None:
    """An LM's parameters (each rank's slices) against the unsharded
    ``whole``: atol 1e-6, the key bias 2.1 lr a step (its true gradient is
    0, see tests/test_torch_train.py)."""
    from megatts2_tpu_torch.parallel import param_specs

    specs = param_specs(model)
    want = dict(whole.named_parameters())
    for name, p in model.named_parameters():
        w = want[name].detach()
        a = p.detach()
        if name.endswith("attn.qkv.bias"):  # the key bias: true gradient 0
            kb = torch.zeros(3 * D, dtype=torch.bool)
            kb[D:2 * D] = True
            if name in specs:
                kb = specs[name].local(kb)
                w = specs[name].local(w)
            np.testing.assert_allclose(a[kb].numpy(), w[kb].numpy(), rtol=0,
                                       atol=2.1 * TRAIN.initial_learning_rate * n_steps)
            a, w = a[~kb], w[~kb]
        elif name in specs:
            w = specs[name].local(w)
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=0, atol=1e-6, err_msg=name)


def check_adm_step_vs_jax(ref: dict) -> None:
    """The ADM step at (world, 1) against JAX's unsharded step: metrics
    rtol 1e-5, parameters after the steps as the PLM's; its gradients
    against the port's one-process step's (``_assert_grads``)."""
    from megatts2_tpu_torch.bridge import load_flax_params
    from megatts2_tpu_torch.models import MegaADM
    from megatts2_tpu_torch.parallel import place_train_state, shard_batch
    from megatts2_tpu_torch.training import create_adm_state, make_adm_train_step

    st, one = (create_adm_state(ADM, TRAIN, device="cpu") for _ in range(2))
    for s in (st, one):
        load_flax_params(s.model, ref["params0"])
    place_train_state(st, _mesh(1))
    step = make_adm_train_step(ADM, TRAIN)[0]
    for i, want in enumerate(ref["metrics"]):
        _assert_metrics(step(st, shard_batch(ref["batch"], st.mesh)), want, 1e-5, f"ADM step {i}")
        step(one, ref["batch"])
        _assert_grads({"model": st.model}, _grads({"model": st.model}),
                      _grads({"model": one.model}), f"ADM step {i}")
    _assert_lm_params(st.model, load_flax_params(MegaADM(ADM), ref["params"]), ADM.d_model,
                      ref["n_steps"])


def check_zero_equals_plain(ref: dict, tmp: str) -> None:
    """ZeRO-1 at (world, 1) takes the same steps as plain AdamW, each rank
    holding the moments of about 1/world of the parameters; a checkpoint
    written at (world, 1) with ZeRO restores at (1, 1) into the state of a
    one-process run of as many steps, and its next step is that run's."""
    from megatts2_tpu_torch.training import make_plm_train_step, restore_checkpoint, save_checkpoint

    plain, mp, _ = _plm_run(ref, 1, zero=False)
    zero, mz, _ = _plm_run(ref, 1, zero=True)
    for a, b in zip(mp, mz):
        _assert_metrics(a, b, 0, "ZeRO vs plain")
    _assert_state_close(zero.model, plain.model, 0, "ZeRO vs plain")
    total = sum(p.numel() for p in zero.model.parameters())
    share = sum(p.numel() for g in zero.opt.optim.param_groups for p in g["params"]) / total
    assert 0.25 < share < 0.75, f"rank holds the moments of {share:.2f} of the parameters"
    path = save_checkpoint(os.path.join(tmp, "ck_zero"), zero, zero.step)
    dist.barrier()
    one = _plm_state(ref["params0"])
    one.generator.manual_seed(123)  # the restore sets it
    restore_checkpoint(path, one)
    assert one.step == zero.step
    ref_one = _plm_state(ref["params0"])
    from megatts2_tpu_torch.nn import Draws

    ref_one.draws = Draws(replay={"masks": list(ref["masks"])})
    step = make_plm_train_step(PLM, TRAIN)[0]
    for _ in range(ref["n_steps"]):
        step(ref_one, ref["batch"])
    _assert_lm_params(one.model, ref_one.model, PLM.d_model, ref["n_steps"])
    sd_one, sd_ref = one.opt.state_dict(), ref_one.opt.state_dict()
    for k, st in sd_ref["state"].items():  # 1e-5 of each moment's largest element
        for name in ("exp_avg", "exp_avg_sq"):
            want = st[name].numpy()
            np.testing.assert_allclose(sd_one["state"][k][name].numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max(), err_msg=f"moment {k} {name}")
    ref_one.draws = None
    ref_one.generator.set_state(one.generator.get_state())
    batch = plm_batch(seed=5)
    _assert_metrics(step(one, batch), step(ref_one, batch), 1e-5, "step after the restore")


def check_tp_forward_equals_whole() -> None:
    """At (1, world): the PLM's forward (fused qkv by head, the code head
    gathered) and a TransformerEncoder (q/k/v, out_proj and the conv FF)
    equal the unsharded modules, fp32 atol 1e-5; the gradients of the
    sharded weights are the slices of the whole gradients (atol 1e-5 of the
    largest gradient)."""
    from megatts2_tpu_torch.models import MegaPLM, init_random_
    from megatts2_tpu_torch.nn import TransformerEncoder
    from megatts2_tpu_torch.parallel import param_specs, place_train_state
    from megatts2_tpu_torch.parallel.sharding import shard_module_

    mesh = _mesh(dist.get_world_size())
    st = _plm_state()
    whole = _plm_state()
    place_train_state(st, mesh)
    specs = param_specs(st.model)
    assert {n.rsplit(".", 1)[0] for n in specs} >= {"plm.layers.0.attn.qkv", "predict_layer"}
    batch = {k: torch.as_tensor(v) for k, v in plm_batch().items()}
    args = (batch["tc_latents"], batch["p_codes"].long(), batch["lens"])
    out, _ = st.model(*args)
    ref, _ = whole.model(*args)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), rtol=0, atol=1e-5)
    out.square().sum().backward()
    ref.square().sum().backward()
    grads = {n: p.grad for n, p in whole.model.named_parameters()}
    scale = max(g.abs().max().item() for g in grads.values())  # as tests/test_torch_train.py
    for n, p in st.model.named_parameters():
        w = specs[n].local(grads[n]) if n in specs else grads[n]
        np.testing.assert_allclose(p.grad.numpy(), w.numpy(), rtol=0, atol=1e-5 * scale, err_msg=n)

    enc, enc_whole = (init_random_(TransformerEncoder(16, 32, 2, n_heads=2),
                                   torch.Generator().manual_seed(0)) for _ in range(2))
    shard_module_(enc, mesh)
    # w_q, w_k, w_v, ff_conv1 (weight, bias); out_proj, ff_conv2 (weight)
    assert len(param_specs(enc)) == 2 * 10
    x = torch.randn(3, 7, 16, generator=torch.Generator().manual_seed(1))
    lens = torch.tensor([7, 5, 2])
    np.testing.assert_allclose(enc(x, lens).detach().numpy(), enc_whole(x, lens).detach().numpy(),
                               rtol=0, atol=1e-5)


def check_gan_step(n_model: int = 1, n_steps: int = 2) -> None:
    """The GAN step at (world / n_model, n_model) against the port's
    one-process step on the same global batch (same seeds, so the same
    masks, codebook rows and window starts): the first step's kmeans init,
    the VQ EMA and the BatchNorm statistics, and under tensor parallelism
    the MRTE's attention and conv FF split; metrics rtol 1e-5, the
    gradients of G and D at every step (``_assert_grads``), G and D
    (parameters and buffers, each rank's slices) atol 1e-5, ``ZERO_GRAD``
    2.1 lr a step."""
    from megatts2_tpu_torch.parallel import param_specs, place_train_state, shard_batch
    from megatts2_tpu_torch.training import create_gan_state, make_gan_train_step

    tc = dataclasses.replace(TRAIN, g_ema_decay=0.5)
    step = make_gan_train_step(G, D, tc)
    batch = gan_batch()
    one = create_gan_state(G, D, tc, device="cpu")
    par = place_train_state(create_gan_state(G, D, tc, device="cpu"), _mesh(n_model))
    assert bool(param_specs(par.g)) == (n_model > 1)
    for i in range(n_steps):
        _assert_metrics(step(par, shard_batch(batch, par.mesh)), step(one, batch), 1e-5,
                        f"GAN step {i}")
        modules = {"g": par.g, "d": par.d}
        _assert_grads(modules, _grads(modules), _grads({"g": one.g, "d": one.d}), f"GAN step {i}")
    cb = par.g.vqpe.vq.layers[0]._codebook
    assert float(cb.inited) == 1.0 and float(cb.cluster_size.sum()) > 0
    _assert_state_close(par.g, one.g, 1e-5, "G", n_steps)
    _assert_state_close(par.d, one.d, 1e-5, "D", n_steps)
    specs = param_specs(par.g)
    for name, e in one.g_ema.items():
        tol = 2.1 * TRAIN.initial_learning_rate * n_steps if name.endswith(ZERO_GRAD) else 1e-5
        e = specs[name].local(e) if name in specs else e
        np.testing.assert_allclose(par.g_ema[name].numpy(), e.numpy(), rtol=0, atol=tol,
                                   err_msg=f"g_ema {name}")


def check_synthesize_batch_dp(symbols: str) -> None:
    """``Megatts.synthesize_batch(mesh=)`` at (world, 1), each rank
    synthesising its rows after the global padding, equals the
    one-process batch: frame counts equal, waveforms atol 1e-5."""
    from megatts2_tpu_torch.models import Megatts, MegaADM, MegaG, MegaPLM, Vocos, init_random_

    gen = torch.Generator().manual_seed(0)
    g = init_random_(MegaG(G), gen)
    plm = init_random_(MegaPLM(dataclasses.replace(PLM, vq_dim=8, vq_bins=32, dropout=0.0,
                                                   tc_latent_dim=16)), gen)
    adm = init_random_(MegaADM(dataclasses.replace(ADM, tc_latent_dim=16, max_duration_token=3)),
                       gen)
    voc = init_random_(Vocos(tcfg.VocosConfig(dim=16, intermediate_dim=32, num_layers=1)), gen)
    tts = Megatts(g, plm, adm, voc, symbols, max_frames=32, dtype=torch.float32, device="cpu")
    texts = ["hello world", "world", "hello hello world", "world hello"]
    mels = np.random.RandomState(0).randn(4, 40, 80).astype(np.float32)
    ref = tts.synthesize_batch(texts, mels)
    got = tts.synthesize_batch(texts, mels, mesh=_mesh(1))
    assert [w.shape for w in got] == [w.shape for w in ref]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def check_cli_fit_meshes(cfg2: str, cfg3: str, logs: str, ck: str) -> None:
    """``cli fit`` of the PLM at (world, 1) with ``--zero_opt`` for 2 steps,
    then resumed from its checkpoint at (1, world) for a third; rank 0
    alone writes the logs and the checkpoints."""
    from megatts2_tpu_torch import cli

    rank = dist.get_rank()
    argv = ["--log_dir", logs, "--ckpt_dir", ck, "--device", "cpu"]
    st = cli.main(["fit", "-c", cfg2, *argv, "--zero_opt"])
    assert st.step == 2 and st.mesh.shape == {"data": dist.get_world_size(), "model": 1}
    st = cli.main(["fit", "-c", cfg3, *argv, "--n_model", str(dist.get_world_size())])
    assert st.step == 3 and st.mesh.n_model == dist.get_world_size()
    files = sorted(os.listdir(ck))
    assert files[-2:] == ["step_2.ckpt", "step_3.ckpt"], (rank, files)


def check_serve_batch(argv: list) -> None:
    """``serve`` in batch mode on (world, 1): every rank synthesises its
    rows, rank 0 alone writes the wavs and returns the throughput record;
    ``--continuous`` refuses a world above one rank."""
    from megatts2_tpu_torch import serve

    record = serve.main(argv)
    assert record["mesh"] == {"data": dist.get_world_size(), "model": 1}
    assert ("requests" in record) == (dist.get_rank() == 0)
    try:
        serve.main(argv + ["--continuous"])
        raise AssertionError("--continuous served on a world of several ranks")
    except SystemExit as e:
        assert "one rank" in str(e)
