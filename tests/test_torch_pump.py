"""Kernel D's plain version and the port's bandwidth tool held against the
JAX package's ``tools/bw_ceiling.py`` on the CPU.  The plain pump equals the
Pallas ``_pump_kernel_factory`` run in interpret mode (the tool is imported
by path with its shape constants set small; the file is not changed);
``read_reduce`` and ``dots`` equal that tool's formulas written in numpy
(they are closures there).  The pump's outputs are integers: exact.
``read_reduce`` is fp32 arithmetic in the same order: exact.  ``dots``
rounds to bf16 between layers, where sums in another order may round
differently: rtol 1e-2 on its final sum."""
import importlib.util
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import ml_dtypes
import torch

from megatts2_tpu_torch.config import MegaPLMConfig
from megatts2_tpu_torch.ops import pump as tpump
from megatts2_tpu_torch.tools import bw_ceiling as tbw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = (3, 16, 256)  # n_chunks, ch, cols


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_bw_ceiling",
                                                  os.path.join(ROOT, "tools", "bw_ceiling.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _w(shape=SMALL, seed=0):
    return np.random.RandomState(seed).randint(-127, 127, shape).astype(np.int8)


@pytest.mark.parametrize("steps", [1, 2])
def test_plain_pump_matches_the_pallas_kernel(jax_tool, monkeypatch, steps):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    for name, v in zip(("N_CHUNKS", "CH", "W_COLS"), SMALL):
        monkeypatch.setattr(jax_tool, name, v)
    w = _w()
    ref = pl.pallas_call(
        jax_tool._pump_kernel_factory(steps),
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
        interpret=True,
    )(jnp.asarray(w))
    head, total = tpump.pump_plain(torch.from_numpy(w), steps)
    assert head.shape == (1, 1) and head.dtype == torch.float32
    np.testing.assert_array_equal(head.numpy(), np.asarray(ref))
    assert int(total) == steps * int(w.astype(np.int64).sum())


def test_pump_dispatches_by_device():
    w = torch.from_numpy(_w(seed=1))
    head, total = tpump.pump(w, 3)
    want = tpump.pump_plain(w, 3)
    assert torch.equal(head, want[0]) and torch.equal(total, want[1])
    with pytest.raises(ValueError, match="CUDA"):
        tpump.pump_cuda(w, 3)  # a CPU tensor never reaches the kernel


@pytest.mark.parametrize("ch, cols, tile", [(16, 256, 4096), (256, 4096, 32768), (8, 128, 1024),
                                            (12, 4096, None), (4, 256, None)])
def test_tile_bytes(ch, cols, tile):
    if tile is None:
        with pytest.raises(ValueError, match="tile"):
            tpump.tile_bytes(ch, cols)
    else:
        assert tpump.tile_bytes(ch, cols) == tile


def _layers(d=64, ff=128, n_layers=2):
    return tbw.int8_layers(d, ff, n_layers, torch.device("cpu"), seed=3)


def test_read_reduce_matches_the_jax_formula():
    ws = _layers()
    steps = 3
    c = np.float32(0)
    for _ in range(steps):  # bw_ceiling.py:74-82
        s = np.float32(0)
        for a in ws:
            for layer in a.numpy():
                s = np.float32(s + np.float32(layer.astype(np.int32).sum(dtype=np.int32)))
        c = np.float32(c + s * np.float32(1e-9))
    got = tbw.read_reduce(*ws, steps)
    assert got.dtype == torch.float32
    assert got.item() == float(c)


def test_dots_matches_the_jax_formula():
    ws = [a.numpy() for a in _layers()]
    bf16 = ml_dtypes.bfloat16
    x0 = np.random.RandomState(4).randn(8, 64).astype(np.float32).astype(bf16)
    steps = 2
    x = x0
    for _ in range(steps):  # bw_ceiling.py:84-101, fp32 products of bf16 operands
        for l in range(ws[0].shape[0]):
            xf = x.astype(np.float32)
            h = xf @ ws[0][l].astype(np.float32)
            h1 = xf @ ws[1][l].astype(np.float32)
            f = xf @ ws[2][l].astype(np.float32)
            g = f.astype(bf16).astype(np.float32) @ ws[3][l].astype(np.float32)
            x = (h[:, :64] + h1 + g).astype(bf16)
    want = x.astype(np.float32).sum()
    got = tbw.dots(*(torch.from_numpy(a) for a in ws),
                   torch.from_numpy(x0.astype(np.float32)).bfloat16(), steps)
    np.testing.assert_allclose(got.item(), want, rtol=1e-2)


def test_decode_step_bytes_counts_weights_scales_and_the_cache_read():
    from megatts2_tpu_torch.models import MegaPLM
    from megatts2_tpu_torch.quantization.weight_only import cast_float_, quantize_

    cfg = MegaPLMConfig(n_layers=2, n_heads=2, vq_dim=16, tc_latent_dim=16, vq_bins=64)
    m = cast_float_(quantize_(MegaPLM(cfg), 8), torch.bfloat16)
    D = cfg.d_model
    weights = 2 * (3 * D * D + D * D + 4 * D * D * 2) + D * 64
    scales_biases = 4 * (2 * 2 * (3 * D + D + 4 * D + D) + 64)
    kv = 2 * 8 * 2 * D * 2 * (64 + 1) / 2  # layers * B * 2D * bf16 * mean(t + 1)
    assert tbw.decode_step_bytes(m, 8, 64) == weights + scales_biases + kv


def test_bw_ceiling_runs_every_case_on_the_cpu():
    lines = []
    recs = tbw.run(device="cpu", steps=2, d=64, ff=128, n_layers=2, ch=16, w_cols=256,
                   n_chunks=3, pump_steps=(1, 2), iters=1, B=2, T=3, emit=lines.append,
                   plm_cfg=MegaPLMConfig(n_layers=1, n_heads=2, vq_dim=16, tc_latent_dim=16,
                                         vq_bins=64))
    assert [r["case"] for r in recs] == ["read_reduce", "dots", "pump_1", "pump_2", "pump_fit",
                                         "decode"]
    assert len(lines) == 6 and all(r["device"] == "cpu" for r in recs)
    assert recs[-1]["MB_per_step"] > 0 and recs[-1]["ms_per_step"] > 0
