"""The port's weight-only quantization held against the JAX package on the
CPU: ``quantize_kernel`` values and scales bit-equal for int8 and int4, the
unpacked and dequantized kernels equal, the quantized dense equal to JAX's
``_dense`` to fp32 rounding, and the int8 / int4 PLM and ADM decodes loaded
through the bridge from ``quantize_tree`` trees giving the JAX codes and
durations exactly.  Logits are held to 1e-5 of the largest one: fp32 sums
in another order, and the scale applied after the product in the port
against before it in the dequantized reference."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from megatts2_tpu_torch import config as tcfg
from megatts2_tpu_torch.bridge import load_flax_params
from megatts2_tpu_torch.quantization import weight_only as twq

KEY = jax.random.PRNGKey(0)


def _perturbed(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + np.float32(0.1) * np.asarray(rng.randn(*np.shape(x)), np.float32),
        tree,
    )


def _torch_cfg(jax_cfg):
    return getattr(tcfg, type(jax_cfg).__name__)(
        **{f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(jax_cfg)}
    )


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(16, 8), (3, 24, 5)])
def test_quantize_kernel_is_bit_equal_to_jax(bits, shape):
    from megatts2_tpu.quantization.weight_only import quantize_kernel as jq

    w = np.random.RandomState(sum(shape) + bits).randn(*shape).astype(np.float32)
    w[..., 0, 0] = 0.0
    w[..., 1, :] *= 5.0  # the largest row sets the scales
    jk, js = (np.asarray(a) for a in jq(jnp.asarray(w), bits))
    tk, ts = twq.quantize_kernel(torch.from_numpy(w), bits)
    assert tk.numpy().dtype == jk.dtype and tk.shape == jk.shape
    np.testing.assert_array_equal(tk.numpy(), jk)
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), js.view(np.uint32))


@pytest.mark.parametrize("bits", [8, 4])
def test_unpack_and_dequantize_match_jax(bits):
    from megatts2_tpu.quantization.weight_only import dequantize_tree, quantize_kernel, unpack_int4

    w = np.random.RandomState(3).randn(2, 12, 6).astype(np.float32)
    q, s = quantize_kernel(jnp.asarray(w), bits)
    back = dequantize_tree({"d": {"kernel_q": q, "scale": s}})["d"]["kernel"]
    got = twq.dequantize(torch.from_numpy(np.array(q)), torch.from_numpy(np.array(s)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(back))
    if bits == 4:
        lo, hi = twq.unpack_int4(torch.from_numpy(np.array(q)))
        jlo, jhi = unpack_int4(q, jnp.float32)
        np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
        assert lo.abs().max() <= 7 and hi.abs().max() <= 7


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_linear_matches_jax_dense(bits):
    """QuantLinear.from_linear on a Linear whose weight is the flax kernel
    transposed gives JAX ``_dense(x, kernel_q, scale, bias)`` to fp32 rounding."""
    from megatts2_tpu.models.fast_decode import _dense
    from megatts2_tpu.quantization.weight_only import quantize_kernel

    rng = np.random.RandomState(4)
    k, b = rng.randn(32, 10).astype(np.float32), rng.randn(10).astype(np.float32)
    x = rng.randn(3, 32).astype(np.float32)
    q, s = quantize_kernel(jnp.asarray(k), bits)
    ref = np.asarray(_dense(jnp.asarray(x), q, jnp.float32, s, jnp.asarray(b)))
    lin = torch.nn.Linear(32, 10)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(k.T))
        lin.bias.copy_(torch.from_numpy(b))
    ql = twq.QuantLinear.from_linear(lin, bits)
    assert ql.is_int4 == (bits == 4) and ql.scale.dtype == ql.bias.dtype == torch.float32
    got = ql(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_quantize_swaps_every_linear_and_keeps_odd_dims_int8():
    from megatts2_tpu_torch.models import MegaADM

    adm = MegaADM(tcfg.MegaADMConfig(n_layers=2, n_heads=2, emb_dim=8, tc_latent_dim=16,
                                     tc_emb_dim=8))
    n_linear = sum(isinstance(m, torch.nn.Linear) for m in adm.modules())
    twq.quantize_(adm, 4)
    assert not any(isinstance(m, torch.nn.Linear) for m in adm.modules())
    assert sum(isinstance(m, twq.QuantLinear) for m in adm.modules()) == n_linear
    assert adm.dt_linear_emb.weight_q.dtype == torch.int8  # K = 1 cannot pack
    assert adm.tc_linear_emb.is_int4 and twq.is_int4(adm)
    twq.cast_float_(adm, torch.bfloat16)
    assert adm.adm.layers[0].norm1.weight.dtype == torch.bfloat16
    assert adm.pe.dtype == torch.bfloat16
    ql = adm.adm.layers[0].attn.qkv
    assert ql.scale.dtype == ql.bias.dtype == torch.float32


def _jax_plm(seed=7):
    from megatts2_tpu import config as jcfg
    from megatts2_tpu.models import MegaPLM as JPLM

    jc = jcfg.MegaPLMConfig(n_layers=2, n_heads=2, vq_dim=8, tc_latent_dim=16, vq_bins=32,
                            dropout=0.0)
    params = _perturbed(JPLM(jc).init(KEY, jnp.zeros((1, 4, 16)), jnp.zeros((1, 5), jnp.int32),
                                      jnp.asarray([4]))["params"], seed)
    return jc, params


def _quantized_port(module, tree, bits):
    return load_flax_params(twq.quantize_(module, bits), tree)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_plm_decode_matches_jax(bits):
    """Codes == JAX plm_infer(quant=True) on the quantize_tree tree; per-step
    logits == the JAX float PLM on the dequantized tree, teacher-forced."""
    from megatts2_tpu.models import MegaPLM as JPLM
    from megatts2_tpu.models import plm_infer as jplm_infer
    from megatts2_tpu.quantization.weight_only import dequantize_tree, quantize_tree
    from megatts2_tpu_torch.models import MegaPLM, plm_infer
    from megatts2_tpu_torch.models.fast_decode import plm_decode_step

    jc, params = _jax_plm()
    qp = _np(quantize_tree(params, bits))
    B, T = 3, 10
    tc = np.random.RandomState(8).randn(B, T, 16).astype(np.float32)
    ref = np.asarray(jplm_infer(qp, jc, jnp.asarray(tc), dtype=jnp.float32, quant=True))

    model = _quantized_port(MegaPLM(_torch_cfg(jc)), qp, bits)
    assert twq.is_int4(model) == (bits == 4)
    codes = plm_infer(model, torch.from_numpy(tc), quant=True).numpy()
    np.testing.assert_array_equal(codes, ref)
    assert len(np.unique(codes)) > 2

    bos = np.full((B, 1), jc.bos_id, np.int32)
    ref_logits, _ = JPLM(jc).apply({"params": dequantize_tree(qp)}, jnp.asarray(tc),
                                   jnp.asarray(np.concatenate([bos, codes], axis=1)),
                                   jnp.full((B,), T, jnp.int32))
    ref_logits = np.asarray(ref_logits)
    with torch.inference_mode():
        caches = model.plm.new_cache(B, T, torch.from_numpy(tc))
        prev = torch.full((B,), jc.bos_id)
        logits = []
        for t in range(T):
            logits.append(plm_decode_step(model, torch.from_numpy(tc[:, t]), prev, caches, t))
            prev = torch.from_numpy(codes[:, t])
    got = torch.stack(logits, 1).numpy()
    np.testing.assert_allclose(got, ref_logits, rtol=0, atol=1e-5 * np.abs(ref_logits).max())


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_adm_decode_matches_jax(bits):
    from megatts2_tpu import config as jcfg
    from megatts2_tpu.models import MegaADM as JADM
    from megatts2_tpu.models import adm_infer as jadm_infer
    from megatts2_tpu.quantization.weight_only import quantize_tree
    from megatts2_tpu_torch.models import MegaADM, adm_infer

    jc = jcfg.MegaADMConfig(n_layers=2, n_heads=2, emb_dim=8, tc_latent_dim=16, tc_emb_dim=8,
                            dropout=0.0)
    params = _perturbed(JADM(jc).init(KEY, jnp.zeros((1, 4, 16)), jnp.zeros((1, 5, 1)),
                                      jnp.asarray([4]))["params"], 5)
    params["predict_layer"]["kernel"] = params["predict_layer"]["kernel"] * 10.0
    params["dt_linear_emb"]["kernel"] = params["dt_linear_emb"]["kernel"] * 0.02
    qp = _np(quantize_tree(params, bits))
    assert qp["dt_linear_emb"]["kernel_q"].dtype == np.int8  # odd K stays int8 at 4 bits
    tc = np.random.RandomState(6).randn(3, 12, 16).astype(np.float32)
    ref = np.asarray(jadm_infer(qp, jc, jnp.asarray(tc), dtype=jnp.float32, quant=True))
    model = _quantized_port(MegaADM(_torch_cfg(jc)), qp, bits)
    dur = adm_infer(model, torch.from_numpy(tc)).numpy()
    assert len(np.unique(dur)) > 3, dur
    np.testing.assert_array_equal(dur, ref)


def test_bridge_merges_quantized_qkv_and_refuses_float_leaves():
    from megatts2_tpu.quantization.weight_only import quantize_tree
    from megatts2_tpu_torch.models import MegaPLM

    jc, params = _jax_plm()
    qp = _np(quantize_tree(params, 8))
    m = _quantized_port(MegaPLM(_torch_cfg(jc)), qp, 8)
    att = qp["plm"]["layers"]["attn"]
    want = np.concatenate([att[n]["kernel_q"][1] for n in ("w_q", "w_k", "w_v")], axis=1).T
    np.testing.assert_array_equal(m.plm.layers[1].attn.qkv.weight_q.numpy(), want)
    np.testing.assert_array_equal(
        m.plm.layers[1].attn.qkv.scale.numpy(),
        np.concatenate([att[n]["scale"][1] for n in ("w_q", "w_k", "w_v")]))
    with pytest.raises(KeyError, match="kernel"):  # a float tree into a quantized model
        load_flax_params(twq.quantize_(MegaPLM(_torch_cfg(jc)), 8), _np(params))


def test_plm_infer_quant_flag_must_match_the_model():
    from megatts2_tpu_torch.models import MegaPLM, plm_infer

    m = MegaPLM(tcfg.MegaPLMConfig(n_layers=1, n_heads=2, vq_dim=8, tc_latent_dim=8, vq_bins=16))
    tc = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="float"):
        plm_infer(m, tc, quant=True)
    twq.quantize_(m, 8)
    with pytest.raises(ValueError, match="quantized"):
        plm_infer(m, tc)
