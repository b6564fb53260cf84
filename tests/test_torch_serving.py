"""The port's serving options held against the JAX package on the CPU, in
fp32, at tiny widths: temperature / top-k sampling (JAX's Gumbel noise,
``jax.random.gumbel(fold_in(rng, t), ...)``, injected into the port), the
prompt prefill, the HiFi-GAN vocoder (JAX with its space-to-depth stages),
and the whole cascade with an int8 PLM, sampling, a prompt and HiFi-GAN.
Codes, durations and ``n_frames`` must be equal; HiFi-GAN agrees to atol
1e-4 (fp32 convolutions summed in another order) and the cascade's
waveform to atol 1e-3, as in ``test_torch_slice.py``."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from megatts2_tpu_torch import config as tcfg
from megatts2_tpu_torch.bridge import load_flax_params
from megatts2_tpu_torch.quantization.weight_only import quantize_

KEY = jax.random.PRNGKey(0)
MAX_FRAMES = 64
TEMPERATURE = 0.8


def _perturbed(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + np.float32(0.1) * np.asarray(rng.randn(*np.shape(x)), np.float32),
        tree,
    )


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_cfg(jax_cfg):
    kw = {}
    for f in dataclasses.fields(jax_cfg):
        v = getattr(jax_cfg, f.name)
        kw[f.name] = _torch_cfg(v) if dataclasses.is_dataclass(v) else v
    return getattr(tcfg, type(jax_cfg).__name__)(**kw)


def _gumbel(rng, T, B, V):
    """The noise JAX's categorical adds at step t, stacked (T, B, V)."""
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.gumbel(jax.random.fold_in(rng, t), (B, V))) for t in range(T)]))


def _hifi_cfg():
    from megatts2_tpu import config as jcfg

    # 64 channels plain, then 32 and 16 in JAX's space-to-depth blocks; 8*8*4 = hop 256
    return jcfg.HiFiGANConfig(upsample_initial_channel=128, upsample_rates=(8, 8, 4),
                              upsample_kernel_sizes=(16, 16, 8), resblock_kernel_sizes=(3, 5),
                              resblock_dilation_sizes=((1, 3), (1, 3)))


@pytest.fixture(scope="module")
def plm_pair():
    from megatts2_tpu import config as jcfg
    from megatts2_tpu.models import MegaPLM as JPLM
    from megatts2_tpu_torch.models import MegaPLM

    jc = jcfg.MegaPLMConfig(n_layers=2, n_heads=2, vq_dim=8, tc_latent_dim=16, vq_bins=32,
                            dropout=0.0)
    params = _perturbed(JPLM(jc).init(KEY, jnp.zeros((1, 4, 16)), jnp.zeros((1, 5), jnp.int32),
                                      jnp.asarray([4]))["params"], 11)
    return jc, params, load_flax_params(MegaPLM(_torch_cfg(jc)), params)


@pytest.mark.parametrize("top_k", [0, 1, 8])
def test_sampling_with_jax_noise_matches_jax(plm_pair, top_k):
    """Sampled codes == JAX plm_infer(temperature, top_k, rng) when the port
    is given the Gumbel noise JAX draws; top_k = 1 is greedy."""
    from megatts2_tpu.models import plm_infer as jplm_infer
    from megatts2_tpu_torch.models import plm_infer

    jc, params, model = plm_pair
    B, T = 3, 12
    tc = np.random.RandomState(12).randn(B, T, 16).astype(np.float32)
    rng = jax.random.PRNGKey(5)
    ref = np.asarray(jplm_infer(params, jc, jnp.asarray(tc), dtype=jnp.float32,
                                temperature=TEMPERATURE, top_k=top_k, rng=rng))
    got = plm_infer(model, torch.from_numpy(tc), temperature=TEMPERATURE, top_k=top_k,
                    gumbel=_gumbel(rng, T, B, jc.vq_bins)).numpy()
    np.testing.assert_array_equal(got, ref)
    greedy = plm_infer(model, torch.from_numpy(tc)).numpy()
    if top_k == 1:
        np.testing.assert_array_equal(got, greedy)
    else:
        assert (got != greedy).any()  # the noise does change the codes


def test_sampling_needs_noise_and_draws_from_the_generator(plm_pair):
    from megatts2_tpu_torch.models import plm_infer

    _, _, model = plm_pair
    tc = torch.from_numpy(np.random.RandomState(13).randn(2, 6, 16).astype(np.float32))
    with pytest.raises(ValueError, match="generator"):
        plm_infer(model, tc, temperature=1.0)
    a, b, c = (plm_infer(model, tc, temperature=1.0, top_k=8,
                         generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < model.cfg.vq_bins


@pytest.mark.parametrize("quant", [False, True])
def test_prompt_prefill_matches_jax(plm_pair, quant):
    """A P = 8 prompt: codes == JAX plm_infer(prompt_tc, prompt_codes), and
    the prefill's last-token logits == JAX ``MegaPLM.prefill``'s."""
    from megatts2_tpu.models import MegaPLM as JPLM
    from megatts2_tpu.models import plm_infer as jplm_infer
    from megatts2_tpu.quantization.weight_only import quantize_tree
    from megatts2_tpu_torch.models import MegaPLM, plm_infer

    jc, params, model = plm_pair
    if quant:
        params = _np(quantize_tree(params, 8))
        model = load_flax_params(quantize_(MegaPLM(_torch_cfg(jc)), 8), params)
    B, T, P = 2, 10, 8
    r = np.random.RandomState(14)
    tc = r.randn(B, T, 16).astype(np.float32)
    ptc = r.randn(B, P, 16).astype(np.float32)
    pcodes = r.randint(0, jc.vq_bins, (B, P)).astype(np.int32)
    ref = np.asarray(jplm_infer(params, jc, jnp.asarray(tc), dtype=jnp.float32, quant=quant,
                                prompt_tc=jnp.asarray(ptc), prompt_codes=jnp.asarray(pcodes)))
    got = plm_infer(model, torch.from_numpy(tc), quant=quant, prompt_tc=torch.from_numpy(ptc),
                    prompt_codes=torch.from_numpy(pcodes)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(got, plm_infer(model, torch.from_numpy(tc), quant=quant).numpy())

    prev = np.concatenate([np.full((B, 1), jc.bos_id, np.int32), pcodes[:, :-1]], axis=1)
    ref_logits, _ = JPLM(jc, decode=True, max_decode_len=P + T, quant=quant).apply(
        {"params": params}, jnp.asarray(ptc), jnp.asarray(prev), method=JPLM.prefill,
        mutable=["cache"])
    with torch.inference_mode():
        caches = model.plm.new_cache(B, P + T, torch.from_numpy(tc))
        logits = model.prefill(torch.from_numpy(ptc), torch.from_numpy(prev).long(), caches)
    ref_logits = np.asarray(ref_logits)
    np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=0,
                               atol=1e-5 * np.abs(ref_logits).max())
    assert caches[0][:, P:].abs().max() == 0  # only the prompt's positions are written


def test_int4_with_a_prompt_raises(plm_pair):
    from megatts2_tpu_torch.models import MegaPLM, plm_infer

    jc = plm_pair[0]
    model = quantize_(MegaPLM(_torch_cfg(jc)), 4)
    with pytest.raises(NotImplementedError, match="int4"):
        plm_infer(model, torch.zeros(1, 4, 16), quant=True, prompt_tc=torch.zeros(1, 2, 16),
                  prompt_codes=torch.zeros(1, 2, dtype=torch.long))


def test_hifigan_matches_jax():
    """The plain port against the JAX generator, whose 32- and 16-channel
    stages run as space-to-depth blocks, on its own random weights."""
    from megatts2_tpu.models import HiFiGAN as JHiFiGAN
    from megatts2_tpu_torch.models import HiFiGAN

    cfg = _hifi_cfg()
    params = _np(jax.jit(JHiFiGAN(cfg).init)(KEY, jnp.zeros((1, 4, 80)))["params"])
    params = jax.tree_util.tree_map(lambda x: x * np.float32(2.0), params)  # a louder output
    mel = np.random.RandomState(15).randn(2, 13, 80).astype(np.float32)
    ref = np.asarray(jax.jit(JHiFiGAN(cfg).apply)({"params": params}, jnp.asarray(mel)))
    model = load_flax_params(HiFiGAN(_torch_cfg(cfg)), params)
    with torch.no_grad():
        got = model(torch.from_numpy(mel)).numpy()
    assert got.shape == ref.shape == (2, 13 * 256)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def serving_pair(tmp_path_factory):
    """Tiny JAX models with perturbed weights and HiFi-GAN, the port's twins
    through the bridge (float), and a prompt directory with a symbol table."""
    from megatts2_tpu import config as jcfg
    from megatts2_tpu.models import HiFiGAN, MegaADM, MegaG, MegaPLM
    from megatts2_tpu.utils.audio import save_wav
    from megatts2_tpu_torch import models as tm

    g_cfg = jcfg.MegaGConfig(
        mrte=jcfg.MRTEConfig(mel_n_layer=1, mel_n_stack=1, mel_n_block=1, content_ff_dim=32,
                             content_n_heads=2, content_n_layers=1, hidden_size=16,
                             phone_vocab_size=40, dropout=0.0),
        vqpe=jcfg.VQPEConfig(hidden_size=16, kernel_size=3, n_layers=1, n_stacks=1, n_blocks=1,
                             vq_bins=32, vq_dim=8),
        kernel_size=3, hidden_size=16, decoder_n_stack=1, decoder_n_block=1,
    )
    plm_cfg = jcfg.MegaPLMConfig(n_layers=2, n_heads=2, vq_dim=8, tc_latent_dim=16, vq_bins=32,
                                 dropout=0.0)
    adm_cfg = jcfg.MegaADMConfig(n_layers=2, n_heads=2, emb_dim=8, tc_latent_dim=16,
                                 tc_emb_dim=8, dropout=0.0)
    hifi_cfg = _hifi_cfg()
    gv = jax.jit(MegaG(g_cfg).init)(
        {"params": KEY, "vq": KEY}, jnp.ones((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32),
        jnp.asarray([4]), jnp.zeros((1, 32, 80)), jnp.zeros((1, 16, 80)),
    )
    g_vars = {"params": _perturbed(gv["params"], 21), "vq_stats": _perturbed(gv["vq_stats"], 22)}
    plm_p = _perturbed(MegaPLM(plm_cfg).init(
        KEY, jnp.zeros((1, 4, 16)), jnp.zeros((1, 5), jnp.int32), jnp.asarray([4]))["params"], 23)
    adm_p = _perturbed(MegaADM(adm_cfg).init(
        KEY, jnp.zeros((1, 4, 16)), jnp.zeros((1, 5, 1)), jnp.asarray([4]))["params"], 24)
    adm_p["predict_layer"]["kernel"] = adm_p["predict_layer"]["kernel"] * -4.0
    adm_p["dt_linear_emb"]["kernel"] = adm_p["dt_linear_emb"]["kernel"] * 0.005
    hifi_p = _np(jax.jit(HiFiGAN(hifi_cfg).init)(KEY, jnp.zeros((1, 4, 80)))["params"])

    root = tmp_path_factory.mktemp("torch_serving")
    sym = str(root / "symbols")
    with open(sym, "w") as f:
        for i, s in enumerate(["<eps>", "_", "-", "hello", "world"]):
            f.write(f"{s} {i}\n")
    wavs = root / "wavs"
    wavs.mkdir()
    rng = np.random.RandomState(25)
    for name, n in (("a.wav", 4000), ("b.wav", 3100)):
        t = np.arange(n) / 16000.0
        save_wav(str(wavs / name), (0.3 * np.sin(2 * np.pi * 150 * t) + 0.05 * rng.randn(n))
                 .astype(np.float32))

    def port():
        return dict(
            g=load_flax_params(tm.MegaG(_torch_cfg(g_cfg)), g_vars),
            plm=load_flax_params(tm.MegaPLM(_torch_cfg(plm_cfg)), plm_p),
            adm=load_flax_params(tm.MegaADM(_torch_cfg(adm_cfg)), adm_p),
            vocoder=load_flax_params(tm.HiFiGAN(_torch_cfg(hifi_cfg)), hifi_p),
        )

    prompt = np.random.RandomState(26)
    features = (prompt.randn(1, 8, 16).astype(np.float32),
                prompt.randint(0, 32, (1, 8)).astype(np.int32))
    return dict(port=port, vars=(g_vars, plm_p, adm_p, hifi_p),
                cfgs=(g_cfg, plm_cfg, adm_cfg, hifi_cfg), sym=sym, wavs=str(wavs), root=root,
                features=features)


def test_synthesize_int8_sampling_prompt_hifigan_matches_jax(serving_pair):
    """The cascade with an int8 PLM sampled at top_k 8 after a prompt, and
    HiFi-GAN: durations, codes and n_frames equal, mel and waveform close."""
    from megatts2_tpu.models import adm_infer as jadm, plm_infer as jplm
    from megatts2_tpu.models.megag import MegaG as JMegaG
    from megatts2_tpu.models.megatts import max_pool_time as jpool
    from megatts2_tpu.models.megatts import synthesize as jsynth
    from megatts2_tpu.ops import regulate_length as jreg
    from megatts2_tpu.quantization.weight_only import quantize_tree
    from megatts2_tpu_torch.models import adm_infer, plm_infer, synthesize
    from megatts2_tpu_torch.models.megatts import max_pool_time
    from megatts2_tpu_torch.ops import regulate_length

    (g_vars, plm_p, adm_p, hifi_p), cfgs = serving_pair["vars"], serving_pair["cfgs"]
    qp = _np(quantize_tree(plm_p, 8))
    rng = np.random.RandomState(27)
    B = 2
    phone = rng.randint(1, 40, (B, 7)).astype(np.int32)
    lens = np.array([7, 5], np.int32)
    phone[1, 5:] = 0
    mels = rng.randn(B, 40, 80).astype(np.float32)
    ptc = np.repeat(serving_pair["features"][0], B, axis=0)
    pcodes = np.repeat(serving_pair["features"][1], B, axis=0)
    key = jax.random.PRNGKey(9)
    kw = dict(quant=True, plm_temperature=TEMPERATURE, plm_top_k=8)
    jargs = (jnp.asarray(phone), jnp.asarray(lens), jnp.asarray(mels))
    ref_wav, ref_mel, ref_n = jsynth(g_vars, qp, adm_p, hifi_p, *cfgs, *jargs,
                                     max_frames=MAX_FRAMES, dtype=jnp.float32, rng=key,
                                     plm_prompt_tc=jnp.asarray(ptc),
                                     plm_prompt_codes=jnp.asarray(pcodes), **kw)
    jtc = JMegaG(cfgs[0]).apply(g_vars, *jargs,
                                method=lambda m, ph, ln, mel: m.mrte.tc_latent(ph, mel, ln))
    jdt = np.asarray(jadm(adm_p, cfgs[2], jtc, dtype=jnp.float32))
    jdt = np.where(np.arange(7)[None] < lens[:, None], jdt, 0)
    jcodes = np.asarray(jplm(qp, cfgs[1], jpool(jreg(jtc, jnp.asarray(jdt), MAX_FRAMES), 8),
                             dtype=jnp.float32, quant=True, temperature=TEMPERATURE, top_k=8,
                             rng=key, prompt_tc=jnp.asarray(ptc),
                             prompt_codes=jnp.asarray(pcodes)))

    p = serving_pair["port"]()
    quantize_(p["plm"], 8)
    noise = _gumbel(key, MAX_FRAMES // 8, B, cfgs[1].vq_bins)
    targs = (torch.from_numpy(phone).long(), torch.from_numpy(lens).long(), torch.from_numpy(mels))
    tprompt = dict(plm_prompt_tc=torch.from_numpy(ptc), plm_prompt_codes=torch.from_numpy(pcodes))
    wav, mel_hat, n = synthesize(p["g"], p["plm"], p["adm"], p["vocoder"], *targs, MAX_FRAMES,
                                 plm_gumbel=noise, **kw, **tprompt)
    with torch.inference_mode():
        tc = p["g"].mrte.tc_latent(targs[0], targs[2], targs[1])
        dt = adm_infer(p["adm"], tc)
        dt = torch.where(torch.arange(7)[None] < targs[1][:, None], dt, 0)
        codes = plm_infer(p["plm"], max_pool_time(regulate_length(tc, dt, MAX_FRAMES), 8),
                          quant=True, temperature=TEMPERATURE, top_k=8, gumbel=noise,
                          prompt_tc=tprompt["plm_prompt_tc"],
                          prompt_codes=tprompt["plm_prompt_codes"])

    np.testing.assert_array_equal(dt.numpy(), jdt)
    assert len(np.unique(jdt)) > 3, jdt
    np.testing.assert_array_equal(codes.numpy(), jcodes)
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))
    assert wav.shape == ref_wav.shape == (B, MAX_FRAMES * 256)
    np.testing.assert_allclose(mel_hat.numpy(), np.asarray(ref_mel), atol=1e-3)
    np.testing.assert_allclose(wav.numpy(), np.asarray(ref_wav), atol=1e-3)


def test_megatts_int8_hifigan_with_prompt_matches_jax(serving_pair):
    """``Megatts(quant_int8=True)`` with HiFi-GAN: ``__call__`` and
    ``synthesize_batch`` with a (1, P) prompt shared by the batch give the
    JAX waveforms (greedy: the two generators' streams differ)."""
    from megatts2_tpu.models import Megatts as JMegatts
    from megatts2_tpu_torch.models import Megatts

    (g_vars, plm_p, adm_p, hifi_p), (g_cfg, plm_cfg, adm_cfg, hifi_cfg) = \
        serving_pair["vars"], serving_pair["cfgs"]
    jtts = JMegatts(g_vars, plm_p, adm_p, hifi_p, serving_pair["sym"], g_cfg=g_cfg,
                    plm_cfg=plm_cfg, adm_cfg=adm_cfg, hifi_cfg=hifi_cfg, max_frames=MAX_FRAMES,
                    dtype=jnp.float32, quant_int8=True)
    p = serving_pair["port"]()
    ttts = Megatts(p["g"], p["plm"], p["adm"], p["vocoder"], serving_pair["sym"],
                   max_frames=MAX_FRAMES, dtype=torch.float32, device="cpu", quant_int8=True)
    assert ttts.plm.predict_layer.weight_q.dtype == torch.int8
    assert ttts.plm.plm.layers[0].attn.qkv.scale.dtype == torch.float32
    feats = serving_pair["features"]
    root = serving_pair["root"]
    ref = jtts(serving_pair["wavs"], "hello world", out_path=str(root / "jax.wav"),
               prompt_features=(jnp.asarray(feats[0]), jnp.asarray(feats[1])))
    got = ttts(serving_pair["wavs"], "hello world", out_path=str(root / "torch.wav"),
               prompt_features=feats)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-3)

    mels = np.random.RandomState(28).randn(2, 40, 80).astype(np.float32)
    texts = ["hello world", "world hello world"]
    ref_b = jtts.synthesize_batch(texts, mels, prompt_features=feats)
    got_b = ttts.synthesize_batch(texts, mels, prompt_features=feats)
    assert [len(w) for w in got_b] == [len(w) for w in ref_b]
    for a, b in zip(got_b, ref_b):
        np.testing.assert_allclose(a, b, atol=1e-3)


def test_vocode_dispatches_on_the_vocoder_type():
    from megatts2_tpu_torch.models import HiFiGAN, Vocos, vocode

    mel = torch.zeros(1, 3, 80)
    voc = Vocos(tcfg.VocosConfig(dim=8, intermediate_dim=16, num_layers=1))
    hifi = HiFiGAN(tcfg.HiFiGANConfig(upsample_initial_channel=16, upsample_rates=(16, 16),
                                      upsample_kernel_sizes=(32, 32)))
    with torch.no_grad():
        assert vocode(voc, mel).shape == vocode(hifi, mel).shape == (1, 3 * 256)
    with pytest.raises(TypeError, match="Linear"):
        vocode(torch.nn.Linear(2, 2), mel)


def test_training_states_default_to_the_card():
    """An entry point runs on the card unless asked for the CPU: without
    one, the default raises."""
    from megatts2_tpu_torch.training import create_adm_state, create_plm_state

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = tcfg.MegaPLMConfig(n_layers=1, n_heads=2, vq_dim=8, tc_latent_dim=8, vq_bins=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_plm_state(cfg, tcfg.TrainConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        create_adm_state(tcfg.MegaADMConfig(n_layers=1, n_heads=2, emb_dim=8, tc_latent_dim=8,
                                            tc_emb_dim=8), tcfg.TrainConfig())
