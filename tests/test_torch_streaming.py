"""Streaming synthesis in the port (``megatts2_tpu_torch/models/streaming.py``,
``Megatts.stream``) against the port's one-shot ``synthesize`` and against
the JAX package's ``stream_synthesize``, on the CPU at tiny widths, fp32.

The cascade here (``build_cascade``, also used by ``test_torch_continuous.py``
and ``test_torch_serve.py``) has the tiny configs of
``tests/test_streaming.py``; its weights are the port's, made so that
durations and prosody codes steer the output, and reach JAX through the
port's reference-layout state dicts and JAX's converters.

Tolerances: the concatenated stream equals ``synthesize`` at the stream's
frame budget to atol 1e-4 (``tests/test_streaming.py``'s bound: windows
sum in another order at their seams) with the same length; against JAX's
stream, lengths equal and atol 1e-3 (fp32 through the whole cascade, as
``tests/test_torch_slice.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from megatts2_tpu_torch.bridge import load_flax_params

F_CHUNK = 32
ADM_SCALE = -0.6  # raw durations of 1-5 frames a phone from these weights


def build_cascade(adm_scale: float = ADM_SCALE):
    """(jax vars, jax cfgs, port cfgs, a port-module factory) of the tiny
    cascade.  The weights are made by the port (seeded ``init_random_``
    plus 0.1 noise on every parameter, the codebook random and marked
    initialised, the ADM's head scaled to a few frames a phone with a weak
    raw feedback) and carried to JAX through the port's reference-layout
    state dicts and JAX's converters, so no JAX init is compiled."""
    import test_torch_slice as ts
    from megatts2_tpu.training import convert as jconv
    from megatts2_tpu_torch import models as tm
    from megatts2_tpu_torch.training.checkpoints import model_state_dict
    from tests.test_streaming import TINY_ADM, TINY_G, TINY_HIFI, TINY_PLM

    jcfgs = (TINY_G, TINY_PLM, TINY_ADM, TINY_HIFI)
    tcfgs = tuple(ts._torch_cfg(c) for c in jcfgs)
    gen = torch.Generator().manual_seed(1)
    mods = [tm.init_random_(m, gen) for m in (tm.MegaG(tcfgs[0]), tm.MegaPLM(tcfgs[1]),
                                              tm.MegaADM(tcfgs[2]), tm.HiFiGAN(tcfgs[3]))]
    with torch.no_grad():
        for m in mods:
            for p in m.parameters():
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
        cb = mods[0].vqpe.vq.layers[0]._codebook
        cb.inited.fill_(1.0)
        cb.cluster_size.fill_(1.0)
        cb.embed_avg.copy_(cb.embed)
        mods[2].predict_layer.weight.mul_(adm_scale)
        mods[2].dt_linear_emb.weight.mul_(0.005)
    sds = []
    for m, prefix in zip(mods, ("G.", "plm.", "adm.", "")):
        sds.append({k[len(prefix):]: v.numpy() for k, v in model_state_dict(m).items()})
    trees = (jconv.convert_megag(sds[0], TINY_G), jconv.convert_plm(sds[1], TINY_PLM),
             jconv.convert_adm(sds[2], TINY_ADM), jconv.convert_hifigan(sds[3], TINY_HIFI))

    def port():
        return (load_flax_params(tm.MegaG(tcfgs[0]), trees[0]).eval(),
                load_flax_params(tm.MegaPLM(tcfgs[1]), trees[1]).eval(),
                load_flax_params(tm.MegaADM(tcfgs[2]), trees[2]).eval(),
                load_flax_params(tm.HiFiGAN(tcfgs[3]), trees[3]).eval())

    return dict(vars=trees, jcfgs=jcfgs, tcfgs=tcfgs, port=port)


@pytest.fixture(scope="module")
def cascade():
    return build_cascade()


def padded_phones(phone: np.ndarray) -> np.ndarray:
    """(1, tp) → (1, Tp): zero-padded to a multiple of 16, as the engine does."""
    tp = phone.shape[1]
    out = np.zeros((1, -(-tp // 16) * 16), np.int64)
    out[0, :tp] = phone[0]
    return out


def port_synthesize(cascade, phone, lens, mels, max_frames, **kw):
    """The port's one-shot ``synthesize`` on numpy inputs → (wav trimmed, n_frames)."""
    from megatts2_tpu_torch.models import synthesize

    g, plm, adm, voc = cascade["port"]()
    wav, _, n = synthesize(g, plm, adm, voc, torch.as_tensor(phone).long(),
                           torch.as_tensor(lens).long(), torch.as_tensor(mels), max_frames, **kw)
    n = int(n[0])
    return wav[0, : n * 256].numpy(), n


def _inputs(seed=0, tp=48):
    rng = np.random.RandomState(seed)
    phone = rng.randint(1, 40, (1, tp)).astype(np.int64)
    return phone, np.full((1,), tp, np.int64), rng.randn(1, 64, 80).astype(np.float32)


def test_rf_helpers_equal_jax(cascade):
    from megatts2_tpu.config import HiFiGANConfig as JH, MegaGConfig as JG, VocosConfig as JV
    from megatts2_tpu.models import streaming as js
    from megatts2_tpu_torch import config as tcfg
    from megatts2_tpu_torch.models import streaming as ps

    for jc, tc in ((cascade["jcfgs"][0], cascade["tcfgs"][0]), (JG(), tcfg.MegaGConfig())):
        assert ps.decoder_rf_frames(tc) == js.decoder_rf_frames(jc)
    for jc, tc in ((cascade["jcfgs"][3], cascade["tcfgs"][3]), (JH(), tcfg.HiFiGANConfig()),
                   (JV(), tcfg.VocosConfig()), (JV(num_layers=2, n_fft=512),
                                                 tcfg.VocosConfig(num_layers=2, n_fft=512))):
        assert ps.vocoder_rf_frames(tc) == js.vocoder_rf_frames(jc)
    assert ps.hifigan_rf_frames(tcfg.HiFiGANConfig()) == js.hifigan_rf_frames(JH())


def _stream(cascade, phone, lens, mels, max_frames, plm=None):
    from megatts2_tpu_torch.models.streaming import stream_synthesize

    g, p, adm, voc = cascade["port"]()
    return list(stream_synthesize(g, plm or p, adm, voc, torch.from_numpy(phone),
                                  torch.from_numpy(lens), torch.from_numpy(mels), max_frames,
                                  F_CHUNK))


def test_stream_equals_synthesize_and_jax(cascade):
    from megatts2_tpu.models.streaming import stream_synthesize as jstream
    from megatts2_tpu_torch.models.streaming import stream_geometry

    phone, lens, mels = _inputs()
    g, _, _, voc = cascade["port"]()
    Tmax = stream_geometry(g.cfg, voc.cfg, 96, F_CHUNK)[3]
    chunks = _stream(cascade, phone, lens, mels, 96)
    assert len(chunks) >= 3  # several chunks and seams
    assert all(c.shape[0] == F_CHUNK * 256 for c in chunks[:-1])
    streamed = np.concatenate(chunks)
    full, n = port_synthesize(cascade, phone, lens, mels, Tmax)
    assert streamed.shape[0] == n * 256
    np.testing.assert_allclose(streamed, full, rtol=1e-4, atol=1e-4)

    jchunks = list(jstream(*cascade["vars"], *cascade["jcfgs"], phone.astype(np.int32),
                           lens.astype(np.int32), mels, max_frames=96, chunk_frames=F_CHUNK,
                           dtype=jnp.float32))
    ref = np.concatenate(jchunks)
    assert [c.shape for c in jchunks] == [c.shape for c in chunks]
    np.testing.assert_allclose(streamed, ref, atol=1e-3)


def test_stream_int8_runs(cascade):
    from megatts2_tpu_torch.quantization.weight_only import quantize_

    phone, lens, mels = _inputs(1, tp=4)
    plm = quantize_(cascade["port"]()[1], 8)
    chunks = _stream(cascade, phone, lens, mels, 64, plm=plm)
    assert chunks and all(np.isfinite(c).all() for c in chunks)


def test_megatts_stream_equals_call(cascade, tmp_path):
    """``Megatts.stream`` over a prompt directory: the chunks joined equal
    the generated part of ``Megatts.__call__`` at the stream's budget."""
    from megatts2_tpu_torch.models import Megatts
    from megatts2_tpu_torch.models.streaming import stream_geometry
    from megatts2_tpu_torch.utils.audio import save_wav

    sym = tmp_path / "symbols"
    sym.write_text("".join(f"{s} {i}\n" for i, s in enumerate(["<eps>", "_", "-", "hello",
                                                              "world"])))
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    t = np.arange(4000) / 16000.0
    save_wav(str(wavs / "a.wav"), (0.3 * np.sin(2 * np.pi * 180 * t)).astype(np.float32))
    g, plm, adm, voc = cascade["port"]()
    Tmax = stream_geometry(g.cfg, voc.cfg, 64, F_CHUNK)[3]
    tts = Megatts(g, plm, adm, voc, str(sym), max_frames=Tmax, dtype=torch.float32,
                  device="cpu")
    text = "hello world hello world hello"
    full = tts(str(wavs), text, out_path=str(tmp_path / "o.wav"))
    streamed = np.concatenate(list(tts.stream(str(wavs), text, chunk_frames=F_CHUNK)))
    np.testing.assert_allclose(streamed, full[4000:], rtol=1e-4, atol=1e-4)
