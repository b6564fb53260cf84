"""The port's FLOP counts (``megatts2_tpu_torch/utils/flops.py``) equal
the JAX package's (``megatts2_tpu/utils/flops.py``) exactly, function by
function, over the default configs, a tiny config, both vocoder families
and several batch sizes and lengths; its peaks are the H100 SXM's."""
import dataclasses

import pytest

from megatts2_tpu import config as jcfg
from megatts2_tpu.utils import flops as jf
from megatts2_tpu_torch import config as tcfg
from megatts2_tpu_torch.utils import flops as tf

SIZES = [(1, 16, 64), (8, 64, 512), (3, 37, 301)]  # (B, T short, T long)
TINY_MRTE = dict(mel_stride=4, mel_n_layer=1, mel_n_stack=1, mel_n_block=1, content_ff_dim=64,
                 content_n_heads=2, content_n_layers=2, hidden_size=128, phone_vocab_size=40)
TINY_VQPE = dict(hidden_size=32, kernel_size=3, n_layers=1, n_stacks=1, n_blocks=1, vq_bins=32,
                 vq_dim=16)
JAX_CFGS = {
    "default": dict(g=jcfg.MegaGConfig(), plm=jcfg.MegaPLMConfig(),
                    adm=jcfg.MegaADMConfig(tc_emb_dim=512), hifi=jcfg.HiFiGANConfig(),
                    vocos=jcfg.VocosConfig()),
    "tiny": dict(g=jcfg.MegaGConfig(mrte=jcfg.MRTEConfig(**TINY_MRTE),
                                    vqpe=jcfg.VQPEConfig(**TINY_VQPE), kernel_size=3,
                                    hidden_size=32, decoder_n_stack=1, decoder_n_block=1),
                 plm=jcfg.MegaPLMConfig(n_layers=2, n_heads=2, vq_dim=8, tc_latent_dim=128,
                                        vq_bins=32),
                 adm=jcfg.MegaADMConfig(n_layers=2, n_heads=2, emb_dim=8, tc_latent_dim=128,
                                        tc_emb_dim=8),
                 hifi=jcfg.HiFiGANConfig(upsample_initial_channel=16, resblock_kernel_sizes=(3, 5),
                                         resblock_dilation_sizes=((1, 3), (1, 2))),
                 vocos=jcfg.VocosConfig(dim=16, intermediate_dim=48, num_layers=2)),
}


def _port(cfg):
    """The port's config with the JAX config's field values."""
    kw = {f.name: (_port(getattr(cfg, f.name)) if dataclasses.is_dataclass(getattr(cfg, f.name))
                   else getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    return getattr(tcfg, type(cfg).__name__)(**kw)


def _same(name: str, *args, **kwargs):
    """JAX's function on the JAX configs, the port's on its copies: equal."""
    want = getattr(jf, name)(*args, **kwargs)
    got = getattr(tf, name)(*(_port(a) if dataclasses.is_dataclass(a) else a for a in args), **kwargs)
    assert got == want and type(got) is type(want), (name, got, want)
    return got


@pytest.mark.parametrize("B,T,_", SIZES)
@pytest.mark.parametrize("conv_ff", [False, True])
def test_encoder_counts(B, T, _, conv_ff):
    _same("transformer_flops", 8, 512, 1024, T, B, conv_ff=conv_ff)
    _same("transformer_flops", 2, 16, 32, T, B, conv_ff=conv_ff, ff_kernel=3)
    _same("ar_transformer_flops", 12, 1024, 4096, T, B)


@pytest.mark.parametrize("B,T,_", SIZES)
@pytest.mark.parametrize("middle_is_conv", [False, True])
def test_convnet_counts(B, T, _, middle_is_conv):
    _same("convnet_flops", T, B, 592, 512, 80, 4, 2, 5)
    _same("convnet_double_flops", T, B, 80, 512, 512, 5, 5, 2, 3, 16, middle_is_conv)
    _same("convnet_double_flops", T, B, 20, 384, 256, 3, 5, 2, 5, 8, middle_is_conv)


@pytest.mark.parametrize("which", sorted(JAX_CFGS))
@pytest.mark.parametrize("B,Tp,Tm", SIZES)
def test_model_counts(which, B, Tp, Tm):
    c = JAX_CFGS[which]
    _same("mrte_tc_latent_flops", c["g"].mrte, B, Tp, Tm)
    _same("hifigan_flops", c["hifi"], B, Tm)
    _same("vocos_flops", c["vocos"], B, Tm)
    assert _same("gan_step_flops", c["g"], B, Tp, Tm, Tm) > 0


@pytest.mark.parametrize("which", sorted(JAX_CFGS))
@pytest.mark.parametrize("vocoder", ["hifi", "vocos"])
@pytest.mark.parametrize("B,Tp,Tm", SIZES)
def test_synthesis_counts(which, vocoder, B, Tp, Tm):
    c = JAX_CFGS[which]
    out = _same("synthesis_flops", c["g"], c["plm"], c["adm"], c[vocoder], B, Tp, Tm, 2 * Tm)
    assert set(out) == {"mrte", "adm", "plm", "decoder", "vocoder", "total"}


def test_gan_step_at_the_bench_geometry_and_the_h100_peaks():
    """bench_train's GAN geometry (B=8, Tp=64, 512 + 512 frames) counts
    2149.0 GFLOP; the peaks are the H100 SXM's dense rates."""
    fl = _same("gan_step_flops", jcfg.MegaGConfig(), 8, 64, 512, 512)
    assert round(fl / 1e9, 1) == 2149.0
    assert tf.PEAK_FLOPS["bf16"] == 989e12 and tf.PEAK_FLOPS["f32"] == 67e12
    assert tf.PEAK_BYTES_PER_S == 3.35e12 and "H100" in tf.PEAK_CARD
