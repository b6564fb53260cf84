"""Analytic FLOP counts for the synthesis cascade and training steps (port
of ``megatts2_tpu/utils/flops.py``, the same counts).

``tools/bench_train.py`` reports MFU from them.  Counts are matmul/conv
MACs×2 only (elementwise, norm, softmax and gather traffic are excluded —
they are bandwidth, not FLOPs); accurate to a few percent for these
conv/transformer-dominated graphs.
"""
from __future__ import annotations

from ..config import HiFiGANConfig, MegaADMConfig, MegaGConfig, MegaPLMConfig

# NVIDIA H100 SXM5, dense (NVIDIA's data sheet, at its 700 W limit): 989
# TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32 outside them, 1,979
# TOP/s int8; 3.35 TB/s of HBM3
PEAK_CARD = "NVIDIA H100 SXM5"
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
PEAK_BYTES_PER_S = 3.35e12


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def transformer_flops(
    n_layers: int, d: int, ff: int, T: int, B: int,
    conv_ff: bool = False, ff_kernel: int = 5,
) -> float:
    """Full (non-AR) encoder forward."""
    proj = 4 * B * T * d * d * 2  # q,k,v,out
    attn = 2 * B * T * T * d * 2  # logits + apply
    if conv_ff:
        ffl = 2 * B * T * ff_kernel * d * ff * 2
    else:
        ffl = 2 * B * T * d * ff * 2
    return n_layers * (proj + attn + ffl)


def ar_transformer_flops(n_layers: int, d: int, ff: int, T: int, B: int) -> float:
    """KV-cached greedy decode of T tokens (per-step projections + growing
    cache attention)."""
    proj = 4 * B * T * d * d * 2
    attn = 2 * B * T * T * d  # sum_t 2*t*d*2 ≈ T^2*d*2, halved for avg t
    ffl = 2 * B * T * d * ff * 2
    return n_layers * (proj + attn + ffl)


def convnet_flops(
    T: int, B: int, in_ch: int, hidden: int, out_ch: int,
    n_stacks: int, n_blocks: int, k: int,
) -> float:
    first = B * T * k * in_ch * hidden * 2
    blocks = n_stacks * n_blocks * B * T * k * hidden * hidden * 2
    last = B * T * k * hidden * out_ch * 2
    return first + blocks + last


def convnet_double_flops(
    T: int, B: int, in_ch: int, hidden: int, out_ch: int,
    n_layers: int, n_stacks: int, n_blocks: int, k: int,
    middle_stride: int, middle_is_conv: bool,
) -> float:
    T2 = _ceil_div(T, middle_stride)
    first = B * T * k * in_ch * hidden * 2
    per_layer = (
        n_stacks * n_blocks * B * T * k * hidden * hidden * 2  # stack1
        + (B * T2 * (middle_stride + 1) * hidden * hidden * 2 if middle_is_conv else 0)
        + n_stacks * n_blocks * B * T2 * k * hidden * hidden * 2  # stack2
    )
    last = B * T2 * k * hidden * out_ch * 2
    return first + n_layers * per_layer + last


def mrte_tc_latent_flops(cfg, B: int, Tp: int, Tm: int) -> float:
    m = cfg
    H = m.hidden_size
    enc = transformer_flops(
        m.content_n_layers, H, m.content_ff_dim, Tp, B, conv_ff=True
    )
    mel = convnet_double_flops(
        Tm, B, m.mel_bins, H, H, m.mel_n_layer, m.mel_n_stack, m.mel_n_block,
        m.mel_kernel_size, m.mel_stride, middle_is_conv=True,
    )
    Tk = _ceil_div(Tm, m.mel_stride)
    xattn = (
        B * Tp * H * H * 2  # q proj
        + 2 * B * Tk * H * H * 2  # k, v proj
        + 2 * B * Tp * Tk * H * 2  # logits + apply
        + B * Tp * H * H * 2  # out proj
    )
    return enc + mel + xattn


def hifigan_flops(cfg: HiFiGANConfig, B: int, T: int) -> float:
    c = cfg
    total = B * T * 7 * c.in_channels * c.upsample_initial_channel * 2  # conv_pre
    t = T
    ch_in = c.upsample_initial_channel
    for i, (r, k) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
        ch = c.upsample_initial_channel // (2 ** (i + 1))
        total += B * t * k * ch_in * ch * 2  # transposed conv (useful MACs)
        t *= r
        for rk, rd in zip(c.resblock_kernel_sizes, c.resblock_dilation_sizes):
            total += len(rd) * 2 * B * t * rk * ch * ch * 2
        ch_in = ch
    total += B * t * 7 * ch_in * 1 * 2  # conv_post
    return total


def vocos_flops(cfg, B: int, T: int) -> float:
    """Vocos generator forward (models/vocos.py): embed conv + ConvNeXt
    blocks (dwconv + 2 pointwise) + head Dense + irfft-as-DFT."""
    c = cfg
    n_freq = c.n_fft // 2 + 1
    embed = B * T * 7 * c.in_channels * c.dim * 2
    per_block = (
        B * T * 7 * c.dim * 2  # depthwise k=7
        + 2 * B * T * c.dim * c.intermediate_dim * 2  # two pointwise
    )
    head = B * T * c.dim * 2 * n_freq * 2
    irfft = B * T * c.n_fft * n_freq * 2  # counted as the DFT matmul bound
    return embed + c.num_layers * per_block + head + irfft


def synthesis_flops(
    g_cfg: MegaGConfig,
    plm_cfg: MegaPLMConfig,
    adm_cfg: MegaADMConfig,
    hifi_cfg: HiFiGANConfig,
    B: int, Tp: int, Tm_prompt: int, max_frames: int,
) -> dict:
    """Per-stage + total forward FLOPs of one batched ``synthesize`` call
    (the full padded budget is computed, matching what the device does)."""
    m = g_cfg.mrte
    mrte = mrte_tc_latent_flops(m, B, Tp, Tm_prompt)
    adm_d = adm_cfg.d_model
    adm = (
        ar_transformer_flops(adm_cfg.n_layers, adm_d, adm_cfg.emb_dim * 4, Tp, B)
        + B * Tp * adm_cfg.tc_latent_dim * adm_cfg.tc_emb_dim * 2
    )
    T8 = _ceil_div(max_frames, 8)
    plm_d = plm_cfg.d_model
    plm = (
        ar_transformer_flops(plm_cfg.n_layers, plm_d, plm_d * 4, T8, B)
        + B * T8 * plm_d * plm_cfg.vq_bins * 2
    )
    dec = convnet_flops(
        max_frames, B, m.hidden_size + g_cfg.vqpe.vq_dim, g_cfg.hidden_size,
        m.mel_bins, g_cfg.decoder_n_stack, g_cfg.decoder_n_block, g_cfg.kernel_size,
    )
    if isinstance(hifi_cfg, HiFiGANConfig):
        voc = hifigan_flops(hifi_cfg, B, max_frames)
    else:  # VocosConfig (fast iSTFT family)
        voc = vocos_flops(hifi_cfg, B, max_frames)
    out = {"mrte": mrte, "adm": adm, "plm": plm, "decoder": dec, "vocoder": voc}
    out["total"] = sum(out.values())
    return out


def gan_step_flops(g_cfg: MegaGConfig, B: int, Tp: int, Tm: int, Tt: int) -> float:
    """One GAN train step ≈ 3× generator forward (fwd + bwd≈2×fwd); the
    discriminator (fixed 32/64/128-frame windows) adds a few percent."""
    m, v = g_cfg.mrte, g_cfg.vqpe
    fwd = (
        mrte_tc_latent_flops(m, B, Tp, Tt)
        + convnet_double_flops(
            Tm, B, v.mel_bins, v.hidden_size, v.vq_dim, v.n_layers, v.n_stacks,
            v.n_blocks, v.kernel_size, v.stride, middle_is_conv=False,
        )
        + convnet_flops(
            Tm, B, m.hidden_size + v.vq_dim, g_cfg.hidden_size, m.mel_bins,
            g_cfg.decoder_n_stack, g_cfg.decoder_n_block, g_cfg.kernel_size,
        )
    )
    return 3.0 * fwd
