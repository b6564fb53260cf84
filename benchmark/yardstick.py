"""The benchmark's own counts of work and the card's peaks: frozen copies,
so that a change to the port cannot move the yardstick.

* :data:`PEAK_FLOPS`, :data:`PEAK_BYTES_PER_S`: one NVIDIA H100 SXM5 at
  its 700 W limit (NVIDIA's data sheet, dense).
* :func:`synthesis_flops`: a copy of the port's ``utils/flops.py``
  ``synthesis_flops`` for the Vocos family (matmul and conv MACs × 2 of
  one batched ``synthesize`` over its whole padded budget).
* :func:`plm_decode_step_work`: the bytes and FLOPs one int8 PLM decode
  step needs, averaged over the steps of a decode (the pattern of
  ``tools/bw_ceiling.decode_step_bytes``, counted from the configuration).
* :func:`attention_fwd_work`, :func:`attention_bwd_work`: masked causal
  attention at the rows' real lengths.
* :func:`plm_train_flops`: 6 × matmul parameters × real tokens plus the
  attention's forward and backward at the real lengths.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

PEAK_CARD = "NVIDIA H100 SXM5, 700 W"
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12}
PEAK_BYTES_PER_S = 3.35e12


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def least_time(flops: float, nbytes: float, peak: float = PEAK_FLOPS["bf16"]) -> float:
    """The least seconds the card could take: the larger of its two bounds."""
    return max(flops / peak, nbytes / PEAK_BYTES_PER_S)


# ---------------------------------------------------------------- synthesis


def transformer_flops(n_layers, d, ff, T, B, conv_ff=False, ff_kernel=5) -> float:
    proj = 4 * B * T * d * d * 2
    attn = 2 * B * T * T * d * 2
    ffl = 2 * B * T * (ff_kernel if conv_ff else 1) * d * ff * 2
    return n_layers * (proj + attn + ffl)


def ar_transformer_flops(n_layers, d, ff, T, B) -> float:
    proj = 4 * B * T * d * d * 2
    attn = 2 * B * T * T * d
    ffl = 2 * B * T * d * ff * 2
    return n_layers * (proj + attn + ffl)


def convnet_flops(T, B, in_ch, hidden, out_ch, n_stacks, n_blocks, k) -> float:
    return (B * T * k * in_ch * hidden * 2 + n_stacks * n_blocks * B * T * k * hidden * hidden * 2
            + B * T * k * hidden * out_ch * 2)


def convnet_double_flops(T, B, in_ch, hidden, out_ch, n_layers, n_stacks, n_blocks, k,
                         middle_stride, middle_is_conv) -> float:
    T2 = _cdiv(T, middle_stride)
    per_layer = (n_stacks * n_blocks * B * T * k * hidden * hidden * 2
                 + (B * T2 * (middle_stride + 1) * hidden * hidden * 2 if middle_is_conv else 0)
                 + n_stacks * n_blocks * B * T2 * k * hidden * hidden * 2)
    return B * T * k * in_ch * hidden * 2 + n_layers * per_layer + B * T2 * k * hidden * out_ch * 2


def mrte_flops(m: dict, B, Tp, Tm) -> float:
    H = m["hidden_size"]
    enc = transformer_flops(m["content_n_layers"], H, m["content_ff_dim"], Tp, B, conv_ff=True)
    mel = convnet_double_flops(Tm, B, m["mel_bins"], H, H, m["mel_n_layer"], m["mel_n_stack"],
                               m["mel_n_block"], m["mel_kernel_size"], m["mel_stride"], True)
    Tk = _cdiv(Tm, m["mel_stride"])
    xattn = B * Tp * H * H * 2 + 2 * B * Tk * H * H * 2 + 2 * B * Tp * Tk * H * 2 + B * Tp * H * H * 2
    return enc + mel + xattn


def vocos_flops(c: dict, B, T) -> float:
    n_freq = c["n_fft"] // 2 + 1
    per_block = B * T * 7 * c["dim"] * 2 + 2 * B * T * c["dim"] * c["intermediate_dim"] * 2
    return (B * T * 7 * c["in_channels"] * c["dim"] * 2 + c["num_layers"] * per_block
            + B * T * c["dim"] * 2 * n_freq * 2 + B * T * c["n_fft"] * n_freq * 2)


def synthesis_flops(cfg: dict, B: int, Tp: int, Tm: int, max_frames: int) -> Dict[str, float]:
    """Per-stage and total FLOPs of one batched synthesis (int8 + Vocos)."""
    g, plm, adm, voc = cfg["g"], cfg["plm"], cfg["adm"], cfg["vocoder"]
    m = g["mrte"]
    adm_d = adm["emb_dim"] + adm["tc_emb_dim"]
    plm_d = plm["vq_dim"] + plm["tc_latent_dim"]
    T8 = _cdiv(max_frames, 8)
    out = {
        "mrte": mrte_flops(m, B, Tp, Tm),
        "adm": ar_transformer_flops(adm["n_layers"], adm_d, adm["emb_dim"] * 4, Tp, B)
        + B * Tp * adm["tc_latent_dim"] * adm["tc_emb_dim"] * 2,
        "plm": ar_transformer_flops(plm["n_layers"], plm_d, plm_d * 4, T8, B)
        + B * T8 * plm_d * plm["vq_bins"] * 2,
        "decoder": convnet_flops(max_frames, B, m["hidden_size"] + g["vqpe"]["vq_dim"],
                                 g["hidden_size"], m["mel_bins"], g["decoder_n_stack"],
                                 g["decoder_n_block"], g["kernel_size"]),
        "vocoder": vocos_flops(voc, B, max_frames),
    }
    out["total"] = sum(out.values())
    return out


def plm_decode_step_work(plm: dict, B: int, T: int, act_bytes: int = 2) -> Tuple[float, float]:
    """(bytes, FLOPs) of one int8 PLM decode step averaged over a T-step
    decode: every Linear's int8 weight and fp32 scale and bias read once,
    each layer's KV cache read at positions <= t, and the products."""
    d = plm["vq_dim"] + plm["tc_latent_dim"]
    L = plm["n_layers"]
    shapes = [(3 * d, d, True), (d, d, True), (4 * d, d, True), (d, 4 * d, True)]
    w = L * sum(o * i + 4 * o * (2 if b else 1) for o, i, b in shapes)
    w += plm["vq_bins"] * d + 4 * plm["vq_bins"]  # the head: int8 weight, fp32 scale
    mean_len = (T + 1) / 2
    kv = L * B * 2 * d * act_bytes * mean_len
    flops = L * B * 2 * (12 * d * d) + B * 2 * d * plm["vq_bins"] + L * B * 4 * d * mean_len
    return w + kv, flops


# ---------------------------------------------------------------- training


def _pairs(lens: Sequence[int]) -> int:
    return sum(n * (n + 1) // 2 for n in lens)


def attention_fwd_work(lens: Sequence[int], H: int, Dh: int, elt: int = 2) -> Tuple[float, float]:
    """(bytes, FLOPs) of one masked causal attention forward over rows of
    ``lens``: q, k, v read and o written once, the softmax statistics
    (two fp32 a row and head) written; QK^T and PV over the causal pairs."""
    n = sum(lens)
    return 4 * n * H * Dh * elt + 2 * n * H * 4, 4 * _pairs(lens) * H * Dh


def attention_bwd_work(lens: Sequence[int], H: int, Dh: int, elt: int = 2) -> Tuple[float, float]:
    """(bytes, FLOPs) of its backward: q, k, v, o, dO and the statistics
    read, dq, dk, dv written; dV, dP, dQ and dK over the causal pairs."""
    n = sum(lens)
    return 8 * n * H * Dh * elt + 2 * n * H * 4, 8 * _pairs(lens) * H * Dh


def plm_matmul_params(plm: dict) -> int:
    d = plm["vq_dim"] + plm["tc_latent_dim"]
    return plm["n_layers"] * 12 * d * d + d * plm["vq_bins"]


def plm_train_flops(plm: dict, lens: Sequence[int]) -> float:
    """Model FLOPs of one PLM train step: 6 × matmul parameters × real
    tokens, plus the attention's forward and backward at the real lengths."""
    d = plm["vq_dim"] + plm["tc_latent_dim"]
    H = plm["n_heads"]
    attn = plm["n_layers"] * (attention_fwd_work(lens, H, d // H)[1]
                              + attention_bwd_work(lens, H, d // H)[1])
    return 6 * plm_matmul_params(plm) * sum(lens) + attn
