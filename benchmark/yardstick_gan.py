"""The benchmark's count of the VQ-GAN step's work (``mfu.gan``), kept
beside ``yardstick.py`` and, like it, apart from the port: matmul and conv
FLOPs (2 × MACs) at the shapes the step runs, from the configuration file
(``benchmark/configs/megatts2-gan-train.json``'s ``g`` and ``d``).
Elementwise work, the norms and the optimizers are not counted.
"""
from __future__ import annotations


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _strided_len(T: int, s: int) -> int:
    """Output length of the MRTE's middle conv (kernel s + 1, stride s, padding s // 2)."""
    return (T + 2 * (s // 2) - (s + 1)) // s + 1


def g_forward_flops(cfg: dict, B: int, T: int, Tp: int, Tm: int) -> float:
    """Matmul and conv FLOPs (2 × MACs) of one G forward: the prosody
    encoder, the codebook's distances, the MRTE and the decoder."""
    g, m, v = cfg["g"], cfg["g"]["mrte"], cfg["g"]["vqpe"]

    def double(T0, T1, c_in, H, c_out, n_layers, n_stacks, n_blocks, k, middle_k):
        blocks = n_stacks * n_blocks * k * H * H
        return 2 * B * (T0 * k * c_in * H + n_layers * (T0 * blocks + T1 * middle_k * H * H
                                                         + T1 * blocks) + T1 * k * H * c_out)

    T8 = _ceil_div(T, v["stride"])
    vq = double(T, T8, v["mel_bins"], v["hidden_size"], v["vq_dim"], v["n_layers"],
                v["n_stacks"], v["n_blocks"], v["kernel_size"], 0)
    vq += 2 * B * T8 * v["vq_bins"] * v["vq_dim"]
    H = m["hidden_size"]
    Tk = _strided_len(Tm, m["mel_stride"])
    mel = double(Tm, Tk, m["mel_bins"], H, H, m["mel_n_layer"], m["mel_n_stack"],
                 m["mel_n_block"], m["mel_kernel_size"], m["mel_stride"] + 1)
    layer = 2 * B * (4 * Tp * H * H + 2 * Tp * Tp * H + 2 * 5 * Tp * H * m["content_ff_dim"])
    xattn = 2 * B * (2 * Tp * H * H + 2 * Tk * H * H + 2 * Tp * Tk * H)
    k = g["kernel_size"]
    dec = 2 * B * T * k * g["hidden_size"] * (
        H + v["vq_dim"] + g["decoder_n_stack"] * g["decoder_n_block"] * g["hidden_size"]
        + m["mel_bins"])
    return float(vq + mel + m["content_n_layers"] * layer + xattn + dec)


def d_pass_flops(cfg: dict, B: int) -> float:
    """Conv and Linear FLOPs of one discriminator pass over its windows."""
    d = cfg["d"]
    kh, kw = d["kernel"]
    C = d["hidden_size"]
    total = 0
    for wl in d["time_lengths"]:
        t, f, c_in = wl, d["freq_length"], d["c_in"]
        for _ in range(3):
            t, f = _ceil_div(t, 2), _ceil_div(f, 2)
            total += 2 * B * t * f * kh * kw * c_in * C
            c_in = C
        total += 2 * B * t * f * C
    return float(total)


def train_step_flops(cfg: dict, B: int, T: int, Tp: int, Tm: int) -> float:
    """Model FLOPs of one GAN step: G's forward and backward (3 × its
    forward); D's real and fake passes forward and backward (3 × each)
    and its adversarial pass forward and back to ŷ (2 ×)."""
    return 3 * g_forward_flops(cfg, B, T, Tp, Tm) + 8 * d_pass_flops(cfg, B)
