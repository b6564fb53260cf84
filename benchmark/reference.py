"""Plain PyTorch reference of the Mega-TTS 2 cascade and of the PLM's
training step, against which the benchmark judges what the port's timed
path produced.

It imports nothing but ``torch``, ``numpy`` and the standard library: not
the port, not JAX.  Weights arrive as a flat ``{name: fp32 tensor}`` dict
in the port's layout (the benchmark makes it from the seed and hands the
same values to the port); everything the port derives from them (bf16
casts, int8 weights and scales, the mel of a prompt) is worked out here
again from that dict and the raw inputs.

Every product goes through a :class:`Precision`: ``Precision("fp32")`` is
the reference (float32, TF32 off, set by the caller), and the lower
precisions are the controls, the reference computed one step below the
configuration: ``fp8`` rounds both operands of every product the
configuration computes in bf16 to float8 e4m3 (per-tensor scale for
activations, per-output-channel for weights), and ``int4`` takes the place
of the PLM's int8 weights.  Products the configuration keeps in fp32 (the
Vocos head, the codebook lookup) stay fp32 in every precision.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]

SR, N_FFT, HOP, WIN, N_MELS, F_MAX = 16000, 1024, 256, 1024, 80, 8000.0
FP8_MAX = 448.0
FP8_E5M2_MAX = 57344.0


class Precision:
    """How operands of products are rounded: ``fp32`` (exact), ``bf16``
    (bfloat16 operands, fp32 products: the size of the rounding error a
    sound bf16 program makes, to scale a check by), ``fp8``
    (float8 e4m3 operands, and in training the gradients that reach a
    product in float8 e5m2, as fp8 training rounds them), ``int8`` /
    ``int4`` weight-only layers (symmetric per output channel, round half
    to even, fp32 activations)."""

    def __init__(self, float_kind: str = "fp32", quant_bits: int = 8):
        if float_kind not in ("fp32", "bf16", "fp8"):
            raise ValueError(f"float_kind {float_kind!r}")
        self.float_kind = float_kind
        self.quant_bits = quant_bits

    def act(self, x: torch.Tensor) -> torch.Tensor:
        if self.float_kind == "fp32":
            return x
        if self.float_kind == "bf16":
            return x.to(torch.bfloat16).to(x.dtype)
        s = x.detach().abs().amax().clamp(min=1e-12) / FP8_MAX
        return _fake_round(x, s)

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A float layer's weight (out, ...)."""
        if self.float_kind == "fp32":
            return w
        if self.float_kind == "bf16":
            return w.to(torch.bfloat16).to(w.dtype)
        s = w.detach().abs().flatten(1).amax(1).clamp(min=1e-12) / FP8_MAX
        return _fake_round(w, s.view(-1, *([1] * (w.dim() - 1))))

    def store(self, x: torch.Tensor) -> torch.Tensor:
        """An activation as a bf16 program keeps it (``bf16`` only)."""
        return x.to(torch.bfloat16).to(x.dtype) if self.float_kind == "bf16" else x

    def out(self, y: torch.Tensor) -> torch.Tensor:
        """A product's output: its gradient rounded on the way back."""
        if self.float_kind != "fp8" or not y.requires_grad:
            return y
        return _RoundGrad.apply(y)


class _RoundGrad(torch.autograd.Function):
    """The identity, whose backward rounds the gradient to float8 e5m2 at
    a per-tensor scale."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        s = g.abs().amax().clamp(min=1e-30) / FP8_E5M2_MAX
        return (g / s).to(torch.float8_e5m2).to(g.dtype) * s


def _fake_round(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 at scale s; the gradient passes straight through."""
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return x + (q - x).detach()


def quantized_weight(w: torch.Tensor, bits: int) -> torch.Tensor:
    """The weight a weight-only layer of ``bits`` multiplies by: each output
    row scaled by amax / qmax (at least 1e-12), rounded half to even,
    clipped to ±qmax, times the scale."""
    qmax = 127.0 if bits == 8 else 7.0
    s = torch.clamp(w.abs().amax(dim=1, keepdim=True) / qmax, min=1e-12)
    return torch.clamp(torch.round(w / s), -qmax, qmax) * s


# ---------------------------------------------------------------- primitives


def linear(x, W: Weights, name: str, P: Precision, bias: bool = True, quant: bool = False):
    w = W[name + ".weight"]
    if quant:
        y = x @ quantized_weight(w, P.quant_bits).T
    else:
        y = P.store(P.out(P.act(x) @ P.weight(w).T))
    return P.store(y + W[name + ".bias"]) if bias else y


def conv(x, W: Weights, name: str, P: Precision, padding: int = 0, stride: int = 1,
         groups: int = 1):
    """Conv1d on channels-last (B, T, C)."""
    y = F.conv1d(P.act(x).transpose(1, 2), P.weight(W[name + ".weight"]), W[name + ".bias"],
                 stride=stride, padding=padding, groups=groups)
    return y.transpose(1, 2)


def layer_norm(x, W: Weights, name: str, eps: float = 1e-5):
    return F.layer_norm(x, x.shape[-1:], W[name + ".weight"], W[name + ".bias"], eps)


def sinusoids(T: int, dim: int, device) -> torch.Tensor:
    pos = torch.arange(T, dtype=torch.float64)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float64) * -(math.log(10000.0) / dim))
    pe = torch.zeros(T, dim, dtype=torch.float64)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.float().to(device)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2 / math.pi) * (x + 0.044715 * x ** 3)))


def attention(q, k, v, P: Precision, key_lens=None, causal: bool = False):
    """q (B, Tq, H, Dh), k and v (B, Tk, H, Dh); keys at or past
    ``key_lens`` and, if ``causal``, after the query are left out."""
    Tq, Tk = q.shape[1], k.shape[1]
    logits = P.out(torch.einsum("bqhd,bkhd->bhqk", P.act(q), P.act(k))) / math.sqrt(q.shape[-1])
    drop = torch.zeros(1, 1, Tq, Tk, dtype=torch.bool, device=q.device)
    if key_lens is not None:
        drop = drop | (torch.arange(Tk, device=q.device)[None, None, None, :]
                       >= key_lens[:, None, None, None])
    if causal:
        drop = drop | torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).triu(1)
    probs = torch.softmax(logits.masked_fill(drop, float("-inf")), dim=-1)
    return P.out(torch.einsum("bhqk,bkhd->bqhd", P.act(probs), P.act(v)))


# ---------------------------------------------------------------- front end


def _hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = math.log(6.4) / 27.0
    with np.errstate(divide="ignore"):
        log_mel = min_log_hz / f_sp + np.log(np.maximum(f, 1e-30) / min_log_hz) / logstep
    return np.where(f >= min_log_hz, log_mel, f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, math.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), m * f_sp)


def mel_filterbank() -> np.ndarray:
    """Slaney-scale, slaney-normalised triangles, (N_FFT // 2 + 1, N_MELS)."""
    freqs = np.linspace(0, SR / 2, N_FFT // 2 + 1)
    f_pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(F_MAX), N_MELS + 2))
    slopes = f_pts[None, :] - freqs[:, None]
    f_diff = np.diff(f_pts)
    fb = np.maximum(0.0, np.minimum(-slopes[:, :-2] / f_diff[None, :-1],
                                    slopes[:, 2:] / f_diff[None, 1:]))
    return (fb * (2.0 / (f_pts[2:] - f_pts[:-2]))[None, :]).astype(np.float32)


def log_mel(wav: torch.Tensor) -> torch.Tensor:
    """(N,) fp32 waveform → (1 + N // HOP, 80) log-mel: magnitude STFT
    (periodic Hann, centred, reflect-padded), slaney filterbank, log of
    the value clamped at 1e-5."""
    window = torch.hann_window(WIN, periodic=True, device=wav.device)
    spec = torch.stft(wav, N_FFT, HOP, WIN, window, center=True, pad_mode="reflect",
                      return_complex=True).abs()
    fb = torch.from_numpy(mel_filterbank()).to(wav.device)
    return torch.log(torch.clamp(spec.T @ fb, min=1e-5))


# ---------------------------------------------------------------- MegaG


def conv_block(x, W, name, P, k):
    """ReLU → conv (same padding) → LayerNorm."""
    return layer_norm(conv(F.relu(x), W, name + ".conv", P, padding=(k - 1) // 2), W, name + ".norm")


def residual_stack(x, W, name, P, n_stacks, n_blocks, k):
    for s in range(n_stacks):
        h = x
        for b in range(n_blocks):
            h = conv_block(h, W, f"{name}.conv_stacks.{s}.blocks.{b}", P, k)
        x = x + h
    return x


def mel_encoder(mel, W, c: dict, P: Precision):
    """The MRTE's ConvNetDouble: first conv, ``mel_n_layer`` branches of
    (stack, the shared stride-``mel_stride`` conv, stack) summed, last conv."""
    k, s = c["mel_kernel_size"], c["mel_stride"]
    name = "mrte.mel_encoder"
    x = conv(mel, W, name + ".first_layer", P, padding=(k - 1) // 2)
    out = 0
    for i in range(c["mel_n_layer"]):
        h = residual_stack(x, W, f"{name}.layers.{i}.conv_stack1", P, c["mel_n_stack"],
                           c["mel_n_block"], k)
        h = conv(h, W, name + ".middle_layer.conv", P, padding=s // 2, stride=s)
        out = out + residual_stack(h, W, f"{name}.layers.{i}.conv_stack2", P, c["mel_n_stack"],
                                   c["mel_n_block"], k)
    return conv(out, W, name + ".last_layer", P, padding=(k - 1) // 2)


def mha(xq, xkv, W, name, P, n_heads, key_lens=None):
    B, Tq, D = xq.shape
    dh = D // n_heads
    q = linear(xq, W, name + ".w_q", P).view(B, Tq, n_heads, dh)
    k = linear(xkv, W, name + ".w_k", P).view(B, -1, n_heads, dh)
    v = linear(xkv, W, name + ".w_v", P).view(B, -1, n_heads, dh)
    return linear(attention(q, k, v, P, key_lens).reshape(B, Tq, D), W, name + ".out_proj", P)


def tc_latent(W: Weights, c: dict, phone, phone_lens, mel, P: Precision):
    """The MRTE's content-timbre latent (B, Tp, hidden): embedded phones
    plus sinusoids through the masked conv-FF encoder, attending to the
    encoded mel prompt with one head, then LayerNorm and ReLU."""
    H = c["hidden_size"]
    x = W["mrte.phone_embedding.word_embeddings.weight"][phone]
    x = x + sinusoids(x.shape[1], H, x.device)
    ctx = mel_encoder(mel, W, c, P)
    for i in range(c["content_n_layers"]):
        p = f"mrte.phone_encoder.layers.{i}"
        x = x + mha(layer_norm(x, W, p + ".norm1"), layer_norm(x, W, p + ".norm1"), W,
                    p + ".attn", P, c["content_n_heads"], phone_lens)
        h = layer_norm(x, W, p + ".norm2")
        x = h + conv(F.relu(conv(h, W, p + ".ff_conv1", P, padding=2)), W, p + ".ff_conv2", P,
                     padding=2)
    return F.relu(layer_norm(mha(x, ctx, W, "mrte.mha", P, 1), W, "mrte.norm"))


def regulate(x, durations, T_out: int):
    """Frame f takes phone #(cumsum(durations) <= f); frames past the sum are 0."""
    ends = torch.cumsum(durations.long(), dim=1)
    frames = torch.arange(T_out, device=x.device)
    idx = (ends[:, None, :] <= frames[None, :, None]).sum(-1).clamp(max=x.shape[1] - 1)
    out = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))
    return out * (frames[None, :] < ends[:, -1:])[..., None]


def max_pool8(x):
    return F.max_pool1d(x.transpose(1, 2), 8, 8, ceil_mode=True).transpose(1, 2)


def mel_decoder(W: Weights, c: dict, tc_frames, codes, P: Precision):
    """Codebook rows ×8 beside the frame-rate latents, through the ConvNet
    decoder → (B, T, 80)."""
    k = c["kernel_size"]
    zq = W["vqpe.vq.layers.0._codebook.embed"][codes].repeat_interleave(8, dim=1)
    x = torch.cat([tc_frames, zq[:, : tc_frames.shape[1]]], dim=-1)
    x = conv(x, W, "decoder.first_layer", P, padding=(k - 1) // 2)
    x = residual_stack(x, W, "decoder.conv_stack", P, c["decoder_n_stack"], c["decoder_n_block"], k)
    return conv(x, W, "decoder.last_layer", P, padding=(k - 1) // 2)


# ---------------------------------------------------------------- decoders


def decoder_stack(x, W: Weights, name: str, n_layers: int, n_heads: int, P: Precision,
                  key_lens=None, quant: bool = False, keep: Optional[list] = None,
                  rate: float = 0.0):
    """Pre-LN causal layers with linear FF; ``keep`` (a list of bool masks,
    two a layer: the attention output's, then the FF hidden's) applies
    dropout at ``rate``."""
    B, T, D = x.shape
    dh = D // n_heads
    masks = iter(keep or ())

    def drop(h):
        return h if keep is None else torch.where(next(masks), h / (1.0 - rate), 0.0)

    for i in range(n_layers):
        p = f"{name}.layers.{i}"
        qkv = linear(layer_norm(x, W, p + ".norm1"), W, p + ".attn.qkv", P, quant=quant)
        q, k, v = (t.reshape(B, T, n_heads, dh) for t in qkv.split(D, dim=-1))
        att = attention(q, k, v, P, key_lens, causal=True).reshape(B, T, D)
        x = P.store(x + drop(linear(att, W, p + ".attn.out_proj", P, quant=quant)))
        h = drop(F.relu(linear(layer_norm(x, W, p + ".norm2"), W, p + ".ff_linear1", P,
                               quant=quant)))
        x = P.store(x + linear(h, W, p + ".ff_linear2", P, quant=quant))
    return x


def adm_raw(W: Weights, c: dict, tc, fed, P: Precision):
    """The ADM's raw duration predictions (B, Tp) teacher-forced: step t
    takes the raw prediction ``fed[:, t - 1]`` (0 at the first step) as the
    greedy decode feeds back its own, in one causal pass."""
    B, T, _ = tc.shape
    d_model = c["emb_dim"] + c["tc_emb_dim"]
    tc_emb = P.store(P.act(tc) @ P.weight(W["tc_linear_emb.weight"]).T)
    prev = torch.cat([torch.zeros_like(fed[:, :1]), fed[:, :-1]], dim=1)
    dt_emb = P.store(P.act(prev[..., None]) @ P.weight(W["dt_linear_emb.weight"]).T)
    x = P.store(torch.cat([tc_emb, dt_emb], dim=-1) + P.store(sinusoids(T, d_model, tc.device)))
    h = decoder_stack(x, W, "adm", c["n_layers"], c["n_heads"], P)
    return P.store(P.act(h) @ P.weight(W["predict_layer.weight"]).T)[..., 0]


def plm_logits(W: Weights, c: dict, tc_codes, prev_codes, P: Precision, quant: bool,
               lens=None, keep=None):
    """Teacher-forced PLM logits (B, T, vq_bins): input t is the code-rate
    latent beside the embedded previous code, plus sinusoids; causal
    layers; bias-free head.  ``quant``: the Linear layers are weight-only
    at ``P.quant_bits``."""
    d_model = c["vq_dim"] + c["tc_latent_dim"]
    x = torch.cat([tc_codes, W["pc_embedding.weight"][prev_codes]], dim=-1)
    x = x + sinusoids(x.shape[1], d_model, x.device)
    x = decoder_stack(x, W, "plm", c["n_layers"], c["n_heads"], P, lens, quant, keep,
                      c.get("dropout", 0.0))
    return linear(x, W, "predict_layer", P, bias=False, quant=quant)


# ---------------------------------------------------------------- vocoder


def vocos(W: Weights, c: dict, mel, P: Precision):
    """Vocos: embed conv, ConvNeXt blocks (depthwise k=7, LN, GELU MLP,
    layer scale), LN, the fp32 head to log-magnitude and phase, the last
    frame repeated, inverse STFT → (B, T * hop)."""
    x = layer_norm(conv(mel, W, "embed", P, padding=3), W, "norm_pre", 1e-6)
    for i in range(c["num_layers"]):
        p = f"block.{i}"
        h = layer_norm(conv(x, W, p + ".dwconv", P, padding=3, groups=x.shape[-1]), W,
                       p + ".norm", 1e-6)
        h = linear(gelu_tanh(linear(h, W, p + ".pwconv1", P)), W, p + ".pwconv2", P)
        x = x + W[p + ".gamma"] * h
    h = layer_norm(x, W, "norm_post", 1e-6) @ W["head.weight"].T + W["head.bias"]
    n_freq = c["n_fft"] // 2 + 1
    mag = torch.clamp(torch.exp(h[..., :n_freq]), max=c["mag_clip"])
    spec = torch.polar(mag, h[..., n_freq:])
    spec = torch.cat([spec, spec[:, -1:]], dim=1)
    window = torch.hann_window(c["n_fft"], periodic=True, device=mel.device)
    return torch.istft(spec.transpose(1, 2), c["n_fft"], c["hop_length"], c["n_fft"], window,
                       center=True)


# ---------------------------------------------------------------- PLM training


def plm_loss(W: Weights, c: dict, batch: dict, P: Precision, keep) -> torch.Tensor:
    """The summed cross-entropy of a teacher-forced PLM batch over every
    target that is not EOS (vq_bins + 1)."""
    codes = batch["p_codes"].long()
    logits = plm_logits(W, c, batch["tc_latents"].float(), codes[:, :-1], P, False,
                        batch["lens"], keep)
    target = codes[:, 1:]
    valid = target != c["vq_bins"] + 1
    nll = -torch.log_softmax(logits, -1).gather(-1, target.masked_fill(~valid, 0)[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum()


def cosine_warmup_lr(step: int, lr: float, warmup: int, total: int) -> float:
    """Linear warmup to ``lr``, then half a cosine down to 0 at ``total``."""
    if step < warmup:
        return lr * step / max(1.0, float(warmup))
    progress = (step - warmup) / max(1.0, float(total - warmup))
    return lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * progress)))


def train_plm(W: Weights, c: dict, opt_cfg: dict, batches: list, keeps: list, start_step: int,
              P: Precision, rows: Optional[int] = None) -> dict:
    """``len(batches)`` AdamW steps of the PLM from ``W`` (fp32 masters),
    the learning rate at update count ``start_step`` first.  Each step's
    loss and gradient are summed over blocks of ``rows`` rows (all at
    once when None), so that the attention's (rows, H, T, T) tensors fit.
    Returns each step's loss, each leaf's first gradient and each leaf's
    change over all the steps."""
    params = {k: v.clone().requires_grad_(True) for k, v in W.items()}
    b1, b2, eps, wd = opt_cfg["b1"], opt_cfg["b2"], opt_cfg["eps"], opt_cfg["weight_decay"]
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first_grad = [], None
    for i, (batch, keep) in enumerate(zip(batches, keeps)):
        B = batch["p_codes"].shape[0]
        step = rows or B
        grads = {k: torch.zeros_like(p) for k, p in params.items()}
        loss_sum = 0.0
        for a in range(0, B, step):
            part = {k: v[a: a + step] for k, v in batch.items()}
            loss = plm_loss(params, c, part, P, [m[a: a + step] for m in keep])
            got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            loss_sum += float(loss.detach())
            with torch.no_grad():
                for k, g in zip(params, got):
                    if g is not None:
                        grads[k] += g
            del loss, got
        losses.append(loss_sum)
        lr = cosine_warmup_lr(start_step + i, opt_cfg["lr"], opt_cfg["warmup_steps"],
                              opt_cfg["max_steps"])
        with torch.no_grad():
            if first_grad is None:
                first_grad = {k: g.clone() for k, g in grads.items()}
            t = i + 1
            for k, p in params.items():
                g = grads[k]
                p.mul_(1 - lr * wd)
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[k] / (1 - b2 ** t)).sqrt() + eps
                p.sub_(lr * (m[k] / (1 - b1 ** t)) / denom)
        del grads
    with torch.no_grad():
        change = {k: p.detach() - W[k] for k, p in params.items()}
    return {"losses": losses, "first_grad": first_grad, "change": change}
