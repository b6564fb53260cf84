"""Plain PyTorch reference of Mega-TTS 2's VQ-GAN training step (stage 1):
the generator MegaG (VQ prosody encoder with its EMA codebook, MRTE,
ConvNet mel decoder), the multi-window discriminator and the two AdamWs,
against which the benchmark judges the port's ``make_gan_train_step``.

It imports nothing but ``torch``, ``numpy``, the standard library and
``benchmark/reference.py``: not the port, not JAX.  Weights arrive as a
flat ``{name: fp32 tensor}`` dict in the port's state-dict layout (MegaG's
under ``g.``, the discriminator's under ``d.``); the randomness of a step
(dropout keep masks, the codebook's sample rows, the window starts)
arrives as the lists the benchmark also hands the port through a
``Draws`` replay, in the order the port asks for them
(:func:`mask_shapes`).  Every product goes through a
:class:`reference.Precision`; the codebook's distances and statistics,
the LayerNorms, BatchNorms and losses are fp32 in every precision.

One step (:func:`train_gan`), as arXiv:2307.07218 and the reference
implementation (github.com/LSimon95/megatts2, ``config_gan.yaml``) train it:

* G's forward in train mode: the VQ prosody encoder over the 20 low mel
  bands (ConvNetDouble, max-pool middle) to ze; its codes, quantized rows
  and straight-through latents, repeated ×8; the MRTE (phone embedding and
  sinusoids, 8 masked self-attention layers with a conv FF, the mel
  prompt's ConvNetDouble with a stride-16 conv middle, one-head cross
  attention, LayerNorm, ReLU), length-regulated by the durations; the
  ConvNet decoder over both, to 80 bins;
* the codebook's update from every latent of the batch: dead codes
  (EMA mass under 2, before the update) replaced by sampled latents, then
  the EMA of the counts and sums (decay 0.99) and Laplace smoothing;
* commit and vq losses, both mean((q - ze)^2), the first reaching ze
  directly, the second through the straight-through latent;
* the discriminator's real and fake passes (LSGAN, 0.5 · mean((D(y) -
  1)^2) + 0.5 · mean(D(ŷ)^2)), BatchNorm updating its running statistics
  at each, then D's AdamW;
* G's loss against the updated D (a third BatchNorm update): L1(y, ŷ) +
  0.15 · commit + 0.05 · vq + 1.0 · 0.5 · mean((D(ŷ) - 1)^2), then G's
  AdamW, each optimizer on the cosine-warmup schedule over max_steps / 2.

Departures from the published description, each as the port (and the
JAX package it was held against) does it:

* BatchNorm is flax's: epsilon 0.8 (the reference passes 0.8 positionally
  into ``BatchNorm2d``'s eps), running = 0.9 · running + 0.1 · batch, the
  biased batch variance E[x^2] - E[x]^2;
* an expired code also takes its replacement into ``embed_avg`` and
  ``cluster_size`` 2 (the reference's expiry is overwritten by the same
  step's ``embed_avg / cluster_size``);
* one window start per window length, shared by the batch; a window
  longer than the batch's longest mel scores zero;
* the discriminator's dropout drops whole channels per example;
* the codebook is taken as a resumed run leaves it (``inited`` 1): the
  first batch's k-means initialisation is not part of this reference;
* ``codes`` may be given: the assignment is then teacher-forced with the
  judged side's codes (its latents stay the reference's own), as the
  synthesis check feeds the reference the served codes: bf16 latents take
  another of two close codes, and such a swap moves a code's statistics
  more than the rest of the step's rounding does.  :func:`code_gap`
  judges the assignment itself.

At the benchmark's sizes G runs in blocks of ``rows`` rows, so that its
activations fit beside the program's state: a first pass without
gradients gives every latent and ŷ (G is row-wise except for the
codebook's statistics, which are taken over all the batch's latents, and
the loss means, weighted here by the whole batch's counts); the
discriminator runs on the whole batch at once, so BatchNorm sees the
batch's statistics; dL/dŷ is taken there and a second pass, with
gradients, back-propagates it block by block with the same masks.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import torch
import torch.nn.functional as F

from .reference import Precision, attention, cosine_warmup_lr, layer_norm, linear, sinusoids

Weights = Dict[str, torch.Tensor]

CONV_DROPOUT, D_DROPOUT, LEAKY = 0.1, 0.25, 0.2
BN_EPS, BN_MOMENTUM = 0.8, 0.9
DECAY, EPSILON, DEAD_CODE = 0.99, 1e-5, 2.0
CODEBOOK = "g.vqpe.vq.layers.0._codebook."
CODEBOOK_STATS = ("inited", "cluster_size", "embed", "embed_avg")


def is_statistic(name: str) -> bool:
    """A buffer a step updates (the codebook's, BatchNorm's running
    statistics), not a parameter the optimizers train."""
    return name.startswith(CODEBOOK) or (".bn." in name and name.endswith((".mean", ".var")))


# ---------------------------------------------------------------- draws


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _strided_len(T: int, s: int) -> int:
    """Output length of the MRTE's middle conv (kernel s + 1, stride s, padding s // 2)."""
    return (T + 2 * (s // 2) - (s + 1)) // s + 1


def mask_shapes(cfg: dict, B: int, T: int, Tp: int, Tm: int) -> List[tuple]:
    """(shape, rate) of every dropout keep mask of one step, in the order
    they are taken: G's forward (the prosody encoder's conv blocks; the
    MRTE's phone embedding, its sinusoids, the mel prompt's conv blocks,
    each self-attention's output, the cross-attention's output; the
    decoder's conv blocks), then the discriminator's real, fake and
    adversarial passes (per window, per conv block, one value a channel
    and example)."""
    g, m, v, d = cfg["g"], cfg["g"]["mrte"], cfg["g"]["vqpe"], cfg["d"]
    out = []

    def double(T0, T1, H, n_layers, n_stacks, n_blocks):
        for _ in range(n_layers):
            out.extend([((B, T0, H), CONV_DROPOUT)] * (n_stacks * n_blocks))
            out.extend([((B, T1, H), CONV_DROPOUT)] * (n_stacks * n_blocks))

    double(T, _ceil_div(T, v["stride"]), v["hidden_size"], v["n_layers"], v["n_stacks"],
           v["n_blocks"])
    H, r = m["hidden_size"], m["dropout"]
    out += [((B, Tp, H), r)] * 2
    double(Tm, _strided_len(Tm, m["mel_stride"]), H, m["mel_n_layer"], m["mel_n_stack"],
           m["mel_n_block"])
    out += [((B, Tp, H), r)] * (m["content_n_layers"] + 1)
    out += [((B, T, g["hidden_size"]), CONV_DROPOUT)] * (g["decoder_n_stack"]
                                                          * g["decoder_n_block"])
    out += [((B, 1, 1, d["hidden_size"]), D_DROPOUT)] * (3 * 3 * len(d["time_lengths"]))
    return [(s, rate) for s, rate in out if rate > 0]


# ---------------------------------------------------------------- layers


class _Masks:
    """A step's G masks in order, each sliced to the block's rows."""

    def __init__(self, masks: List[torch.Tensor], rows: slice):
        self.it: Iterator[torch.Tensor] = iter(masks)
        self.rows = rows

    def drop(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if rate == 0.0:
            return x
        return torch.where(next(self.it)[self.rows], x / (1.0 - rate), 0.0)


def conv1d(x, W: Weights, name: str, P: Precision, padding: int, stride: int = 1):
    """Conv1d on channels-last (B, T, C), the bias after the product."""
    y = F.conv1d(P.act(x).transpose(1, 2), P.weight(W[name + ".weight"]), stride=stride,
                 padding=padding)
    return P.out(y.transpose(1, 2)) + W[name + ".bias"]


def conv_block(x, W, name, P, k, masks: _Masks):
    """ReLU → dropout 0.1 → conv (same padding) → LayerNorm."""
    h = masks.drop(F.relu(x), CONV_DROPOUT)
    return layer_norm(conv1d(h, W, name + ".conv", P, (k - 1) // 2), W, name + ".norm")


def residual_stack(x, W, name, P, n_stacks, n_blocks, k, masks):
    for s in range(n_stacks):
        h = x
        for b in range(n_blocks):
            h = conv_block(h, W, f"{name}.conv_stacks.{s}.blocks.{b}", P, k, masks)
        x = x + h
    return x


def conv_net_double(x, W, name, P, n_layers, n_stacks, n_blocks, k, middle, masks):
    """First conv; ``n_layers`` branches of (stack, the shared middle,
    stack), summed; last conv."""
    x = conv1d(x, W, name + ".first_layer", P, (k - 1) // 2)
    out = 0
    for i in range(n_layers):
        h = residual_stack(x, W, f"{name}.layers.{i}.conv_stack1", P, n_stacks, n_blocks, k, masks)
        out = out + residual_stack(middle(h), W, f"{name}.layers.{i}.conv_stack2", P, n_stacks,
                                   n_blocks, k, masks)
    return conv1d(out, W, name + ".last_layer", P, (k - 1) // 2)


def attention_layer(xq, xkv, W, name, P, n_heads, key_lens=None):
    """q, k, v projections with bias, scaled dot-product attention over the
    keys below ``key_lens``, the output projection."""
    B, Tq, D = xq.shape
    dh = D // n_heads
    q = linear(xq, W, name + ".w_q", P).view(B, Tq, n_heads, dh)
    k = linear(xkv, W, name + ".w_k", P).view(B, -1, n_heads, dh)
    v = linear(xkv, W, name + ".w_v", P).view(B, -1, n_heads, dh)
    return linear(attention(q, k, v, P, key_lens).reshape(B, Tq, D), W, name + ".out_proj", P)


def regulate(x, durations, T_out: int):
    """Frame f takes phone #(cumsum(durations) <= f); frames past the sum are 0."""
    ends = torch.cumsum(durations.long(), dim=1)
    frames = torch.arange(T_out, device=x.device)
    idx = (ends[:, None, :] <= frames[None, :, None]).sum(-1).clamp(max=x.shape[1] - 1)
    out = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))
    return out * (frames[None, :] < ends[:, -1:])[..., None]


# ---------------------------------------------------------------- MegaG


def prosody_latents(W, g: dict, mel, P, masks: _Masks):
    """ze (B, ceil(T / stride), vq_dim): the prosody encoder over the
    ``mel_bins`` low bands."""
    v = g["vqpe"]
    s = v["stride"]

    def pool(h):
        return F.max_pool1d(h.transpose(1, 2), s, s, ceil_mode=True).transpose(1, 2)

    return conv_net_double(mel[..., : v["mel_bins"]], W, "g.vqpe.convnet", P, v["n_layers"],
                           v["n_stacks"], v["n_blocks"], v["kernel_size"], pool, masks)


def content_latents(W, m: dict, phone, phone_lens, mel, P, masks: _Masks):
    """The MRTE's phone-rate latent (B, Tp, hidden)."""
    s, r = m["mel_stride"], m["dropout"]
    x = masks.drop(W["g.mrte.phone_embedding.word_embeddings.weight"][phone.long()], r)
    x = masks.drop(x + sinusoids(x.shape[1], m["hidden_size"], x.device), r)

    def strided(h):
        return conv1d(h, W, "g.mrte.mel_encoder.middle_layer.conv", P, s // 2, s)

    ctx = conv_net_double(mel, W, "g.mrte.mel_encoder", P, m["mel_n_layer"], m["mel_n_stack"],
                          m["mel_n_block"], m["mel_kernel_size"], strided, masks)
    for i in range(m["content_n_layers"]):
        p = f"g.mrte.phone_encoder.layers.{i}"
        h = layer_norm(x, W, p + ".norm1")
        x = x + masks.drop(attention_layer(h, h, W, p + ".attn", P, m["content_n_heads"],
                                           phone_lens), r)
        h = layer_norm(x, W, p + ".norm2")
        x = h + conv1d(F.relu(conv1d(h, W, p + ".ff_conv1", P, 2)), W, p + ".ff_conv2", P, 2)
    tc = masks.drop(attention_layer(x, ctx, W, "g.mrte.mha", P, 1), r)
    return F.relu(layer_norm(tc, W, "g.mrte.norm"))


def decode(W, g: dict, frames, zq, P, masks: _Masks):
    """The ConvNet decoder over the frame-rate content latents beside the
    quantized prosody latents → (B, T, 80)."""
    k = g["kernel_size"]
    x = conv1d(torch.cat([frames, zq], dim=-1), W, "g.decoder.first_layer", P, (k - 1) // 2)
    x = residual_stack(x, W, "g.decoder.conv_stack", P, g["decoder_n_stack"],
                       g["decoder_n_block"], k, masks)
    return conv1d(x, W, "g.decoder.last_layer", P, (k - 1) // 2)


def nearest(ze: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Each latent's nearest code (squared L2 distance, fp32)."""
    flat = ze.reshape(-1, ze.shape[-1])
    dist = (flat * flat).sum(-1, keepdim=True) - 2.0 * flat @ embed.T + (embed * embed).sum(-1)
    return dist.argmin(-1).reshape(ze.shape[:-1])


def g_forward(W, cfg: dict, batch: dict, rows: slice, masks: _Masks, embed, P, codes=None):
    """G's forward in train mode over ``rows`` of the batch →
    {"ze", "codes", "q", "y_hat"}; the codes the nearest of ``embed`` (the
    codebook before this step's update), or ``codes``' rows (teacher
    forcing, and the second pass, which takes the first's)."""
    g = cfg["g"]
    b = {k: v[rows] for k, v in batch.items()}
    T = b["mel_targets"].shape[1]
    ze = prosody_latents(W, g, b["mel_targets"].float(), P, masks)
    with torch.no_grad():
        codes = nearest(ze.detach(), embed) if codes is None else codes[rows]
    q = embed[codes]
    zq = ze + (q - ze).detach()  # the straight-through latent
    zq = zq.repeat_interleave(g["vqpe"]["stride"], dim=1)[:, :T]
    tc = content_latents(W, g["mrte"], b["phone_tokens"], b["tokens_lens"],
                         b["mel_timbres"].float(), P, masks)
    frames = regulate(tc, b["duration_tokens"], T)
    return {"ze": ze, "codes": codes, "q": q, "y_hat": decode(W, g, frames, zq, P, masks)}


# ---------------------------------------------------------------- D


def batch_norm(x, W, name: str, running: Weights):
    """flax BatchNorm in train mode over (B, T, F) per channel; the running
    statistics take the batch's."""
    mean = x.mean((0, 1, 2))
    var = ((x * x).mean((0, 1, 2)) - mean * mean).clamp(min=0.0)
    with torch.no_grad():
        for stat, value in (("mean", mean), ("var", var)):
            running[f"{name}.{stat}"] = (BN_MOMENTUM * running[f"{name}.{stat}"]
                                         + (1 - BN_MOMENTUM) * value)
    return (x - mean) * (torch.rsqrt(var + BN_EPS) * W[name + ".scale"]) + W[name + ".bias"]


def discriminate(W, d: dict, mel, starts, max_len: int, masks: Iterator, running: Weights,
                 P: Precision):
    """The summed validity (B, 1) of the windows of ``mel`` (B, T, 80) at
    ``starts``: per window 3 × [conv 3×3 stride 2 → LeakyReLU 0.2 →
    dropout 0.25 of whole channels → BatchNorm (the first two)] → flatten
    (time, frequency, channel) → Linear."""
    x = mel[..., None]
    B, T = x.shape[:2]
    kh, kw = d["kernel"]
    total = 0.0
    for w, (wl, s) in enumerate(zip(d["time_lengths"], starts)):
        s = min(max(int(s), 0), T - wl)
        h = x[:, s: s + wl]
        p = f"d.disc.{w}"
        for i in range(3):
            y = F.conv2d(P.act(h).permute(0, 3, 1, 2), P.weight(W[f"{p}.conv.{i}.weight"]),
                         stride=2, padding=(kh // 2, kw // 2))
            h = F.leaky_relu(P.out(y.permute(0, 2, 3, 1)) + W[f"{p}.conv.{i}.bias"], LEAKY)
            h = torch.where(next(masks), h / (1.0 - D_DROPOUT), 0.0)
            if i < 2:
                h = batch_norm(h, W, f"{p}.bn.{i}", running)
        v = linear(h.reshape(B, -1), W, f"{p}.adv_layer", P)
        total = total + (v * 0.0 if wl > max_len else v)
    return total


# ---------------------------------------------------------------- the step


def _blocks(B: int, rows: Optional[int]) -> List[slice]:
    step = rows or B
    return [slice(a, min(a + step, B)) for a in range(0, B, step)]


def update_codebook(stats: Weights, ze_flat, codes_flat, repl_idx) -> None:
    """The codebook's update in place from all the batch's latents: codes
    whose mass is under ``DEAD_CODE`` replaced by the sampled latents, then
    the EMA of counts and sums and the smoothed means."""
    K = stats["cluster_size"].shape[0]
    size, avg = stats["cluster_size"], stats["embed_avg"]
    expired = size < DEAD_CODE
    repl = ze_flat[repl_idx]
    avg = torch.where(expired[:, None], repl, avg)
    size = torch.where(expired, torch.full_like(size, DEAD_CODE), size)
    counts = torch.bincount(codes_flat, minlength=K).float()
    sums = torch.zeros_like(avg).index_add_(0, codes_flat, ze_flat)
    size = size * DECAY + counts * (1 - DECAY)
    avg = avg * DECAY + sums * (1 - DECAY)
    total = size.sum()
    smoothed = (size + EPSILON) / (total + K * EPSILON) * total
    stats.update(cluster_size=size, embed_avg=avg, embed=avg / smoothed[:, None],
                 inited=torch.ones_like(stats["inited"]))


def _adamw(params: Weights, grads: Weights, m: Weights, v: Weights, t: int, lr: float,
           o: dict) -> None:
    for k, p in params.items():
        g = grads.get(k)
        if g is None:
            continue
        p.mul_(1 - lr * o["weight_decay"])
        m[k].mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
        v[k].mul_(o["b2"]).addcmul_(g, g, value=1 - o["b2"])
        p.sub_(lr * (m[k] / (1 - o["b1"] ** t)) / ((v[k] / (1 - o["b2"] ** t)).sqrt() + o["eps"]))


def train_gan(W: Weights, cfg: dict, batches: List[dict], draws: List[dict], start_step: int,
              P: Precision, rows: Optional[int] = None,
              codes: Optional[List[torch.Tensor]] = None) -> dict:
    """``len(batches)`` GAN steps from ``W`` (fp32), each with its draws
    ({"masks", "indices", "starts"}: the lists a ``Draws`` replays), the
    learning rate at update count ``start_step`` first; G in blocks of
    ``rows`` rows (all at once when None); ``codes``, one (B, T8) tensor a
    step, teacher-forces the assignment.  Returns each step's nine metrics,
    its latents, codes and the codebook they were assigned from, the first
    gradient and the change of every parameter, and the statistics after
    the last step."""
    o = cfg["train"]
    co, cv, ca = o["G_commit_loss_coeff"], o["G_vq_loss_coeff"], o["G_adv_loss_coeff"]
    params = {k: w.clone().requires_grad_(True) for k, w in W.items() if not is_statistic(k)}
    stats = {k: w.clone() for k, w in W.items() if is_statistic(k)}
    book = {s: stats[CODEBOOK + s] for s in CODEBOOK_STATS}
    g_names = [k for k in params if k.startswith("g.")]
    d_names = [k for k in params if k.startswith("d.")]
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v2 = {k: torch.zeros_like(p) for k, p in params.items()}
    out = {"metrics": [], "ze": [], "codes": [], "embed": []}
    first_grad = None
    for i, (batch, dr) in enumerate(zip(batches, draws)):
        B, T = batch["mel_targets"].shape[:2]
        lens = batch.get("mel_target_lens")
        max_len = min(int(lens.max()), T) if lens is not None else T
        n_g = len(dr["masks"]) - 9 * len(cfg["d"]["time_lengths"])  # D: 3 passes × 3 blocks
        g_masks, d_masks = dr["masks"][:n_g], iter(dr["masks"][n_g:])
        embed = book["embed"].clone()
        blocks = _blocks(B, rows)
        forced = None if codes is None else codes[i]
        with torch.no_grad():  # pass 1: every latent and ŷ
            parts = [g_forward(params, cfg, batch, r, _Masks(g_masks, r), embed, P, forced)
                     for r in blocks]
        ze = torch.cat([p["ze"] for p in parts])
        step_codes = torch.cat([p["codes"] for p in parts])
        y_hat = torch.cat([p["y_hat"] for p in parts])
        n_latent = ze.numel()
        commit = sum(float(((p["q"] - p["ze"]) ** 2).sum()) for p in parts) / n_latent
        update_codebook(book, ze.reshape(-1, ze.shape[-1]), step_codes.reshape(-1),
                        dr["indices"][0].long())
        del parts

        y = batch["mel_targets"].float()
        d_params = {k: params[k] for k in d_names}
        d_real = 0.5 * ((discriminate(params, cfg["d"], y, dr["starts"], max_len, d_masks,
                                      stats, P) - 1.0) ** 2).mean()
        d_fake = 0.5 * (discriminate(params, cfg["d"], y_hat, dr["starts"], max_len, d_masks,
                                     stats, P) ** 2).mean()
        got = torch.autograd.grad(d_real + d_fake, list(d_params.values()), allow_unused=True)
        grads = {k: gr for k, gr in zip(d_names, got)}
        lr = cosine_warmup_lr(start_step + i, o["initial_learning_rate"], o["warmup_steps"],
                              o["max_steps"] // 2)
        with torch.no_grad():
            _adamw(d_params, grads, m, v2, i + 1, lr, o)

        y_leaf = y_hat.detach().requires_grad_(True)
        g_adv = 0.5 * ((discriminate(params, cfg["d"], y_leaf, dr["starts"], max_len, d_masks,
                                     stats, P) - 1.0) ** 2).mean()
        g_re = (y - y_leaf).abs().mean()
        (dy,) = torch.autograd.grad(g_re + ca * g_adv, [y_leaf])
        g_grads = {k: torch.zeros_like(params[k]) for k in g_names}
        g_list = [params[k] for k in g_names]
        for r in blocks:  # pass 2: the same forward with gradients, block by block
            p = g_forward(params, cfg, batch, r, _Masks(g_masks, r), embed, P, step_codes)
            zq = p["ze"] + (p["q"] - p["ze"]).detach()
            loss = ((p["y_hat"] * dy[r]).sum()
                    + co * ((p["q"] - p["ze"]) ** 2).sum() / n_latent
                    + cv * ((p["ze"].detach() - zq) ** 2).sum() / n_latent)
            for k, gr in zip(g_names, torch.autograd.grad(loss, g_list, allow_unused=True)):
                if gr is not None:
                    g_grads[k] += gr
            del p, zq, loss
        grads.update(g_grads)
        with torch.no_grad():
            _adamw({k: params[k] for k in g_names}, g_grads, m, v2, i + 1, lr, o)
        if first_grad is None:
            first_grad = {k: gr.detach().clone() for k, gr in grads.items() if gr is not None}
        g_adv, g_re = float(g_adv.detach()), float(g_re.detach())
        g_loss = g_re + co * commit + cv * commit + ca * g_adv
        out["metrics"].append({
            "D_loss_total": float((d_real + d_fake).detach()),
            "D_loss_real": float(d_real.detach()), "D_loss_fake": float(d_fake.detach()),
            "G_loss_total": g_loss, "G_loss_adv": g_adv,
            "G_loss_re": g_re, "G_loss_commit": commit, "G_loss_vq": commit,
            "vq_code_usage": float((book["cluster_size"] > 1.0).float().mean())})
        out["ze"].append(ze)
        out["codes"].append(step_codes)
        out["embed"].append(embed)
        del grads, g_grads, y_hat, y_leaf, dy
    with torch.no_grad():
        out["change"] = {k: p.detach() - W[k] for k, p in params.items()}
    out["first_grad"] = first_grad
    stats.update({CODEBOOK + s: book[s] for s in CODEBOOK_STATS})
    out["stats"] = stats
    return out


def code_gap(ze: torch.Tensor, embed: torch.Tensor, codes: torch.Tensor) -> float:
    """How much farther ``codes`` lie from the latents ``ze`` than their
    nearest codes of ``embed``, over the mean nearest distance:
    mean(d(ze, e[codes]) - d(ze, e_best)) / mean(d(ze, e_best)), squared
    L2 in fp32; 0 when every code is the nearest, infinite when ``codes``
    do not cover the latents one to one."""
    flat = ze.reshape(-1, ze.shape[-1]).float()
    if codes.numel() != flat.shape[0]:
        return float("inf")
    embed = embed.float()
    dist = ((flat * flat).sum(-1, keepdim=True) - 2.0 * flat @ embed.T
            + (embed * embed).sum(-1)).clamp(min=0.0)
    best = dist.min(-1).values
    taken = dist.gather(-1, codes.reshape(-1, 1).long())[:, 0]
    return float((taken - best).mean() / best.mean().clamp(min=1e-30))
