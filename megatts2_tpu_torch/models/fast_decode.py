"""The PLM's and ADM's decoder layers: the KV-cached greedy decode loops
(port of ``megatts2_tpu/models/fast_decode.py``) and the teacher-forced
full-sequence forward that training runs (port of the linear-FF
``TransformerEncoderLayer`` of ``megatts2_tpu/nn/transformer.py``).

Each decoder layer holds ONE merged q/k/v projection (the bridge
concatenates the JAX ``w_q``, ``w_k``, ``w_v`` at load time) and each layer
owns ONE (B, L, 2D) cache: k and v sit side by side in the projection's
output, so a step writes the cache with a single slice assignment of
``qkv[:, D:]``.  The cache is updated in place, which keeps one buffer per
layer for the whole decode.

Numerics follow the JAX loop: LayerNorm statistics in fp32, q·k products
accumulated in fp32 from compute-dtype operands, fp32 softmax, then P·V in
the compute dtype.  A step attends to cache positions ``<= t`` only, which
equals the JAX masked attention over the whole cache, since the masked
positions there carry exactly zero weight.

The training forward computes in the dtype of its input over fp32 master
weights, with the casts of flax's ``dtype=`` written out: a Dense casts its
weight and bias to the compute dtype, LayerNorm keeps fp32 statistics and
returns the compute dtype, and the residual stream stays in it.  Attention
is the masked flash attention of ``ops/attention.py`` (kernels B and C on
the card) under ``use_flash``, else the additive mask through
``nn/transformer.attend``, as the JAX encoder chooses.  Dropout sits after
the output projection and on the FF hidden, drawn from an explicit
``torch.Generator``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.transformer import attend
from ..ops.attention import flash_attention
from ..ops.masks import causal_mask, make_attn_mask


def dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.Dense(dtype=x.dtype)``: weight and bias cast to x's dtype."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=x.dtype)``: fp32 statistics and affine, output in x's dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps).to(x.dtype)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate and scale by its
    inverse; the identity at rate 0.  ``generator`` lives on x's device."""
    if rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class CachedSelfAttention(nn.Module):
    def __init__(self, dim: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.out_proj = nn.Linear(dim, dim)


class DecoderLayer(nn.Module):
    """Pre-LN transformer layer, one token per call (linear FF)."""

    def __init__(self, dim: int, ff_dim: int, n_heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = CachedSelfAttention(dim, n_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.ff_linear1 = nn.Linear(dim, ff_dim)
        self.ff_linear2 = nn.Linear(ff_dim, dim)

    def forward(
        self,
        x: torch.Tensor,  # (B, T, D) in the compute dtype
        mask: Optional[torch.Tensor],  # additive (B|1, 1, T, T), or None on the flash path
        k_lens: Optional[torch.Tensor],  # (B,) on the flash path
        causal: bool,
        rate: float,
        generator: Optional[torch.Generator],
    ) -> torch.Tensor:
        """Teacher-forced pre-LN layer over the whole sequence:
        x + drop(out_proj(attn(norm1 x))), then
        x + linear2(drop(relu(linear1(norm2 x))))."""
        B, T, D = x.shape
        H = self.attn.n_heads
        qkv = dense(self.attn.qkv, layer_norm(self.norm1, x))  # (B, T, 3D): q, k, v side by side
        q, k, v = (t.view(B, T, H, D // H) for t in qkv.split(D, dim=-1))
        if k_lens is not None:
            att = flash_attention(q, k, v, k_lens, causal)
        else:
            att = attend(q, k, v, mask)
        x = x + dropout(dense(self.attn.out_proj, att.reshape(B, T, D)), rate, generator)
        h = dropout(F.relu(dense(self.ff_linear1, layer_norm(self.norm2, x))), rate, generator)
        return x + dense(self.ff_linear2, h)

    def step(self, x: torch.Tensor, ckv: torch.Tensor, t: int) -> torch.Tensor:
        """x (B, D) at position t; writes this token's k and v into ``ckv``
        (B, L, 2D) in place and returns the layer's output (B, D)."""
        B, D = x.shape
        H = self.attn.n_heads
        dh = D // H
        qkv = self.attn.qkv(self.norm1(x))
        ckv[:, t] = qkv[:, D:]
        q = qkv[:, :D].view(B, H, 1, dh)
        k = ckv[:, : t + 1, :D].view(B, t + 1, H, dh).transpose(1, 2)
        v = ckv[:, : t + 1, D:].view(B, t + 1, H, dh).transpose(1, 2)
        logits = (q.float() @ k.float().transpose(-1, -2)) * dh**-0.5  # (B, H, 1, t+1)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        ctx = (probs @ v).reshape(B, D)
        x = x + self.attn.out_proj(ctx)
        return x + self.ff_linear2(F.relu(self.ff_linear1(self.norm2(x))))


class DecoderStack(nn.Module):
    def __init__(
        self, dim: int, ff_dim: int, num_layers: int, n_heads: int, dropout: float = 0.0,
        use_flash: bool = False,
    ):
        super().__init__()
        self.dropout = dropout
        self.use_flash = use_flash
        self.layers = nn.ModuleList(DecoderLayer(dim, ff_dim, n_heads) for _ in range(num_layers))

    def forward(
        self,
        x: torch.Tensor,  # (B, T, D) in the compute dtype
        x_lens: Optional[torch.Tensor] = None,  # (B,)
        causal: bool = False,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """The whole sequence through every layer; the mask is built once from
        the lengths (padding, optionally causal) or, with ``use_flash``,
        passed to the kernel as lengths."""
        B, T = x.shape[0], x.shape[1]
        mask = k_lens = None
        if x_lens is not None:
            if self.use_flash:
                k_lens = x_lens
            else:
                mask = make_attn_mask(x_lens, T, causal=causal)
        elif causal:
            if self.use_flash:
                k_lens = torch.full((B,), T, dtype=torch.int32, device=x.device)
            else:
                mask = causal_mask(T, device=x.device)
        rate = self.dropout if train else 0.0
        for layer in self.layers:
            x = layer(x, mask, k_lens, causal, rate, generator)
        return x

    def new_cache(self, B: int, L: int, like: torch.Tensor) -> list[torch.Tensor]:
        """One zeroed (B, L, 2D) buffer per layer, in ``like``'s dtype and device."""
        D = self.layers[0].norm1.normalized_shape[0]
        return [like.new_zeros(B, L, 2 * D) for _ in self.layers]

    def step(self, x: torch.Tensor, caches: list[torch.Tensor], t: int) -> torch.Tensor:
        for layer, ckv in zip(self.layers, caches):
            x = layer.step(x, ckv, t)
        return x


def plm_decode_step(
    model, tc_t: torch.Tensor, prev: torch.Tensor, caches: list[torch.Tensor], t: int
) -> torch.Tensor:
    """One PLM step: tc_t (B, D_tc), previous code (B,) → logits (B, vq_bins) fp32."""
    dtype = model.predict_layer.weight.dtype
    x = torch.cat([tc_t.to(dtype), model.pc_embedding(prev)], dim=-1)
    x = x + model.pe[t]
    x = model.plm.step(x, caches, t)
    return model.predict_layer(x).float()


@torch.inference_mode()
def plm_fast_decode(model, tc_latent: torch.Tensor) -> torch.Tensor:
    """Greedy prosody codes for every one of the T steps: tc_latent
    (B, T, D_tc) → (B, T) int64.  The first input code is BOS."""
    B, T, _ = tc_latent.shape
    dtype = model.predict_layer.weight.dtype
    tc = tc_latent.to(dtype)
    caches = model.plm.new_cache(B, T, tc)
    prev = torch.full((B,), model.cfg.bos_id, dtype=torch.long, device=tc.device)
    codes = []
    for t in range(T):
        prev = plm_decode_step(model, tc[:, t], prev, caches, t).argmax(dim=-1)
        codes.append(prev)
    return torch.stack(codes, dim=1)


@torch.inference_mode()
def adm_decode_raw(model, tc_latents: torch.Tensor) -> torch.Tensor:
    """Raw duration predictions (B, T) fp32.  Each step feeds back the
    previous RAW float prediction (0 at the first step), as the reference
    loop does."""
    B, T, _ = tc_latents.shape
    dtype = model.predict_layer.weight.dtype
    tc = tc_latents.to(dtype)
    caches = model.adm.new_cache(B, T, tc)
    prev = torch.zeros(B, dtype=torch.float32, device=tc.device)
    out = []
    for t in range(T):
        dt_emb = model.dt_linear_emb(prev[:, None].to(dtype))
        x = torch.cat([model.tc_linear_emb(tc[:, t]), dt_emb], dim=-1) + model.pe[t]
        x = model.adm.step(x, caches, t)
        prev = model.predict_layer(x)[:, 0].float()
        out.append(prev)
    return torch.stack(out, dim=1)


def adm_fast_decode(model, tc_latents: torch.Tensor) -> torch.Tensor:
    """Greedy durations (B, T) int64: raw + 0.5, truncated, clamped to
    [1, max_duration_token]."""
    raw = adm_decode_raw(model, tc_latents)
    return torch.clamp((raw + 0.5).to(torch.int32), 1, model.cfg.max_duration_token).long()
