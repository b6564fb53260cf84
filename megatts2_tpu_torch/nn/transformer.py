"""Pre-LN transformer encoder with self/cross attention (port of the
non-decode part of ``megatts2_tpu/nn/transformer.py``).

* MultiHeadAttention: q/k/v Linear with bias, optional cross-attention
  through ``kv=``, scaled dot-product attention with an fp32 softmax, then
  the output projection and train-mode dropout.  With ``k_lens`` given
  (self-attention only) it takes the masked flash attention of
  ``ops/attention.py``, through its autograd Function (kernels B with
  statistics and C on the card) when autograd records.
* TransformerEncoderLayer: pre-LN residual attention, then the conv FF
  Conv1d(k=5)-ReLU-Conv1d(k=5), where norm2 sits OUTSIDE the residual
  (``x = norm2(x) + ff(norm2(x))``), as in the reference; the FF has no
  dropout, as in JAX.  The JAX
  layer's linear-FF variant (the PLM's and ADM's layers) is
  ``models/fast_decode.DecoderLayer``, whose ``forward`` is the
  teacher-forced training forward and whose ``step`` is the decode.
* TransformerEncoder: N layers in a ``ModuleList``; the mask is built once
  from lengths (padding, optionally causal), or, with ``use_flash``, passed
  to the kernel as lengths.

Linear, LayerNorm and the convs compute in the dtype of their input
(``nn/layers.py``); dropout masks come from ``draws`` (``nn/dropout.py``),
``None`` in eval.  The KV-cached decode lives in ``models/fast_decode.py``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_attention
from ..ops.masks import causal_mask, make_attn_mask
from .convnet import ChannelsLastConv1d
from .dropout import Draws, dropout
from .layers import LayerNorm, Linear


def attend(
    q: torch.Tensor,  # (B, Tq, H, Dh)
    k: torch.Tensor,  # (B, Tk, H, Dh)
    v: torch.Tensor,  # (B, Tk, H, Dh)
    mask: Optional[torch.Tensor],  # additive (B|1, 1|H, Tq, Tk) fp32
) -> torch.Tensor:
    """QK^T accumulated in fp32 from operands in their own dtype (exact
    upcast), additive mask, fp32 softmax, probabilities cast back to the
    compute dtype for P V — the JAX ``_attend`` numerics."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class MultiHeadAttention(nn.Module):
    def __init__(self, qkv_dim: int, n_heads: int = 8, dropout: float = 0.0):
        super().__init__()
        if qkv_dim % n_heads:
            raise ValueError(f"qkv_dim {qkv_dim} is not a multiple of n_heads {n_heads}")
        self.n_heads = n_heads
        self.dropout = dropout
        self.w_q = Linear(qkv_dim, qkv_dim)
        self.w_k = Linear(qkv_dim, qkv_dim)
        self.w_v = Linear(qkv_dim, qkv_dim)
        self.out_proj = Linear(qkv_dim, qkv_dim)

    def forward(
        self,
        q: torch.Tensor,  # (B, Tq, D)
        kv: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        k_lens: Optional[torch.Tensor] = None,  # (B,): flash path
        causal: bool = False,
        draws: Optional[Draws] = None,
    ) -> torch.Tensor:
        B, Tq, D = q.shape
        src = q if kv is None else kv
        dh = D // self.n_heads
        # all heads, or this rank's under tensor parallelism (parallel/layers.py)
        qh = self.w_q(q).unflatten(-1, (-1, dh))
        kh = self.w_k(src).unflatten(-1, (-1, dh))
        vh = self.w_v(src).unflatten(-1, (-1, dh))
        if kv is None and k_lens is not None:
            att = flash_attention(qh, kh, vh, k_lens, causal)
        else:
            att = attend(qh, kh, vh, mask)
        return dropout(self.out_proj(att.flatten(2)), self.dropout, draws)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, dim: int, ff_dim: int, n_heads: int = 8, dropout: float = 0.0):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = MultiHeadAttention(dim, n_heads, dropout)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.ff_conv1 = ChannelsLastConv1d(dim, ff_dim, 5, padding=2)
        self.ff_conv2 = ChannelsLastConv1d(ff_dim, dim, 5, padding=2)

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        k_lens: Optional[torch.Tensor] = None,
        causal: bool = False,
        draws: Optional[Draws] = None,
    ) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), mask=mask, k_lens=k_lens, causal=causal, draws=draws)
        h = self.norm2(x)
        return h + self.ff_conv2(F.relu(self.ff_conv1(h)))


class TransformerEncoder(nn.Module):
    def __init__(
        self, dim: int, ff_dim: int, num_layers: int, n_heads: int = 8,
        use_flash: bool = False, dropout: float = 0.0,
    ):
        super().__init__()
        self.use_flash = use_flash
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(dim, ff_dim, n_heads, dropout) for _ in range(num_layers)
        )

    def forward(
        self,
        x: torch.Tensor,  # (B, T, D)
        x_lens: Optional[torch.Tensor] = None,  # (B,)
        causal: bool = False,
        draws: Optional[Draws] = None,
    ) -> torch.Tensor:
        B, T = x.shape[0], x.shape[1]
        mask = k_lens = None
        if x_lens is not None:
            if self.use_flash:
                k_lens = x_lens  # masks built in the kernel
            else:
                mask = make_attn_mask(x_lens, T, causal=causal)
        elif causal:
            if self.use_flash:
                k_lens = torch.full((B,), T, dtype=torch.int32, device=x.device)
            else:
                mask = causal_mask(T, device=x.device)
        for layer in self.layers:
            x = layer(x, mask=mask, k_lens=k_lens, causal=causal, draws=draws)
        return x
