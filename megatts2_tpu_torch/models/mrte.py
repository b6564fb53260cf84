"""MRTE — multi-reference timbre encoder (port of
``megatts2_tpu/models/mrte.py``).

Phone tokens are embedded and sine-position-encoded, then run through an
8-layer conv-FF transformer masked by ``phone_lens``; the mel prompt is
encoded by a ConvNetDouble whose shared middle layer is a stride-16 conv;
a single-head cross-attention (phone queries, mel keys and values), then
LayerNorm and ReLU give ``tc_latent``; ``forward`` length-regulates it to
frame rate.  With ``use_flash`` the phone encoder's masked self-attention
runs through the flash attention kernels (B, and C in training).  In
train mode dropout applies where JAX applies it, at ``MRTEConfig.dropout``
(the embeddings, each attention's output) and 0.1 (the conv blocks).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import MRTEConfig
from ..nn import (ConvNetDouble, Draws, LayerNorm, MultiHeadAttention, SinePositionalEmbedding,
                  TokenEmbedding, TransformerEncoder, train_draws)
from ..ops import regulate_length


class MRTE(nn.Module):
    def __init__(self, cfg: MRTEConfig = MRTEConfig()):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.phone_embedding = TokenEmbedding(c.hidden_size, c.phone_vocab_size, c.dropout)
        self.phone_pos_embedding = SinePositionalEmbedding(c.hidden_size, c.dropout)
        self.mel_encoder = ConvNetDouble(
            in_channels=c.mel_bins, out_channels=c.hidden_size, hidden_size=c.hidden_size,
            n_layers=c.mel_n_layer, n_stacks=c.mel_n_stack, n_blocks=c.mel_n_block,
            kernel_size=c.mel_kernel_size, activation=c.mel_activation,
            middle_kind="conv", middle_stride=c.mel_stride,
        )
        self.phone_encoder = TransformerEncoder(
            dim=c.hidden_size, ff_dim=c.content_ff_dim, num_layers=c.content_n_layers,
            n_heads=c.content_n_heads, use_flash=c.use_flash, dropout=c.dropout,
        )
        self.mha = MultiHeadAttention(c.hidden_size, n_heads=1, dropout=c.dropout)
        self.norm = LayerNorm(c.hidden_size, eps=1e-5)

    def tc_latent(
        self,
        phone: torch.Tensor,  # (B, Tp) int
        mel: torch.Tensor,  # (B, Tm, mel_bins)
        phone_lens: Optional[torch.Tensor] = None,  # (B,)
        draws: Optional[Draws] = None,
        dtype: Optional[torch.dtype] = None,
    ) -> torch.Tensor:
        """→ (B, Tp, hidden) in ``dtype`` (default the module's)."""
        dtype = self.norm.weight.dtype if dtype is None else dtype
        phone_x = self.phone_pos_embedding(self.phone_embedding(phone, draws, dtype), draws=draws)
        mel_context = self.mel_encoder(mel.to(dtype), draws)  # (B, ceil(Tm/16), H)
        phone_x = self.phone_encoder(phone_x, x_lens=phone_lens, draws=draws)
        tc = self.mha(phone_x, kv=mel_context, draws=draws)
        return F.relu(self.norm(tc))

    def forward(
        self,
        duration_tokens: torch.Tensor,  # (B, Tp) int frames per phone
        phone: torch.Tensor,  # (B, Tp)
        phone_lens: torch.Tensor,  # (B,)
        mel: torch.Tensor,  # (B, Tm, mel_bins)
        max_out_len: int,
        train: bool = False,
        draws: Optional[Draws] = None,
        dtype: Optional[torch.dtype] = None,
    ) -> torch.Tensor:
        """``tc_latent`` expanded to frame rate → (B, max_out_len, hidden);
        ``train`` takes its dropout masks from ``draws``."""
        tc = self.tc_latent(phone, mel, phone_lens, train_draws(train, draws), dtype)
        return regulate_length(tc, duration_tokens, max_out_len)
