"""Vocos-style iSTFT vocoder (port of ``megatts2_tpu/models/vocos.py``).

(B, T, 80) log-mel → (B, T*hop) waveform.  A ConvNeXt backbone at mel
frame rate predicts STFT log-magnitude and phase; the head runs in fp32
(phase is precision-sensitive), repeats the last coefficient frame so that
the iSTFT's (T'-1)*hop samples come to T*hop, and ``ops/istft.py``
reconstructs the waveform.  GELU is the tanh approximation and the
LayerNorm epsilon is 1e-6, as in the flax module.

The backbone computes in the ``dtype`` its forward is given, as flax's
``Vocos(cfg, dtype=...)``: by default the embedding's weight dtype (a
module cast to bf16 for synthesis), or bf16 over fp32 master weights in
training, with the casts of ``nn/layers.py``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import VocosConfig
from ..nn.convnet import ChannelsLastConv1d
from ..nn.layers import LayerNorm, Linear, gelu_tanh
from ..ops.istft import istft


class ConvNeXtBlock(nn.Module):
    """Depthwise k=7 conv → LN → pointwise GELU MLP → layer-scaled residual,
    in x's dtype."""

    def __init__(self, dim: int, intermediate_dim: int):
        super().__init__()
        self.dwconv = ChannelsLastConv1d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.pwconv1 = Linear(dim, intermediate_dim)
        self.pwconv2 = Linear(intermediate_dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm(self.dwconv(x))
        h = self.pwconv2(gelu_tanh(self.pwconv1(h)))
        return x + self.gamma.to(x.dtype) * h


class Vocos(nn.Module):
    def __init__(self, cfg: VocosConfig = VocosConfig()):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.embed = ChannelsLastConv1d(c.in_channels, c.dim, 7, padding=3)
        self.norm_pre = LayerNorm(c.dim, eps=1e-6)
        self.block = nn.ModuleList(
            ConvNeXtBlock(c.dim, c.intermediate_dim) for _ in range(c.num_layers)
        )
        self.norm_post = LayerNorm(c.dim, eps=1e-6)
        self.head = nn.Linear(c.dim, 2 * (c.n_fft // 2 + 1))  # computes in fp32

    def forward(self, mel: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """mel (B, T, 80) → waveform (B, T*hop) fp32; the backbone in
        ``dtype`` (default: the embedding weight's)."""
        c = self.cfg
        x = self.norm_pre(self.embed(mel.to(dtype or self.embed.weight.dtype)))
        for block in self.block:
            x = block(x)
        x = self.norm_post(x)
        h = F.linear(x.float(), self.head.weight.float(), self.head.bias.float())
        n_freq = c.n_fft // 2 + 1
        logmag, phase = h[..., :n_freq], h[..., n_freq:]
        mag = torch.clamp(torch.exp(logmag), max=c.mag_clip)
        re = mag * torch.cos(phase)
        im = mag * torch.sin(phase)
        re = torch.cat([re, re[..., -1:, :]], dim=-2)
        im = torch.cat([im, im[..., -1:, :]], dim=-2)
        return istft(re, im, n_fft=c.n_fft, hop=c.hop_length, win_length=c.n_fft)
