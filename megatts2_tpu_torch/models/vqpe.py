"""VQPE — the vector-quantized prosody encoder (port of
``megatts2_tpu/models/vqpe.py``).

The low ``mel_bins`` (20) mel bands go through a ConvNetDouble whose
middle layer is MaxPool1d(stride 8, ceil_mode); the encoding ze, cast to
fp32, is quantized by a one-codebook EMA RVQ (1024 bins, dim 256, decay
0.99), and the quantized latents are repeated ×8 and cut to the mel's
length.  ``vq_loss`` is mean((sg(ze) - zq)^2) with zq the straight-through
output, as JAX writes it (so its gradient reaches ze through zq).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import VQPEConfig
from ..nn import ConvNetDouble, Draws, train_draws
from ..quantization import ResidualVectorQuantizer


class VQProsodyEncoder(nn.Module):
    def __init__(self, cfg: VQPEConfig = VQPEConfig()):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.convnet = ConvNetDouble(
            in_channels=c.mel_bins, out_channels=c.vq_dim, hidden_size=c.hidden_size,
            n_layers=c.n_layers, n_stacks=c.n_stacks, n_blocks=c.n_blocks,
            kernel_size=c.kernel_size, activation=c.activation, middle_kind="maxpool",
            middle_stride=c.stride,
        )
        self.vq = ResidualVectorQuantizer(dimension=c.vq_dim, n_q=1, bins=c.vq_bins)

    def forward(self, mel: torch.Tensor, train: bool = False, draws: Optional[Draws] = None,
                dtype: torch.dtype = torch.float32):
        """→ (zq (B, T, vq_dim) in ``dtype``, commit_loss, vq_loss, codes (1, B, ceil(T/8)))."""
        draws = train_draws(train, draws)
        ze = self.convnet(mel[..., : self.cfg.mel_bins].to(dtype), draws).float()
        zq, codes, commit_loss = self.vq(ze, train, draws)
        vq_loss = ((ze.detach() - zq) ** 2).mean()
        zq = zq.repeat_interleave(self.cfg.stride, dim=1)[:, : mel.shape[1]]
        return zq.to(dtype), commit_loss, vq_loss, codes
