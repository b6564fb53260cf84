"""Multi-window LSGAN mel discriminator (port of
``megatts2_tpu/models/dscrm.py``).

``SingleWindowDisc`` = 3 × [Conv2d 3×3 stride 2 → LeakyReLU(0.2) →
Dropout(0.25) of whole channels per example → BatchNorm (the first two
blocks)] → flatten → Linear → one validity per example.
``Discriminator`` clips a window of each of 32, 64 and 128 frames at the
given ``starts`` (one start per window, shared by the batch) and sums
their validities; a window longer than ``max_true_len`` still runs (its
BatchNorm statistics and dropout draws happen, as in JAX) but contributes
zero.

Activations stay (B, T, F, C) channels-last, JAX's layout: each conv runs
on a (B, C, T, F) view of them, and the flatten before ``adv_layer``
follows the channels-last order, so the JAX Dense kernel loads as it is.

BatchNorm is flax's, not ``nn.BatchNorm2d``: epsilon 0.8 (the reference
passes 0.8 positionally into BatchNorm2d's eps), running = 0.9 · running
+ 0.1 · batch, the batch variance biased and computed as E[x²] − E[x]²,
statistics and normalisation in fp32 whatever the compute dtype.  On a
data-parallel mesh (``mesh``, set by ``parallel.place_train_state``) the
batch statistics are the global batch's: the sums of x and x² are summed
over the data ranks, their gradient reaching every rank's rows.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..config import DiscriminatorConfig
from ..nn import Draws, Linear, dropout, in_dtype, product_then_bias, train_draws
from ..parallel.collectives import sum_over


EPSILON, MOMENTUM = 0.8, 0.9  # the reference's BatchNorm (see the module docstring)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis; parameters ``scale`` and
    ``bias``, running statistics ``mean`` and ``var`` (JAX's names)."""

    mesh = None  # the data-parallel mesh of a placed train state

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x32 = x.float()
        if train:
            axes = tuple(range(x.dim() - 1))
            if self.mesh is None or self.mesh.n_data == 1:
                mean, sq = x32.mean(axes), (x32 * x32).mean(axes)
            else:
                n = x32.numel() // x32.shape[-1] * self.mesh.n_data
                sums = sum_over(torch.stack([x32.sum(axes), (x32 * x32).sum(axes)]),
                                self.mesh.data_group)
                mean, sq = sums[0] / n, sums[1] / n
            var = (sq - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                self.mean.copy_(MOMENTUM * self.mean + (1 - MOMENTUM) * mean)
                self.var.copy_(MOMENTUM * self.var + (1 - MOMENTUM) * var)
        else:
            mean, var = self.mean, self.var
        return ((x32 - mean) * (torch.rsqrt(var + EPSILON) * self.scale)
                + self.bias).to(x.dtype)


def _halved(n: int, times: int = 3) -> int:
    for _ in range(times):
        n = (n + 1) // 2  # a 3-wide conv of stride 2 with padding 1
    return n


class SingleWindowDisc(nn.Module):
    def __init__(self, time_length: int, freq_length: int = 80, kernel=(3, 3), c_in: int = 1,
                 hidden_size: int = 128):
        super().__init__()
        pad = (kernel[0] // 2, kernel[1] // 2)
        self.conv = nn.ModuleList(
            nn.Conv2d(c_in if i == 0 else hidden_size, hidden_size, tuple(kernel), stride=2,
                      padding=pad) for i in range(3))
        self.bn = nn.ModuleList(BatchNorm(hidden_size) for _ in range(2))
        self.adv_layer = Linear(_halved(time_length) * _halved(freq_length) * hidden_size, 1)

    def forward(self, x: torch.Tensor, draws: Optional[Draws] = None):
        """x (B, T, F, C) → (validity (B, 1), the three blocks' outputs)."""
        h = []
        for i, conv in enumerate(self.conv):
            x = product_then_bias(x, conv.weight, conv.bias, lambda w, b: conv._conv_forward(
                x.permute(0, 3, 1, 2), w, b).permute(0, 2, 3, 1))
            x = F.leaky_relu(x, in_dtype(0.2, x.dtype))
            x = dropout(x, 0.25, draws, broadcast_dims=(1, 2))
            if i < 2:
                x = self.bn[i](x, train=draws is not None)
            h.append(x)
        return self.adv_layer(x.reshape(x.shape[0], -1)), h


class Discriminator(nn.Module):
    def __init__(self, cfg: DiscriminatorConfig = DiscriminatorConfig()):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.disc = nn.ModuleList(
            SingleWindowDisc(wl, c.freq_length, c.kernel, c.c_in, c.hidden_size)
            for wl in c.time_lengths)

    def forward(
        self,
        mel: torch.Tensor,  # (B, T, 80)
        starts: Sequence[int],  # one start frame per window
        train: bool = False,
        max_true_len: Optional[int] = None,  # longest un-padded mel
        draws: Optional[Draws] = None,
        dtype: torch.dtype = torch.float32,
    ) -> dict:
        """→ {"y": summed validity (B, 1) in ``dtype``, "h": the blocks' outputs}.
        A start is clamped so that its window fits, as ``dynamic_slice``."""
        draws = train_draws(train, draws)
        x = mel[..., None].to(dtype)  # (B, T, F, 1)
        T = x.shape[1]
        validity, hiddens = None, []
        for disc, wl, s in zip(self.disc, self.cfg.time_lengths, starts):
            if wl > T:
                raise ValueError(f"window of {wl} frames is longer than the mel's {T}")
            s = min(max(int(s), 0), T - wl)
            v, h = disc(x[:, s : s + wl], draws)
            if max_true_len is not None and wl > max_true_len:
                # a select, not zeros_like: v stays in the graph with a zero
                # gradient, so AdamW still steps and decays this window's
                # weights as optax does (a grad of None makes it skip them)
                v = torch.where(torch.zeros((), dtype=torch.bool, device=v.device), v, 0.0)
            validity = v if validity is None else validity + v
            hiddens.extend(h)
        return {"y": validity, "h": hiddens}
