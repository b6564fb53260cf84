"""Waveform discriminators for vocoder training, multi-period and
multi-scale, HiFi-GAN's topology (port of ``megatts2_tpu/models/wave_dscrm.py``).

* :class:`PeriodDiscriminator` (MPD, one per period p): the signal
  reflect-padded to a multiple of p and folded to (B, 1, T/p, p), then four
  (5, 1) convs of stride (3, 1) and padding (2, 0) with channels
  base·4^i (at most ``max_ch``), a (5, 1) conv, and a (3, 1) conv to one
  channel.
* :class:`ScaleDiscriminator` (MSD): seven 1-D convs over (B, 1, T), kernels
  15, 41 ×5 and 5, strides 1, 2, 2, 4, 4, 1, 1, padding k // 2, grouped
  min(g, in_channels) ways with g = 1, 4, 16, 16, 16, 16, 1, then a k=3 conv
  to one channel.
* :class:`WaveDiscriminator`: an MPD per period, then ``msd_scales`` MSDs on
  the raw signal and its successive ``AvgPool1d(4, 2, padding=2)`` (the
  padded zeros counted, as flax's ``avg_pool``).

Every conv but the last of each discriminator is followed by LeakyReLU of
the config's slope, rounded to the compute dtype as JAX rounds it.  The
modules compute in the ``dtype`` their forward is given, over weights of any
dtype (``nn/layers.py`` ``product_then_bias``: a bf16 product, then the
bias).  Returns (logits, features): per sub-discriminator its (B, -1)
logits and the outputs of each of its convs, in the compute dtype, in
PyTorch's channels-first layout ((B, C, T/p, p) and (B, C, T)); JAX's are
channels-last, and the flattened logits agree.  The JAX parameter tree's
names are kept (``mpd_<p>``, ``msd_<s>``, ``convs_<i>``, ``conv_post``), so
``bridge.load_flax_params`` loads it.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import WaveDiscConfig
from ..nn.dropout import in_dtype
from ..nn.layers import product_then_bias


def _conv(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (Conv1d or Conv2d, channels first) on x in x's dtype."""
    return product_then_bias(x, conv.weight, conv.bias, lambda w, b: conv._conv_forward(x, w, b),
                             channel_dim=1)


class PeriodDiscriminator(nn.Module):
    def __init__(self, period: int, base_ch: int = 32, max_ch: int = 1024, lrelu_slope: float = 0.1):
        super().__init__()
        self.period, self.slope = period, lrelu_slope
        chans = [1] + [min(base_ch * 4**i, max_ch) for i in range(4)]
        self.convs = nn.ModuleList(
            nn.Conv2d(chans[i], chans[i + 1], (5, 1), stride=(3, 1), padding=(2, 0)) for i in range(4))
        self.convs.append(nn.Conv2d(chans[4], min(base_ch * 4**4, max_ch), (5, 1), padding=(2, 0)))
        self.conv_post = nn.Conv2d(self.convs[-1].out_channels, 1, (3, 1), padding=(1, 0))

    def forward(self, wav: torch.Tensor, dtype: torch.dtype) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """wav (B, T) → (logits (B, -1), the six convs' outputs)."""
        p = self.period
        B, T = wav.shape
        pad = (-T) % p
        if pad:  # reflect-pad so that the fold is exact
            wav = F.pad(wav[:, None], (0, pad), mode="reflect")[:, 0]
        x = wav.reshape(B, 1, (T + pad) // p, p).to(dtype)
        slope = in_dtype(self.slope, dtype)
        feats = []
        for conv in self.convs:
            x = F.leaky_relu(_conv(conv, x), slope)
            feats.append(x)
        x = _conv(self.conv_post, x)
        feats.append(x)
        return x.reshape(B, -1), feats


# (kernel, stride, groups) of the MSD's convs; the channels are the config's
MSD_LAYERS = ((15, 1, 1), (41, 2, 4), (41, 2, 16), (41, 4, 16), (41, 4, 16), (41, 1, 16), (5, 1, 1))


class ScaleDiscriminator(nn.Module):
    def __init__(self, base_ch: int = 128, max_ch: int = 1024, lrelu_slope: float = 0.1):
        super().__init__()
        self.slope = lrelu_slope
        c, M = base_ch, max_ch
        outs = (c, c, min(2 * c, M), min(4 * c, M), min(8 * c, M), min(8 * c, M), min(8 * c, M))
        ins = (1,) + outs[:-1]
        self.convs = nn.ModuleList(
            nn.Conv1d(i, o, k, stride=s, padding=k // 2, groups=min(g, i))
            for i, o, (k, s, g) in zip(ins, outs, MSD_LAYERS))
        self.conv_post = nn.Conv1d(outs[-1], 1, 3, padding=1)

    def forward(self, wav: torch.Tensor, dtype: torch.dtype) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """wav (B, T) → (logits (B, -1), the eight convs' outputs)."""
        x = wav[:, None].to(dtype)
        slope = in_dtype(self.slope, dtype)
        feats = []
        for conv in self.convs:
            x = F.leaky_relu(_conv(conv, x), slope)
            feats.append(x)
        x = _conv(self.conv_post, x)
        feats.append(x)
        return x.reshape(x.shape[0], -1), feats


class WaveDiscriminator(nn.Module):
    """An MPD per period, then ``msd_scales`` MSDs (raw, ×2, ×4 pooled)."""

    def __init__(self, cfg: WaveDiscConfig = WaveDiscConfig()):
        super().__init__()
        c = cfg
        self.cfg = cfg
        for p in c.periods:
            self.add_module(f"mpd_{p}", PeriodDiscriminator(p, c.mpd_base_ch, c.max_ch, c.lrelu_slope))
        for s in range(c.msd_scales):
            self.add_module(f"msd_{s}", ScaleDiscriminator(c.msd_base_ch, c.max_ch, c.lrelu_slope))

    def forward(self, wav: torch.Tensor, dtype: torch.dtype = torch.float32):
        """wav (B, T) fp32 → (logits, features) over every sub-discriminator,
        the MPDs first; each sub-discriminator's features a list."""
        c = self.cfg
        logits, feats = [], []
        for p in c.periods:
            lg, f = getattr(self, f"mpd_{p}")(wav, dtype)
            logits.append(lg)
            feats.append(f)
        x = wav
        for s in range(c.msd_scales):
            if s > 0:
                x = F.avg_pool1d(x[:, None], 4, 2, padding=2, count_include_pad=True)[:, 0]
            lg, f = getattr(self, f"msd_{s}")(x, dtype)
            logits.append(lg)
            feats.append(f)
        return logits, feats
