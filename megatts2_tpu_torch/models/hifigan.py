"""HiFi-GAN V1 generator, the reference's vocoder (port of
``megatts2_tpu/models/hifigan.py``).

(B, T, 80) log-mel → (B, T*256) waveform in [-1, 1]: a k=7 conv to 512
channels, then per upsampling stage LeakyReLU → ``ConvTranspose1d(k, s,
padding=(k-s)//2)`` (output length T*s) → the mean of the multi-receptive-
field resblocks (k = 3, 7, 11, dilations 1/3/5 each), then LeakyReLU → a
k=7 conv to one channel → tanh.  Every LeakyReLU has the config's slope
0.1.  The JAX module's polyphase transposed conv and space-to-depth
resblocks are TPU layouts of these same functions and are not ported.
Channels-last (B, T, C) at the module's boundary, as in JAX.  The module
computes in the ``dtype`` its forward is given, as flax's ``HiFiGAN(cfg,
dtype=...)``: by default its first conv's weight dtype (a module cast for
synthesis), or bf16 over fp32 master weights in training, each conv's
bias added after its product and the LeakyReLU slope rounded to the dtype
as flax rounds them (``nn/layers.py``, ``nn/dropout.py`` ``in_dtype``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import HiFiGANConfig
from ..nn.convnet import ChannelsLastConv1d
from ..nn.dropout import in_dtype
from ..nn.layers import product_then_bias


class ChannelsLastConvTranspose1d(nn.ConvTranspose1d):
    """``nn.ConvTranspose1d`` on (B, T, C) input and output, computing in x's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return product_then_bias(x, self.weight, self.bias, lambda w, b: F.conv_transpose1d(
            x.transpose(1, 2), w, b, self.stride, self.padding, self.output_padding, self.groups,
            self.dilation).transpose(1, 2))


def _lrelu(x: torch.Tensor, slope: float) -> torch.Tensor:
    return F.leaky_relu(x, in_dtype(slope, x.dtype))


class ResBlock1(nn.Module):
    """MRF residual block: per dilation d, x += conv2(lrelu(conv1_d(lrelu(x))))."""

    def __init__(self, channels: int, kernel_size: int, dilations, lrelu_slope: float):
        super().__init__()
        k = kernel_size
        self.slope = lrelu_slope
        self.convs1 = nn.ModuleList(
            ChannelsLastConv1d(channels, channels, k, dilation=d, padding=(k - 1) * d // 2)
            for d in dilations
        )
        self.convs2 = nn.ModuleList(
            ChannelsLastConv1d(channels, channels, k, padding=(k - 1) // 2) for _ in dilations
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(_lrelu(c1(_lrelu(x, self.slope)), self.slope))
        return x


class HiFiGAN(nn.Module):
    def __init__(self, cfg: HiFiGANConfig = HiFiGANConfig()):
        super().__init__()
        c = cfg
        self.cfg = cfg
        ch0 = c.upsample_initial_channel
        self.conv_pre = ChannelsLastConv1d(c.in_channels, ch0, 7, padding=3)
        self.ups = nn.ModuleList(
            ChannelsLastConvTranspose1d(ch0 // 2**i, ch0 // 2 ** (i + 1), k, s, padding=(k - s) // 2)
            for i, (s, k) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes))
        )
        self.resblocks = nn.ModuleList(
            ResBlock1(ch0 // 2 ** (i + 1), rk, rd, c.lrelu_slope)
            for i in range(len(c.upsample_rates))
            for rk, rd in zip(c.resblock_kernel_sizes, c.resblock_dilation_sizes)
        )
        self.conv_post = ChannelsLastConv1d(ch0 // 2 ** len(c.upsample_rates), 1, 7, padding=3)

    def forward(self, mel: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """mel (B, T, 80) → waveform (B, T*256) in ``dtype`` (default: the
        first conv weight's)."""
        c = self.cfg
        n_k = len(c.resblock_kernel_sizes)
        x = self.conv_pre(mel.to(dtype or self.conv_pre.weight.dtype))
        for i, up in enumerate(self.ups):
            x = up(_lrelu(x, c.lrelu_slope))
            blocks = self.resblocks[i * n_k : (i + 1) * n_k]
            acc = blocks[0](x)
            for block in blocks[1:]:
                acc = acc + block(x)
            x = acc / n_k
        x = self.conv_post(_lrelu(x, c.lrelu_slope))
        return torch.tanh(x)[..., 0]
