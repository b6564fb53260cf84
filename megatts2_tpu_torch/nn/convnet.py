"""1-D convolutional stacks (port of ``megatts2_tpu/nn/convnet.py``).

Public layout is (B, T, C) channels-last, as in JAX; each convolution
transposes to PyTorch's (B, C, T) around ``conv1d`` and back, with its
weight and bias cast to the input's dtype (``layers.product_then_bias``).
* ConvBlock   = activation → dropout(0.1, train only) → Conv1d(same pad)
  → LayerNorm(channels)
* ResidualBlockStack = n_stacks × (x = x + ConvStack(x))
* ConvNet     = first conv → residual stacks → last conv
* ConvNetDouble = first conv → n_layers parallel (stack → middle → stack)
  branches SUMMED → last conv, with ONE middle layer shared by all
  branches: a strided conv (``middle_kind="conv"``, the MRTE's mel
  encoder) or MaxPool1d(stride, ceil_mode) (``"maxpool"``, the VQPE's).

Each ``forward`` takes ``draws`` (``nn/dropout.py``): train-mode dropout
draws its masks from it; ``None`` is eval.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .dropout import Draws, dropout, in_dtype
from .layers import LayerNorm, gelu_tanh, product_then_bias

CONV_DROPOUT = 0.1  # fixed in the reference's ConvBlock

_ACTS: dict[str, Callable] = {
    "ReLU": F.relu,
    "GELU": gelu_tanh,  # flax nn.gelu default
    "SiLU": F.silu,
    "Tanh": torch.tanh,
    "LeakyReLU": lambda x: F.leaky_relu(x, in_dtype(0.01, x.dtype)),
}


def get_activation(name: str) -> Callable:
    return _ACTS[name]


class ChannelsLastConv1d(nn.Conv1d):
    """``nn.Conv1d`` on (B, T, C) input and output, computing in x's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return product_then_bias(
            x, self.weight, self.bias,
            lambda w, b: self._conv_forward(x.transpose(1, 2), w, b).transpose(1, 2))


def same_conv(c_in: int, c_out: int, kernel_size: int) -> ChannelsLastConv1d:
    return ChannelsLastConv1d(c_in, c_out, kernel_size, padding=(kernel_size - 1) // 2)


class ConvBlock(nn.Module):
    def __init__(self, hidden_size: int, kernel_size: int, activation: str):
        super().__init__()
        self.act = get_activation(activation)
        self.conv = same_conv(hidden_size, hidden_size, kernel_size)
        self.norm = LayerNorm(hidden_size, eps=1e-5)

    def forward(self, x: torch.Tensor, draws: Optional[Draws] = None) -> torch.Tensor:
        return self.norm(self.conv(dropout(self.act(x), CONV_DROPOUT, draws)))


class ConvStack(nn.Module):
    def __init__(self, hidden_size: int, n_blocks: int, kernel_size: int, activation: str):
        super().__init__()
        self.blocks = nn.ModuleList(
            ConvBlock(hidden_size, kernel_size, activation) for _ in range(n_blocks)
        )

    def forward(self, x: torch.Tensor, draws: Optional[Draws] = None) -> torch.Tensor:
        for block in self.blocks:
            x = block(x, draws)
        return x


class ResidualBlockStack(nn.Module):
    def __init__(
        self, hidden_size: int, n_stacks: int, n_blocks: int, kernel_size: int, activation: str
    ):
        super().__init__()
        self.conv_stacks = nn.ModuleList(
            ConvStack(hidden_size, n_blocks, kernel_size, activation) for _ in range(n_stacks)
        )

    def forward(self, x: torch.Tensor, draws: Optional[Draws] = None) -> torch.Tensor:
        for stack in self.conv_stacks:
            x = x + stack(x, draws)
        return x


class StridedConvMiddle(nn.Module):
    """Downsampling middle layer: Conv1d(k=stride+1, s=stride, p=stride//2),
    output length ceil(T / stride)."""

    def __init__(self, hidden_size: int, stride: int):
        super().__init__()
        self.conv = ChannelsLastConv1d(
            hidden_size, hidden_size, stride + 1, stride=stride, padding=stride // 2
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class MaxPoolMiddle(nn.Module):
    """MaxPool1d(stride, ceil_mode=True): output length ceil(T / stride),
    the last window over the frames that remain (JAX pads it with -inf)."""

    def __init__(self, stride: int):
        super().__init__()
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool1d(x.transpose(1, 2), self.stride, self.stride,
                            ceil_mode=True).transpose(1, 2)


class ConvNet(nn.Module):
    def __init__(
        self, in_channels: int, out_channels: int, hidden_size: int, n_stacks: int,
        n_blocks: int, kernel_size: int, activation: str,
    ):
        super().__init__()
        self.first_layer = same_conv(in_channels, hidden_size, kernel_size)
        self.conv_stack = ResidualBlockStack(
            hidden_size, n_stacks, n_blocks, kernel_size, activation
        )
        self.last_layer = same_conv(hidden_size, out_channels, kernel_size)

    def forward(self, x: torch.Tensor, draws: Optional[Draws] = None) -> torch.Tensor:
        return self.last_layer(self.conv_stack(self.first_layer(x), draws))


class ConvNetDoubleLayer(nn.Module):
    def __init__(
        self, hidden_size: int, n_stacks: int, n_blocks: int, kernel_size: int, activation: str
    ):
        super().__init__()
        args = (hidden_size, n_stacks, n_blocks, kernel_size, activation)
        self.conv_stack1 = ResidualBlockStack(*args)
        self.conv_stack2 = ResidualBlockStack(*args)

    def forward(self, x: torch.Tensor, middle: nn.Module,
                draws: Optional[Draws] = None) -> torch.Tensor:
        return self.conv_stack2(middle(self.conv_stack1(x, draws)), draws)


class ConvNetDouble(nn.Module):
    """n_layers parallel downsampling branches, summed, sharing one middle
    layer: ``middle_kind`` "conv" (a strided conv, the one set of weights
    all branches use) or "maxpool"."""

    def __init__(
        self, in_channels: int, out_channels: int, hidden_size: int, n_layers: int,
        n_stacks: int, n_blocks: int, kernel_size: int, activation: str,
        middle_kind: str = "maxpool", middle_stride: int = 8,
    ):
        super().__init__()
        self.first_layer = same_conv(in_channels, hidden_size, kernel_size)
        if middle_kind == "conv":
            self.middle_layer = StridedConvMiddle(hidden_size, middle_stride)
        elif middle_kind == "maxpool":
            self.middle_layer = MaxPoolMiddle(middle_stride)
        else:
            raise ValueError(f"middle_kind {middle_kind!r} is neither 'conv' nor 'maxpool'")
        self.layers = nn.ModuleList(
            ConvNetDoubleLayer(hidden_size, n_stacks, n_blocks, kernel_size, activation)
            for _ in range(n_layers)
        )
        self.last_layer = same_conv(hidden_size, out_channels, kernel_size)

    def forward(self, x: torch.Tensor, draws: Optional[Draws] = None) -> torch.Tensor:
        x = self.first_layer(x)
        out = None
        for layer in self.layers:
            y = layer(x, self.middle_layer, draws)
            out = y if out is None else out + y
        return self.last_layer(out)
