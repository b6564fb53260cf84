"""Linear and LayerNorm that compute in the dtype of their input, as flax's
``nn.Dense(dtype=...)`` and ``nn.LayerNorm(dtype=...)`` do over fp32
parameters.

* :func:`linear`: the weight and bias cast to x's dtype, then the product
  (:func:`product_then_bias`, which the convolutions share).
* :func:`layer_norm`: statistics, normalisation and affine in fp32, the
  output cast to x's dtype.

On a module already cast to x's dtype (the synthesis path) the casts are
no-ops, and LayerNorm is PyTorch's one kernel, which accumulates a bf16
input's statistics in fp32 itself and rounds once, as flax does (the four
casts around it cost more launches than the kernel, on a host-bound path);
in training they let bf16 compute run over fp32 master weights.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .dropout import in_dtype


def product_then_bias(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                      product: Callable, channel_dim: int = -1) -> torch.Tensor:
    """``product(w, b)`` with the weight and bias cast to x's dtype; its
    output's channels lie along ``channel_dim`` (channels-last by
    default).  In fp32 (or fp64) it is one fused call.  Below fp32 (bf16
    compute, over fp32 masters in training or over weights cast to bf16
    for synthesis) the product is rounded to x's dtype and the bias added
    after it, as flax's ``Dense`` and ``Conv`` with ``dtype=`` round: a
    fused bias rounds once, and that one ulp, grown through the GAN
    generator's layers or fed back through a decode loop, is as large as
    bf16's whole noise there."""
    w = weight.to(x.dtype)
    if bias is None or x.dtype in (torch.float32, torch.float64):
        return product(w, None if bias is None else bias.to(x.dtype))
    y = product(w, None)
    shape = [1] * y.dim()
    shape[channel_dim] = -1
    return y + bias.to(x.dtype).reshape(shape)


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return product_then_bias(x, layer.weight, layer.bias, lambda w, b: F.linear(x, w, b))


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    if norm.weight.dtype == x.dtype:  # a module cast to x's dtype: one kernel, fp32 inside
        return F.layer_norm(x, norm.normalized_shape, norm.weight, norm.bias, norm.eps)
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.gelu`` (the tanh form): 0.5 x (1 + tanh(sqrt(2/pi) (x +
    0.044715 x^3))).  In fp32 PyTorch's one kernel.  In another dtype the
    formula op by op, each result rounded to x's dtype and the constants
    too, as JAX computes it (x^3 as x (x x)); the one kernel rounds once at
    the end, a difference of up to an ulp that bf16 training grows."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    c, k = in_dtype(float(np.sqrt(2 / np.pi)), x.dtype), in_dtype(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * (x * x))))))


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self, x)


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(self, x)
