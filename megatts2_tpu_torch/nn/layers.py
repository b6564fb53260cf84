"""Linear and LayerNorm that compute in the dtype of their input, as flax's
``nn.Dense(dtype=...)`` and ``nn.LayerNorm(dtype=...)`` do over fp32
parameters.

* :func:`linear`: the weight and bias cast to x's dtype, then the product
  (:func:`product_then_bias`, which the convolutions share).
* :func:`layer_norm`: statistics, normalisation and affine in fp32, the
  output cast to x's dtype.

On a module already cast to x's dtype (the synthesis path) the casts are
no-ops, and LayerNorm is PyTorch's one kernel, which accumulates a bf16
input's statistics in fp32 itself (the four casts around it cost more
launches than the kernel, on a host-bound path); in training they let bf16
compute run over fp32 master weights.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn


def product_then_bias(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                      product: Callable) -> torch.Tensor:
    """``product(w, b)`` with the weight and bias cast to x's dtype; its
    output is channels-last.  Over weights of x's dtype it is one fused
    call.  Over weights of another dtype (bf16 compute over fp32 masters)
    the product is rounded to x's dtype and the bias added after it, as
    flax's ``Dense`` and ``Conv`` with ``dtype=`` round: a fused bias
    rounds once, and that one ulp, grown through the GAN generator's
    layers, is as large as bf16's whole noise there."""
    w = weight.to(x.dtype)
    if bias is None or weight.dtype == x.dtype:
        return product(w, None if bias is None else bias.to(x.dtype))
    return product(w, None) + bias.to(x.dtype)


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return product_then_bias(x, layer.weight, layer.bias, lambda w, b: F.linear(x, w, b))


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    if norm.weight.dtype == x.dtype:  # a module cast to x's dtype: one kernel, fp32 inside
        return F.layer_norm(x, norm.normalized_shape, norm.weight, norm.bias, norm.eps)
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps).to(x.dtype)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self, x)


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(self, x)
