"""Weight-only int8 / int4 quantization of the PLM's and ADM's Linear layers
(port of ``megatts2_tpu/quantization/weight_only.py``).

* :func:`quantize_kernel` — a (…, K, N) kernel in the flax layout (the
  contraction axis is -2) → (int kernel, fp32 per-N scale), symmetric per
  output channel.  ``bits=8`` gives int8; ``bits=4`` packs two 4-bit rows
  into one uint8 as (row k) low nibble | (row k + K/2) high nibble, so the
  packed array is (…, K/2, N) and its two nibble planes are the first and
  second HALF of K.  Both round half to even (``torch.round`` as
  ``jnp.round``), so the values and scales are bit-equal to JAX's.
* :func:`unpack_int4` and :func:`dequantize` invert it.
* :class:`QuantLinear` holds ``weight_q`` (out, in) int8 or (out, in/2)
  uint8, an fp32 ``scale`` (out,) and an optional fp32 ``bias``, all
  buffers.  Its product is ``fast_decode._dense``'s: operands rounded to
  the compute dtype, an fp32 accumulate and an fp32 result, then the fp32
  scale and bias, then a cast to the compute dtype (:func:`qdense`).
* :func:`quantize_` swaps every ``nn.Linear`` of a module for a
  :class:`QuantLinear` built from its weight; an odd contraction dim stays
  int8, as in ``quantize_tree``.  :func:`cast_float_` casts a module to the
  compute dtype except the quantized layers' fp32 scales and biases, which
  the JAX tree keeps fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def quantize_kernel(w: torch.Tensor, bits: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """(…, K, N) float kernel → (int8 (…, K, N) or packed uint8 (…, K/2, N),
    fp32 scale (…, N))."""
    w = w.detach().to(torch.float32)
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    qmax = 127.0 if bits == 8 else 7.0
    s = torch.clamp(w.abs().amax(dim=-2, keepdim=True) / qmax, min=1e-12)
    if bits == 8:
        return torch.round(w / s).to(torch.int8), s.squeeze(-2)
    K = w.shape[-2]
    if K % 2:
        raise ValueError(f"int4 packing needs an even contraction dim, got {K}")
    q = torch.clamp(torch.round(w / s), -7, 7).to(torch.int32)
    lo, hi = q[..., : K // 2, :], q[..., K // 2 :, :]
    return ((lo & 0xF) | ((hi & 0xF) << 4)).to(torch.uint8), s.squeeze(-2)


def unpack_int4(packed: torch.Tensor, dtype: torch.dtype = torch.float32):
    """Packed uint8 → (lo, hi), the first and second half of the
    contraction axis, in ``dtype`` (sign by the xor-sub trick)."""
    p = packed.to(torch.int32)
    return (((p & 0xF) ^ 8) - 8).to(dtype), (((p >> 4) ^ 8) - 8).to(dtype)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_kernel`: a (…, K, N) fp32 kernel."""
    if q.dtype == torch.uint8:
        q = torch.cat(unpack_int4(q), dim=-2)
    return q.to(torch.float32) * scale[..., None, :]


class QuantLinear(nn.Module):
    """A Linear with int8 or packed-int4 weights, an fp32 per-output scale
    and an optional fp32 bias (buffers, so they load by name)."""

    def __init__(self, in_features: int, out_features: int, bias: bool, bits: int = 8):
        super().__init__()
        if bits == 4 and in_features % 2:
            raise ValueError(f"int4 needs an even in_features, got {in_features}")
        self.in_features, self.out_features = in_features, out_features
        shape, dtype = ((out_features, in_features // 2), torch.uint8) if bits == 4 else \
            ((out_features, in_features), torch.int8)
        self.register_buffer("weight_q", torch.zeros(shape, dtype=dtype))
        self.register_buffer("scale", torch.ones(out_features))
        self.register_buffer("bias", torch.zeros(out_features) if bias else None)

    @classmethod
    def from_linear(cls, linear: nn.Linear, bits: int = 8) -> "QuantLinear":
        """Quantize ``linear``'s weight (read as fp32); an odd in_features
        stays int8."""
        bits = bits if linear.in_features % 2 == 0 else 8
        m = cls(linear.in_features, linear.out_features, linear.bias is not None, bits)
        q, s = quantize_kernel(linear.weight.T, bits)
        m.weight_q.copy_(q.T)
        m.scale.copy_(s)
        if linear.bias is not None:
            m.bias.copy_(linear.bias.detach().float())
        return m.to(linear.weight.device)

    @property
    def is_int4(self) -> bool:
        return self.weight_q.dtype == torch.uint8

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return qdense(self, x)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (…, K) @ w (N, K)^T with an fp32 result, both operands in x's dtype
    and products summed in fp32 (JAX ``preferred_element_type=float32``).

    A bf16 ``F.linear`` would round the sum to bf16 before the scale, which
    is not JAX's numerics.  On a CUDA tensor of a 16-bit type this is
    ``torch.mm(..., out_dtype=torch.float32)``; elsewhere the operands are
    widened to fp32, which is exact, and multiplied in fp32 (TF32 off, as
    PyTorch's default)."""
    w = w.to(x.dtype)
    if x.dtype == torch.float32:
        return F.linear(x, w)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda:
        y = torch.mm(x2, w.T, out_dtype=torch.float32)
    else:
        y = x2.float() @ w.float().T
    return y.reshape(*lead, w.shape[0])


def qdense(layer: QuantLinear, x: torch.Tensor) -> torch.Tensor:
    """``fast_decode._dense``'s quantized path on x in the compute dtype:
    fp32 accumulate, fp32 scale and bias, result cast to x's dtype.  Packed
    int4 runs two half-K products summed in fp32."""
    if layer.is_int4:
        lo, hi = unpack_int4(layer.weight_q, x.dtype)
        k2 = layer.weight_q.shape[1]
        acc = matmul_f32(x[..., :k2], lo) + matmul_f32(x[..., k2:], hi)
    else:
        acc = matmul_f32(x, layer.weight_q)
    y = acc * layer.scale
    if layer.bias is not None:
        y = y + layer.bias
    return y.to(x.dtype)


@torch.no_grad()
def quantize_(module: nn.Module, bits: int = 8) -> nn.Module:
    """Replace every ``nn.Linear`` under ``module`` by its
    :class:`QuantLinear`, in place; returns ``module``."""
    for name, child in list(module.named_children()):
        if isinstance(child, nn.Linear):
            setattr(module, name, QuantLinear.from_linear(child, bits))
        else:
            quantize_(child, bits)
    return module


def is_int4(module: nn.Module) -> bool:
    """True if any quantized layer under ``module`` holds packed int4."""
    return any(isinstance(m, QuantLinear) and m.is_int4 for m in module.modules())


def cast_float_(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast ``module``'s floating parameters and buffers to ``dtype`` in place,
    except those of its :class:`QuantLinear` layers, whose scales and biases
    stay fp32."""
    for m in module.modules():
        if isinstance(m, QuantLinear):
            continue
        for p in m.parameters(recurse=False):
            p.data = p.data.to(dtype)
        for name, b in m.named_buffers(recurse=False):
            if b.is_floating_point():
                m._buffers[name] = b.to(dtype)
    return module
