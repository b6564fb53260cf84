"""Masked attention, forward and backward (port of
``megatts2_tpu/ops/attention_pallas.py``).

softmax(Q K^T * Dh^-0.5) V on (B, T, H, Dh) tensors.  The key-padding mask
comes from per-batch ``k_lens`` and the optional causal mask from positions;
masked logits are REPLACED by the finite -1e9, so a row whose keys are all
masked gives the mean of V rather than NaN.  Both products run in fp32 and
the output is in q's dtype.

* :func:`flash_attention_plain` — the Pallas kernel's math in plain
  PyTorch: upcast, ``where(mask, logits, -1e9)``, fp32 softmax numerator
  and denominator, fp32 P V.  Optionally returns the row max ``m`` and row
  sum ``l`` (B, H, Tq) that the backward recomputes P from.
* :func:`flash_attention_bwd_plain` — ``_fa_bwd``'s math in plain PyTorch,
  with its roundings of P and ds to q's dtype.
* :func:`flash_attention_cuda` / :func:`flash_attention_bwd_cuda` — kernel
  B (``csrc/flash_attn_fwd.cu``) and kernel C (``csrc/flash_attn_bwd.cu``).
  bf16 at head dims 64, 96, 128 and 256 takes their tensor-core path
  (``wgmma`` and TMA loads; :func:`uses_tensor_cores`); fp32, and bf16
  above 256, their SIMT path.  Any other head dim runs zero-padded to the
  next instance (:func:`instance_head_dim`, :func:`pad_head_dim`) at its own
  scale: up to 256 the next of :data:`HEAD_DIMS`, above it the next
  multiple of 256, which the SIMT kernels run in chunks of 256 columns.  The tensor-core path's forward
  splits P into bf16 hi + lo parts for P V (the row sum stays fp32).  TMA
  reads a tensor only from a 16-byte-aligned base with 16-byte strides
  (:func:`tma_aligned`).  The C launcher checks that rule before it
  launches; a view it refuses is copied and the launch made again
  (:func:`_launch_tma`), counted in each wrapper's ``layout_copies``.
* :class:`FlashAttentionFunction` — the ``custom_vjp``: forward by kernel B
  (plain on the CPU) saving q, k, v, k_lens, m and l; backward by kernel C
  (plain on the CPU).
* :func:`flash_attention` — dispatch by device (CPU → plain, CUDA →
  kernel), through the Function when autograd records.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .masks import NEG_INF

HEAD_DIMS = (64, 96, 128, 256)  # the kernels' template instances
WIDE_CHUNK = 256  # above 256 the SIMT kernels loop over chunks of this many columns
# bf16 head dims of kernels B's and C's tensor-core path: the PLM (64), the
# ADM at tc_emb_dim 512 (96; the tiles are 128 wide, TMA filling columns
# 96-127 with zeros) and the MRTE's phone encoder (256: two blocks split the
# output columns)
TC_HEAD_DIMS = (64, 96, 128, 256)


def instance_head_dim(head_dim: int) -> int:
    """The kernel instance a head dim runs on: the smallest of
    :data:`HEAD_DIMS` that holds it, above 256 the next multiple of
    :data:`WIDE_CHUNK`.  Any other head dim is zero-padded to it
    (:func:`pad_head_dim`)."""
    for d in HEAD_DIMS:
        if head_dim <= d:
            return d
    return -(-head_dim // WIDE_CHUNK) * WIDE_CHUNK


def pad_head_dim(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t (..., Dh) zero-padded to (..., dim), or t itself when Dh == dim.
    Zero columns of q and k add nothing to q.k, zero columns of v (and of
    the cotangent g) give zero columns of the output (and of dq, dk, dv),
    which the wrappers cut off; the scale stays that of the true Dh."""
    pad = dim - t.shape[-1]
    return t if pad == 0 else torch.nn.functional.pad(t, (0, pad))


def uses_tensor_cores(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether kernels B and C take their tensor-core path (``wgmma``, TMA)
    for this dtype and instance head dim: bf16 at :data:`TC_HEAD_DIMS`;
    otherwise their SIMT path runs."""
    return dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS


def tma_aligned(data_ptr: int, element_size: int, shape, strides) -> bool:
    """The rule a TMA tensor map sets: unit stride over the last dim, a
    16-byte-aligned base, and every other stride a multiple of 16 bytes
    (strides of extent-1 dims are never used and do not count)."""
    if strides[-1] != 1 or data_ptr % 16:
        return False
    return all(n == 1 or (st * element_size) % 16 == 0 for n, st in zip(shape[:-1], strides[:-1]))


def _tma_ready(t: torch.Tensor, wrapper) -> torch.Tensor:
    """t itself if TMA can read it, else a fresh aligned copy, counted on the
    wrapper (a layout adaptation: the kernel still runs)."""
    if tma_aligned(t.data_ptr(), t.element_size(), t.shape, t.stride()):
        return t
    wrapper.layout_copies += 1
    return t.clone(memory_format=torch.contiguous_format)


# cudaErrorMisalignedAddress: what the tensor-core launchers return, before
# they launch anything, for a tensor off TMA's rule
_MISALIGNED = 716


def _launch_tma(launch, tensors, wrapper) -> int:
    """``launch(*tensors)``'s error code on the tensor-core path.  The
    launcher checks TMA's rule itself, so an aligned call pays no check in
    Python; only when it refuses are the views off the rule copied
    (:func:`_tma_ready`, counted on ``wrapper``) and the launch made again."""
    err = launch(*tensors)
    if err == _MISALIGNED:
        ready = [_tma_ready(t, wrapper) for t in tensors]
        if any(r is not t for r, t in zip(ready, tensors)):
            err = launch(*ready)
    return err


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """fp32 accumulation, fp64 for fp64 inputs (gradcheck)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _masked_logits(q, k, k_lens, causal, scale) -> torch.Tensor:
    """where(mask, Q K^T * scale, -1e9), (B, H, Tq, Tk) in the accumulation dtype;
    the scale is Dh^-0.5 unless given."""
    B, Tq, _, Dh = q.shape
    Tk = k.shape[1]
    acc = _acc_dtype(q)
    scale = Dh**-0.5 if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    kpos = torch.arange(Tk, device=q.device)
    if k_lens is None:
        mask = torch.ones(B, 1, 1, Tk, dtype=torch.bool, device=q.device)
    else:
        mask = (kpos[None, :] < k_lens[:, None])[:, None, None, :]
    if causal:
        qpos = torch.arange(Tq, device=q.device)
        mask = mask & (kpos[None, :] <= qpos[:, None])[None, None]
    return logits.masked_fill(~mask, NEG_INF)


def flash_attention_plain(
    q: torch.Tensor,  # (B, Tq, H, Dh)
    k: torch.Tensor,  # (B, Tk, H, Dh)
    v: torch.Tensor,  # (B, Tk, H, Dh)
    k_lens: Optional[torch.Tensor] = None,  # (B,) valid key lengths
    causal: bool = False,
    return_stats: bool = False,
    scale: Optional[float] = None,  # Dh^-0.5 by default
):
    """Masked attention in plain PyTorch ops; output (B, Tq, H, Dh) in q.dtype,
    with ``return_stats`` also the row max and row sum (B, H, Tq)."""
    logits = _masked_logits(q, k, k_lens, causal, scale)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bhqd", p, v.to(p.dtype)) / denom
    out = out.permute(0, 2, 1, 3).to(q.dtype)
    return (out, m[..., 0], denom[..., 0]) if return_stats else out


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_lens: Optional[torch.Tensor],
    causal: bool,
    g: torch.Tensor,  # (B, Tq, H, Dh) cotangent of the output
    m: torch.Tensor,  # (B, H, Tq) row max from the forward
    l: torch.Tensor,  # (B, H, Tq) row sum from the forward
    scale: Optional[float] = None,  # Dh^-0.5 by default
):
    """(dq, dk, dv) as ``_fa_bwd`` computes them: P = exp(s - m) / l in fp32,
    P rounded to q's dtype for P^T g, D = rowsum(dp * P) from the fp32 P and
    dp, ds = P (dp - D) rounded to q's dtype for the dq and dk products."""
    acc = _acc_dtype(q)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    p = torch.exp(_masked_logits(q, k, k_lens, causal, scale) - m[..., None].to(acc)) / l[..., None].to(acc)
    g32 = g.to(acc)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).to(acc), g32)
    dp = torch.einsum("bqhd,bkhd->bhqk", g32, v.to(acc))
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(q.dtype).to(acc)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(acc)) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(acc)) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_qkv(q, k, v, k_lens, what: str) -> None:
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"{what} takes CUDA tensors")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v must all be float32 or all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q is (B, Tq, H, Dh); k and v are (B, Tk, H, Dh)")
    B, Tq, H, Dh = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, H, Dh):
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if Dh < 1:
        raise ValueError("empty head dim")
    if Tq == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("q, k and v need unit stride over the head dim")
    if k_lens is not None:
        if not k_lens.is_cuda or k_lens.device != q.device:
            raise ValueError("k_lens must be on the device of q")
        if k_lens.dtype != torch.int32 or k_lens.shape != (B,) or not k_lens.is_contiguous():
            raise ValueError("k_lens must be a contiguous (B,) int32 tensor")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _dtype_code(q: torch.Tensor, simt: bool) -> int:
    """The C entry points' ``is_bf16``: 0 fp32, 1 bf16, 2 bf16 on the SIMT path."""
    if q.dtype != torch.bfloat16:
        return 0
    return 2 if simt else 1


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_lens: Optional[torch.Tensor] = None,
    causal: bool = False,
    return_stats: bool = False,
    *,
    simt: bool = False,
):
    """Kernel B (``csrc/flash_attn_fwd.cu``).  Reads q, k, v in place through
    their strides; each needs unit stride over Dh.  With ``return_stats``
    also returns the row max and row sum, fp32 (B, H, Tq).  ``simt`` runs
    the SIMT path whatever the dtype and head dim, to compare the two.  A
    head dim that is no kernel instance runs zero-padded to the next one
    (:func:`instance_head_dim`) at the scale of its own."""
    _check_qkv(q, k, v, k_lens, "flash_attention_cuda")
    from ..csrc.build import check, load_library

    B, Tq, H, dh = q.shape
    Dh = instance_head_dim(dh)
    q, k, v = (pad_head_dim(t, Dh) for t in (q, k, v))
    tc = uses_tensor_cores(q.dtype, Dh) and not simt
    lib = load_library()
    out = torch.empty((B, Tq, H, Dh), dtype=q.dtype, device=q.device)
    m = l = None
    if return_stats:
        m = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)

    def launch(q, k, v):
        strides = [t.stride(i) for t in (q, k, v, out) for i in range(3)]
        with torch.cuda.device(q.device):
            return lib.mt_flash_attn_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(k_lens), out.data_ptr(),
                _ptr(m), _ptr(l), B, Tq, k.shape[1], H, Dh, *strides, int(causal), dh**-0.5,
                _dtype_code(q, not tc), torch.cuda.current_stream().cuda_stream,
            )

    err = _launch_tma(launch, (q, k, v), flash_attention_cuda) if tc else launch(q, k, v)
    check(err, "flash attention kernel")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.tc_launches += int(tc)
    flash_attention_cuda.causal_launches += int(causal)
    if flash_attention_cuda.shapes is not None:
        flash_attention_cuda.shapes.add((B, Tq, k.shape[1], H, dh, q.dtype, bool(causal), tc,
                                         k_lens is not None, return_stats))
    out = out[..., :dh]
    return (out, m, l) if return_stats else out


flash_attention_cuda.launches = 0
flash_attention_cuda.tc_launches = 0  # launches of the tensor-core path
flash_attention_cuda.causal_launches = 0  # causal launches (the prompt prefill, PLM training)
flash_attention_cuda.layout_copies = 0
# a set that each launch adds its (B, Tq, Tk, H, Dh, dtype, causal, tensor
# cores, lengths given, stats returned) to, or None: lets a caller check the
# kernel at every shape a path gave it
flash_attention_cuda.shapes = None


def flash_attention_bwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_lens: Optional[torch.Tensor],
    causal: bool,
    g: torch.Tensor,
    m: torch.Tensor,
    l: torch.Tensor,
    *,
    simt: bool = False,
):
    """Kernel C (``csrc/flash_attn_bwd.cu``): (dq, dk, dv) in q's dtype.
    q, k, v and g are read in place through their strides (unit stride over
    Dh; g is made contiguous otherwise); m and l are kernel B's statistics.
    ``simt`` runs the SIMT path whatever the dtype and head dim.  Other
    head dims run zero-padded, as the forward's."""
    _check_qkv(q, k, v, k_lens, "flash_attention_bwd_cuda")
    B, Tq, H, dh = q.shape
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"g must match q: {tuple(g.shape)} {g.dtype} vs {tuple(q.shape)} {q.dtype}")
    for name, t in (("m", m), ("l", l)):
        if t.shape != (B, H, Tq) or t.dtype != torch.float32 or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (B, H, Tq) float32 tensor on q's device")
    if g.stride(-1) != 1:
        g = g.contiguous()
    Dh = instance_head_dim(dh)
    q, k, v, g = (pad_head_dim(t, Dh) for t in (q, k, v, g))
    tc = uses_tensor_cores(q.dtype, Dh) and not simt
    from ..csrc.build import check, load_library

    lib = load_library()
    dq = torch.empty((B, Tq, H, Dh), dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    dsum = torch.empty_like(m)  # D = rowsum(dp * P), written by pass 1

    def launch(q, k, v, g):
        strides = (ctypes.c_longlong * 21)(
            *[t.stride(i) for t in (q, k, v, g, dq, dk, dv) for i in range(3)]
        )
        with torch.cuda.device(q.device):
            return lib.mt_flash_attn_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), _ptr(k_lens),
                m.data_ptr(), l.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), B, Tq, k.shape[1], H, Dh, strides, int(causal), dh**-0.5,
                _dtype_code(q, not tc), torch.cuda.current_stream().cuda_stream,
            )

    err = _launch_tma(launch, (q, k, v, g), flash_attention_bwd_cuda) if tc else launch(q, k, v, g)
    check(err, "flash attention backward kernel")
    flash_attention_bwd_cuda.launches += 1
    flash_attention_bwd_cuda.tc_launches += int(tc)
    if flash_attention_bwd_cuda.shapes is not None:
        flash_attention_bwd_cuda.shapes.add((B, Tq, k.shape[1], H, dh, q.dtype, bool(causal), tc,
                                             k_lens is not None))
    return dq[..., :dh], dk[..., :dh], dv[..., :dh]


flash_attention_bwd_cuda.launches = 0
flash_attention_bwd_cuda.tc_launches = 0  # launches of the tensor-core path
flash_attention_bwd_cuda.layout_copies = 0
flash_attention_bwd_cuda.shapes = None  # as flash_attention_cuda.shapes, without the stats flag


def _by_device(t: torch.Tensor, cuda_fn, plain_fn):
    if t.is_cuda:
        return cuda_fn
    if t.device.type == "cpu":
        return plain_fn
    raise ValueError(f"flash_attention: no implementation for device {t.device}")


class FlashAttentionFunction(torch.autograd.Function):
    """Masked attention with the recompute backward: kernels B and C on CUDA
    tensors, their plain versions on CPU tensors.  No gradient for
    ``k_lens`` or ``causal``."""

    @staticmethod
    def forward(ctx, q, k, v, k_lens, causal):
        fwd = _by_device(q, flash_attention_cuda, flash_attention_plain)
        out, m, l = fwd(q, k, v, k_lens, causal, return_stats=True)
        ctx.save_for_backward(q, k, v, k_lens, m, l)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, k_lens, m, l = ctx.saved_tensors
        bwd = _by_device(q, flash_attention_bwd_cuda, flash_attention_bwd_plain)
        dq, dk, dv = bwd(q, k, v, k_lens, ctx.causal, g.to(q.dtype), m, l)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_lens: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Masked attention: the CUDA kernels on CUDA tensors, the plain versions
    on CPU tensors, never falling back from one to the other.  Autograd goes
    through :class:`FlashAttentionFunction`; without it, inference runs the
    forward alone."""
    if k_lens is not None:
        k_lens = k_lens.to(torch.int32).contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, k_lens, causal)
    return _by_device(q, flash_attention_cuda, flash_attention_plain)(q, k, v, k_lens, causal)
