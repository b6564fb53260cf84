"""Tensor-parallel layers: a Linear or channels-last Conv1d that holds one
model rank's slice of its weight (Megatron's column- and row-parallel
layers, the placement JAX's ``parallel/sharding.py`` gives these names).

:func:`shard_layer_` turns a layer into one in place: its class becomes a
subclass of its own with the parallel ``forward``, its weight (and a
column layer's bias) keep only this rank's slice, and ``tp_specs`` says
how each sliced parameter lies in the whole one.  Parameter names and
objects stay, so an optimizer built before keeps them.

* Column: the output features split; ``copy_to`` on the input (its
  gradient summed over the model group); ``gather`` layers (the PLM's code
  head) join their output over the group, the backward keeping this
  rank's slice.
* Row: the input features split; the partial products summed over the
  group (``reduce_from``), then the bias, added once.

The fused ``qkv`` of the PLM and ADM layers is column-parallel in three
parts: a rank takes its heads' slice of each of q, k and v
(:class:`ShardSpec` ``parts=3``), so it runs whole heads.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import product_then_bias
from .collectives import all_reduce, copy_to, gather_from, reduce_from


@dataclass(frozen=True)
class ShardSpec:
    """How a parameter's slice lies in the whole: axis ``dim`` of the whole
    is ``parts`` blocks, each cut in ``count`` equal slices; this rank holds
    slice ``index`` of every block."""

    dim: int
    index: int
    count: int
    group: Optional[object]
    parts: int = 1

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole ``full``."""
        blocks = full.unflatten(self.dim, (self.parts, self.count, -1))
        return blocks.select(self.dim + 1, self.index).flatten(self.dim, self.dim + 1).contiguous()

    def full(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor, gathered over the model group from each rank's slice."""
        s = local.shape[self.dim] // self.parts
        shape = list(local.shape)
        buf = local.new_zeros(shape[:self.dim] + [self.parts, self.count, s] + shape[self.dim + 1:])
        buf.select(self.dim + 1, self.index).copy_(local.unflatten(self.dim, (self.parts, s)))
        return all_reduce(buf, self.group).flatten(self.dim, self.dim + 2)

    def full_shape(self, local: torch.Size) -> list:
        shape = list(local)
        shape[self.dim] *= self.count
        return shape


def _product(layer: nn.Module, x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The layer's product with its (local) weight in x's dtype, channels last."""
    if isinstance(layer, nn.Conv1d):
        return product_then_bias(x, layer.weight, bias, lambda w, b: layer._conv_forward(
            x.transpose(1, 2), w, b).transpose(1, 2))
    return product_then_bias(x, layer.weight, bias, lambda w, b: F.linear(x, w, b))


class ModelParallel:
    """Mixin of a layer sharded over the model group (see the module docstring)."""

    tp_specs: dict
    tp_group: Optional[object]


class ColumnParallel(ModelParallel):
    tp_gather: bool = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _product(self, copy_to(x, self.tp_group), self.bias)
        if self.tp_gather:
            spec = self.tp_specs["weight"]
            y = gather_from(y, self.tp_group, spec.index, spec.count)
        return y


class RowParallel(ModelParallel):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = reduce_from(_product(self, x, None), self.tp_group)
        return y if self.bias is None else y + self.bias.to(y.dtype)


_CLASSES: dict = {}


def _parallel_class(mixin: type, cls: type) -> type:
    key = (mixin, cls)
    if key not in _CLASSES:
        _CLASSES[key] = type(f"{mixin.__name__}{cls.__name__}", (mixin, cls), {})
    return _CLASSES[key]


def shard_layer_(layer: nn.Module, kind: str, mesh, parts: int = 1, gather: bool = False) -> dict:
    """Make ``layer`` (an ``nn.Linear`` or ``nn.Conv1d``) ``"column"`` or
    ``"row"`` parallel over the mesh's model group, in place; returns its
    ``tp_specs`` (parameter name → :class:`ShardSpec`)."""
    index, count, group = mesh.model_rank, mesh.n_model, mesh.model_group
    if kind == "column":
        specs = {"weight": ShardSpec(0, index, count, group, parts)}
        if layer.bias is not None:
            specs["bias"] = ShardSpec(0, index, count, group, parts)
        mixin = ColumnParallel
    elif kind == "row":
        specs = {"weight": ShardSpec(1, index, count, group)}
        mixin = RowParallel
    else:
        raise ValueError(f"kind {kind!r} not in ('column', 'row')")
    with torch.no_grad():
        for name, spec in specs.items():
            p = getattr(layer, name)
            p.data = spec.local(p.data)
    layer.__class__ = _parallel_class(mixin, type(layer))
    layer.tp_specs, layer.tp_group = specs, group
    if gather:
        layer.tp_gather = True
    return specs


def tp_cols(layer: nn.Module) -> Optional[tuple[int, int]]:
    """(model rank, n_model) of a column-parallel layer's output, else None."""
    if not isinstance(layer, ColumnParallel) or layer.tp_gather:
        return None
    spec = layer.tp_specs["weight"]
    return spec.index, spec.count
