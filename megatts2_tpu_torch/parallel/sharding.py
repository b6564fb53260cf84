"""Placement of a train state on the mesh: the tensor-parallel rules, ZeRO-1
over the data axis, and the full (one-device) view of a placed state that
checkpoints read and write (port of ``megatts2_tpu/parallel/sharding.py``).

The rules are JAX's ``_spec_for`` by module name: ``w_q``, ``w_k``,
``w_v``, ``ff_linear1``, ``ff_conv1`` and ``predict_layer`` are column
parallel (output features split), ``out_proj``, ``ff_linear2`` and
``ff_conv2`` row parallel (input features split, the bias added once
after the sum); the port's fused ``qkv`` is column parallel by head.  A
layer whose split axis does not divide by n_model stays whole (the ADM's
one-output head); an attention splits only when its heads divide, and
then its projections and ``out_proj`` together.  Convolution stacks,
embeddings, norms, codebooks and the discriminators stay whole on every
rank, as in JAX.

:func:`place_train_state` broadcasts the weights from rank 0, shards the
layers in place, moves the optimizers to ZeRO-1 over the data group when
asked (``torch.distributed.optim.ZeroRedundancyOptimizer``: each data rank
keeps the AdamW moments of about 1/n_data of the parameters; the moments
of a sharded parameter are its slice's), points the codebooks, the
BatchNorms and the random draws at the mesh, and records the mesh on the
state (``state.mesh``), which the train steps read.
"""
from __future__ import annotations

import inspect
from contextlib import contextmanager
from typing import Iterator, Optional

import torch
import torch.distributed as dist
from torch import nn

from .collectives import broadcast_
from .layers import ModelParallel, shard_layer_
from .mesh import Mesh

_COLUMN = ("w_q", "w_k", "w_v", "qkv", "ff_linear1", "ff_conv1", "predict_layer")
_ROW = ("out_proj", "ff_linear2", "ff_conv2")
_ATTENTION = ("w_q", "w_k", "w_v", "qkv", "out_proj")


def _width(layer: nn.Module, axis: str) -> int:
    """A Linear's or Conv1d's output (``"out"``) or input (``"in"``) features."""
    if isinstance(layer, nn.Linear):
        return layer.out_features if axis == "out" else layer.in_features
    return layer.out_channels if axis == "out" else layer.in_channels


def tp_rule(name: str, layer: nn.Module, parent: Optional[nn.Module], n_model: int):
    """("column" | "row", parts, gather) for the layer at ``name`` (a
    dotted module path) under ``n_model`` model ranks, or None (whole)."""
    leaf = name.rsplit(".", 1)[-1]
    if n_model == 1 or not isinstance(layer, (nn.Linear, nn.Conv1d)):
        return None
    if leaf in _ATTENTION:
        heads = getattr(parent, "n_heads", None)
        if heads is None or heads % n_model:
            return None
        if leaf == "out_proj":
            return "row", 1, False
        return "column", 3 if leaf == "qkv" else 1, False
    if leaf in _COLUMN and _width(layer, "out") % n_model == 0:
        return "column", 1, leaf == "predict_layer"
    if leaf in _ROW and _width(layer, "in") % n_model == 0:
        return "row", 1, False
    return None


def tp_plan(module: nn.Module, n_model: int) -> dict:
    """Module path → :func:`tp_rule` for every layer of ``module`` that splits."""
    mods = dict(module.named_modules())
    plan = {}
    for name, layer in mods.items():
        parent = mods.get(name.rsplit(".", 1)[0]) if "." in name else module
        rule = tp_rule(name, layer, parent, n_model)
        if rule is not None:
            plan[name] = rule
    return plan


def param_specs(module: nn.Module) -> dict:
    """Parameter name → :class:`ShardSpec` of every sharded parameter of ``module``."""
    out = {}
    for mname, m in module.named_modules():
        if isinstance(m, ModelParallel):
            for pname, spec in m.tp_specs.items():
                out[f"{mname}.{pname}" if mname else pname] = spec
    return out


def shard_module_(module: nn.Module, mesh: Mesh) -> dict:
    """Apply the rules to ``module`` in place; returns :func:`param_specs`."""
    for name, (kind, parts, gather) in tp_plan(module, mesh.n_model).items():
        shard_layer_(module.get_submodule(name), kind, mesh, parts, gather)
    return param_specs(module)


# ------------------------------------------------------------- train states


def _parts(state) -> tuple[list, list]:
    """(models, [(optimizer attribute, scheduler attribute, model)]) of a train state."""
    if hasattr(state, "model"):
        return [state.model], [("opt", "sched", state.model)]
    return [state.g, state.d], [("g_opt", "g_sched", state.g), ("d_opt", "d_sched", state.d)]


def _zero(opt: torch.optim.Optimizer, sched, group):
    """``opt`` (an AdamW without state) as a ZeroRedundancyOptimizer over
    ``group``, and ``sched`` moved onto it at its step."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    params = [p for g in opt.param_groups for p in g["params"]]
    accepted = inspect.signature(type(opt)).parameters  # defaults also hold derived flags
    z = ZeroRedundancyOptimizer(params, optimizer_class=type(opt), process_group=group,
                                **{k: v for k, v in opt.defaults.items() if k in accepted})
    new = torch.optim.lr_scheduler.LambdaLR(z, sched.lr_lambdas[0])
    new.load_state_dict(sched.state_dict())
    for zg, g in zip(z.param_groups, opt.param_groups):
        zg["lr"] = g["lr"]
    return z, new


def place_train_state(state, mesh: Mesh, zero: bool = False):
    """Place a train state (LM, GAN or vocoder) on ``mesh`` in place and
    return it: weights and buffers broadcast from rank 0, layers sharded
    by the rules, optimizers ZeRO-1 over the data group with ``zero``, the
    codebooks, BatchNorms and draws on the mesh, ``state.mesh`` set.  At
    the (1, 1) mesh only ``state.mesh`` is set.  An optimizer must hold no
    moments yet: restore a checkpoint into the placed state
    (``training/checkpoints.py`` reshards it)."""
    state.mesh = mesh
    if mesh.size == 1:
        return state
    models, opts = _parts(state)
    for attr, _, _ in opts:
        if getattr(state, attr).state:
            raise ValueError("place_train_state: place the state before restoring a checkpoint")
    with torch.no_grad():
        for m in models:
            for t in list(m.parameters()) + list(m.buffers()):
                broadcast_(t, dist.group.WORLD)
    for m in models:
        shard_module_(m, mesh)
        for sub in m.modules():
            if hasattr(type(sub), "mesh"):
                sub.mesh = mesh
    if getattr(state, "g_ema", None) is not None:
        state.g_ema = local_tensors(state.g_ema, state.g)
    if zero and mesh.n_data > 1:
        for attr, sattr, _ in opts:
            z, sched = _zero(getattr(state, attr), getattr(state, sattr), mesh.data_group)
            setattr(state, attr, z)
            setattr(state, sattr, sched)
    draws = getattr(state, "draws", None)
    if draws is not None:
        draws.rows = mesh.rows
    return state


def is_zero(opt) -> bool:
    from torch.distributed.optim import ZeroRedundancyOptimizer

    return isinstance(opt, ZeroRedundancyOptimizer)


@contextmanager
def full_weights(module: nn.Module, gather: bool) -> Iterator[dict]:
    """Within the block each sharded parameter of ``module`` is whole:
    gathered over the model group (``gather``), or zeros of the whole
    shape to be filled; on leaving, each keeps its slice of what it then
    holds.  Yields :func:`param_specs`."""
    specs = param_specs(module)
    params = dict(module.named_parameters())
    with torch.no_grad():
        for name, spec in specs.items():
            p = params[name]
            p.data = spec.full(p.data) if gather else p.data.new_zeros(spec.full_shape(p.shape))
    try:
        yield specs
    finally:
        with torch.no_grad():
            for name, spec in specs.items():
                params[name].data = spec.local(params[name].data)


def _opt_specs(opt, specs_by_param: dict) -> list:
    return [specs_by_param.get(id(p)) for g in opt.param_groups for p in g["params"]]


def _map_moments(sd: dict, specs: list, fn) -> dict:
    """``sd`` (an optimizer state dict) with ``fn(spec, moment)`` applied to
    every param-shaped moment of a sharded parameter."""
    state = {}
    for idx, st in sd["state"].items():
        spec = specs[int(idx)]
        state[idx] = {k: (fn(spec, v) if spec is not None and torch.is_tensor(v) and v.dim() > 0
                          else v) for k, v in st.items()}
    return {**sd, "state": state}


def full_optimizer_state(opt, module: nn.Module, mesh: Optional[Mesh]) -> Optional[dict]:
    """The optimizer's state dict as one device would hold it (ZeRO
    consolidated, sharded moments gathered), on the data axis' first row;
    None on the other rows.  A collective: every rank calls it."""
    if mesh is None or mesh.size == 1:
        return opt.state_dict()
    if is_zero(opt):
        opt.consolidate_state_dict(to=0)
    if mesh.data_rank != 0:
        return None
    specs = param_specs(module)
    by_param = {id(p): specs[name] for name, p in module.named_parameters() if name in specs}
    return _map_moments(opt.state_dict(), _opt_specs(opt, by_param), lambda spec, v: spec.full(v))


def load_full_optimizer_state(opt, module: nn.Module, sd: dict) -> None:
    """Load a one-device optimizer state dict into a placed optimizer:
    sharded moments sliced, ZeRO keeping its own parameters' moments."""
    specs = param_specs(module)
    if specs:
        by_param = {id(p): specs[name] for name, p in module.named_parameters() if name in specs}
        sd = _map_moments(sd, _opt_specs(opt, by_param), lambda spec, v: spec.local(v))
    elif is_zero(opt):
        sd = {**sd, "state": dict(sd["state"])}  # ZeRO clears the entries of other ranks
    opt.load_state_dict(sd)


def full_tensors(tensors: dict, module: nn.Module) -> dict:
    """Tensors keyed by ``module``'s parameter names (the GAN's EMA copy),
    the sharded ones gathered whole."""
    specs = param_specs(module)
    return {k: specs[k].full(v) if k in specs else v for k, v in tensors.items()}


def local_tensors(tensors: dict, module: nn.Module) -> dict:
    """The inverse of :func:`full_tensors`: each sharded one's slice."""
    specs = param_specs(module)
    return {k: specs[k].local(v) if k in specs else v for k, v in tensors.items()}
