"""Weight bridge: JAX (flax) parameter trees → the port's modules.

``load_flax_params(module, tree)`` takes a tree as nested dicts of numpy
arrays (or anything ``np.asarray`` reads) and fills ``module`` in place:

* MegaG takes the generator's variables ``{"params": ..., "vq_stats": ...}``
  (the VQPE encoder and its codebook included), as does the
  VQProsodyEncoder alone; the Discriminator
  ``{"params": ..., "batch_stats": ...}``; MegaPLM, MegaADM, HiFiGAN,
  Vocos and the vocoder's WaveDiscriminator take their ``params``.
* Dense ``kernel`` (in, out) → Linear ``weight`` (out, in).
* A ``quantize_tree`` leaf set ``{kernel_q, scale, bias}`` → the
  ``QuantLinear`` that ``quantize_`` put in the Linear's place:
  ``kernel_q`` (in, out) int8 or (in/2, out) packed uint8 → ``weight_q``
  (out, in) or (out, in/2); ``scale`` and ``bias`` by name, fp32.
* Conv ``kernel`` (k, in/groups, out) → Conv1d ``weight`` (out, in/groups, k),
  grouped or not; (kh, kw, in, out) → Conv2d ``weight`` (out, in, kh, kw),
  e.g. the period discriminators' (5, 1, in, out).
* HiFi-GAN ``TransposedConv1d`` ``kernel`` (k, in, out), stored flipped along
  k (``training/convert.py``) → ConvTranspose1d ``weight`` (in, out, k) =
  ``kernel[::-1].transpose(1, 2, 0)``.
* LayerNorm ``scale``/``bias`` → ``weight``/``bias``; Embed ``embedding`` →
  ``weight``; other parameters and buffers by name (the codebook's
  ``vq_stats``, BatchNorm's ``scale``, ``bias``, ``mean`` and ``var``).
* A key naming a ``ModuleList`` itself is scan-stacked (``nn.scan``: the
  transformer's ``layers``, ``scan_stacks``' ``conv_stacks``): every leaf
  under it carries a leading axis of the list's length and is unstacked
  into the list.  ``name_<i>`` submodules go to ``name[i]``.
* ``w_q``, ``w_k``, ``w_v`` are concatenated along the output axis into the
  decode layers' merged ``qkv`` projection: kernels (float or quantized),
  scales and biases.

It raises on any flax leaf or collection it does not consume, on any
shape mismatch, and on any parameter or persistent buffer of the module
left unfilled.
"""
from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from .models.dscrm import Discriminator
from .models.megag import MegaG
from .models.vqpe import VQProsodyEncoder
from .quantization.weight_only import QuantLinear

_INDEXED = re.compile(r"^(.*)_(\d+)$")


def _assign(target: torch.Tensor, value: np.ndarray, path: str, filled: set) -> None:
    value = torch.from_numpy(np.array(value, order="C"))  # keeps 0-d leaves 0-d
    if tuple(target.shape) != tuple(value.shape):
        raise ValueError(f"{path}: flax shape {tuple(value.shape)} != torch {tuple(target.shape)}")
    with torch.no_grad():
        target.copy_(value.to(target.dtype))
    filled.add(id(target))


def _leaf(module: nn.Module, key: str, value: np.ndarray, path: str, filled: set) -> None:
    if isinstance(module, nn.Linear) and key == "kernel":
        _assign(module.weight, value.T, path, filled)
    elif isinstance(module, QuantLinear) and key == "kernel_q":
        _assign(module.weight_q, value.T, path, filled)
    elif isinstance(module, nn.Conv1d) and key == "kernel":
        _assign(module.weight, value.transpose(2, 1, 0), path, filled)
    elif isinstance(module, nn.Conv2d) and key == "kernel":
        _assign(module.weight, value.transpose(3, 2, 0, 1), path, filled)
    elif isinstance(module, nn.ConvTranspose1d) and key == "kernel":
        _assign(module.weight, value[::-1].transpose(1, 2, 0), path, filled)
    elif isinstance(module, nn.LayerNorm) and key == "scale":
        _assign(module.weight, value, path, filled)
    elif isinstance(module, nn.Embedding) and key == "embedding":
        _assign(module.weight, value, path, filled)
    elif key in module._parameters or key in module._buffers:
        _assign(getattr(module, key), value, path, filled)
    else:
        raise KeyError(f"{path}: no counterpart in {type(module).__name__}")


def _child(module: nn.Module, key: str, path: str) -> nn.Module:
    if key in module._modules:
        return module._modules[key]
    m = _INDEXED.match(key)
    if m and isinstance(module._modules.get(m.group(1)), nn.ModuleList):
        return module._modules[m.group(1)][int(m.group(2))]
    raise KeyError(f"{path}: no counterpart in {type(module).__name__}")


def _load(module: nn.Module, tree: dict, path: str, filled: set) -> None:
    tree = dict(tree)
    if "w_q" in tree and "qkv" in module._modules:  # merged decode projection
        parts = [tree.pop(n) for n in ("w_q", "w_k", "w_v")]
        for key in parts[0]:
            merged = np.concatenate([np.asarray(p[key]) for p in parts], axis=-1)
            _leaf(module.qkv, key, merged, f"{path}/w_qkv/{key}", filled)
    for key, value in tree.items():
        sub = f"{path}/{key}"
        if isinstance(value, dict):
            child = module._modules.get(key)
            if isinstance(child, nn.ModuleList):
                for i, layer in enumerate(child):  # scan-stacked: leading layer axis
                    _load(layer, _index(value, i, len(child), sub), f"{sub}[{i}]", filled)
            else:
                _load(_child(module, key, sub), value, sub, filled)
        else:
            _leaf(module, key, np.asarray(value), sub, filled)


def _index(tree: dict, i: int, n: int, path: str) -> dict:
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = _index(value, i, n, f"{path}/{key}")
        else:
            value = np.asarray(value)
            if value.shape[0] != n:
                raise ValueError(f"{path}/{key}: {value.shape[0]} stacked layers, module has {n}")
            out[key] = value[i]
    return out


# the flax collections each model's tree holds; any other takes its params
_COLLECTIONS = {MegaG: ("params", "vq_stats"), VQProsodyEncoder: ("params", "vq_stats"),
                Discriminator: ("params", "batch_stats")}


def load_flax_params(module: nn.Module, flax_tree: dict) -> nn.Module:
    """Fill ``module`` from a flax tree in place (see module docstring)."""
    filled: set = set()
    names = _COLLECTIONS.get(type(module))
    if names is None:
        _load(module, flax_tree, "params", filled)
    else:
        extra = set(flax_tree) - set(names)
        if extra:
            raise KeyError(f"unconsumed flax collections: {sorted(extra)}")
        for name in names:
            _load(module, flax_tree[name], name, filled)
    persistent = [
        (f"{mname}.{bname}", b)
        for mname, m in module.named_modules()
        for bname, b in m._buffers.items()
        if b is not None and bname not in m._non_persistent_buffers_set
    ]
    missing = [n for n, p in list(module.named_parameters()) + persistent if id(p) not in filled]
    if missing:
        raise KeyError(f"{type(module).__name__}: not filled from the flax tree: {missing}")
    return module


# ------------------------------------------------------------- the inverse


def _leaves(module: nn.Module) -> tuple[dict, dict]:
    """(params, persistent buffers) of ``module`` itself in flax names and layouts."""
    if isinstance(module, QuantLinear):
        raise TypeError("export_flax_params: a quantized layer has no float weights to export")
    p = {k: v for k, v in module._parameters.items() if v is not None}
    out = {}
    if isinstance(module, nn.Linear):
        out["kernel"] = p.pop("weight").T
    elif isinstance(module, nn.Conv1d):
        out["kernel"] = p.pop("weight").permute(2, 1, 0)
    elif isinstance(module, nn.Conv2d):
        out["kernel"] = p.pop("weight").permute(2, 3, 1, 0)
    elif isinstance(module, nn.ConvTranspose1d):
        out["kernel"] = p.pop("weight").permute(2, 0, 1).flip(0)
    elif isinstance(module, nn.LayerNorm):
        out["scale"] = p.pop("weight")
    elif isinstance(module, nn.Embedding):
        out["embedding"] = p.pop("weight")
    out.update(p)
    bufs = {k: b for k, b in module._buffers.items()
            if b is not None and k not in module._non_persistent_buffers_set}
    as_np = lambda d: {k: v.detach().float().cpu().numpy() for k, v in d.items()}  # noqa: E731
    return as_np(out), as_np(bufs)


def _export(module: nn.Module) -> tuple[dict, dict]:
    params, stats = _leaves(module)
    for name, child in module._modules.items():
        kids = ([(f"{name}_{i}", c) for i, c in enumerate(child)]
                if isinstance(child, nn.ModuleList) else [(name, child)])
        for key, c in kids:
            cp, cs = _export(c)
            if key == "qkv" and "kernel" in cp:  # the merged decode projection → w_q, w_k, w_v
                for j, part in enumerate(("w_q", "w_k", "w_v")):
                    params[part] = {k: np.split(v, 3, axis=-1)[j] for k, v in cp.items()}
                continue
            if cp:
                params[key] = cp
            if cs:
                stats[key] = cs
    return params, stats


def export_flax_params(module: nn.Module) -> dict:
    """The inverse of :func:`load_flax_params`: ``module``'s weights as the
    flax tree the JAX package builds (the same collections, Dense and conv
    kernels in flax's layouts, the merged ``qkv`` split into ``w_q``,
    ``w_k`` and ``w_v``), fp32 numpy leaves.  ``ModuleList`` children come
    out unstacked (``name_<i>``), which the bridge and ``convert`` read
    whatever the JAX layout's ``scan_layers``/``scan_stacks``."""
    params, stats = _export(module)
    names = _COLLECTIONS.get(type(module))
    if names is None:
        if stats:
            raise KeyError(f"{type(module).__name__}: buffers outside its flax params: {list(stats)}")
        return params
    return {names[0]: params, names[1]: stats}
