"""Random weights from the seed, made on the device in one draw.

The benchmark, not the port, owns the weights: :func:`make_weights` gives a
``{name: fp32 tensor}`` dict in a module's state-dict layout, which is
loaded into the port's module and, made again from the same seed after
the window, handed to the reference.  One ``randn`` call on a generator
seeded here fills every random leaf, whose views are then scaled in
place:

* LayerNorm weights 1 and biases 0 (names with ``norm``), a layer scale
  (``gamma``) at ``layer_scale``;
* token and code embeddings and the codebook N(0, 1);
* every other bias N(0, 0.01²), so that the checks see the bias paths;
* every other weight N(0, 1 / fan_in), fan_in the product of its
  dimensions after the first (a Linear's inputs, a Conv1d's
  inputs per group times its kernel);
* the codebook's running statistics as a trained codebook leaves them
  (``cluster_size`` 1, ``embed_avg`` the codebook, ``inited`` 1).
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

EMBEDDINGS = ("word_embeddings.weight", "pc_embedding.weight", "_codebook.embed")
BIAS_STD = 0.01


def _kind(name: str, shape: Tuple[int, ...]) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if name.endswith(EMBEDDINGS):
        return "normal"
    if name.endswith(("_codebook.inited", "_codebook.cluster_size")):
        return "one"
    if name.endswith("_codebook.embed_avg"):
        return "embed_avg"
    if leaf == "gamma":
        return "layer_scale"
    if "norm" in name.rsplit(".", 2)[-2] and len(shape) == 1:
        return "one" if leaf == "weight" else "zero"
    if leaf == "bias":
        return "bias"
    return "fan_in"


def make_weights(layout: Iterable[Tuple[str, Tuple[int, ...]]], seed: int, device,
                 layer_scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """fp32 weights for ``layout`` ((name, shape) pairs, in state-dict
    order) from ``seed`` on ``device``."""
    layout = [(n, tuple(s)) for n, s in layout]
    kinds = [_kind(n, s) for n, s in layout]
    drawn = [(n, s, k) for (n, s), k in zip(layout, kinds) if k in ("normal", "bias", "fan_in")]
    total = sum(_numel(s) for _, s, _ in drawn)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for n, s, k in drawn:
        v = flat[off: off + _numel(s)].view(s)
        off += _numel(s)
        if k == "bias":
            v.mul_(BIAS_STD)
        elif k == "fan_in":
            v.mul_((_numel(s) // s[0]) ** -0.5)
        out[n] = v
    for (n, s), k in zip(layout, kinds):
        if k == "one":
            out[n] = torch.ones(s, device=device)
        elif k == "zero":
            out[n] = torch.zeros(s, device=device)
        elif k == "layer_scale":
            out[n] = torch.full(s, float(layer_scale), device=device)
    for (n, s), k in zip(layout, kinds):
        if k == "embed_avg":
            out[n] = out[n[: -len("embed_avg")] + "embed"].clone()
    return {n: out[n] for n, _ in layout}


def _numel(shape: Tuple[int, ...]) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def layout_of(module: torch.nn.Module) -> list:
    """(name, shape) of every entry of ``module``'s state dict."""
    return [(n, tuple(t.shape)) for n, t in module.state_dict().items()]
