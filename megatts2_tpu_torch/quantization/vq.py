"""EMA vector quantization (port of ``megatts2_tpu/quantization/vq.py``).

Kmeans init on the first training batch, nearest-neighbour assignment by
expanded L2 in fp32, straight-through estimator, EMA cluster and embed
updates with Laplace smoothing, dead-code expiry, and an ``n_q``-deep
residual loop.

The codebook statistics are buffers, named as the JAX ``vq_stats``
collection names them, so a JAX checkpoint loads leaf for leaf.  A train
step updates them in place under ``no_grad``; JAX returns them as a new
collection.  The codebook starts empty (``inited`` 0) and is initialised
by kmeans on the first training batch, as the JAX default
``kmeans_init=True``; that is the only initialisation ported.  The random
rows that seed kmeans and replace expired codes come from a ``Draws``
(``nn/dropout.py``): drawn from a generator, or injected.

Whether the codebook is initialised is kept on the host too, so that a
train step does not wait for the device to read ``inited``: the flag is
read from the device once, then again only after the buffer was written
or replaced from outside the train step (``load_state_dict``, a
checkpoint restore through the bridge, a broadcast on a mesh, ``.to``),
which the tensor's version counter and identity show.

``EuclideanCodebook(fixed_expiry=True)`` (the JAX default, and what the
models use) also refreshes ``embed_avg`` and ``cluster_size`` of an
expired code so that the replacement survives the EMA renormalisation;
``False`` reproduces the reference, whose expiry the same step's
``embed = embed_avg / cluster_size`` overwrites.

On a data-parallel mesh (``mesh``, set by ``parallel.place_train_state``)
every statistic is the global batch's, as in JAX, where they are
"identical on every replica by construction": a train step gathers the
rows of every data rank (exact, ``parallel/collectives.py``), runs kmeans,
the expiry and the EMA on them with draws over the global row count, and
keeps its own rows' codes, so each rank's codebook equals a one-process
run's.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import gather_rows

# the reference's codebook constants (core_vq.py): 50 Lloyd iterations,
# EMA decay 0.99, Laplace smoothing 1e-5, codes with EMA mass under 2 expire
KMEANS_ITERS, DECAY, EPSILON, DEAD_CODE = 50, 0.99, 1e-5, 2.0


def _scores(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """-|x - e|^2 expanded as -|x|^2 + 2 x.e - |e|^2, fp32; (N, K)."""
    return (-(x**2).sum(-1, keepdim=True) + 2.0 * (x @ embed.t())
            - (embed**2).sum(-1)[None, :])


def _kmeans(samples: torch.Tensor, num_clusters: int, num_iters: int, seeds: torch.Tensor):
    """Lloyd iterations from the rows ``seeds`` of ``samples``; a cluster
    left empty keeps its mean.  Returns (means, bin_counts)."""
    means = samples[seeds]
    for _ in range(num_iters):
        onehot = F.one_hot(_scores(samples, means).argmax(-1), num_clusters).to(samples.dtype)
        bins = onehot.sum(0)
        new_means = (onehot.t() @ samples) / bins.clamp(min=1.0)[:, None]
        means = torch.where((bins == 0)[:, None], means, new_means)
    bins = F.one_hot(_scores(samples, means).argmax(-1), num_clusters).to(samples.dtype).sum(0)
    return means, bins


class EuclideanCodebook(nn.Module):
    mesh = None  # the data-parallel mesh of a placed train state

    def __init__(self, dim: int, codebook_size: int, fixed_expiry: bool = True):
        super().__init__()
        self.dim, self.codebook_size = dim, codebook_size
        self.fixed_expiry = fixed_expiry
        self.register_buffer("inited", torch.zeros(()))
        self.register_buffer("cluster_size", torch.zeros(codebook_size))
        self.register_buffer("embed", torch.zeros(codebook_size, dim))
        self.register_buffer("embed_avg", torch.zeros(codebook_size, dim))
        # (id, version, value) of the ``inited`` tensor as last read or written here
        self._inited_seen = None

    def is_inited(self) -> bool:
        """``inited`` as a bool, read from the device only when the buffer
        changed since this codebook last read or wrote it."""
        t = self.inited
        seen = self._inited_seen
        if seen is None or seen[0] != id(t) or seen[1] != t._version:
            seen = self._inited_seen = (id(t), t._version, bool(t.item() >= 0.5))
        return seen[2]

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape(-1, self.dim).float()
        return _scores(flat, self.embed.float()).argmax(-1).reshape(x.shape[:-1])

    def decode(self, ind: torch.Tensor) -> torch.Tensor:
        return F.embedding(ind, self.embed)

    def forward(self, x: torch.Tensor, train: bool = False, draws=None):
        """x (..., dim) → (quantized (..., dim) in x's dtype, codes (...)).
        In train mode the codes and the quantized rows come from the
        codebook before this step's update (after the first batch's
        kmeans), then the statistics take the update."""
        flat = x.reshape(-1, self.dim).float()
        if not train:
            ind = _scores(flat, self.embed.float()).argmax(-1)
            return F.embedding(ind, self.embed).reshape(x.shape).to(x.dtype), ind.reshape(x.shape[:-1])
        with torch.no_grad():
            flat = flat.detach()
            rows = None
            if self.mesh is not None and self.mesh.n_data > 1:
                first = self.mesh.data_rank * flat.shape[0]
                rows = slice(first, first + flat.shape[0])
                flat = gather_rows(flat, self.mesh)
            n, K = flat.shape[0], self.codebook_size
            if not self.is_inited():
                embed, bins = _kmeans(flat, K, KMEANS_ITERS, draws.indices(n, K, flat.device))
                embed_avg, cluster_size = embed, bins
            else:
                embed, embed_avg, cluster_size = self.embed, self.embed_avg, self.cluster_size
            ind = _scores(flat, embed).argmax(-1)
            quantized = embed[ind]
            expired = (cluster_size < DEAD_CODE)[:, None]  # the sizes before the update
            repl = flat[draws.indices(n, K, flat.device)]
            embed = torch.where(expired, repl, embed)
            if self.fixed_expiry:
                embed_avg = torch.where(expired, repl, embed_avg)
                cluster_size = torch.where(expired[:, 0], torch.full_like(cluster_size, DEAD_CODE),
                                           cluster_size)
            onehot = F.one_hot(ind, K).to(torch.float32)
            cluster_size = cluster_size * DECAY + onehot.sum(0) * (1 - DECAY)
            embed_avg = embed_avg * DECAY + (onehot.t() @ flat) * (1 - DECAY)
            total = cluster_size.sum()
            smoothed = (cluster_size + EPSILON) / (total + K * EPSILON) * total
            self.inited.fill_(1.0)
            self._inited_seen = (id(self.inited), self.inited._version, True)
            self.cluster_size.copy_(cluster_size)
            self.embed_avg.copy_(embed_avg)
            self.embed.copy_(embed_avg / smoothed[:, None])
            if rows is not None:
                quantized, ind = quantized[rows], ind[rows]
        return quantized.reshape(x.shape).to(x.dtype), ind.reshape(x.shape[:-1])


class VectorQuantization(nn.Module):
    """One codebook; in train mode the straight-through estimator and the
    commitment loss mean((sg(q) - x)^2)."""

    def __init__(self, dim: int, codebook_size: int):
        super().__init__()
        self._codebook = EuclideanCodebook(dim, codebook_size)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self._codebook.encode(x)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        return self._codebook.decode(codes)

    def forward(self, x: torch.Tensor, train: bool = False, draws=None):
        quantized, codes = self._codebook(x, train, draws)
        if not train:
            return quantized, codes, torch.zeros((), device=x.device)
        quantized = x + (quantized - x).detach()
        commit = ((quantized.detach() - x).float() ** 2).mean()
        return quantized, codes, commit


class ResidualVectorQuantizer(nn.Module):
    """n_q codebooks applied to successive residuals.  ``forward`` →
    (quantized, codes (n_q, ...), commit loss summed over codebooks);
    ``encode`` → codes; ``decode`` sums the lookups of codes (n_q, ...)."""

    def __init__(self, dimension: int = 256, n_q: int = 1, bins: int = 1024):
        super().__init__()
        self.layers = nn.ModuleList(VectorQuantization(dimension, bins) for _ in range(n_q))

    def forward(self, x: torch.Tensor, train: bool = False, draws=None):
        out, residual = torch.zeros_like(x), x
        codes, losses = [], []
        for layer in self.layers:
            q, c, loss = layer(residual, train, draws)
            residual = residual - q
            out = out + q
            codes.append(c)
            losses.append(loss)
        return out, torch.stack(codes), torch.stack(losses).sum()

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        residual, codes = x, []
        for layer in self.layers:
            c = layer.encode(residual)
            residual = residual - layer.decode(c)
            codes.append(c)
        return torch.stack(codes)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        out: Optional[torch.Tensor] = None
        for i, layer in enumerate(self.layers):
            q = layer.decode(codes[i])
            out = q if out is None else out + q
        return out
