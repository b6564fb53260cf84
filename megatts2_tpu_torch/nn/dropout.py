"""The randomness of a training forward: dropout keep masks, the codebook's
sample indices and the discriminator's window starts.

JAX draws them from PRNG keys, whose streams torch cannot reproduce.  A
:class:`Draws` therefore draws them from explicit ``torch.Generator`` s, or
replays given values in the order they are asked for: the tests record
JAX's draws and replay them into the port, and a run on one device can be
recorded and replayed on another.  A module in train mode takes a
``Draws``; in eval mode it takes ``None`` and draws nothing.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

KINDS = ("masks", "indices", "starts")


class Draws:
    """Keep masks and indices from ``generator`` (on the device of the
    tensors they apply to), window starts from ``host_generator`` (CPU);
    or, with ``replay`` (a dict of lists under :data:`KINDS`), those values
    in order.  With ``record`` every value handed out is also appended to
    ``self.recorded``.  ``calls`` counts the values handed out, by kind.

    ``rows`` = (data rank, n_data) on a rank of a data-parallel mesh: a
    mask is drawn (or replayed) at the global batch's shape and the rank
    takes its rows, so every rank's generator stays in lockstep with a
    one-process run's and the masks are that run's."""

    def __init__(
        self,
        generator: Optional[torch.Generator] = None,
        host_generator: Optional[torch.Generator] = None,
        replay: Optional[dict] = None,
        record: bool = False,
        rows: Optional[tuple[int, int]] = None,
    ):
        self.generator = generator
        self.host_generator = host_generator
        self.rows = rows
        self.replay = None if replay is None else {k: list(replay.get(k, ())) for k in KINDS}
        self.recorded = {k: [] for k in KINDS} if record else None
        self.calls = dict.fromkeys(KINDS, 0)

    def _take(self, kind: str, draw):
        if self.replay is None:
            value = draw()
        elif self.replay[kind]:
            value = self.replay[kind].pop(0)
        else:
            raise IndexError(f"Draws: no {kind} left to replay (call {self.calls[kind] + 1})")
        if self.recorded is not None:
            self.recorded[kind].append(value)
        self.calls[kind] += 1
        return value

    def keep_mask(self, shape: Sequence[int], rate: float, device, split_rows: bool = True,
                  cols: Optional[tuple[int, int]] = None) -> torch.Tensor:
        """Bool mask of ``shape``, each element kept with probability 1 - rate.
        Under ``self.rows`` (and ``split_rows``: axis 0 is not broadcast)
        axis 0 is this rank's rows of the global mask; ``cols`` = (index,
        count): the last axis is slice ``index`` of ``count`` (the output
        of a column-parallel layer)."""
        rows = self.rows if split_rows else None
        full = list(shape)
        if rows is not None:
            full[0] *= rows[1]
        if cols is not None:
            full[-1] *= cols[1]
        keep = self._take("masks", lambda: torch.rand(
            tuple(full), generator=self.generator, device=device) >= rate)
        keep = _tensor(keep, device).bool()
        if rows is not None:
            keep = keep.narrow(0, rows[0] * shape[0], shape[0])
        if cols is not None:
            keep = keep.narrow(-1, cols[0] * shape[-1], shape[-1])
        return keep

    def indices(self, n: int, num: int, device) -> torch.Tensor:
        """``num`` row indices into ``n`` rows: distinct (a permutation's head)
        when n >= num, else drawn with replacement."""
        def draw():
            if n >= num:
                return torch.randperm(n, generator=self.generator, device=device)[:num]
            return torch.randint(0, n, (num,), generator=self.generator, device=device)

        return _tensor(self._take("indices", draw), device).long()

    def starts(self, highs: Sequence[int]) -> list[int]:
        """One start in [0, high] for each high."""
        return [int(self._take("starts", lambda h=h: int(torch.randint(
            0, h + 1, (), generator=self.host_generator)))) for h in highs]


def _tensor(value, device) -> torch.Tensor:
    """A drawn tensor, or a replayed array (copied: it may be read-only), on ``device``."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.from_numpy(np.array(value)).to(device)


def train_draws(train: bool, draws: Optional[Draws]) -> Optional[Draws]:
    """``draws`` in train mode, where it is required; ``None`` in eval."""
    if not train:
        return None
    if draws is None:
        raise ValueError("train mode draws its dropout masks and samples from a Draws; pass draws=")
    return draws


@functools.lru_cache(maxsize=None)
def in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: JAX rounds a Python float to the dtype
    of the array it meets (0.9 is 0.8984375 in bf16), while torch computes
    a bf16 op with the scalar in fp32."""
    return torch.tensor(value, dtype=dtype).item()


def dropout(x: torch.Tensor, rate: float, draws: Optional[Draws],
            broadcast_dims: Sequence[int] = (),
            cols: Optional[tuple[int, int]] = None) -> torch.Tensor:
    """flax ``nn.Dropout(rate, broadcast_dims)``: the identity without
    ``draws`` (eval) or at rate 0; else keep with probability 1 - rate,
    scaled by its inverse, one mask value shared along ``broadcast_dims``.
    The keep probability is rounded to x's dtype first, as JAX rounds the
    Python float it divides by (:func:`in_dtype`).  ``cols``: x's last axis
    is a slice of a column-parallel layer's output (``Draws.keep_mask``)."""
    if draws is None or rate == 0.0:
        return x
    shape = [1 if i in broadcast_dims else n for i, n in enumerate(x.shape)]
    keep = draws.keep_mask(shape, rate, x.device, split_rows=0 not in broadcast_dims, cols=cols)
    return torch.where(keep, x / in_dtype(1.0 - rate, x.dtype), torch.zeros((), dtype=x.dtype, device=x.device))
