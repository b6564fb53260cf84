"""Duration-bucketing batch sampler (port of ``megatts2_tpu/data/sampler.py``).

Cuts are grouped into duration-quantile buckets; a batch accumulates until
``max_duration_batch`` total seconds (or ``max_cuts``).  The batch plan of
a (seed, epoch) is JAX's index for index: the same ``np.random.RandomState``
draws in the same order.  One case differs, under a ``batch_divisor``
above 1: a last remainder that no earlier batch precedes is padded here
too (JAX leaves it short and replicates it over its data axis; the port's
ranks each need rows of their own), and a pad longer than its bucket
cycles through the bucket.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from .manifest import CutManifest


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class DurationBucketSampler:
    """Yields lists of cut indices (one list = one batch)."""

    def __init__(
        self,
        manifest: CutManifest,
        max_duration_batch: Optional[float] = 60.0,
        max_cuts: Optional[int] = None,
        num_buckets: int = 10,
        shuffle: bool = True,
        drop_last: bool = False,
        seed: int = 0,
        batch_divisor: int = 1,
    ):
        """``batch_divisor``: emit batch sizes that are multiples of this
        (a data-parallel group's size); the remainder rolls into the next
        batch.  The one-card CLI passes 1."""
        self.manifest = manifest
        self.max_duration_batch = max_duration_batch
        self.max_cuts = max_cuts
        self.batch_divisor = max(1, batch_divisor)
        self.num_buckets = max(1, min(num_buckets, len(manifest) or 1))
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self._len_cache: Optional[int] = None

        durs = np.array([c.duration for c in manifest])
        order = np.argsort(durs)
        self.buckets: List[np.ndarray] = [
            b for b in np.array_split(order, self.num_buckets) if len(b)
        ]

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self._len_cache = None

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.RandomState(self.seed + self.epoch)
        batches: List[List[int]] = []
        div = self.batch_divisor

        def close(cur: List[int], carry: List[int]) -> List[int]:
            """Emit cur trimmed to a multiple of the divisor; the remainder
            carries into the next batch."""
            if div > 1 and len(cur) % div:
                keep = len(cur) - len(cur) % div
                carry.extend(cur[keep:])
                cur = cur[:keep]
            if cur:
                batches.append(cur)
            return carry

        for bucket in self.buckets:
            idxs = bucket.copy()
            if self.shuffle:
                rng.shuffle(idxs)
            cur: List[int] = []
            cur_dur = 0.0
            for i in idxs:
                d = self.manifest[int(i)].duration
                over_dur = (self.max_duration_batch is not None and cur
                            and cur_dur + d > self.max_duration_batch)
                over_cnt = self.max_cuts is not None and len(cur) >= self.max_cuts
                if over_dur or over_cnt:
                    cur = close(cur, [])
                    cur_dur = sum(self.manifest[j].duration for j in cur)
                cur.append(int(i))
                cur_dur += d
            if cur and not self.drop_last:
                if div > 1 and len(cur) % div:
                    # final remainder: pad by re-sampling from the bucket
                    need = div - len(cur) % div
                    cur = cur + [int(j) for j in np.resize(idxs, need)]
                batches.append(cur)
        if self.shuffle:
            rng.shuffle(batches)
        return iter(batches)

    def __len__(self) -> int:
        # the batch plan is deterministic per (seed, epoch): count it once
        if self._len_cache is None:
            self._len_cache = sum(1 for _ in iter(self))
        return self._len_cache
