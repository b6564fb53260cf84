"""Prefetching data loader (port of ``megatts2_tpu/data/loader.py``): a
sampler × a batch builder on one background thread, ``prefetch`` numpy
batches deep.  Batches the builder returns as ``None`` (the ADM builder's
when every cut of a batch is skipped) are dropped.  Moving a batch to the
device is the train step's work.

Not a ``torch.utils.data.DataLoader``: the builders keep their own seeded
``np.random.RandomState`` and must see the sampler's batches in order.

Unlike the JAX loader, an exception in the builder is raised in the
consumer (not swallowed as the end of the epoch), and a consumer that
stops early (the train loop at ``max_steps``) stops the thread.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator

import numpy as np

_DONE = object()


class DataLoader:
    def __init__(self, sampler, batch_builder: Callable, prefetch: int = 2):
        self.sampler = sampler
        self.batch_builder = batch_builder
        self.prefetch = prefetch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        failed: list = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                for idxs in self.sampler:
                    batch = self.batch_builder(idxs)
                    if batch is not None and not put(batch):
                        return
            except Exception as e:  # raised again in the consumer
                failed.append(e)
            put(_DONE)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while (item := q.get()) is not _DONE:
                yield item
            if failed:
                raise failed[0]
        finally:
            stop.set()
            t.join()
