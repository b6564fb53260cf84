"""The (data × model) mesh of ranks, and the batch split over it (port of
``megatts2_tpu/parallel/mesh.py``).

JAX builds one ``Mesh(("data", "model"))`` over its devices and lets GSPMD
insert the collectives into a program over global arrays.  Here each rank
is a process (``torchrun``, one a card) that runs the step on its own
rows, and the collectives are explicit (``parallel/collectives.py``).
:func:`make_mesh` lays the world out as (world / n_model) data rows by
n_model model columns, the model groups of consecutive ranks, through
``torch.distributed.device_mesh.init_device_mesh``.  Without a process
group it returns the (1, 1) mesh, under which every collective is the
identity and every path runs as on one device.

:func:`shard_batch` takes a rank's contiguous rows of a global batch.
Every rank builds the same global batch (the sampler's seed and
``batch_divisor`` = n_data are shared), so all padding is the global
batch's; a leading axis not divisible by n_data stays whole on every rank,
as JAX replicates it.  The train loop refuses that fallback
(``replicate=False``): a train step sums or averages over the data ranks as
if each held rows of its own, so a replicated batch would count each row
n_data times.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def maybe_initialize_distributed(backend: Optional[str] = None, device="cuda") -> bool:
    """Join the process group that ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``):
    NCCL for ``device`` cuda, gloo for cpu, or ``backend``.  Under NCCL each
    rank takes card ``LOCAL_RANK``.  Returns whether a group exists; a no-op
    when one already does or the environment names none."""
    if dist.is_available() and dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return False
    on_card = torch.device(device).type == "cuda"
    backend = backend or ("nccl" if on_card else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method="env://")
    return True


@dataclass(eq=False)
class Mesh:
    """A rank's place on the (data, model) mesh: the axis sizes in
    ``shape`` (JAX's ``mesh.shape`` keys), its index along each, and the
    process group of each axis (None on an axis of size 1)."""

    shape: dict = field(default_factory=lambda: {DATA_AXIS: 1, MODEL_AXIS: 1})
    data_rank: int = 0
    model_rank: int = 0
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def n_data(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def n_model(self) -> int:
        return self.shape[MODEL_AXIS]

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    @property
    def rank(self) -> int:
        """The global rank (row-major: model groups are consecutive ranks)."""
        return self.data_rank * self.n_model + self.model_rank

    @property
    def is_main(self) -> bool:
        """Global rank 0: the one rank that writes logs, traces and checkpoints."""
        return self.rank == 0

    @property
    def rows(self) -> Optional[tuple[int, int]]:
        """(data rank, n_data) when the batch is split, else None."""
        return (self.data_rank, self.n_data) if self.n_data > 1 else None


def make_mesh(n_model: int = 1) -> Mesh:
    """The (world / n_model, n_model) mesh of the process group, or the
    (1, 1) mesh without one.  Raises when the world size is not a multiple
    of ``n_model``."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if n_model < 1 or world % n_model:
        raise ValueError(f"{world} ranks not divisible by model={n_model}")
    if world == 1:
        return Mesh()
    from torch.distributed.device_mesh import init_device_mesh

    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(kind, (world // n_model, n_model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    n_data = world // n_model
    return Mesh({DATA_AXIS: n_data, MODEL_AXIS: n_model},
                data_rank=dm.get_local_rank(DATA_AXIS), model_rank=dm.get_local_rank(MODEL_AXIS),
                data_group=dm.get_group(DATA_AXIS) if n_data > 1 else None,
                model_group=dm.get_group(MODEL_AXIS) if n_model > 1 else None)


def shard_rows(x, mesh: Mesh):
    """This rank's contiguous rows of ``x`` (numpy or tensor) along axis 0;
    ``x`` whole when the axis does not split evenly over the data axis."""
    n = mesh.n_data
    shape = np.shape(x)
    if n == 1 or not shape or shape[0] % n:
        return x
    b = shape[0] // n
    return x[mesh.data_rank * b:(mesh.data_rank + 1) * b]


class ShardedBatch(dict):
    """A rank's rows of a batch; ``full`` is the global batch it came from
    (host values such as the longest length are read from it)."""

    full: dict


def shard_batch(batch: dict, mesh: Mesh, replicate: bool = True) -> dict:
    """This rank's rows of every array of ``batch`` (see :func:`shard_rows`);
    the batch itself under a mesh of one data row.  ``replicate=False``
    raises on a leading axis that does not split over the data ranks."""
    if mesh.n_data == 1:
        return batch
    if not replicate:
        whole = {k: np.shape(v)[:1] for k, v in batch.items() if not np.shape(v)
                 or np.shape(v)[0] % mesh.n_data}
        if whole:
            raise ValueError(f"batch rows {whole} do not split over {mesh.n_data} data ranks "
                             "(the sampler's batch_divisor must be the data axis)")
    out = ShardedBatch({k: shard_rows(v, mesh) for k, v in batch.items()})
    out.full = batch
    return out


def full_batch(batch: dict) -> dict:
    """The global batch of a :func:`shard_batch` result (or the batch itself)."""
    return getattr(batch, "full", batch)
