"""Data and tensor parallelism of the port (counterpart of
``megatts2_tpu/parallel/``): the mesh of ranks, its collectives, the
tensor-parallel layers and the placement of a train state."""
from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, full_batch, make_mesh,
                   maybe_initialize_distributed, shard_batch, shard_rows)
from .sharding import (full_optimizer_state, full_weights, load_full_optimizer_state,
                       param_specs, place_train_state, tp_plan, tp_rule)
