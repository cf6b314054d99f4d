"""Data- and tensor-parallel training over ``torch.distributed``: the mesh
and sharding layout (``mesh.py``), the sharded rollout driver
(``rollout.py``) and the multi-rank dry run (``dryrun.py``)."""

from minigrid_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    make_mesh,
    param_shardings,
    shard_batch,
    shard_params,
)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "batch_sharding", "make_mesh",
    "param_shardings", "shard_batch", "shard_params",
]
