"""Data-parallel training and rollouts over ``torch.distributed``: the
JAX package's ``miniworld_tpu.parallel``, with ``dist`` in place of its
mesh module. The default process group is the mesh, each rank a device
of its ``data`` axis, so ``make_mesh``, ``env_sharding`` and
``DATA_AXIS`` have no counterpart here."""

from miniworld_tpu_torch.parallel.dist import (  # noqa: F401
    init_multihost,
    rank,
    replicate,
    reset_shard,
    shard_env_batch,
    shard_slice,
    world_size,
)
from miniworld_tpu_torch.parallel.rollout import (  # noqa: F401
    make_sharded_rollout,
)
from miniworld_tpu_torch.parallel.train import (  # noqa: F401
    make_ppo_step,
    make_train_step,
)
