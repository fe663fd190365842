"""Data parallelism over the env batch on ``torch.distributed`` (the port of
the JAX package's ``parallel/``): the process group (``distributed``), each
rank's shard of the env batch and the collectives the trainers call
(``mesh``), and the sharded train steps of PPO, SAC and TD3 (``dryrun``,
imported on its own: it needs the trainers, which need ``mesh``)."""
from mujoco_playground_tpu_torch.parallel.distributed import (  # noqa: F401
    initialize_distributed,
    local_batch_slice,
)
from mujoco_playground_tpu_torch.parallel.mesh import (  # noqa: F401
    EnvShard,
    all_gather_env,
    broadcast_,
    make_mesh,
    shard_env_states,
    shard_train_state,
)
