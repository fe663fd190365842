"""The PPO, SAC and TD3 trainers, the device replay buffer, the random
baseline, evaluation and checkpointing (the port of the JAX package's
``rl/``)."""
from mujoco_playground_tpu_torch.rl import ppo  # noqa: F401
from mujoco_playground_tpu_torch.rl import replay_buffer  # noqa: F401
from mujoco_playground_tpu_torch.rl import sac  # noqa: F401
from mujoco_playground_tpu_torch.rl import td3  # noqa: F401
from mujoco_playground_tpu_torch.rl.config import (  # noqa: F401
    RLConfig,
    default_config,
)
from mujoco_playground_tpu_torch.rl.evaluate import (  # noqa: F401
    deterministic_policy,
    evaluate_agent,
)
from mujoco_playground_tpu_torch.rl.networks import ActorCritic  # noqa: F401
from mujoco_playground_tpu_torch.rl.random_policy import (  # noqa: F401
    run_random_baseline,
)
from mujoco_playground_tpu_torch.rl.utils import (  # noqa: F401
    compute_episode_stats,
)
