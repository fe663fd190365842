"""Ackermann navigation environments."""
from mujoco_playground_tpu_torch.envs.ackermann_env import (  # noqa: F401
    AckermannEnv,
    EnvConfig,
    EnvState,
)
from mujoco_playground_tpu_torch.envs.domain_randomization import (  # noqa
    DomainRandomizedEnv,
    RandomizationConfig,
    randomize_model,
)
from mujoco_playground_tpu_torch.envs.make_env import (  # noqa: F401
    list_available_mazes,
    make_ackermann_env,
)
# gymnasium is optional: without it the wrappers keep their API on a plain
# object base (gym_wrapper.py)
from mujoco_playground_tpu_torch.envs.gym_wrapper import (  # noqa: F401
    GymAckermannEnv,
    GymVectorAckermannEnv,
)
