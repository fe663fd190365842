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
from mujoco_playground_tpu_torch.envs.make_env import \
    make_ackermann_env  # noqa: F401
