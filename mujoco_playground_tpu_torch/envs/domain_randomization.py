"""Domain randomization: per-env perturbations of model parameters (the
port of the JAX package's ``envs/domain_randomization.py``).

Selected leaves of the :class:`Model` get a leading env axis; the env step
hands the randomized model and the base model to ``engine.step_batch``,
which packs the nine per-env scalars for kernel K1e.  Randomized quantities
(multiplicative log-uniform scales unless noted): wheel friction, body
masses with their rotational inertias, joint damping, friction loss and
armature, actuator gain with its bias terms, and the floor height
(additive).  Draws come from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from mujoco_playground_tpu_torch.envs.ackermann_env import (AckermannEnv,
                                                            EnvState)
from mujoco_playground_tpu_torch.physics.model import Model


@dataclasses.dataclass(frozen=True)
class RandomizationConfig:
    friction_scale: tuple = (0.7, 1.3)
    mass_scale: tuple = (0.8, 1.25)
    damping_scale: tuple = (0.7, 1.4)
    frictionloss_scale: tuple = (0.5, 2.0)
    armature_scale: tuple = (0.7, 1.4)
    actuator_gain_scale: tuple = (0.8, 1.25)
    floor_z_offset: tuple = (-0.002, 0.002)


def _log_uniform(generator, shape, lo, hi, model):
    u = torch.rand(shape, generator=generator, dtype=model.dtype,
                   device=model.device)
    return torch.exp(u * (math.log(hi) - math.log(lo)) + math.log(lo))


def randomize_model(model: Model, generator: torch.Generator, num_envs: int,
                    config: RandomizationConfig = RandomizationConfig()
                    ) -> Model:
    """A Model whose randomized leaves have a leading (num_envs,) axis."""
    B = num_envs
    fric = _log_uniform(generator, (B, 1, 1), *config.friction_scale, model)
    mass = _log_uniform(generator, (B, 1), *config.mass_scale, model)
    damp = _log_uniform(generator, (B, 1), *config.damping_scale, model)
    floss = _log_uniform(generator, (B, 1), *config.frictionloss_scale,
                         model)
    arma = _log_uniform(generator, (B, 1), *config.armature_scale, model)
    gain = _log_uniform(generator, (B, 1), *config.actuator_gain_scale,
                        model)
    lo, hi = config.floor_z_offset
    floor = lo + (hi - lo) * torch.rand(B, generator=generator,
                                        dtype=model.dtype,
                                        device=model.device)
    return dataclasses.replace(
        model,
        wheel_friction=model.wheel_friction[None] * fric,
        body_mass=model.body_mass[None] * mass,
        body_inertia=model.body_inertia[None] * mass[..., None],
        dof_damping=model.dof_damping[None] * damp,
        dof_frictionloss=model.dof_frictionloss[None] * floss,
        dof_armature=model.dof_armature[None] * arma,
        actuator_gain=model.actuator_gain[None] * gain,
        # the bias terms scale with the gain, so both servo types keep kp
        # and kv together as "servo strength"
        actuator_bias=model.actuator_bias[None] * gain[..., None],
        plane_z=model.plane_z[None] + floor)


class DomainRandomizedEnv:
    """Batched env with per-slot randomized physics: each env slot keeps its
    own parameters until :meth:`resample` redraws them.  Resets use the
    base model; the randomized parameters act from the first step."""

    def __init__(self, env: AckermannEnv, num_envs: int,
                 generator: torch.Generator,
                 config: RandomizationConfig = RandomizationConfig()):
        self.env = env
        self.num_envs = num_envs
        self.rand_config = config
        self.obs_size = env.obs_size
        self.action_size = env.action_size
        self.config = env.config
        self.models = randomize_model(env.model, generator, num_envs, config)

    def resample(self, generator: torch.Generator):
        self.models = randomize_model(self.env.model, generator,
                                      self.num_envs, self.rand_config)

    def reset(self, num_envs: Optional[int] = None,
              core: Optional[EnvState] = None) -> EnvState:
        return self.env.reset(num_envs or self.num_envs, core=core)

    def step_batch(self, states: EnvState, actions) -> EnvState:
        return self.env.step_batch(states, actions, models=self.models,
                                   base_model=self.env.model)

    def step_autoreset_batch(self, states: EnvState, actions,
                             fresh: Optional[EnvState] = None) -> EnvState:
        """One step with auto-reset, through K1e with the per-env floor
        height in the fused observation and spawn scans."""
        return self.env.step_autoreset_batch(states, actions, fresh=fresh,
                                             models=self.models,
                                             base_model=self.env.model)
