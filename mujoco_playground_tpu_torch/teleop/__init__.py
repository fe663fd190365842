from mujoco_playground_tpu_torch.teleop.keyboard import MujocoTeleop  # noqa: F401
