"""mujoco_playground_tpu_torch: the PyTorch/CUDA port of mujoco_playground_tpu.

The Ackermann goal-navigation environment steps thousands of lockstep envs
on one NVIDIA H100 through hand-written CUDA kernels (``csrc/``): the fused
physics step (``ops/step.py``) and the 72-beam lidar scan (``ops/lidar.py``).
Each kernel has a plain PyTorch twin that CPU tensors take.
"""

__version__ = "0.1.0"
