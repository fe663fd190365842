"""The benchmark of the PyTorch and CUDA port (``mujoco_playground_tpu_torch``):
lockstep env throughput on one card.  ``run.py`` is the entry point."""
