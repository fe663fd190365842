"""The plain reference that decides ``correct``: the robot spec, the PointMaze
scene, the model compiler, the settle step, the physics step with its fused
lidar and env rows, the observation, reward, done flags and auto-reset, the
geodesic fields and the policy MLP, in plain PyTorch and numpy.

Frozen from the port's plain versions of these parts and kept here so that
no change to the program moves the yardstick.  Nothing here imports the
port, JAX or the JAX package; it takes nothing the program has made: it
builds its own model, template, fields and tables from the spec and the
configuration, and reads the program's outputs only to judge them.
"""
