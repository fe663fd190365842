"""Interactive simulation (port of the JAX package's ``main_sim.py``, the
twin of the reference's src/main_sim.py).

Drives the port's per-env step in a 500 Hz wall-clock-paced loop: teleop
cmd_vel -> bicycle controller -> ``physics.engine.step`` (one env, plain
PyTorch on ``--device``) -> lidar (``sensors.lidar_scan``) + odometry
printout, with an optional MuJoCo passive viewer mirroring the port's state
(including the reference's yellow lidar-ray overlay drawn from the port's
raycast distances and ``kinematics.site_frames``, main_sim.py:103-140).

    python -m mujoco_playground_tpu_torch.main_sim       # viewer if available
    python -m mujoco_playground_tpu_torch.main_sim --headless --steps 2000
    python -m mujoco_playground_tpu_torch.main_sim --headless --device cpu
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from mujoco_playground_tpu_torch.core.controller import \
    bicycle_cmd_vel_to_controls
from mujoco_playground_tpu_torch.core.odometry import (calculate_odom,
                                                       odometry_reset)
from mujoco_playground_tpu_torch.physics import engine, kinematics, sensors
from mujoco_playground_tpu_torch.physics.model import make_model
from mujoco_playground_tpu_torch.physics.state import make_state
from mujoco_playground_tpu_torch.spec.robot import ackermann_robot_v2
from mujoco_playground_tpu_torch.spec.scene import (maze_flat_scene,
                                                    open_floor_scene)
from mujoco_playground_tpu_torch.teleop.keyboard import MujocoTeleop


def main(argv=None):
    """Run the loop; returns the final physics state (one env)."""
    p = argparse.ArgumentParser(description="Interactive Ackermann sim")
    p.add_argument("--scene", default="floor", choices=["floor", "maze_flat"])
    p.add_argument("--headless", action="store_true",
                   help="no viewer; scripted figure-8 drive")
    p.add_argument("--steps", type=int, default=0,
                   help="stop after N steps (0 = run until closed)")
    p.add_argument("--print-every", type=int, default=50)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "on the CPU)")
    args = p.parse_args(argv)

    scene = maze_flat_scene() if args.scene == "maze_flat" else open_floor_scene()
    model = make_model(ackermann_robot_v2(), scene, device=args.device)
    qpos = model.qpos0.clone()
    qpos[2] = 0.1
    state = make_state(model, qpos=qpos)
    teleop = MujocoTeleop()
    odom_ref = odometry_reset(state.xpos[1], state.xquat[1])

    viewer = None
    mj_model = mj_data = None
    if not args.headless:
        try:
            import mujoco
            import mujoco.viewer

            from mujoco_playground_tpu_torch.spec.mjcf import to_mjcf
            mj_model = mujoco.MjModel.from_xml_string(
                to_mjcf(ackermann_robot_v2(), scene))
            mj_data = mujoco.MjData(mj_model)
            viewer = mujoco.viewer.launch_passive(
                mj_model, mj_data, key_callback=teleop.key_callback)
        except Exception as e:  # headless box, no GL, no mujoco, etc.
            print(f"(viewer unavailable: {e}; running headless)")

    timestep = float(model.timestep)
    t = 0
    try:
        while (viewer is None or viewer.is_running()) and (
                args.steps == 0 or t < args.steps):
            step_start = time.time()
            if viewer is None:
                # scripted drive so headless mode exercises the full loop
                cmd = {"linear_x": 0.5,
                       "angular_z": 0.8 * math.sin(t * timestep)}
            else:
                cmd = teleop.get_cmd_vel()
            ctrl = bicycle_cmd_vel_to_controls(
                *(torch.tensor(cmd[k], dtype=model.dtype, device=model.device)
                  for k in ("linear_x", "angular_z")))
            state = engine.step(model, state.replace(ctrl=ctrl))
            t += 1

            if t % args.print_every == 0:
                lidar = sensors.lidar_scan(model, state).cpu().numpy()
                odom = calculate_odom(odom_ref, state.xpos[1], state.xquat[1])
                print("Lidar scan:", np.round(lidar, 2))
                print(f"Odometry - Position: "
                      f"{np.round(odom['position'].cpu().numpy(), 3)}, "
                      f"Heading: {float(odom['heading']):.3f}, "
                      f"Distance: {float(odom['distance']):.3f}")

            if viewer is not None:
                _sync_viewer(viewer, mj_model, mj_data, model, state)
            time.sleep(max(0.0, timestep - (time.time() - step_start)))
    except KeyboardInterrupt:
        pass
    if viewer is not None:
        viewer.close()
    return state


def _sync_viewer(viewer, mj_model, mj_data, model, state):
    import mujoco
    mj_data.qpos[:] = state.qpos.cpu().numpy()
    mj_data.qvel[:] = state.qvel.cpu().numpy()
    mujoco.mj_forward(mj_model, mj_data)
    # lidar ray overlay from the port's raycast (reference main_sim.py:103-140)
    lidar = sensors.lidar_scan(model, state).cpu().numpy()
    pos, zaxis = kinematics.site_frames(model, state.xpos, state.xquat)
    pos, zaxis = pos.cpu().numpy(), zaxis.cpu().numpy()
    scn = viewer.user_scn
    scn.ngeom = 0
    rgba = np.array([1.0, 1.0, 0.0, 0.9])
    for i in range(len(lidar)):
        if scn.ngeom >= scn.maxgeom:
            break
        length = float(min(12.0, max(0.0, lidar[i])))
        geom = scn.geoms[scn.ngeom]
        mujoco.mjv_connector(geom, mujoco.mjtGeom.mjGEOM_LINE, 0.01,
                             pos[i], pos[i] + zaxis[i] * length)
        geom.rgba[:] = rgba
        scn.ngeom += 1
    viewer.sync()


if __name__ == "__main__":
    main()
