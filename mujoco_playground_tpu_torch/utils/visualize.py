"""Trajectory / scan visualization (port of the JAX package's
``utils/visualize.py``; matplotlib, optional).

The reference's only visualization is the live MuJoCo viewer; for headless
boxes this renders rollouts to PNG: maze layout, robot path, goal, and
optionally lidar scans at waypoints.  matplotlib is an optional dependency
(as in the reference's requirements.txt), imported on first use with the
``Agg`` backend.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def plot_trajectory(scene, positions, goal=None, start=None,
                    lidar_frames=None, path: str = "trajectory.png",
                    title: Optional[str] = None):
    """Render a top-down trajectory plot.

    Args:
      scene: SceneSpec (box obstacles drawn as rectangles).
      positions: (T, 2) world-frame xy path of the chassis.
      goal: optional (2,) goal position (world frame).
      start: optional (2,) start position.
      lidar_frames: optional list of (origin(2,), dirs(n,2), dists(n,))
        tuples to overlay scans.
      path: output PNG path.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    fig, ax = plt.subplots(figsize=(7, 7))
    for k in range(scene.num_boxes):
        cx, cy = scene.box_pos[k][:2]
        hx, hy = scene.box_size[k][:2]
        ax.add_patch(Rectangle((cx - hx, cy - hy), 2 * hx, 2 * hy,
                               facecolor="#444455", edgecolor="none"))
    positions = np.asarray(positions)
    ax.plot(positions[:, 0], positions[:, 1], "-", color="#1f77b4", lw=1.5,
            label="trajectory")
    if start is not None:
        ax.plot(*np.asarray(start)[:2], "o", color="#2ca02c", ms=10,
                label="start")
    if goal is not None:
        ax.plot(*np.asarray(goal)[:2], "*", color="#d62728", ms=18,
                label="goal")
    if lidar_frames:
        for origin, dirs, dists in lidar_frames:
            d = np.where(np.asarray(dists) < 0, 0.0, np.asarray(dists))
            ends = np.asarray(origin)[None] + np.asarray(dirs) * d[:, None]
            for e in ends:
                ax.plot([origin[0], e[0]], [origin[1], e[1]],
                        color="#ffbb33", alpha=0.25, lw=0.5)
    ax.set_aspect("equal")
    ax.legend(loc="upper right")
    ax.set_title(title or scene.name)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def rollout_and_plot(env, policy_fn, generator=None, max_steps: int = 1000,
                     path: str = "trajectory.png"):
    """Play one episode with policy_fn(obs (1, obs_size)) -> action (1, 2)
    through the per-env ``env.reset``/``env.step`` and plot it.  The reset
    draws from ``generator`` (default: the env's own)."""
    import torch

    from mujoco_playground_tpu_torch.envs.ackermann_env import _unbatch1

    state = _unbatch1(env.reset(1, generator=generator))
    ref = state.odom_ref.position[:2].cpu().numpy()
    goal_world = state.goal.cpu().numpy() + ref
    positions = [state.physics.xpos[1][:2].cpu().numpy()]
    with torch.no_grad():
        for _ in range(max_steps):
            action = policy_fn(state.obs[None])[0]
            state = env.step(state, action)
            positions.append(state.physics.xpos[1][:2].cpu().numpy())
            if bool(state.done):
                break
    return plot_trajectory(
        env.scene, np.asarray(positions), goal=goal_world, start=positions[0],
        path=path,
        title=f"{env.scene.name}: return-ish len={len(positions)} "
              f"success={bool(state.terminated)}")
