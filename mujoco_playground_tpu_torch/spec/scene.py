"""Static scene specs: floor + axis-aligned box obstacles.

Replaces the reference's three arena sources with one uniform representation:

* the bare open floor (reference ``SimpleMapSpawner``,
  src/rl/envs/simple_map_spawner.py:22-54),
* the hand-authored obstacle grid
  (``models/environments/ackermann_maze_flat.xml:26-139`` — 38 1x1 m boxes on
  an 8x8 m grid),
* the Gymnasium-Robotics PointMaze arenas that the reference grafts in via
  runtime XML surgery (src/rl/envs/ackermann_gymnasium_maze_env.py:237-398).
  Here a maze is just *layout data* — a cell grid expanded once into box
  arrays at model-compile time, so env reset never recompiles anything.

All obstacles are axis-aligned boxes, which keeps broadphase, contact and the
lidar raycast fully vectorizable (ray-AABB slab tests) on the device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

# PointMaze cell grids (1 = wall). Transcribed from gymnasium_robotics's maze
# registry (the reference consumes these via gym.make, maze_env.py:87).
POINTMAZE_MAPS = {
    "PointMaze_UMaze-v3": [
        [1, 1, 1, 1, 1],
        [1, 0, 0, 0, 1],
        [1, 1, 1, 0, 1],
        [1, 0, 0, 0, 1],
        [1, 1, 1, 1, 1],
    ],
    "PointMaze_Open-v3": [
        [1, 1, 1, 1, 1, 1, 1],
        [1, 0, 0, 0, 0, 0, 1],
        [1, 0, 0, 0, 0, 0, 1],
        [1, 0, 0, 0, 0, 0, 1],
        [1, 1, 1, 1, 1, 1, 1],
    ],
    "PointMaze_Medium-v3": [
        [1, 1, 1, 1, 1, 1, 1, 1],
        [1, 0, 0, 1, 1, 0, 0, 1],
        [1, 0, 0, 1, 0, 0, 0, 1],
        [1, 1, 0, 0, 0, 1, 1, 1],
        [1, 0, 0, 1, 0, 0, 0, 1],
        [1, 0, 1, 0, 0, 1, 0, 1],
        [1, 0, 0, 0, 1, 0, 0, 1],
        [1, 1, 1, 1, 1, 1, 1, 1],
    ],
    "PointMaze_Large-v3": [
        [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
        [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 1],
        [1, 0, 1, 1, 0, 1, 0, 1, 0, 1, 0, 1],
        [1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1],
        [1, 0, 1, 1, 1, 1, 0, 1, 1, 1, 0, 1],
        [1, 0, 0, 1, 0, 1, 0, 0, 0, 0, 0, 1],
        [1, 1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 1],
        [1, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1],
        [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
    ],
}

# Short aliases used by the reference trainer CLI (train.py:245-248).
MAZE_ALIASES = {
    "umaze": "PointMaze_UMaze-v3",
    "open": "PointMaze_Open-v3",
    "medium": "PointMaze_Medium-v3",
    "large": "PointMaze_Large-v3",
}

# The 38-obstacle grid of models/environments/ackermann_maze_flat.xml (all
# boxes are half-size 0.5x0.5x0.1 at z=0.05).
_MAZE_FLAT_XY = [
    (-4.0, -4.0), (-4.0, -3.0), (-4.0, -2.0), (-4.0, -1.0), (-4.0, 0.0),
    (-4.0, 1.0), (-4.0, 2.0), (-4.0, 3.0), (-3.0, -4.0), (-3.0, -1.0),
    (-3.0, 3.0), (-2.0, -4.0), (-2.0, -1.0), (-2.0, 1.0), (-2.0, 3.0),
    (-1.0, -4.0), (-1.0, -3.0), (-1.0, 2.0), (-1.0, 3.0), (0.0, -4.0),
    (0.0, -3.0), (0.0, -2.0), (0.0, 0.0), (0.0, 3.0), (1.0, -4.0),
    (1.0, 1.0), (1.0, 3.0), (2.0, -4.0), (2.0, -1.0), (2.0, 3.0),
    (3.0, -4.0), (3.0, -3.0), (3.0, -2.0), (3.0, -1.0), (3.0, 0.0),
    (3.0, 1.0), (3.0, 2.0), (3.0, 3.0),
]


@dataclasses.dataclass
class SceneSpec:
    """Floor plane + K axis-aligned boxes (static world geometry)."""

    name: str
    floor_z: float = 0.0
    floor_friction: Tuple[float, float, float] = (1.0, 0.005, 0.0001)
    # (K, 3) box centers and (K, 3) half-sizes, axis-aligned, world frame.
    box_pos: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3)))
    box_size: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3)))
    # Free (non-wall) cell centers for start/goal sampling, (M, 2); empty for
    # scenes without a cell structure.
    free_cells: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2)))
    cell_size: float = 1.0

    @property
    def num_boxes(self) -> int:
        return len(self.box_pos)


def merge_aabbs(pos, size, eps: float = 1e-9):
    """Exact-union merge of axis-aligned boxes: collinear runs of touching
    boxes with identical cross-sections become one box.

    The union SOLID is unchanged, so ray entry distances (lidar) and outer
    contact surfaces are identical — but the raycast and the per-pair
    nearest-box contact loops scale with the box COUNT, and a maze's wall
    cells merge into a handful of long slabs (umaze: 17 -> 7).  Iterates
    axis merges to a fixpoint (a row merge can enable a column merge).
    """
    import collections

    if len(pos) == 0:
        return np.asarray(pos), np.asarray(size)
    boxes = np.concatenate([np.asarray(pos, np.float64)
                            - np.asarray(size, np.float64),
                            np.asarray(pos, np.float64)
                            + np.asarray(size, np.float64)], axis=-1)

    def merge_axis(bs, ax):
        others = [o for o in range(3) if o != ax]
        groups = collections.defaultdict(list)
        for b in bs:
            # EXACT cross-section equality (no rounding): grid callers
            # build shared coordinates from identical float expressions,
            # and snapping nearly-equal cross-sections together would
            # break the exact-union contract by a sliver.  A non-matching
            # cross-section merely stays unmerged (perf, not correctness).
            key = tuple(float(b[o]) for o in others) + \
                tuple(float(b[3 + o]) for o in others)
            groups[key].append(b)
        out = []
        for g in groups.values():
            g.sort(key=lambda b: float(b[ax]))
            cur = g[0].copy()
            for b in g[1:]:
                if float(b[ax]) <= float(cur[3 + ax]) + eps:
                    cur[3 + ax] = max(float(cur[3 + ax]), float(b[3 + ax]))
                else:
                    out.append(cur)
                    cur = b.copy()
            out.append(cur)
        return np.stack(out)

    while True:
        n = len(boxes)
        for ax in (0, 1, 2):
            boxes = merge_axis(boxes, ax)
        if len(boxes) == n:
            break
    lo, hi = boxes[:, :3], boxes[:, 3:]
    return (lo + hi) / 2, (hi - lo) / 2


def open_floor_scene() -> SceneSpec:
    """Bare floor (the reference's SimpleMapSpawner arena)."""
    return SceneSpec(name="simple_floor")


def maze_flat_scene() -> SceneSpec:
    """The 38-box obstacle grid of ackermann_maze_flat.xml."""
    xy = np.asarray(_MAZE_FLAT_XY)
    pos = np.concatenate([xy, np.full((len(xy), 1), 0.05)], axis=1)
    size = np.tile(np.array([[0.5, 0.5, 0.1]]), (len(xy), 1))
    return SceneSpec(name="ackermann_maze_flat", box_pos=pos, box_size=size)


def normalize_maze_map(maze_map) -> np.ndarray:
    """Arbitrary gymnasium_robotics-style cell grid -> int wall grid.

    Accepts the registry's mixed-type maps: ``1`` is a wall; ``0`` and the
    string markers ``'r'``/``'g'``/``'c'`` (reset / goal / combined cells)
    are free.  Rows must be equal length.
    """
    rows = [[1 if c == 1 else 0 for c in row] for row in maze_map]
    if len({len(r) for r in rows}) > 1:
        raise ValueError("maze_map rows have unequal lengths")
    return np.asarray(rows, dtype=int)


def registry_maze_map(maze_id: str):
    """Fetch the cell grid for ANY registered PointMaze env id.

    The reference creates the full gym env and steals its generated XML
    (src/rl/envs/ackermann_gymnasium_maze_env.py:84-98); here only the
    layout *data* is read from the registry spec — no env, no XML.
    gymnasium and gymnasium_robotics are imported here, on first use.
    """
    import gymnasium as gym
    import gymnasium_robotics  # noqa: F401  (registers the PointMaze ids)
    try:
        spec = gym.spec(maze_id)
    except Exception as e:
        raise KeyError(
            f"maze id {maze_id!r} not in the transcribed maps nor the "
            f"gymnasium registry") from e
    maze_map = spec.kwargs.get("maze_map")
    if maze_map is None:
        raise KeyError(f"{maze_id!r} is registered but has no maze_map kwarg "
                       f"(not a PointMaze env?)")
    return maze_map


def pointmaze_scene(maze_id: str = "PointMaze_UMaze-v3",
                    floor_z: float = -0.5,
                    maze_height: float = 0.4,
                    size_scaling: float = 1.0,
                    maze_map=None) -> SceneSpec:
    """PointMaze arena as box layout data.

    Reproduces the reference's merged-maze geometry *after* its XML surgery
    (maze_env.py:320-355): the maze ground is dropped to z=-0.5 and each wall
    block re-seated so its bottom rests on the ground (center z = floor_z +
    half-height).  Cell (i, j) of the map is centered at
    (x_center - ...), matching gymnasium_robotics's cell_xy convention.

    ``maze_id`` may be any registered PointMaze env id: the four transcribed
    maps (and their short aliases) resolve locally, anything else is
    fetched from the gymnasium registry (``registry_maze_map``).
    ``maze_map`` overrides with an explicit cell grid (any
    gymnasium_robotics-style map).
    """
    maze_id = MAZE_ALIASES.get(maze_id, maze_id)
    if maze_map is not None:
        grid = normalize_maze_map(maze_map)
    elif maze_id in POINTMAZE_MAPS:
        grid = np.asarray(POINTMAZE_MAPS[maze_id])
    else:
        grid = normalize_maze_map(registry_maze_map(maze_id))
    rows, cols = grid.shape
    x_center = cols / 2 * size_scaling
    y_center = rows / 2 * size_scaling
    half = 0.5 * size_scaling
    half_h = maze_height / 2 * size_scaling

    walls, free = [], []
    for i in range(rows):
        for j in range(cols):
            # gymnasium_robotics cell_rowcol_to_xy: x = j*s - x_center + s/2,
            # y = y_center - i*s - s/2.
            x = j * size_scaling - x_center + half
            y = y_center - i * size_scaling - half
            if grid[i, j] == 1:
                walls.append((x, y, floor_z + half_h))
            else:
                free.append((x, y))

    pos = np.asarray(walls)
    size = np.tile(np.array([[half, half, half_h]]), (len(walls), 1))
    # collinear wall cells merge into long slabs — same union solid, so
    # lidar readings and contact surfaces are unchanged, but raycast and
    # nearest-box loops shrink ~2-3x (merge_aabbs docstring)
    pos, size = merge_aabbs(pos, size)
    return SceneSpec(name=maze_id, floor_z=floor_z, box_pos=pos, box_size=size,
                     free_cells=np.asarray(free), cell_size=size_scaling)


def list_available_mazes() -> List[str]:
    """Restores the lost ``make_env.list_available_mazes`` API (reference
    component #17, recovered from bytecode)."""
    return list(POINTMAZE_MAPS.keys())
