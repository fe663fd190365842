"""Numpy-only model specs: the Ackermann robot and the static scenes."""
from mujoco_playground_tpu_torch.spec.types import (  # noqa: F401
    ActuatorSpec,
    BodySpec,
    EqualitySpec,
    GeomSpec,
    JointSpec,
    ModelSpec,
    OptionSpec,
    SensorSpec,
    SiteSpec,
)
from mujoco_playground_tpu_torch.spec.robot import (  # noqa: F401
    ackermann_robot_legacy,
    ackermann_robot_v2,
)
from mujoco_playground_tpu_torch.spec.scene import (  # noqa: F401
    SceneSpec,
    maze_flat_scene,
    normalize_maze_map,
    open_floor_scene,
    pointmaze_scene,
    registry_maze_map,
)
