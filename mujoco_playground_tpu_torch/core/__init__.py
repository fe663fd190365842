"""Controllers, odometry and the cmd_vel bus."""
from mujoco_playground_tpu_torch.core.controller import (  # noqa: F401
    PIDState,
    ackermann_cmd_vel_to_controls,
    bicycle_cmd_vel_to_controls,
    pid_compute,
    pid_init,
)
from mujoco_playground_tpu_torch.core.odometry import (  # noqa: F401
    OdometryRef,
    calculate_odom,
    get_bearing_to_point,
    get_distance_to_point,
    odometry_reset,
)
from mujoco_playground_tpu_torch.core.cmd_vel import (  # noqa: F401
    CmdVelPublisher,
    Twist,
    Vector3,
    cmd_vel_publisher,
)
