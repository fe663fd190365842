from mujoco_playground_tpu_torch.utils.logging import (  # noqa: F401
    MetricsLogger,
)
from mujoco_playground_tpu_torch.utils.profiler import (  # noqa: F401
    trace_context,
)
