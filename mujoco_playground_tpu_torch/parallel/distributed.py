"""Process-group set-up for data parallelism over the env batch: the port of
the JAX package's ``parallel/distributed.py``.

Call :func:`initialize_distributed` once per process before building the
trainers; afterwards ``parallel.mesh.make_mesh`` gives each rank its shard
of the env batch.  Nothing here detects a cluster: the caller names the
rendezvous (``tcp://host:port``), the world size and the rank.  The
backend is NCCL for CUDA tensors (one rank per card) and gloo on the CPU;
gloo also takes CUDA tensors, staging them through the host, which is how
several ranks share one card (NCCL refuses two ranks on one device).
"""
from __future__ import annotations

import datetime
from typing import Optional

import torch.distributed as dist

from mujoco_playground_tpu_torch.device import resolve_device
from mujoco_playground_tpu_torch.parallel.mesh import make_mesh


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None, device=None,
                           timeout_s: float = 300.0) -> bool:
    """Join the process group if a multi-process run is asked for.

    Returns False, doing nothing, when neither ``init_method`` nor
    ``world_size`` is given (one process); True once the group is up.
    ``backend`` defaults to NCCL when ``device`` (default: the CUDA card)
    is a CUDA device and to gloo on the CPU.  A rendezvous that fails
    within ``timeout_s`` seconds, or NCCL missing from this build, raises:
    there is no fallback to one process or to another backend."""
    if init_method is None and world_size is None:
        return False
    if init_method is None or world_size is None or rank is None:
        raise ValueError("a multi-process run needs init_method, world_size "
                         "and rank")
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("the NCCL backend is not available in this "
                           "PyTorch build")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def local_batch_slice(global_batch: int) -> slice:
    """This rank's rows of a globally sharded env batch (the whole batch
    without a process group).  The batch must split evenly."""
    return make_mesh(global_batch).rows
