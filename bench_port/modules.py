"""The check that the benchmark's process holds no JAX: top-level module
names (the part before the first dot) compared whole, so the port's own
name, which begins with the JAX package's, is not taken for it."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "mujoco_playground_tpu")
PORT = "mujoco_playground_tpu_torch"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(names=None, extra=()) -> list:
    """Sorted loaded module names whose top-level name is forbidden
    (``extra`` adds names, such as the port for the reference)."""
    bad = set(FORBIDDEN) | set(extra)
    names = sys.modules if names is None else names
    return sorted(n for n in names if top_level(n) in bad)
