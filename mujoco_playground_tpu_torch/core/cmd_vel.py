"""ROS-style Twist message types + in-process pub/sub bus (host-side).

A copy of the JAX package's ``core/cmd_vel.py`` (the reference's cmd_vel
message layer): teleop publishes here to feed the interactive sim loop.
Host-side glue, not device code: the step consumes plain (linear_x,
angular_z) floats.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, List


@dataclasses.dataclass
class Vector3:
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0


@dataclasses.dataclass
class Twist:
    linear: Vector3 = dataclasses.field(default_factory=Vector3)
    angular: Vector3 = dataclasses.field(default_factory=Vector3)


class CmdVelPublisher:
    """Thread-safe in-process pub/sub for Twist messages."""

    def __init__(self):
        self._subscribers: List[Callable[[Twist], None]] = []
        self._latest = Twist()
        self._lock = threading.Lock()

    def publish(self, msg: Twist) -> None:
        with self._lock:
            self._latest = msg
            subs = list(self._subscribers)
        for cb in subs:
            cb(msg)

    def subscribe(self, callback: Callable[[Twist], None]) -> None:
        with self._lock:
            self._subscribers.append(callback)

    def get_latest(self) -> Twist:
        with self._lock:
            return self._latest


# Module-level singleton, like the reference's cmd_vel_publisher
# (cmd_vel_message.py:62).
cmd_vel_publisher = CmdVelPublisher()
