"""Joystick teleop (a copy of the JAX package's ``teleop/joystick.py``) —
twin of the reference's JoystickTeleop
(src/teleop/joystick_teleop.py): pygame event loop at 60 FPS, deadzone
rescaling, RB hold-to-enable safety + Back emergency stop, 20 Hz publisher
thread posting Twist to the module-level cmd_vel bus, ``--list`` enumeration.

pygame is optional (reference requirements.txt lists it as such); importing
this module without it raises only when a joystick is actually requested.
"""
from __future__ import annotations

import argparse
import threading
import time

from mujoco_playground_tpu_torch.core.cmd_vel import (Twist, Vector3,
                                                      cmd_vel_publisher)

AXIS_LINEAR = 1      # left stick vertical
AXIS_ANGULAR = 3     # right stick horizontal
BUTTON_ENABLE = 5    # RB: hold to enable motion
BUTTON_ESTOP = 6     # Back: emergency stop


class JoystickTeleop:
    def __init__(self, joystick_index: int = 0, max_linear: float = 1.0,
                 max_angular: float = 2.0, deadzone: float = 0.1,
                 publish_rate: float = 20.0):
        self.joystick_index = joystick_index
        self.max_linear = max_linear
        self.max_angular = max_angular
        self.deadzone = deadzone
        self.publish_rate = publish_rate
        self.current_linear_vel = 0.0
        self.current_angular_vel = 0.0
        self.enabled = False
        self.estopped = False
        self._running = False
        self._threads = []

    # ------------------------------------------------------------------ api
    def start(self):
        import pygame
        pygame.init()
        pygame.joystick.init()
        if pygame.joystick.get_count() <= self.joystick_index:
            raise RuntimeError(
                f"joystick {self.joystick_index} not found "
                f"({pygame.joystick.get_count()} available)")
        self._joystick = pygame.joystick.Joystick(self.joystick_index)
        self._joystick.init()
        self._running = True
        pub = threading.Thread(target=self._publisher_loop, daemon=True)
        pub.start()
        self._threads.append(pub)
        self._joystick_loop(pygame)

    def stop(self):
        self._running = False

    # -------------------------------------------------------------- internal
    def _apply_deadzone(self, value: float) -> float:
        if abs(value) < self.deadzone:
            return 0.0
        sign = 1.0 if value > 0 else -1.0
        return sign * (abs(value) - self.deadzone) / (1.0 - self.deadzone)

    def _joystick_loop(self, pygame):
        clock = pygame.time.Clock()
        while self._running:
            for event in pygame.event.get():
                if event.type == pygame.JOYBUTTONDOWN:
                    if event.button == BUTTON_ESTOP:
                        self.estopped = True
                        self.current_linear_vel = 0.0
                        self.current_angular_vel = 0.0
            self.enabled = bool(self._joystick.get_button(BUTTON_ENABLE))
            if self.enabled and not self.estopped:
                lin = -self._apply_deadzone(
                    self._joystick.get_axis(AXIS_LINEAR))
                ang = -self._apply_deadzone(
                    self._joystick.get_axis(AXIS_ANGULAR))
                self.current_linear_vel = lin * self.max_linear
                self.current_angular_vel = ang * self.max_angular
            else:
                self.current_linear_vel = 0.0
                self.current_angular_vel = 0.0
            clock.tick(60)

    def _publisher_loop(self):
        period = 1.0 / self.publish_rate
        while self._running:
            msg = Twist(linear=Vector3(x=self.current_linear_vel),
                        angular=Vector3(z=self.current_angular_vel))
            cmd_vel_publisher.publish(msg)
            time.sleep(period)


def list_joysticks():
    import pygame
    pygame.init()
    pygame.joystick.init()
    out = []
    for i in range(pygame.joystick.get_count()):
        j = pygame.joystick.Joystick(i)
        out.append((i, j.get_name()))
        print(f"[{i}] {j.get_name()}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Joystick teleop")
    p.add_argument("--list", action="store_true", help="list joysticks")
    p.add_argument("--index", type=int, default=0)
    args = p.parse_args(argv)
    if args.list:
        list_joysticks()
        return
    JoystickTeleop(joystick_index=args.index).start()


if __name__ == "__main__":
    main()
