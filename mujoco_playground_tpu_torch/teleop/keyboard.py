"""Keyboard teleop: numpad/arrow key events accumulate a cmd_vel (a copy
of the JAX package's ``teleop/keyboard.py``).

Behavior spec from the reference's MujocoTeleop
(src/teleop/keyboard_teleop.py): +-0.1 increments on linear_x, +-0.3 on
angular_z, numpad diagonals combine both, KP_5 zeroes, clipping to +-1.0
linear / +-2.0 angular.  Implemented as a keycode -> (d_linear, d_angular)
table rather than an if/elif ladder; keycodes are GLFW numeric values (as
delivered by ``mujoco.viewer``'s key_callback), with glfw an optional
import.
"""
from __future__ import annotations

try:
    import glfw
    KEY_KP_1, KEY_KP_2, KEY_KP_3 = glfw.KEY_KP_1, glfw.KEY_KP_2, glfw.KEY_KP_3
    KEY_KP_4, KEY_KP_5, KEY_KP_6 = glfw.KEY_KP_4, glfw.KEY_KP_5, glfw.KEY_KP_6
    KEY_KP_7, KEY_KP_8, KEY_KP_9 = glfw.KEY_KP_7, glfw.KEY_KP_8, glfw.KEY_KP_9
    KEY_UP, KEY_DOWN = glfw.KEY_UP, glfw.KEY_DOWN
    KEY_LEFT, KEY_RIGHT = glfw.KEY_LEFT, glfw.KEY_RIGHT
except ImportError:  # GLFW numeric keycodes (stable constants)
    (KEY_KP_1, KEY_KP_2, KEY_KP_3, KEY_KP_4, KEY_KP_5, KEY_KP_6, KEY_KP_7,
     KEY_KP_8, KEY_KP_9) = range(321, 330)
    KEY_RIGHT, KEY_LEFT, KEY_DOWN, KEY_UP = 262, 263, 264, 265


def _keymap():
    """keycode -> (linear steps, angular steps) in increment units."""
    table = {
        KEY_KP_8: (+1, 0), KEY_UP: (+1, 0),
        KEY_KP_2: (-1, 0), KEY_DOWN: (-1, 0),
        KEY_KP_4: (0, +1), KEY_LEFT: (0, +1),
        KEY_KP_6: (0, -1), KEY_RIGHT: (0, -1),
        KEY_KP_7: (+1, +1), KEY_KP_9: (+1, -1),
        KEY_KP_1: (-1, +1), KEY_KP_3: (-1, -1),
    }
    return table


class MujocoTeleop:
    """Accumulating cmd_vel from viewer key events."""

    def __init__(self, linear_increment=0.1, angular_increment=0.3,
                 linear_limit=1.0, angular_limit=2.0):
        self.cmd_vel = {"linear_x": 0.0, "angular_z": 0.0}
        self.linear_increment = linear_increment
        self.angular_increment = angular_increment
        self.linear_limit = linear_limit
        self.angular_limit = angular_limit
        self._map = _keymap()

    def key_callback(self, keycode):
        if keycode == KEY_KP_5:
            self.cmd_vel = {"linear_x": 0.0, "angular_z": 0.0}
            return
        dl, da = self._map.get(keycode, (0, 0))
        lin = self.cmd_vel["linear_x"] + dl * self.linear_increment
        ang = self.cmd_vel["angular_z"] + da * self.angular_increment
        self.cmd_vel = {
            "linear_x": min(max(lin, -self.linear_limit), self.linear_limit),
            "angular_z": min(max(ang, -self.angular_limit),
                             self.angular_limit),
        }

    def get_cmd_vel(self):
        return self.cmd_vel
