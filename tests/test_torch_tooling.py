"""The port's controllers, odometry, cmd_vel bus and teleop against the JAX
package's on the same inputs (CPU).

* ``ackermann_cmd_vel_to_controls`` on a seeded grid of (v, omega) that
  includes |omega| < 1e-4 (straight ahead) and both clip limits, and
  ``bicycle_cmd_vel_to_controls`` on the same grid: float32 on both sides,
  atol 1e-6 plus rtol 1e-6 (the two libraries' atan/tan may part by an
  ulp; the wheel speeds reach the +-50 clip).
* The PID over 20 updates and the odometry readouts (``odometry_reset``,
  ``calculate_odom``, ``get_distance_to_point``, ``get_bearing_to_point``)
  on seeded float32 poses: atol 1e-6 plus rtol 1e-6.
* The cmd_vel bus (host Python): exact.
* ``MujocoTeleop`` after the same keycode sequences (arrows, the numpad
  diagonals, KP_5, an unmapped key, both clip limits), and its GLFW keycode
  fallback with glfw hidden: exact (the same float operations).
* ``JoystickTeleop``'s ``_apply_deadzone`` on a grid and one pass of
  ``_joystick_loop`` driven by a stub ``pygame`` object, ``list_joysticks``
  and ``start``'s missing-joystick error under the same stub: exact.
"""
import importlib
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from mujoco_playground_tpu.core import controller as jctl
from mujoco_playground_tpu.core import odometry as jodo
from mujoco_playground_tpu.teleop import joystick as jjoy
from mujoco_playground_tpu.teleop import keyboard as jkey
from mujoco_playground_tpu_torch.core import cmd_vel, controller, odometry
from mujoco_playground_tpu_torch.teleop import joystick, keyboard

TOL = dict(atol=1e-6, rtol=1e-6)


def _grid():
    rng = np.random.default_rng(0)
    v = np.concatenate([[-2.0, -0.5, 0.0, 1e-6, 0.5, 2.0],
                        rng.uniform(-1.5, 1.5, 10)])
    omega = np.concatenate([[-3.0, -1.0, -1e-4, -5e-5, 0.0, 5e-5, 9.9e-5,
                             1e-4, 1e-3, 1.0, 3.0],
                            rng.uniform(-2.5, 2.5, 10)])
    vv, ww = np.meshgrid(v, omega, indexing="ij")
    return vv.ravel().astype(np.float32), ww.ravel().astype(np.float32)


@pytest.mark.parametrize("name", ["ackermann_cmd_vel_to_controls",
                                  "bicycle_cmd_vel_to_controls"])
def test_cmd_vel_to_controls_matches_jax(name):
    v, w = _grid()
    assert (np.abs(w) < 1e-4).sum() > 0 and (np.abs(w) >= 1e-4).sum() > 0
    got = getattr(controller, name)(torch.from_numpy(v), torch.from_numpy(w))
    want = np.asarray(getattr(jctl, name)(jnp.asarray(v), jnp.asarray(w)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the straight-ahead branch and the clip limits were reached
    if name == "ackermann_cmd_vel_to_controls":
        straight = np.abs(w) < 1e-4
        assert (got.numpy()[straight, :2] == 0).all()
        assert np.isclose(np.abs(got.numpy()[:, :2]).max(), 0.61)
    assert np.isclose(np.abs(got.numpy()[:, -1]).max(), 50.0)


def test_pid_matches_jax():
    rng = np.random.default_rng(1)
    kp, ki, kd = 2.0, 0.5, 0.01
    ps, js = controller.pid_init(), jctl.pid_init()
    assert ps.integral.dtype == torch.float32 and ps.integral.shape == ()
    for target, current in rng.normal(size=(20, 2)).astype(np.float32):
        pout, ps = controller.pid_compute(
            ps, kp, ki, kd, torch.tensor(target), torch.tensor(current))
        jout, js = jctl.pid_compute(js, kp, ki, kd, jnp.float32(target),
                                    jnp.float32(current))
        np.testing.assert_allclose(float(pout), float(jout), **TOL)
        np.testing.assert_allclose(float(ps.integral), float(js.integral),
                                   **TOL)
        assert float(ps.prev_error) == float(js.prev_error)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_odometry_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ref_pos, pos = rng.normal(size=(2, 3)).astype(np.float32)
    ref_quat, quat = rng.normal(size=(2, 4)).astype(np.float32)
    ref_quat /= np.linalg.norm(ref_quat)
    quat /= np.linalg.norm(quat)
    target = rng.normal(size=3).astype(np.float32)
    pref = odometry.odometry_reset(torch.from_numpy(ref_pos),
                                   torch.from_numpy(ref_quat))
    jref = jodo.odometry_reset(jnp.asarray(ref_pos), jnp.asarray(ref_quat))
    got = odometry.calculate_odom(pref, torch.from_numpy(pos),
                                  torch.from_numpy(quat))
    want = jodo.calculate_odom(jref, jnp.asarray(pos), jnp.asarray(quat))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **TOL)
    np.testing.assert_allclose(
        float(odometry.get_distance_to_point(torch.from_numpy(pos), target)),
        float(jodo.get_distance_to_point(jnp.asarray(pos), target)), **TOL)
    np.testing.assert_allclose(
        float(odometry.get_bearing_to_point(torch.from_numpy(pos), target)),
        float(jodo.get_bearing_to_point(jnp.asarray(pos), target)), **TOL)


def test_cmd_vel_bus_publishes_to_subscribers_in_order():
    bus = cmd_vel.CmdVelPublisher()
    assert bus.get_latest() == cmd_vel.Twist()
    seen_a, seen_b = [], []
    bus.subscribe(seen_a.append)
    bus.subscribe(lambda m: seen_b.append(m.angular.z))
    msgs = [cmd_vel.Twist(linear=cmd_vel.Vector3(x=0.1 * i),
                          angular=cmd_vel.Vector3(z=-0.2 * i))
            for i in range(3)]
    for m in msgs:
        bus.publish(m)
    assert seen_a == msgs
    assert seen_b == [m.angular.z for m in msgs]
    assert bus.get_latest() is msgs[-1]
    assert isinstance(cmd_vel.cmd_vel_publisher, cmd_vel.CmdVelPublisher)


_MAPPED = [keyboard.KEY_KP_1, keyboard.KEY_KP_2, keyboard.KEY_KP_3,
           keyboard.KEY_KP_4, keyboard.KEY_KP_6, keyboard.KEY_KP_7,
           keyboard.KEY_KP_8, keyboard.KEY_KP_9, keyboard.KEY_UP,
           keyboard.KEY_DOWN, keyboard.KEY_LEFT, keyboard.KEY_RIGHT]


def _sequences():
    rng = np.random.default_rng(3)
    return {
        "random": [int(k) for k in rng.choice(
            _MAPPED + [keyboard.KEY_KP_5, 65], size=300)],
        "saturate": ([keyboard.KEY_KP_7] * 25 + [keyboard.KEY_KP_3] * 40
                     + [keyboard.KEY_RIGHT] * 9 + [keyboard.KEY_UP] * 12),
        "kp5": ([keyboard.KEY_KP_9] * 4 + [keyboard.KEY_KP_5]
                + [keyboard.KEY_DOWN, keyboard.KEY_LEFT, 65]
                + [keyboard.KEY_KP_5]),
    }


@pytest.mark.parametrize("which", ["random", "saturate", "kp5"])
def test_keyboard_teleop_matches_jax(which):
    keys = _sequences()[which]
    port, ref = keyboard.MujocoTeleop(), jkey.MujocoTeleop()
    lin, ang = set(), set()
    for k in keys:
        port.key_callback(k)
        ref.key_callback(k)
        assert port.get_cmd_vel() == ref.get_cmd_vel(), k
        lin.add(port.get_cmd_vel()["linear_x"])
        ang.add(port.get_cmd_vel()["angular_z"])
    if which == "saturate":
        assert {1.0, -1.0} <= lin and {2.0, -2.0} <= ang
    if which == "kp5":
        assert port.get_cmd_vel() == {"linear_x": 0.0, "angular_z": 0.0}


def test_keyboard_glfw_keycode_fallback(monkeypatch):
    """With glfw absent the module falls back to GLFW's numeric keycodes,
    the values glfw itself (or the JAX module's fallback) gives."""
    names = [n for n in dir(jkey) if n.startswith("KEY_")]
    monkeypatch.setitem(sys.modules, "glfw", None)
    try:
        fallback = importlib.reload(keyboard)
        assert {n: getattr(fallback, n) for n in names} == {
            n: getattr(jkey, n) for n in names}
        t = fallback.MujocoTeleop()
        t.key_callback(329)                # KP_9: forward and right
        assert t.get_cmd_vel() == {"linear_x": 0.1, "angular_z": -0.3}
    finally:
        monkeypatch.undo()
        importlib.reload(keyboard)


def test_joystick_deadzone_matches_jax():
    port, ref = joystick.JoystickTeleop(), jjoy.JoystickTeleop()
    for x in np.linspace(-1.0, 1.0, 41).tolist() + [0.0999, -0.1001]:
        assert port._apply_deadzone(x) == ref._apply_deadzone(x), x


class _StubPygame:
    """The parts of pygame that the joystick teleop reads: one joystick
    with fixed axes and buttons, one batch of events, and a clock whose
    tick ends the loop after its first pass."""
    JOYBUTTONDOWN = 1539

    def __init__(self, axes, buttons, events=(), count=1, on_tick=None):
        stub = self
        self._events = list(events)
        self.on_tick = on_tick
        self.ticks = []

        class _Joystick:
            def __init__(self, i):
                self.index = i

            def init(self):
                pass

            def get_name(self):
                return f"stub pad {self.index}"

            def get_axis(self, i):
                return axes.get(i, 0.0)

            def get_button(self, i):
                return int(i in buttons)

        class _Clock:
            def tick(self, fps):
                stub.ticks.append(fps)
                if stub.on_tick is not None:
                    stub.on_tick()

        self.joystick = SimpleNamespace(init=lambda: None,
                                        get_count=lambda: count,
                                        Joystick=_Joystick)
        self.event = SimpleNamespace(get=self._get_events)
        self.time = SimpleNamespace(Clock=_Clock)

    def init(self):
        pass

    def _get_events(self):
        out, self._events = self._events, []
        return out


_CASES = {
    "enabled": dict(axes={1: -0.6, 3: 0.35}, buttons={5}),
    "disabled": dict(axes={1: -0.6, 3: 0.35}, buttons=set()),
    "estop": dict(axes={1: -0.6, 3: 0.35}, buttons={5},
                  events=[SimpleNamespace(type=1539, button=6)]),
    "deadzone": dict(axes={1: 0.05, 3: -0.95}, buttons={5},
                     events=[SimpleNamespace(type=1539, button=2)]),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_joystick_loop_matches_jax(case):
    out = []
    for cls in (joystick.JoystickTeleop, jjoy.JoystickTeleop):
        t = cls(max_linear=1.5, max_angular=2.5)
        stub = _StubPygame(**_CASES[case])
        stub.on_tick = lambda t=t: setattr(t, "_running", False)
        t._joystick = stub.joystick.Joystick(0)
        t._running = True
        t._joystick_loop(stub)
        assert stub.ticks == [60]
        out.append((t.current_linear_vel, t.current_angular_vel, t.enabled,
                    t.estopped))
    assert out[0] == out[1]
    if case == "enabled":
        assert out[0][0] > 0 and out[0][1] < 0
    if case in ("disabled", "estop"):
        assert out[0][:2] == (0.0, 0.0)


def test_joystick_list_and_missing_pad_match_jax(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "pygame",
                        _StubPygame({}, set(), count=2))
    assert joystick.list_joysticks() == jjoy.list_joysticks() == [
        (0, "stub pad 0"), (1, "stub pad 1")]
    joystick.main(["--list"])
    assert "[1] stub pad 1" in capsys.readouterr().out
    for cls in (joystick.JoystickTeleop, jjoy.JoystickTeleop):
        with pytest.raises(RuntimeError, match="joystick 2 not found"):
            cls(joystick_index=2).start()
