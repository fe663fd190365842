"""The per-layer readers (``metrics/<name>.py``) on a made-up trace: each
reads what its docstring says, from the source ``BENCHMARK.json`` names,
and returns nothing where there is nothing to read."""
import pytest

from bench_port import counts, manifest, trace

K1 = "void k1_kernel<1, 1, 0, 0>(Params)"


def _trace(policy_ops=0):
    tr = trace.Trace(1000)
    tr.steps, tr.t0, tr.window_us = 10, 0.0, 20_000.0
    # per step: K1 1.5 ms launched in the env span, a 0.1 ms glue kernel;
    # the device idle 0.4 ms of each 2 ms step
    for i in range(10):
        t = 2000.0 * i
        tr.kernels += [(K1, t, 1500.0, "env.step_autoreset_batch"),
                       ("elementwise", t + 1500.0, 100.0, "policy.forward")]
        tr.device += [(t, t + 1500.0), (t + 1500.0, t + 1600.0)]
    tr.host_spans = {"env.step_autoreset_batch": [0.003, 0.001, 0.002]}
    tr.k1_ops, tr.k1_bytes, tr.policy_ops = 70_000.0, 1000, policy_ops
    return tr


def _read(name, tr):
    return manifest.reader(name)(tr)


def test_k1_readings():
    tr = _trace()
    assert _read("k1_ms", tr) == pytest.approx(1.5)
    bound, _ = counts.bound_ms(1000 * 1000, 70_000.0 * 1000)
    assert _read("k1_roofline", tr) == pytest.approx(100 * bound / 1.5)


@pytest.mark.parametrize("policy_ops", [0, 174_756])
def test_step_mfu_is_over_the_traced_busy_time(policy_ops):
    """All the step's counted work over the device's busy time in the
    profiled stretch (16 ms of its 20 ms), not the host's window."""
    tr = _trace(policy_ops)
    want = ((70_000.0 + policy_ops) * 1000 * 10 / 0.016 / counts.PEAK_F32
            * 100)
    assert _read("step_mfu", tr) == pytest.approx(want)


def test_device_shares_and_launches():
    tr = _trace()
    assert _read("idle_share", tr) == pytest.approx(20.0)
    assert _read("launches_per_step", tr) == 2.0
    assert _read("policy_ms", tr) == pytest.approx(0.1)


def test_env_host_ms_is_the_median_span():
    assert _read("env_host_ms", _trace()) == pytest.approx(2.0)


@pytest.mark.parametrize("name", [m["name"] for m in
                                  manifest.benchmark()["per_layer"]])
def test_nothing_to_read_gives_nothing(name):
    assert _read(name, trace.Trace(1000)) is None


@pytest.mark.parametrize("name,source", [
    ("step_mfu", "device_trace"), ("k1_roofline", "device_trace"),
    ("env_host_ms", "host_clock")])
def test_sources(name, source):
    m = {m["name"]: m for m in manifest.benchmark()["per_layer"]}[name]
    assert m["source"] == source
