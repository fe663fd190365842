"""The reader of the port's own spans (``port_spans.py``) on a made-up
Chrome trace and made-up memory records: it nests, where ``trace.Trace``
credits a launch to the latest span still open."""
import pytest

from bench_port import port_spans, trace

MAIN = dict(pid=1, tid=7)
OTHER = dict(pid=1, tid=9)


def _span(name, ts, dur, where=MAIN):
    return dict(cat="user_annotation", name=name, ts=ts, dur=dur, **where)


def _launch(ts, corr, where=MAIN):
    return dict(cat="cuda_runtime", name="cudaLaunchKernel", ts=ts, dur=1,
                args=dict(correlation=corr), **where)


def _kernel(name, ts, dur, corr):
    return dict(cat="kernel", name=name, ts=ts, dur=dur, pid=0, tid=7,
                args=dict(correlation=corr))


def _events():
    """One step of 100 us: the env step (0-60) holds step_batch (5-40),
    which holds ops.k1 (10-20); the merge's kernel is launched at 45, after
    step_batch closed but inside the env step; a draw outside the port at
    70, and a span on another thread that contains launch 3's time."""
    return [
        _span(trace.STRETCH, 0, 100),
        _span("env.step_autoreset_batch", 0, 60),     # the benchmark's
        _span("envs.step_autoreset_batch", 1, 58),
        _span("envs.step_batch", 5, 35),
        _span("ops.k1", 10, 10),
        _span("envs.merge", 40, 3),
        _span("rl.policy", 60, 30, OTHER),
        _launch(12, 1), _kernel("k1_kernel<1,1,0,0>", 20, 30, 1),
        _launch(30, 2), _kernel("where", 50, 4, 2),
        _launch(45, 3), _kernel("copy", 54, 6, 3),
        _launch(70, 4), _kernel("randint", 75, 5, 4),
        _launch(41, 5), dict(cat="gpu_memset", name="Memset", ts=60, dur=1,
                             pid=0, tid=7, args=dict(correlation=5)),
    ]


@pytest.fixture
def prof():
    return port_spans.Profiled(_events(), steps=1)


def test_a_kernel_belongs_to_every_span_around_its_launch(prof):
    chains = {n: ch for n, _, _, ch in prof.ops}
    assert chains["k1_kernel<1,1,0,0>"] == (
        "envs.step_autoreset_batch", "envs.step_batch", "ops.k1")
    assert chains["where"] == ("envs.step_autoreset_batch",
                               "envs.step_batch")
    # launched after step_batch closed, inside the env step
    assert chains["copy"] == ("envs.step_autoreset_batch",)
    assert chains["Memset"] == ("envs.step_autoreset_batch", "envs.merge")
    # rl.policy is open at 70 on another thread only
    assert chains["randint"] == ()


def test_the_benchmark_trace_credits_the_late_launch_elsewhere():
    """What ``trace.Trace.host_at`` makes of the same launch times with
    the port's spans in its list: the launch at 45 falls after
    ``envs.merge`` (the latest span begun before it) closed, so it goes to
    ``bench.loop``."""
    tr = trace.Trace(1)
    tr.spans = sorted((e["name"], e["ts"], e["ts"] + e["dur"])
                      for e in _events()[1:6])
    tr.spans.sort(key=lambda s: s[1])
    tr._starts = [s[1] for s in tr.spans]
    assert tr.host_at(45) == trace.IDLE_HOST


def test_readings(prof):
    assert port_spans.envs_glue_ms(prof) == pytest.approx(0.011)
    assert prof.device_ms("ops.k1") == pytest.approx(0.030)
    assert prof.device_ms("envs.step_autoreset_batch") == pytest.approx(
        0.041)
    assert port_spans.rl_policy_ms(prof) is None
    assert port_spans.rl_value_ms(prof) is None


def test_table_accounts_for_every_operation(prof):
    t = prof.table()
    assert t["envs.step_autoreset_batch"]["launches"] == 4
    assert t[port_spans.OUTSIDE] == dict(device_ms=pytest.approx(0.005),
                                         launches=1)
    assert t["envs.step_batch"]["traced_host_self_ms"] == pytest.approx(
        0.025)
    assert t["envs.step_autoreset_batch"]["calls"] == 1
    total = sum(d for _, _, d, _ in prof.ops)
    assert (t["envs.step_autoreset_batch"]["device_ms"]
            + t[port_spans.OUTSIDE]["device_ms"]) == pytest.approx(
        total / 1e3)
    # busy 20-54 (K1 to the where), 54-60 and 60-61, 75-80
    assert prof.coverage() == pytest.approx(41 / 46)


def test_idle_gaps_take_the_innermost_port_span_on_the_main_thread(prof):
    # gaps: 0-20 (middle 10: ops.k1), 61-75 (68: outside the port, the
    # other thread's rl.policy not counted), 80-100 (90: outside)
    assert prof.idle_gaps() == [["ops.k1", 0.020],
                                [port_spans.OUTSIDE, 0.020],
                                [port_spans.OUTSIDE, 0.014]]


def test_no_stretch_raises():
    with pytest.raises(RuntimeError):
        port_spans.Profiled(_events()[1:], steps=1)


RECORDS = [  # name, parent, step, start ns, end ns
    ("rl.policy", -1, 0, 0, 1_000_000),
    ("envs.step_autoreset_batch", -1, 0, 2_000_000, 9_000_000),
    ("envs.step_batch", 1, 0, 2_500_000, 6_000_000),
    ("ops.k1", 2, 0, 3_000_000, 3_400_000),
    ("envs.step_autoreset_batch", -1, 1, 10_000_000, 13_000_000),
    ("envs.step_batch", 4, 1, 10_500_000, 12_000_000),
    ("ops.k1", 5, 1, 11_000_000, 11_200_000),
]


def test_host_readings():
    host = port_spans.Host(RECORDS, steps=2)
    assert port_spans.envs_step_host_ms(host) == pytest.approx(5.0)
    assert port_spans.k1_launch_host_ms(host) == pytest.approx(0.3)
    assert host.self_ms("envs.step_batch") == pytest.approx([3.1, 1.3])
    t = host.table()
    assert t["envs.step_autoreset_batch"] == dict(
        calls=1.0, host_self_ms=pytest.approx((3.5 + 1.5) / 2))
    assert port_spans.k1_launch_host_ms(port_spans.Host([], 1)) is None


def test_step_owner_names_the_step_s_largest_self_time():
    host = port_spans.Host(RECORDS, steps=2)
    assert host.step_owner(0, 9.0) == ("envs.step_autoreset_batch",
                                       pytest.approx(3.5))
    # 8 ms outside the port's 1 + 7 ms of top-level spans
    assert host.step_owner(0, 16.0) == (port_spans.OUTSIDE,
                                        pytest.approx(8.0))


def test_counters_per_step():
    assert port_spans.counters_per_step(
        {"k1.launches": 5, "build.loads": 2},
        {"k1.launches": 105, "build.loads": 2}, 100) == {
        "k1.launches": 1.0, "build.loads": 0.0}
