"""The window's arithmetic: the rate over the whole window, the 95th
percentile over all steps, the seeded sample of steps, the loop's lag."""
import pytest

from bench_port import window


def test_rate_is_over_the_whole_window():
    assert window.rate(65536, 1000, 8.0) == 65536 * 1000 / 8.0


@pytest.mark.parametrize("n,q,want", [(100, 95.0, 95), (20, 95.0, 19),
                                      (1, 95.0, 1), (2000, 95.0, 1900),
                                      (10, 100.0, 10), (10, 50.0, 5)])
def test_percentile_nearest_rank(n, q, want):
    values = list(range(n, 0, -1))        # n..1, unsorted
    assert window.percentile(values, q) == want


def test_percentile_of_nothing_raises():
    with pytest.raises(ValueError):
        window.percentile([], 95.0)


def test_sampled_steps_check_a_fixed_number_of_env_steps():
    assert window.sampled_steps(65536) == 4
    assert window.sampled_steps(131072) == 2
    assert window.sampled_steps(8) == window.MAX_SAMPLED_STEPS
    assert window.sampled_steps(10**7) == 1


def test_sampler_is_seeded_and_uniform():
    def picks(seed, n=1000):
        s = window.Sampler(seed, k=4)
        for i in range(n):
            s.offer(i, i)
        return sorted(i for i, _ in s.items)
    assert picks(7) == picks(7)
    assert picks(7) != picks(8)
    counts = [0] * 10
    for seed in range(2000):
        for i in picks(seed, 10):
            counts[i] += 1
    assert all(700 < c < 900 for c in counts)     # 4/10 of 2000 each


class _Loop:
    def __init__(self):
        self.spans = window.Spans("drained")
        self.calls = 0

    def step(self, s):
        self.calls += 1
        return s + 1, None, None


def test_run_counts_steps_and_waits():
    loop = _Loop()
    s, steps, wall, gaps = window.run(loop, 0, steps=12, device="cpu")
    assert (s, steps, loop.calls, len(gaps)) == (12, 12, 12, 12)
    assert len(loop.spans.host["bench.wait"]) == 12 - window.LAG
    assert wall >= 0 and all(g >= 0 for g in gaps)


def test_run_for_seconds():
    loop = _Loop()
    _, steps, wall, gaps = window.run(loop, 0, seconds=0.05, device="cpu")
    assert steps == len(gaps) > 0 and wall >= 0.05


def test_drained_spans_start_on_a_synchronised_device(monkeypatch):
    """In the drained stretch each span begins after a synchronise, so it
    times the host's own work, never a wait on a full launch queue."""
    calls = []
    monkeypatch.setattr(window, "synchronize", lambda d: calls.append(d))
    spans = window.Spans("drained", "cuda")
    for _ in range(3):
        with spans("env.step_autoreset_batch"):
            calls.append("span")
    assert calls == ["cuda", "span"] * 3
    assert len(spans.host["env.step_autoreset_batch"]) == 3
    with window.Spans("off")("x"):
        pass
    assert calls == ["cuda", "span"] * 3


def test_stall_report_names_the_longest_steps():
    from bench_port import stalls
    loop = _Loop()
    stamps = []
    with stalls.Watch() as watch:
        _, steps, _, gaps = window.run(loop, 0, steps=8, device="cpu",
                                       stamps=stamps)
    rep = watch.report(gaps, stamps)
    assert len(stamps) == steps == 8
    assert len(rep["longest_gaps_ms"]) == stalls.TOP
    assert all(ms >= 0 and 0 <= i < 8 for ms, i in rep["longest_waits_ms"])
    assert rep["cpu_s"] >= 0 and rep["gc_s"] >= 0
