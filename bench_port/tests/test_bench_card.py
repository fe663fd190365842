"""The harness on the card (skips without one): a short run of each cell
at its own width comes out correct, and a traced run reads K1 and the
device's shares within their ranges.  On one H100:
``python -m pytest bench_port/tests -q -m card``."""
import pytest

from bench_port import run


@pytest.mark.card
@pytest.mark.parametrize("cell", ["umaze_random_64k", "medium_policy_128k"])
def test_cell_runs_correct_on_the_card(card, cell):
    line, _ = run.run_cell(cell, 2**31 + 5, 2.0, False, device=card)
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["metrics"]["env_steps_per_s"]["value"] > 0


@pytest.mark.card
def test_traced_run_reads_the_kernels(card):
    line, _ = run.run_cell("umaze_random_64k", 2**31 + 6, 2.0, True,
                           device=card)
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert line["correct"]
    assert m["k1_ms"] > 0 and 0 < m["k1_roofline"] < 100
    assert 0 < m["step_mfu"] < 100 and 0 <= m["idle_share"] < 100
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert len(line["breakdown"]["device_ops"]) <= 10
