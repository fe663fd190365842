"""The measurement helpers of ``chip_smoke.py`` that run without a card."""
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def _event(key, device_type, us, count=1):
    return SimpleNamespace(key=key, device_type=device_type,
                           self_device_time_total=us, count=count)


def test_kernel_times_counts_each_kernel_once():
    """An operator's device time is that of the kernels it launched, which
    the trace lists as well: only the kernels count toward device time."""
    events = [_event("aten::mul", DeviceType.CPU, 5.0),
              _event("void elementwise_kernel<mul>", DeviceType.CUDA, 5.0),
              _event("k3_kernel(K3Args)", DeviceType.CUDA, 7.0, count=2),
              _event("aten::empty", DeviceType.CPU, 0.0)]
    got = chip_smoke.kernel_times(events)
    assert got == [(7.0, 2, "k3_kernel(K3Args)"),
                   (5.0, 1, "void elementwise_kernel<mul>")]
    assert sum(t for t, _, _ in got) == 12.0


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="with a CUDA device chip_smoke.py runs in full")
def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without a CUDA device it exits non-zero and prints no result."""
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300,
                          cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
