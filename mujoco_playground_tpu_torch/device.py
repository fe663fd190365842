"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; a CUDA device that does not exist
    raises instead of quietly running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU")
    return dev
