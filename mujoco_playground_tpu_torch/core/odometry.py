"""Odometry reference: the chassis pose captured at reset (port of the JAX
package's ``core/odometry.py`` ``OdometryRef``)."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class OdometryRef:
    position: torch.Tensor  # (..., 3) world chassis position at reset
    quat: torch.Tensor      # (..., 4) world chassis orientation at reset

    def replace(self, **kw) -> "OdometryRef":
        return dataclasses.replace(self, **kw)
