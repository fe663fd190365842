"""RL utilities: the port of the JAX package's ``rl/utils.py``."""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def compute_episode_stats(returns: List[float],
                          lengths: List[int]) -> Dict[str, float]:
    """Mean/std/min/max return + length stats (std divides by n)."""
    return {
        'mean_return': float(np.mean(returns)),
        'std_return': float(np.std(returns)),
        'min_return': float(np.min(returns)),
        'max_return': float(np.max(returns)),
        'mean_length': float(np.mean(lengths)),
        'std_length': float(np.std(lengths)),
    }
