"""Grid sizing (port of ``repro/dist/elastic.py:53`` ``choose_grid``;
``ensemble_plan``, the straggler monitor and the retry loop are not
ported yet)."""
from __future__ import annotations

import math


def choose_grid(n_devices: int) -> int:
    """Largest square-grid side p with p * p <= n_devices (the diagonal
    broadcasts of Alg. 3 need p_r == p_c, paper §6.1.3)."""
    return math.isqrt(n_devices)
