"""The benchmark's own tests: the harness at small sizes on the CPU, and
(``gpu`` marker) the control and a small run on the card.

    PYTHONPATH=src python -m pytest portbench/tests -q
"""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for path in (ROOT, ROOT / "src"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

from portbench.harness import spec  # noqa: E402

# a dense block, a BCSR shard and a sweep that a test run holds
SMALL_SHARES = {
    "dense": {"operand": "dense", "m": 3, "n_local": 64},
    "bcsr": {"operand": "bcsr", "m": 3, "n_local": 64, "bs": 8,
             "nnzb": 12},
}


def small_config(name: str, **share) -> dict:
    """Configuration ``name`` cut to a small share (and, for the sweep,
    k = 2..4 with 10 MU iterations)."""
    cfg = copy.deepcopy(spec.config(name))
    small = dict(SMALL_SHARES[cfg["share"]["operand"]], **share)
    cfg["share"] = small
    cfg.update(k=4, k_min=2, k_max=4, rescal_iters=10)
    return cfg


@pytest.fixture(scope="session")
def bench():
    return spec.load_benchmark()
