"""On the card (``gpu`` marker; skipped without one): at a size a test run
holds, the harness's run of each cell with the port's CUDA kernels comes
out correct, and its control (the plain reference computed with TF32
allowed, in the program's place) comes out not correct against the
cell's limits.

    PYTHONPATH=src python -m pytest -q -m gpu portbench/tests
"""
import time

import pytest
from conftest import small_config

from portbench.harness import cell

pytestmark = pytest.mark.gpu

SIZES = {
    "dense3tb.mu": dict(m=4, n_local=2048),
    "sparseeb.mu": dict(m=4, n_local=32768, bs=128, nnzb=2000),
    "dense3tb.select": dict(m=4, n_local=1024),
}


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def run(bench, name, device, control):
    cfg = small_config(spec_config(bench, name), **SIZES[name])
    if name == "dense3tb.select":
        cfg.update(rescal_iters=20)
    else:
        cfg["k"] = 10
    return cell.run_cell(bench, name, 2 ** 31 + 101, 0.5, False, device,
                         time.perf_counter(), config=cfg, control=control)


def spec_config(bench, name):
    from portbench.harness import spec
    return spec.workload(bench, name)["config"]


@pytest.mark.parametrize("name", sorted(SIZES))
def test_kernels_are_correct(bench, card, name):
    out = run(bench, name, card, control=False)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("name", sorted(SIZES))
def test_control_is_not_correct(bench, card, name):
    out = run(bench, name, card, control=True)
    assert not out["correct"], out["checks"]
