"""The port's CUDA kernels on a card: each against its plain version, and a
small sweep through the kernels against the same sweep on the CPU.

Every test here needs a CUDA device (marker ``gpu``) and skips without
one.  The file imports neither ``jax`` nor ``repro``, so it runs on a
machine that has only PyTorch; from the root of a checkout there:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

(``--noconftest``: ``tests/conftest.py`` imports jax for ``repro``'s
tests.)  ``chip_smoke.py`` runs the same comparisons at the sweep's
full shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import sparse as tsp
from repro_torch.kernels import bcsr_fused, bcsr_spmm, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.policy import KernelPolicy
from repro_torch.selection import ArrayDraws, RescalkConfig, SweepScheduler

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "mode (chip_smoke.py runs these checks on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rel_err(got, ref):
    return float(torch.linalg.vector_norm(got - ref)
                 / torch.linalg.vector_norm(ref))


# (n, bs, block density, k, members): bs | n with shared data; bs not
# dividing n with r = 4 members; a 32-wide block with k = 16
GPU_CASES = [(256, 128, 0.3, 8, None), (200, 64, 0.3, 3, 4),
             (130, 32, 0.2, 16, 2)]


@pytest.mark.parametrize("n,bs,density,k,r", GPU_CASES)
def test_kernels_match_plain_versions_on_card(cuda, n, bs, density, k, r):
    """Relative Frobenius error <= 1e-5: XTB's atomics add in no fixed
    order, the plain version sums in another."""
    t = tsp.random_bcsr(np.random.default_rng(n), m=3, n=n, bs=bs,
                        block_density=density, device=cuda)
    if r is not None:
        t = t.with_data(torch.stack([t.data * (1 + q) for q in range(r)]))
    shape = (r, n, k) if r is not None else (n, k)
    B1 = torch.rand(shape, device=cuda)
    B2 = torch.rand(shape, device=cuda)
    ops.reset_launch_counts()
    xa, xt = bcsr_fused.bcsr_xa_xta(t, B1, B2)
    sa = bcsr_spmm.bcsr_spmm(t, B1)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"bcsr_xa_xta": 1, "bcsr_spmm": 1}
    ra, rt = tref.ref_bcsr_xa_xta(t, B1, B2)
    for got, ref in ((xa, ra), (xt, rt), (sa, ra)):
        assert rel_err(got, ref) <= 1e-5


def test_cuda_impl_launches_and_ref_impl_does_not(cuda):
    t = tsp.random_bcsr(np.random.default_rng(0), m=2, n=128, bs=32,
                        block_density=0.3, device=cuda)
    B = torch.rand(128, 4, device=cuda)
    ops.reset_launch_counts()
    got = ops.bcsr_spmm(t, B, impl="cuda")
    ref = ops.bcsr_spmm(t, B, impl="ref")
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"bcsr_xa_xta": 0, "bcsr_spmm": 1}
    assert rel_err(got, ref) <= 1e-5


def test_sweep_on_card_matches_cpu(cuda):
    """A small fused sweep through the kernels on the card and through the
    plain versions on the CPU, on the same numpy draws: the same k_opt,
    per-k values within 1e-4."""
    rng = np.random.default_rng(3)
    n, m, bs, r = 96, 2, 32, 3
    cpu = tsp.random_bcsr(rng, m=m, n=n, bs=bs, block_density=0.4,
                          device="cpu")
    cfg = RescalkConfig(k_min=2, k_max=3, n_perturbations=r,
                        rescal_iters=30, regress_iters=30,
                        kernel=KernelPolicy(use_fused=True))
    members = {(k, q): (rng.uniform(0.98, 1.02, tuple(cpu.data.shape)),
                        rng.uniform(0.05, 1.0, (n, k)),
                        rng.uniform(0.05, 1.0, (m, k, k)))
               for k in cfg.ks for q in range(r)}
    regress = {k: rng.uniform(0.05, 1.0, (m, k, k)) for k in cfg.ks}
    ref = SweepScheduler(cfg, draws=ArrayDraws(members, regress, "cpu")).run(
        cpu)
    on_card = tsp.BCSR(data=cpu.data.to(cuda),
                       block_rows=cpu.block_rows.to(cuda),
                       block_cols=cpu.block_cols.to(cuda), n=n)
    sched = SweepScheduler(cfg, draws=ArrayDraws(members, regress, cuda))
    got = sched.run(on_card)
    launches = sched.report.meta["kernel_launches"]
    assert launches["bcsr_xa_xta"] == len(cfg.ks) * cfg.rescal_iters
    assert launches["bcsr_spmm"] == 3 * len(cfg.ks)
    assert got.k_opt == ref.k_opt
    for name in ("s_min", "s_mean", "rel_err"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=1e-4, atol=1e-4)
