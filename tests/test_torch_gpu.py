"""The port's CUDA kernels on a card: each against its plain version, a
small sweep through the kernels against the same sweep on the CPU, a
small ServeEngine on the card against the same engine on the CPU, and a
small dense grid sweep on a 1 x 1 NCCL grid, kernel against plain.

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
from repro_torch.kernels import bcsr_fused, bcsr_spmm, ops, score_topk
from repro_torch.kernels import ref as tref
from repro_torch.kernels.policy import KernelPolicy
from repro_torch.selection import ArrayDraws, RescalkConfig, SweepScheduler
from repro_torch.serve import (FactorBundle, ServeConfig, ServeEngine,
                               random_queries)

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
    assert ops.launch_counts() == {"bcsr_xa_xta": 1, "bcsr_spmm": 1,
                                   "fused_xa_xtb": 0, "score_topk": 0}
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
    assert ops.launch_counts() == {"bcsr_xa_xta": 0, "bcsr_spmm": 1,
                                   "fused_xa_xtb": 0, "score_topk": 0}
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


def topk_close(got, plain, V, A):
    """A top-k check that allows near ties to swap: the scores match the
    plain version's, and every returned index's float64 score matches
    the reported one and is not beaten by an index left out (1e-5 of the
    row's largest score)."""
    (s, i), (rs, _) = got, plain
    t = min(s.shape[1], A.shape[0])
    assert bool((i[:, t:] == -1).all()) and bool(torch.isneginf(
        s[:, t:]).all())
    full = V.double() @ A.double().T
    tol = 1e-5 * full.abs().amax(dim=1, keepdim=True)
    S, I = s[:, :t].double(), i[:, :t].long()
    assert bool(((S - rs[:, :t].double()).abs() <= tol).all())
    assert bool(((full.gather(1, I) - S).abs() <= tol).all())
    left = full.scatter(1, I, -torch.inf).amax(dim=1, keepdim=True)
    assert bool((left <= S[:, -1:] + tol).all())


@pytest.mark.parametrize("b,n,k,topk", [(1, 5, 3, 10), (32, 1000, 3, 10),
                                        (128, 20000, 32, 100)])
def test_score_topk_matches_plain_version_on_card(cuda, b, n, k, topk):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n)
    V = torch.rand((b, k), generator=gen, device=cuda)
    A = torch.rand((n, k), generator=gen, device=cuda)
    ops.reset_launch_counts()
    got = ops.score_topk(V, A, topk=topk)
    torch.cuda.synchronize()
    assert ops.launch_counts()["score_topk"] == 1
    topk_close(got, tref.ref_score_topk_stream(V, A, topk), V, A)


@pytest.mark.parametrize("b,n,k,topk", [
    (32, 131072, 3, 10), (128, 4194304, 32, 32), (1, 1, 3, 10),
    (5, 1000, 64, 1024), (300, 70000, 17, 100), (32, 40000, 8, 100)])
def test_score_topk_plan_covers_the_work(cuda, b, n, k, topk):
    """The library's plan: Q queries per CTA within the batch, whole
    chunks that cover n, and about two stage-1 CTAs per SM."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    p = score_topk.plan(b, n, k, topk, sms)
    assert 1 <= p.q <= b
    assert (p.n_chunks - 1) * p.chunk_rows < n <= p.n_chunks * p.chunk_rows
    assert p.n_chunks <= 2 * sms


def test_score_topk_limits_agree_with_the_library(cuda):
    """The wrapper's MAX_K and MAX_TOPK are the library's: it plans at
    both and refuses one past either."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    score_topk.plan(5, 1000, score_topk.MAX_K, score_topk.MAX_TOPK, sms)
    for k, topk in ((score_topk.MAX_K + 1, 10), (8, score_topk.MAX_TOPK + 1)):
        with pytest.raises(RuntimeError, match="score_topk plan"):
            score_topk.plan(5, 1000, k, topk, sms)


def tie_case(gen, b, n, device):
    """Integer factors whose rows of A repeat every 300 rows: every order
    of summation gives bit-equal scores, and each score ties many rows."""
    base = torch.randint(0, 3, (300, 8), generator=gen, device=device)
    A = base[torch.arange(n, device=device) % 300].float().contiguous()
    V = torch.randint(0, 3, (b, 8), generator=gen, device=device).float()
    return V, A


@pytest.mark.parametrize("b,n", [(16, 600), (32, 40000), (128, 40000)])
def test_score_topk_exact_ties_on_card(cuda, b, n):
    """Bit-equal scores, and the indices equal the plain version's (ties
    to the lowest index).  At n = 40000 the chunks hold several tiles, so
    ties are also broken between a full running list and a later tile."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n + b)
    V, A = tie_case(gen, b, n, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if n == 40000:
        assert score_topk.plan(b, n, 8, 100, sms).chunk_rows > 256
    for topk in (1, 10, 100):
        s, i = score_topk.score_topk(V, A, topk=topk)
        rs, ri = tref.ref_score_topk_stream(V, A, topk)
        assert torch.equal(s, rs) and torch.equal(i, ri)


def test_serve_engine_on_card_matches_cpu(cuda):
    """The same bundle and stream through the engine on the card (the
    kernel, one launch per device batch) and on the CPU (the plain
    version): the same stats and flags, and each card answer passes the
    top-k check against the CPU engine's scores."""
    rng = np.random.default_rng(1)
    bundle = FactorBundle(A=rng.random((3000, 4), np.float32),
                          R=rng.random((3, 4, 4), np.float32))
    cfg = ServeConfig(topk=8, batch=16)
    on_card = ServeEngine(bundle, cfg)
    on_cpu = ServeEngine(bundle, cfg, device="cpu")
    queries = random_queries(3000, 3, 200, skew=1.2, seed=2)
    ops.reset_launch_counts()
    got, want = [], []
    for c0 in range(0, 200, 25):
        got += on_card.query(queries[c0:c0 + 25])
        want += on_cpu.query(queries[c0:c0 + 25])
    assert on_card.stats() == on_cpu.stats()
    assert ops.launch_counts()["score_topk"] == on_card.stats()["batches"]
    A = torch.from_numpy(bundle.A).to(cuda)
    R = torch.from_numpy(bundle.R).to(cuda)
    for q, g, w in zip(queries, got, want):
        assert (g.cached, g.shed) == (w.cached, w.shed)
        Rq = R[q.rel] if q.mode == "sro" else R[q.rel].T
        V = (A[q.anchor] @ Rq)[None]
        topk_close((torch.from_numpy(g.scores)[None].to(cuda),
                    torch.from_numpy(g.indices)[None].to(cuda)),
                   (torch.from_numpy(w.scores)[None].to(cuda), None), V, A)


# (m, n1, n2, k, r, B2 shared over m): ragged tails, the scalar path (n2
# odd) and the float4 path, m = 1, k = 1 and k = 64, members
FUSED_GPU_CASES = [(3, 37, 1000, 3, None, False), (1, 1000, 37, 64, 4, True),
                   (4, 300, 256, 8, 4, True), (2, 1, 37, 1, None, False)]


@pytest.mark.parametrize("m,n1,n2,k,r,shared", FUSED_GPU_CASES)
def test_fused_xa_xtb_matches_plain_version_on_card(cuda, m, n1, n2, k, r,
                                                    shared):
    """Relative Frobenius error <= 1e-5: XTB's atomics add in no fixed
    order, the plain version sums in another."""
    from repro_torch.kernels import fused_bilinear
    lead = (r,) if r is not None else ()
    X = torch.rand(lead + (m, n1, n2), device=cuda)
    B1 = torch.rand(lead + (n2, k), device=cuda)
    B2 = (torch.rand(lead + (1, n1, k), device=cuda).expand(
        lead + (m, n1, k)) if shared else
        torch.rand(lead + (m, n1, k), device=cuda))
    ops.reset_launch_counts()
    xa, xt = fused_bilinear.fused_xa_xtb(X, B1, B2)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_xa_xtb"] == 1
    ra, rt = tref.ref_fused_xa_xtb(X, B1, B2)
    assert rel_err(xa, ra) <= 1e-5 and rel_err(xt, rt) <= 1e-5


def test_fused_xa_xtb_refuses_rank_above_64_on_card(cuda):
    from repro_torch.kernels import fused_bilinear
    X = torch.rand(2, 16, 16, device=cuda)
    with pytest.raises(ValueError, match="rank k=65"):
        fused_bilinear.fused_xa_xtb(X, torch.rand(16, 65, device=cuda),
                                    torch.rand(2, 16, 65, device=cuda))


def test_grid_sweep_1x1_nccl_kernel_matches_ref(cuda):
    """The dense grid sweep on a one-rank NCCL grid, through the kernel and
    through the plain version: one launch per MU iteration, the same
    k_opt, per-k values within 1e-4."""
    from repro_torch.core.rescalk import rescalk
    from repro_torch.data.synthetic import synthetic_rescal
    from repro_torch.launch.mesh import make_grid
    grid = make_grid(data=1, model=1, device=cuda)
    try:
        X, _, _ = synthetic_rescal(256, 3, 3, seed=1, device=cuda)
        out = {}
        for impl in ("auto", "ref"):
            cfg = RescalkConfig(k_min=2, k_max=3, n_perturbations=2,
                                rescal_iters=30, regress_iters=20,
                                kernel=KernelPolicy(use_fused=True,
                                                    impl=impl))
            ops.reset_launch_counts()
            out[impl] = rescalk(X, cfg, grid=grid)
            launches = ops.launch_counts()["fused_xa_xtb"]
            assert launches == (60 if impl == "auto" else 0)
        assert grid.collectives > 0
        assert out["auto"].k_opt == out["ref"].k_opt
        for name in ("s_min", "s_mean", "rel_err"):
            np.testing.assert_allclose(getattr(out["auto"], name),
                                       getattr(out["ref"], name),
                                       rtol=1e-4, atol=1e-4)
    finally:
        grid.destroy()
