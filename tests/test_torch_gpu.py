"""The port's CUDA kernels on a card: each against its plain version, a
small sweep through the kernels against the same sweep on the CPU, a
small ServeEngine on the card against the same engine on the CPU, a
small dense grid sweep on a 1 x 1 NCCL grid and a small single-device
dense sweep (batched and cross-k grid mode), kernel against plain, and
flash_attention with a prefill of the reduced llama3.2-1b through it.

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
                                   "fused_xa_xtb": 0, "mu_update_a": 0,
                                   "score_topk": 0, "flash_attention": 0}
    ra, rt = tref.ref_bcsr_xa_xta(t, B1, B2)
    for got, ref in ((xa, ra), (xt, rt), (sa, ra)):
        assert rel_err(got, ref) <= 1e-5


# block patterns (rows, cols), row-major: GAPPY leaves block rows 1 and 3
# and block cols 0 and 4 empty; UNEVEN puts 44 blocks in block row 0 beside
# empty rows 1-2 and 4-45 (nb = 47), block cols 44 and 45 empty
GAPPY = ([0, 0, 2, 2, 4], [1, 3, 1, 2, 3])
UNEVEN = ([0] * 44 + [3, 3, 46], list(range(44)) + [0, 5, 46])
# (n, bs, pattern, k, data members, operand members): uneven work per
# block row, bs 64 and 96, k from 1 to 64 (one to eight 8-column slices),
# shared data with r operand members
BCSR_EDGE_CASES = [(6000, 128, UNEVEN, 5, 4, 4),
                   (6000, 128, UNEVEN, 8, None, 4),
                   (300, 64, GAPPY, 5, None, None),
                   (450, 96, GAPPY, 9, 4, 4),
                   (600, 128, GAPPY, 1, None, 4),
                   (600, 128, GAPPY, 4, None, None),
                   (600, 128, GAPPY, 33, 4, 4),
                   (200, 32, GAPPY, 64, None, 4)]


def pattern_bcsr(pattern, n, bs, m, members, rng, device):
    """A BCSR over the given block pattern with uniform values, zero in
    the padded tail; member-stacked when ``members`` is not None."""
    rows, cols = (np.asarray(x, dtype=np.int64) for x in pattern)
    nb = -(-n // bs)
    lead = (members, m) if members is not None else (m,)
    data = rng.random(lead + (len(rows), bs, bs), dtype=np.float32)
    valid = (np.arange(nb * bs) < n).astype(np.float32).reshape(nb, bs)
    data *= valid[rows][:, :, None] * valid[cols][:, None, :]
    return tsp.BCSR(data=torch.from_numpy(data).to(device),
                    block_rows=torch.from_numpy(rows.astype(np.int32)).to(
                        device),
                    block_cols=torch.from_numpy(cols.astype(np.int32)).to(
                        device), n=n)


@pytest.mark.parametrize("n,bs,pattern,k,dr,br", BCSR_EDGE_CASES)
def test_bcsr_xa_xta_edges_on_card(cuda, n, bs, pattern, k, dr, br):
    """Relative Frobenius error <= 1e-5 against the plain version (XTB's
    atomics add in no fixed order); XA bit-identical across two calls;
    block rows and cols that store nothing exactly zero."""
    rng = np.random.default_rng(n + k)
    sp = pattern_bcsr(pattern, n, bs, 3, dr, rng, cuda)
    shape = (br, n, k) if br is not None else (n, k)
    B1 = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(cuda)
    B2 = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(cuda)
    ops.reset_launch_counts()
    xa, xt = bcsr_fused.bcsr_xa_xta(sp, B1, B2)
    xa2, _ = bcsr_fused.bcsr_xa_xta(sp, B1, B2)
    torch.cuda.synchronize()
    assert ops.launch_counts()["bcsr_xa_xta"] == 2
    assert torch.equal(xa, xa2)
    ra, rt = tref.ref_bcsr_xa_xta(sp, B1, B2)
    assert rel_err(xa, ra) <= 1e-5 and rel_err(xt, rt) <= 1e-5
    rows, cols = pattern
    for i in range(-(-n // bs)):
        sl = slice(i * bs, min((i + 1) * bs, n))
        if i not in rows:
            assert not xa[..., sl, :].any()
        if i not in cols:
            assert not xt[..., sl, :].any()


def test_cuda_impl_launches_and_ref_impl_does_not(cuda):
    t = tsp.random_bcsr(np.random.default_rng(0), m=2, n=128, bs=32,
                        block_density=0.3, device=cuda)
    B = torch.rand(128, 4, device=cuda)
    ops.reset_launch_counts()
    got = ops.bcsr_spmm(t, B, impl="cuda")
    ref = ops.bcsr_spmm(t, B, impl="ref")
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"bcsr_xa_xta": 0, "bcsr_spmm": 1,
                                   "fused_xa_xtb": 0, "mu_update_a": 0,
                                   "score_topk": 0, "flash_attention": 0}
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
    assert launches["mu_update_a"] == len(cfg.ks) * cfg.rescal_iters
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
            launches = ops.launch_counts()
            assert launches["fused_xa_xtb"] == launches["mu_update_a"] \
                == (60 if impl == "auto" else 0)
        assert grid.collectives > 0
        assert out["auto"].k_opt == out["ref"].k_opt
        for name in ("s_min", "s_mean", "rel_err"):
            np.testing.assert_allclose(getattr(out["auto"], name),
                                       getattr(out["ref"], name),
                                       rtol=1e-4, atol=1e-4)
    finally:
        grid.destroy()


# (n, k, r, S shared over members): empty and ragged n, k = 1 and 64
MU_GPU_CASES = [(0, 3, None, False), (1, 1, None, False), (37, 5, 4, False),
                (1000, 64, 4, True), (1000, 16, None, False)]


@pytest.mark.parametrize("n,k,r,shared", MU_GPU_CASES)
def test_mu_update_a_matches_plain_version_on_card(cuda, n, k, r, shared):
    """Relative Frobenius error <= 1e-6: the k-term dot sums in another
    order than the plain version's product; one launch per call."""
    from repro_torch.kernels import mu_update_a as mu
    lead = (r,) if r is not None else ()
    A = torch.rand(lead + (n, k), device=cuda)
    Num = torch.rand(lead + (n, k), device=cuda)
    S = torch.rand((k, k), device=cuda)
    if r is not None:
        S = S.expand(r, k, k) if shared else torch.rand((r, k, k),
                                                         device=cuda)
    ops.reset_launch_counts()
    got = mu.mu_update_a(A, Num, S, 1e-16)
    got2 = ops.mu_update_a(A, Num, S, 1e-16)
    torch.cuda.synchronize()
    assert ops.launch_counts()["mu_update_a"] == (2 if n else 0)
    ref = tref.ref_mu_update_a(A, Num, S, 1e-16)
    if n:
        assert rel_err(got, ref) <= 1e-6 and torch.equal(got, got2)
    assert got.shape == ref.shape


def test_mu_update_a_refuses_rank_above_64_on_card(cuda):
    from repro_torch.kernels import mu_update_a as mu
    with pytest.raises(ValueError, match="rank k=65"):
        mu.mu_update_a(torch.rand(16, 65, device=cuda),
                       torch.rand(16, 65, device=cuda),
                       torch.rand(65, 65, device=cuda), 1e-16)


@pytest.mark.parametrize("mode", ["batched", "grid"])
def test_dense_sweep_on_card_kernel_matches_ref(cuda, mode):
    """The single-device dense sweep through the kernels and through the
    plain versions on the card: fused_xa_xtb and mu_update_a once per MU
    iteration, the same k_opt, per-k values within 1e-4."""
    from repro_torch.core.rescalk import rescalk
    from repro_torch.data.synthetic import synthetic_rescal
    X, _, _ = synthetic_rescal(256, 3, 3, seed=1, device=cuda)
    out = {}
    for impl in ("auto", "ref"):
        cfg = RescalkConfig(k_min=2, k_max=3, n_perturbations=2,
                            rescal_iters=30, regress_iters=20,
                            kernel=KernelPolicy(use_fused=True, impl=impl))
        ops.reset_launch_counts()
        out[impl] = rescalk(X, cfg, mode=mode,
                            grid_chunk=2 if mode == "grid" else None)
        launches = ops.launch_counts()
        want = 60 if impl == "auto" else 0
        assert launches["fused_xa_xtb"] == launches["mu_update_a"] == want
    assert out["auto"].k_opt == out["ref"].k_opt
    for name in ("s_min", "s_mean", "rel_err"):
        np.testing.assert_allclose(getattr(out["auto"], name),
                                   getattr(out["ref"], name),
                                   rtol=1e-4, atol=1e-4)


# (sq, skv, d, (hq, hkv), causal, q_offset): tails no tile divides, every
# head dim, MHA / GQA / MQA, the continuation offset; for the bf16
# kernel's edges: d = 16 and 128 (the 32-byte swizzle and the two
# 64-column halves) on sq, skv not multiples of its 128-row and 128-key
# tiles, sq = 1, causal with q_offset 64, hq = hkv and hq / hkv = 5
FLASH_GPU_CASES = [(1, 37, 16, (4, 4), True, 0),
                   (37, 37, 32, (8, 2), True, 0),
                   (256, 1000, 64, (5, 1), False, 0),
                   (1000, 1000, 128, (32, 8), True, 0),
                   (200, 264, 64, (8, 2), True, 64),
                   (129, 257, 16, (4, 4), True, 0),
                   (129, 257, 128, (10, 2), False, 0),
                   (1, 300, 128, (5, 1), True, 64),
                   (300, 300, 16, (10, 2), True, 64),
                   (127, 129, 32, (4, 4), False, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv,d,heads,causal,q_offset", FLASH_GPU_CASES)
def test_flash_attention_matches_plain_version_on_card(
        cuda, dtype, sq, skv, d, heads, causal, q_offset):
    """Inputs as permuted (B, S, H, D) views.  fp32 (the FMA kernel):
    relative Frobenius error <= 1e-5 (sums in another order).  bf16 (the
    tensor-core kernel): <= 1e-2 against the plain version on the same
    bf16 inputs and against it on their fp32 copies (the kernel rounds p
    to bf16 before p @ v, the plain version keeps it in fp32; the output
    rounds to bf16)."""
    from repro_torch.kernels import flash_attention as fa
    hq, hkv = heads
    gen = torch.Generator(device=cuda).manual_seed(sq + skv + d)
    q = torch.randn((2, sq, hq, d), generator=gen, device=cuda).to(dtype)
    k = torch.randn((2, skv, hkv, d), generator=gen, device=cuda).to(dtype)
    v = torch.randn((2, skv, hkv, d), generator=gen, device=cuda).to(dtype)
    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    kw = dict(causal=causal, q_offset=q_offset)
    ops.reset_launch_counts()
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    bf16 = dtype == torch.bfloat16
    assert fa.launch_count_by_variant() == {"sm90_bf16": int(bf16),
                                            "fma_fp32": int(not bf16)}
    assert got.dtype == dtype and got.shape == q.shape
    assert got.stride() == q.stride()
    ref = tref.ref_attention(q, k, v, **kw)
    if dtype == torch.float32:
        assert rel_err(got, ref) <= 1e-5
    else:
        ref32 = tref.ref_attention(q.float(), k.float(), v.float(), **kw)
        assert rel_err(got.float(), ref.float()) <= 1e-2
        assert rel_err(got.float(), ref32) <= 1e-2


def test_flash_attention_bf16_refuses_misaligned_views_on_card(cuda):
    """A bf16 view whose s stride (260 elements, 520 bytes) TMA cannot
    take raises before any launch; its fp32 copy runs the FMA kernel."""
    from repro_torch.kernels import flash_attention as fa
    buf = torch.randn(2 * 8 * 260, device=cuda).to(torch.bfloat16)
    q = buf.as_strided((2, 4, 8, 64), (2080, 64, 260, 1))
    kv = torch.randn((2, 8, 2, 64), device=cuda).to(torch.bfloat16)
    kv = kv.transpose(1, 2)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="s stride 260"):
        fa.flash_attention(q, kv, kv)
    assert ops.launch_counts()["flash_attention"] == 0
    fa.flash_attention(q.float(), kv.float(), kv.float())
    torch.cuda.synchronize()
    assert fa.launch_count_by_variant() == {"sm90_bf16": 0, "fma_fp32": 1}


def test_flash_attention_refuses_outside_its_limits_on_card(cuda):
    from repro_torch.kernels import flash_attention as fa
    q, kv = (torch.rand((1, h, 8, 64), device=cuda) for h in (4, 2))
    with pytest.raises(ValueError, match="head dim 24"):
        fa.flash_attention(torch.rand((1, 4, 8, 24), device=cuda),
                           torch.rand((1, 2, 8, 24), device=cuda),
                           torch.rand((1, 2, 8, 24), device=cuda))
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention(q, kv, kv, q_offset=-1)
    with pytest.raises(ValueError, match="unit stride"):
        fa.flash_attention(torch.rand((1, 4, 8, 128), device=cuda)[..., ::2],
                           kv, kv)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        fa.flash_attention(q.half(), kv.half(), kv.half())


def test_prefill_on_card_launches_once_per_layer(cuda):
    """The reduced llama3.2-1b's prefill on the card: one flash_attention
    launch per layer, logits and cache within 1e-4 of the plain chunked
    path on the card."""
    from repro_torch.configs import REDUCED_ARCHS
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import make_prefill_step
    cfg = REDUCED_ARCHS["llama3.2-1b"]
    gen = torch.Generator(device=cuda).manual_seed(0)
    model = Transformer(cfg, device=cuda, gen=gen)
    toks = torch.randint(0, cfg.vocab, (2, 100), generator=gen, device=cuda)
    ops.reset_launch_counts()
    logits, cache = make_prefill_step(model)(toks)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    ref_logits, ref_cache = make_prefill_step(model, impl="ref")(toks)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    assert rel_err(logits, ref_logits) <= 1e-4
    for name in ("k", "v"):
        assert rel_err(cache[name], ref_cache[name]) <= 1e-4
