"""The port's CUDA kernels on a card: each against its plain version, a
small sweep through the kernels against the same sweep on the CPU, a
small ServeEngine on the card against the same engine on the CPU, a
small dense grid sweep on a 1 x 1 NCCL grid and a small single-device
dense sweep (batched and cross-k grid mode), kernel against plain,
flash_attention with a prefill of the reduced llama3.2-1b through it,
and the data layer: virtual generation on the card, the BCSR kernels on
front-padded shards (and on one relation slice of a member stack), and
the BCSR grid sweep on a 1 x 1 NCCL grid; and the cross-k grid sweep on
that grid, stopped and resumed from its checkpoints; and one train step
of the reduced llama3.2-1b on the card, with the guard that keeps
gradients off the attention kernel; and the LM zoo's other families
(MoE, MLA, SSM, hybrid, enc-dec, VLM) reduced on the card, with the
kernel's MLA (padded) and cross-attention shapes; and a fused MU
iteration counted on the card against its count on meta tensors
(``launch.step_costs``).

Every test here needs a CUDA device (marker ``gpu``) and skips without
one.  The file imports neither ``jax`` nor ``repro``, so it runs on a
machine that has only PyTorch; from the root of a checkout there:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

(``--noconftest``: ``tests/conftest.py`` imports jax for ``repro``'s
tests.)  ``chip_smoke.py`` runs the same comparisons at the sweep's
full shapes.
"""
import dataclasses

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
    """Relative Frobenius error <= 1e-5: the kernels and the plain version
    sum in different orders."""
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
    """Relative Frobenius error <= 1e-5 against the plain version (another
    summation order); XA and XTB bit-identical across two calls; block
    rows and cols that store nothing exactly zero."""
    rng = np.random.default_rng(n + k)
    sp = pattern_bcsr(pattern, n, bs, 3, dr, rng, cuda)
    shape = (br, n, k) if br is not None else (n, k)
    B1 = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(cuda)
    B2 = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(cuda)
    ops.reset_launch_counts()
    xa, xt = bcsr_fused.bcsr_xa_xta(sp, B1, B2)
    xa2, xt2 = bcsr_fused.bcsr_xa_xta(sp, B1, B2)
    torch.cuda.synchronize()
    assert ops.launch_counts()["bcsr_xa_xta"] == 2
    assert torch.equal(xa, xa2) and torch.equal(xt, xt2)
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


@pytest.mark.parametrize("mode", ["batched", "loop"])
def test_resumed_and_retried_sweep_on_card_is_bit_identical(cuda, tmp_path,
                                                             mode):
    """Through the kernels on the card: a sweep stopped after one unit and
    resumed from its checkpoints, and a sweep whose unit retried after a
    transient fault, equal the uninterrupted sweep bit for bit (both X
    kernels sum XTB in a fixed order); one forced budget-overflow refuses
    one kernel call, whose unit retries on the kernel to the same bits."""
    from repro_torch.resilience import (FaultPlan, FaultSpec, RetryPolicy,
                                        faults)
    from repro_torch.selection import SweepInterrupted, TorchDraws
    rng = np.random.default_rng(5)
    sp = tsp.random_bcsr(rng, m=2, n=200, bs=32, block_density=0.4,
                         device=cuda)
    cfg = RescalkConfig(k_min=2, k_max=3, n_perturbations=3,
                        rescal_iters=20, regress_iters=20,
                        kernel=KernelPolicy(use_fused=True))

    def sweep(**kw):
        sched = SweepScheduler(cfg, mode=mode, draws=TorchDraws(0, cuda),
                               **kw)
        return sched.run(sp), sched.report

    want, rep = sweep()
    assert rep.meta["n_kernel_fallbacks"] == 0
    assert rep.meta["kernel_launches"]["bcsr_xa_xta"] > 0
    d = str(tmp_path / "ck")
    with pytest.raises(SweepInterrupted):
        sweep(ckpt_dir=d, stop_after_units=1)
    plan = FaultPlan({"sched/unit": [
        FaultSpec(kind="raise-transient", at=(0,))]})
    with faults.active(plan):
        resumed, rep = sweep(ckpt_dir=d,
                             retry=RetryPolicy(base_delay=0.001))
    assert rep.n_reused == 1 and rep.meta["n_retries"] == 1
    for got in (resumed, sweep()[0]):
        assert got.k_opt == want.k_opt
        for name in ("s_min", "s_mean", "rel_err"):
            assert np.array_equal(getattr(got, name), getattr(want, name))
    plan = FaultPlan({"kernel/dispatch": [
        FaultSpec(kind="budget-overflow", at=(0,))]})
    with faults.active(plan):
        forced, rep = sweep()
    assert rep.meta["n_kernel_fallbacks"] == 1
    assert rep.meta["n_retries"] == 1 and forced.k_opt == want.k_opt
    for name in ("s_min", "s_mean", "rel_err"):
        assert np.array_equal(getattr(forced, name), getattr(want, name))


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
    """The plan on this card: every query in one (block, group), chunks of
    whole tiles that cover n, at most one stage-1 CTA per SM."""
    sms = score_topk.sm_count(cuda)
    p = score_topk.plan(b, n, k, topk, sms)
    assert (p.q_blocks - 1) * p.groups * p.queries < b \
        <= p.q_blocks * p.groups * p.queries
    assert (p.n_chunks - 1) * p.chunk_rows < n <= p.n_chunks * p.chunk_rows
    assert p.q_blocks * p.n_chunks <= max(sms, p.q_blocks)


def test_score_topk_limits_agree_with_the_library(cuda):
    """The wrapper's MAX_K and MAX_TOPK are the library's: it launches at
    both and refuses one past either, and a plan that does not fit the
    topk."""
    V = torch.rand((5, score_topk.MAX_K), device=cuda)
    A = torch.rand((1000, score_topk.MAX_K), device=cuda)
    s, i = score_topk.score_topk(V, A, topk=score_topk.MAX_TOPK)
    torch.cuda.synchronize()
    assert bool((i[:, 1000:] == -1).all())
    from repro_torch.kernels import _build
    lib = _build.library()
    buf = torch.empty(1 << 20, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    for k, topk, e in ((score_topk.MAX_K + 1, 10, 1),
                       (8, score_topk.MAX_TOPK + 1, 64), (8, 33, 1)):
        rc = lib.repro_score_topk(V.data_ptr(), A.data_ptr(), 0, 0,
                                  buf.data_ptr(), buf.data_ptr(),
                                  buf.data_ptr(), buf.data_ptr(), 5, 1000, k,
                                  topk, e, 8, 1, 1024, 1, stream)
        assert rc != 0


# every k of the kernel's two scoring paths (float4 rows, k % 4 == 0, and
# scalar rows), b and n off the query group and the 256-row tile, topk at
# every list width E and across its boundaries (32 / 33, 1024)
TOPK_EDGE = [(1, 1, 10), (37, 37, 33), (37, 3000, 100), (5, 3000, 1024),
             (37, 131079, 32), (1, 131079, 1), (33, 3000, 1),
             (9, 20000, 257)]


@pytest.mark.parametrize("k", [1, 3, 4, 5, 8, 16, 32, 64])
def test_score_topk_edges_on_card(cuda, k):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(k)
    for b, n, topk in TOPK_EDGE:
        V = torch.rand((b, k), generator=gen, device=cuda)
        A = torch.rand((n, k), generator=gen, device=cuda)
        ops.reset_launch_counts()
        got = score_topk.score_topk(V, A, topk=topk)
        torch.cuda.synchronize()
        assert ops.launch_counts()["score_topk"] == 1
        topk_close(got, tref.ref_score_topk_stream(V, A, topk), V, A)


@pytest.mark.parametrize("k,topk", [(5, 33), (32, 32)])
def test_score_topk_seeded_pass_on_card(cuda, k, topk):
    """From SEED_ROWS rows on, a first launch over a prefix of A seeds the
    thresholds: two launches, the same top-k."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(k)
    n = score_topk.SEED_ROWS + 37
    V = torch.rand((37, k), generator=gen, device=cuda)
    A = torch.rand((n, k), generator=gen, device=cuda)
    ops.reset_launch_counts()
    got = score_topk.score_topk(V, A, topk=topk)
    torch.cuda.synchronize()
    assert ops.launch_counts()["score_topk"] == 2
    topk_close(got, tref.ref_score_topk_stream(V, A, topk), V, A)


def test_score_topk_takes_a_misaligned_view_on_card(cuda):
    """A contiguous A whose start is not 16-byte aligned (a row offset of
    a k = 3 table): the wrapper copies it for the ring."""
    V = torch.rand((4, 3), device=cuda)
    base = torch.rand((3001, 3), device=cuda)
    A = base[1:]
    assert A.is_contiguous() and A.data_ptr() % 16
    topk_close(score_topk.score_topk(V, A, topk=10),
               tref.ref_score_topk_stream(V, A, 10), V, A)


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
    sms = score_topk.sm_count(cuda)
    if n == 40000:
        assert score_topk.plan(b, n, 8, 100, sms).chunk_rows > 256
    for topk in (1, 10, 100):
        s, i = score_topk.score_topk(V, A, topk=topk)
        rs, ri = tref.ref_score_topk_stream(V, A, topk)
        assert torch.equal(s, rs) and torch.equal(i, ri)


@pytest.mark.parametrize("topk,n", [(32, 131079), (33, 131079),
                                    (1024, 131079), (33, (1 << 20) + 7)])
def test_score_topk_exact_ties_across_chunks_on_card(cuda, topk, n):
    """Ties that straddle every chunk and CTA (the 300 distinct rows
    repeat through n), with the seeded pass at n > 2^20: scores and
    indices bit-equal to the plain version's, at the list widths'
    boundaries."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(topk)
    V, A = tie_case(gen, 37, n, cuda)
    assert score_topk.plan(37, n, 8, topk,
                           score_topk.sm_count(cuda)).n_chunks > 1
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


# (m, n1, n2, k, r, B2 shared over m): ragged tails, the cp.async path
# (n2 odd) and the TMA path, m = 1, k = 1 and k = 64, members, k = 10 and
# 16 (two n8 tiles), and one slice of 3 panels x 20 chunks (the sliced
# schedule's call: fewer items than SMs, both partial reductions)
FUSED_GPU_CASES = [(3, 37, 1000, 3, None, False), (1, 1000, 37, 64, 4, True),
                   (4, 300, 256, 8, 4, True), (2, 1, 37, 1, None, False),
                   (2, 1100, 700, 10, 4, True), (3, 515, 1029, 16, None,
                                                 False),
                   (1, 1500, 2500, 10, None, True)]


@pytest.mark.parametrize("m,n1,n2,k,r,shared", FUSED_GPU_CASES)
def test_fused_xa_xtb_matches_plain_version_on_card(cuda, m, n1, n2, k, r,
                                                    shared):
    """Relative Frobenius error <= 1e-5 (the plain version sums in
    another order); XA and XTB bit-identical across two calls (n1 = 1100,
    1500 and n2 = 2500 reduce panel and chunk partials)."""
    from repro_torch.kernels import fused_bilinear
    lead = (r,) if r is not None else ()
    X = torch.rand(lead + (m, n1, n2), device=cuda)
    B1 = torch.rand(lead + (n2, k), device=cuda)
    B2 = (torch.rand(lead + (1, n1, k), device=cuda).expand(
        lead + (m, n1, k)) if shared else
        torch.rand(lead + (m, n1, k), device=cuda))
    ops.reset_launch_counts()
    xa, xt = fused_bilinear.fused_xa_xtb(X, B1, B2)
    xa2, xt2 = fused_bilinear.fused_xa_xtb(X, B1, B2)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_xa_xtb"] == 2
    assert torch.equal(xa, xa2) and torch.equal(xt, xt2)
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


# every KMAX build (4, 8, 16, 32, 64) at its edges and inside it; n empty,
# one row, off the 32-row tile, and 131073
MU_KS = [1, 3, 4, 5, 8, 9, 16, 17, 32, 33, 63, 64]


@pytest.mark.parametrize("k", MU_KS)
def test_mu_update_a_edges_on_card(cuda, k):
    """Every n, S per member and shared (member stride 0), an expanded
    Num, against the plain version: relative Frobenius error <= 1e-6."""
    from repro_torch.kernels import mu_update_a as mu
    gen = torch.Generator(device=cuda)
    gen.manual_seed(k)
    for n in (0, 1, 37, 1000, 131073):
        A = torch.rand((4, n, k), generator=gen, device=cuda)
        Num = torch.rand((4, n, k), generator=gen, device=cuda)
        for S in (torch.rand((4, k, k), generator=gen, device=cuda),
                  torch.rand((k, k), generator=gen, device=cuda)
                  .expand(4, k, k)):
            got = mu.mu_update_a(A, Num, S, 1e-16)
            ref = tref.ref_mu_update_a(A, Num, S, 1e-16)
            assert got.shape == ref.shape
            if n:
                assert rel_err(got, ref) <= 1e-6
        if n:
            one = Num[:1].expand(4, n, k)
            assert rel_err(mu.mu_update_a(A, one, S, 1e-16),
                           tref.ref_mu_update_a(A, one, S, 1e-16)) <= 1e-6


def test_mu_update_a_keeps_padded_columns_zero_on_card(cuda):
    """Padded cells of the cross-k grid: columns past each cell's rank are
    zero in A, Num and S, and stay exact zeros."""
    from repro_torch.kernels import mu_update_a as mu
    ks, k_max, n = (2, 3, 4, 5), 5, 1000
    mask = (torch.arange(k_max, device=cuda)[None, :]
            < torch.tensor(ks, device=cuda)[:, None]).float()
    A = torch.rand((4, n, k_max), device=cuda) * mask[:, None, :]
    Num = torch.rand(A.shape, device=cuda) * mask[:, None, :]
    S = torch.rand((4, k_max, k_max), device=cuda) \
        * (mask[:, :, None] * mask[:, None, :])
    got = mu.mu_update_a(A, Num, S, 1e-16)
    assert not (got * (1 - mask[:, None, :])).any()
    assert rel_err(got, tref.ref_mu_update_a(A, Num, S, 1e-16)) <= 1e-6


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


# the LM zoo's two call shapes beyond the dense decoders': minicpm3-4b's
# MLA heads (q/k 96 = 64 + 32, v 64) in zero-padded 128-wide buffers, and
# whisper-large-v3's cross attention (non-causal, sq != skv)
ZOO_FLASH_CASES = [dict(b=2, h=40, sq=2048, skv=2048, d=128, dqk=96, dv=64,
                        causal=True),
                   dict(b=2, h=20, sq=512, skv=2048, d=64, dqk=64, dv=64,
                        causal=False)]


@pytest.mark.parametrize("case", ZOO_FLASH_CASES, ids=["mla", "cross"])
def test_flash_attention_zoo_shapes_on_card(cuda, case):
    """bf16 on the tensor-core kernel, inputs as permuted (B, S, H, D)
    views: within 1e-2 of the plain version on the same inputs; the
    padded columns of the output are exactly 0 (v's are)."""
    from repro_torch.kernels import flash_attention as fa
    b, h, sq, skv, d = (case[k] for k in ("b", "h", "sq", "skv", "d"))
    gen = torch.Generator(device=cuda).manual_seed(sq + skv)
    q, k, v = (torch.zeros((b, s, h, d), device=cuda, dtype=torch.bfloat16)
               for s in (sq, skv, skv))
    for x, cols in ((q, case["dqk"]), (k, case["dqk"]), (v, case["dv"])):
        x[..., :cols] = torch.randn(x[..., :cols].shape, generator=gen,
                                    device=cuda)
    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    kw = dict(causal=case["causal"], sm_scale=case["dqk"] ** -0.5)
    ops.reset_launch_counts()
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launch_count_by_variant() == {"sm90_bf16": 1, "fma_fp32": 0}
    ref = tref.ref_attention(q, k, v, **kw)
    assert rel_err(got.float(), ref.float()) <= 1e-2
    assert not got[..., case["dv"]:].any()


# the reduced families on the card in fp32 (the FMA kernel): the kernel's
# launches per forward (0 for the SSM and the hybrid's sliding window)
ZOO_GPU = ["deepseek-moe-16b", "granite-moe-3b-a800m", "minicpm3-4b",
           "mamba2-1.3b", "hymba-1.5b", "whisper-large-v3", "internvl2-26b"]


@pytest.mark.parametrize("name", ZOO_GPU)
def test_zoo_forward_and_prefill_on_card(cuda, name):
    """forward and prefill of the reduced family on the card, kernel
    route against impl="ref": logits and every cache leaf within 1e-4;
    flash_attention launched once per attention layer (MLA padded to
    d = 32; enc-dec: the encoder, then self and cross attention per
    decoder layer), the plain route not at all."""
    from repro_torch.configs import REDUCED_ARCHS
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import make_prefill_step
    cfg = REDUCED_ARCHS[name]
    gen = torch.Generator(device=cuda).manual_seed(0)
    model = Transformer(cfg, device=cuda, gen=gen)
    toks = torch.randint(0, cfg.vocab, (2, 64), generator=gen, device=cuda)
    inputs = {}
    if cfg.family == "encdec":
        inputs["frames"] = torch.randn((2, 48, cfg.d_model), generator=gen,
                                       device=cuda)
    if cfg.family == "vlm":
        inputs["patches"] = torch.randn((2, cfg.n_patches, cfg.d_model),
                                        generator=gen, device=cuda)
    want = {"ssm": 0, "hybrid": 0,
            "encdec": cfg.n_enc_layers + 2 * cfg.n_layers}.get(
        cfg.family, cfg.n_layers)
    ops.reset_launch_counts()
    with torch.no_grad():
        logits, aux = model(toks, **inputs)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == want
    with torch.no_grad():
        ref_logits, ref_aux = model(toks, impl="ref", **inputs)
    assert ops.launch_counts()["flash_attention"] == want
    assert rel_err(logits, ref_logits) <= 1e-4
    assert abs(float(aux) - float(ref_aux)) <= 1e-4 * max(1.0, float(aux))
    last, cache = make_prefill_step(model)(toks, **inputs)
    ref_last, ref_cache = make_prefill_step(model, impl="ref")(toks, **inputs)
    assert ops.launch_counts()["flash_attention"] == 2 * want
    assert rel_err(last, ref_last) <= 1e-4
    for leaf in cache:
        assert rel_err(cache[leaf], ref_cache[leaf]) <= 1e-4, leaf


def test_traced_sweep_on_card_passes_check_trace(cuda, tmp_path):
    """``rescalk_run --trace --sanitize`` on the card: the artifacts pass
    scripts/check_trace.py, the ledger holds the allocator's peak and one
    measured iteration per rank, and the ledger's measurement launches
    (one per kernel per rank) stay out of the report's counts."""
    import json
    import subprocess
    import sys
    from pathlib import Path
    from repro_torch.launch import rescalk_run
    rng = np.random.default_rng(0)
    n, bs, m, per = 256, 32, 2, 60
    blocks = [(i, i) for i in range(n // bs)] + [(0, 5), (3, 1)]
    row = np.concatenate([bi * bs + rng.integers(0, bs, per)
                          for bi, _ in blocks])
    col = np.concatenate([bj * bs + rng.integers(0, bs, per)
                          for _, bj in blocks])
    np.savez(tmp_path / "x.npz", row=row, col=col,
             rel=rng.integers(0, m, row.size),
             val=rng.uniform(0.5, 1.5, row.size).astype(np.float32))
    ks, iters = (2, 3), 20
    ops.reset_launch_counts()
    _, rep = rescalk_run.main([
        "--data", str(tmp_path / "x.npz"), "--bs", str(bs), "--k-min", "2",
        "--k-max", "3", "--r", "3", "--iters", str(iters),
        "--use-fused-kernel", "--sanitize", "--trace", str(tmp_path / "tr"),
        "--report", str(tmp_path / "r.json")])
    total = ops.launch_counts()
    script = Path(__file__).resolve().parent.parent / "scripts" / \
        "check_trace.py"
    out = subprocess.run([sys.executable, str(script), str(tmp_path / "tr"),
                          "--report", str(tmp_path / "r.json"),
                          "--expect-metrics", "--expect-memory"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout
    led = json.loads((tmp_path / "tr" / "memory.json").read_text())
    assert led["runtime"]["peak_device_bytes"] > 0
    assert sorted(led["per_k"]) == [str(k) for k in ks]
    for e in led["per_k"].values():
        assert e["peak"] >= max(e["argument"], e["output"], e["temp"]) > 0
    assert all(u.peak_device_bytes > 0 for u in rep.units)
    launches = rep.meta["kernel_launches"]
    assert launches["mu_update_a"] == launches["bcsr_xa_xta"] == \
        len(ks) * iters
    # every traced iteration's rel_error, then 3 per rank in the reduction
    assert launches["bcsr_spmm"] == len(ks) * (iters + 3)
    for name in ("mu_update_a", "bcsr_xa_xta"):
        assert total[name] == launches[name] + len(ks)
    with np.load(tmp_path / "tr" / "metrics.npz") as d:
        assert d["core.sparse.sparse_mu_step.rel_error"].shape == \
            (len(ks) * iters * 3,)


# ---------------------------------------------------------------------------
# The data layer: virtual and sharded operands
# ---------------------------------------------------------------------------

VIRTUAL_SPEC = "virtual:bcsr:n=1024,m=3,k=3,bs=64,density=0.1,grid=2,seed=1"


def test_virtual_generation_on_card_is_deterministic(cuda):
    """The same spec twice on the card: the same blocks and values; the
    pattern and ground truth equal the CPU's (host draws), the values
    differ only by the noise's realization (torch generators per
    device), within its +-1% band."""
    from repro_torch.io import VirtualSpec, virtual_sharded_bcsr
    spec = VirtualSpec.parse(VIRTUAL_SPEC)
    a = virtual_sharded_bcsr(spec, device=cuda)
    b = virtual_sharded_bcsr(spec, device=cuda)
    assert torch.equal(a.data, b.data) and torch.equal(a.rows, b.rows)
    cpu = virtual_sharded_bcsr(spec, device="cpu")
    assert torch.equal(a.rows.cpu(), cpu.rows)
    np.testing.assert_array_equal(a.nnzb, cpu.nnzb)
    stored = cpu.data != 0
    ratio = a.data.cpu()[stored] / cpu.data[stored]
    assert float(ratio.min()) >= 0.99 / 1.01 - 1e-6
    assert float(ratio.max()) <= 1.01 / 0.99 + 1e-6


@pytest.mark.parametrize("k", [3, 5, 8])
def test_bcsr_kernels_on_front_padded_shards_on_card(cuda, k):
    """Every shard of an unbalanced layout (front-padded with zero blocks
    at (0, 0), block row 0 one long unit) through both BCSR kernels,
    against their plain versions; the padding adds nothing."""
    from repro_torch.io import VirtualSpec, virtual_sharded_bcsr
    spec = VirtualSpec.parse(VIRTUAL_SPEC + ",skew=1.5")
    sh = virtual_sharded_bcsr(spec, device=cuda)
    assert sh.nnzb.min() < sh.z_max          # some shard is padded
    gen = torch.Generator(device=cuda)
    gen.manual_seed(k)
    for i in range(2):
        for j in range(2):
            sp = sh.shard(i, j)
            A = torch.rand((sp.n, k), generator=gen, device=cuda)
            xa, xt = bcsr_fused.bcsr_xa_xta(sp, A, A)
            sa = bcsr_spmm.bcsr_spmm(sp, A)
            ra, rt = tref.ref_bcsr_xa_xta(sp, A, A)
            for got, ref in ((xa, ra), (xt, rt), (sa, ra)):
                assert rel_err(got, ref) <= 1e-5
            pad = sh.z_max - int(sh.nnzb[i, j])
            real = tsp.BCSR(data=sp.data[:, pad:].contiguous(),
                            block_rows=sp.block_rows[pad:],
                            block_cols=sp.block_cols[pad:], n=sp.n)
            assert rel_err(bcsr_spmm.bcsr_spmm(real, A), sa) <= 1e-6


def test_bcsr_kernels_take_one_slice_of_a_member_stack_on_card(cuda):
    """The sliced schedule's call on a member stack: data (r, 1, nnzb,
    bs, bs) viewed out of (r, m, ...), the member axis strided."""
    t = tsp.random_bcsr(np.random.default_rng(3), m=3, n=200, bs=64,
                        block_density=0.4, device=cuda)
    stack = t.with_data(torch.stack([t.data * (1 + q) for q in range(4)]))
    sl = stack.with_data(stack.data[:, 1:2])
    assert not sl.data.is_contiguous()
    B = torch.rand((4, 200, 5), device=cuda)
    xa, xt = bcsr_fused.bcsr_xa_xta(sl, B, B)
    ra, rt = tref.ref_bcsr_xa_xta(sl, B, B)
    assert rel_err(xa, ra) <= 1e-5 and rel_err(xt, rt) <= 1e-5
    assert rel_err(bcsr_spmm.bcsr_spmm(sl, B), ra) <= 1e-5


@pytest.mark.parametrize("n,k,members", [(512, 5, None), (600, 10, None),
                                         (600, 5, 2), (512, 10, 2)])
def test_bcsr_xa_xta_prepared_operands_are_bit_identical_on_card(
        cuda, n, k, members):
    """``prepare``'s tiles handed to bcsr_xa_xta on each relation slice
    (the sliced MU body's calls) give the bits of the call that tiles its
    own B: one and two column slices, with and without a member axis, bs
    dividing n and not; each distinct B is tiled once."""
    rng = np.random.default_rng(n + k)
    sp = tsp.random_bcsr(rng, m=3, n=n, bs=128, block_density=0.3,
                         device=cuda)
    shape = (n, k)
    if members is not None:
        sp = sp.with_data(torch.stack([sp.data * (1 + q)
                                       for q in range(members)]))
        shape = (members, n, k)
    B1, B2 = (torch.from_numpy(rng.random(shape, dtype=np.float32)).to(cuda)
              for _ in range(2))
    for b2, tilings in ((B2, 2), (B1, 1)):
        t0 = bcsr_fused.tiling_count()
        tiled = bcsr_fused.prepare(sp, B1, b2)
        assert bcsr_fused.tiling_count() - t0 == tilings
        for t in range(sp.m):
            sl = sp.with_data(sp.data[..., t:t + 1, :, :, :])
            xa, xt = bcsr_fused.bcsr_xa_xta(sl, B1, b2, operands=tiled)
            ra, rt = bcsr_fused.bcsr_xa_xta(sl, B1, b2)
            assert torch.equal(xa, ra) and torch.equal(xt, rt)
        assert bcsr_fused.tiling_count() - t0 == tilings * (1 + sp.m)


def test_sliced_bcsr_iteration_tiles_once_bit_identically_on_card(
        cuda, monkeypatch):
    """One sliced MU iteration of the BCSR engine body, fused, on a small
    shard: A^(j) and A^(i) tiled once for the m calls, and (A, R) the
    bits of the same body whose calls each tile their own B."""
    from repro_torch.dist import engine
    from repro_torch.dist.sharding import Grid
    rng = np.random.default_rng(5)
    sp = tsp.random_bcsr(rng, m=4, n=600, bs=128, block_density=0.3,
                         device=cuda)
    A = torch.from_numpy(rng.random((600, 10), dtype=np.float32)).to(cuda)
    R = torch.from_numpy(rng.random((4, 10, 10), dtype=np.float32)).to(cuda)
    cfg = engine.DistRescalConfig(schedule="sliced",
                                  kernel=KernelPolicy(use_fused=True))
    body = engine.get_mu_iter("bcsr", "sliced")
    grid = Grid.at_rank(0, 1, 1, 1, cuda, record=True)
    t0 = bcsr_fused.tiling_count()
    A1, R1 = body(grid, sp, A, R, cfg)
    assert bcsr_fused.tiling_count() - t0 == 2
    monkeypatch.setattr(engine, "prepare_products", lambda *a, **kw: None)
    A0, R0 = body(grid, sp, A, R, cfg)
    assert bcsr_fused.tiling_count() - t0 == 2 + 2 * sp.m
    torch.cuda.synchronize()
    assert torch.equal(A1, A0) and torch.equal(R1, R0)


@pytest.mark.parametrize("schedule", ["batched", "sliced"])
def test_bcsr_grid_sweep_1x1_nccl_matches_single_device(cuda, schedule):
    """The BCSR grid sweep on a one-rank NCCL grid against the
    single-device sweep on the merged operand (batched; the sliced grid
    schedule against its plain version): the same k_opt, per-k values
    within 1e-4, bcsr_xa_xta launched per MU iteration (per slice under
    the sliced schedule)."""
    from repro_torch.core.rescalk import rescalk
    from repro_torch.io import VirtualSpec, virtual_sharded_bcsr
    from repro_torch.launch.mesh import make_grid
    spec = VirtualSpec.parse(VIRTUAL_SPEC.replace("grid=2", "grid=1"))
    sh = virtual_sharded_bcsr(spec, device=cuda)
    grid = make_grid(data=1, model=1, device=cuda)
    try:
        cfg = RescalkConfig(k_min=2, k_max=3, n_perturbations=2,
                            rescal_iters=30, regress_iters=20,
                            schedule=schedule,
                            kernel=KernelPolicy(use_fused=True))
        ops.reset_launch_counts()
        got = rescalk(sh.cell(0, 0), cfg, grid=grid)
        per = spec.m if schedule == "sliced" else 1
        assert ops.launch_counts()["bcsr_xa_xta"] == 60 * per
        if schedule == "batched":
            ref = rescalk(sh, cfg)
        else:
            ref = rescalk(sh.cell(0, 0), RescalkConfig(
                k_min=2, k_max=3, n_perturbations=2, rescal_iters=30,
                regress_iters=20, schedule=schedule,
                kernel=KernelPolicy(use_fused=True, impl="ref")), grid=grid)
        assert got.k_opt == ref.k_opt
        for name in ("s_min", "s_mean", "rel_err"):
            np.testing.assert_allclose(getattr(got, name),
                                       getattr(ref, name), rtol=1e-4,
                                       atol=1e-4)
    finally:
        grid.destroy()


def test_grid_mode_sweep_resume_1x1_nccl_on_card(cuda, tmp_path):
    """The cross-k grid program on a one-rank NCCL grid with per-chunk
    checkpoints: stopped after one chunk and resumed, it equals the
    uninterrupted sweep bit for bit (fixed-order XTB), the resume launching
    the kernels only for the chunks it computes (one fused_xa_xtb and one
    mu_update_a per MU iteration per chunk); and within 1e-4 of the per-k
    grid sweep, with the same k_opt."""
    from repro_torch.data.synthetic import synthetic_rescal
    from repro_torch.launch.mesh import make_grid
    from repro_torch.selection import SweepInterrupted
    grid = make_grid(data=1, model=1, device=cuda)
    try:
        X, _, _ = synthetic_rescal(256, 3, 3, seed=1, device=cuda)
        cfg = RescalkConfig(k_min=2, k_max=3, n_perturbations=2,
                            rescal_iters=30, regress_iters=20,
                            kernel=KernelPolicy(use_fused=True))
        kw = dict(grid=grid, mode="grid", grid_chunk=2)
        ops.reset_launch_counts()
        clean = SweepScheduler(cfg, **kw).run(X)
        launches = ops.launch_counts()
        assert launches["fused_xa_xtb"] == launches["mu_update_a"] == 60
        ck = str(tmp_path / "ck")
        with pytest.raises(SweepInterrupted):
            SweepScheduler(cfg, ckpt_dir=ck, stop_after_units=1,
                           **kw).run(X)
        ops.reset_launch_counts()
        sched = SweepScheduler(cfg, ckpt_dir=ck, **kw)
        resumed = sched.run(X)
        launches = ops.launch_counts()
        assert launches["fused_xa_xtb"] == launches["mu_update_a"] == 30
        assert sched.report.n_reused == 1
        assert sched.report.meta["mesh"] == grid.shape
        assert resumed.k_opt == clean.k_opt
        for name in ("s_min", "s_mean", "rel_err"):
            np.testing.assert_array_equal(getattr(resumed, name),
                                          getattr(clean, name))
        perk = SweepScheduler(cfg, grid=grid).run(X)
        assert perk.k_opt == clean.k_opt
        for name in ("s_min", "s_mean", "rel_err"):
            np.testing.assert_allclose(getattr(clean, name),
                                       getattr(perk, name), rtol=1e-4,
                                       atol=1e-4)
    finally:
        grid.destroy()


def test_train_step_on_card_refuses_kernel_grads(cuda):
    """The reduced llama3.2-1b in bf16: one train step on the card runs
    the plain chunked attention (no flash_attention launch), moves every
    weight matrix and gives wq, wk, wv non-zero gradients, and
    agrees with the same step on the CPU (bf16: 2e-2 of the loss); a
    forward on the kernel's route under grad raises."""
    from repro_torch.configs import REDUCED_ARCHS
    from repro_torch.data import TokenStreamConfig, batch_at
    from repro_torch.models import model as tm
    from repro_torch.optim import AdamW
    from repro_torch.train import init_state, make_train_step
    cfg = dataclasses.replace(REDUCED_ARCHS["llama3.2-1b"], dtype="bfloat16")
    batch = batch_at(TokenStreamConfig(vocab=cfg.vocab, batch=4, seq=64), 0)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        opt = AdamW(lr=1e-3)
        state = init_state(cfg, opt, generator=torch.Generator().manual_seed(0),
                           device="cpu")
        state.params.to(dev)
        state = state._replace(opt=opt.init(dict(
            state.params.named_parameters())))
        before = {n: p.detach().clone()
                  for n, p in state.params.named_parameters()}
        ops.reset_launch_counts()
        state, m = make_train_step(cfg, optimizer=opt, remat=True)(state,
                                                                    batch)
        assert ops.launch_counts()["flash_attention"] == 0
        assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
        # every weight matrix moves; a norm's ones may not (an update of
        # lr = 1e-3 is below bf16's spacing at 1.0, and bf16 parameters
        # keep no fp32 master copy, as in repro)
        still = [n for n, p in state.params.named_parameters()
                 if p.dim() >= 2 and torch.equal(p.detach(), before[n])]
        assert not still, still
        out[dev.type] = float(m["loss"])
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=2e-2)
    model = state.params.to(cuda)
    loss, _ = tm.loss_fn(model, cfg, {k: v.to(cuda) for k, v in
                                      batch.items()})
    loss.backward()
    for w in (model.layers[0].attn.wq, model.layers[0].attn.wk,
              model.layers[0].attn.wv):
        assert float(w.grad.float().abs().max()) > 0
    with pytest.raises(RuntimeError, match="no backward"):
        model(batch["tokens"].to(cuda))
    with torch.no_grad():
        model(batch["tokens"].to(cuda))               # serving: the kernel
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("schedule", ["batched", "sliced"])
def test_step_count_on_card_equals_meta(cuda, sparse, schedule):
    """One fused MU iteration on a 1 x 1 recording grid counted on the
    card (``launch.step_costs``) equals its count on meta tensors, in
    flops, bytes, collectives and the op histogram, and counts the
    kernels it launched."""
    from repro_torch.dist.engine import DistRescalConfig, make_mu_step
    from repro_torch.dist.sharding import Grid
    from repro_torch.launch.step_costs import StepCounter
    m, n, k, bs = 3, 256, 5, 128
    gen = torch.Generator().manual_seed(0)
    counts = {}
    for dev in (cuda, torch.device("meta")):
        if sparse:
            idx = torch.tensor([0, 1], dtype=torch.int32)
            X = tsp.BCSR(data=torch.rand((m, 2, bs, bs), generator=gen),
                         block_rows=idx, block_cols=idx, n=n)
            X = (X.on_meta() if dev.type == "meta" else tsp.BCSR(
                data=X.data.to(dev), block_rows=idx.to(dev),
                block_cols=idx.to(dev), n=n))
        else:
            X = torch.rand((m, n, n), generator=gen).to(dev)
        A = torch.rand((n, k), generator=gen).to(dev)
        R = torch.rand((m, k, k), generator=gen).to(dev)
        grid = Grid.at_rank(0, 1, 1, 1, dev, record=True)
        step = make_mu_step(grid, DistRescalConfig(
            schedule=schedule, kernel=KernelPolicy(use_fused=True)))
        step(X, A, R)                       # the pattern's cached index
        ops.reset_launch_counts()
        with StepCounter() as c:
            step(X, A, R)
        counts[dev.type] = (c.summary(), ops.launch_counts())
    assert counts["cuda"][0] == counts["meta"][0]
    kernel = "bcsr_xa_xta" if sparse else "fused_xa_xtb"
    assert counts["cuda"][1][kernel] == \
        counts["cuda"][0]["ops"][f"kernel:{kernel}"] > 0
    assert counts["meta"][1][kernel] == 0          # meta launches nothing


@pytest.mark.parametrize("sparse", [False, True])
def test_mu_program_on_card_equals_meta(cuda, sparse):
    """The traced CLI's count: the one-member MU step run on the card's
    operand (``measure_mu_costs``) counts what it counts on meta tensors
    of the operand's shapes."""
    from repro_torch.obs import costs as obs_costs
    m, n, bs = 3, 256, 128
    gen = torch.Generator().manual_seed(0)
    if sparse:
        idx = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
        X = tsp.BCSR(data=torch.rand((m, 2, bs, bs), generator=gen).to(cuda),
                     block_rows=idx, block_cols=idx, n=n)
    else:
        X = torch.rand((m, n, n), generator=gen).to(cuda)
    card = obs_costs.measure_mu_costs(X, [4, 10])
    meta = (X.on_meta() if sparse else
            torch.empty(X.shape, dtype=X.dtype, device="meta"))
    assert card == obs_costs.measure_mu_costs(meta, [4, 10])
    assert card[4]["flops"] > 0
