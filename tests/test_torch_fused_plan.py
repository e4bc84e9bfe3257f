"""fused_xa_xtb's launch plan and its split-TF32 arithmetic, on the CPU.

The CUDA kernel (``kernels/csrc/fused_bilinear.cu``) runs only on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 2).  Here:
the plan that the wrapper hands it (work items, panels and chunks, the
workspace), the wrapper's alignment and operand-group choices, and a
numpy emulation of the kernel's products: each value split as hi =
tf32(x) rounded as ``cvt.rna`` rounds (10 mantissa bits, ties away from
zero) and lo = x - hi read by the tensor core toward zero, three products
per 8-deep k-step (lo.hi', hi.lo', hi.hi') from zero, each rounded toward
zero as the tensor core's accumulator is (the worse case), added to an
fp32 sum (round to nearest), the chunk (or panel) partials summed in
order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import fused_bilinear as fb

SWEEP = dict(T=32, n=16384)          # chip_smoke FUSED_SCALE: r = 4, m = 8
EXA = dict(T=20, n=12288, k=10)      # rescal-dense-3tb's share on 16 x 16
SMS = 132
REL_TOL = 1e-5                       # chip_smoke's kernel vs plain version


def tf32_rna(x):
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(
        np.float32)


def tf32_trunc(x):
    bits = np.asarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xffffe000)).view(np.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_trunc(x - hi)      # x - hi is exact in fp32


def rz32(x):
    """fp64 -> fp32 rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def kstep_terms(X, B, groups):
    """Each k-step's three products from zero, as the tensor core forms
    them: (steps, M, N) fp32.  X (M, K), B (K, N) fp32; ``groups`` (steps,
    8) the contraction indices of each k-step."""
    xh, xl = (a.astype(np.float64) for a in split(X))
    bh, bl = (a.astype(np.float64) for a in split(B))

    def dot(a, b):
        return np.einsum("msj,sjn->smn", a[:, groups], b[groups])

    t = rz32(dot(xl, bh))
    t = rz32(t.astype(np.float64) + dot(xh, bl))
    return rz32(t.astype(np.float64) + dot(xh, bh))


def xa_groups(n):
    """The kernel's XA k-steps over n columns (a multiple of 32): k-step
    s of column group q holds columns 32q + 8t + 2s and + 1, t < 4."""
    q, s, t, e = np.meshgrid(np.arange(n // 32), np.arange(4), np.arange(4),
                             np.arange(2), indexing="ij")
    return (32 * q + 8 * t + 2 * s + e).reshape(-1, 8)


def emulate(X, B, part, groups):
    """sum_j X[:, j] B[j] in the kernel's order: within each part of
    ``part`` contraction indices, one fp32 sum over the k-steps; then the
    parts in order."""
    terms = kstep_terms(X, B, groups)
    per = part // 8
    total = np.zeros(terms.shape[1:], np.float32)
    for p0 in range(0, terms.shape[0], per):
        acc = np.zeros_like(total)
        for step in terms[p0:p0 + per]:
            acc = acc + step
        total = total + acc
    return total


def rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("k", [5, 10])
def test_split_tf32_is_fp32_accurate_at_the_sweeps_scale(k):
    """Uniform X and factors, n = 16384 summed (the sweep's XA rows over
    the plan's chunks, its XTB columns over the plan's panels): relative
    Frobenius error against fp64 below 1e-6, inside REL_TOL."""
    rng = np.random.default_rng(k)
    n = SWEEP["n"]
    plan = fb.plan(SWEEP["T"], n, n, k)
    X = rng.random((32, n), dtype=np.float32)
    B = rng.random((n, k), dtype=np.float32)
    exact = X.astype(np.float64) @ B.astype(np.float64)
    xa = emulate(X, B, plan.chunk_cols, xa_groups(n))
    xtb = emulate(X, B, plan.panel_rows, np.arange(n).reshape(-1, 8))
    assert rel(xa, exact) < 1e-6 and rel(xtb, exact) < 1e-6


def test_one_chain_inside_the_tensor_core_would_not_be():
    """Why every k-step starts from zero: 16384 columns accumulated in the
    tensor core, truncated at each of its 3 x 2048 adds, lose ~1e-4."""
    rng = np.random.default_rng(0)
    n, k = SWEEP["n"], 10
    X = rng.random((32, n), dtype=np.float32)
    B = rng.random((n, k), dtype=np.float32)
    xh, xl = (a.astype(np.float64) for a in split(X))
    bh, bl = (a.astype(np.float64) for a in split(B))
    acc = np.zeros((32, k), np.float32)
    for j in range(0, n, 8):
        c = slice(j, j + 8)
        for a, b in ((xl, bh), (xh, bl), (xh, bh)):
            acc = rz32(acc.astype(np.float64) + a[:, c] @ b[c])
    exact = X.astype(np.float64) @ B.astype(np.float64)
    assert rel(acc, exact) > REL_TOL


def test_emulated_products_match_repro():
    """The emulated kernel on X (m, n1, n2) with ragged panels and chunks
    against repro's plain products at RTOL 1e-5."""
    rng = np.random.default_rng(3)
    m, n1, n2, k = 2, 200, 150, 10
    X = rng.random((m, n1, n2), dtype=np.float32)
    B1 = rng.random((n2, k), dtype=np.float32)
    B2 = rng.random((m, n1, k), dtype=np.float32)
    rxa, rxtb = (np.asarray(a) for a in jref.ref_fused_xa_xtb(
        jnp.asarray(X), jnp.asarray(B1), jnp.asarray(B2)))
    n2p, n1p = 256, 256          # zeros past n2 and n1, as the kernel pads
    for t in range(m):
        Xp = np.zeros((n1p, n2p), np.float32)
        Xp[:n1, :n2] = X[t]
        B1p = np.zeros((n2p, k), np.float32)
        B1p[:n2] = B1
        B2p = np.zeros((n1p, k), np.float32)
        B2p[:n1] = B2[t]
        xa = emulate(Xp, B1p, 128, xa_groups(n2p))[:n1]
        xtb = emulate(Xp.T.copy(), B2p, 64,
                      np.arange(n1p).reshape(-1, 8))[:n2]
        np.testing.assert_allclose(xa, rxa[t], rtol=1e-5)
        np.testing.assert_allclose(xtb, rxtb[t], rtol=1e-5)


@pytest.mark.parametrize("k,rows", [(1, 1024), (8, 1024), (9, 512),
                                    (16, 512), (17, 320), (24, 320),
                                    (32, 256), (40, 192), (41, 128),
                                    (64, 128)])
def test_panel_rows_follow_the_kernels_builds(k, rows):
    """64-row bands, 16 / ceil(k / 8) of them (the XA sums a warp keeps
    in registers; the kernel refuses any other panel)."""
    assert fb.panel_rows(k) == rows


PLANS = [(32, 16384, 16384, 5), (20, 12288, 12288, 10), (1, 16384, 16384, 4),
         (1, 16384, 16384, 10), (8, 4096, 4096, 3), (3, 37, 1000, 3),
         (4, 1000, 37, 64), (2, 1, 37, 1), (1, 1500, 2500, 10),
         (6, 515, 1029, 16)]


@pytest.mark.parametrize("T,n1,n2,k", PLANS)
def test_plan_items_cover_every_slice_panel_chunk_once(T, n1, n2, k):
    """The persistent CTAs' items, in each CTA's order, are every (slice,
    panel, chunk) exactly once; panels and chunks cover the rows and
    columns, chunks are whole 128-column strips."""
    p = fb.plan(T, n1, n2, k)
    walked = [it for c in range(p.grid(SMS)) for it in p.cta_items(c, SMS)]
    want = [(t, i, j) for t in range(T) for i in range(p.panels)
            for j in range(p.chunks)]
    assert sorted(walked) == want and len(walked) == p.items
    for c in range(p.grid(SMS)):
        mine = p.cta_items(c, SMS)
        assert mine == sorted(mine)
    assert p.chunk_cols % fb.STRIP_COLS == 0
    assert (p.panels - 1) * p.panel_rows < n1 <= p.panels * p.panel_rows
    assert (p.chunks - 1) * p.chunk_cols < n2 <= p.chunks * p.chunk_cols
    assert p.grid(SMS) == min(p.items, SMS)


@pytest.mark.parametrize("T,n1,n2,k", PLANS)
def test_workspace_floats_is_the_plans_sections(T, n1, n2, k):
    """Split fragments of B1 and B2 (rows padded to whole strips and
    bands, k to a multiple of 8, hi and lo), the chunk partials of XA and
    the panel partials of XTB, none for a single chunk or panel."""
    for g1, g2 in ((1, 1), (4, 4), (1, 8)):
        p = fb.plan(T, n1, n2, k, g1, g2)
        k8 = -(-k // 8) * 8
        s = p.sections()
        assert s["B1 fragments"] == g1 * (-(-n2 // 128) * 128) * k8 * 2
        assert s["B2 fragments"] == g2 * (-(-n1 // 64) * 64) * k8 * 2
        assert s["XA chunk partials"] == (T * p.chunks * n1 * k
                                          if p.chunks > 1 else 0)
        assert s["XTB panel partials"] == (T * p.panels * n2 * k
                                           if p.panels > 1 else 0)
        assert fb.workspace_floats(T, n1, n2, k, g1, g2) == sum(s.values())


@pytest.mark.parametrize("T,n,k,groups", [
    (SWEEP["T"], SWEEP["n"], 2, 4), (SWEEP["T"], SWEEP["n"], 5, 4),
    (SWEEP["T"], SWEEP["n"], 10, 4), (EXA["T"], EXA["n"], EXA["k"], 1),
    (1, SWEEP["n"], 4, 1)])
def test_workspace_traffic_is_under_5pct_of_x(T, n, k, groups):
    """The workspace written once and read once, beside X's bytes: the
    dense sweep's batched call (k = 2..5, and k = 10), the exascale
    share's and the sliced schedule's one slice."""
    floats = fb.workspace_floats(T, n, n, k, groups, groups)
    assert 2 * floats <= 0.05 * T * n * n


@pytest.mark.parametrize("T,n,k,strips", [
    (1, 16384, 4, 16), (1, 16384, 10, 32), (1, 4096, 5, 1),
    (EXA["T"], EXA["n"], EXA["k"], 352), (SWEEP["T"], SWEEP["n"], 5, 512),
    (SWEEP["T"], SWEEP["n"], 10, 1024)])
def test_plan_balances_the_items_over_the_sms(T, n, k, strips):
    """The busiest of 132 SMs streams at most 4% more strips than an even
    share of the call's (the sliced schedule's single slice, T x panels <
    132, is cut into chunks; larger calls keep MAX_CHUNK_COLS)."""
    p = fb.plan(T, n, n, k)
    busiest = fb.busiest_strips(p.items, p.chunk_cols // fb.STRIP_COLS)
    even = T * p.panels * -(-n // fb.STRIP_COLS) / SMS
    assert busiest == strips and busiest <= max(1.04 * even, 1)
    assert T * p.panels < SMS or p.chunk_cols == fb.MAX_CHUNK_COLS


def test_call_picks_the_copy_path_and_operand_groups():
    """TMA (vec = 1) needs n2 % 4 == 0, X 16-byte aligned and its member
    and slice strides multiples of 4 floats; the fragment groups follow
    the strides the kernel reads (B1 per member, B2 per member and per
    slice unless broadcast)."""
    def call(X, B1, B2):
        return fb.Call(X, B1, B2)

    X = torch.rand(4, 3, 16, 8)
    A = torch.rand(4, 16, 5)
    c = call(X, torch.rand(4, 8, 5), A.unsqueeze(-3).expand(4, 3, 16, 5))
    assert (c.vec, c.b1_groups, c.b2_groups) == (1, 4, 4)
    c = call(X, torch.rand(8, 5), torch.rand(4, 3, 16, 5))
    assert (c.vec, c.b1_groups, c.b2_groups) == (1, 1, 12)
    c = call(X[0], torch.rand(8, 5), torch.rand(1, 16, 5).expand(3, 16, 5))
    assert (c.vec, c.b1_groups, c.b2_groups) == (1, 1, 1)
    odd = torch.rand(2, 16, 7)
    assert call(odd, torch.rand(7, 5), torch.rand(2, 16, 5)).vec == 0
    # a view starting one float in: not 16-byte aligned
    shifted = torch.rand(2 * 16 * 8 + 1)[1:].view(2, 16, 8)
    assert call(shifted, torch.rand(8, 5), torch.rand(2, 16, 5)).vec == 0
    # a slice stride of 16 * 8 + 2 floats: rows aligned, slices not
    wide = torch.rand(2, 16 * 8 + 2)[:, :16 * 8].view(2, 16, 8)
    assert call(wide, torch.rand(8, 5), torch.rand(2, 16, 5)).vec == 0
    # the sliced schedule's view: one slice, B2 broadcast
    c = call(X[:, 1:2], torch.rand(4, 8, 5), A.unsqueeze(-3))
    assert (c.vec, c.T, c.b1_groups, c.b2_groups) == (1, 4, 4, 4)
