"""The port's BCSR kernels: plain versions against repro's, dispatch rules
and the wrappers' argument checks.

On the CPU the wrappers run their plain versions (kernels/ref.py), held
here against ``repro.kernels.ref`` at rtol 1e-5.  The CUDA kernels against
their plain versions on a card: ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparse as jsp
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import sparse as tsp
from repro_torch.kernels import _build, bcsr_fused, bcsr_spmm, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.policy import KernelPolicy

RTOL = 1e-5

# (n, bs, block density, k): bs | n; bs not dividing n; empty block rows
CASES = [(64, 16, 0.4, 3), (70, 16, 0.4, 4), (96, 16, 0.05, 5)]


def make(seed, n, bs, density, m=2):
    rng = np.random.default_rng(seed)
    nb = -(-n // bs)
    keep = rng.random((nb, nb)) < density
    keep[nb - 1, 0] = True
    rows, cols = np.nonzero(keep)
    data = rng.random((m, rows.shape[0], bs, bs), dtype=np.float32)
    mask = (np.arange(nb * bs) < n).astype(np.float32).reshape(nb, bs)
    data *= mask[rows][None, :, :, None] * mask[cols][None, :, None, :]
    j = jsp.BCSR(data=jnp.asarray(data),
                 block_rows=jnp.asarray(rows, jnp.int32),
                 block_cols=jnp.asarray(cols, jnp.int32), n=n)
    return j, rng


def close(a, b):
    a, b = convert.to_numpy(a), np.asarray(b)
    assert a.shape == b.shape
    scale = max(float(np.abs(b).max()), 1e-30)
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("n,bs,density,k", CASES)
def test_ref_bcsr_xa_xta_matches_repro(n, bs, density, k):
    j, rng = make(0, n, bs, density)
    B1 = rng.random((n, k), dtype=np.float32)
    B2 = rng.random((n, k), dtype=np.float32)
    rxa, rxt = jref.ref_bcsr_xa_xta(j, jnp.asarray(B1), jnp.asarray(B2))
    t = convert.bcsr(j, device="cpu")
    xa, xt = tref.ref_bcsr_xa_xta(t, torch.from_numpy(B1),
                                  torch.from_numpy(B2))
    close(xa, rxa)
    close(xt, rxt)


@pytest.mark.parametrize("n,bs,density,k", CASES)
def test_ref_bcsr_spmm_matches_repro(n, bs, density, k):
    j, rng = make(1, n, bs, density)
    B = rng.random((n, k), dtype=np.float32)
    t = convert.bcsr(j, device="cpu")
    close(tref.ref_bcsr_spmm(t, torch.from_numpy(B)),
          jref.ref_bcsr_spmm(j, jnp.asarray(B)))


def test_empty_block_rows_and_cols_are_exact_zero():
    j, rng = make(2, 96, 16, 0.05)
    t = convert.bcsr(j, device="cpu")
    B = torch.from_numpy(rng.random((96, 3), dtype=np.float32))
    xa, xt = tref.ref_bcsr_xa_xta(t, B, B)
    rows = set(np.asarray(j.block_rows).tolist())
    cols = set(np.asarray(j.block_cols).tolist())
    for i in range(t.nblocks):
        sl = slice(i * 16, (i + 1) * 16)
        assert bool((xa[:, sl] == 0).all()) == (i not in rows)
        assert bool((xt[:, sl] == 0).all()) == (i not in cols)


def test_nnzb_zero_gives_zeros():
    t = tsp.BCSR(data=torch.zeros((2, 0, 32, 32)),
                 block_rows=torch.zeros(0, dtype=torch.int32),
                 block_cols=torch.zeros(0, dtype=torch.int32), n=50)
    B = torch.rand(3, 50, 4)            # member-batched operand
    xa, xt = ops.bcsr_xa_xta(t, B, B)
    assert xa.shape == xt.shape == (3, 2, 50, 4)
    assert not xa.any() and not xt.any()
    assert not ops.bcsr_spmm(t, B).any()


def test_member_batched_plain_versions():
    """Data (r, m, ...) and operands (r, n, k): member q of the result is
    the single-member product."""
    j, rng = make(3, 70, 16, 0.4)
    t = convert.bcsr(j, device="cpu")
    data = torch.stack([t.data, 2 * t.data])
    B = torch.from_numpy(rng.random((2, 70, 4), dtype=np.float32))
    xa, xt = tref.ref_bcsr_xa_xta(t.with_data(data), B, B)
    for q in range(2):
        sq = t.with_data(data[q])
        close(xa[q], tsp.spmm(sq, B[q]))
        close(xt[q], tsp.spmm_t(sq, B[q]))


def test_cpu_dispatch_uses_plain_version_and_counts_nothing():
    j, rng = make(4, 64, 16, 0.4)
    t = convert.bcsr(j, device="cpu")
    B = torch.from_numpy(rng.random((64, 3), dtype=np.float32))
    ops.reset_launch_counts()
    for impl in ("auto", "ref"):
        xa, xt = ops.bcsr_xa_xta(t, B, B, impl=impl)
        close(xa, tsp.spmm(t, B))
        close(xt, tsp.spmm_t(t, B))
        close(ops.bcsr_spmm(t, B, impl=impl), tsp.spmm(t, B))
    xa, xt = bcsr_fused.bcsr_xa_xta(t, B, B)      # the wrappers themselves
    close(xt, tsp.spmm_t(t, B))
    close(bcsr_spmm.bcsr_spmm(t, B), tsp.spmm(t, B))
    assert ops.launch_counts() == {"bcsr_xa_xta": 0, "bcsr_spmm": 0,
                                   "fused_xa_xtb": 0, "mu_update_a": 0,
                                   "score_topk": 0, "flash_attention": 0}


@pytest.mark.parametrize("kernel", ["bcsr_xa_xta", "bcsr_spmm"])
def test_cuda_impl_on_cpu_tensor_raises(kernel):
    j, rng = make(5, 64, 16, 0.4)
    t = convert.bcsr(j, device="cpu")
    B = torch.from_numpy(rng.random((64, 3), dtype=np.float32))
    args = (t, B, B) if kernel == "bcsr_xa_xta" else (t, B)
    with pytest.raises(ValueError, match="impl='cuda'"):
        getattr(ops, kernel)(*args, impl="cuda")


def test_policy_rejects_unknown_impl():
    with pytest.raises(ValueError, match="impl"):
        KernelPolicy(impl="pallas")


def test_build_is_keyed_by_sources(tmp_path, monkeypatch):
    """All six kernels' sources (flash_attention's two variants) are
    compiled, and an edit to any source — the shared header included —
    gives a new build directory (test_torch_cli checks that importing
    builds nothing)."""
    names = {p.name for p in _build.sources()}
    assert names == {"bcsr_spmm.cu", "bcsr_fused.cu", "fused_bilinear.cu",
                     "mu_update_a.cu", "score_topk.cu", "flash_attention.cu",
                     "flash_attention_sm90.cu"}
    assert set(_build.SIGNATURES) == {"repro_bcsr_spmm",
                                      "repro_bcsr_xa_xta",
                                      "repro_flash_attention",
                                      "repro_flash_attention_sm90",
                                      "repro_fused_xa_xtb",
                                      "repro_mu_update_a",
                                      "repro_score_topk",
                                      "repro_score_topk_plan"}
    for src in _build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._digest()
    assert before == _build._digest()
    for name in ("bcsr_tile.cuh", "score_topk.cu", "fused_bilinear.cu",
                 "mu_update_a.cu", "flash_attention.cu",
                 "flash_attention_sm90.cu"):
        with open(tmp_path / name, "a") as f:
            f.write("\n")
        assert _build._digest() != before
        before = _build._digest()


def _launch_args(*, k=4, bs=32, dtype=torch.float32, operand_members=None,
                 transpose=False, misaligned=False):
    rng = np.random.default_rng(9)
    t = tsp.random_bcsr(rng, m=2, n=70, bs=bs, block_density=0.5,
                        device="cpu")
    if misaligned:          # contiguous, but 4 bytes past a 16-byte boundary
        buf = torch.empty(t.data.numel() + 4)
        off = (-(buf.data_ptr() // 4) + 1) % 4
        data = buf[off:off + t.data.numel()].view(t.data.shape)
        data.copy_(t.data)
        t = t.with_data(data)
    shape = (70, k) if operand_members is None else (operand_members, 70, k)
    B = torch.rand(shape, dtype=dtype)
    if transpose:
        B = B.transpose(-1, -2).contiguous().transpose(-1, -2)
    return t, B


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(k=65), ValueError, "rank k=65"),
    (dict(bs=16), ValueError, "block size 16"),
    (dict(dtype=torch.float64), TypeError, "float32"),
    (dict(transpose=True), ValueError, "contiguous"),
    (dict(misaligned=True), ValueError, "16-byte aligned"),
    (dict(), ValueError, "one CUDA device"),
])
@pytest.mark.parametrize("kernel", ["bcsr_xa_xta", "bcsr_spmm"])
def test_wrapper_checks_reject_what_the_kernels_cannot_take(kernel, kwargs,
                                                            error, match):
    """The checks a CUDA launch passes first: the shared-memory layout's
    limits (k <= 64, bs a multiple of 32 up to 128), float32, contiguity,
    stored blocks 16-byte aligned (bcsr_xa_xta reads them by bulk copy),
    and every tensor on one CUDA device."""
    from repro_torch.kernels._launch import Launch
    t, B = _launch_args(**kwargs)
    operands = (B, B) if kernel == "bcsr_xa_xta" else (B,)
    with pytest.raises(error, match=match):
        Launch(kernel, t, *operands)


@pytest.mark.parametrize("k,members,bs,n", [(1, None, 32, 70), (4, 3, 64, 130),
                                            (5, 2, 32, 64), (12, None, 96, 200),
                                            (33, 4, 128, 130)])
def test_operand_tiles_are_the_kernels_layout(k, members, bs, n):
    """bcsr_xa_xta's operand layout: k-slices of 4 (k <= 4) or 8 columns,
    outermost; zero-padded rows and columns; in each (bs, kc) row tile the
    16-byte slot s at s ^ ((s >> 3) & 7), which puts the 4-row reads of
    eight consecutive 4-column chunks (a quarter-warp's B1 reads) on eight
    different bank groups."""
    rng = np.random.default_rng(k)
    shape = (n, k) if members is None else (members, n, k)
    B = torch.from_numpy(rng.random(shape, dtype=np.float32))
    n_pad = -(-n // bs) * bs
    kc = bcsr_fused.slice_width(k)
    assert kc == (4 if k <= 4 else 8)
    tiles = bcsr_fused.operand_tiles(B, bs, n_pad, kc)
    slices = -(-k // kc)
    assert tiles.shape == (slices, members or 1, n_pad, kc)
    assert tiles.is_contiguous()
    slots = bs * kc // 4
    s = torch.arange(slots)
    phys = s ^ ((s >> 3) & 7)
    flat = tiles.reshape(slices, members or 1, n_pad // bs, slots, 4)
    logical = torch.empty_like(flat)
    logical[..., s, :] = flat[..., phys, :]
    want = torch.zeros((members or 1, n_pad, slices * kc))
    want[:, :n, :k] = B if members is not None else B[None]
    got = logical.reshape(slices, members or 1, n_pad, kc)
    assert torch.equal(torch.cat(list(got), dim=-1), want)
    for j in range(4):
        for h in range(kc // 4):
            chunk_reads = [int(phys[(4 * q + j) * (kc // 4) + h]) % 8
                           for q in range(min(8, bs // 4))]
            assert len(set(chunk_reads)) == len(chunk_reads)


def test_wrapper_rejects_mismatched_member_counts():
    from repro_torch.kernels._launch import Launch
    t, B = _launch_args(operand_members=3)
    t2 = t.with_data(torch.stack([t.data, t.data]))
    with pytest.raises(ValueError, match="2 members, operands 3"):
        Launch("bcsr_spmm", t2, B)


# ---------------------------------------------------------------------------
# score_topk: the plain versions against repro's, dispatch and checks
# ---------------------------------------------------------------------------

def _va(seed, b=5, n=1000, k=7):
    rng = np.random.default_rng(seed)
    return (rng.random((b, k), dtype=np.float32),
            rng.random((n, k), dtype=np.float32))


def same_topk(got, want, want_next):
    """Scores at rtol 1e-5; indices equal wherever the reference's scores
    are separated from their neighbours (want_next: the reference's
    score of rank topk + 1) by more than that."""
    (gs, gi), (ws, wi) = ([convert.to_numpy(x) for x in got],
                          [np.asarray(x) for x in want])
    assert gs.dtype == np.float32 and gi.dtype == np.int32
    assert gs.shape == gi.shape == ws.shape
    finite = np.isfinite(ws)
    assert (np.isfinite(gs) == finite).all()
    np.testing.assert_allclose(gs[finite], ws[finite], rtol=RTOL)
    pad = np.concatenate([np.full((ws.shape[0], 1), np.inf), ws,
                          np.asarray(want_next)[:, None]], axis=1)
    tol = RTOL * np.abs(ws[finite]).max()
    gap = np.minimum(pad[:, 1:-1] - pad[:, 2:], pad[:, :-2] - pad[:, 1:-1])
    sep = ~finite | (gap > tol)
    np.testing.assert_array_equal(gi[sep], wi[sep])
    assert sep.mean() > 0.5


@pytest.mark.parametrize("pn", [128, 2048])
def test_ref_score_topk_stream_matches_repro(pn):
    from repro.kernels import ops as jops
    V, A = _va(0)
    want = jops.score_topk(jnp.asarray(V), jnp.asarray(A), topk=10,
                           impl="stream", pn=pn)
    nxt = np.asarray(jref.ref_score_topk(jnp.asarray(V), jnp.asarray(A),
                                         11)[0])[:, 10]
    got = tref.ref_score_topk_stream(torch.from_numpy(V),
                                     torch.from_numpy(A), 10, pn)
    same_topk(got, want, nxt)
    same_topk(tref.ref_score_topk(torch.from_numpy(V), torch.from_numpy(A),
                                  10),
              jref.ref_score_topk(jnp.asarray(V), jnp.asarray(A), 10), nxt)


@pytest.mark.parametrize("plain", ["stream", "materializing"])
def test_score_topk_past_n_pads_like_repro(plain):
    V, A = _va(1, n=6)
    fn = (tref.ref_score_topk if plain == "materializing"
          else lambda v, a, t: tref.ref_score_topk_stream(v, a, t, 128))
    s, i = fn(torch.from_numpy(V), torch.from_numpy(A), 10)
    ws, wi = jref.ref_score_topk(jnp.asarray(V), jnp.asarray(A), 10)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=RTOL)
    assert (i.numpy()[:, 6:] == -1).all() and np.isneginf(s.numpy()[:, 6:]
                                                         ).all()


@pytest.mark.parametrize("topk", [1, 10, 100])
def test_score_topk_exact_ties_match_repro(topk):
    """Integer factors with repeated rows of A: every order of summation
    gives bit-equal scores, and ties go to the lowest index."""
    from repro.kernels import ops as jops
    rng = np.random.default_rng(2)
    A = rng.integers(0, 3, (400, 6)).astype(np.float32)
    A[200:] = A[:200]
    V = rng.integers(0, 3, (5, 6)).astype(np.float32)
    ws, wi = jops.score_topk(jnp.asarray(V), jnp.asarray(A), topk=topk,
                             impl="stream", pn=128)
    rs, ri = jref.ref_score_topk(jnp.asarray(V), jnp.asarray(A), topk)
    for s, i in (tref.ref_score_topk_stream(torch.from_numpy(V),
                                            torch.from_numpy(A), topk, 128),
                 tref.ref_score_topk(torch.from_numpy(V),
                                     torch.from_numpy(A), topk)):
        np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(s.numpy(), np.asarray(ws))


def test_score_topk_cpu_dispatch_uses_plain_version_and_counts_nothing():
    V, A = (torch.from_numpy(x) for x in _va(3, n=300))
    want = tref.ref_score_topk_stream(V, A, 7, 128)
    ops.reset_launch_counts()
    for impl in ("auto", "ref"):
        s, i = ops.score_topk(V, A, topk=7, impl=impl, pn=128)
        assert torch.equal(s, want[0]) and torch.equal(i, want[1])
    with pytest.raises(ValueError, match="impl='cuda'"):
        ops.score_topk(V, A, topk=7, impl="cuda")
    assert ops.launch_counts()["score_topk"] == 0


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(k=65), ValueError, "rank k=65"),
    (dict(topk=1025), ValueError, "topk=1025"),
    (dict(topk=0), ValueError, "topk=0"),
    (dict(dtype=torch.float64), TypeError, "float32"),
    (dict(transpose=True), ValueError, "contiguous"),
    (dict(), ValueError, "one CUDA device"),
])
def test_score_topk_checks_reject_what_the_kernel_cannot_take(kwargs, error,
                                                              match):
    """The checks a CUDA launch passes first: k <= 64 (register rows),
    1 <= topk <= 1024 (shared-memory lists), float32, contiguity, and
    both tensors on one CUDA device."""
    from repro_torch.kernels import score_topk
    k = kwargs.get("k", 8)
    A = torch.rand(50, k, dtype=kwargs.get("dtype", torch.float32))
    if kwargs.get("transpose"):
        A = A.T.contiguous().T
    V = torch.rand(4, k, dtype=A.dtype)
    with pytest.raises(error, match=match):
        score_topk.check(V, A, kwargs.get("topk", 10))


# ---------------------------------------------------------------------------
# fused_xa_xtb: the plain version against repro's, dispatch and checks
# ---------------------------------------------------------------------------

# (m, n1, n2, k, r, B2 shared over m): n1 != n2, neither a multiple of the
# kernel's tile, n in {1, 37, 1000}; m = 1 (the sliced schedule's call);
# k in {1, 3, 5, 16, 64}; r in {1, 4}; B2 broadcast over m (stride 0)
FUSED_CASES = [(3, 37, 1000, 3, None, False), (1, 1000, 37, 5, 4, True),
               (2, 1, 37, 1, None, True), (3, 37, 1, 16, 4, False),
               (1, 37, 37, 64, None, False), (4, 40, 24, 5, 4, True)]


def fused_inputs(seed, m, n1, n2, k, r, shared):
    rng = np.random.default_rng(seed)
    lead = (r,) if r is not None else ()
    X = rng.random(lead + (m, n1, n2), dtype=np.float32)
    B1 = rng.random(lead + (n2, k), dtype=np.float32)
    if shared:
        B2 = np.broadcast_to(rng.random(lead + (1, n1, k),
                                        dtype=np.float32),
                             lead + (m, n1, k))
    else:
        B2 = rng.random(lead + (m, n1, k), dtype=np.float32)
    return X, B1, B2


def to_torch_b2(B2, shared):
    """B2 as the engine passes it: a stride-0 view over m when shared."""
    if not shared:
        return torch.from_numpy(np.ascontiguousarray(B2))
    one = torch.from_numpy(np.ascontiguousarray(B2[..., :1, :, :]))
    return one.expand(B2.shape)


@pytest.mark.parametrize("m,n1,n2,k,r,shared", FUSED_CASES)
def test_ref_fused_xa_xtb_matches_repro(m, n1, n2, k, r, shared):
    """Member by member against repro.kernels.ref.ref_fused_xa_xtb (the
    Pallas interpret path is broken under this JAX; see ROADMAP.md)."""
    X, B1, B2 = fused_inputs(m + n1, m, n1, n2, k, r, shared)
    b2 = to_torch_b2(B2, shared)
    if shared:
        assert b2.stride(-3) == 0
    xa, xtb = tref.ref_fused_xa_xtb(torch.from_numpy(X),
                                    torch.from_numpy(B1), b2)
    members = range(r) if r is not None else [None]
    for q in members:
        pick = (lambda a: a) if q is None else (lambda a: a[q])
        rxa, rxtb = jref.ref_fused_xa_xtb(jnp.asarray(pick(X)),
                                          jnp.asarray(pick(B1)),
                                          jnp.asarray(pick(B2)))
        close(pick(xa), rxa)
        close(pick(xtb), rxtb)


def test_ref_fused_xa_xtb_shared_x_folds_members():
    """A shared X (m, n1, n2) with member-stacked B1/B2 (the pod step's
    call) gives each member's products without copying X r times."""
    X, B1, B2 = fused_inputs(3, 2, 30, 20, 4, 3, False)
    xa, xtb = tref.ref_fused_xa_xtb(torch.from_numpy(X[0]),
                                    torch.from_numpy(B1),
                                    torch.from_numpy(B2))
    assert tuple(xa.shape) == (3, 2, 30, 4) and tuple(xtb.shape) == (
        3, 2, 20, 4)
    for q in range(3):
        rxa, rxtb = jref.ref_fused_xa_xtb(jnp.asarray(X[0]),
                                          jnp.asarray(B1[q]),
                                          jnp.asarray(B2[q]))
        close(xa[q], rxa)
        close(xtb[q], rxtb)


def test_fused_cpu_dispatch_uses_plain_version_and_counts_nothing():
    X, B1, B2 = (torch.from_numpy(np.ascontiguousarray(a))
                 for a in fused_inputs(5, 2, 33, 17, 3, None, False))
    want = tref.ref_fused_xa_xtb(X, B1, B2)
    ops.reset_launch_counts()
    from repro_torch.kernels import fused_bilinear
    for got in (ops.fused_xa_xtb(X, B1, B2),
                ops.fused_xa_xtb(X, B1, B2, impl="ref"),
                fused_bilinear.fused_xa_xtb(X, B1, B2)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="impl='cuda'"):
        ops.fused_xa_xtb(X, B1, B2, impl="cuda")
    assert ops.launch_counts()["fused_xa_xtb"] == 0


def _fused_args(*, k=4, dtype=torch.float32, b1_members=None,
                x_cols=False, b1_cols=False, m=2):
    X = torch.rand(m, 9, 7, dtype=dtype)
    if x_cols:
        X = X.transpose(-1, -2).contiguous().transpose(-1, -2)
    B1 = torch.rand((7, k) if b1_members is None else (b1_members, 7, k),
                    dtype=dtype)
    if b1_cols:
        B1 = B1.transpose(-1, -2).contiguous().transpose(-1, -2)
    B2 = torch.rand(2, m, 9, k, dtype=dtype)
    return X, B1, B2


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(k=65), ValueError, "rank k=65"),
    (dict(dtype=torch.float64), TypeError, "float32"),
    (dict(x_cols=True), ValueError, "X's last two axes"),
    (dict(b1_cols=True), ValueError, "B1's last two axes"),
    (dict(b1_members=3), ValueError, "member axes disagree"),
    (dict(), ValueError, "one CUDA device"),
])
def test_fused_checks_reject_what_the_kernel_cannot_take(kwargs, error,
                                                         match):
    """The checks a CUDA launch passes first: k <= 64 (register
    accumulators), float32, row-major last axes, one member count, and
    every tensor on one CUDA device."""
    from repro_torch.kernels.fused_bilinear import Call
    args = _fused_args(**kwargs)
    with pytest.raises(error, match=match):
        Call(*args).require_cuda(*args)


def test_fused_call_reads_strides_without_copies():
    """A slice view of X (the sliced schedule) and B2 broadcast over m
    pass as strides: no copy, the launch shape and the float4 path from
    the strides."""
    from repro_torch.kernels.fused_bilinear import Call
    X = torch.rand(4, 3, 16, 8)
    Ai = torch.rand(4, 16, 5)
    Xt = X[:, 1:3]
    B2 = Ai.unsqueeze(-3).expand(4, 2, 16, 5)
    c = Call(Xt, torch.rand(4, 8, 5), B2)
    with pytest.raises(ValueError, match="one CUDA device"):
        c.require_cuda(Xt, B2)
    assert c.strides == (3 * 16 * 8, 16 * 8, 8 * 5, 16 * 5, 0)
    assert (c.T, c.m, c.n1, c.n2, c.k, c.vec) == (8, 2, 16, 8, 5, 1)
