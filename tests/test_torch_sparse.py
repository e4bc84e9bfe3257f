"""repro_torch.core against repro.core on the same BCSR operands.

Inputs are made with numpy from a seed and handed to both packages
(``repro_torch.convert``); the JAX side runs its plain references.  The
tolerance is rtol 1e-5: both sides sum in fp32 in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparse as jsp
from repro.core.rescal import RescalState as JState
from repro.core.rescal import mu_step_batched as j_mu_step
from repro.core.rescal import normalize as j_normalize
from repro.core.rescal import rel_error as j_rel_error
from repro.kernels.policy import KernelPolicy as JPolicy
from repro_torch import convert
from repro_torch.core import rescal as trescal
from repro_torch.core import sparse as tsp
from repro_torch.kernels.policy import KernelPolicy

RTOL = 1e-5

# (n, bs, block density): bs | n, bs not dividing n, sparse with empty
# block rows
SHAPES = [(64, 16, 0.3), (70, 16, 0.3), (96, 16, 0.05)]


def numpy_bcsr(seed, n, bs, density, m=3):
    """A non-negative BCSR from numpy draws, as repro's and the port's.
    Only block (0, 0) is always stored, so at a low density some block
    rows and cols are empty."""
    rng = np.random.default_rng(seed)
    nb = -(-n // bs)
    keep = rng.random((nb, nb)) < density
    keep[0, 0] = True
    rows, cols = np.nonzero(keep)
    data = rng.random((m, rows.shape[0], bs, bs), dtype=np.float32)
    mask = (np.arange(nb * bs) < n).astype(np.float32).reshape(nb, bs)
    data *= mask[rows][None, :, :, None] * mask[cols][None, :, None, :]
    j = jsp.BCSR(data=jnp.asarray(data),
                 block_rows=jnp.asarray(rows, jnp.int32),
                 block_cols=jnp.asarray(cols, jnp.int32), n=n)
    return j, convert.bcsr(j, device="cpu"), rng


def factors(rng, n, m, k):
    A = rng.uniform(0.05, 1.0, (n, k)).astype(np.float32)
    R = rng.uniform(0.05, 1.0, (m, k, k)).astype(np.float32)
    return A, R


def close(a, b, rtol=RTOL):
    a, b = convert.to_numpy(a), np.asarray(b)
    assert a.shape == b.shape
    scale = max(float(np.abs(b).max()), 1e-30)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("n,bs,density", SHAPES)
@pytest.mark.parametrize("which", ["spmm", "spmm_t"])
def test_products_match_repro(n, bs, density, which):
    j, t, rng = numpy_bcsr(0, n, bs, density)
    B = rng.random((n, 5), dtype=np.float32)
    ref = getattr(jsp, which)(j, jnp.asarray(B))
    close(getattr(tsp, which)(t, torch.from_numpy(B)), ref)


def test_empty_pattern_products_are_zero():
    t = tsp.BCSR(data=torch.zeros((2, 0, 16, 16)),
                 block_rows=torch.zeros(0, dtype=torch.int32),
                 block_cols=torch.zeros(0, dtype=torch.int32), n=40)
    B = torch.rand(40, 3)
    assert torch.equal(tsp.spmm(t, B), torch.zeros(2, 40, 3))
    assert torch.equal(tsp.spmm_t(t, B), torch.zeros(2, 40, 3))
    assert t.row_ptr.tolist() == [0, 0, 0, 0]


def test_dense_roundtrip_and_row_ptr():
    j, t, _ = numpy_bcsr(1, 70, 16, 0.3)
    dense = tsp.to_dense(t)
    close(dense, jsp.to_dense(j), rtol=0)
    back = tsp.from_dense(dense, bs=16)
    assert torch.equal(back.block_rows, t.block_rows)
    assert torch.equal(back.data, t.data)
    counts = np.bincount(np.asarray(j.block_rows), minlength=t.nblocks)
    assert t.row_ptr.tolist() == [0] + np.cumsum(counts).tolist()


def test_unsorted_blocks_rejected():
    with pytest.raises(ValueError, match="row-major"):
        tsp.BCSR(data=torch.zeros((1, 2, 16, 16)),
                 block_rows=torch.tensor([1, 0], dtype=torch.int32),
                 block_cols=torch.tensor([0, 0], dtype=torch.int32), n=32)


def test_random_bcsr_masks_padded_tail():
    t = tsp.random_bcsr(np.random.default_rng(0), m=2, n=40, bs=16,
                        block_density=0.5, device="cpu")
    dense = tsp.to_dense(t)
    padded = tsp.from_dense(torch.nn.functional.pad(dense, (0, 8, 0, 8)),
                            bs=16)
    assert float(padded.data.sum()) == pytest.approx(float(dense.sum()))


@pytest.mark.parametrize("n,bs,density", SHAPES)
@pytest.mark.parametrize("fused", [False, True])
def test_mu_step_matches_repro(n, bs, density, fused):
    """One sparse MU step; fused runs the port's plain kernel versions
    (CPU tensors) against repro's impl='ref'."""
    j, t, rng = numpy_bcsr(2, n, bs, density)
    A, R = factors(rng, n, 3, 4)
    jp = JPolicy(use_fused=True, impl="ref") if fused else None
    tp = KernelPolicy(use_fused=True) if fused else None
    jA, jR = jsp.sparse_mu_step(j, jnp.asarray(A), jnp.asarray(R),
                                policy=jp)
    tA, tR = tsp.sparse_mu_step(t, torch.from_numpy(A), torch.from_numpy(R),
                                policy=tp)
    close(tA, jA)
    close(tR, jR)


@pytest.mark.parametrize("n,bs,density", SHAPES)
def test_member_axis_matches_one_member_at_a_time(n, bs, density):
    """The written-out member axis (repro's vmap): r perturbed copies and
    r factor sets in one step equal r single steps."""
    _, t, rng = numpy_bcsr(3, n, bs, density)
    r = 3
    noise = rng.uniform(0.98, 1.02, (r,) + tuple(t.data.shape))
    data = t.data * torch.from_numpy(noise.astype(np.float32))
    A = torch.from_numpy(rng.uniform(0.05, 1, (r, n, 4)).astype(np.float32))
    R = torch.from_numpy(rng.uniform(0.05, 1, (r, 3, 4, 4)).astype(
        np.float32))
    bA, bR = tsp.sparse_mu_step(t.with_data(data), A, R)
    for q in range(r):
        qA, qR = tsp.sparse_mu_step(t.with_data(data[q]), A[q], R[q])
        close(bA[q], qA)
        close(bR[q], qR)


@pytest.mark.parametrize("n,bs,density", SHAPES)
@pytest.mark.parametrize("fused", [False, True])
def test_rel_error_matches_repro(n, bs, density, fused):
    """rtol 1e-5, not tighter: the error identity cancels."""
    j, t, rng = numpy_bcsr(4, n, bs, density)
    A, R = factors(rng, n, 3, 4)
    jp = JPolicy(use_fused=True, impl="ref") if fused else None
    tp = KernelPolicy(use_fused=True) if fused else None
    ref = jsp.sparse_rel_error(j, jnp.asarray(A), jnp.asarray(R), policy=jp)
    got = tsp.sparse_rel_error(t, torch.from_numpy(A), torch.from_numpy(R),
                               policy=tp)
    close(got, ref)


@pytest.mark.parametrize("fused", [False, True])
def test_regress_R_with_injected_R0(fused):
    """sparse_regress_R from repro's own PRNGKey(17) draw."""
    j, t, rng = numpy_bcsr(5, 70, 16, 0.3)
    A = rng.uniform(0.05, 1.0, (70, 3)).astype(np.float32)
    R0 = jax.random.uniform(jax.random.PRNGKey(17), (3, 3, 3),
                            dtype=jnp.float32, minval=0.05, maxval=1.0)
    ref = jsp.sparse_regress_R(j, jnp.asarray(A), iters=30)
    got = tsp.sparse_regress_R(
        t, torch.from_numpy(A), convert.tensor(R0, "cpu"), iters=30,
        policy=KernelPolicy(use_fused=True) if fused else None)
    close(got, ref)
    G = trescal.gram(torch.from_numpy(A))
    one = tsp.sparse_update_R(t, torch.from_numpy(A),
                              convert.tensor(R0, "cpu"), G)
    close(one, jsp.sparse_update_R(j, jnp.asarray(A), R0,
                                   jnp.asarray(A).T @ jnp.asarray(A)))


def test_dense_core_matches_repro():
    """The dense MU step, normalize and rel_error of core/rescal.py."""
    rng = np.random.default_rng(6)
    X = rng.random((3, 40, 40), dtype=np.float32)
    A, R = factors(rng, 40, 3, 4)
    js = j_mu_step(jnp.asarray(X), JState(jnp.asarray(A), jnp.asarray(R),
                                          jnp.zeros((), jnp.int32)))
    ts = trescal.mu_step_batched(torch.from_numpy(X),
                                 convert.rescal_state(A=A, R=R,
                                                      device="cpu"))
    close(ts.A, js.A)
    close(ts.R, js.R)
    jn, tn = j_normalize(js), trescal.normalize(ts)
    close(tn.A, jn.A)
    close(tn.R, jn.R)
    close(trescal.rel_error(torch.from_numpy(X), tn.A, tn.R),
          j_rel_error(jnp.asarray(X), jn.A, jn.R))


def test_cuda_default_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsp.random_bcsr(np.random.default_rng(0), m=1, n=32, bs=16)


def test_dense_rescal_and_regression_match_repro():
    """rescal() from a given init, and regress_R from repro's PRNGKey(17)
    draw, on a dense tensor."""
    from repro.core.regression import regress_R as j_regress
    from repro.core.rescal import rescal as j_rescal
    from repro_torch.core.regression import regress_R
    rng = np.random.default_rng(7)
    X = rng.random((2, 30, 30), dtype=np.float32)
    A, R = factors(rng, 30, 2, 3)
    jst, jerr = j_rescal(jnp.asarray(X), 3, iters=15,
                         init=JState(jnp.asarray(A), jnp.asarray(R),
                                     jnp.zeros((), jnp.int32)))
    tst, terr = trescal.rescal(torch.from_numpy(X), 3, iters=15,
                               init=convert.rescal_state(A=A, R=R,
                                                         device="cpu"))
    close(tst.A, jst.A, rtol=1e-4)
    close(terr, jerr)
    R0 = jax.random.uniform(jax.random.PRNGKey(17), (2, 3, 3),
                            dtype=jnp.float32, minval=0.05, maxval=1.0)
    close(regress_R(torch.from_numpy(X), torch.from_numpy(A),
                    convert.tensor(R0, "cpu"), iters=20),
          j_regress(jnp.asarray(X), jnp.asarray(A), iters=20))


def test_sanitizer_and_metrics_hooks_when_enabled():
    """Off by default; enabled, the sanitizer names the step and the
    metrics hook records one entry per step."""
    from repro_torch.analysis.sanitizer import FactorSanitizerError
    from repro_torch.obs import metrics
    _, t, rng = numpy_bcsr(8, 64, 16, 0.3)
    A, R = (torch.from_numpy(x) for x in factors(rng, 64, 3, 3))
    tsp.sparse_mu_step(t, -A, R)                     # default: unchecked
    with pytest.raises(FactorSanitizerError, match="sparse_mu_step"):
        tsp.sparse_mu_step(t, -A, R, sanitize=True)
    buf = metrics.MetricsBuffer()
    prev = metrics.install_buffer(buf)
    try:
        tsp.sparse_mu_step(t, A, R)
        assert buf.records == []
        A1, R1 = tsp.sparse_mu_step(t, A, R, trace_metrics=True)
    finally:
        metrics.install_buffer(prev)
    [(_, tag, rec)] = buf.records
    assert tag == "core.sparse.sparse_mu_step"
    np.testing.assert_allclose(rec["rel_error"],
                               tsp.sparse_rel_error(t, A1, R1).numpy(),
                               rtol=1e-6)
