"""The port's single-device dense sweep and its mu_update_a against repro.

The same numpy-seeded inputs go through both packages.  The sweeps run
on repro's own draws: ``ArrayDraws`` filled from repro's key discipline
(``unit_keys`` -> split into (pkey, fkey) -> the perturbation noise and
``init_factors``' draws; the regression's PRNGKey(17)).  One test spawns
a 1 x 1 gloo grid, whose worker imports this module to find its
function, so ``jax`` and ``repro`` are imported inside the tests only.

Tolerances: mu_update_a at rtol 1e-6 (one ratio, sums of k terms in
another order); one masked step at rtol 1e-5; NNDSVD at rtol 1e-4 (two
eigensolvers); members after 40 MU iterations at rtol 1e-4 / atol 1e-5
(fp32 sums in another order compound, as in test_torch_selection); sweep
curves within 1e-4 per k; two port paths on the same numbers within
1e-5.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import rescal as tr
from repro_torch.core import sparse as tsp
from repro_torch.core.nndsvd import nndsvd_init_A, randomized_eigh
from repro_torch.core.rescalk import rescalk
from repro_torch.io import manifest_of
from repro_torch.kernels import mu_update_a as tmu
from repro_torch.kernels import ops
from repro_torch.kernels.policy import KernelPolicy
from repro_torch.launch import rescalk_run
from repro_torch.launch.mesh import spawn_grid
from repro_torch.selection import (ArrayDraws, GridChunk, RescalkConfig,
                                   SweepScheduler, TorchDraws, plan_sweep,
                                   run_ensemble, run_sweep_batched)

EPS = 1e-16
N, M, K_TRUE = 24, 3, 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Run this module's many small products on one intra-op thread: with
    several test workers sharing the cores, idle OpenMP threads spinning
    on tiny products cost far more than the parallelism gives."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
SWEEP = dict(k_min=2, k_max=4, n_perturbations=4, rescal_iters=40,
             regress_iters=50, seed=3)
FUSED = KernelPolicy(use_fused=True)


def planted_dense(seed=7, n=N, m=M, k=K_TRUE):
    """A planted non-negative X = A R A^T * noise (m, n, n), community
    structured, as numpy float32."""
    rng = np.random.default_rng(seed)
    A = np.zeros((n, k))
    A[np.arange(n), np.arange(n) * k // n] = rng.uniform(0.5, 1.0, n)
    A += 0.05 * rng.uniform(size=(n, k))
    R = rng.uniform(0.1, 1.0, (m, k, k))
    X = np.einsum("ia,mab,jb->mij", A, R, A) * rng.uniform(0.98, 1.02,
                                                          (m, n, n))
    return X.astype(np.float32)


def planted_bcsr(n=40, bs=16, m=2, k=3, seed=0):
    """repro's BCSR of a planted tensor whose unlinked community blocks
    drop out."""
    import jax.numpy as jnp
    from repro.core import sparse as jsp
    rng = np.random.default_rng(seed)
    A = np.zeros((n, k), np.float32)
    A[np.arange(n), np.arange(n) * k // n] = rng.uniform(0.5, 1.0, n)
    R = rng.uniform(0.1, 1.0, (m, k, k)).astype(np.float32)
    R[:, 0, 2] = R[:, 2, 0] = 0.0
    X = np.einsum("ia,mab,jb->mij", A, R, A).astype(np.float32)
    return jsp.from_dense(jnp.asarray(X), bs=bs)


def jcfg(**kw):
    from repro.selection import RescalkConfig as JConfig
    return JConfig(**{**SWEEP, **kw})


def tcfg(**kw):
    return RescalkConfig(**{**SWEEP, **kw})


def repro_draws(cfg, X) -> ArrayDraws:
    """repro's draws for every member of the sweep: the noise of the
    values a member perturbs (a dense X, or a BCSR's stored blocks) and
    init_factors' A0, R0 from the member key's (pkey, fkey) split."""
    import jax
    from repro.core.rescal import init_factors
    from repro.selection.ensemble import unit_keys
    vals = X.data if hasattr(X, "block_rows") else X
    m, n = (X.m, X.n) if hasattr(X, "block_rows") else X.shape[:2]
    members = {}
    for k in cfg.ks:
        keys = unit_keys(cfg, k, tuple(range(cfg.n_perturbations)))
        for q in range(cfg.n_perturbations):
            pkey, fkey = jax.random.split(keys[q])
            noise = jax.random.uniform(pkey, vals.shape, np.float32,
                                       1.0 - cfg.perturbation_delta,
                                       1.0 + cfg.perturbation_delta)
            st = init_factors(fkey, n, m, k)
            members[(k, q)] = (noise, st.A, st.R)
    regress = {k: jax.random.uniform(jax.random.PRNGKey(17), (m, k, k),
                                     minval=0.05, maxval=1.0)
               for k in cfg.ks}
    return ArrayDraws(members, regress, device="cpu")


def repro_rescal():
    """repro's core/rescal.py (``repro.core`` exports a function of that
    name, which shadows the module as an attribute)."""
    import importlib
    return importlib.import_module("repro.core.rescal")


def t(x):
    return torch.as_tensor(np.array(x, np.float32))


def close(got, ref, rtol, atol=0.0):
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(ref),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# mu_update_a
# ---------------------------------------------------------------------------

def mu_inputs(seed, n, k, r=None):
    rng = np.random.default_rng(seed)
    lead = (r,) if r is not None else ()
    A = rng.uniform(0.05, 1.0, lead + (n, k)).astype(np.float32)
    Num = rng.uniform(0.05, 1.0, lead + (n, k)).astype(np.float32)
    S = rng.uniform(0.05, 1.0, lead + (k, k)).astype(np.float32)
    return A, Num, S


@pytest.mark.parametrize("k", [1, 3, 5, 16, 64])
@pytest.mark.parametrize("n", [1, 37, 1000])
def test_mu_update_a_plain_matches_repro_ref(n, k):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    A, Num, S = mu_inputs(n * k, n, k)
    ref = jref.ref_mu_update_a(jnp.asarray(A), jnp.asarray(Num),
                               jnp.asarray(S), EPS)
    for got in (ops.mu_update_a(t(A), t(Num), t(S), EPS),
                tmu.mu_update_a(t(A), t(Num), t(S), EPS)):
        close(got, ref, rtol=1e-6)


@pytest.mark.parametrize("k", [1, 3, 5, 16, 64])
def test_mu_update_a_matches_repro_pallas_interpret(k):
    """repro's Pallas kernel body in interpret mode (n = 1024, bm = 256:
    four row panels)."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    A, Num, S = mu_inputs(k, 1024, k)
    ref = jops.mu_update_a(jnp.asarray(A), jnp.asarray(Num), jnp.asarray(S),
                           EPS, impl="interpret", bm=256)
    close(ops.mu_update_a(t(A), t(Num), t(S), EPS), ref, rtol=1e-6)


@pytest.mark.parametrize("shared", [False, True])
def test_mu_update_a_member_stack_matches_per_member_calls(shared):
    A, Num, S = mu_inputs(3, 37, 5, r=3)
    S_t = t(S[0]).expand(3, 5, 5) if shared else t(S)
    got = ops.mu_update_a(t(A), t(Num), S_t, EPS)
    for q in range(3):
        one = ops.mu_update_a(t(A[q]), t(Num[q]), S_t[q], EPS)
        close(got[q], convert.to_numpy(one), rtol=1e-6)


def test_mu_update_a_keeps_masked_columns_exactly_zero():
    """Padded cells of the cross-k grid: a zero column of A (and zero rows
    and columns of S) gives 0 * num / (0 + eps) = 0 exactly."""
    A, Num, S = mu_inputs(4, 1000, 5, r=4)
    mask = tr.column_mask([2, 3, 4, 5], 5)
    A_t = t(A) * mask[:, None, :]
    S_t = t(S) * (mask[:, :, None] * mask[:, None, :])
    got = ops.mu_update_a(A_t, t(Num), S_t, EPS)
    assert not (got * (1 - mask[:, None, :])).any()
    assert bool((got[:, :, 0] > 0).all())


def test_mu_update_a_checks_and_dispatch():
    A, Num, S = mu_inputs(5, 37, 3, r=2)
    ops.reset_launch_counts()
    close(ops.mu_update_a(t(A), t(Num), t(S), EPS, impl="ref"),
          convert.to_numpy(tmu.mu_update_a(t(A), t(Num), t(S), EPS)),
          rtol=0)
    assert ops.launch_counts()["mu_update_a"] == 0
    with pytest.raises(ValueError, match="impl='cuda'"):
        ops.mu_update_a(t(A), t(Num), t(S), EPS, impl="cuda")
    call = tmu.Call(t(A), t(Num), t(S[0]).expand(2, 3, 3))
    assert (call.members, call.n, call.k) == (2, 37, 3)
    assert call.strides == (37 * 3, 37 * 3, 0)
    with pytest.raises(ValueError, match="CUDA device"):
        call.require_cuda(t(A))
    with pytest.raises(ValueError, match="rank k=65"):
        tmu.Call(torch.ones(4, 65), torch.ones(4, 65), torch.ones(65, 65))
    with pytest.raises(TypeError, match="float32"):
        tmu.Call(t(A).double(), t(Num), t(S))
    with pytest.raises(ValueError, match="same shape"):
        tmu.Call(t(A), t(Num)[:, :5], t(S))
    with pytest.raises(ValueError, match="member axis"):
        tmu.Call(t(A[0]), t(Num[0]), t(S))
    with pytest.raises(ValueError, match="row-major"):
        tmu.Call(t(A).transpose(-1, -2).contiguous().transpose(-1, -2),
                 t(Num), t(S))


# ---------------------------------------------------------------------------
# The masked (k_max-padded) steps, the fused dense step, NNDSVD
# ---------------------------------------------------------------------------

def state_inputs(seed, n=N, m=M, k=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.05, 1.0, (n, k)).astype(np.float32),
            rng.uniform(0.05, 1.0, (m, k, k)).astype(np.float32))


@pytest.mark.parametrize("schedule", ["batched", "sliced"])
def test_masked_mu_step_matches_repro(schedule):
    """One masked step on padded factors against repro's at rtol 1e-5,
    the padding exactly zero; and the padded run's active block against
    the unpadded run (tests/test_selection.py:332's parity)."""
    import jax.numpy as jnp
    jr = repro_rescal()
    X = planted_dense()
    A0, R0 = state_inputs(1)
    k, k_max = 3, 5
    jst = jr.pad_state(jr.RescalState(A=jnp.asarray(A0), R=jnp.asarray(R0),
                                      step=jnp.zeros((), jnp.int32)), k_max)
    jmask = jr.column_mask(k, k_max)
    ref = jr.masked_mu_step(jnp.asarray(X), jst, jmask, EPS, schedule)
    mask = tr.column_mask(k, k_max)
    st = tr.pad_state(convert.rescal_state(A0, R0, device="cpu"), k_max)
    for policy in (None, FUSED):
        got = tr.masked_mu_step(t(X), st, mask, EPS, schedule,
                                policy=policy)
        close(got.A, ref.A, rtol=1e-5, atol=1e-7)
        close(got.R, ref.R, rtol=1e-5, atol=1e-7)
        assert not got.A[:, k:].any() and not got.R[:, k:, :].any() \
            and not got.R[:, :, k:].any()
    plain = convert.rescal_state(A0, R0, device="cpu")
    padded = st
    for _ in range(10):
        plain = tr.MU_SCHEDULES[schedule](t(X), plain, EPS)
        padded = tr.masked_mu_step(t(X), padded, mask, EPS, schedule)
    crop = tr.crop_state(padded, k)
    close(crop.A, convert.to_numpy(plain.A), rtol=1e-5, atol=1e-7)
    close(crop.R, convert.to_numpy(plain.R), rtol=1e-5, atol=1e-7)
    assert not padded.A[:, k:].any()


def test_masked_normalize_and_rel_error_match_repro():
    import jax.numpy as jnp
    jr = repro_rescal()
    X = planted_dense()
    A0, R0 = state_inputs(2)
    jst = jr.pad_state(jr.RescalState(A=jnp.asarray(A0), R=jnp.asarray(R0),
                                      step=jnp.zeros((), jnp.int32)), 4)
    ref = jr.masked_normalize(jst, jr.column_mask(3, 4))
    st = tr.pad_state(convert.rescal_state(A0, R0, device="cpu"), 4)
    got = tr.masked_normalize(st, tr.column_mask(3, 4))
    close(got.A, ref.A, rtol=1e-5, atol=1e-7)
    close(got.R, ref.R, rtol=1e-5, atol=1e-7)
    assert not got.A[:, 3].any()
    ref_err = jr.rel_error(jnp.asarray(X), ref.A, ref.R)
    assert float(tr.rel_error(t(X), got.A, got.R)) == pytest.approx(
        float(ref_err), rel=1e-5)


def test_masked_sparse_mu_step_matches_repro():
    import jax.numpy as jnp
    jr = repro_rescal()
    from repro.core import sparse as jsp
    jsp_x = planted_bcsr()
    A0, R0 = state_inputs(3, n=40, m=2, k=2)
    jst = jr.pad_state(jr.RescalState(A=jnp.asarray(A0), R=jnp.asarray(R0),
                                      step=jnp.zeros((), jnp.int32)), 4)
    jmask = jr.column_mask(2, 4)
    ref_A, ref_R = jsp.masked_sparse_mu_step(jsp_x, jst.A, jst.R, jmask, EPS)
    sp = convert.bcsr(jsp_x, device="cpu")
    st = tr.pad_state(convert.rescal_state(A0, R0, device="cpu"), 4)
    mask = tr.column_mask(2, 4)
    for policy in (None, FUSED):
        A, R = tsp.masked_sparse_mu_step(sp, st.A, st.R, mask, EPS,
                                         policy=policy)
        close(A, ref_A, rtol=1e-5, atol=1e-7)
        close(R, ref_R, rtol=1e-5, atol=1e-7)
        assert not A[:, 2:].any() and not R[:, 2:, :].any()


def test_masked_steps_sanitize_the_padding():
    from repro_torch.analysis.sanitizer import FactorSanitizerError
    X = planted_dense()
    A0, R0 = state_inputs(4)
    st = tr.pad_state(convert.rescal_state(A0, R0, device="cpu"), 4)
    mask = tr.column_mask(3, 4)
    tr.masked_mu_step(t(X), st, mask, EPS, sanitize=True)
    bad = st._replace(A=st.A.clone())
    bad.A[0, 3] = 1.0
    from repro_torch.analysis.sanitizer import sanitize_state
    with pytest.raises(FactorSanitizerError, match="masked"):
        sanitize_state(bad.A, bad.R, where="test", mask=mask, enabled=True)


@pytest.mark.parametrize("schedule", ["batched", "sliced"])
def test_fused_dense_step_matches_repro(schedule):
    """The fused dense step (one pass over X, then mu_update_a) on the
    plain kernel versions against repro's three-pass step, on one
    factorization and on a member stack."""
    import jax.numpy as jnp
    jr = repro_rescal()
    X = planted_dense()
    A0, R0 = state_inputs(5)
    ref = jr.MU_SCHEDULES[schedule](
        jnp.asarray(X), jr.RescalState(A=jnp.asarray(A0), R=jnp.asarray(R0),
                                       step=jnp.zeros((), jnp.int32)))
    got = tr.MU_SCHEDULES[schedule](
        t(X), convert.rescal_state(A0, R0, device="cpu"), policy=FUSED)
    close(got.A, ref.A, rtol=1e-5, atol=1e-7)
    close(got.R, ref.R, rtol=1e-5, atol=1e-7)
    stack = tr.MU_SCHEDULES[schedule](
        t(np.stack([X, X])),
        tr.RescalState(A=t(np.stack([A0, A0])), R=t(np.stack([R0, R0])),
                       step=0), policy=FUSED)
    close(stack.A[1], ref.A, rtol=1e-5, atol=1e-7)


def separated(seed=0, n=40, m=3):
    """X whose surrogate has eigenvalues 8, 4, 2, 1 over noise 0.01."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    w = np.concatenate([[8.0, 4.0, 2.0, 1.0],
                        0.01 * rng.uniform(size=n - 4)])
    C = (Q * w) @ Q.T
    return np.stack([C * (t_ + 1) / 2 for t_ in range(m)]).astype(np.float32)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_nndsvd_init_matches_repro(k):
    import jax.numpy as jnp
    from repro.core.nndsvd import nndsvd_init_A as j_nndsvd
    X = separated()
    close(nndsvd_init_A(t(X), k), j_nndsvd(jnp.asarray(X), k), rtol=1e-4,
          atol=1e-6)


def test_randomized_eigh_finds_the_leading_pairs():
    X = separated(1)
    C = t(X).sum(0)
    C = (C + C.T) / 6.0
    g = torch.Generator().manual_seed(0)
    w, V = randomized_eigh(lambda Y: C @ Y, 40, 3, g)
    w_ref, V_ref = torch.linalg.eigh(C)
    np.testing.assert_allclose(w.numpy(), w_ref.flip(0)[:3].numpy(),
                               rtol=1e-4)
    overlap = (V.T @ V_ref.flip(1)[:, :3]).abs().diagonal()
    np.testing.assert_allclose(overlap.numpy(), 1.0, rtol=1e-4)


# ---------------------------------------------------------------------------
# Ensembles and the cross-k grid against repro
# ---------------------------------------------------------------------------

def members_close(got, ref):
    close(got.errors, ref.errors, rtol=1e-4)
    close(got.A, ref.A, rtol=1e-4, atol=1e-5)
    close(got.R, ref.R, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode,init", [("batched", "random"),
                                       ("batched", "nndsvd"),
                                       ("loop", "random")])
def test_dense_ensemble_matches_repro(mode, init):
    import jax.numpy as jnp
    from repro.selection import run_ensemble as j_run_ensemble
    X = planted_dense()
    jc = jcfg(init=init, k_min=3, k_max=3)
    ref = j_run_ensemble(jnp.asarray(X), 3, jc, mode=mode)
    got = run_ensemble(t(X), 3, tcfg(init=init, k_min=3, k_max=3),
                       repro_draws(jc, X), mode=mode)
    members_close(got, ref)
    fused = run_ensemble(t(X), 3, tcfg(init=init, k_min=3, k_max=3,
                                       kernel=FUSED),
                         repro_draws(jc, X), mode=mode)
    members_close(fused, ref)


def test_bcsr_loop_ensemble_matches_repro():
    from repro.selection import run_ensemble as j_run_ensemble
    jsp_x = planted_bcsr()
    jc = jcfg(k_min=2, k_max=2)
    ref = j_run_ensemble(jsp_x, 2, jc, mode="loop")
    for policy in (KernelPolicy(), FUSED):
        got = run_ensemble(convert.bcsr(jsp_x, device="cpu"), 2,
                           tcfg(k_min=2, k_max=2, kernel=policy),
                           repro_draws(jc, jsp_x), mode="loop")
        members_close(got, ref)


@pytest.mark.parametrize("operand", ["dense", "bcsr"])
def test_cross_k_grid_matches_repro_and_batched_members(operand):
    """run_sweep_batched on a mixed-rank chunk against repro's, and each
    row cropped to its k against the per-k batched members (1e-5: the
    same numbers, only extra exact-zero terms)."""
    import jax.numpy as jnp
    from repro.selection.ensemble import run_sweep_batched as j_sweep
    if operand == "dense":
        jx = planted_dense()
        X = t(jx)
        jx = jnp.asarray(jx)
    else:
        jx = planted_bcsr()
        X = convert.bcsr(jx, device="cpu")
    jc = jcfg()
    draws = repro_draws(jc, jx if operand == "bcsr" else np.asarray(jx))
    cells = [(2, 1), (3, 0), (4, 3), (4, 0)]
    ref = j_sweep(jx, cells, jc)
    got = run_sweep_batched(X, cells, tcfg(kernel=FUSED), draws)
    members_close(got, ref)
    assert not got.A[0, :, 2:].any() and not got.R[1, :, 3:, :].any()
    for row, (k, q) in enumerate(cells):
        one = run_ensemble(X, k, tcfg(), draws, members=(q,))
        close(got.A[row, :, :k], convert.to_numpy(one.A[0]), rtol=1e-5,
              atol=1e-7)
        close(got.errors[row], convert.to_numpy(one.errors[0]), rtol=1e-5)


def test_grid_init_pads_the_reference_draws():
    X = planted_dense()
    jc = jcfg()
    draws = repro_draws(jc, X)
    cells = [(2, 0), (4, 1)]
    out = torch.empty((2,) + X.shape)
    from repro_torch.selection import grid_init
    mask, st = grid_init(cells, t(X), 4, tcfg(), draws, out)
    assert mask.tolist() == [[1, 1, 0, 0], [1, 1, 1, 1]]
    noise, A0, R0 = draws.members[(2, 0)]
    close(out[0], noise, rtol=0)
    close(st.A[0, :, :2], A0, rtol=0)
    assert not st.A[0, :, 2:].any() and not st.R[0, :, 2:].any()


# ---------------------------------------------------------------------------
# The sweep scheduler against repro's, in every mode
# ---------------------------------------------------------------------------

MODES = [("batched", None), ("loop", None), ("grid", 1), ("grid", None),
         ("grid", 5)]


@pytest.fixture(scope="module")
def repro_sweeps():
    """repro's dense sweep in each mode, with its plan."""
    import jax.numpy as jnp
    from repro.selection import SweepScheduler as JScheduler
    X = planted_dense()
    out = {}
    for mode, chunk in MODES:
        sched = JScheduler(jcfg(), mode=mode, grid_chunk=chunk)
        res = sched.run(jnp.asarray(X))
        out[(mode, chunk)] = (res, [u.uid for u in sched.units],
                              sched.report.mode)
    return X, out


@pytest.mark.parametrize("mode,chunk", MODES)
def test_sweep_modes_match_repro(repro_sweeps, mode, chunk):
    X, refs = repro_sweeps
    ref, uids, ref_mode = refs[(mode, chunk)]
    sched = SweepScheduler(tcfg(kernel=FUSED), mode=mode, grid_chunk=chunk,
                           draws=repro_draws(jcfg(), X))
    got = sched.run(t(X))
    assert [u.uid for u in sched.units] == uids
    assert [r.uid for r in sched.report.units] == uids
    assert sched.report.mode == ref_mode == mode
    assert got.k_opt == ref.k_opt
    for name in ("s_min", "s_mean", "rel_err"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=1e-4, atol=1e-4)
    for k in got.ks:
        np.testing.assert_allclose(got.per_k[k].member_errors,
                                   ref.per_k[k].member_errors, rtol=1e-3)


def test_plan_sweep_matches_repro():
    from repro.selection.scheduler import plan_sweep as j_plan
    cfg, jc = tcfg(n_perturbations=3), jcfg(n_perturbations=3)
    for mode, chunk in MODES + [("grid", 4), ("grid", 100)]:
        got = plan_sweep(cfg, mode=mode, grid_chunk=chunk)
        ref = j_plan(jc, mode=mode, grid_chunk=chunk)
        assert [u.uid for u in got] == [u.uid for u in ref]
        if mode == "grid":
            assert [convert.grid_chunk(u) for u in ref] == got
    with pytest.raises(ValueError, match="grid_chunk only applies"):
        plan_sweep(cfg, mode="loop", grid_chunk=2)
    with pytest.raises(ValueError, match="must be positive"):
        plan_sweep(cfg, mode="grid", grid_chunk=0)
    with pytest.raises(ValueError, match="unknown sweep mode"):
        plan_sweep(cfg, mode="mesh")
    assert isinstance(plan_sweep(cfg, mode="grid")[0], GridChunk)


def test_nndsvd_refusals_match_repro():
    """NNDSVD on a BCSR operand and in the cross-k grid raise
    NotImplementedError, in both packages."""
    from repro.selection import SweepScheduler as JScheduler
    from repro.selection import run_ensemble as j_run_ensemble
    jsp_x = planted_bcsr()
    sp = convert.bcsr(jsp_x, device="cpu")
    with pytest.raises(NotImplementedError, match="BCSR ensembles"):
        j_run_ensemble(jsp_x, 2, jcfg(init="nndsvd"))
    with pytest.raises(NotImplementedError, match="BCSR ensembles"):
        run_ensemble(sp, 2, tcfg(init="nndsvd"), TorchDraws(0, "cpu"))
    with pytest.raises(NotImplementedError, match="mode='grid'"):
        JScheduler(jcfg(init="nndsvd"), mode="grid")
    with pytest.raises(NotImplementedError, match="mode='grid'"):
        SweepScheduler(tcfg(init="nndsvd"), mode="grid")
    with pytest.raises(NotImplementedError, match="cross-k grid"):
        run_sweep_batched(t(planted_dense()), [(2, 0)], tcfg(init="nndsvd"),
                          TorchDraws(0, "cpu"))
    with pytest.raises(ValueError, match="init must be one of"):
        tcfg(init="svd")


def test_dense_manifest_matches_repro():
    import jax.numpy as jnp
    from repro.io.manifest import manifest_of as j_manifest
    X = planted_dense()
    ref = j_manifest(jnp.asarray(X)).fingerprint()
    got = manifest_of(t(X)).fingerprint()
    for key in ("kind", "m", "n", "n_factor", "dtype", "logical_bytes",
                "resident_bytes", "block_size", "grid", "nnzb"):
        assert got[key] == ref[key], key
    np.testing.assert_allclose(
        [float(v) for v in got["digest"].split("/")],
        [float(v) for v in ref["digest"].split("/")], rtol=1e-5)
    # a symmetric permutation of the entities shifts the digest
    perm = np.random.default_rng(0).permutation(N)
    other = manifest_of(t(X[:, perm][:, :, perm])).digest
    assert other != got["digest"]


# ---------------------------------------------------------------------------
# Single device against the 1 x 1 grid, with the port's own draws
# ---------------------------------------------------------------------------

def cell_grid_sweep(grid, X) -> dict:
    res = rescalk(torch.from_numpy(X), tcfg(kernel=FUSED), grid=grid,
                  draws=TorchDraws(SWEEP["seed"], "cpu"))
    return {"k_opt": res.k_opt, "s_min": res.s_min, "s_mean": res.s_mean,
            "rel_err": res.rel_err,
            "member_errors": {k: r.member_errors
                              for k, r in res.per_k.items()}}


def test_single_device_sweep_equals_the_1x1_grid_sweep(tmp_path):
    """TorchDraws draws a dense member as the 1 x 1 grid's one cell, so
    the single-device sweep and rescalk(X, cfg, grid=1 x 1 gloo) compute
    on the same numbers: per-k values and member errors within 1e-5.
    The member errors are held absolutely: the error identity cancels
    (ROADMAP "Reference caveats"), and the two paths normalize A with
    sums in another order."""
    X = planted_dense()
    ref = spawn_grid(cell_grid_sweep, tmp_path, data=1, model=1,
                     args=(X,))[0]
    got = rescalk(t(X), tcfg(kernel=FUSED))
    assert got.k_opt == ref["k_opt"]
    for name in ("s_min", "s_mean", "rel_err"):
        np.testing.assert_allclose(getattr(got, name), ref[name],
                                   rtol=1e-5, atol=1e-5)
    for k in got.ks:
        np.testing.assert_allclose(got.per_k[k].member_errors,
                                   ref["member_errors"][k], rtol=0,
                                   atol=1e-5)


def test_torch_draws_dense_member_is_the_grid_cell():
    from repro_torch.dist.sharding import Grid
    X = t(planted_dense())
    d = TorchDraws(5, "cpu")
    out = torch.empty_like(X)
    noise, A0, R0 = d.member(3, 2, X, 0.02, out=out)
    assert noise is out
    cell = torch.empty_like(X)
    A1, R1 = d.grid_member(3, 2, Grid.at_rank(0, 1, 1, 1, "cpu"), cell,
                           0.02)
    assert torch.equal(out, cell) and torch.equal(A0, A1) \
        and torch.equal(R0, R1)
    fresh, A2, _ = d.member(3, 2, X, 0.02)
    assert torch.equal(fresh, out) and torch.equal(A2, A0)
    assert float(out.min()) >= 0.98 and float(out.max()) <= 1.02
    assert not torch.equal(d.member(3, 1, X, 0.02)[0], out)


# ---------------------------------------------------------------------------
# The CLI's default path
# ---------------------------------------------------------------------------

CLI_BASE = ["--device", "cpu", "--n", "64", "--m", "4", "--k-true", "3",
            "--k-min", "2", "--k-max", "4"]
CLI_RUNS = [(), ("--mode", "loop"), ("--mode", "grid", "--grid-chunk", "2"),
            ("--mode", "grid"), ("--schedule", "sliced"),
            ("--init", "nndsvd"), ("--use-fused-kernel",),
            ("--init", "nndsvd", "--mode", "loop", "--use-fused-kernel")]


@pytest.fixture(scope="module")
def cli_default(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    res, rep = rescalk_run.main(CLI_BASE + ["--report", str(tmp / "r.json")])
    return res, rep, tmp


@pytest.mark.parametrize("extra", CLI_RUNS, ids=" ".join)
def test_cli_default_path_runs_without_data(cli_default, tmp_path, capsys,
                                            extra):
    base, _, _ = cli_default
    capsys.readouterr()
    report = tmp_path / "r.json"
    res, rep = rescalk_run.main(CLI_BASE + list(extra)
                                + ["--report", str(report)])
    out = capsys.readouterr().out
    mode = extra[extra.index("--mode") + 1] if "--mode" in extra \
        else "batched"
    assert f"mode={mode}" in out and out.count("[sweep] k=") == 3
    assert f"selected k_opt = {res.k_opt} (planted 3)" in out
    assert res.k_opt == 3 == base.k_opt
    assert "feature correlation vs ground truth: min=" in out
    saved = json.loads(report.read_text())
    assert saved["mode"] == rep.mode == mode
    assert saved["meta"]["bundle"] == str(tmp_path / "r.bundle")
    from repro_torch.serve import FactorBundle
    bundle = FactorBundle.load(str(tmp_path / "r.bundle"))
    assert bundle.manifest["kind"] == "dense" and bundle.k == 3
    assert bundle.manifest["n"] == 64 and bundle.manifest["m"] == 4
    if extra in ((), ("--use-fused-kernel",), ("--mode", "grid")):
        np.testing.assert_allclose(res.rel_err, base.rel_err, rtol=1e-5,
                                   atol=1e-6)


def test_cli_refusals():
    with pytest.raises(SystemExit, match="--grid-chunk requires --mode grid"):
        rescalk_run.main(CLI_BASE + ["--grid-chunk", "2"])
    with pytest.raises(NotImplementedError, match="mode='grid'"):
        rescalk_run.main(CLI_BASE + ["--mode", "grid", "--init", "nndsvd"])


def test_cli_refuses_nndsvd_on_bcsr(tmp_path):
    rng = np.random.default_rng(0)
    row, col = rng.integers(0, 50, 300), rng.integers(0, 50, 300)
    np.savez(tmp_path / "x.npz", row=row, col=col,
             rel=rng.integers(0, 2, 300),
             val=rng.uniform(0.5, 1.0, 300).astype(np.float32))
    with pytest.raises(NotImplementedError, match="BCSR ensembles"):
        rescalk_run.main(["--device", "cpu", "--data",
                          str(tmp_path / "x.npz"), "--bs", "16",
                          "--k-min", "2", "--k-max", "2", "--iters", "2",
                          "--init", "nndsvd"])


def test_cli_flags_match_repro_defaults():
    from repro.launch.rescalk_run import build_parser as repro_parser
    theirs = {a.dest: a for a in repro_parser()._actions}
    mine = {a.dest: a for a in rescalk_run.build_parser()._actions}
    for dest in ("n", "m", "k_true", "data", "schedule", "init", "mode",
                 "grid_chunk"):
        assert mine[dest].default == theirs[dest].default, dest
        assert mine[dest].choices == theirs[dest].choices or \
            tuple(mine[dest].choices) == tuple(theirs[dest].choices), dest


def test_report_of_a_grid_sweep_is_read_by_repro(tmp_path):
    from repro.selection.report import SelectionReport as JReport
    sched = SweepScheduler(tcfg(rescal_iters=5, regress_iters=5),
                           mode="grid", grid_chunk=5,
                           report_path=str(tmp_path / "r.json"),
                           draws=TorchDraws(0, "cpu"))
    sched.run(t(planted_dense()))
    back = JReport.load(str(tmp_path / "r.json"))
    assert back.mode == "grid" and len(back.units) == 3
    assert back.units[0].k == -1 and back.units[0].cells[0] == [2, 0]
    assert dataclasses.asdict(sched.report.units[0])["cells"] == \
        back.units[0].cells
