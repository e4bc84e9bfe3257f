"""The port's distributed dense engine on CPU gloo grids against repro.

Each grid shape is spawned once per module (``launch.mesh.spawn_grid``):
1 x 1 (one process), 2 x 2 (four) and 2 x (2 x 2) (eight, two pods).  The
cells compute with the port on numpy inputs made here and hand back
numpy; ``repro``'s references are computed in the pytest process.  The
workers import this module to find their functions, so ``jax`` and
``repro`` are imported inside the tests only, never at the top.

Tolerances: one MU iteration against repro at rtol 1e-5 (fp32 sums in
another order); 30 iterations at rtol 5e-4 / atol 1e-5, repro's own
mesh-vs-host tolerance (tests/test_multidevice.py); errors at rtol 1e-4;
sweep curves within 1e-4 per k.
"""
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core.rescal import RescalState
from repro_torch.core.rescalk import rescalk
from repro_torch.dist.engine import (DistRescalConfig, dist_rescal,
                                     make_mu_step)
from repro_torch.dist.sharding import COL_AXIS, POD_AXIS, ROW_AXIS, Grid
from repro_torch.kernels import ops
from repro_torch.kernels.policy import KernelPolicy
from repro_torch.launch.mesh import make_grid, spawn_grid
from repro_torch.selection import ArrayDraws, RescalkConfig, run_grid_ensemble

N, M, K = 12, 3, 3                 # the engine problem: 2 x 2 blocks of 6
ITERS = (1, 30)
VARIANTS = [(s, f) for s in ("batched", "sliced") for f in (True, False)]
SWEEP = dict(k_min=2, k_max=4, n_perturbations=4, rescal_iters=40,
             regress_iters=50, seed=3)
POD_CFG = dict(k_min=3, k_max=3, n_perturbations=4, rescal_iters=30,
               seed=5)
POD_RUNS = [("batched", True), ("sliced", False)]


def problem(seed=0, n=N, m=M, k=K):
    """A planted non-negative X = A R A^T * noise, and an init (A0, R0)."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.05, 1.0, (n, k))
    R = rng.uniform(0.05, 1.0, (m, k, k))
    X = np.einsum("ia,mab,jb->mij", A, R, A) * rng.uniform(0.95, 1.05,
                                                          (m, n, n))
    A0 = rng.uniform(0.05, 1.0, (n, k))
    R0 = rng.uniform(0.05, 1.0, (m, k, k))
    return tuple(x.astype(np.float32) for x in (X, A0, R0))


def dcfg(schedule, fused, **kw):
    return DistRescalConfig(schedule=schedule,
                            kernel=KernelPolicy(use_fused=fused), **kw)


# ---------------------------------------------------------------------------
# What the cells run (imported by the spawned workers)
# ---------------------------------------------------------------------------

def cell_collectives(grid: Grid) -> dict:
    """Every collective on an input that depends on the rank."""
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) * (grid.rank + 1)
    out = {"cell": (grid.pod, grid.i, grid.j), "x": x.numpy()}
    for axis in (ROW_AXIS, COL_AXIS, POD_AXIS):
        out[f"psum_{axis}"] = grid.psum(x, axis).numpy()
        out[f"gather_{axis}"] = grid.all_gather(x, axis, dim=0).numpy()
    out["bf16"] = grid.psum_cast(x + 0.1, ROW_AXIS, "bfloat16").numpy()
    out["row_to_col"] = grid.diag_row_to_col(x).numpy()
    out["col_to_row"] = grid.diag_col_to_row(x).numpy()
    out["unchanged"] = bool(torch.equal(
        x, torch.arange(6, dtype=torch.float32).reshape(2, 3)
        * (grid.rank + 1)))
    out["count"] = grid.collectives
    out["jax_free"] = not any(
        name in ("jax", "repro") or name.startswith(("jax.", "repro."))
        for name in sys.modules)
    return out


def cell_engine(grid: Grid, X, A0, R0) -> dict:
    """make_mu_step for every (schedule, fused) variant and iteration
    count, and dist_rescal's error, on this cell's blocks."""
    blk = convert.grid_blocks(grid, X=X, A=A0, R=R0, device="cpu")
    out = {}
    c0 = grid.collectives
    for schedule, fused in VARIANTS:
        for iters in ITERS:
            step = make_mu_step(grid, dcfg(schedule, fused), iters=iters)
            Ai, R = step(blk["X"], blk["A"], blk["R"])
            out[(schedule, fused, iters)] = (Ai.numpy(), R.numpy())
    st, err = dist_rescal(blk["X"], K, grid,
                          init=RescalState(A=torch.from_numpy(A0),
                                           R=torch.from_numpy(R0), step=0),
                          iters=30, cfg=dcfg("batched", True))
    out["dist_rescal"] = (st.A.numpy(), st.R.numpy(), float(err))
    out["collectives"] = grid.collectives - c0
    return out


def cell_bf16(grid: Grid, X, A0, R0) -> dict:
    blk = convert.grid_blocks(grid, X=X, A=A0, R=R0, device="cpu")
    out = {}
    for iters in ITERS:
        step = make_mu_step(grid, dcfg("batched", True,
                                       comm_dtype="bfloat16"), iters=iters)
        Ai, R = step(blk["X"], blk["A"], blk["R"])
        out[iters] = (Ai.numpy(), R.numpy())
    return out


def cell_hooks(grid: Grid, X, A0, R0) -> dict:
    """The engine's sanitize and trace_metrics hooks: a negative factor
    raises under sanitize; trace_metrics records one entry per
    iteration."""
    from repro_torch.analysis.sanitizer import FactorSanitizerError
    from repro_torch.obs.metrics import MetricsBuffer, install_buffer
    blk = convert.grid_blocks(grid, X=X, A=A0, R=R0, device="cpu")
    out = {}
    for schedule in ("batched", "sliced"):
        bad = blk["A"].clone()
        bad[0, 0] = -1.0
        try:
            make_mu_step(grid, dcfg(schedule, True, sanitize=True))(
                blk["X"], bad, blk["R"])
        except FactorSanitizerError as e:
            out[("sanitize", schedule)] = str(e)
        buf = MetricsBuffer()
        prev = install_buffer(buf)
        try:
            make_mu_step(grid, dcfg(schedule, True, trace_metrics=True),
                         iters=3)(blk["X"], blk["A"], blk["R"])
        finally:
            install_buffer(prev)
        out[("trace", schedule)] = [tag for _, tag, _ in buf.records]
    return out


def cell_sweep(grid: Grid, X, members, regress) -> dict:
    draws = ArrayDraws(members, regress, device="cpu")
    ops.reset_launch_counts()
    res = rescalk(convert.grid_blocks(grid, X=X, device="cpu")["X"],
                  RescalkConfig(kernel=KernelPolicy(use_fused=True),
                                **SWEEP), grid=grid, draws=draws)
    return {"k_opt": res.k_opt, "s_min": res.s_min, "s_mean": res.s_mean,
            "rel_err": res.rel_err, "launches": ops.launch_counts(),
            "member_errors": {k: r.member_errors
                              for k, r in res.per_k.items()}}


def cell_pods(grid: Grid, X, A0s, R0s, members, regress) -> dict:
    """The pod make_mu_step (members split over pods, X shared) and the
    pod ensemble, on this cell."""
    out = {"members": list(grid.pod_members(len(A0s)))}
    Xl = convert.grid_blocks(grid, X=X, device="cpu")["X"]
    mine = out["members"]
    Ai = grid.row_block(torch.from_numpy(A0s[mine]))
    R = torch.from_numpy(R0s[mine])
    for schedule, fused in VARIANTS:
        Aq, Rq = make_mu_step(grid, dcfg(schedule, fused), iters=30)(
            Xl, Ai, R)
        out[("step", schedule, fused)] = (Aq.numpy(), Rq.numpy())
    draws = ArrayDraws(members, regress, device="cpu")
    for schedule, fused in POD_RUNS:
        cfg = RescalkConfig(schedule=schedule,
                            kernel=KernelPolicy(use_fused=fused), **POD_CFG)
        res = run_grid_ensemble(grid, Xl, POD_CFG["k_min"], cfg, draws)
        out[("ensemble", schedule)] = (res.A.numpy(), res.R.numpy(),
                                       res.errors.numpy())
    try:
        run_grid_ensemble(grid, Xl, 3, RescalkConfig(n_perturbations=3),
                          draws)
    except ValueError as e:
        out["refused_r"] = str(e)
    return out


# ---------------------------------------------------------------------------
# The spawned grids, once per module
# ---------------------------------------------------------------------------

def _grid_runs(tmp, shape, *jobs):
    """Spawn the grid once and run every (fn, args) job on it."""
    return spawn_grid(cell_jobs, tmp, args=(jobs,), **shape)


def cell_jobs(grid: Grid, jobs) -> list:
    return [fn(grid, *args) for fn, args in jobs]


def repro_member_draws(cfg, X, k, grid):
    """repro's draws for every member of rank k, as its mesh program makes
    them: (pkey, fkey) = split(member key); each block's noise from
    perturb_shard(pkey, ., q, i * gc + j) — built here on a block of ones,
    which is the noise itself — and init_factors(fkey)."""
    import jax
    import jax.numpy as jnp
    from repro.core.perturb import perturb_shard
    from repro.core.rescal import init_factors
    from repro.selection.ensemble import unit_keys
    m, n, _ = X.shape
    g = grid
    nb = n // g
    keys = unit_keys(cfg, k, tuple(range(cfg.n_perturbations)))
    out = {}
    for q in range(cfg.n_perturbations):
        pkey, fkey = jax.random.split(keys[q])
        noise = np.zeros((m, n, n), np.float32)
        for i in range(g):
            for j in range(g):
                noise[:, i * nb:(i + 1) * nb, j * nb:(j + 1) * nb] = \
                    perturb_shard(pkey, jnp.ones((m, nb, nb)), q, i * g + j,
                                  cfg.perturbation_delta)
        st = init_factors(fkey, n, m, k, dtype=jnp.float32)
        out[(k, q)] = (noise, np.asarray(st.A), np.asarray(st.R))
    return out


def repro_regress(ks, m):
    import jax
    return {k: np.asarray(jax.random.uniform(
        jax.random.PRNGKey(17), (m, k, k), minval=0.05, maxval=1.0))
        for k in ks}


def sweep_problem():
    X, _, _ = problem(seed=7, n=24, m=3, k=3)
    return X


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    X, A0, R0 = problem()
    Xs = sweep_problem()
    from repro.selection import RescalkConfig as JConfig
    jcfg = JConfig(**SWEEP)
    members = {}
    for k in jcfg.ks:
        members.update(repro_member_draws(jcfg, Xs, k, 1))
    regress = repro_regress(jcfg.ks, Xs.shape[0])
    res = _grid_runs(tmp_path_factory.mktemp("grid11"),
                     dict(data=1, model=1),
                     (cell_collectives, ()), (cell_engine, (X, A0, R0)),
                     (cell_bf16, (X, A0, R0)),
                     (cell_sweep, (Xs, members, regress)),
                     (cell_hooks, (X, A0, R0)))
    return dict(inputs=(X, A0, R0), sweep_X=Xs, jcfg=jcfg, cells=res)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    X, A0, R0 = problem()
    res = _grid_runs(tmp_path_factory.mktemp("grid22"),
                     dict(data=2, model=2),
                     (cell_collectives, ()), (cell_engine, (X, A0, R0)))
    return dict(inputs=(X, A0, R0), cells=res)


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    X, _, _ = problem(seed=1)
    rng = np.random.default_rng(2)
    r = POD_CFG["n_perturbations"]
    A0s = rng.uniform(0.05, 1.0, (r, N, K)).astype(np.float32)
    R0s = rng.uniform(0.05, 1.0, (r, M, K, K)).astype(np.float32)
    from repro.selection import RescalkConfig as JConfig
    jcfg = JConfig(**POD_CFG)
    members = repro_member_draws(jcfg, X, POD_CFG["k_min"], 2)
    res = _grid_runs(tmp_path_factory.mktemp("grid222"),
                     dict(pods=2, data=2, model=2),
                     (cell_collectives, ()),
                     (cell_pods, (X, A0s, R0s, members, {})))
    return dict(X=X, A0s=A0s, R0s=R0s, jcfg=jcfg, cells=res)


def job(fixture, index):
    """Per-rank results of one job."""
    return [cell[index] for cell in fixture["cells"]]


def assemble_A(cells, key, g):
    """The global A from the (pod 0) cells' row blocks: cell (i, 0)."""
    blocks = [cells[i * g][key][0] for i in range(g)]
    return np.concatenate(blocks, axis=-2)


# ---------------------------------------------------------------------------
# Collectives against their definition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["one", "two", "pods"])
def test_collectives_match_their_definition(shape, request):
    fx = request.getfixturevalue(shape)
    out = job(fx, 0)
    by_cell = {o["cell"]: o for o in out}
    pods_n = 1 + max(c[0] for c in by_cell)
    g = 1 + max(c[1] for c in by_cell)
    for (p, i, j), o in by_cell.items():
        col = [by_cell[(p, i, jj)]["x"] for jj in range(g)]
        row = [by_cell[(p, ii, j)]["x"] for ii in range(g)]
        pod = [by_cell[(pp, i, j)]["x"] for pp in range(pods_n)]
        np.testing.assert_array_equal(o[f"psum_{ROW_AXIS}"], sum(row))
        np.testing.assert_array_equal(o[f"psum_{COL_AXIS}"], sum(col))
        np.testing.assert_array_equal(o[f"psum_{POD_AXIS}"], sum(pod))
        np.testing.assert_array_equal(o[f"gather_{ROW_AXIS}"],
                                      np.concatenate(row))
        np.testing.assert_array_equal(o[f"gather_{COL_AXIS}"],
                                      np.concatenate(col))
        np.testing.assert_array_equal(o[f"gather_{POD_AXIS}"],
                                      np.concatenate(pod))
        # diagonal broadcasts: block j from cell (j, j); block i from (i, i)
        np.testing.assert_array_equal(o["row_to_col"],
                                      by_cell[(p, j, j)]["x"])
        np.testing.assert_array_equal(o["col_to_row"],
                                      by_cell[(p, i, i)]["x"])
        # the bf16 payload: each contribution rounded to bf16, the sum
        # within bf16 rounding of the f32 sum (gloo adds in bf16)
        want = sum(r + 0.1 for r in row)
        np.testing.assert_allclose(o["bf16"], want, rtol=2 ** -7)
        assert o["unchanged"]
        assert o["count"] == 9
        assert o["jax_free"]


# ---------------------------------------------------------------------------
# The engine on 2 x 2 against repro on one device
# ---------------------------------------------------------------------------

def repro_iters(X, A0, R0, schedule, iters):
    import jax.numpy as jnp
    from repro.core.rescal import RescalState as JState
    from repro.core.rescal import _run_iters
    st = _run_iters(jnp.asarray(X), JState(A=jnp.asarray(A0),
                                           R=jnp.asarray(R0),
                                           step=jnp.zeros((), jnp.int32)),
                    iters, schedule, 1e-16)
    return np.asarray(st.A), np.asarray(st.R)


def tol(iters):
    return dict(rtol=1e-5, atol=1e-7) if iters == 1 else \
        dict(rtol=5e-4, atol=1e-5)


@pytest.mark.parametrize("iters", ITERS)
@pytest.mark.parametrize("schedule,fused", VARIANTS)
def test_mu_step_2x2_matches_repro_single_device(two, schedule, fused,
                                                 iters):
    X, A0, R0 = two["inputs"]
    cells = job(two, 1)
    key = (schedule, fused, iters)
    A = assemble_A(cells, key, 2)
    refA, refR = repro_iters(X, A0, R0, schedule, iters)
    np.testing.assert_allclose(A, refA, **tol(iters))
    for c in cells:   # R is replicated: every cell holds the same
        np.testing.assert_allclose(c[key][1], refR, **tol(iters))
    # A^(i) is replicated over the columns j
    np.testing.assert_array_equal(cells[0][key][0], cells[1][key][0])


def test_dist_rescal_error_matches_repro_rel_error(two):
    import jax.numpy as jnp
    from repro.core.rescal import rel_error
    X = two["inputs"][0]
    cells = job(two, 1)
    A = assemble_A(cells, "dist_rescal", 2)
    R = cells[0]["dist_rescal"][1]
    ref = float(rel_error(jnp.asarray(X), jnp.asarray(A), jnp.asarray(R)))
    for c in cells:
        assert c["dist_rescal"][2] == pytest.approx(ref, rel=1e-4)
    assert 0.0 < ref < 0.2


def test_sliced_schedule_issues_more_collectives(two):
    """Every cell issues the same collectives, and the sliced schedule's
    per-slice ones make the count grow with m."""
    counts = {c["collectives"] for c in job(two, 1)}
    assert len(counts) == 1
    # per iteration: batched 6 (2 diagonal broadcasts, 4 psums), sliced
    # 2 + 4 per slice; the error 6 (4 + ||X||^2 over rows, then columns)
    per = {"batched": 6, "sliced": 2 + 4 * M}
    want = sum(per[s] * it for s, _ in VARIANTS for it in ITERS)
    want += 6 * 30 + 6              # dist_rescal: 30 MU + the error
    assert counts == {want}


# ---------------------------------------------------------------------------
# 1 x 1 against repro's own 1 x 1 mesh
# ---------------------------------------------------------------------------

def repro_mesh_step(X, A0, R0, schedule, iters, **kw):
    import jax.numpy as jnp
    from repro.dist.engine import DistRescalConfig as JCfg
    from repro.dist.engine import make_mu_step as j_step
    from repro.kernels.policy import KernelPolicy as JPolicy
    from repro.launch.mesh import make_debug_mesh
    step = j_step(make_debug_mesh(1, 1),
                  JCfg(schedule=schedule,
                       kernel=JPolicy(use_fused=True, impl="ref"), **kw),
                  iters=iters)
    A, R = step(jnp.asarray(X), jnp.asarray(A0), jnp.asarray(R0))
    return np.asarray(A), np.asarray(R)


@pytest.mark.parametrize("iters", ITERS)
@pytest.mark.parametrize("schedule", ["batched", "sliced"])
def test_mu_step_1x1_matches_repro_mesh(one, schedule, iters):
    X, A0, R0 = one["inputs"]
    got = job(one, 1)[0][(schedule, True, iters)]
    ref = repro_mesh_step(X, A0, R0, schedule, iters)
    np.testing.assert_allclose(got[0], ref[0], **tol(iters))
    np.testing.assert_allclose(got[1], ref[1], **tol(iters))


@pytest.mark.parametrize("iters", ITERS)
def test_bf16_comm_1x1_matches_repro_mesh(one, iters):
    """comm_dtype='bfloat16' rounds every collective's payload to bf16
    (8 bits of mantissa) in both packages.  One iteration: both round the
    same fp32 values, which agree to ~1e-7, so a payload lands on another
    bf16 value only when it sits on a rounding boundary — at most one
    bf16 ulp (2^-8 relative), which the update passes on at most halved:
    rtol 4e-3.  30 iterations compound such flips: rtol 2e-2."""
    X, A0, R0 = one["inputs"]
    got = job(one, 2)[0][iters]
    ref = repro_mesh_step(X, A0, R0, "batched", iters,
                          comm_dtype="bfloat16")
    rtol = 4e-3 if iters == 1 else 2e-2
    np.testing.assert_allclose(got[0], ref[0], rtol=rtol, atol=1e-6)
    np.testing.assert_allclose(got[1], ref[1], rtol=rtol, atol=1e-6)
    # and bf16 is not a no-op: the fp32 engine differs
    f32 = job(one, 1)[0][("batched", True, iters)]
    assert not np.array_equal(got[0], f32[0])


def test_sweep_1x1_matches_repro_mesh_sweep(one):
    """The whole slice on a 1 x 1 grid against repro's
    SweepScheduler(mesh=1 x 1) on the same draws: the same k_opt, per-k
    s_min / s_mean / rel_err within 1e-4; the plain fused_xa_xtb on CPU
    tensors launches nothing."""
    import jax.numpy as jnp
    from repro.kernels.policy import KernelPolicy as JPolicy
    from repro.launch.mesh import make_debug_mesh
    from repro.selection import RescalkConfig as JConfig
    from repro.selection import SweepScheduler as JScheduler
    jcfg = JConfig(kernel=JPolicy(use_fused=True, impl="ref"), **SWEEP)
    ref = JScheduler(jcfg, mesh=make_debug_mesh(1, 1)).run(
        jnp.asarray(one["sweep_X"]))
    got = job(one, 3)[0]
    assert got["k_opt"] == ref.k_opt
    for name in ("s_min", "s_mean", "rel_err"):
        np.testing.assert_allclose(got[name], getattr(ref, name),
                                   rtol=1e-4, atol=1e-4)
    for k in jcfg.ks:
        np.testing.assert_allclose(got["member_errors"][k],
                                   ref.per_k[k].member_errors, rtol=1e-3)
    assert not any(got["launches"].values())


@pytest.mark.parametrize("schedule", ["batched", "sliced"])
def test_engine_sanitize_and_trace_hooks(one, schedule):
    got = job(one, 4)[0]
    assert f"dist.engine._mu_iter_{schedule}" in got[("sanitize", schedule)]
    assert "negative" in got[("sanitize", schedule)]
    assert got[("trace", schedule)] == [
        f"dist.engine._mu_iter_{schedule}"] * 3


# ---------------------------------------------------------------------------
# Pods: 2 x (2 x 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule,fused", VARIANTS)
def test_pod_mu_step_matches_repro_per_member(pods, schedule, fused):
    """Members split over the pods, X replicated: each member's factors
    equal repro's single-device MU from the same init."""
    cells = job(pods, 1)
    for pod in range(2):
        pc = cells[pod * 4:(pod + 1) * 4]
        A = np.concatenate([pc[0][("step", schedule, fused)][0],
                            pc[2][("step", schedule, fused)][0]], axis=-2)
        R = pc[0][("step", schedule, fused)][1]
        for slot, q in enumerate(pc[0]["members"]):
            refA, refR = repro_iters(pods["X"], pods["A0s"][q],
                                     pods["R0s"][q], schedule, 30)
            np.testing.assert_allclose(A[slot], refA, rtol=5e-4, atol=1e-5)
            np.testing.assert_allclose(R[slot], refR, rtol=5e-4, atol=1e-5)


@pytest.mark.parametrize("schedule,fused", POD_RUNS)
def test_pod_ensemble_matches_repro_reference(pods, schedule, fused):
    """The grid ensemble on 2 x (2 x 2) against repro's
    run_ensemble_reference(grid=(2, 2)), whose blocked noise ArrayDraws
    hands to the port: errors, A and R at rtol 5e-4 / atol 1e-5."""
    import dataclasses

    import jax.numpy as jnp
    from repro.selection.ensemble import run_ensemble_reference
    jcfg = dataclasses.replace(pods["jcfg"], schedule=schedule)
    ref = run_ensemble_reference(jnp.asarray(pods["X"]), POD_CFG["k_min"],
                                 jcfg, grid=(2, 2))
    cells = job(pods, 1)
    for pod in range(2):
        pc = cells[pod * 4:(pod + 1) * 4]
        key = ("ensemble", schedule)
        A = np.concatenate([pc[0][key][0], pc[2][key][0]], axis=-2)
        qs = pc[0]["members"]
        np.testing.assert_allclose(A, np.asarray(ref.A)[qs], rtol=5e-4,
                                   atol=1e-5)
        for c in pc:
            np.testing.assert_allclose(c[key][1], np.asarray(ref.R)[qs],
                                       rtol=5e-4, atol=1e-5)
            np.testing.assert_allclose(c[key][2],
                                       np.asarray(ref.errors)[qs],
                                       rtol=5e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

def test_refuses_a_non_square_grid(tmp_path):
    with pytest.raises(ValueError, match="square"):
        make_grid(data=2, model=1, device="cpu")
    with pytest.raises(ValueError, match="square"):
        spawn_grid(cell_collectives, tmp_path, data=1, model=2)
    with pytest.raises(ValueError, match="square"):
        Grid.at_rank(0, 1, 2, 3, "cpu")


def test_refuses_n_not_dividing_the_grid():
    grid = Grid.at_rank(3, 1, 2, 2, "cpu")
    X, A0, R0 = problem(n=13)
    with pytest.raises(ValueError, match="divide"):
        convert.grid_blocks(grid, X=X, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        convert.grid_blocks(grid, A=A0, device="cpu")
    blk = convert.grid_blocks(grid, X=problem()[0], A=problem()[1],
                              device="cpu")
    assert tuple(blk["X"].shape) == (M, N // 2, N // 2)
    np.testing.assert_array_equal(blk["A"].numpy(),
                                  problem()[1][N // 2:])
    noise = np.random.default_rng(0).random((M, N, N), dtype=np.float32)
    np.testing.assert_array_equal(
        convert.grid_blocks(grid, noise=noise, device="cpu")["noise"],
        noise[:, N // 2:, N // 2:])


def test_refuses_members_not_dividing_the_pods(pods):
    assert "not divisible by pods=2" in job(pods, 1)[0]["refused_r"]
    with pytest.raises(ValueError, match="divisible"):
        Grid.at_rank(0, 2, 1, 1, "cpu").pod_members(5)
    assert list(Grid.at_rank(5, 2, 2, 2, "cpu").pod_members(4)) == [2, 3]


# ---------------------------------------------------------------------------
# Single-process pieces of the slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["batched", "sliced"])
def test_core_schedules_match_repro(schedule):
    """core.rescal's MU_SCHEDULES — the single-process reference of the
    engine's schedules — one step against repro's at rtol 1e-5, on one
    factorization and on a member stack."""
    import jax.numpy as jnp
    from repro.core.rescal import MU_SCHEDULES as J_SCHEDULES
    from repro.core.rescal import RescalState as JState
    from repro_torch.core.rescal import MU_SCHEDULES
    X, A0, R0 = problem(seed=4)
    ref = J_SCHEDULES[schedule](
        jnp.asarray(X), JState(A=jnp.asarray(A0), R=jnp.asarray(R0),
                               step=jnp.zeros((), jnp.int32)))
    got = MU_SCHEDULES[schedule](
        torch.from_numpy(X), RescalState(A=torch.from_numpy(A0),
                                         R=torch.from_numpy(R0), step=0))
    np.testing.assert_allclose(got.A.numpy(), ref.A, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.R.numpy(), ref.R, rtol=1e-5, atol=1e-7)
    stack = MU_SCHEDULES[schedule](
        torch.from_numpy(np.stack([X, X])),
        RescalState(A=torch.from_numpy(np.stack([A0, A0])),
                    R=torch.from_numpy(np.stack([R0, R0])), step=0))
    np.testing.assert_allclose(stack.A[1].numpy(), ref.A, rtol=1e-5,
                               atol=1e-7)


def test_rescal_sliced_matches_repro_rescal():
    import jax.numpy as jnp
    from repro.core.rescal import RescalState as JState
    from repro.core.rescal import rescal as j_rescal
    from repro_torch.core.rescal import rescal
    X, A0, R0 = problem(seed=6)
    ref, ref_err = j_rescal(jnp.asarray(X), K, iters=25, schedule="sliced",
                            init=JState(A=jnp.asarray(A0),
                                        R=jnp.asarray(R0),
                                        step=jnp.zeros((), jnp.int32)))
    got, err = rescal(torch.from_numpy(X), K, iters=25, schedule="sliced",
                      init=RescalState(A=torch.from_numpy(A0),
                                       R=torch.from_numpy(R0), step=0))
    np.testing.assert_allclose(got.A.numpy(), ref.A, rtol=5e-4, atol=1e-5)
    assert float(err) == pytest.approx(float(ref_err), rel=1e-4)


def test_synthetic_rescal_follows_repros_recipe():
    """Torch draws cannot equal jax.random's, so the recipe is checked:
    A the Gaussian bumps plus the floor, R >= 0, X = A R A^T within the
    noise band, the same tensors from the same seed, others from
    another."""
    from repro_torch.data.synthetic import gaussian_features, synthetic_rescal
    X, A, R = synthetic_rescal(40, 3, 4, seed=2, noise=0.01, device="cpu")
    assert tuple(X.shape) == (3, 40, 40) and tuple(A.shape) == (40, 4)
    assert tuple(R.shape) == (3, 4, 4) and bool((R >= 0).all())
    ratio = X / torch.einsum("ia,mab,jb->mij", A, R, A)
    assert float(ratio.min()) >= 0.99 - 1e-6
    assert float(ratio.max()) <= 1.01 + 1e-6
    assert float(A.min()) >= 0.01 - 1e-6 and float(A.max()) <= 1.01 + 1e-6
    # each column's bump peaks near its own quarter of the entity axis
    peaks = A.argmax(dim=0).numpy() / 39.0
    np.testing.assert_allclose(np.sort(peaks), (np.arange(4) + 0.5) / 4,
                               atol=0.1)
    again = synthetic_rescal(40, 3, 4, seed=2, noise=0.01, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip((X, A, R), again))
    assert not torch.equal(X, synthetic_rescal(40, 3, 4, seed=3,
                                               device="cpu")[0])
    g = torch.Generator()
    g.manual_seed(0)
    C = gaussian_features(64, 3, generator=g, correlated=True)
    assert tuple(C.shape) == (64, 3) and float(C.min()) >= 0.01 - 1e-6
