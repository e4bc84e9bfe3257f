"""The resilient sweep on the process grid against repro's mesh sweep.

``SweepScheduler(grid=...)`` runs what ``SweepScheduler(mesh=...)`` runs:
the cross-k grid program (``run_grid_sweep_batched``, repro's
``make_mesh_grid_ensemble``), per-unit checkpoints and their resume,
``n_pods`` units, and retries that every cell agrees on.  Each grid
shape is spawned once per module (``launch.mesh.spawn_grid``): 1 x 1 (one
process), 2 x 2 (four) and 2 x (2 x 2) (eight, two pods).  The cells
compute with the port on numpy inputs made here and return numpy;
``repro``'s references run in the pytest process, and ``jax`` and
``repro`` are imported inside the tests only (the workers import this
module, and ``test_torch_dist``'s problem builders, to find their
functions).

Tolerances: the 1 x 1 sweeps against repro's mesh sweeps at 1e-4 per k;
the grid program against the per-k grid ensemble and against repro's
blocked-noise references at repro's own (tests/multidevice_main.py:
dense rtol 5e-4 / atol 1e-5, BCSR rtol 2e-3 / atol 5e-5); resumed and
retried sweeps equal the uninterrupted one bit for bit.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.dist.sharding import Grid
from repro_torch.kernels import ops
from repro_torch.kernels.policy import KernelPolicy
from repro_torch.launch.mesh import spawn_grid
from repro_torch.resilience import (FaultPlan, FaultSpec, RetryPolicy,
                                    faults)
from repro_torch.selection import (ArrayDraws, RescalkConfig,
                                   SweepInterrupted, SweepScheduler,
                                   TorchDraws, gather_unit,
                                   run_grid_ensemble, run_grid_sweep_batched)
from test_torch_dist import (bcsr_problem, problem, repro_bcsr_draws,
                             repro_member_draws, repro_regress)

SWEEP = dict(k_min=2, k_max=3, n_perturbations=4, rescal_iters=30,
             regress_iters=30, seed=3)
CHUNK = 4                       # cells per chunk: 2 chunks of (k, q) cells
RESUME_RUNS = (("batched", None, 1), ("batched", None, 2),
               ("grid", CHUNK, 1))          # (mode, grid_chunk, n_pods)
FAULT_RANK = 3                  # the one cell a plan is installed on
RETRY = RetryPolicy(max_attempts=3, base_delay=0.001)


def sweep_X():
    return problem(seed=7, n=24, m=3, k=3)[0]


def cfg_of(**kw):
    return RescalkConfig(kernel=KernelPolicy(use_fused=True),
                         **{**SWEEP, **kw})


def chunks(cfg):
    cells = [(k, q) for k in cfg.ks for q in range(cfg.n_perturbations)]
    return [cells[c:c + CHUNK] for c in range(0, len(cells), CHUNK)]


def summary(res, sched) -> dict:
    rep = sched.report
    return {"k_opt": res.k_opt, "s_min": res.s_min, "s_mean": res.s_mean,
            "rel_err": res.rel_err,
            "A": {k: r.A_median for k, r in res.per_k.items()},
            "R": {k: r.R_regress for k, r in res.per_k.items()},
            "member_errors": {k: r.member_errors
                              for k, r in res.per_k.items()},
            "units": [(u.uid, u.k, u.members, u.cells, u.attempts,
                       u.retries, u.backoff_seconds, u.straggler,
                       u.kernel_fallbacks, u.reused) for u in rep.units],
            "meta": {k: rep.meta[k] for k in ("mesh", "n_retries",
                                               "n_kernel_fallbacks")},
            "collectives": rep.meta["collectives"]}


# ---------------------------------------------------------------------------
# What the cells run (imported by the spawned workers)
# ---------------------------------------------------------------------------

def cell_repro_sweeps(grid: Grid, X, members, regress, packed, bmembers,
                      bregress) -> dict:
    """Grid-mode sweeps on repro's draws: the dense block and the BCSR
    shard."""
    out = {}
    cfg = cfg_of()
    Xl = convert.grid_blocks(grid, X=X, device="cpu")["X"]
    cell = convert.sharded_bcsr(packed, device="cpu").cell(grid.i, grid.j)
    for name, operand, draws in (
            ("dense", Xl, ArrayDraws(members, regress, device="cpu")),
            ("bcsr", cell, ArrayDraws(bmembers, bregress, device="cpu"))):
        ops.reset_launch_counts()
        sched = SweepScheduler(cfg, mode="grid", grid_chunk=CHUNK,
                               grid=grid, draws=draws)
        out[name] = summary(sched.run(operand), sched)
        out[name]["launches"] = ops.launch_counts()
    return out


def cell_program(grid: Grid, X, members, packed, bmembers) -> dict:
    """The grid program's chunks and the per-k grid ensemble, gathered
    to their global arrays, on the dense block and on the BCSR shard."""
    cfg = cfg_of()
    Xl = convert.grid_blocks(grid, X=X, device="cpu")["X"]
    cell = convert.sharded_bcsr(packed, device="cpu").cell(grid.i, grid.j)
    out = {}
    for name, operand, draws in (
            ("dense", Xl, ArrayDraws(members, {}, device="cpu")),
            ("bcsr", cell, ArrayDraws(bmembers, {}, device="cpu"))):
        c0 = grid.collectives
        perk = {k: gather_unit(grid, run_grid_ensemble(grid, operand, k, cfg,
                                                       draws))
                for k in cfg.ks}
        per_iter_perk = grid.collectives - c0
        c0 = grid.collectives
        grid_rows = [gather_unit(grid, run_grid_sweep_batched(
            grid, operand, c, cfg, draws)) for c in chunks(cfg)]
        out[name] = {
            "perk": {k: tuple(x.numpy() for x in r) for k, r in perk.items()},
            "chunks": [tuple(x.numpy() for x in r) for r in grid_rows],
            "collectives": (per_iter_perk, grid.collectives - c0)}
    return out


def cell_resume(grid: Grid, X, root: str) -> dict:
    """Per k, n_pods = 2 and grid mode: an uninterrupted sweep, and one
    stopped after a unit and resumed from its checkpoints; and the first
    unit's global result computed apart, for the checkpoint's format."""
    Xl = convert.grid_blocks(grid, X=X, device="cpu")["X"]
    draws = TorchDraws(5, "cpu")
    cfg = cfg_of()
    out = {}
    for mode, chunk, pods in RESUME_RUNS:
        tag = f"{mode}_{pods}"
        ck = os.path.join(root, tag)
        kw = dict(mode=mode, grid_chunk=chunk, n_pods=pods, grid=grid,
                  draws=draws)
        sched = SweepScheduler(cfg, **kw)
        clean = summary(sched.run(Xl), sched)
        try:
            SweepScheduler(cfg, ckpt_dir=ck, stop_after_units=1,
                           **kw).run(Xl)
        except SweepInterrupted as e:
            stopped = (e.executed, e.completed, e.total)
        sched = SweepScheduler(cfg, ckpt_dir=ck, async_ckpt=True, **kw)
        resumed = summary(sched.run(Xl), sched)
        out[tag] = {"clean": clean, "resumed": resumed, "stopped": stopped,
                    "ckpt": ck, "reused": sched.report.n_reused}
    unit = SweepScheduler(cfg, grid=grid).units[0]
    first = gather_unit(grid, run_grid_ensemble(grid, Xl, unit.k, cfg, draws,
                                                members=unit.members))
    out["first_unit"] = (unit.uid, {k: v.numpy()
                                    for k, v in first._asdict().items()})
    return out


def cell_faults(grid: Grid, X) -> dict:
    """A transient sched/unit fault, then a deterministic one, each
    installed on one cell only."""
    Xl = convert.grid_blocks(grid, X=X, device="cpu")["X"]
    cfg = cfg_of()
    draws = TorchDraws(5, "cpu")
    sched = SweepScheduler(cfg, grid=grid, draws=draws, retry=RETRY)
    out = {"clean": summary(sched.run(Xl), sched)}
    mine = grid.rank == FAULT_RANK
    plan = FaultPlan({"sched/unit": [FaultSpec(kind="raise-transient",
                                               at=(1,))]} if mine else {})
    with faults.active(plan):
        sched = SweepScheduler(cfg, grid=grid, draws=draws, retry=RETRY)
        out["transient"] = summary(sched.run(Xl), sched)
    out["backoff"] = RETRY.backoff(2, sched.units[1].uid)
    plan = FaultPlan({"sched/unit": [FaultSpec(kind="raise-deterministic",
                                               at=(0,))]} if mine else {})
    with faults.active(plan):
        try:
            SweepScheduler(cfg, grid=grid, draws=draws, retry=RETRY).run(Xl)
            out["deterministic"] = None
        except Exception as e:  # the failure under test, on every cell
            out["deterministic"] = (type(e).__name__, str(e)[:200])
    out["deterministic_hits"] = dict(plan.hits)
    return out


def cell_other_grid(grid: Grid, X, ck: str) -> str | None:
    """A resume from a checkpoint directory another grid shape wrote."""
    Xl = convert.grid_blocks(grid, X=X, device="cpu")["X"]
    try:
        SweepScheduler(cfg_of(), grid=grid, draws=TorchDraws(5, "cpu"),
                       ckpt_dir=ck).run(Xl)
    except ValueError as e:
        return str(e)
    return None


def cell_jobs(grid: Grid, jobs) -> list:
    return [fn(grid, *args) for fn, args in jobs]


def _grid_runs(tmp, shape, *jobs):
    return spawn_grid(cell_jobs, tmp, args=(jobs,), **shape)


# ---------------------------------------------------------------------------
# The spawned grids, once per module
# ---------------------------------------------------------------------------

def repro_draws(g):
    """repro's draws for the dense and the BCSR problem on a g x g grid:
    the blocked noise of its mesh programs (make_mesh_ensemble,
    make_mesh_grid_ensemble), per (k, q), and the regression's R0."""
    from repro.selection import RescalkConfig as JConfig
    jcfg = JConfig(**SWEEP)
    X = sweep_X()
    bp = bcsr_problem(g)
    members, bmembers = {}, {}
    for k in jcfg.ks:
        members.update(repro_member_draws(jcfg, X, k, g))
        bmembers.update(repro_bcsr_draws(jcfg, bp["sharded"], k))
    return dict(X=X, bp=bp, jcfg=jcfg, members=members, bmembers=bmembers,
                regress=repro_regress(jcfg.ks, X.shape[0]),
                bregress=repro_regress(jcfg.ks, bp["sharded"].m))


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    d = repro_draws(1)
    res = _grid_runs(tmp_path_factory.mktemp("gs11"), dict(data=1, model=1),
                     (cell_repro_sweeps, (d["X"], d["members"],
                                          d["regress"], d["bp"]["packed"],
                                          d["bmembers"], d["bregress"])))
    return dict(d, cells=res)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    d = repro_draws(2)
    tmp = tmp_path_factory.mktemp("gs22")
    res = _grid_runs(tmp, dict(data=2, model=2),
                     (cell_program, (d["X"], d["members"], d["bp"]["packed"],
                                     d["bmembers"])),
                     (cell_resume, (d["X"], str(tmp / "ck"))))
    return dict(d, cells=res, ck=tmp / "ck")


@pytest.fixture(scope="module")
def pods(tmp_path_factory, two):
    d = repro_draws(2)
    tmp = tmp_path_factory.mktemp("gs222")
    res = _grid_runs(tmp, dict(pods=2, data=2, model=2),
                     (cell_program, (d["X"], d["members"], d["bp"]["packed"],
                                     d["bmembers"])),
                     (cell_resume, (d["X"], str(tmp / "ck"))),
                     (cell_faults, (d["X"],)),
                     (cell_other_grid, (d["X"],
                                        str(two["ck"] / "batched_1"))))
    return dict(d, cells=res)


def job(fixture, index):
    return [cell[index] for cell in fixture["cells"]]


# ---------------------------------------------------------------------------
# 1 x 1 against repro's 1 x 1 mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("operand", ["dense", "bcsr"])
def test_grid_mode_sweep_1x1_matches_repro_mesh(one, operand):
    """SweepScheduler(mode="grid", grid=1 x 1) against repro's
    SweepScheduler(mode="grid", mesh=1 x 1) on the same data and draws:
    the same k_opt, per-k values within 1e-4; CPU tensors launch no
    kernel."""
    import jax.numpy as jnp
    from repro.kernels.policy import KernelPolicy as JPolicy
    from repro.launch.mesh import make_debug_mesh
    from repro.selection import SweepScheduler as JScheduler
    jcfg = dataclasses.replace(one["jcfg"],
                               kernel=JPolicy(use_fused=True, impl="ref"))
    X = jnp.asarray(one["X"]) if operand == "dense" else \
        one["bp"]["sharded"]
    ref = JScheduler(jcfg, mode="grid", grid_chunk=CHUNK,
                     mesh=make_debug_mesh(1, 1)).run(X)
    got = job(one, 0)[0][operand]
    assert got["k_opt"] == ref.k_opt
    for name in ("s_min", "s_mean", "rel_err"):
        np.testing.assert_allclose(got[name], getattr(ref, name),
                                   rtol=1e-4, atol=1e-4)
    assert got["meta"]["mesh"] == {"pod": 1, "data": 1, "model": 1}
    assert [u[0] for u in got["units"]] == ["grid_k2q0-k2q3",
                                            "grid_k3q0-k3q3"]
    assert not any(got["launches"].values())


# ---------------------------------------------------------------------------
# The grid program on 2 x 2 and 2 x (2 x 2)
# ---------------------------------------------------------------------------

TOLS = {"dense": dict(rtol=5e-4, atol=1e-5), "bcsr": dict(rtol=2e-3,
                                                           atol=5e-5)}


@pytest.mark.parametrize("operand", ["dense", "bcsr"])
@pytest.mark.parametrize("shape", ["two", "pods"])
def test_grid_program_matches_per_k_grid_ensemble(shape, operand, request):
    """Each chunk's cell, cropped to its k, is the per-k grid ensemble's
    member: A, R and errors within repro's tolerances; the masked columns
    are exactly 0, and every cell holds the same gathered arrays."""
    fx = request.getfixturevalue(shape)
    cells = job(fx, 0)
    got = cells[0][operand]
    cfg = cfg_of()
    for rows, cell_list in zip(got["chunks"], chunks(cfg)):
        A, R, errs = rows
        for i, (k, q) in enumerate(cell_list):
            pA, pR, perr = (x[q] for x in got["perk"][k])
            np.testing.assert_allclose(A[i, :, :k], pA, **TOLS[operand])
            np.testing.assert_allclose(R[i, :, :k, :k], pR, **TOLS[operand])
            np.testing.assert_allclose(errs[i], perr, **TOLS[operand])
            assert not np.any(A[i, :, k:]) and not np.any(R[i, :, k:])
            assert not np.any(R[i, :, :, k:])
    for c in cells[1:]:
        for a, b in zip(c[operand]["chunks"], got["chunks"]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("operand", ["dense", "bcsr"])
@pytest.mark.parametrize("shape", ["two", "pods"])
def test_grid_program_matches_repro_references(shape, operand, request):
    """The chunks against repro's run_ensemble_reference(grid=(2, 2)) /
    run_ensemble_bcsr_sharded_reference, whose blocked noise ArrayDraws
    hands to the port, member for member."""
    import jax.numpy as jnp
    from repro.selection.ensemble import (run_ensemble_bcsr_sharded_reference,
                                          run_ensemble_reference)
    fx = request.getfixturevalue(shape)
    got = job(fx, 0)[0][operand]
    jcfg = fx["jcfg"]
    refs = {}
    for k in jcfg.ks:
        refs[k] = run_ensemble_reference(
            jnp.asarray(fx["X"]), k, jcfg, grid=(2, 2)) \
            if operand == "dense" else \
            run_ensemble_bcsr_sharded_reference(fx["bp"]["sharded"], k,
                                                jcfg)
    for rows, cell_list in zip(got["chunks"], chunks(cfg_of())):
        A, R, errs = rows
        for i, (k, q) in enumerate(cell_list):
            np.testing.assert_allclose(A[i, :, :k], np.asarray(refs[k].A)[q],
                                       **TOLS[operand])
            np.testing.assert_allclose(R[i, :, :k, :k],
                                       np.asarray(refs[k].R)[q],
                                       **TOLS[operand])
            np.testing.assert_allclose(errs[i],
                                       np.asarray(refs[k].errors)[q],
                                       **TOLS[operand])


@pytest.mark.parametrize("shape", ["two", "pods"])
def test_grid_program_issues_the_per_k_collectives(shape, request):
    """Per MU iteration the grid program issues the per-k ensemble's
    collectives (6 on the batched schedule): one chunk of the ks' cells
    costs what one rank's ensemble costs, with no agreement inside."""
    fx = request.getfixturevalue(shape)
    cfg = cfg_of()
    gathers = 4                       # gather_unit: A over rows, 3 over pods
    per_unit = 6 * cfg.rescal_iters + 1 + 6 + gathers   # + normalize, error
    for c in job(fx, 0):
        for operand in ("dense", "bcsr"):
            perk, grid = c[operand]["collectives"]
            assert perk == per_unit * len(cfg.ks)
            assert grid == per_unit * len(chunks(cfg))


# ---------------------------------------------------------------------------
# Checkpoints and resume
# ---------------------------------------------------------------------------

def _same(a, b):
    assert a["k_opt"] == b["k_opt"]
    for name in ("s_min", "s_mean", "rel_err"):
        np.testing.assert_array_equal(a[name], b[name])
    for name in ("A", "R", "member_errors"):
        for k in a[name]:
            np.testing.assert_array_equal(a[name][k], b[name][k])


@pytest.mark.parametrize("run", [f"{m}_{p}" for m, _, p in RESUME_RUNS])
@pytest.mark.parametrize("shape", ["two", "pods"])
def test_resumed_grid_sweep_is_bit_identical(shape, run, request):
    """A sweep stopped after one unit (SweepInterrupted on every cell at
    the same unit) and resumed from its checkpoints equals the
    uninterrupted sweep bit for bit, on every cell; the resume reuses the
    checkpointed unit."""
    fx = request.getfixturevalue(shape)
    cells = job(fx, 1)
    for c in cells:
        r = c[run]
        _same(r["resumed"], r["clean"])
        _same(r["clean"], cells[0][run]["clean"])
        assert r["stopped"] == (1, 1, len(r["clean"]["units"]))
        assert r["reused"] == 1
        assert r["resumed"]["units"][0][-1] is True
    if run == "batched_2":
        assert [u[2] for u in cells[0][run]["clean"]["units"]] == [
            [0, 1], [2, 3], [0, 1], [2, 3]]
    with open(os.path.join(cells[0][run]["ckpt"], "sweep.json")) as f:
        import json
        stored = json.load(f)
    want = {"pod": 2 if shape == "pods" else 1, "data": 2, "model": 2}
    assert stored["mesh"] == want and stored["mode"] == run.split("_")[0]


@pytest.mark.parametrize("shape", ["two", "pods"])
def test_grid_checkpoint_restores_in_repro(shape, request):
    """A unit checkpoint the grid wrote is repro's global unit result:
    repro.ckpt.restore gives the gathered A (r_u, n, k), R and errors."""
    import jax
    from repro import ckpt as jckpt
    fx = request.getfixturevalue(shape)
    out = job(fx, 1)[0]
    uid, want = out["first_unit"]
    like = {name: jax.ShapeDtypeStruct(arr.shape, arr.dtype)
            for name, arr in want.items()}
    tree, step = jckpt.restore(os.path.join(out["batched_1"]["ckpt"], uid),
                               like)
    assert step == 0
    for name, arr in want.items():
        np.testing.assert_array_equal(np.asarray(tree[name]), arr)
    assert want["A"].shape == (4, 24, 2) and want["R"].shape == (4, 3, 2, 2)


# ---------------------------------------------------------------------------
# Retries every cell agrees on
# ---------------------------------------------------------------------------

def test_one_cell_transient_fault_makes_every_cell_retry(pods):
    """A sched/unit transient fault installed on one cell only: every
    cell retries the unit after the same backoff, every record shows two
    attempts, and the report equals the fault-free one."""
    cells = job(pods, 2)
    for c in cells:
        _same(c["transient"], c["clean"])
        units = c["transient"]["units"]
        assert [u[4] for u in units] == [1, 2]
        assert units[1][6] == c["backoff"] > 0
        assert units == cells[0]["transient"]["units"]
        assert c["transient"]["meta"]["n_retries"] == 1
    # the agreements add collectives outside the MU iterations only: the
    # failed attempt's opening agreement (3 all-reduces)
    assert cells[0]["transient"]["collectives"] == \
        cells[0]["clean"]["collectives"] + 3


def test_one_cell_deterministic_fault_fails_every_cell_fast(pods):
    """A deterministic fault on one cell: every cell raises the same
    class after one attempt (each cell probed the seam once)."""
    cells = job(pods, 2)
    for rank, c in enumerate(cells):
        name, msg = c["deterministic"]
        assert name == "DeterministicFault"
        assert ("another cell" in msg) == (rank != FAULT_RANK)
        assert c["deterministic_hits"] == {"sched/unit": 1}


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

def test_resume_under_another_grid_shape_is_refused(pods):
    """A 2 x (2 x 2) sweep on the directory a 2 x 2 sweep wrote (the same
    config, mode and cell-0 block): cell 0 names the mismatched "mesh",
    and every other cell refuses with the same class."""
    msgs = job(pods, 3)
    assert "different sweep configuration (mismatched: ['mesh'])" in msgs[0]
    for msg in msgs[1:]:
        assert msg.startswith("ValueError on another cell of the grid")


def test_grid_refuses_loop_mode_and_indivisible_chunks():
    cfg = cfg_of()
    one = Grid.at_rank(0, 1, 1, 1, "cpu")
    with pytest.raises(ValueError, match="host-only"):
        SweepScheduler(cfg, mode="loop", grid=one)
    two_pods = Grid.at_rank(0, 2, 1, 1, "cpu")
    with pytest.raises(ValueError, match=r"units \['grid_k2q0-k2q2'"):
        SweepScheduler(cfg, mode="grid", grid_chunk=3, grid=two_pods)
    with pytest.raises(ValueError, match=r"\['unit_k2_q0-0'.*pods=2"):
        SweepScheduler(cfg, n_pods=4, grid=two_pods)
    SweepScheduler(cfg, mode="grid", grid_chunk=2, grid=two_pods)
    with pytest.raises(ValueError, match="does not shard evenly"):
        run_grid_sweep_batched(two_pods, torch.zeros(3, 24, 24),
                               [(2, 0), (2, 1), (2, 2)], cfg,
                               TorchDraws(0, "cpu"))
