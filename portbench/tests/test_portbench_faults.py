"""The harness's comparison catches a broken timed path.  Each test skips
the look for a card and drives the rest of a run on the CPU at a small
size, with the port's code broken underneath, and sees ``correct`` come
out false: a step that returns its state unchanged, half of the batch
left out (the MU loop's relation slices; the sweep's members, the
reduction taken over the rest), and an answer altered where it is
produced; and, in the MU loop, an output buffer that every call reuses,
which shows only in steps that run back to back with their states held.
The sound run of each cell comes out correct."""
import dataclasses
import time

import pytest
import torch
from conftest import small_config

from portbench.harness import cell

CELLS = {"dense3tb.mu": ("rescal-dense-3tb.r16", ("dense", "batched")),
         "sparseeb.mu": ("rescal-sparse-eb.r16", ("bcsr", "sliced")),
         "dense3tb.select": ("rescal-dense-3tb.r16", ("dense", "batched"))}


def run(bench, name: str, seed: int = 2 ** 31 + 11) -> dict:
    cfg = small_config(CELLS[name][0])
    return cell.run_cell(bench, name, seed, 0.2, False, "cpu",
                         time.perf_counter(), config=cfg)


def unchanged(orig):
    return lambda grid, Xl, Ai, R, cfg: (Ai, R)


def half_slices(orig):
    """The iteration on the first half of the relation slices only; the
    other slices' R kept as it was."""
    def it(grid, Xl, Ai, R, cfg):
        h = R.shape[-3] // 2
        from repro_torch.core.sparse import BCSR
        Xh = Xl.with_data(Xl.data[..., :h, :, :, :]) \
            if isinstance(Xl, BCSR) else Xl[..., :h, :, :]
        A, Rh = orig(grid, Xh, Ai, R[..., :h, :, :], cfg)
        return A, torch.cat([Rh, R[..., h:, :, :]], dim=-3)
    return it


def altered(orig):
    """The iteration, then one element of A changed."""
    def it(grid, Xl, Ai, R, cfg):
        A, R = orig(grid, Xl, Ai, R, cfg)
        A = A.clone()
        A[..., 0, 0] = 2.0 * A.max()
        return A, R
    return it


def reused_buffer(orig):
    """The iteration, its A written into one buffer that every call
    returns: each step's arithmetic is right, but a state held past the
    next call changes under it."""
    buf = {}

    def it(grid, Xl, Ai, R, cfg):
        A, R = orig(grid, Xl, Ai, R, cfg)
        out = buf.setdefault("A", torch.empty_like(A))
        return out.copy_(A), R
    return it


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_run_is_correct(bench, name):
    out = run(bench, name)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("fault", [unchanged, half_slices, altered])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_broken_step_is_not_correct(bench, name, fault, monkeypatch):
    from repro_torch.dist import engine
    key = CELLS[name][1]
    monkeypatch.setitem(engine._ITERS, key, fault(engine._ITERS[key]))
    out = run(bench, name)
    assert not out["correct"]
    assert out["failed"] > 0


@pytest.mark.parametrize("name", ["dense3tb.mu", "sparseeb.mu"])
def test_reused_output_buffer_is_not_correct(bench, name, monkeypatch):
    from repro_torch.dist import engine
    key = CELLS[name][1]
    monkeypatch.setitem(engine._ITERS, key,
                        reused_buffer(engine._ITERS[key]))
    out = run(bench, name)
    assert not out["correct"]
    assert out["failed"] > 0


def test_sweep_half_members_is_not_correct(bench, monkeypatch):
    """Half of each rank's members computed, the reduction taken over
    those twice."""
    from repro_torch.selection import scheduler
    from repro_torch.selection.ensemble import EnsembleResult
    orig = scheduler.run_grid_ensemble

    def half(grid, Xl, k, cfg, draws, *, members=None):
        kept = tuple(members)[:len(members) // 2]
        res = orig(grid, Xl, k, cfg, draws, members=kept)
        return EnsembleResult(*(torch.cat([x, x]) for x in res))
    monkeypatch.setattr(scheduler, "run_grid_ensemble", half)
    out = run(bench, "dense3tb.select")
    assert not out["correct"] and out["failed"] > 0


def bump_first(a):
    a = a.copy()
    a.flat[0] = 2.0 * a.max()
    return a


@pytest.mark.parametrize("field,change", [
    ("rel_err", lambda v: v * 1.01), ("A_median", bump_first)])
def test_sweep_altered_answer_is_not_correct(bench, monkeypatch, field,
                                             change):
    """One rank's error 1% off, or one element of its median A."""
    from repro_torch.selection import scheduler
    orig = scheduler.reduce_k_grid

    def reduce(*args, **kwargs):
        res = orig(*args, **kwargs)
        return dataclasses.replace(res, **{field: change(getattr(res,
                                                                 field))})
    monkeypatch.setattr(scheduler, "reduce_k_grid", reduce)
    out = run(bench, "dense3tb.select")
    assert not out["correct"] and out["failed"] > 0
