"""The port's dry run (``repro_torch.launch.dryrun``) and what it reads:
the paper's RESCAL configs, ``input_specs``, ``cache_shapes`` and
``state_shapes`` against ``repro``'s; both FLOP formulas against
``repro``'s; the plan's per-rank bytes against the tensors each rank of a
CPU gloo grid really holds, and its collectives against
``Grid.collectives``; the plan's transient peaks against the live bytes
of the port's own step (``LiveBytes``: the RESCAL ledger byte for byte
on every cell of those grids, the LM training estimate within its fit
margin); the CLI, ``--all`` and the example.

``repro`` is imported inside the tests only (the spawned workers import
this module to find their functions).  ``repro.launch.dryrun`` is never
imported here: it sets ``XLA_FLAGS`` to 512 devices at import, so its
formula runs in a subprocess.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import (ARCHS, REDUCED_ARCHS, RESCAL_CONFIGS,
                                 SHAPES, RescalConfig, ShapeSpec, get_config,
                                 input_specs)
from repro_torch.core.sparse import BCSR
from repro_torch.dist.engine import DistRescalConfig, make_mu_step
from repro_torch.kernels import bcsr_fused, fused_bilinear
from repro_torch.kernels import mu_update_a as mu_mod
from repro_torch.kernels.policy import KernelPolicy
from repro_torch.launch import dryrun
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import spawn_grid
from repro_torch.models import model as model_lib
from repro_torch.models import transformer as tt
from repro_torch.models.transformer import GridTransformer, Transformer
from repro_torch.optim import AdamW
from repro_torch.train.serve_step import params_shardings
from repro_torch.train.train_step import init_state, state_shapes

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")

# small RESCAL cells for the grids: dense and BCSR, k = 5 (the kernel's
# 8-column build), and a BCSR at the exascale cells' k = 10 (two column
# slices of B's tiles), n dividing 2 x 2
DENSE = RescalConfig(name="t-dense", n=64, m=3, k=5)
SPARSE = RescalConfig(name="t-bcsr", n=512, m=3, k=5, sparse=True,
                      block_size=32, block_density=0.3, schedule="sliced")
SPARSE10 = dataclasses.replace(SPARSE, name="t-bcsr10", m=2, k=10)
LM_ARCHS = ("llama3.2-1b", "deepseek-moe-16b", "minicpm3-4b")
LM_SHAPE = dict(batch=4, seq=16)


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _jcfg(cfg):
    from repro.configs.base import ArchConfig
    return ArchConfig(**dataclasses.asdict(cfg))


def _sd(x) -> tuple:
    """(shape, dtype name) of a torch tensor or a jax ShapeDtypeStruct."""
    return tuple(x.shape), str(x.dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# Configs, input specs, cache and state shapes against repro
# ---------------------------------------------------------------------------

def test_rescal_configs_equal_repro():
    from repro.configs import RESCAL_CONFIGS as JR
    assert sorted(RESCAL_CONFIGS) == sorted(JR)
    for name, cfg in RESCAL_CONFIGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(JR[name])
        assert cfg.dense_bytes == JR[name].dense_bytes
        assert cfg.stored_bytes == JR[name].stored_bytes


def test_get_config_resolves_every_name_as_repro():
    from repro.configs import get_config as jget
    for name in list(ARCHS) + list(RESCAL_CONFIGS):
        got, want = get_config(name), jget(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(KeyError) as ours:
        get_config("no-such-arch")
    with pytest.raises(KeyError) as theirs:
        jget("no-such-arch")
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_equal_repro(arch, shape):
    from repro.configs import input_specs as jspecs
    cfg, spec = ARCHS[arch], SHAPES[shape]
    got = input_specs(cfg, spec)
    want = jspecs(_jcfg(cfg), spec)
    assert set(got) == set(want)
    for key in want:
        if key == "pos":
            assert _sd(got[key]) == _sd(want[key])
            continue
        g, w = _flat(got[key]) if key != "tokens" else {"": got[key]}, \
            _flat(want[key]) if key != "tokens" else {"": want[key]}
        assert {p: _sd(x) for p, x in g.items()} == \
            {p: _sd(x) for p, x in w.items()}, key
    for x in _flat({k: v for k, v in got.items()}).values():
        assert x.device.type == "meta"


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_shapes_equal_repro(arch):
    from repro.models import transformer as jt
    cfg = ARCHS[arch]
    got = tt.cache_shapes(cfg, 3, 64)
    want = jt.cache_shapes(_jcfg(cfg), 3, 64)
    assert {k: _sd(v) for k, v in got.items()} == \
        {k: _sd(v) for k, v in want.items()}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_state_shapes_equal_repro(arch):
    from repro.optim import AdamW as JAdamW
    from repro.train import train_step as jts
    from repro_torch.dist.sharding import stacked_shapes
    cfg = ARCHS[arch]
    got = state_shapes(cfg, AdamW())
    want = jts.state_shapes(_jcfg(cfg), JAdamW())

    def stacked(named: dict) -> dict:
        return stacked_shapes({n: tuple(t.shape) for n, t in named.items()})

    params = dict(got.params.named_parameters())
    assert all(p.device.type == "meta" for p in params.values())
    assert stacked(params) == {p: tuple(x.shape)
                               for p, x in _flat(want.params).items()}
    assert {str(p.dtype).replace("torch.", "") for p in params.values()} \
        == {str(x.dtype) for x in _flat(want.params).values()}
    for ours, theirs in ((got.opt.m, want.opt.m), (got.opt.v, want.opt.v)):
        assert stacked(ours) == {p: tuple(x.shape)
                                 for p, x in _flat(theirs).items()}
        assert {t.dtype for t in ours.values()} == {torch.float32}
        assert {str(x.dtype) for x in _flat(theirs).values()} == {"float32"}
    assert _sd(got.opt.count) == _sd(want.opt.count)


# ---------------------------------------------------------------------------
# FLOP formulas against repro
# ---------------------------------------------------------------------------

def test_rescal_model_flops_equal_repro():
    code = ("import json; from repro.configs import RESCAL_CONFIGS as C; "
            "from repro.launch.dryrun import rescal_model_flops as f; "
            "print(json.dumps({n: f(c) for n, c in C.items()}))")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    assert {n: dryrun.rescal_model_flops(c)
            for n, c in RESCAL_CONFIGS.items()} == want


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_lm_model_flops_equal_repro(arch):
    from repro.models import model as jm
    cfg = ARCHS[arch]
    for spec in SHAPES.values():
        assert model_lib.model_flops(cfg, spec) == \
            jm.model_flops(_jcfg(cfg), spec)


# ---------------------------------------------------------------------------
# The plan against what each rank of a gloo grid holds
# ---------------------------------------------------------------------------

def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages the ops run under it create, while they
    live, and their peak: a storage counts from the op that makes it
    (not a view of an input) until the last tensor on it dies.
    ``paused`` leaves the ops it runs uncounted."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self.sizes: dict[int, int] = {}
        self.counting = True

    def _free(self, key: int) -> None:
        self.live -= self.sizes.pop(key)

    @contextlib.contextmanager
    def paused(self):
        self.counting = False
        try:
            yield
        finally:
            self.counting = True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.counting:
            return out
        inputs = {x.untyped_storage()._cdata
                  for x in tree_leaves((args, kwargs))
                  if isinstance(x, torch.Tensor)}
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.sizes or key in inputs:
                continue
            self.sizes[key] = st.nbytes()
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)
        return out


@contextlib.contextmanager
def card_allocations(live: LiveBytes):
    """The three RESCAL kernels' CPU paths replaced by what their CUDA
    wrappers allocate, in their order (the values from the plain versions,
    uncounted): ``fused_xa_xtb`` XA, XTB and its fixed-order workspace;
    ``bcsr_xa_xta`` B's operand tiles (unless the call is handed them),
    XA, XTB of kt columns and the partials; ``bcsr_fused.prepare`` the
    tiles it hands on; ``mu_update_a`` its output."""
    plain = (fused_bilinear.ref_fused_xa_xtb, bcsr_fused.ref_bcsr_xa_xta,
             mu_mod.ref_mu_update_a, bcsr_fused.plain_operands)

    def fused(X, B1, B2):
        with live.paused():
            xa_v, xtb_v = plain[0](X, B1, B2)
        call = fused_bilinear.Call(X, B1, B2)
        xa = torch.empty(call.shape_out(call.n1))
        xtb = torch.empty(call.shape_out(call.n2))
        ws = torch.empty(fused_bilinear.workspace_floats(
            call.T, call.n1, call.n2, call.k, call.b1_groups,
            call.b2_groups))
        del ws
        xa.copy_(xa_v)
        xtb.copy_(xtb_v)
        return xa, xtb

    def bcsr(sp, B1, B2, operands=None):
        with live.paused():
            xa_v, xtb_v = plain[1](sp, B1, B2)
        k = B1.shape[-1]
        kc = bcsr_fused.slice_width(k)
        tiled = bcsr_fused._tile(sp, B1, B2) if operands is None \
            else operands
        kt = -(-k // 4) * 4
        members = (sp.batch_shape[0] if sp.batch_shape else
                   B1.shape[0] if B1.dim() == 3 else None)
        T = (members or 1) * sp.m
        xa = torch.empty((T, sp.n_pad, k))
        xtb = torch.empty((T, sp.n_pad, kt))
        part = torch.empty(T * sp.nnzb * sp.bs * kc)
        sp.col_index()
        del part, tiled
        lead = (members,) if members is not None else ()

        def out(x):
            x = x.reshape(lead + (sp.m, sp.n_pad, k))[..., :sp.n, :]
            return x

        xa, xtb = out(xa), out(xtb[..., :k])
        xa.copy_(xa_v)
        xtb.copy_(xtb_v)
        return xa, xtb

    def mu(A, Num, S, eps):
        with live.paused():
            v = plain[2](A, Num, S, eps)
        o = torch.empty(v.shape)
        o.copy_(v)
        return o

    fused_bilinear.ref_fused_xa_xtb = fused
    bcsr_fused.ref_bcsr_xa_xta = bcsr
    mu_mod.ref_mu_update_a = mu
    bcsr_fused.plain_operands = bcsr_fused._tile
    try:
        yield
    finally:
        (fused_bilinear.ref_fused_xa_xtb, bcsr_fused.ref_bcsr_xa_xta,
         mu_mod.ref_mu_update_a, bcsr_fused.plain_operands) = plain


def _local_bcsr(sh, m: int, seed: int) -> BCSR:
    """A shard-local BCSR of exactly ``sh.nnzb`` blocks per slice."""
    rng = np.random.default_rng(seed)
    flat = np.sort(rng.choice(sh.nb * sh.nb, size=sh.nnzb, replace=False))
    rows = torch.from_numpy((flat // sh.nb).astype(np.int32))
    cols = torch.from_numpy((flat % sh.nb).astype(np.int32))
    gen = torch.Generator().manual_seed(seed)
    data = torch.rand((m, sh.nnzb, sh.bs, sh.bs), generator=gen)
    return BCSR(data=data, block_rows=rows, block_cols=cols, n=sh.nl)


def cell_rescal(grid, cfg: RescalConfig, schedule: str,
                comm_dtype: str | None = None) -> dict:
    """This cell's share of ``cfg`` as the engine holds it, the
    collectives of one fused MU iteration, and the live bytes of the next
    one's own allocations at their peak (the kernels' as on the card)."""
    cfg = dataclasses.replace(cfg, schedule=schedule)
    sh = dryrun.rescal_share(cfg, grid.rows, grid.pods)
    gen = torch.Generator().manual_seed(1)
    if cfg.sparse:
        Xl = _local_bcsr(sh, cfg.m, seed=grid.rank)
        held = _nbytes(Xl.data, Xl.block_rows, Xl.block_cols, Xl.row_ptr)
    else:
        X = torch.rand((cfg.m, cfg.n, cfg.n), generator=gen)
        Xl = grid.x_block(X).contiguous()
        held = _nbytes(Xl)
    A = torch.rand((dryrun.ENSEMBLE_R, cfg.n, cfg.k), generator=gen)
    R = torch.rand((dryrun.ENSEMBLE_R, cfg.m, cfg.k, cfg.k), generator=gen)
    if grid.pods > 1:
        mine = list(grid.pod_members(dryrun.ENSEMBLE_R))
        Ai, Ri = grid.row_block(A[mine]).contiguous(), R[mine]
    else:
        Ai, Ri = grid.row_block(A[0]).contiguous(), R[0]
    held += _nbytes(Ai, Ri)
    step = make_mu_step(grid, DistRescalConfig(
        schedule=schedule, comm_dtype=comm_dtype,
        kernel=KernelPolicy(use_fused=True)))
    c0 = grid.collectives
    Ai, Ri = step(Xl, Ai, Ri)
    collectives = grid.collectives - c0
    live = LiveBytes()
    with card_allocations(live):
        step(Xl, Ai, Ri)                 # the pattern's cached index
        with live:
            out = step(Xl, Ai, Ri)
    del out
    return {"rank": grid.rank, "held": held, "collectives": collectives,
            "diagonal": grid.i == grid.j, "step_peak": live.peak}


def cell_lm(grid, arch: str) -> dict:
    """The LM state this cell really holds: its parameter blocks, its
    ZeRO-1 moments and its decode cache."""
    cfg = REDUCED_ARCHS[arch]
    gen = torch.Generator().manual_seed(0)
    state = init_state(cfg, AdamW(), generator=gen, device="cpu", grid=grid)
    model = state.params
    gm = GridTransformer(model, grid)
    cache = gm.init_cache(LM_SHAPE["batch"], LM_SHAPE["seq"])
    serve = params_shardings(grid, Transformer(cfg, device="cpu", gen=gen))
    return {"rank": grid.rank, "i": grid.i,
            "params": _nbytes(*model.parameters()),
            "serve_params": _nbytes(*serve.parameters()),
            "moments": _nbytes(*state.opt.m.values(), *state.opt.v.values()),
            "cache": _nbytes(*cache.values())}


def cell_jobs(grid, jobs):
    return [globals()[name](grid, *args) for name, args in jobs]


RESCAL_JOBS = [("cell_rescal", (cfg, schedule)) for cfg in (DENSE, SPARSE)
               for schedule in ("batched", "sliced")]
RESCAL_JOBS += [("cell_rescal", (DENSE, "batched", "bfloat16")),
                ("cell_rescal", (SPARSE, "sliced", "bfloat16")),
                ("cell_rescal", (SPARSE10, "batched")),
                ("cell_rescal", (SPARSE10, "sliced"))]


@pytest.fixture(scope="module")
def rescal_grids(tmp_path_factory):
    return {(pods, g): spawn_grid(cell_jobs, tmp_path_factory.mktemp(
        f"rescal{pods}x{g}"), pods=pods, data=g, model=g,
        args=(RESCAL_JOBS,)) for pods, g in ((1, 2), (2, 1))}


@pytest.mark.parametrize("job", range(len(RESCAL_JOBS)))
@pytest.mark.parametrize("grid", [(1, 2), (2, 1)])
def test_rescal_plan_bytes_and_collectives_equal_the_grid(rescal_grids,
                                                          grid, job):
    pods, g = grid
    cfg, schedule, *cd = RESCAL_JOBS[job][1]
    plan = dryrun.plan_rescal(dataclasses.replace(cfg, schedule=schedule),
                              g, pods, comm_dtype=cd[0] if cd else None)
    for cell in rescal_grids[grid]:
        got = cell[job]
        assert got["held"] == plan["memory"]["argument"], got["rank"]
        assert got["collectives"] == plan["collectives"]["count"]
    want = 6 if schedule == "batched" else 2 + 4 * cfg.m
    assert plan["collectives"]["count"] == want


@pytest.mark.parametrize("job", range(len(RESCAL_JOBS)))
@pytest.mark.parametrize("grid", [(1, 2), (2, 1)])
def test_rescal_ledger_peak_equals_the_engine_step(rescal_grids, grid,
                                                   job):
    """The ledger's peak (the plan's output + temp) of each cell,
    diagonal or not, equals the live bytes of the engine's own step at
    its peak, byte for byte; the plan takes the largest cell's.  With a
    comm dtype the wire copy that ``psum_cast`` drops may outlive the
    call by a moment (gloo's worker thread lets its reference go after
    the wait returns), so the step may read up to one wire buffer
    more."""
    pods, g = grid
    cfg, schedule, *cd = RESCAL_JOBS[job][1]
    cfg = dataclasses.replace(cfg, schedule=schedule)
    comm = cd[0] if cd else None
    sh = dryrun.rescal_share(cfg, g, pods)
    plan = dryrun.plan_rescal(cfg, g, pods, comm_dtype=comm)
    peaks = []
    for cell in rescal_grids[grid]:
        got = cell[job]
        led = dryrun.rescal_ledger(sh, diagonal=got["diagonal"],
                                   comm_dtype=comm)
        lag = max(b for _, b in led.collectives) if comm else 0
        assert led.peak <= got["step_peak"] <= led.peak + lag, \
            (got["rank"], got["diagonal"], got["step_peak"], led.peak)
        peaks.append(led.peak)
    mem = plan["memory"]
    assert mem["output"] + mem["temp"] == max(peaks)


# small bf16 LM training cells on one CPU: the loss's backward (a wide
# vocabulary) and the chunked attention's tiles (long rows, many heads)
# each the largest transient
LM_TRAIN_CELLS = {
    "loss": (dict(n_layers=2, d_model=128, n_heads=8, n_kv=2, head_dim=16,
                  d_ff=512, vocab=8000), 2, 256),
    "attention": (dict(n_layers=2, d_model=128, n_heads=16, n_kv=4,
                       head_dim=16, d_ff=512, vocab=512), 1, 1024),
}


@pytest.mark.parametrize("cell", sorted(LM_TRAIN_CELLS))
def test_lm_train_plan_holds_to_the_measured_peak(cell, monkeypatch):
    """The training CLI's live bytes at their peak (state, batch and the
    step) against the plan's total on a 1 x 1 grid: the plan within the
    fit's train margin of it, either way."""
    fields, B, S = LM_TRAIN_CELLS[cell]
    cfg = dataclasses.replace(ARCHS["llama3.2-1b"], dtype="bfloat16",
                              **fields)
    monkeypatch.setattr(train_cli, "ARCHS", {cfg.name: cfg})
    live = LiveBytes()
    with live:
        train_cli.main(["--arch", cfg.name, "--steps", "1", "--batch",
                        str(B), "--seq", str(S), "--remat", "--device",
                        "cpu"])
    plan = dryrun.plan_lm(cfg, ShapeSpec("t", "train", S, B), 1, 1, 1)
    total = plan["memory"]["total"]
    margin = dryrun.LM_PLAN_SHORTFALL["train"]
    assert live.peak / (1 + margin) <= total <= live.peak * (1 + margin), \
        (total, live.peak)


@pytest.fixture(scope="module")
def lm_grids(tmp_path_factory):
    jobs = [("cell_lm", (arch,)) for arch in LM_ARCHS]
    return {shape: spawn_grid(cell_jobs, tmp_path_factory.mktemp(
        "lm" + "x".join(map(str, shape))), pods=shape[0], data=shape[1],
        model=shape[2], lm=True, args=(jobs,))
        for shape in ((1, 2, 2), (2, 1, 2))}


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 1, 2)])
def test_lm_plan_bytes_equal_the_grid(lm_grids, shape, arch):
    pods, data, model = shape
    cfg = REDUCED_ARCHS[arch]
    B, S = LM_SHAPE["batch"], LM_SHAPE["seq"]
    train = dryrun.plan_lm(cfg, ShapeSpec("t", "train", S, B), pods, data,
                           model)
    decode = dryrun.plan_lm(cfg, ShapeSpec("d", "decode", S, B), pods, data,
                            model)
    assert "refused" not in train and "refused" not in decode
    cells = lm_grids[shape]
    for cell in cells:
        got = cell[LM_ARCHS.index(arch)]
        assert got["params"] == got["serve_params"] \
            == train["terms"]["params"]
        assert got["moments"] == train["moments_by_data_index"][got["i"]]
        assert got["cache"] == decode["terms"]["cache"]
    assert train["terms"]["moments"] == max(
        c[LM_ARCHS.index(arch)]["moments"] for c in cells)


def test_lm_plan_refuses_as_the_grid_does():
    """A decode cache whose positions the model axis does not divide, and
    an MoE batch that does not split over the data cells: the port's own
    messages."""
    cfg = REDUCED_ARCHS["llama3.2-1b"]
    got = dryrun.plan_lm(cfg, ShapeSpec("d", "decode", 15, 4), 1, 2, 2)
    assert "multiple of the model axis" in got["refused"]
    moe = REDUCED_ARCHS["deepseek-moe-16b"]
    got = dryrun.plan_lm(moe, ShapeSpec("p", "prefill", 16, 3), 1, 2, 2)
    assert "split evenly" in got["refused"]


# ---------------------------------------------------------------------------
# The CLI, --all and the example
# ---------------------------------------------------------------------------

def _run(*args, timeout=120):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=timeout, env=env, cwd=ROOT)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_cli_rescal_small(tmp_path, multi_pod):
    out = tmp_path / "cell.json"
    args = ["-m", "repro_torch.launch.dryrun", "--arch", "rescal-small",
            "--shape", "mu_iter", "--out", str(out)]
    if multi_pod:
        args.append("--multi-pod")
    r = _run(*args)
    assert r.returncode == 0, r.stderr[-2000:]
    d = json.loads(out.read_text())
    assert d["devices"] == (512 if multi_pod else 256)
    assert d["skipped"] is False
    assert d["memory"][dryrun.FIT_KEY] is True
    assert d["memory"]["card_bytes"] == 80 * 10 ** 9
    for key in dryrun.XLA_ONLY:
        assert d[key] is None, key
    assert d["collectives"]["total"]["count"] == 6
    assert d["collectives"]["per"] == "MU iteration"
    assert d["flops_per_device"] > 0 and d["bytes_per_device"] > 0
    assert d["ops"]["kernel:fused_xa_xtb"] == 1
    assert d["model_flops_global"] > 0


def test_cli_skipped_cell_records_reason(tmp_path):
    out = tmp_path / "skip.json"
    r = _run("-m", "repro_torch.launch.dryrun", "--arch", "yi-9b",
             "--shape", "long_500k", "--out", str(out))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "full-attention" in json.loads(out.read_text())["skipped"]


def test_exascale_cells():
    dense = dryrun.run_cell("rescal-dense-3tb", "mu_iter")
    assert dense["devices"] == 256
    assert dense["terms"]["X block"] == 20 * 12288 * 12288 * 4
    assert dense["memory"]["argument"] >= 12.08e9
    sparse = dryrun.run_cell("rescal-sparse-eb", "mu_iter", multi_pod=True)
    assert sparse["devices"] == 512
    assert sparse["local"]["nnzb"] == 6653
    assert sparse["local"]["nl"] == 23347200
    assert sparse["collectives"]["total"]["count"] == 2 + 4 * 20
    assert sparse["ops"]["kernel:bcsr_xa_xta"] == 20
    # the dense share reads its 12.08 GB block once per MU iteration
    assert dense["bytes_per_device"] >= dense["terms"]["X block"]
    assert dense["flops_per_device"] >= 4 * 20 * 12288 ** 2 * 10
    for d in (dense, sparse):
        assert d["memory"][dryrun.FIT_KEY]
        assert d["memory"]["total"] == d["memory"]["peak"]
        assert all(d[k] is None for k in dryrun.XLA_ONLY)
        assert all(d[k] is not None for k in dryrun.COUNTED)


def test_all_cells_one_mesh(tmp_path):
    # counting every cell's step adds ~2 min on a CPU (three processes;
    # internvl2-26b's 8-microbatch train step the longest, ~85 s)
    r = _run("-m", "repro_torch.launch.dryrun", "--all", "--out",
             str(tmp_path), timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    files = sorted((tmp_path / "pod").glob("*.json"))
    assert len(files) == len(ARCHS) * len(SHAPES) + len(RESCAL_CONFIGS)
    for f in files:
        d = json.loads(f.read_text())
        assert d["devices"] == 256
        assert "refused" not in d, d["refused"]
        if d.get("skipped"):
            assert "full-attention" in d["skipped"]
        else:
            assert d["memory"]["total"] > 0
            assert all(d[k] is None for k in dryrun.XLA_ONLY)
            assert "count_error" not in d, d["count_error"]
            assert d["flops_per_device"] > 0 and d["bytes_per_device"] > 0
            assert d["ops"] and d["collectives"]["total"]["count"] >= 0
            arch = d["arch"]
            assert d["model_flops_global"] == (
                dryrun.rescal_model_flops(RESCAL_CONFIGS[arch])
                if arch in RESCAL_CONFIGS else
                model_lib.model_flops(ARCHS[arch], SHAPES[d["shape"]]))


def test_example_exits_zero():
    r = _run(str(ROOT / "examples" / "torch_exascale_dryrun.py"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "All exascale cells fit" in r.stdout
