"""The port's counted step costs (``repro_torch.launch.step_costs``,
``repro_torch.obs.costs.measure_mu_costs``, the kernels' ``cost``) on
the CPU: the one-iteration MU program's FLOPs against ``repro``'s
loop-aware HLO count (``hlo_costs.analyze(aot_mu_program(...))``), the
wire formula against ``repro``'s, the same count on CPU and meta tensors
(the MU steps, a reduced LM's train, prefill and decode), a recording
grid against a live gloo grid, the trip counts against the whole count,
a reduced LM train step against ``repro``'s lowering, and each kernel's
``cost`` against the bound formula ``chip_smoke.py`` wrote inline before
it (PERF.md section 6's shapes).

``repro`` is imported inside the tests only (the spawned workers import
this module to find their functions); ``repro.launch.dryrun`` runs in a
subprocess (it sets ``XLA_FLAGS`` at import).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import REDUCED_ARCHS, RescalConfig, ShapeSpec
from repro_torch.core.rescal import RescalState, mu_step_batched
from repro_torch.core.sparse import BCSR
from repro_torch.dist.engine import DistRescalConfig, make_mu_step
from repro_torch.dist.sharding import Grid
from repro_torch.kernels import (bcsr_fused, bcsr_spmm, flash_attention,
                                 fused_bilinear, mu_update_a, score_topk)
from repro_torch.kernels.policy import KernelPolicy
from repro_torch.launch import dryrun, step_costs
from repro_torch.launch.mesh import spawn_grid
from repro_torch.launch.step_costs import StepCounter
from repro_torch.models.transformer import GridTransformer, Transformer
from repro_torch.obs import costs as obs_costs
from repro_torch.optim import AdamW
from repro_torch.train.serve_step import (make_prefill_step, make_serve_step,
                                          params_shardings)
from repro_torch.train.train_step import (TrainState, init_state,
                                          make_train_step, zero1_moments)

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
FUSED = KernelPolicy(use_fused=True)
# repro's tolerance for its loop-aware count (tests/test_hlo_costs.py)
HLO_TOL = 0.05
# a reduced LM train step against repro's lowering: the matmuls are the
# same products, but XLA's fusions count each elementwise instruction its
# lowerings emit (softmax, rsqrt, the optimizer's) where eager counts one
# per aten op, and its remat recomputes what it chooses; measured 0.950
# (llama3.2-1b reduced, 4 x 64, one device)
LM_TOL = 0.10


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


# ---------------------------------------------------------------------------
# The MU program against repro's HLO count
# ---------------------------------------------------------------------------

MU_CASES = [("dense", 4, 4316368), ("dense", 8, 8880960),
            ("bcsr", 4, 11775252), ("bcsr", 8, 24028036)]


@pytest.mark.parametrize("operand,k,recorded", MU_CASES)
def test_mu_program_flops_match_repro(operand, k, recorded):
    """(m, n) = (4, 256) dense, and ``random_bcsr(PRNGKey(0), 4, 512, 128,
    0.25)`` (11 blocks): the counted one-member MU iteration within 5% of
    ``repro``'s loop-aware count of its compiled program."""
    import jax
    import jax.numpy as jnp
    from repro.core.sparse import random_bcsr
    from repro.launch import hlo_costs
    from repro.obs import costs as jcosts
    from repro_torch import convert
    if operand == "dense":
        theirs = jnp.ones((4, 256, 256), jnp.float32)
        ours = torch.empty((4, 256, 256), device="meta")
    else:
        theirs = random_bcsr(jax.random.PRNGKey(0), 4, 512, 128, 0.25)
        ours = convert.bcsr(theirs, device="cpu").on_meta()
        assert ours.nnzb == 11
    want = hlo_costs.analyze(jcosts.aot_mu_program(theirs, k).as_text())
    assert want["flops"] == recorded
    got = obs_costs.measure_mu_costs(ours, [k])[k]
    assert abs(got["flops"] - want["flops"]) <= HLO_TOL * want["flops"]
    assert got["bytes accessed"] > 0


def test_cost_table_fills_the_counted_columns():
    X = torch.empty((4, 256, 256), device="meta")
    measured = obs_costs.measure_mu_costs(X, [4])

    @dataclasses.dataclass
    class Unit:
        uid: str = "unit_k4"
        k: int = 4
        members: tuple = (0, 1)
        seconds: float = 1.5
        reused: bool = False

    rows = obs_costs.cost_table([Unit()], X, iters=10, measured=measured)
    assert rows[0]["xla_gflop"] == pytest.approx(
        2 * 10 * measured[4]["flops"] / 1e9)
    assert rows[0]["model_vs_xla"] > 1.0      # three X products modelled
    table = obs_costs.format_cost_table(rows)
    assert " - " not in table.splitlines()[-1]


# ---------------------------------------------------------------------------
# The wire formula against repro's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g", [1, 2, 4, 16])
@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
def test_wire_bytes_equal_repro(kind, g):
    from repro.launch.hlo_stats import _wire_bytes
    for nbytes in (0, 4, 1000, 12345678):
        assert step_costs.wire_bytes(kind, nbytes, g) == \
            _wire_bytes(kind, nbytes, g)


# ---------------------------------------------------------------------------
# One count on every device
# ---------------------------------------------------------------------------

def _mu_operands(dev: str, sparse: bool, m=3, nl=256, k=5, bs=128):
    gen = torch.Generator().manual_seed(0)
    if sparse:
        rows = torch.tensor([0, 0, 1], dtype=torch.int32)
        cols = torch.tensor([0, 1, 1], dtype=torch.int32)
        X = BCSR(data=torch.rand((m, 3, bs, bs), generator=gen),
                 block_rows=rows, block_cols=cols, n=nl)
        X = X.on_meta() if dev == "meta" else X
    else:
        X = torch.rand((m, nl, nl), generator=gen).to(dev)
    A = torch.rand((nl, k), generator=gen).to(dev)
    R = torch.rand((m, k, k), generator=gen).to(dev)
    return X, A, R


def _engine_count(dev: str, sparse: bool, schedule: str) -> dict:
    grid = Grid.at_rank(0, 1, 1, 1, dev, record=True)
    step = make_mu_step(grid, DistRescalConfig(schedule=schedule,
                                               kernel=FUSED))
    X, A, R = _mu_operands(dev, sparse)
    with StepCounter() as c:
        step(X, A, R)
    # the recording grid counts each collective the counter sees
    coll = c.collectives_summary()
    assert grid.collectives == coll["total"]["count"]
    assert set(coll) - {"total", "by_axis"} == {"all-reduce"}
    return c.summary()


@pytest.mark.parametrize("schedule", ["batched", "sliced"])
@pytest.mark.parametrize("sparse", [False, True])
def test_mu_step_counts_equal_on_cpu_and_meta(sparse, schedule):
    cpu = _engine_count("cpu", sparse, schedule)
    meta = _engine_count("meta", sparse, schedule)
    assert cpu == meta
    kernel = "bcsr_xa_xta" if sparse else "fused_xa_xtb"
    m = 3
    assert cpu["ops"][f"kernel:{kernel}"] == (m if schedule == "sliced"
                                              else 1)
    assert cpu["ops"]["kernel:mu_update_a"] == 1
    assert cpu["collectives"]["total"]["count"] == (
        2 + 4 * m if schedule == "sliced" else 6)


def test_single_device_step_equals_mu_program():
    """The CLI's claim: ``measure_mu_costs`` counts what the sweep's MU
    step on the CPU counts."""
    X, A, R = _mu_operands("cpu", False)
    with StepCounter() as c:
        mu_step_batched(X, RescalState(A=A, R=R, step=0), policy=FUSED)
    got = obs_costs.measure_mu_costs(X, [A.shape[1]])[A.shape[1]]
    assert got == {"flops": float(c.flops), "bytes accessed": float(c.bytes)}


@pytest.mark.parametrize("sparse", [False, True])
def test_mu_program_on_a_cpu_operand_equals_meta(sparse):
    """``measure_mu_costs`` runs the step on the operand itself (the
    traced CLI's count on the card): the same count on a CPU operand as
    on meta tensors of its shapes."""
    assert obs_costs.measure_mu_costs(_mu_operands("cpu", sparse)[0],
                                      [4, 5]) == \
        obs_costs.measure_mu_costs(_mu_operands("meta", sparse)[0], [4, 5])


def test_a_count_on_real_tensors_imports_neither_dynamo_nor_sympy():
    """Counting a step on real tensors runs no meta op, and the counter's
    own dispatch imports nothing: ``torch._dynamo`` and sympy stay
    unloaded (each takes seconds to import; the traced CLI counts at its
    exit)."""
    code = (
        "import sys, torch\n"
        "from repro_torch.obs import costs\n"
        "from repro_torch.kernels.policy import KernelPolicy\n"
        "X = torch.rand(3, 64, 64)\n"
        "got = costs.measure_mu_costs(X, [4], policy=KernelPolicy())\n"
        "assert got[4]['flops'] > 0, got\n"
        "print(sorted(m for m in ('torch._dynamo', 'sympy')"
        " if m in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _lm_count(dev: str, kind: str, cfg, B=4, S=32) -> dict:
    grid = Grid.at_rank(0, 1, 1, 1, dev, lm=True, record=True)
    gen = torch.Generator().manual_seed(0)
    if dev == "cpu":
        state = init_state(cfg, AdamW(), generator=gen, device="cpu",
                           grid=grid)
    else:
        model = params_shardings(grid, Transformer(cfg, device="meta"))
        state = TrainState(params=model,
                           opt=zero1_moments(grid, model, AdamW()),
                           step=torch.zeros((), dtype=torch.int64))
    model = state.params
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen).to(dev)
    with StepCounter() as c:
        if kind == "train":
            make_train_step(cfg, grid=grid)(state, {"tokens": tokens,
                                                   "labels": tokens})
        elif kind == "prefill":
            make_prefill_step(model, grid=grid)(tokens)
        else:
            with step_costs.uncounted():
                cache = GridTransformer(model, grid).init_cache(B, S)
            make_serve_step(model, grid=grid)(cache, tokens[:, :1], S - 1)
    return c.summary()


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_lm_counts_equal_on_cpu_and_meta(kind):
    cfg = REDUCED_ARCHS["llama3.2-1b"]
    cpu = _lm_count("cpu", kind, cfg)
    meta = _lm_count("meta", kind, cfg)
    assert cpu == meta
    assert cpu["flops"] > 0 and cpu["bytes"] > 0
    # the prefill takes the kernel's route on meta as on the card, and
    # counts it so on the CPU (its plain version uncounted)
    assert cpu["ops"].get("kernel:flash_attention", 0) == (
        cfg.n_layers if kind == "prefill" else 0)


# ---------------------------------------------------------------------------
# A recording grid against a live gloo grid
# ---------------------------------------------------------------------------

GRID_RESCAL = (RescalConfig(name="t-dense", n=64, m=3, k=5),
               RescalConfig(name="t-bcsr", n=512, m=3, k=5, sparse=True,
                            block_size=32, block_density=0.3,
                            schedule="sliced"))
GRID_LM = ShapeSpec("t", "train", 16, 4)


def live_counts(grid, jobs) -> list:
    """Each job's step on this live gloo cell, counted: (grid.collectives
    made, the counter's summary)."""
    out = []
    for job in jobs:
        c0 = grid.collectives
        if job[0] == "rescal":
            cfg = job[1]
            sh = dryrun.rescal_share(cfg, grid.rows, grid.pods)
            gen = torch.Generator().manual_seed(1)
            if cfg.sparse:
                rng = np.random.default_rng(grid.rank)
                flat = np.sort(rng.choice(sh.nb * sh.nb, size=sh.nnzb,
                                          replace=False))
                Xl = BCSR(data=torch.rand((cfg.m, sh.nnzb, sh.bs, sh.bs),
                                          generator=gen),
                          block_rows=torch.from_numpy(
                              (flat // sh.nb).astype(np.int32)),
                          block_cols=torch.from_numpy(
                              (flat % sh.nb).astype(np.int32)), n=sh.nl)
            else:
                Xl = torch.rand((cfg.m, sh.nl, sh.nl), generator=gen)
            A = torch.rand((sh.nl, cfg.k), generator=gen)
            R = torch.rand((cfg.m, cfg.k, cfg.k), generator=gen)
            step = make_mu_step(grid, DistRescalConfig(
                schedule=cfg.schedule, kernel=FUSED))
            with StepCounter() as c:
                step(Xl, A, R)
        else:
            cfg = REDUCED_ARCHS[job[1]]
            gen = torch.Generator().manual_seed(0)
            state = init_state(cfg, AdamW(), generator=gen, device="cpu",
                               grid=grid)
            B, S = GRID_LM.global_batch, GRID_LM.seq_len
            tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen)
            with StepCounter() as c:
                make_train_step(cfg, grid=grid)(
                    state, {"tokens": tokens, "labels": tokens})
        out.append((grid.collectives - c0, c.summary()))
    return out


@pytest.fixture(scope="module")
def live_rescal(tmp_path_factory):
    return spawn_grid(live_counts, tmp_path_factory.mktemp("sc_rescal"),
                      data=2, model=2,
                      args=([("rescal", cfg) for cfg in GRID_RESCAL],))


@pytest.fixture(scope="module")
def live_lm(tmp_path_factory):
    return spawn_grid(live_counts, tmp_path_factory.mktemp("sc_lm"),
                      data=2, model=2, lm=True,
                      args=([("lm", "llama3.2-1b")],))


@pytest.mark.parametrize("job", range(len(GRID_RESCAL)))
def test_recording_grid_equals_a_live_rescal_grid(live_rescal, job):
    cfg = GRID_RESCAL[job]
    for rank, cell in enumerate(live_rescal):
        made, live = cell[job]
        c = dryrun.count_rescal(cfg, 2, 1, rank)
        assert made == c.collectives_summary()["total"]["count"]
        assert _flat(live) == _flat(c.summary())


def test_recording_grid_equals_a_live_lm_grid(live_lm):
    cfg = REDUCED_ARCHS["llama3.2-1b"]
    for rank, cell in enumerate(live_lm):
        made, live = cell[0]
        got = dryrun.count_lm(cfg, GRID_LM, 1, 2, 2, rank,
                              trip_counts=False)
        assert made == got["collectives"]["total"]["count"] > 0
        assert _flat(live) == _flat(got)


# ---------------------------------------------------------------------------
# Trip counts, and repro's lowering of a train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-moe-16b",
                                  "whisper-large-v3"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_trip_counts_equal_the_whole_count(arch, kind):
    """Four decoder layers (and three encoder layers) on a 2 x 2 grid,
    where ZeRO-1 gives each data rank two layers' moments: one layer of
    each kind counted and multiplied equals the whole step's count."""
    base = REDUCED_ARCHS[arch]
    cfg = dataclasses.replace(base, n_layers=4, **(
        {"n_enc_layers": 3} if base.n_enc_layers else {}))
    spec = ShapeSpec("t", kind, 32, 4 if kind != "train" else 8)
    for rank in (0, 2):
        whole = dryrun.count_lm(cfg, spec, 1, 2, 2, rank, trip_counts=False)
        assert _flat(dryrun.count_lm(cfg, spec, 1, 2, 2, rank)) == \
            _flat(whole)


def test_lm_train_flops_near_repro_lowering():
    code = (
        "import json, sys; from repro.launch import dryrun as d, hlo_costs;"
        " from repro.launch.mesh import make_debug_mesh;"
        " from repro.configs import REDUCED_ARCHS;"
        " from repro.configs.base import ShapeSpec;"
        " c = d.lower_lm_cell(REDUCED_ARCHS['llama3.2-1b'],"
        " ShapeSpec('t', 'train', 64, 4), make_debug_mesh(data=1, model=1))"
        ".compile(); print(json.dumps(hlo_costs.analyze(c.as_text())"
        "['flops']))")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    got = dryrun.count_lm(REDUCED_ARCHS["llama3.2-1b"],
                          ShapeSpec("t", "train", 64, 4), 1, 1, 1,
                          trip_counts=False)["flops"]
    assert abs(got - want) <= LM_TOL * want


# ---------------------------------------------------------------------------
# Each kernel's cost against the inline bound formulas it replaced
# ---------------------------------------------------------------------------

def _meta(*shape):
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("k", [4, 5, 8])
def test_bcsr_costs_equal_the_old_bound(k):
    r, m, nnzb, bs, n = 4, 8, 6259, 128, 131072     # the BCSR sweep's
    sp_r = BCSR.meta(m, nnzb, bs, n, members=r)
    A_r = _meta(r, n, k)
    T = r * m
    assert bcsr_fused.cost(sp_r, A_r, A_r) == (
        T * nnzb * bs * bs * 4 * k,
        sp_r.data.numel() * 4 + 2 * A_r.numel() * 4 + 2 * T * n * k * 4)
    sp, A = BCSR.meta(m, nnzb, bs, n), _meta(n, k)
    assert bcsr_spmm.cost(sp, A) == (
        m * nnzb * bs * bs * 2 * k,
        sp.data.numel() * 4 + A.numel() * 4 + m * n * k * 4)


@pytest.mark.parametrize("k", [4, 5, 8, 10])
def test_fused_cost_equals_the_old_bound(k):
    def old(X, B1, B2u, k):
        r, m, n1, n2 = X.shape
        return (4 * X.numel() * k,
                4 * (X.numel() + B1.numel() + B2u.numel()
                     + r * m * (n1 + n2) * k))
    r, m, n = 4, 8, 16384
    X, A = _meta(r, m, n, n), _meta(r, n, k)
    B2 = A.unsqueeze(-3).expand(r, m, n, k)
    assert fused_bilinear.cost(X, A, B2) == old(X, A, A, k)
    Xt, B2t = X[0, 2:3], B2[0, 2:3]                 # one slice
    assert fused_bilinear.cost(Xt, A[0], B2t) == \
        old(Xt[None], A[0][None], A[0][None], k)
    if k == 10:                                     # phase 17 (a)
        X, A = _meta(20, 12288, 12288), _meta(12288, 10)
        B2 = A.unsqueeze(-3).expand(20, 12288, 10)
        assert fused_bilinear.cost(X, A, B2) == old(X[None], A[None],
                                                    A[None], k)


@pytest.mark.parametrize("r,n,k", [(4, 131072, 5), (4, 16384, 5)])
def test_mu_update_a_cost_equals_the_old_bound(r, n, k):
    A, Num, S = _meta(r, n, k), _meta(r, n, k), _meta(r, k, k)
    assert mu_update_a.cost(A, Num, S) == ((2 * k + 2) * A.numel(),
                                           4 * (3 * A.numel() + S.numel()))


@pytest.mark.parametrize("b,n,k,topk", [(32, 131072, 3, 10),
                                        (128, 4194304, 32, 32)])
def test_score_topk_cost_equals_the_old_bound(b, n, k, topk):
    V, A = _meta(b, k), _meta(n, k)
    assert score_topk.cost(V, A, topk) == (
        2 * b * n * k, 4 * (n * k + b * k) + 8 * b * topk)


@pytest.mark.parametrize("b,hq,hkv,s,d", [(4, 32, 8, 4096, 64),
                                          (1, 32, 8, 32768, 64)])
def test_flash_cost_equals_the_old_bound(b, hq, hkv, s, d):
    q = torch.empty((b, hq, s, d), dtype=torch.bfloat16, device="meta")
    k = torch.empty((b, hkv, s, d), dtype=torch.bfloat16, device="meta")
    assert flash_attention.cost(q, k, k, causal=True) == (
        4 * b * hq * d * s * (s + 1) // 2,
        2 * (2 * b * hq * s * d + 2 * b * hkv * s * d))


@pytest.mark.parametrize("b,h,sq,skv,d,dqk,dv,causal", [
    (2, 40, 2048, 2048, 128, 96, 64, True),        # MLA, padded
    (2, 20, 512, 2048, 64, 64, 64, False)])        # cross
def test_flash_cost_equals_the_old_zoo_bound(b, h, sq, skv, d, dqk, dv,
                                             causal):
    def old(heads, pairs, dqk, dv):
        return (2 * heads * pairs * (dqk + dv),
                2 * heads * (sq * dqk + skv * dqk + skv * dv + sq * dv))
    q = torch.empty((b, h, sq, d), dtype=torch.bfloat16, device="meta")
    k = torch.empty((b, h, skv, d), dtype=torch.bfloat16, device="meta")
    pairs = sq * (sq + 1) // 2 if causal else sq * skv
    assert flash_attention.cost(q, k, k, causal=causal, dqk=dqk, dv=dv) == \
        old(b * h, pairs, dqk, dv)
    assert flash_attention.cost(q, k, k, causal=causal) == \
        old(b * h, pairs, d, d)


def test_visible_pairs_by_enumeration():
    for sq in range(1, 7):
        for skv in range(1, 7):
            for off in range(0, 7):
                want = sum(min(skv, off + i + 1) for i in range(sq))
                assert flash_attention.visible_pairs(sq, skv, True, off) \
                    == want
                assert flash_attention.visible_pairs(sq, skv, False, off) \
                    == sq * skv


def test_a_card_tensor_still_raises_without_a_card():
    """No meta branch for a CUDA tensor, no fallback: the wrapper's device
    check names the card."""
    X = torch.empty((2, 8, 8), device="meta")
    A = torch.empty((8, 4))
    with pytest.raises(ValueError, match="one CUDA device"):
        fused_bilinear.fused_xa_xtb(X, A, A.unsqueeze(0).expand(2, 8, 4))


def test_a_rank_the_kernels_refuse_has_no_count():
    """k = 65 is past the kernels' MAX_K: no count for that rank, as
    ``repro`` leaves a rank without an analysis; the table shows "-"."""
    X = torch.empty((2, 128, 128))
    got = obs_costs.measure_mu_costs(X, [4, 65])
    assert got[65] == {} and got[4]["flops"] > 0


def test_a_block_size_the_kernels_refuse_has_no_count():
    """Blocks of 16 are not the BCSR kernels' (a multiple of 32): no
    count under the fused policy, which counts the card's path; the
    plain step still counts."""
    idx = torch.tensor([0, 1], dtype=torch.int32)
    X = BCSR(data=torch.rand((2, 2, 16, 16)), block_rows=idx,
             block_cols=idx, n=32)
    assert obs_costs.measure_mu_costs(X, [4]) == {4: {}}
    plain = obs_costs.measure_mu_costs(X, [4], policy=KernelPolicy())
    assert plain[4]["flops"] > 0
