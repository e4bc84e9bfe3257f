"""The LM zoo's other families on the process grid against repro: the MoE
(deepseek-moe-16b, granite-moe-3b-a800m) and MLA (minicpm3-4b) here,
the SSM, hybrid, enc-dec and VLM in tests/test_torch_lm_grid_zoo2.py;
the MoE's global groups, slots, drops and balance loss, the fused
expert weight's placement, and the elastic reshard.

Each grid shape is spawned once per module (``launch.mesh.spawn_grid``,
CPU gloo, one process per cell): 2 x 2 and 1 x 4 (data x model), and for
the reshard 4 x 2.  The cells compute with the port on numpy inputs made
here and return numpy; ``repro``'s references run in the pytest process,
and ``jax`` and ``repro`` are imported inside the tests and fixtures
only (the workers import this module to find their functions).

What each grid exercises, at the reduced configs (4 query heads of 16,
2 KV heads, d_ff 128, 4 experts top-2, vocab 512; L = 2): on 2 x 2 the
experts split 2 per rank, the router's layer axis takes "model" in
``repro``'s rules (so each layer's router is whole), and the batch's 4 x
32 tokens form one group of 128 across both data cells; on 1 x 4 one
expert per rank and the router's 4 columns split.  The edge cases: 6
experts on 1 x 4 (E does not divide the axis: every rank runs every
expert on its 32-column d_ff block; ``repro``'s EXPERT-else-ff), an MLA
of 6 heads on 1 x 4 (wq_up's, wkv_up's and wo's blocks are 1.5 heads),
groups that span the data cells at an uneven boundary (4 x 48 tokens in
groups of 64), and the reshard from a (2, 2) checkpoint onto (4, 2)
(llama3.2-1b, as repro's check) and onto (1, 4) (the 6 experts, expert
sharded on the first grid and ff sharded on the second).

Tolerances, with their reasons:
  * the loss and the grad norm over 3 train steps against repro's
    single-device step: rtol 1e-4 (repro's tests/multidevice_main.py);
    the parameters after them at atol 2 * lr * steps (a near-zero
    gradient whose sign flips with the summation order moves its
    parameter by 2 * lr per step).
  * the prefill's last-position logits and 6 decode steps fed the same
    tokens against repro's single-device prefill and decode_step: rtol
    and atol 2e-3 (repro's check_sharded_decode_matches_single).
  * moe_apply's output and aux on the grid against repro's moe_apply on the global
    batch: 1e-5 of the largest |value| (fp32 sums in another order); its
    slots equal.
  * the reshard: the step after the restore within rtol 1e-4 of the
    first grid's own (repro's check_elastic_reshard).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import ckpt, convert
from repro_torch.configs import ARCHS, REDUCED_ARCHS, reduced
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import Grid
from repro_torch.launch.mesh import spawn_grid
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.models.transformer import GridTransformer, Transformer
from repro_torch.optim import AdamW
from repro_torch.train import make_prefill_step, make_serve_step
from repro_torch.train.loop import _global_like, load_tree, state_tree
from repro_torch.train.serve_step import params_shardings
from repro_torch.train.train_step import (TrainState, init_state,
                                          make_train_step, zero1_moments)

LR = 1e-3
STEPS = 3
TRAIN_BATCH, TRAIN_SEQ = 4, 32
LOSS_RTOL = 1e-4
DECODE_TOL = 2e-3
MOE_TOL = 1e-5
# the serve batch: B prompts of P tokens (2 x the hybrid's window), SE
# encoder frames, NEW decode steps fed the same tokens on both sides
B, P, SE, NEW = 4, 32, 8, 6
ARCHS_HERE = ("deepseek-moe-16b", "granite-moe-3b-a800m", "minicpm3-4b")
EDGES = {"six-experts": ("granite-moe-3b-a800m", dict(n_experts=6)),
         "six-mla-heads": ("minicpm3-4b", dict(n_heads=6))}
# groups of the global batch (B, S): one of 128 across both data cells,
# and groups of 64 whose boundary falls inside a cell (T_l = 96)
MOE_SHAPES = ((4, 32), (4, 48))


def cfg_of(arch: str, **kw):
    return reduced(ARCHS[arch], **kw) if kw else REDUCED_ARCHS[arch]


def jcfg(cfg):
    """repro's config with the port's values."""
    from repro.configs.base import ArchConfig
    return ArchConfig(**dataclasses.asdict(cfg))


def repro_params(cfg):
    import jax
    from repro.models import transformer as jt
    params = jt.init_params(jax.random.PRNGKey(0), jcfg(cfg))
    return jax.tree_util.tree_map(np.asarray, params)


def extra_inputs(cfg, rng, rows: int) -> dict:
    """enc-dec's frames or the VLM's patches for ``rows`` sequences."""
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal(
            (rows, SE, cfg.d_model)).astype(np.float32)}
    if cfg.family == "vlm":
        return {"patches": rng.standard_normal(
            (rows, cfg.n_patches, cfg.d_model)).astype(np.float32)}
    return {}


def torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype.kind in "iu"
            else torch.from_numpy(v) for k, v in batch.items()}


def job(cells, index):
    return [cell[index] for cell in cells]


def rows_of(cell, n_rows: int) -> slice:
    return slice(cell["i"] * n_rows, (cell["i"] + 1) * n_rows)


# ---------------------------------------------------------------------------
# What the cells run (imported by the spawned workers)
# ---------------------------------------------------------------------------

def placed_model(grid: Grid, cfg, params) -> Transformer:
    model = Transformer(cfg, device="cpu")
    params_shardings(grid, model)
    model.load_state_dict(convert.lm_grid_params_from_repro(
        params, cfg, grid, device="cpu"))
    return model


def cell_train(grid: Grid, cfg, params, batches) -> dict:
    """STEPS grid train steps from repro's parameters on repro's batches
    (the MoE's einsum path): the metrics, the parameters after them
    (gathered, on rank 0), and the collectives per step."""
    opt = AdamW(lr=LR)
    model = placed_model(grid, cfg, params)
    state = TrainState(params=model, opt=zero1_moments(grid, model, opt),
                       step=torch.zeros((), dtype=torch.int64))
    step = make_train_step(cfg, grid=grid, optimizer=opt, remat=True)
    hist, per_step = [], []
    for b in batches:
        c0 = grid.collectives
        state, m = step(state, torch_batch(b))
        per_step.append(grid.collectives - c0)
        hist.append({k: float(v) for k, v in m.items()})
    placement = tt.lm_placement(grid, cfg)
    full = {n: placement.gather_param(n, p.detach()).numpy()
            for n, p in model.named_parameters()}
    return {"hist": hist, "collectives": per_step,
            "params": full if grid.rank == 0 else None, "i": grid.i}


def cell_serve(grid: Grid, cfg, params, serve: dict) -> dict:
    """The grid prefill of the global prompts (and frames or patches),
    then NEW decode steps from its cache fed serve["next"]: this cell's
    rows of the last-position and step logits, and the cache's
    shapes."""
    model = placed_model(grid, cfg, params)
    inputs = {k: torch.from_numpy(v) for k, v in serve.items()
              if k in ("frames", "patches")}
    start = P + (cfg.n_patches if cfg.family == "vlm" else 0)
    logits, cache = make_prefill_step(model, grid=grid,
                                      max_len=start + NEW)(
        torch.from_numpy(serve["prompts"]).long(), **inputs)
    step = make_serve_step(model, grid=grid)
    rows = shd.shard_batch(grid, {"t": torch.from_numpy(serve["next"])})["t"]
    out, per_step = [], []
    for t in range(NEW):
        c0 = grid.collectives
        s, cache = step(cache, rows[:, t:t + 1].long(), start + t)
        per_step.append(grid.collectives - c0)
        out.append(s.numpy())
    return {"prefill": logits.numpy(), "steps": np.concatenate(out, 1),
            "collectives": per_step, "i": grid.i,
            "cache": {n: tuple(x.shape) for n, x in cache.items()}}


def cell_moe(grid: Grid, cfg, params, x, impl: str) -> dict:
    """moe_apply on layer 0's experts for this cell's rows of the global
    x, and ``slots`` on this cell's first choices of the global
    routing: (y rows, aux, slots)."""
    model = placed_model(grid, cfg, params)
    gm = GridTransformer(model, grid)
    p = model.layers[0].moe
    xr = shd.shard_batch(grid, {"x": torch.from_numpy(x)})["x"]
    with torch.no_grad():
        y, aux = tmoe.moe_apply(p, xr, cfg.top_k, impl=impl,
                                plan=gm.moe_plan, tp=gm.tp, batch=gm.rows)
    out = {"y": y.numpy(), "aux": float(aux), "i": grid.i}
    if impl == "einsum":
        Bg, S, d = x.shape
        T, T_l = Bg * S, xr.shape[0] * S
        router = convert.lm_params_from_repro(params, cfg, "cpu")[
            "layers.0.moe.router"]
        probs = torch.softmax(xr.reshape(T_l, d) @ router, dim=-1)
        _, gids = tmoe._top_k(probs, cfg.top_k)
        out["slots"] = tmoe.slots(gids, cfg.n_experts,
                                  tmoe.tokens_per_group(T), t0=T_l * grid.i,
                                  T=T, batch=gm.rows).numpy()
    return out


def cell_wgi(grid: Grid, cfg, params) -> dict:
    """The fused expert weight cut to this cell's block and gathered
    back, and the block's two halves."""
    model = placed_model(grid, cfg, params)
    pl = tt.lm_placement(grid, cfg)
    local = model.layers[0].moe.wgi.detach()
    return {"local": local.numpy(),
            "whole": pl.gather_param("layers.0.moe.wgi", local).numpy(),
            "halves": pl["layers.0.moe.wgi"].halves, "j": grid.j}


def reshard_state(grid: Grid, cfg, seed: int = 0) -> TrainState:
    return init_state(cfg, AdamW(lr=LR), generator=torch.Generator()
                      .manual_seed(seed), device="cpu", grid=grid)


def cell_reshard_save(grid: Grid, cfg, batches, ck: str) -> dict:
    """repro's check_elastic_reshard, first grid: 2 steps, the global
    checkpoint of step 2 (rank 0 writes it), then this grid's step 3."""
    state = reshard_state(grid, cfg)
    step = make_train_step(cfg, grid=grid, optimizer=AdamW(lr=LR),
                           remat=False)
    for b in batches[:2]:
        state, _ = step(state, torch_batch(b))
    tree = state_tree(state, grid)
    if grid.rank == 0:
        ckpt.save(ck, 2, tree)
    grid.agree([2])
    _, m = step(state, torch_batch(batches[2]))
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}


def cell_reshard_load(grid: Grid, cfg, batches, ck: str) -> dict:
    """The second grid: a fresh state restored from the global checkpoint
    (``load_tree``: this cell's blocks), then step 3."""
    state = reshard_state(grid, cfg, seed=1)
    tree, n = ckpt.restore(ck, _global_like(state))
    state = load_tree(state, tree, grid)
    step = make_train_step(cfg, grid=grid, optimizer=AdamW(lr=LR),
                           remat=False)
    _, m = step(state, torch_batch(batches[2]))
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "restored": n, "count": int(state.opt.count)}


def cell_jobs(grid: Grid, jobs) -> list:
    return [globals()[name](grid, *args) for name, args in jobs]


# ---------------------------------------------------------------------------
# repro's references
# ---------------------------------------------------------------------------

def train_ref(cfg, seed: int = 0) -> dict:
    """repro's parameters, STEPS numpy batches and its single-device
    train step's losses, grad norms and parameters after them."""
    import jax
    import jax.numpy as jnp
    from repro.optim import AdamW as JAdamW
    from repro.train import make_train_step as jtrain
    from repro.train.train_step import TrainState as JState
    params = repro_params(cfg)
    rng = np.random.default_rng(seed)
    batches = [{"tokens": rng.integers(0, cfg.vocab,
                                       (TRAIN_BATCH, TRAIN_SEQ)),
                "labels": rng.integers(0, cfg.vocab,
                                       (TRAIN_BATCH, TRAIN_SEQ)),
                **extra_inputs(cfg, rng, TRAIN_BATCH)}
               for _ in range(STEPS)]
    opt = JAdamW(lr=LR)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = JState(params=jp, opt=opt.init(jp),
                   step=jnp.zeros((), jnp.int32))
    step = jtrain(jcfg(cfg), None, optimizer=opt, remat=False,
                  donate=False)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    final = convert.lm_params_from_repro(state.params, cfg, "cpu")
    return {"params": params, "batches": batches, "losses": losses,
            "grad_norms": norms,
            "final": {n: x.numpy() for n, x in final.items()}}


def serve_ref(cfg, params, seed: int = 1) -> dict:
    """The serve inputs and repro's single-device prefill and NEW decode
    steps from its cache, fed the same tokens."""
    import jax.numpy as jnp
    from repro.models import transformer as jt
    rng = np.random.default_rng(seed)
    serve = {"prompts": rng.integers(0, cfg.vocab, (B, P)),
             "next": rng.integers(0, cfg.vocab, (B, NEW)),
             **extra_inputs(cfg, rng, B)}
    jc = jcfg(cfg)
    batch = {"tokens": jnp.asarray(serve["prompts"]),
             **{k: jnp.asarray(v) for k, v in serve.items()
                if k in ("frames", "patches")}}
    last, jcache = jt.prefill(params, jc, batch)
    start = P + (cfg.n_patches if cfg.family == "vlm" else 0)
    full = jt.init_cache(jc, B, start + NEW)
    for leaf, x in jcache.items():
        same = leaf in ("xk", "xv") or x.shape == full[leaf].shape
        full[leaf] = x if same else full[leaf].at[:, :, :start].set(x)
    steps = []
    for t in range(NEW):
        s, full = jt.decode_step(params, jc, full,
                                 jnp.asarray(serve["next"][:, t:t + 1]),
                                 jnp.int32(start + t))
        steps.append(np.asarray(s, np.float32))
    return {"serve": serve, "prefill": np.asarray(last, np.float32),
            "steps": np.concatenate(steps, axis=1)}


def family_refs(archs, edges) -> dict:
    out = {}
    for name in archs:
        cfg = cfg_of(name)
        t = train_ref(cfg)
        out[name] = {"cfg": cfg, "train": t,
                     **serve_ref(cfg, t["params"])}
    for name, (arch, kw) in edges.items():
        cfg = cfg_of(arch, **kw)
        t = train_ref(cfg)
        out[name] = {"cfg": cfg, "train": t,
                     **serve_ref(cfg, t["params"])}
    return out


def family_jobs(refs) -> list:
    jobs = []
    for r in refs.values():
        jobs.append(("cell_train", (r["cfg"], r["train"]["params"],
                                    r["train"]["batches"])))
        jobs.append(("cell_serve", (r["cfg"], r["train"]["params"],
                                    r["serve"])))
    return jobs


def check_train(cells, ref) -> None:
    for cell in cells:
        np.testing.assert_allclose([h["loss"] for h in cell["hist"]],
                                   ref["losses"], rtol=LOSS_RTOL)
        np.testing.assert_allclose([h["grad_norm"] for h in cell["hist"]],
                                   ref["grad_norms"], rtol=LOSS_RTOL)
    counts = {tuple(c["collectives"]) for c in cells}
    assert len(counts) == 1 and min(next(iter(counts))) > 0
    first = cells[0]["params"]
    assert set(first) == set(ref["final"])
    for name, want in ref["final"].items():
        np.testing.assert_allclose(first[name], want, rtol=0,
                                   atol=2 * LR * STEPS, err_msg=name)


def check_serve(cells, ref) -> None:
    rows = B // (1 + max(c["i"] for c in cells))
    for c in cells:
        r = rows_of(c, rows)
        np.testing.assert_allclose(c["prefill"], ref["prefill"][r],
                                   rtol=DECODE_TOL, atol=DECODE_TOL)
        np.testing.assert_allclose(c["steps"], ref["steps"][r],
                                   rtol=DECODE_TOL, atol=DECODE_TOL)
    assert len({tuple(c["collectives"]) for c in cells}) == 1


# ---------------------------------------------------------------------------
# The spawned grids
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def refs():
    return family_refs(ARCHS_HERE, EDGES)


@pytest.fixture(scope="module")
def moe_refs():
    """A 6-expert MoE layer whose router favours expert 0 (so groups drop
    assignments past capacity), global inputs, and repro's moe_apply on
    them in its three paths."""
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    cfg = cfg_of("deepseek-moe-16b", n_experts=6)
    params = repro_params(cfg)
    rng = np.random.default_rng(5)
    bias = rng.standard_normal(cfg.d_model).astype(np.float32)
    router = np.array(params["layers"]["moe"]["router"])
    router[:, :, 0] += 0.5 * bias / np.linalg.norm(bias)
    params["layers"]["moe"]["router"] = router
    layer0 = {k: (v[0] if not isinstance(v, dict) else
                  {kk: vv[0] for kk, vv in v.items()})
              for k, v in params["layers"]["moe"].items()}
    out = {"cfg": cfg, "params": params, "cases": []}
    for Bg, S in MOE_SHAPES:
        x = (rng.standard_normal((Bg, S, cfg.d_model)) + bias).astype(
            np.float32)
        want = {impl: jmoe.moe_apply(
            {k: (jnp.asarray(v) if not isinstance(v, dict) else
                 {kk: jnp.asarray(vv) for kk, vv in v.items()})
             for k, v in layer0.items()}, jnp.asarray(x), cfg.top_k,
            impl=impl) for impl in ("einsum", "scatter", "dense")}
        out["cases"].append((x, {k: (np.asarray(y), float(a))
                                 for k, (y, a) in want.items()}))
    return out


def moe_jobs(moe_refs) -> list:
    return [("cell_moe", (moe_refs["cfg"], moe_refs["params"], x, impl))
            for x, _ in moe_refs["cases"]
            for impl in ("einsum", "scatter", "dense")]


@pytest.fixture(scope="module")
def reshard_refs(tmp_path_factory):
    """The reshard's two models, their batches (8 x 32 for llama, as
    repro's check) and the checkpoint directories."""
    rng = np.random.default_rng(9)
    out = {}
    for name, cfg, rows in (("llama", cfg_of("llama3.2-1b"), 8),
                            ("moe", cfg_of("granite-moe-3b-a800m",
                                           n_experts=6), 4)):
        out[name] = (cfg, [{"tokens": rng.integers(0, cfg.vocab, (rows, 32)),
                            "labels": rng.integers(0, cfg.vocab, (rows, 32))}
                           for _ in range(3)],
                     str(tmp_path_factory.mktemp(f"reshard_{name}")))
    return out


N_FAMILY = 2 * (len(ARCHS_HERE) + len(EDGES))


@pytest.fixture(scope="module")
def grid22(refs, moe_refs, reshard_refs, tmp_path_factory):
    jobs = family_jobs(refs) + moe_jobs(moe_refs) + [
        ("cell_reshard_save", reshard_refs["llama"]),
        ("cell_reshard_save", reshard_refs["moe"])]
    return spawn_grid(cell_jobs, tmp_path_factory.mktemp("z22"), data=2,
                      model=2, lm=True, args=(jobs,))


@pytest.fixture(scope="module")
def grid14(refs, moe_refs, reshard_refs, grid22, tmp_path_factory):
    jobs = family_jobs(refs) + moe_jobs(moe_refs) + [
        ("cell_reshard_load", reshard_refs["moe"]),
        ("cell_wgi", (moe_refs["cfg"], moe_refs["params"]))]
    return spawn_grid(cell_jobs, tmp_path_factory.mktemp("z14"), data=1,
                      model=4, lm=True, args=(jobs,))


@pytest.fixture(scope="module")
def grid42(reshard_refs, grid22, tmp_path_factory):
    return spawn_grid(cell_jobs, tmp_path_factory.mktemp("z42"), data=4,
                      model=2, lm=True,
                      args=([("cell_reshard_load", reshard_refs["llama"])],))


def family_index(refs, name: str, serve: bool) -> int:
    return 2 * list(refs).index(name) + int(serve)


# ---------------------------------------------------------------------------
# Training and serving against repro's single device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["grid22", "grid14"])
@pytest.mark.parametrize("name", ARCHS_HERE + tuple(EDGES))
def test_grid_train_steps_match_repro(name, shape, refs, request):
    cells = request.getfixturevalue(shape)
    check_train(job(cells, family_index(refs, name, False)),
                refs[name]["train"])


@pytest.mark.parametrize("shape", ["grid22", "grid14"])
@pytest.mark.parametrize("name", ARCHS_HERE + tuple(EDGES))
def test_grid_prefill_and_decode_match_repro(name, shape, refs, request):
    cells = request.getfixturevalue(shape)
    check_serve(job(cells, family_index(refs, name, True)), refs[name])


def test_mla_cache_is_sequence_sharded(refs, grid14):
    """minicpm3-4b on 1 x 4: the latents' 40 positions (32 + 6, rounded
    up) are 10 per rank, every latent column whole."""
    cfg = refs["minicpm3-4b"]["cfg"]
    for c in job(grid14, family_index(refs, "minicpm3-4b", True)):
        assert c["cache"] == {"c": (2, B, 10, cfg.kv_lora),
                              "r": (2, B, 10, cfg.d_rope)}


# ---------------------------------------------------------------------------
# The MoE's global groups, and the fused expert weight
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["grid22", "grid14"])
@pytest.mark.parametrize("case", range(len(MOE_SHAPES)))
@pytest.mark.parametrize("impl", ["einsum", "scatter", "dense"])
def test_moe_grid_matches_repro_on_the_global_batch(impl, case, shape,
                                                    moe_refs, request):
    """moe_apply's rows and aux on the grid against repro's moe_apply on
    the whole batch: the groups, capacities, slots and drops, and the balance loss
    are the global batch's, also where a group spans the data cells."""
    x, want = moe_refs["cases"][case]
    y_ref, aux_ref = want[impl]
    cells = job(request.getfixturevalue(shape),
                N_FAMILY + 3 * case + ["einsum", "scatter",
                                       "dense"].index(impl))
    rows = x.shape[0] // (1 + max(c["i"] for c in cells))
    scale = np.abs(y_ref).max()
    for c in cells:
        np.testing.assert_allclose(c["y"], y_ref[rows_of(c, rows)], rtol=0,
                                   atol=MOE_TOL * scale)
        np.testing.assert_allclose(c["aux"], aux_ref, rtol=MOE_TOL)


@pytest.mark.parametrize("case", range(len(MOE_SHAPES)))
def test_moe_slots_and_drops_of_groups_spanning_cells(case, moe_refs,
                                                      grid22):
    """The slots each data cell of 2 x 2 computes for its rows (the
    earlier cell's counts all-gathered) equal the single device's over
    the global batch, and the biased router drops assignments."""
    cfg = moe_refs["cfg"]
    x, _ = moe_refs["cases"][case]
    Bg, S, d = x.shape
    T = Bg * S
    router = convert.lm_params_from_repro(moe_refs["params"], cfg, "cpu")[
        "layers.0.moe.router"]
    probs = torch.softmax(torch.from_numpy(x).reshape(T, d) @ router, -1)
    _, gids = tmoe._top_k(probs, cfg.top_k)
    gs = tmoe.tokens_per_group(T)
    C = tmoe.capacity(gs, cfg.top_k, cfg.n_experts, tmoe.CAPACITY_FACTOR)
    # the single device's slots, counted as repro counts them: earlier
    # assignments to the same expert in the group's (token, k) order
    onehot = torch.nn.functional.one_hot(gids, cfg.n_experts).reshape(
        T // gs, gs * cfg.top_k, -1)
    slot = ((torch.cumsum(onehot, 1) - onehot) * onehot).sum(-1)
    kept = slot < C
    slot = slot.reshape(Bg, S, cfg.top_k).numpy()
    assert (T // 2) % gs                          # a group spans cells
    assert int((~kept).sum()) > 0                 # drops past capacity
    cells = job(grid22, N_FAMILY + 3 * case)
    for c in cells:
        np.testing.assert_array_equal(
            c["slots"], slot[rows_of(c, Bg // 2)].reshape(-1, cfg.top_k))


def test_fused_expert_weight_cut_and_regathered(moe_refs, grid14):
    """6 experts on 1 x 4 (E does not divide the axis): each rank holds
    its 32-column block of wg beside its block of wi, and the gather
    gives back [wg | wi] in the global layout."""
    cfg = moe_refs["cfg"]
    wg = moe_refs["params"]["layers"]["moe"]["wg"][0]
    wi = moe_refs["params"]["layers"]["moe"]["wi"][0]
    cells = job(grid14, N_FAMILY + 3 * len(MOE_SHAPES) + 1)
    per = cfg.d_ff // 4
    for c in cells:
        assert c["halves"]
        j = slice(c["j"] * per, (c["j"] + 1) * per)
        np.testing.assert_array_equal(
            c["local"], np.concatenate([wg[..., j], wi[..., j]], -1))
        np.testing.assert_array_equal(c["whole"],
                                      np.concatenate([wg, wi], -1))
    # the cut alone, on a grid without process groups
    pl = tt.lm_placement(Grid.at_rank(2, 1, 1, 4, "cpu", lm=True), cfg)
    full = torch.from_numpy(np.concatenate([wg, wi], -1))
    assert pl.local_shape("layers.0.moe.wgi") == (6, cfg.d_model, 2 * per)
    assert torch.equal(pl.local("layers.0.moe.wgi", full),
                       torch.cat([full[..., 2 * per:3 * per],
                                  full[..., cfg.d_ff + 2 * per:
                                       cfg.d_ff + 3 * per]], -1))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_arch_places_on_every_lm_grid(arch):
    """lm_placement and GridTransformer take every arch on any LM grid
    (the reduced config placed on 1 x 2 and 2 x 4 cells)."""
    cfg = cfg_of(arch)
    for shape in ((1, 1, 2), (1, 2, 4), (2, 1, 2)):
        grid = Grid.at_rank(1, *shape, "cpu", lm=True)
        model = Transformer(cfg, device="cpu")
        params_shardings(grid, model)
        gm = GridTransformer(model, grid)
        assert gm.placement is not None
    with pytest.raises(ValueError, match="LM grid"):
        tt.lm_placement(Grid.at_rank(0, 1, 1, 1, "cpu"), cfg)


def test_moe_rows_must_split_over_the_data_cells():
    cfg = cfg_of("deepseek-moe-16b")
    grid = Grid.at_rank(0, 1, 2, 1, "cpu", lm=True)
    model = Transformer(cfg, device="cpu")
    params_shardings(grid, model)
    with pytest.raises(ValueError, match="split evenly"):
        GridTransformer(model, grid).init_cache(3, 8)


# ---------------------------------------------------------------------------
# The elastic reshard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,shape", [("llama", "grid42"),
                                        ("moe", "grid14")])
def test_elastic_reshard_continues_the_run(name, shape, grid22, request):
    """repro's check_elastic_reshard: 2 steps on (2, 2), the global
    checkpoint restored onto (4, 2) (llama3.2-1b) or (1, 4) (6 experts:
    expert-sharded, then ff-sharded), and step 3 there equal to the
    first grid's own step 3."""
    index = {"llama": -2, "moe": -1}[name]
    want = job(grid22, index)
    cells = request.getfixturevalue(shape)
    got = job(cells, 0 if name == "llama" else -2)
    for c in got:
        assert c["restored"] == 2 and c["count"] == 2
        np.testing.assert_allclose(c["loss"], want[0]["loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(c["grad_norm"], want[0]["grad_norm"],
                                   rtol=LOSS_RTOL)
    assert len({c["loss"] for c in want}) == 1
