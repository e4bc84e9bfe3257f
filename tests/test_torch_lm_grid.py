"""The LM on the process grid against repro: the placement trees, the
grid train step (tensor parallel, data parallel, ZeRO-1 moments,
microbatches), the grid prefill and decode (the sequence-sharded cache),
``decode_attention(group=)`` and ``ef_psum``.

Each grid shape is spawned once per module (``launch.mesh.spawn_grid``,
CPU gloo, one process per cell): 2 x 2, 1 x 4 and 2 x 1 (data x model).
The cells compute with the port on numpy inputs made here and return
numpy; ``repro``'s references run in the pytest process, and ``jax`` and
``repro`` are imported inside the tests and fixtures only (the workers
import this module to find their functions).

What each grid exercises (the reduced configs: 4 query heads of 16, d_ff
128, vocab 512): 2 x 2 heads and KV heads split evenly (2 and 1 per
rank), ZeRO-1 on the layer stack (L = 2 over data 2); 1 x 4 llama's 2
KV heads over 4 ranks (wk's 8-column blocks are half heads: gathered),
granite-20b's one KV head (MQA), and a 6-head variant whose heads do not
divide the axis (``constrain_heads``'s fallback: sequence-sharded
queries); 2 x 1 data parallelism alone.

Tolerances, with their reasons:
  * placement trees: equal.
  * the loss over 3 train steps against repro's single-device step: rtol
    1e-4 (repro's own tests/multidevice_main.py); the parameters after
    them at atol 2 * lr * steps (tests/test_torch_train.py: a near-zero
    gradient whose sign flips with the summation order moves its
    parameter by 2 * lr per step).
  * decode logits against repro's single-device serve step: rtol and
    atol 2e-3 (repro's own check); the grid path against the port's
    single-device path (the same arithmetic split over ranks, fp32
    partial sums added in another order): 1e-5 of the largest |logit|.
  * decode_attention(group=) against repro's axis_name= under vmap:
    1e-6 of the largest |value|; ef_psum's int8 sums exact, so its mean
    bit-identical.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import ARCHS, REDUCED_ARCHS, reduced
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import Grid, MeshShape, Spec
from repro_torch.launch import decode_demo
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import spawn_grid
from repro_torch.models import transformer as tt
from repro_torch.models.attention import decode_attention
from repro_torch.models.transformer import GridTransformer, Transformer
from repro_torch.optim import AdamW, compression
from repro_torch.train import make_prefill_step, make_serve_step
from repro_torch.train.serve_step import decode_loop, params_shardings
from repro_torch.train.train_step import (TrainState, batch_shardings,
                                          make_train_step, state_shardings,
                                          zero1_moments)

LR = 1e-3
STEPS = 3
TRAIN_BATCH, TRAIN_SEQ = 4, 32
LOSS_RTOL = 1e-4
DECODE_TOL = 2e-3
SAME_PATH_TOL = 1e-5
# a llama variant whose 6 query heads do not divide a 4-way model axis
SIX_HEADS = dict(n_heads=6, n_kv=2)
# the placement trees' meshes: repro's debug 2 x 2 and production meshes
MESHES = {"2x2": MeshShape(("data", "model"), {"data": 2, "model": 2}),
          "16x16": MeshShape(("data", "model"), {"data": 16, "model": 16}),
          "2x16x16": MeshShape(("pod", "data", "model"),
                               {"pod": 2, "data": 16, "model": 16})}
# decode caches (batch, positions): decode_32k's, and shapes that fall
# back (batch not a multiple of the data axes; positions not a multiple
# of "model")
CACHES = ((128, 32768), (4, 16), (6, 20))


class FakeMesh:
    """Just enough Mesh surface for repro's spec functions."""

    def __init__(self, mesh: MeshShape):
        self.axis_names = mesh.axis_names
        self.shape = dict(mesh.shape)


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


def flat(tree, prefix="") -> dict:
    """A repro pytree as {"/"-path: leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


# ---------------------------------------------------------------------------
# What the cells run (imported by the spawned workers)
# ---------------------------------------------------------------------------

def placed_model(grid: Grid, cfg, params) -> Transformer:
    model = Transformer(cfg, device="cpu")
    params_shardings(grid, model)
    model.load_state_dict(convert.lm_grid_params_from_repro(
        params, cfg, grid, device="cpu"))
    return model


def cell_train(grid: Grid, cfg, params, batches, mb: int) -> dict:
    """STEPS grid train steps from repro's parameters on repro's batches:
    the metrics, the parameters after them (gathered, on rank 0), each
    moment's owned shape, and the collectives per step."""
    opt = AdamW(lr=LR)
    model = placed_model(grid, cfg, params)
    state = TrainState(params=model, opt=zero1_moments(grid, model, opt),
                       step=torch.zeros((), dtype=torch.int64))
    step = make_train_step(cfg, grid=grid, optimizer=opt, remat=mb == 1,
                           moe_impl="dense", microbatches=mb)
    hist, per_step = [], []
    for b in batches:
        c0 = grid.collectives
        state, m = step(state, {k: torch.from_numpy(v).long()
                                for k, v in b.items()})
        per_step.append(grid.collectives - c0)
        hist.append({k: float(v) for k, v in m.items()})
    placement = tt.lm_placement(grid, cfg)
    full = {n: placement.gather_param(n, p.detach()).numpy()
            for n, p in model.named_parameters()}
    return {"hist": hist, "collectives": per_step,
            "params": full if grid.rank == 0 else None,
            "moments": {n: tuple(x.shape) for n, x in state.opt.m.items()},
            "moment_bytes": sum(4 * x.numel() for part in (state.opt.m,
                                                           state.opt.v)
                                for x in part.values()),
            "i": grid.i, "j": grid.j}


def cell_decode(grid: Grid, cfg, params, toks, max_len: int) -> dict:
    """Decode steps from a zero cache fed toks[:, t] (repro's
    multidevice check): this cell's rows of each step's logits."""
    model = placed_model(grid, cfg, params)
    gm = GridTransformer(model, grid)
    cache = gm.init_cache(toks.shape[0], max_len)
    step = make_serve_step(model, grid=grid)
    rows = shd.shard_batch(grid, {"t": torch.from_numpy(toks).long()})["t"]
    out, per_step = [], []
    for t in range(toks.shape[1]):
        c0 = grid.collectives
        logits, cache = step(cache, rows[:, t:t + 1], t)
        per_step.append(grid.collectives - c0)
        out.append(logits.numpy())
    return {"logits": np.concatenate(out, axis=1), "i": grid.i,
            "j": grid.j, "collectives": per_step,
            "cache": tuple(cache["k"].shape)}


def cell_serve(grid: Grid, cfg, params, prompts, new: int) -> dict:
    """The grid prefill of the global prompts, then ``new`` greedy decode
    steps (``decode_loop``): this cell's rows of the prefill's logits,
    the tokens and the step logits fed those tokens."""
    model = placed_model(grid, cfg, params)
    P = prompts.shape[1]
    logits, cache = make_prefill_step(model, grid=grid, max_len=P + new)(
        torch.from_numpy(prompts).long())
    first = logits.argmax(-1)
    cache_steps = {k: v.clone() for k, v in cache.items()}
    tokens, _ = decode_loop(model, cache, first, P, new, grid=grid)
    step = make_serve_step(model, grid=grid)
    steps = []
    for t in range(new):
        s, cache_steps = step(cache_steps, tokens[:, t:t + 1], P + t)
        steps.append(s.numpy())
    return {"prefill": logits.numpy(), "tokens": tokens.numpy(),
            "steps": np.concatenate(steps, axis=1), "i": grid.i}


def cell_collectives(grid: Grid, q, k, v, poses, g, err) -> dict:
    """decode_attention over the model axis on this rank's block of the
    cache's positions, and ef_psum over the model axis of this rank's
    row of g and err."""
    axis = grid.axis("model")
    S = k.shape[1] // axis.size
    lo = axis.index * S
    kc = torch.from_numpy(k[:, lo:lo + S])
    vc = torch.from_numpy(v[:, lo:lo + S])
    att = [decode_attention(torch.from_numpy(q), kc, vc, pos,
                            group=axis).numpy() for pos in poses]
    mean, new_err = compression.ef_psum(
        torch.from_numpy(g[axis.index]), torch.from_numpy(err[axis.index]),
        grid, "model")
    return {"att": att, "mean": mean.numpy(), "err": new_err.numpy()}


def cell_loop(grid: Grid, ck_root: str) -> dict:
    """train_loop on the grid: uninterrupted, then with checkpoints and a
    transient fault at hit 3 on every cell (restore step 2, replay)."""
    from repro_torch.data import TokenStreamConfig, batch_at
    from repro_torch.resilience import FaultPlan, FaultSpec, faults
    from repro_torch.train import LoopConfig, train_loop
    cfg = cfg_of("llama3.2-1b")
    ds = TokenStreamConfig(vocab=cfg.vocab, batch=4, seq=16, seed=0)

    def run(ck, plan):
        loop = LoopConfig(steps=4, save_every=2, seed=0, ckpt_dir=ck,
                          max_restarts=2)
        with faults.active(plan):
            return train_loop(cfg, lambda s: batch_at(ds, s), loop,
                              optimizer=AdamW(lr=LR), remat=False,
                              grid=grid)

    _, clean = run(None, None)
    plan = FaultPlan({"train/step": [FaultSpec(kind="raise-transient",
                                               at=(3,))]})
    state, faulty = run(ck_root, plan)
    shapes = None
    if grid.rank == 0:
        with np.load(f"{ck_root}/step_4.npz") as z:
            shapes = {k: z[k].shape for k in z.files}
    return {"clean": [(h["step"], h["loss"]) for h in clean],
            "faulty": [(h["step"], h["loss"]) for h in faulty],
            "fired": [f["hit"] for f in plan.fired], "shapes": shapes,
            "step": int(state.step), "count": int(state.opt.count)}


def cell_jobs(grid: Grid, jobs) -> list:
    return [globals()[name](grid, *args) for name, args in jobs]


# ---------------------------------------------------------------------------
# The references and the spawned grids
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def refs():
    """repro's parameters, batches and single-device references."""
    import jax
    import jax.numpy as jnp
    from repro.data import TokenStreamConfig, batch_at
    from repro.models import transformer as jt
    from repro.optim import AdamW as JAdamW
    from repro.train import make_serve_step as jserve
    from repro.train import make_train_step as jtrain
    from repro.train.train_step import TrainState as JState

    def train(cfg, mb):
        params = repro_params(cfg)
        ds = TokenStreamConfig(vocab=cfg.vocab, batch=TRAIN_BATCH,
                               seq=TRAIN_SEQ, seed=0)
        batches = [jax.tree_util.tree_map(np.asarray, batch_at(ds, i))
                   for i in range(STEPS)]
        opt = JAdamW(lr=LR)
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        state = JState(params=jp, opt=opt.init(jp),
                       step=jnp.zeros((), jnp.int32))
        step = jtrain(jcfg(cfg), None, optimizer=opt, remat=False,
                      moe_impl="dense", donate=False, microbatches=mb)
        losses, norms = [], []
        for b in batches:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        final = convert.lm_params_from_repro(state.params, cfg, "cpu")
        return {"params": params, "batches": batches, "losses": losses,
                "grad_norms": norms,
                "final": {n: x.numpy() for n, x in final.items()}}

    def decode(cfg, B, T, S):
        params = repro_params(cfg)
        toks = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (B, T),
                                             0, cfg.vocab))
        cache = jt.init_cache(jcfg(cfg), B, S)
        step = jserve(jcfg(cfg), None, moe_impl="dense")
        jparams = jax.tree_util.tree_map(jnp.asarray, params)
        out = []
        for t in range(T):
            logits, cache = step(jparams, cache, toks[:, t:t + 1],
                                 jnp.int32(t))
            out.append(np.asarray(logits, np.float32))
        return {"params": params, "toks": toks,
                "logits": np.concatenate(out, axis=1)}

    llama = cfg_of("llama3.2-1b")
    six = cfg_of("llama3.2-1b", **SIX_HEADS)
    rng = np.random.default_rng(0)
    return {"train": train(llama, 1), "train_mb": train(llama, 2),
            "train_six": train(six, 1),
            "decode": decode(cfg_of("yi-9b"), 4, 6, 16),
            "serve": {a: repro_params(cfg_of(a)) for a in
                      ("yi-9b", "llama3.2-1b", "granite-20b")},
            "prompts": rng.integers(0, 512, (4, 12)),
            "kernels": {"q": rng.standard_normal((2, 1, 8, 16),
                                                 dtype=np.float32),
                        "k": rng.standard_normal((2, 32, 2, 16),
                                                 dtype=np.float32),
                        "v": rng.standard_normal((2, 32, 2, 16),
                                                 dtype=np.float32),
                        "poses": (1, 5, 8, 9, 20, 32),
                        "g": rng.standard_normal((4, 128),
                                                 dtype=np.float32),
                        "err": 1e-3 * rng.standard_normal(
                            (4, 128), dtype=np.float32)}}


def serve_jobs(refs, archs):
    return [("cell_serve", (cfg_of(a), refs["serve"][a], refs["prompts"], 4))
            for a in archs]


@pytest.fixture(scope="module")
def grid22(refs, tmp_path_factory):
    t, d = refs["train"], refs["decode"]
    jobs = [("cell_train", (cfg_of("llama3.2-1b"), t["params"], t["batches"],
                            1)),
            ("cell_train", (cfg_of("llama3.2-1b"), refs["train_mb"]["params"],
                            refs["train_mb"]["batches"], 2)),
            ("cell_decode", (cfg_of("yi-9b"), d["params"], d["toks"], 16)),
            *serve_jobs(refs, ("yi-9b",)),
            ("cell_loop", (str(tmp_path_factory.mktemp("g22ck")),))]
    return spawn_grid(cell_jobs, tmp_path_factory.mktemp("g22"), data=2,
                      model=2, lm=True, args=(jobs,))


@pytest.fixture(scope="module")
def grid14(refs, tmp_path_factory):
    t, six, kk = refs["train"], refs["train_six"], refs["kernels"]
    jobs = [("cell_train", (cfg_of("llama3.2-1b"), t["params"], t["batches"],
                            1)),
            ("cell_train", (cfg_of("llama3.2-1b", **SIX_HEADS),
                            six["params"], six["batches"], 1)),
            ("cell_collectives", (kk["q"], kk["k"], kk["v"], kk["poses"],
                                  kk["g"], kk["err"])),
            *serve_jobs(refs, ("llama3.2-1b", "granite-20b"))]
    return spawn_grid(cell_jobs, tmp_path_factory.mktemp("g14"), data=1,
                      model=4, lm=True, args=(jobs,))


@pytest.fixture(scope="module")
def grid21(refs, tmp_path_factory):
    t = refs["train"]
    jobs = [("cell_train", (cfg_of("llama3.2-1b"), t["params"], t["batches"],
                            1))]
    return spawn_grid(cell_jobs, tmp_path_factory.mktemp("g21"), data=2,
                      model=1, lm=True, args=(jobs,))


def job(cells, index):
    return [cell[index] for cell in cells]


# ---------------------------------------------------------------------------
# (a) Placement parity, exact
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def repro_trees():
    """repro's param shape tree per arch (eval_shape, no devices)."""
    from repro.models import transformer as jt
    return {a: flat(jt.param_shapes(jcfg(c))) for a, c in ARCHS.items()}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_opt_state_specs_equal_repro(arch, mesh, repro_trees):
    from repro.dist import sharding as jshd
    m = MESHES[mesh]
    tree = repro_trees[arch]
    shapes = tt.param_shapes(ARCHS[arch])
    assert shapes == {p: tuple(x.shape) for p, x in tree.items()}
    for port_fn, repro_fn in ((shd.param_specs, jshd.param_specs),
                              (shd.opt_state_specs, jshd.opt_state_specs)):
        want = {p: tuple(s) for p, s in flat(repro_fn(
            FakeMesh(m), jt_tree(tree))).items()}
        got = port_fn(m, shapes)
        assert got == want


def jt_tree(flat_tree: dict) -> dict:
    """A flat {"/"-path: leaf} back into repro's nested tree."""
    out: dict = {}
    for path, leaf in flat_tree.items():
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_equal_repro(arch, mesh):
    from repro.dist import sharding as jshd
    from repro.models import transformer as jt
    m = MESHES[mesh]
    model = Transformer(ARCHS[arch], device="meta")
    for B, S in CACHES:
        cache = model.init_cache(B, S)
        jcache = jt.cache_shapes(jcfg(ARCHS[arch]), B, S)
        assert {n: tuple(x.shape) for n, x in cache.items()} == \
            {n: tuple(x.shape) for n, x in jcache.items()}
        want = {n: tuple(s) for n, s in jshd.cache_specs(
            FakeMesh(m), jcache).items()}
        assert shd.cache_specs(m, cache) == want


LOGICAL_CASES = [
    # tests/test_sharding.py's TestLogicalSpec, and the pod axis's
    # fallback to "data" alone
    ("4x4", (8, 16), (shd.BATCH, None), Spec("data", None)),
    ("pod", (8, 16), (shd.BATCH, None), Spec(("pod", "data"), None)),
    ("4x4", (6, 16), (shd.BATCH, shd.MODEL), Spec(None, "model")),
    ("4x4", (8, 10, 12), (shd.EXPERT, None, shd.MODEL),
     Spec("model", None, None)),
    ("4x4", (10, 8, 12), (shd.EXPERT, None, shd.MODEL),
     Spec(None, None, "model")),
    ("pod", (4, 16), (shd.BATCH, None), Spec("data", None)),
]


@pytest.mark.parametrize("mesh,shape,axes,want", LOGICAL_CASES)
def test_logical_spec_cases_match_repro(mesh, shape, axes, want):
    from repro.dist import sharding as jshd
    m = {"4x4": MeshShape(("data", "model"), {"data": 4, "model": 4}),
         "pod": MeshShape(("pod", "data", "model"),
                          {"pod": 2, "data": 4, "model": 4})}[mesh]
    assert shd.logical_spec(m, shape, axes) == want
    assert (jshd.BATCH, jshd.SEQ, jshd.MODEL, jshd.EXPERT) == \
        (shd.BATCH, shd.SEQ, shd.MODEL, shd.EXPERT)
    assert tuple(jshd.logical_spec(FakeMesh(m), shape, axes)) == want


def test_param_spec_rules_of_repro_tests():
    """tests/test_sharding.py's TestParamSpecs / TestOptStateSpecs /
    TestCacheSpecs cases on the port's functions."""
    m = MeshShape(("data", "model"), {"data": 4, "model": 4})
    s = shd.param_specs(m, {"attn/wq": (16, 32), "attn/wo": (32, 16),
                            "embed/table": (512, 16),
                            "moe/wi": (4, 16, 32), "moe/wo": (4, 32, 16),
                            "x/moe/wi": (10, 16, 32),
                            "x/moe/wo": (10, 32, 16),
                            "layers/mlp/wi": (8, 16, 32), "ln1": (16,)})
    assert s == {"attn/wq": Spec(None, "model"),
                 "attn/wo": Spec("model", None),
                 "embed/table": Spec("model", None),
                 "moe/wi": Spec("model", None, None),
                 "moe/wo": Spec("model", None, None),
                 "x/moe/wi": Spec(None, None, "model"),
                 "x/moe/wo": Spec(None, "model", None),
                 "layers/mlp/wi": Spec(None, None, "model"),
                 "ln1": Spec(None)}
    assert shd.opt_state_specs(m, {"mlp/wi": (16, 32), "w": (6, 32)}) == \
        {"mlp/wi": Spec("data", "model"), "w": Spec(None, "data")}
    assert shd.cache_specs(m, {"k": (8, 16, 64, 5, 32),
                               "s1": (8, 16, 64, 8, 16),
                               "s2": (8, 16, 50, 8, 16)}) == \
        {"k": Spec(None, "data", "model", None, None),
         "s1": Spec(None, "data", "model", None, None),
         "s2": Spec(None, "data", None, "model", None)}


def test_batch_shardings_put_rows_on_the_data_axes():
    two = Grid.at_rank(0, 1, 2, 2, "cpu", lm=True)
    pods = Grid.at_rank(0, 2, 2, 2, "cpu", lm=True)
    batch = {"tokens": torch.zeros(8, 16), "labels": (8, 16),
             "odd": torch.zeros(3, 16)}
    assert batch_shardings(two, batch) == {"tokens": Spec("data", None),
                                           "labels": Spec("data", None),
                                           "odd": Spec(None, None)}
    assert batch_shardings(pods, batch)["tokens"] == \
        Spec(("pod", "data"), None)
    rows = shd.shard_batch(Grid.at_rank(7, 2, 2, 2, "cpu", lm=True),
                           {"t": torch.arange(8)})["t"]
    assert rows.tolist() == [6, 7]            # pod 1, data 1: block 3


def test_zero1_puts_data_on_the_layer_stack_at_production_width():
    """At (16, 16) llama3.2-1b's wq moments are ('data', None, 'model'):
    data rank r holds layer r's moments whole (L = 16 over data 16)."""
    cfg = ARCHS["llama3.2-1b"]
    spec = shd.opt_state_specs(MESHES["16x16"], tt.param_shapes(cfg))
    assert spec["layers/attn/wq"] == Spec("data", None, "model")
    grid = Grid.at_rank(5 * 16 + 3, 1, 16, 16, "cpu", lm=True)
    st = state_shardings(grid, cfg)
    assert st.opt.m["layers.7.attn.wq"] == Spec("data", None, "model")
    pl = tt.lm_placement(grid, cfg)
    assert [pl["layers.%d.attn.wq" % i].owner for i in range(16)] == \
        list(range(16))
    assert pl.local_shape("layers.0.attn.wk") == (2048, 32)  # half a head


# ---------------------------------------------------------------------------
# (b) Training against repro's single-device step
# ---------------------------------------------------------------------------

def check_train(cells, ref) -> None:
    for cell in cells:
        np.testing.assert_allclose([h["loss"] for h in cell["hist"]],
                                   ref["losses"], rtol=LOSS_RTOL)
        # the global norm over shards: each distinct part counted once
        np.testing.assert_allclose([h["grad_norm"] for h in cell["hist"]],
                                   ref["grad_norms"], rtol=LOSS_RTOL)
    first = cells[0]["params"]
    assert set(first) == set(ref["final"])
    for name, want in ref["final"].items():
        np.testing.assert_allclose(first[name], want, rtol=0,
                                   atol=2 * LR * STEPS, err_msg=name)


@pytest.mark.parametrize("shape", ["grid22", "grid14", "grid21"])
def test_grid_train_steps_match_repro(shape, refs, request):
    check_train(job(request.getfixturevalue(shape), 0), refs["train"])


def test_grid_train_microbatches_match_repro(refs, grid22):
    """Two microbatches, the fp32 accumulator ZeRO-placed."""
    check_train(job(grid22, 1), refs["train_mb"])


def test_grid_train_heads_not_dividing_the_axis(refs, grid14):
    """6 query heads over a 4-way model axis: queries sequence-sharded,
    K/V whole (constrain_heads's fallback)."""
    check_train(job(grid14, 1), refs["train_six"])


def test_grid_train_runs_collectives_every_step(grid22, grid14):
    for cells in (job(grid22, 0), job(grid14, 0)):
        counts = {tuple(c["collectives"]) for c in cells}
        assert len(counts) == 1            # every rank the same
        assert min(next(iter(counts))) > 0


def test_grid_train_loop_restart_replays_with_global_checkpoints(grid22):
    """train_loop(grid=): a transient fault on every cell at hit 3
    restores step 2 from the global checkpoint and replays, bit for bit;
    the checkpoint holds the global arrays (the single-device layout)."""
    from repro_torch.train.loop import state_tree
    cells = job(grid22, 4)
    model = Transformer(cfg_of("llama3.2-1b"), device="meta")
    named = dict(model.named_parameters())
    for c in cells:
        assert c["fired"] == [3]
        assert [s for s, _ in c["faulty"]] == [0, 1, 2, 2, 3]
        clean = dict(c["clean"])
        assert all(loss == clean[s] for s, loss in c["faulty"])
        assert c["step"] == 4 and c["count"] == 4
    want = {f"params/{n}": tuple(p.shape) for n, p in named.items()}
    want.update({f"opt/{m}/{n}": tuple(p.shape) for n, p in named.items()
                 for m in ("m", "v")})
    want.update({"opt/count": (), "step": ()})
    assert cells[0]["shapes"] == want
    assert set(want) == {
        "/".join(k) for k in _paths(state_tree_shapes(state_tree, named))}


def state_tree_shapes(state_tree, named) -> dict:
    from repro_torch.optim import AdamW
    model = Transformer(cfg_of("llama3.2-1b"), device="meta")
    opt = AdamW().init(dict(model.named_parameters()))
    return state_tree(TrainState(params=model, opt=opt,
                                 step=torch.zeros((), dtype=torch.int64)))


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


# ---------------------------------------------------------------------------
# (c) Decode
# ---------------------------------------------------------------------------

def test_grid_decode_matches_repro_single_device(refs, grid22):
    """yi-9b reduced, 6 decode steps on 2 x 2 from a zero cache:
    tests/multidevice_main.py's check_sharded_decode_matches_single."""
    d = refs["decode"]
    cells = job(grid22, 2)
    for c in cells:
        assert c["cache"] == (2, 2, 8, 2, 16)     # batch / 2, positions / 2
        rows = d["logits"][2 * c["i"]:2 * c["i"] + 2]
        np.testing.assert_allclose(c["logits"], rows, rtol=DECODE_TOL,
                                   atol=DECODE_TOL)
        assert min(c["collectives"]) > 0


@pytest.mark.parametrize("shape,index,arch", [
    ("grid22", 3, "yi-9b"), ("grid14", 3, "llama3.2-1b"),
    ("grid14", 4, "granite-20b")])
def test_grid_prefill_and_decode_match_single_device(shape, index, arch,
                                                     refs, request):
    """The grid prefill (its K/V gathered over "model", each rank's block
    of positions kept) and greedy decode against the port's
    single-device path on the same weights, fed the grid's tokens, and
    the prefill's logits against repro's."""
    import jax.numpy as jnp
    from repro.models import transformer as jt
    cfg = cfg_of(arch)
    params = refs["serve"][arch]
    prompts = refs["prompts"]
    want_pre, _ = jt.prefill(params, jcfg(cfg), {"tokens": jnp.asarray(
        prompts)})
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(convert.lm_params_from_repro(params, cfg, "cpu"))
    cells = job(request.getfixturevalue(shape), index)
    rows_per = prompts.shape[0] // (1 + max(c["i"] for c in cells))
    for c in cells:
        r = slice(c["i"] * rows_per, (c["i"] + 1) * rows_per)
        np.testing.assert_allclose(c["prefill"], np.asarray(want_pre)[r],
                                   rtol=DECODE_TOL, atol=DECODE_TOL)
        logits, filled = model.prefill(torch.from_numpy(prompts[r]).long(),
                                       impl="ref")
        tokens = torch.from_numpy(c["tokens"])
        assert torch.equal(tokens[:, :1], logits.argmax(-1))
        cache = model.extend_cache(filled, prompts.shape[1] + 4)
        scale = np.abs(c["steps"]).max()
        for t in range(4):
            want, cache = model.decode_step(cache, tokens[:, t:t + 1],
                                            prompts.shape[1] + t)
            np.testing.assert_allclose(c["steps"][:, t:t + 1], want.numpy(),
                                       rtol=0, atol=SAME_PATH_TOL * scale)


# ---------------------------------------------------------------------------
# (d) decode_attention(group=) and ef_psum against repro under vmap
# ---------------------------------------------------------------------------

def test_sequence_sharded_decode_attention_matches_repro(refs, grid14):
    import jax
    from repro.models.attention import decode_attention as jdecode
    kk = refs["kernels"]
    n = 4
    ks = kk["k"].reshape(2, n, -1, 2, 16).swapaxes(0, 1)
    vs = kk["v"].reshape(2, n, -1, 2, 16).swapaxes(0, 1)
    cells = job(grid14, 2)
    for p, pos in enumerate(kk["poses"]):
        want = jax.vmap(lambda kc, vc: jdecode(kk["q"], kc, vc, pos,
                                               axis_name="x"),
                        axis_name="x")(ks, vs)
        want = np.asarray(want)
        single = decode_attention(torch.from_numpy(kk["q"]),
                                  torch.from_numpy(kk["k"]),
                                  torch.from_numpy(kk["v"]), pos).numpy()
        scale = np.abs(want).max()
        for r, c in enumerate(cells):
            np.testing.assert_allclose(c["att"][p], want[r], rtol=0,
                                       atol=1e-6 * scale)
            np.testing.assert_allclose(c["att"][p], single, rtol=0,
                                       atol=1e-6 * scale)


def test_ef_psum_matches_repro_exactly(refs, grid14):
    import jax
    import jax.numpy as jnp
    from repro.optim import compression as jcomp
    kk = refs["kernels"]
    mean, err = jax.vmap(lambda g, e: jcomp.ef_psum(g, e, "x"),
                         axis_name="x")(jnp.asarray(kk["g"]),
                                        jnp.asarray(kk["err"]))
    cells = job(grid14, 2)
    for r, c in enumerate(cells):
        assert np.array_equal(c["mean"], np.asarray(mean[r]))
        np.testing.assert_allclose(c["err"], np.asarray(err[r]), rtol=0,
                                   atol=1e-7)
    # the shared scale and the int32 sum, recomputed
    target = kk["g"] + kk["err"]
    scale = np.float32(max(np.abs(target).max(), 1e-12)) / np.float32(127)
    q = np.clip(np.round(target / scale), -127, 127).astype(np.int32)
    np.testing.assert_allclose(cells[0]["mean"],
                               q.sum(0).astype(np.float32) * scale / 4,
                               rtol=1e-6)


def test_ef_psum_on_one_cell_is_compress():
    """On a group of one, ef_psum's mean is the int8 round trip of g +
    err (compression.ef_compress) and its error the same residual."""
    from repro_torch.launch.mesh import make_debug_grid
    grid = make_debug_grid(data=1, model=1, device="cpu")
    try:
        g = torch.randn(64, generator=torch.Generator().manual_seed(0))
        err = 1e-3 * torch.ones(64)
        mean, new_err = compression.ef_psum(g, err, grid, "data")
        c, want_err = compression.ef_compress(g, err)
        assert torch.equal(mean, compression.decompress(c))
        assert torch.equal(new_err, want_err)
        assert grid.collectives == 2
    finally:
        grid.destroy()


# ---------------------------------------------------------------------------
# (e) Guards
# ---------------------------------------------------------------------------

def test_zero1_moments_are_not_replicated_over_data(grid22):
    """2 x 2: every moment whose ZeRO-1 spec has "data" is held by one data
    rank (a layer's, L = 2 over data 2) or split between them (embed,
    final_norm); each rank holds about half of its model block's
    moments."""
    cfg = cfg_of("llama3.2-1b")
    cells = job(grid22, 0)
    grid = Grid.at_rank(0, 1, 2, 2, "cpu", lm=True)
    pl = tt.lm_placement(grid, cfg)
    local = {n: int(np.prod(pl.local_shape(n))) for n in pl.params}
    for j in (0, 1):
        col = [c for c in cells if c["j"] == j]
        held = {}
        for c in col:
            for n, shape in c["moments"].items():
                held.setdefault(n, []).append(int(np.prod(shape)))
        for n, pp in pl.params.items():
            assert sum(held.get(n, [])) == local[n], n
            if pl.data_sharded(n):
                assert all(x < local[n] for x in held[n]) or \
                    len(held[n]) == 1, n
        total = sum(8 * x for x in local.values())
        for c in col:
            assert abs(c["moment_bytes"] - total / 2) <= 0.1 * total
    assert {pl[f"layers.{i}.attn.wq"].owner for i in range(2)} == {0, 1}


def test_mesh_flags_refuse_outside_a_torchrun_world(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for argv, need in ((["--mesh", "pod"], 256),
                       (["--mesh", "multipod"], 512)):
        with pytest.raises(ValueError, match=f"torchrun world of {need}"):
            train_cli.main(["--arch", "llama3.2-1b", "--reduced",
                            "--device", "cpu", *argv])
        with pytest.raises(ValueError, match=f"torchrun world of {need}"):
            decode_demo.main(["--arch", "llama3.2-1b", "--reduced",
                              "--device", "cpu", *argv])


def test_unplaced_model_and_indivisible_cache_are_refused():
    cfg = cfg_of("llama3.2-1b")
    grid = Grid.at_rank(1, 1, 1, 2, "cpu", lm=True)
    model = Transformer(cfg, device="cpu")
    with pytest.raises(ValueError, match="params_shardings"):
        GridTransformer(model, grid)
    params_shardings(grid, model)
    gm = GridTransformer(model, grid)
    assert gm.plan.heads_local and gm.plan.kv_local
    assert gm.init_cache(4, 16)["k"].shape == (2, 4, 8, 2, 16)
    with pytest.raises(ValueError, match="multiple of the model axis"):
        gm.init_cache(4, 15)
    # cache_shardings places a global cache as init_cache's blocks
    full = {n: torch.arange(2 * 4 * 16 * 2 * 16, dtype=torch.float32)
            .reshape(2, 4, 16, 2, 16) for n in ("k", "v")}
    placed = shd.cache_shardings(grid, full)
    assert torch.equal(placed["k"], full["k"][:, :, 8:])
    assert placed["v"].shape == gm.init_cache(4, 16)["v"].shape


def test_lm_grid_takes_any_shape_and_the_rescal_grid_stays_square():
    g = Grid.at_rank(5, 2, 1, 3, "cpu", lm=True)
    assert (g.pod, g.i, g.j) == (1, 0, 2)
    assert g.axis_index("batch") == 1 and g.axis_size("batch") == 2
    assert g.mesh.axis_names == ("pod", "data", "model")
    with pytest.raises(ValueError, match="square"):
        Grid.at_rank(0, 1, 1, 3, "cpu")
    assert shd.group_ranks(2, 1, 3, lm=True)[-3:] == [
        ("batch", [0, 3]), ("batch", [1, 4]), ("batch", [2, 5])]
