"""The port's LM training path against repro: the loss, AdamW and
clipping, int8 compression, the token stream, the train step (with
microbatches and remat), the fault-tolerant loop, the launcher, and the
guard that keeps gradients off the attention kernel.

The model is ``REDUCED_ARCHS["llama3.2-1b"]`` (fp32) holding repro's
``init_params(PRNGKey(0), cfg)`` (``convert.lm_params_from_repro``), and
both packages train on repro's own ``batch_at`` batches (the port's
stream draws other numbers from a seed).  ``jax`` and ``repro`` are
imported inside the tests only.

Tolerances, with their reasons:
  * loss and CE: rtol 1e-5 (fp32 sums of the same terms in another
    order, as tests/test_torch_lm.py holds the forward).
  * gradients (before the optimizer): rtol 1e-4 of each tensor's
    largest |value|: the backward sums over the batch, the heads and the
    vocab in another order than XLA's.
  * AdamW alone on identical inputs: rtol 1e-6 (one or two fp32
    roundings apart: the port scales the moments in place).
  * the loss over 3 train steps: rtol 1e-4.  Step 1's AdamW update is
    about +-lr * sign(g) wherever |g| >> eps, so a near-zero gradient
    whose sign flips with the summation order moves its parameter by
    2 * lr; the parameters after the steps are held at atol 2 * lr *
    steps, and the share of elements farther than 1e-5 apart is
    reported.
  * compression: repro's own bounds (round trip within 0.51 scale; the
    error feedback exact to rtol 1e-4, atol 1e-5), and the int8 payload
    and scale equal to repro's on the same input.
  * remat against no remat, and a replayed restart against the
    uninterrupted run: bit for bit (the same operations recomputed on
    the CPU).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import ARCHS, REDUCED_ARCHS, reduced
from repro_torch.data import TokenStreamConfig, batch_at, shard_batch_at
from repro_torch.data import stream as token_stream
from repro_torch.kernels import ops
from repro_torch.launch import train as train_cli
from repro_torch.models import model as tm
from repro_torch.models.attention import chunked_attention
from repro_torch.models.transformer import Transformer
from repro_torch.optim import (AdamW, apply_updates, clip_by_global_norm,
                               compression, global_norm)
from repro_torch.resilience import (DeterministicFault, FaultPlan, FaultSpec,
                                    faults)
from repro_torch.train import (LoopConfig, TrainState, init_state,
                               make_train_step, train_loop)

ARCH = "llama3.2-1b"
CFG = REDUCED_ARCHS[ARCH]
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
ADAMW_TOL = 1e-6
TRAJ_TOL = 1e-4
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: several test workers share the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jcfg(cfg):
    """repro's config with the same values as the port's ``cfg``."""
    from repro.configs import REDUCED_ARCHS as JREDUCED
    from repro.configs.base import ArchConfig
    return ArchConfig(**{**dataclasses.asdict(JREDUCED[ARCH]),
                         **dataclasses.asdict(cfg)})


def models(cfg=CFG):
    """repro's parameters (PRNGKey(0)) and the port's model holding
    them."""
    import jax
    from repro.models import transformer as jt
    params = jt.init_params(jax.random.PRNGKey(0), jcfg(cfg))
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(convert.lm_params_from_repro(params, cfg,
                                                       device="cpu"))
    return params, model


def repro_batch(cfg, batch: int, seq: int, step: int = 0, seed: int = 0):
    """repro's batch_at batch, as jax arrays and as torch int64."""
    from repro.data import TokenStreamConfig as JStream
    from repro.data import batch_at as jbatch_at
    jb = jbatch_at(JStream(vocab=cfg.vocab, batch=batch, seq=seq,
                           seed=seed), step)
    return jb, {k: torch.from_numpy(np.array(v)).long()
                for k, v in jb.items()}


def named(tree, cfg=CFG) -> dict:
    """A repro params-shaped pytree under the port's parameter names."""
    return convert.lm_params_from_repro(tree, cfg, device="cpu")


def close_scaled(got, want, t: float) -> None:
    """|got - want| <= t * max |want| (each tensor's own scale)."""
    got = convert.to_numpy(got.float() if torch.is_tensor(got) else got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=t * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# The loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_padded_vocab_and_ignore_match_repro(dtype):
    import jax.numpy as jnp
    from repro.models.model import cross_entropy as jce
    rng = np.random.default_rng(0)
    vocab, vpad = 300, 512
    logits = (3 * rng.standard_normal((2, 7, vpad))).astype(np.float32)
    logits[..., vocab:] += 50.0       # padded ids would win if unmasked
    labels = rng.integers(0, vocab, (2, 7))
    labels[0, :3] = tm.IGNORE
    jl = jnp.asarray(logits).astype(dtype)
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    ce, n = tm.cross_entropy(tl, torch.from_numpy(labels), vocab)
    jce_, jn = jce(jl, jnp.asarray(labels), vocab)
    assert int(n) == int(jn) == 11
    assert ce.dtype == torch.float32
    np.testing.assert_allclose(float(ce), float(jce_), rtol=LOSS_TOL)
    none = torch.full((2, 7), tm.IGNORE)
    ce0, n0 = tm.cross_entropy(tl, none, vocab)
    assert float(ce0) == 0.0 and int(n0) == 1     # repro's max(n, 1)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("vocab", [512, 500])
def test_loss_fn_matches_repro(remat, vocab):
    """vocab 500 pads to 512: the padded logits are masked in both."""
    from repro.models.model import loss_fn as jloss_fn
    cfg = reduced(ARCHS[ARCH], vocab=vocab)
    params, model = models(cfg)
    jb, tb = repro_batch(cfg, 2, 64)
    jloss, jm = jloss_fn(params, jcfg(cfg), jb, remat=remat)
    loss, m = tm.loss_fn(model, cfg, tb, remat=remat)
    assert loss.requires_grad
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(float(m["ce"]), float(jm["ce"]),
                               rtol=LOSS_TOL)
    assert float(m["aux"]) == float(jm["aux"]) == 0.0
    assert int(m["tokens"]) == int(jm["tokens"]) == 2 * 64


def test_grads_match_repro_over_two_query_tiles():
    """seq 512: two 256-row query tiles of the chunked attention, so the
    backward runs through the online softmax's rescaling."""
    import jax
    from repro.models.model import loss_fn as jloss_fn
    params, model = models()
    jb, tb = repro_batch(CFG, 2, 512)
    jgrads = jax.grad(lambda p: jloss_fn(p, jcfg(CFG), jb)[0])(params)
    loss, _ = tm.loss_fn(model, CFG, tb)
    names, tensors = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, tensors)))
    want = named(jgrads)
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert float(g.abs().max()) > 0, name
        close_scaled(g, convert.to_numpy(want[name]), GRAD_TOL)


def test_remat_equals_no_remat_bit_for_bit():
    _, model = models()
    _, tb = repro_batch(CFG, 2, 64)
    names, tensors = zip(*model.named_parameters())
    out = []
    for remat in (False, True):
        loss, _ = tm.loss_fn(model, CFG, tb, remat=remat)
        out.append((loss.detach(), torch.autograd.grad(loss, tensors)))
    assert torch.equal(out[0][0], out[1][0])
    for name, a, b in zip(names, out[0][1], out[1][1]):
        assert torch.equal(a, b), name


# ---------------------------------------------------------------------------
# The grad guard: no gradient through a kernel without a backward
# ---------------------------------------------------------------------------

def _qkv(requires_grad: bool):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(1, 8, 2, 16, generator=g,
                        requires_grad=requires_grad) for _ in range(3)]


@pytest.mark.parametrize("call", ["chunked", "ops"])
def test_kernel_route_refuses_grad_before_the_device_check(call):
    q, k, v = _qkv(True)
    if call == "chunked":
        run = lambda: chunked_attention(q, k, v, impl="cuda")
    else:
        run = lambda: ops.flash_attention(q.transpose(1, 2),
                                          k.transpose(1, 2),
                                          v.transpose(1, 2), impl="cuda")
    with pytest.raises(RuntimeError, match='impl="ref"'):
        run()
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        run()               # no grad: the device check speaks
    with pytest.raises(ValueError, match="CUDA"):
        q2, k2, v2 = _qkv(False)
        chunked_attention(q2, k2, v2, impl="cuda")


def test_model_forward_on_kernel_route_refuses_grad():
    _, model = models()
    tokens = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(RuntimeError, match="no backward"):
        model(tokens, impl="cuda")


def test_training_forward_gives_attention_projections_grads():
    """loss_fn runs the plain chunked path, so wq, wk and wv of every
    layer get non-zero gradients, and no kernel launches."""
    _, model = models()
    _, tb = repro_batch(CFG, 2, 32)
    ops.reset_launch_counts()
    loss, _ = tm.loss_fn(model, CFG, tb)
    loss.backward()
    for blk in model.layers:
        for w in (blk.attn.wq, blk.attn.wk, blk.attn.wv):
            assert w.grad is not None and float(w.grad.abs().max()) > 0
    assert ops.launch_counts()["flash_attention"] == 0


# ---------------------------------------------------------------------------
# AdamW and clipping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_matches_repro_on_identical_inputs(dtype, weight_decay):
    """Three updates on the same params, grads and moments; bf16
    parameters keep fp32 moments and take bf16 updates, as in repro."""
    import jax.numpy as jnp
    from repro.optim import AdamW as JAdamW
    from repro.optim import apply_updates as japply
    rng = np.random.default_rng(1)
    shapes = {"a": (5, 7), "b": (11,)}
    p = {n: rng.standard_normal(s).astype(np.float32)
         for n, s in shapes.items()}
    jopt = JAdamW(lr=1e-2, weight_decay=weight_decay)
    topt = AdamW(lr=1e-2, weight_decay=weight_decay)
    jp = {n: jnp.asarray(x).astype(dtype) for n, x in p.items()}
    tp = {n: torch.from_numpy(x).to(getattr(torch, dtype))
          for n, x in p.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    assert all(x.dtype == torch.float32 for x in ts.m.values())
    for step in range(3):
        g = {n: rng.standard_normal(s).astype(np.float32)
             for n, s in shapes.items()}
        ju, js = jopt.update({n: jnp.asarray(x).astype(dtype)
                              for n, x in g.items()}, js, jp)
        tu, ts = topt.update({n: torch.from_numpy(x).to(getattr(torch,
                                                                dtype))
                              for n, x in g.items()}, ts, tp)
        assert int(ts.count) == int(js.count) == step + 1
        for n in shapes:
            assert tu[n].dtype == tp[n].dtype
            for got, want in ((ts.m[n], js.m[n]), (ts.v[n], js.v[n])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=ADAMW_TOL, atol=1e-12)
            np.testing.assert_allclose(
                tu[n].float().numpy(),
                np.asarray(ju[n]).astype(np.float32),
                rtol=ADAMW_TOL if dtype == "float32" else 2 ** -8)
        jp, tp = japply(jp, ju), apply_updates(tp, tu)


def test_adamw_properties():
    """repro's tests/test_optim.py: convergence on a quadratic, weight
    decay pulls to zero."""
    opt = AdamW(lr=0.1)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(200):
        updates, state = opt.update({"w": 2 * params["w"]}, state, params)
        params = apply_updates(params, updates)
    assert float(params["w"].abs().max()) < 1e-2
    opt = AdamW(lr=0.05, weight_decay=0.5)
    params = {"w": torch.tensor([1.0])}
    state = opt.init(params)
    for _ in range(100):
        updates, state = opt.update({"w": torch.zeros(1)}, state, params)
        params = apply_updates(params, updates)
    assert abs(float(params["w"][0])) < 0.1


def test_clip_by_global_norm_matches_repro():
    import jax.numpy as jnp
    from repro.optim import clip_by_global_norm as jclip
    tree = {"a": torch.full((4,), 3.0), "b": torch.full((4,), 4.0)}
    clipped, norm = clip_by_global_norm(tree, 1.0)
    assert abs(float(norm) - 10.0) < 1e-4
    assert abs(float(global_norm(clipped)) - 1.0) < 1e-4
    rng = np.random.default_rng(2)
    x = {"a": rng.standard_normal((3, 5)).astype(np.float32),
         "b": rng.standard_normal(9).astype(np.float32)}
    for max_norm in (0.5, 100.0):
        jc, jn = jclip({k: jnp.asarray(v) for k, v in x.items()}, max_norm)
        tc, tn = clip_by_global_norm({k: torch.from_numpy(v)
                                      for k, v in x.items()}, max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=ADAMW_TOL)
        for k in x:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       rtol=ADAMW_TOL)
    bf = {"w": torch.ones(4, dtype=torch.bfloat16) * 3}
    assert clip_by_global_norm(bf, 1.0)[0]["w"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------

def test_compress_matches_repro_and_round_trips():
    import jax.numpy as jnp
    from repro.optim import compression as jcomp
    x = np.random.default_rng(3).standard_normal(1000).astype(np.float32)
    c = compression.compress(torch.from_numpy(x))
    jc = jcomp.compress(jnp.asarray(x))
    assert c.q.dtype == torch.int8
    np.testing.assert_array_equal(c.q.numpy(), np.asarray(jc.q))
    assert float(c.scale) == float(jc.scale)
    err = np.abs(compression.decompress(c).numpy() - x)
    assert err.max() <= float(c.scale) * 0.51 + 1e-6
    assert compression.decompress(c, torch.bfloat16).dtype == torch.bfloat16


def test_error_feedback_accumulates_exactly():
    """Sum of decompressed updates + final error == sum of raw grads."""
    g = torch.Generator().manual_seed(4)
    err = compression.init_error({"w": torch.zeros(256)})["w"]
    sent, true = torch.zeros(256), torch.zeros(256)
    for _ in range(20):
        grad = torch.randn(256, generator=g) * 0.1
        c, err = compression.ef_compress(grad, err)
        sent += compression.decompress(c)
        true += grad
    np.testing.assert_allclose((sent + err).numpy(), true.numpy(),
                               rtol=1e-4, atol=1e-5)


def test_ef_compress_matches_repro():
    import jax.numpy as jnp
    from repro.optim import compression as jcomp
    rng = np.random.default_rng(5)
    gr = rng.standard_normal(300).astype(np.float32)
    er = (rng.standard_normal(300) * 1e-3).astype(np.float32)
    c, e = compression.ef_compress(torch.from_numpy(gr), torch.from_numpy(er))
    jc, je = jcomp.ef_compress(jnp.asarray(gr), jnp.asarray(er))
    np.testing.assert_array_equal(c.q.numpy(), np.asarray(jc.q))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))


# ---------------------------------------------------------------------------
# The token stream
# ---------------------------------------------------------------------------

def test_token_stream_is_a_pure_function_of_seed_and_step():
    ds = TokenStreamConfig(vocab=512, batch=4, seq=33, seed=3)
    a, b = batch_at(ds, 7), batch_at(ds, 7)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(batch_at(ds, 8)["tokens"], a["tokens"])
    other = dataclasses.replace(ds, seed=4)
    assert not torch.equal(batch_at(other, 7)["tokens"], a["tokens"])
    it = token_stream(ds, start_step=7)
    assert torch.equal(next(it)["tokens"], a["tokens"])
    assert torch.equal(next(it)["tokens"], batch_at(ds, 8)["tokens"])
    halves = [shard_batch_at(ds, 7, i, 2) for i in range(2)]
    for k in a:
        assert torch.equal(torch.cat([h[k] for h in halves]), a[k])


def test_token_stream_structure_matches_repro():
    """The same recipe as repro's stream: labels are the tokens shifted
    by one, every odd position of the drawn sequence is its predecessor
    + 1 mod V, the marginal is Zipf (rank 0 the most frequent)."""
    from repro.data import TokenStreamConfig as JStream
    from repro.data import batch_at as jbatch_at
    V = 512
    ds = TokenStreamConfig(vocab=V, batch=8, seq=256)
    for b in (batch_at(ds, 0),
              {k: torch.from_numpy(np.array(v)).long()
               for k, v in jbatch_at(JStream(vocab=V, batch=8, seq=256),
                                     0).items()}):
        tok, lbl = b["tokens"], b["labels"]
        assert tok.shape == lbl.shape == (8, 256)
        assert torch.equal(tok[:, 1:], lbl[:, :-1])
        full = torch.cat([tok, lbl[:, -1:]], dim=1)
        assert torch.equal(full[:, 1::2], (full[:, 0::2][:, :128] + 1) % V)
        drawn = full[:, 0::2]
        assert int(drawn.min()) >= 0 and int(drawn.max()) < V
        counts = torch.bincount(drawn.reshape(-1), minlength=V)
        assert int(counts.argmax()) == 0
        assert float(counts[:8].sum()) > 0.3 * drawn.numel()


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def port_state(params, cfg=CFG, lr=LR):
    opt = AdamW(lr=lr)
    state = init_state(cfg, opt, generator=torch.Generator().manual_seed(9),
                       device="cpu")
    state.params.load_state_dict(named(params, cfg))
    return opt, state


@pytest.mark.parametrize("microbatches", [1, 2])
def test_three_train_steps_match_repro(microbatches):
    import jax
    from repro.optim import AdamW as JAdamW
    from repro.train.train_step import init_state as jinit
    from repro.train.train_step import make_train_step as jmake
    params, _ = models()
    jopt = JAdamW(lr=LR)
    jstate = jinit(jax.random.PRNGKey(0), jcfg(CFG), jopt)
    jstep = jmake(jcfg(CFG), None, optimizer=jopt, remat=False,
                  donate=False, microbatches=microbatches)
    opt, state = port_state(params)
    step = make_train_step(CFG, optimizer=opt, remat=False,
                           microbatches=microbatches)
    steps = 3
    for s in range(steps):
        jb, tb = repro_batch(CFG, 4, 32, step=s)
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, tb)
        for key in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=TRAJ_TOL, err_msg=f"{key} {s}")
        assert int(m["tokens"]) == int(jm["tokens"]) == 4 * 32
    assert int(state.step) == int(jstate.step) == steps
    assert int(state.opt.count) == int(jstate.opt.count) == steps
    want = named(jstate.params)
    far = total = 0
    for name, p in state.params.named_parameters():
        diff = np.abs(p.detach().numpy() - convert.to_numpy(want[name]))
        assert diff.max() <= 2 * LR * steps, name
        far += int((diff > 1e-5).sum())
        total += diff.size
    print(f"[train parity] mb={microbatches}: {far} of {total} parameters "
          f"({far / total:.2%}) more than 1e-5 from repro's")


def test_microbatches_average_the_loss_and_the_grads():
    """Two microbatches of a batch against the whole batch in one: the
    same mean loss and gradient norm (each half holds the same number
    of tokens), within fp32 summation order."""
    params, _ = models()
    _, tb = repro_batch(CFG, 4, 32)
    out = []
    for mb in (1, 2):
        opt, state = port_state(params)
        _, m = make_train_step(CFG, optimizer=opt, remat=True,
                               microbatches=mb)(state, tb)
        out.append(m)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(out[1][key]), float(out[0][key]),
                                   rtol=LOSS_TOL)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(CFG, microbatches=3)(port_state(params)[1], tb)


# ---------------------------------------------------------------------------
# The fault-tolerant loop
# ---------------------------------------------------------------------------

def run_loop(tmp, name, steps=8, save_every=3, plan=None, **kw):
    ds = TokenStreamConfig(vocab=CFG.vocab, batch=2, seq=16, seed=0)
    loop = LoopConfig(steps=steps, save_every=save_every, seed=0,
                      ckpt_dir=None if name is None else str(tmp / name),
                      **kw)
    if plan is None:
        return train_loop(CFG, lambda s: batch_at(ds, s), loop,
                          optimizer=AdamW(lr=LR), remat=False, device="cpu")
    with faults.active(plan):
        return train_loop(CFG, lambda s: batch_at(ds, s), loop,
                          optimizer=AdamW(lr=LR), remat=False, device="cpu")


def losses(history) -> dict:
    return {h["step"]: h["loss"] for h in history}


@pytest.mark.parametrize("async_save", [False, True])
def test_transient_fault_replays_bit_for_bit(tmp_path, async_save):
    """repro's tests/test_fault_tolerance.py contract, bit for bit: hit 5
    of train/step fails once, the loop restores step 3 and replays."""
    from repro_torch import ckpt
    clean_state, clean = run_loop(tmp_path, None, max_restarts=0)
    plan = FaultPlan({"train/step": [
        FaultSpec(kind="raise-transient", at=(5,), message="chaos")]})
    state, hist = run_loop(tmp_path, "faulty", plan=plan, max_restarts=2,
                           async_save=async_save)
    assert [f["hit"] for f in plan.fired] == [5]
    assert [h["step"] for h in hist] == [0, 1, 2, 3, 4, 3, 4, 5, 6, 7]
    assert losses(hist) == losses(clean)
    for (n, a), (_, b) in zip(state.params.named_parameters(),
                              clean_state.params.named_parameters()):
        assert torch.equal(a, b), n
    assert ckpt.latest_step(str(tmp_path / "faulty")) == 8
    assert int(state.step) == 8 and int(state.opt.count) == 8


def test_restart_resumes_from_the_checkpoint_dir(tmp_path):
    """A second loop over the same directory restores the last step and
    runs only the steps after it, to the uninterrupted run's state."""
    _, clean = run_loop(tmp_path, None, steps=6)
    _, first = run_loop(tmp_path, "resume", steps=4, save_every=2)
    state, second = run_loop(tmp_path, "resume", steps=6, save_every=2)
    assert [h["step"] for h in second] == [4, 5]
    assert {**losses(first), **losses(second)} == losses(clean)
    assert int(state.step) == 6


def test_deterministic_fault_raises_at_once(tmp_path):
    plan = FaultPlan({"train/step": [
        FaultSpec(kind="raise-deterministic", at=(2,))]})
    with pytest.raises(DeterministicFault):
        run_loop(tmp_path, "det", plan=plan, max_restarts=3)
    assert [f["hit"] for f in plan.fired] == [2]
    plan = FaultPlan({"train/step": [
        FaultSpec(kind="raise-transient", at=(1,))]})
    with pytest.raises(faults.TransientError):      # no ckpt_dir: no restart
        run_loop(tmp_path, None, plan=plan, max_restarts=3)


def test_train_loop_records_steps_and_stragglers(tmp_path):
    from repro_torch.obs import trace as obs
    tracer = obs.Tracer()
    prev = obs.install(tracer)
    try:
        state, hist = run_loop(tmp_path, None, steps=3)
    finally:
        obs.install(prev)
    assert isinstance(state, TrainState)
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) and h["seconds"] > 0 for h in hist)
    assert {"ce", "aux", "tokens", "loss", "grad_norm",
            "straggler"} <= set(hist[0])
    steps = [r for r in tracer.events if r["name"] == "train/step"]
    assert [r["args"]["step"] for r in steps] == [0, 1, 2]
    assert steps[0]["args"]["loss"] == hist[0]["loss"]


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_launch_train_reduced_on_cpu(capsys, tmp_path):
    hist = train_cli.main(["--arch", ARCH, "--reduced", "--steps", "12",
                           "--device", "cpu", "--ckpt-dir",
                           str(tmp_path / "ck"), "--save-every", "5"])
    out = capsys.readouterr().out
    assert out.startswith(f"train {CFG.name}: ")
    assert "M params, mesh=none" in out
    assert "[train] step=0 loss=" in out and "[train] step=10 " in out
    assert "done: loss " in out
    assert len(hist) == 12
    first = np.mean([h["loss"] for h in hist[:4]])
    last = np.mean([h["loss"] for h in hist[-4:]])
    assert last < first


@pytest.mark.parametrize("argv,err", [
    (["--arch", ARCH, "--reduced", "--mesh", "pod"], ValueError),
    (["--arch", "whisper-large-v3", "--reduced"], SystemExit),
    (["--arch", "internvl2-26b", "--reduced"], SystemExit),
])
def test_launch_train_refusals(argv, err):
    with pytest.raises(err):
        train_cli.main(argv + ["--steps", "1", "--device", "cpu"])
