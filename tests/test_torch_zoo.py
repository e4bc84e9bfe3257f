"""The port's LM zoo families against repro: MoE (granite-moe-3b-a800m,
deepseek-moe-16b), MLA (minicpm3-4b), SSM (mamba2-1.3b), hybrid
(hymba-1.5b), enc-dec (whisper-large-v3) and VLM (internvl2-26b), each
at its REDUCED_ARCHS miniature in fp32; and their parts on their own:
moe_apply in its three paths, MLA prefill and decode, the SSD scan and
its recurrent step, the Mamba2 mixer, sliding-window, ring and cross
attention, and the hybrid mixer's ring cache.

Inputs are drawn with numpy from a seed and go through both packages;
model parameters are repro's ``init_params(PRNGKey(0), cfg)`` carried
over by ``convert.lm_params_from_repro``.  ``jax`` and ``repro`` are
imported inside the tests only.  On the CPU the attention runs its plain
chunked path; the kernel route's padding (MLA) and its non-causal
cross shape are held here through the kernel's plain version
(``ref_attention``) behind its own argument checks (``Call``), and on
the card in tests/test_torch_gpu.py and chip_smoke.py.

The tolerance, fp32 throughout: rtol 1e-5 with an atol of 1e-5 of the
largest |value| (of each parameter's gradient, for gradients), as
tests/test_torch_lm.py: sums of the same terms in another order.  The
SSD scan and the gradients hold it too (the hybrid's gradients, the
closest, differ by more than 2e-6).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import REDUCED_ARCHS
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.launch import decode_demo
from repro_torch.launch import train as train_cli
from repro_torch.models import attention as tattn
from repro_torch.models import hybrid as thyb
from repro_torch.models import model as tm
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import Transformer, block_type
from repro_torch.train import make_prefill_step, make_serve_step

F32_TOL = 1e-5
ZOO = ["deepseek-moe-16b", "granite-moe-3b-a800m", "minicpm3-4b",
       "mamba2-1.3b", "hymba-1.5b", "whisper-large-v3", "internvl2-26b"]
# the batch: B sequences of S tokens (S = 2 x the hybrid's window), SE
# encoder frames for enc-dec, STEPS decode steps after the prefill
B, S, SE, STEPS = 2, 32, 24, 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: several test workers share the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def close(got, want, t: float) -> None:
    """|got - want| <= t * |want| + t * max |want|, both as float32."""
    if torch.is_tensor(got):
        got = convert.to_numpy(got.float())
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=t, atol=t * scale)


def randn(rng, *shape) -> np.ndarray:
    return rng.standard_normal(shape).astype(np.float32)


def both(x: np.ndarray):
    """The same fp32 array for jax and for torch."""
    import jax.numpy as jnp
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))


def models(cfg):
    """repro's parameters (PRNGKey(0)) and the port's model holding
    them."""
    import jax
    from repro.models import transformer as jt
    params = jt.init_params(jax.random.PRNGKey(0), cfg)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(convert.lm_params_from_repro(params, cfg,
                                                       device="cpu"))
    return params, model


def batches(cfg, seed: int = 7):
    """repro's batch and the port's: tokens (B, S + STEPS) (the prompt is
    the first S), labels, and the family's frames or patches."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + STEPS))
    np_batch = {"tokens": toks[:, :S],
                "labels": rng.integers(0, cfg.vocab, (B, S))}
    if cfg.family == "encdec":
        np_batch["frames"] = randn(rng, B, SE, cfg.d_model)
    if cfg.family == "vlm":
        np_batch["patches"] = randn(rng, B, cfg.n_patches, cfg.d_model)
    jb, tb = {}, {}
    for name, x in np_batch.items():
        jb[name], tb[name] = both(x)
    return toks, jb, tb


def extras(batch: dict) -> dict:
    return {k: v for k, v in batch.items() if k in ("frames", "patches")}


# ---------------------------------------------------------------------------
# The families end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ZOO)
def test_zoo_model_matches_repro(name):
    """forward logits and aux, prefill logits and every cache leaf, then
    STEPS decode steps from that cache fed the same tokens and the
    cache they leave, all against repro."""
    import jax.numpy as jnp
    from repro.models import transformer as jt
    cfg = REDUCED_ARCHS[name]
    params, model = models(cfg)
    t = F32_TOL
    toks, jb, tb = batches(cfg)

    with torch.no_grad():
        logits, aux = model(tb["tokens"], **extras(tb))
    jlogits, jaux = jt.forward(params, cfg, jb)
    close(logits, jlogits, t)
    close(aux, jaux, t)
    assert (float(aux) > 0) == bool(cfg.n_experts)

    last, cache = make_prefill_step(model)(tb["tokens"], **extras(tb))
    jlast, jcache = jt.prefill(params, cfg, jb)
    close(last, jlast, t)
    assert sorted(cache) == sorted(jcache)
    for leaf in cache:
        assert cache[leaf].dtype == getattr(torch, str(jcache[leaf].dtype))
        close(cache[leaf], jcache[leaf], t)

    P = logits.shape[1]                       # S, plus the VLM's patches
    full = model.extend_cache(cache, P + STEPS)
    jfull = jt.init_cache(cfg, B, P + STEPS)
    for leaf, x in jcache.items():
        same = leaf in ("xk", "xv") or x.shape == jfull[leaf].shape
        jfull[leaf] = x if same else jfull[leaf].at[:, :, :P].set(x)
    step = make_serve_step(model)
    for i in range(STEPS):
        tok = toks[:, S + i:S + i + 1]
        got, full = step(full, torch.from_numpy(tok), P + i)
        want, jfull = jt.decode_step(params, cfg, jfull, jnp.asarray(tok),
                                     jnp.int32(P + i))
        close(got, want, t)
    for leaf in full:
        close(full[leaf], jfull[leaf], t)


@pytest.mark.parametrize("name", ZOO)
def test_zoo_loss_and_gradients_match_repro(name):
    """loss_fn (cross-entropy + 0.01 x the MoE aux; the VLM's patch
    positions stripped) and the gradient of every parameter, against
    jax.grad of repro's loss_fn; the experts' wg and wi gradients fused
    as the port's wgi."""
    import jax
    from repro.models import model as jm
    cfg = REDUCED_ARCHS[name]
    params, model = models(cfg)
    _, jb, tb = batches(cfg, seed=8)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jm.loss_fn(p, cfg, jb), has_aux=True)(params)
    loss, metrics = tm.loss_fn(model, cfg, tb)
    close(loss.detach(), jloss, F32_TOL)
    for key in ("ce", "aux"):
        close(metrics[key].detach(), jmetrics[key], F32_TOL)
    assert int(metrics["tokens"]) == int(jmetrics["tokens"])
    names, leaves = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    want = convert.lm_params_from_repro(jgrads, cfg, device="cpu")
    assert sorted(grads) == sorted(want)
    for key, g in grads.items():
        w = convert.to_numpy(want[key])
        np.testing.assert_allclose(convert.to_numpy(g), w, rtol=F32_TOL,
                                   atol=F32_TOL * float(np.abs(w).max()),
                                   err_msg=key)


@pytest.mark.parametrize("name", ZOO + ["llama3.2-1b"])
def test_zoo_param_counts_match_repro(name):
    import jax
    from repro.models import model as jm
    from repro.models import transformer as jt
    cfg = REDUCED_ARCHS[name]
    params = jt.init_params(jax.random.PRNGKey(0), cfg)
    model = Transformer(cfg, device="cpu")
    assert tm.count_params(model) == jm.count_params(params)
    assert tm.count_params_analytic(cfg) == jm.count_params_analytic(cfg)


def test_zoo_init_is_seeded_and_scaled():
    """Drawn from a generator as repro's init_params draws: the router at
    0.02, the experts at 1 / sqrt(d_in), the conv at 0.2, A_log and
    dt_bias zero, D one, the SSM's fp32 leaves fp32 in a bf16 model."""
    cfg = dataclasses.replace(REDUCED_ARCHS["deepseek-moe-16b"],
                              d_model=256)
    a = Transformer(cfg, device="cpu", gen=torch.Generator().manual_seed(3))
    b = Transformer(cfg, device="cpu", gen=torch.Generator().manual_seed(3))
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
    moe = a.layers[0].moe
    assert abs(float(moe.router.detach().std()) - 0.02) < 0.002
    for w, d_in in ((moe.wg, 256), (moe.wi, 256), (moe.wo, cfg.d_ff)):
        assert abs(float(w.detach().std()) - d_in ** -0.5) < \
            0.05 * d_in ** -0.5
    cfg = REDUCED_ARCHS["hymba-1.5b"]
    m = Transformer(dataclasses.replace(cfg, dtype="bfloat16"), device="cpu",
                    gen=torch.Generator().manual_seed(0)).layers[0].mixer.mamba
    assert abs(float(m.conv_w.detach().float().std()) - 0.2) < 0.03
    assert m.A_log.dtype == m.D.dtype == m.dt_bias.dtype == torch.float32
    assert m.in_proj.dtype == torch.bfloat16
    assert not m.A_log.any() and not m.dt_bias.any() and bool(
        (m.D == 1).all())


def test_block_type_refuses_outside_the_zoo():
    cfg = REDUCED_ARCHS["llama3.2-1b"]
    for bad in (dict(family="rnn"), dict(attn_impl="linear")):
        with pytest.raises(ValueError, match="not in the zoo"):
            block_type(dataclasses.replace(cfg, **bad))
    with pytest.raises(ValueError, match="needs frames"):
        Transformer(REDUCED_ARCHS["whisper-large-v3"], device="cpu",
                    gen=torch.Generator().manual_seed(0))(
            torch.zeros((1, 4), dtype=torch.int64))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def moe_pair(rng, d=32, f=48, E=4, n_shared=1, router_bias=None):
    """repro's moe params (moe_init) and the port's MoE holding them."""
    import jax
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    p = jmoe.moe_init(jax.random.PRNGKey(int(rng.integers(1 << 30))), d, f,
                      E, n_shared=n_shared)
    if router_bias is not None:
        p = dict(p, router=p["router"] + jnp.asarray(router_bias))
    mod = tmoe.MoE(d, f, E, 2, n_shared, torch.float32, "cpu")
    state = convert.lm_params_from_repro(
        {"embed": {"table": np.zeros((1, 1))}, "final_norm": np.zeros(1),
         "layers": jax.tree_util.tree_map(lambda x: x[None], {"moe": p})},
        dataclasses.replace(REDUCED_ARCHS["deepseek-moe-16b"], n_layers=1,
                            n_enc_layers=0), device="cpu")
    mod.load_state_dict({k[len("layers.0.moe."):]: v for k, v in state.items()
                         if k.startswith("layers.0.moe.")})
    return p, mod


# a balanced router, one whose offset sends most tokens of moe_input to
# expert 0 (the einsum and scatter paths drop assignments past capacity),
# and a zero router (every prob ties: lax.top_k takes the lower ids)
ROUTERS = {"balanced": None, "skewed": [1.0, 0.0, 0.0, -1.0],
           "tied": "zero"}


def moe_input(rng) -> np.ndarray:
    """(2, 64, 32) tokens of mean 0.5: a router column offset by c adds
    about 16 c to that expert's logit."""
    return randn(rng, 2, 64, 32) + 0.5


@pytest.mark.parametrize("router", sorted(ROUTERS))
@pytest.mark.parametrize("impl", ["einsum", "scatter", "dense"])
def test_moe_apply_matches_repro(impl, router):
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    rng = np.random.default_rng(11)
    bias = ROUTERS[router]
    p, mod = moe_pair(rng, router_bias=None if bias == "zero" else bias)
    if bias == "zero":
        p = dict(p, router=jnp.zeros_like(p["router"]))
        with torch.no_grad():
            mod.router.zero_()
    jx, tx = both(moe_input(rng))
    # the router's choices first: ids, then gates
    jg, jids, jaux = jmoe._router(p, jx.reshape(-1, 32), 2)
    g, ids, aux = tmoe._router(mod, tx.reshape(-1, 32), 2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    close(g.detach(), jg, F32_TOL)
    if bias == "zero":
        assert (ids == torch.tensor([0, 1])).all()
    with torch.no_grad():
        y, aux = tmoe.moe_apply(mod, tx, 2, impl=impl)
    jy, jaux = jmoe.moe_apply(p, jx, 2, impl=impl)
    close(y, jy, F32_TOL)
    close(aux, jaux, F32_TOL)


def test_moe_drops_past_capacity_and_scatter_equals_dense_under_it():
    """The skewed router overflows expert 0 (some of its assignments are
    dropped, so einsum and scatter leave dense); with a capacity factor
    that fits every assignment, scatter equals dense."""
    rng = np.random.default_rng(12)
    _, mod = moe_pair(rng, router_bias=ROUTERS["skewed"])
    x = torch.from_numpy(moe_input(rng))
    with torch.no_grad():
        _, gids, _ = tmoe._router(mod, x.reshape(-1, 32), 2)
        kept = tmoe.slots(gids, 4, 128) < tmoe.capacity(128, 2, 4, 1.25)
        assert 0 < int((~kept).sum()) < kept.numel()
        dense, _ = tmoe.moe_apply(mod, x, 2, impl="dense")
        for impl in ("einsum", "scatter"):
            y, _ = tmoe.moe_apply(mod, x, 2, impl=impl)
            assert not torch.allclose(y, dense, rtol=1e-3, atol=1e-3)
        y, _ = tmoe.moe_apply(mod, x, 2, impl="scatter", capacity_factor=4.0)
        close(y, dense.numpy(), F32_TOL)
    assert tmoe.capacity(4, 6, 64, 1.25) == 8
    assert tmoe.capacity(256, 6, 64, 1.25) == 30
    assert tmoe.tokens_per_group(16384) == 256
    assert tmoe.tokens_per_group(96) == 96
    assert tmoe.tokens_per_group(300) == 4
    with pytest.raises(ValueError, match="moe impl"):
        tmoe.moe_apply(mod, x, 2, impl="grouped")


def test_moe_keeps_one_fused_gate_up_weight():
    """wg and wi are views of wgi (gate columns first): a call copies no
    weight, and the state dict holds wgi alone."""
    mod = tmoe.MoE(16, 24, 4, 2, 0, torch.float32, "cpu")
    assert mod.wg.data_ptr() == mod.wgi.data_ptr()
    assert mod.wi.data_ptr() == mod.wgi.data_ptr() + 24 * 4
    assert sorted(mod.state_dict()) == ["router", "wgi", "wo"]


# ---------------------------------------------------------------------------
# Attention: MLA, sliding window, ring, cross
# ---------------------------------------------------------------------------

MLA = dict(n_heads=4, q_lora=32, kv_lora=16, d_nope=16, d_rope=8, d_v=16,
           rope_theta=10000.0)


def mla_pair(rng, d=64):
    import jax
    from repro.models import attention as ja
    kw = {k: MLA[k] for k in ("q_lora", "kv_lora", "d_nope", "d_rope",
                              "d_v")}
    p = ja.mla_init(jax.random.PRNGKey(int(rng.integers(1 << 30))), d,
                    MLA["n_heads"], **kw)
    mod = tattn.MLAAttention(d, MLA["n_heads"], rope_theta=10000.0,
                             dtype=torch.float32, device="cpu", **kw)
    mod.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in p.items()})
    return p, mod


def test_mla_prefill_and_decode_match_repro():
    import jax.numpy as jnp
    from repro.models import attention as ja
    rng = np.random.default_rng(20)
    p, mod = mla_pair(rng)
    jx, tx = both(randn(rng, 2, 24, 64))
    pos = np.broadcast_to(np.arange(24), (2, 24))
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos.copy())
    kw = {k: MLA[k] for k in ("n_heads", "kv_lora", "d_nope", "d_rope",
                              "d_v")}
    with torch.no_grad():
        out, (c, r) = tattn.mla_prefill(mod, tx, tpos, q_chunk=8)
    jout, (jc, jr) = ja.mla_prefill(p, jx, jpos, q_chunk=8, chunk=8, **kw)
    for got, want in ((out, jout), (c, jc), (r, jr)):
        close(got, want, F32_TOL)
    cc, rc = torch.zeros((2, 30, 16)), torch.zeros((2, 30, 8))
    cc[:, :24], rc[:, :24] = c, r
    jcache = (jnp.zeros((2, 30, 16)).at[:, :24].set(jc),
              jnp.zeros((2, 30, 8)).at[:, :24].set(jr))
    for pos in range(24, 28):
        jx1, tx1 = both(randn(rng, 2, 1, 64))
        with torch.no_grad():
            got = tattn.mla_decode(mod, tx1, pos, cc, rc)
        want, jcache = ja.mla_decode(p, jx1, jnp.int32(pos), jcache, **kw)
        close(got, want, F32_TOL)
    close(cc, jcache[0], F32_TOL)
    close(rc, jcache[1], F32_TOL)


def kernel_stand_in(monkeypatch, calls: list):
    """Route the kernel's calls to its plain version on the CPU, after its
    own argument checks (``Call``) on the views it is given, and record
    each call's (q shape, v shape, causal, sm_scale)."""
    def fake(q, k, v, *, causal=True, q_offset=0, sm_scale=None,
             impl="auto"):
        assert impl == "cuda"
        tflash.Call(q, k, v, q_offset)
        calls.append((tuple(q.shape), tuple(v.shape), causal, sm_scale))
        return tref.ref_attention(q, k, v, causal=causal, q_offset=q_offset,
                                  sm_scale=sm_scale)
    monkeypatch.setattr(ops, "flash_attention", fake)
    monkeypatch.setattr(tattn, "on_kernel", lambda impl, x: impl != "ref")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_prefill_pads_to_a_kernel_head_dim(monkeypatch, dtype):
    """On the kernel's route q and k (24 = 16 + 8 columns) and v (16) go to
    the kernel as zero-padded (B, S, H, 32) buffers with the scale
    24 ** -0.5, which its checks take (in bf16 its TMA strides too): the
    same output as the unpadded plain path (bf16: to 2e-2, the
    tolerance of tests/test_torch_lm.py); heads wider than the kernel's
    128 raise."""
    rng = np.random.default_rng(21)
    _, mod = mla_pair(rng)
    mod.to(dtype)
    x = torch.from_numpy(randn(rng, 2, 24, 64)).to(dtype)
    pos = torch.arange(24).expand(2, 24)
    with torch.no_grad():
        want, _ = tattn.mla_prefill(mod, x, pos, impl="ref")
        calls = []
        kernel_stand_in(monkeypatch, calls)
        got, _ = tattn.mla_prefill(mod, x, pos)
    assert calls == [((2, 4, 24, 32), (2, 4, 24, 32), True, 24 ** -0.5)]
    assert got.dtype == dtype
    close(got, want.float().numpy(),
          F32_TOL if dtype == torch.float32 else 2e-2)
    wide = tattn.MLAAttention(64, 2, q_lora=8, kv_lora=8, d_nope=128,
                              d_rope=8, d_v=16, rope_theta=1e4,
                              dtype=torch.float32, device="cpu")
    wide.init_parameters(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="exceed flash_attention"):
        tattn.mla_prefill(wide, x.float(), pos)


def test_cross_attention_goes_to_the_kernel_non_causal(monkeypatch):
    """Cross attention on the kernel's route: one non-causal call with sq
    != skv on (b, h, s, d) views, equal to the plain path; and repro's
    cross_attention on the same inputs."""
    from repro.models.attention import cross_attention as jcross
    rng = np.random.default_rng(22)
    q, k, v = (randn(rng, 2, 12, 4, 16), randn(rng, 2, 40, 2, 16),
               randn(rng, 2, 40, 2, 16))
    (jq, tq), (jk, tk), (jv, tv) = (both(x) for x in (q, k, v))
    want = tattn.cross_attention(tq, tk, tv, impl="ref")
    close(want, jcross(jq, jk, jv), F32_TOL)
    calls = []
    kernel_stand_in(monkeypatch, calls)
    got = tattn.cross_attention(tq, tk, tv)
    assert calls == [((2, 4, 12, 16), (2, 2, 40, 16), False, None)]
    close(got, want.numpy(), F32_TOL)


@pytest.mark.parametrize("window,chunk", [(16, 8), (5, 8), (24, 16)])
def test_sliding_window_attention_matches_repro(window, chunk):
    from repro.models.attention import sliding_window_attention as jsw
    rng = np.random.default_rng(window)
    q, k, v = (randn(rng, 2, 32, 4, 16), randn(rng, 2, 32, 2, 16),
               randn(rng, 2, 32, 2, 16))
    (jq, tq), (jk, tk), (jv, tv) = (both(x) for x in (q, k, v))
    got = tattn.sliding_window_attention(tq, tk, tv, window=window,
                                         chunk=chunk)
    close(got, jsw(jq, jk, jv, window=window, chunk=chunk), F32_TOL)
    # the window as a mask over the plain softmax
    s = torch.einsum("bqhd,bkhd->bhqk", tq,
                     tk.repeat_interleave(2, dim=2)) / 4.0
    i, j = torch.arange(32)[:, None], torch.arange(32)[None, :]
    s = s.masked_fill(~((j <= i) & (i - j < window)), -torch.inf)
    want = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1),
                        tv.repeat_interleave(2, dim=2))
    close(got, want.numpy(), F32_TOL)
    with pytest.raises(ValueError, match="does not divide"):
        tattn.sliding_window_attention(tq[:, :30], tk[:, :30], tv[:, :30],
                                       window=window, chunk=chunk)


@pytest.mark.parametrize("pos", [0, 3, 15, 16, 37])
def test_ring_decode_attention_matches_repro(pos):
    import jax.numpy as jnp
    from repro.models.attention import ring_decode_attention as jring
    rng = np.random.default_rng(pos)
    q, kr, vr = (randn(rng, 2, 1, 4, 16), randn(rng, 2, 16, 2, 16),
                 randn(rng, 2, 16, 2, 16))
    (jq, tq), (jk, tk), (jv, tv) = (both(x) for x in (q, kr, vr))
    got = tattn.ring_decode_attention(tq, tk, tv, pos, 16)
    close(got, jring(jq, jk, jv, jnp.int32(pos), 16), F32_TOL)


# ---------------------------------------------------------------------------
# SSD and Mamba2
# ---------------------------------------------------------------------------

def ssd_inputs(rng, L=32, H=4, P=8, G=2, N=6):
    x = randn(rng, 2, L, H, P)
    dt = np.log1p(np.exp(randn(rng, 2, L, H))).astype(np.float32)
    A = -np.exp(randn(rng, H) / 2).astype(np.float32)
    return x, dt, A, randn(rng, 2, L, G, N), randn(rng, 2, L, G, N)


@pytest.mark.parametrize("chunk", [8, 32])
def test_ssd_chunked_matches_repro_and_its_recurrence(chunk):
    """The chunked scan against repro's, and against ssd_decode_step run
    position by position from the same initial state."""
    from repro.models import ssm as jssm
    rng = np.random.default_rng(chunk)
    arrays = ssd_inputs(rng)
    h0 = randn(rng, 2, 4, 8, 6)
    (jx, tx), (jdt, tdt), (jA, tA), (jB, tB), (jC, tC), (jh0, th0) = (
        both(a) for a in (*arrays, h0))
    y, h = tssm.ssd_chunked(tx, tdt, tA, tB, tC, chunk=chunk, h0=th0)
    jy, jh = jssm.ssd_chunked(jx, jdt, jA, jB, jC, chunk=chunk, h0=jh0)
    close(y, jy, F32_TOL)
    close(h, jh, F32_TOL)
    state, ys = th0, []
    for t in range(tx.shape[1]):
        yt, state = tssm.ssd_decode_step(state, tx[:, t], tdt[:, t], tA,
                                         tB[:, t], tC[:, t])
        ys.append(yt)
    close(torch.stack(ys, dim=1), y.numpy(), F32_TOL)
    close(state, h.numpy(), F32_TOL)
    jyt, jst = jssm.ssd_decode_step(jh0, jx[:, 0], jdt[:, 0], jA, jB[:, 0],
                                    jC[:, 0])
    yt, st = tssm.ssd_decode_step(th0, tx[:, 0], tdt[:, 0], tA, tB[:, 0],
                                  tC[:, 0])
    close(yt, jyt, F32_TOL)
    close(st, jst, F32_TOL)


def test_mamba2_apply_and_step_match_repro():
    import jax
    from repro.models import ssm as jssm
    kw = dict(state=8, expand=2, headdim=16, groups=1)
    p = jssm.mamba2_init(jax.random.PRNGKey(3), 32, **kw)
    mod = tssm.Mamba2(32, **kw, device="cpu")
    mod.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in p.items()})
    rng = np.random.default_rng(30)
    jx, tx = both(randn(rng, 2, 16, 32))
    with torch.no_grad():
        out, (h, tail) = tssm.mamba2_apply(mod, tx, chunk=8,
                                           return_state=True)
    jout, (jh, jtail) = jssm.mamba2_apply(p, jx, chunk=8, return_state=True,
                                          **kw)
    for got, want in ((out, jout), (h, jh), (tail, jtail)):
        close(got, want, F32_TOL)
    for _ in range(3):
        jy, ty = both(randn(rng, 2, 1, 32))
        with torch.no_grad():
            o, h, tail = tssm.mamba2_step(mod, ty, h, tail)
        jo, jh, jtail = jssm.mamba2_step(p, jy, jh, jtail, **kw)
        for got, want in ((o, jo), (h, jh), (tail, jtail)):
            close(got, want, F32_TOL)
    with pytest.raises(ValueError, match="does not divide"):
        tssm.mamba2_apply(mod, tx[:, :12], chunk=8)


# ---------------------------------------------------------------------------
# The hybrid mixer's ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [8, 32])
def test_hymba_ring_matches_repro(S):
    """The ring cache from a prompt shorter than the window (zero-padded
    slots, masked at warm-up) and from S = 2W (the last W positions,
    aligned: S % W == 0), then decode steps through it."""
    import jax
    import jax.numpy as jnp
    from repro.models import hybrid as jh
    W = 16
    kw = dict(n_heads=4, n_kv=2, head_dim=16, ssm_state=8, ssm_headdim=16)
    p = jh.hymba_init(jax.random.PRNGKey(4), 32, **kw)
    mod = thyb.Hymba(32, window=W, rope_theta=10000.0, device="cpu", **kw)
    state = convert.lm_params_from_repro(
        {"embed": {"table": np.zeros((1, 1))}, "final_norm": np.zeros(1),
         "layers": jax.tree_util.tree_map(lambda x: x[None], {"mixer": p})},
        dataclasses.replace(REDUCED_ARCHS["hymba-1.5b"], n_layers=1),
        device="cpu")
    mod.load_state_dict({k[len("layers.0.mixer."):]: v
                         for k, v in state.items()
                         if k.startswith("layers.0.mixer.")})
    rng = np.random.default_rng(S)
    jx, tx = both(randn(rng, 2, S, 32))
    pos = np.broadcast_to(np.arange(S), (2, S))
    with torch.no_grad():
        out, cache = thyb.hymba_apply(mod, tx, torch.from_numpy(pos.copy()),
                                      return_state=True)
    jout, jcache = jh.hymba_apply(p, jx, jnp.asarray(pos), window=W,
                                  return_state=True, **kw)
    close(out, jout, F32_TOL)
    for leaf in ("k", "v", "ssm", "conv"):
        close(cache[leaf], jcache[leaf], F32_TOL)
    if S < W:
        assert not cache["k"][:, S:].any()
    cache = {k: v.clone() for k, v in cache.items()}
    for t in range(S, S + 3):
        jy, ty = both(randn(rng, 2, 1, 32))
        with torch.no_grad():
            got = thyb.hymba_step(mod, ty, cache, t)
        want, jcache = jh.hymba_step(p, jy, jcache, jnp.int32(t), window=W,
                                     **kw)
        close(got, want, F32_TOL)
    for leaf in ("k", "v", "ssm", "conv"):
        close(cache[leaf], jcache[leaf], F32_TOL)


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["deepseek-moe-16b", "minicpm3-4b",
                                  "mamba2-1.3b", "hymba-1.5b"])
def test_decode_demo_serves_the_family_on_cpu(name, capsys):
    res = decode_demo.main(["--device", "cpu", "--arch", name, "--reduced",
                            "--batch", "2", "--prompt-len", "16",
                            "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "prefill 2x16:" in out and "decode: 3 steps x 2 seqs" in out
    assert res.tokens.shape == (2, 4) and res.flash_launches == 0
    assert res.flash_by_variant == {"sm90_bf16": 0, "fma_fp32": 0}
    assert int(res.tokens.max()) < REDUCED_ARCHS[name].vocab
    # the demo's decode continued the prefill's cache: the same logits as
    # a forward over prompt + tokens
    seq = torch.cat([res.prompts, res.tokens[:, :-1]], dim=1)
    with torch.no_grad():
        full, _ = res.model(seq)
    if not REDUCED_ARCHS[name].n_experts:     # (MoE drops differ by batch)
        close(res.step_logits, full[:, 16:].numpy(), F32_TOL)


@pytest.mark.parametrize("name", ["whisper-large-v3", "internvl2-26b"])
def test_demo_serve_takes_frames_and_patches_on_cpu(name, capsys):
    """decode_demo refuses enc-dec and VLM, as repro's; its ``serve`` on a
    built model takes their frames or patches (the VLM's decode starts
    after them) and continues the prefill's cache."""
    cfg = REDUCED_ARCHS[name]
    gen = torch.Generator().manual_seed(0)
    model = Transformer(cfg, device="cpu", gen=gen)
    prompts = torch.randint(0, cfg.vocab, (2, 12), generator=gen)
    inputs = ({"frames": torch.randn((2, 24, cfg.d_model), generator=gen)}
              if cfg.family == "encdec" else
              {"patches": torch.randn((2, cfg.n_patches, cfg.d_model),
                                      generator=gen)})
    res = decode_demo.serve(model, prompts, 3, **inputs)
    assert "prefill 2x12:" in capsys.readouterr().out
    assert res.start == 12 + (cfg.n_patches if "patches" in inputs else 0)
    seq = torch.cat([prompts, res.tokens[:, :-1]], dim=1)
    with torch.no_grad():
        full, _ = model(seq, **inputs)
    close(res.step_logits, full[:, res.start:].numpy(), F32_TOL)
    close(res.prefill_logits[:, 0], full[:, res.start - 1].numpy(),
          F32_TOL)


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "minicpm3-4b",
                                  "mamba2-1.3b", "hymba-1.5b"])
def test_launch_train_trains_the_family_on_cpu(name, capsys):
    hist = train_cli.main(["--arch", name, "--reduced", "--steps", "6",
                           "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith(f"train {name}-reduced: ")
    assert len(hist) == 6
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in hist)
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_launch_train_picks_repro_moe_impl(monkeypatch):
    """--reduced trains the MoE through "dense", the full widths through
    "scatter" (repro's launcher)."""
    seen = []
    monkeypatch.setattr(train_cli, "train_loop",
                        lambda *a, **k: (seen.append(k["moe_impl"]),
                                         (None, []))[1])
    train_cli.main(["--arch", "deepseek-moe-16b", "--reduced", "--steps",
                    "1", "--device", "cpu"])
    train_cli.main(["--arch", "deepseek-moe-16b", "--steps", "1",
                    "--device", "cpu"])
    assert seen == ["dense", "scatter"]
