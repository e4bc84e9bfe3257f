"""The port's LM serving path against repro: configs, layers, attention,
the dense decoder (forward, prefill, decode), accounting and the decode
demo CLI.

Inputs are drawn with numpy from a seed and go through both packages;
model parameters are repro's ``init_params(PRNGKey(0), cfg)`` carried
over by ``convert.lm_params_from_repro``.  ``jax`` and ``repro`` are
imported inside the tests only.  On the CPU ``chunked_attention`` runs
its plain chunked path (the CUDA kernel runs on the card:
tests/test_torch_gpu.py, chip_smoke.py).

Tolerances, with their reasons:
  * fp32: rtol 1e-5 (as the sweep's functions are held) with an atol of
    1e-5 of the largest |value|: sums of the same terms in another order
    (XLA's dot and the MKL/oneDNN products round differently), and
    cos/sin of angles up to 4096 rad one ulp apart between the two
    libraries.
  * bf16: rtol and atol 2e-2 of the largest |value| (a few bf16 ulps,
    2^-8 each): both sides round every product and activation to bf16,
    but accumulate in different orders, so an element can land one
    rounding step away and the step carries through the layers.
  * ref_attention against repro's interpret-mode Pallas kernel: 2e-4,
    the tolerance repro's own kernel tests use.
"""
import argparse
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import (ARCHS, REDUCED_ARCHS, SHAPES, get_config,
                                 reduced)
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.launch import decode_demo
from repro_torch.models import layers as tl
from repro_torch.models import model as tm
from repro_torch.models.attention import chunked_attention, decode_attention
from repro_torch.models.transformer import Transformer
from repro_torch.train import decode_loop, make_prefill_step, make_serve_step

F32_TOL = 1e-5
BF16_TOL = 2e-2
DTYPES = ("float32", "bfloat16")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: several test workers share the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def tol(dtype: str) -> float:
    return F32_TOL if dtype == "float32" else BF16_TOL


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


def both(x: np.ndarray, dtype: str):
    """The same array for jax and for torch, in ``dtype``."""
    import jax.numpy as jnp
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return jnp.asarray(x, dtype=jnp.float32).astype(dtype), \
        t.to(getattr(torch, dtype))


def randn(rng, *shape) -> np.ndarray:
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ARCHS))
def test_configs_match_repro(name):
    from repro.configs import ARCHS as JARCHS
    from repro.configs import REDUCED_ARCHS as JREDUCED
    from repro.configs import SHAPES as JSHAPES
    for ours, theirs in ((ARCHS[name], JARCHS[name]),
                         (REDUCED_ARCHS[name], JREDUCED[name]),
                         (reduced(ARCHS[name], dtype="bfloat16"),
                          dataclasses.replace(JREDUCED[name],
                                              dtype="bfloat16"))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.padded_vocab == theirs.padded_vocab
        for s in SHAPES:
            assert ours.supports(SHAPES[s]) == theirs.supports(JSHAPES[s])
    assert get_config(name) is ARCHS[name]
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}


def test_get_config_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_matches_repro(dtype):
    from repro.models import layers as jl
    rng = np.random.default_rng(0)
    jx, tx = both(3 * randn(rng, 2, 5, 64), dtype)
    jw, tw = both(1 + randn(rng, 64) / 4, dtype)
    close(tl.rmsnorm(tx, tw), jl.rmsnorm(jx, jw), tol(dtype))
    assert tl.rmsnorm(tx, tw).dtype == tx.dtype


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("theta,d", [(10000.0, 16), (500000.0, 64),
                                     (500000.0, 128)])
def test_apply_rope_matches_repro_at_long_positions(dtype, theta, d):
    """Positions up to 4096 (the card's prompt length): angles of up to
    4096 rad, where an ulp in the frequencies would show."""
    import jax.numpy as jnp
    from repro.models import layers as jl
    np.testing.assert_array_equal(tl.rope_freqs(d, theta).numpy(),
                                  np.asarray(jl.rope_freqs(d, theta)))
    rng = np.random.default_rng(1)
    pos = np.stack([np.arange(0, 4097, 64), np.arange(4096, -1, -64)])
    jx, tx = both(randn(rng, 2, pos.shape[1], 3, d), dtype)
    got = tl.apply_rope(tx, torch.from_numpy(pos), theta)
    close(got, jl.apply_rope(jx, jnp.asarray(pos), theta), tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gated", [True, False])
def test_mlp_matches_repro(dtype, gated):
    from repro.models import layers as jl
    rng = np.random.default_rng(2)
    d, f = 64, 128
    jx, tx = both(randn(rng, 2, 7, d), dtype)
    ws = {"wi": randn(rng, d, f) / 8, "wo": randn(rng, f, d) / 11}
    if gated:
        ws["wg"] = randn(rng, d, f) / 8
    mod = (tl.MLP if gated else tl.MLP2)(d, f, getattr(torch, dtype), "cpu")
    jp = {}
    for name, w in ws.items():
        jp[name], tw = both(w, dtype)
        getattr(mod, name).data.copy_(tw)
    apply = jl.mlp_apply if gated else jl.mlp2_apply
    with torch.no_grad():
        close(mod(tx), apply(jp, jx), tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_embed_and_tied_unembed_match_repro(dtype):
    import jax.numpy as jnp
    from repro.models import layers as jl
    rng = np.random.default_rng(3)
    jt, tt = both(randn(rng, 256, 32) * 0.02, dtype)
    tokens = rng.integers(0, 256, (2, 9))
    x = tl.embed(tt, torch.from_numpy(tokens))
    jx = jl.embed_apply({"table": jt}, jnp.asarray(tokens))
    close(x, jx, 0.0)
    close(tl.unembed(tt, x), jl.unembed_apply({"table": jt}, jx), tol(dtype))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def qkv_bshd(rng, b, sq, skv, hq, hkv, d):
    return (randn(rng, b, sq, hq, d), randn(rng, b, skv, hkv, d),
            randn(rng, b, skv, hkv, d))


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (5, 1)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_offset", [0, 64])
def test_chunked_attention_plain_matches_repro(hq, hkv, causal, q_offset):
    from repro.models.attention import chunked_attention as jchunked
    rng = np.random.default_rng(hq * 10 + hkv)
    q, k, v = qkv_bshd(rng, 2, 64, 64 + q_offset, hq, hkv, 16)
    (jq, tq), (jk, tk), (jv, tv) = (both(x, "float32") for x in (q, k, v))
    kw = dict(causal=causal, q_offset=q_offset, chunk=32, q_chunk=16)
    got = chunked_attention(tq, tk, tv, impl="ref", **kw)
    close(got, jchunked(jq, jk, jv, **kw), F32_TOL)
    close(chunked_attention(tq, tk, tv, **kw), got, 0.0)   # auto on CPU


@pytest.mark.parametrize("d", [16, 64, 128])
def test_chunked_attention_bf16_matches_repro(d):
    """bf16: q times the scale in bf16, p cast to bf16 for p @ v, as
    repro; d = 128's scale is not a power of two."""
    from repro.models.attention import chunked_attention as jchunked
    rng = np.random.default_rng(d)
    q, k, v = qkv_bshd(rng, 2, 128, 128, 8, 2, d)
    (jq, tq), (jk, tk), (jv, tv) = (both(x, "bfloat16") for x in (q, k, v))
    kw = dict(causal=True, chunk=64, q_chunk=32)
    got = chunked_attention(tq, tk, tv, **kw)
    assert got.dtype == torch.bfloat16
    close(got, jchunked(jq, jk, jv, **kw), BF16_TOL)


# repro's tests/test_kernels.py TestFlashAttention shapes (q, k, v as
# (b, h, s, d)): GQA causal and not, the continuation offset, and the
# hypothesis test's (sq, skv, d) corners
KERNEL_CASES = ([(2, hq, hkv, 128, 128, 32, causal, 0)
                 for hq, hkv in ((4, 4), (8, 2), (5, 1))
                 for causal in (True, False)]
                + [(1, 2, 2, 64, 128, 32, True, 64)]
                + [(1, 2, 2, sq, skv, d, False, 0)
                   for sq, skv, d in ((64, 128, 16), (128, 64, 64))])


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,q_offset", KERNEL_CASES)
def test_ref_attention_matches_repro_ref_and_pallas_interpret(
        b, hq, hkv, sq, skv, d, causal, q_offset):
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    rng = np.random.default_rng(sq + skv + d)
    q, k, v = (randn(rng, b, hq, sq, d), randn(rng, b, hkv, skv, d),
               randn(rng, b, hkv, skv, d))
    (jq, tq), (jk, tk), (jv, tv) = (both(x, "float32") for x in (q, k, v))
    kw = dict(causal=causal, q_offset=q_offset)
    got = tref.ref_attention(tq, tk, tv, **kw)
    close(got, jref.ref_attention(jq, jk, jv, **kw), F32_TOL)
    pallas = jops.flash_attention(jq, jk, jv, impl="interpret", bq=64, bk=64,
                                  **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("sq,skv,q_offset", [(1, 37, 0), (37, 37, 0),
                                             (37, 100, 63), (200, 200, 0),
                                             (100, 300, 200)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_chunked_attention_matches_ref_attention_on_ragged_tails(
        sq, skv, q_offset, dtype):
    """The port's two plain versions, on lengths no tile divides: the
    chunked online softmax (tiles 16 x 32) and the materializing softmax,
    reached through the kernel wrapper and ops on CPU tensors."""
    rng = np.random.default_rng(sq * skv)
    q, k, v = qkv_bshd(rng, 2, sq, skv, 6, 2, 32)
    _, tq = both(q, dtype)
    _, tk = both(k, dtype)
    _, tv = both(v, dtype)
    kw = dict(causal=True, q_offset=q_offset)
    got = chunked_attention(tq, tk, tv, chunk=32, q_chunk=16, **kw)
    perm = (tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2))
    want = tref.ref_attention(*perm, **kw).transpose(1, 2)
    close(got, want.float(), tol(dtype))
    ops.reset_launch_counts()
    for got in (tflash.flash_attention(*perm, **kw),
                ops.flash_attention(*perm, impl="auto", **kw)):
        close(got.transpose(1, 2), want.float(), 0.0)
    assert ops.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pos", [1, 5, 16])
def test_decode_attention_matches_repro(dtype, pos):
    import jax.numpy as jnp
    from repro.models.attention import decode_attention as jdecode
    rng = np.random.default_rng(pos)
    q = randn(rng, 2, 1, 8, 16)
    kc, vc = randn(rng, 2, 16, 2, 16), randn(rng, 2, 16, 2, 16)
    (jq, tq), (jk, tk), (jv, tv) = (both(x, dtype) for x in (q, kc, vc))
    got = decode_attention(tq, tk, tv, pos)
    close(got, jdecode(jq, jk, jv, jnp.int32(pos)), tol(dtype))


def test_kernel_call_checks(tmp_path):
    """The kernel's limits, checked before any launch (so reachable on the
    CPU); on a CUDA device these raise ValueError from the wrapper."""
    def t(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)
    q, kv = t(1, 4, 8, 64), t(1, 2, 8, 64)
    tflash.Call(q, kv, kv, 0)
    bad = [((t(1, 4, 8, 24), t(1, 2, 8, 24), t(1, 2, 8, 24)), 0, "head dim"),
           ((q, kv, kv), -1, "q_offset"),
           ((q, t(1, 3, 8, 64), t(1, 3, 8, 64)), 0, "disagree"),
           ((q.half(), kv.half(), kv.half()), 0, "float32 or all bfloat16"),
           ((q, kv.bfloat16(), kv), 0, "float32 or all bfloat16"),
           ((t(1, 4, 8, 128)[..., ::2], kv, kv), 0, "unit stride"),
           ((q, t(1, 2, 0, 64), t(1, 2, 0, 64)), 0, "no keys")]
    for args, q_offset, msg in bad:
        with pytest.raises(ValueError, match=msg):
            tflash.Call(*args, q_offset)
    with pytest.raises(ValueError, match="CUDA"):
        tflash.Call(q, kv, kv, 0).require_cuda(q, kv, kv)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.flash_attention(q, kv, kv, impl="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        chunked_attention(q.transpose(1, 2), kv.transpose(1, 2),
                          kv.transpose(1, 2), impl="cuda")


@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "sm90_bf16"),
                                           (torch.float32, "fma_fp32")])
def test_kernel_variant_follows_dtype(dtype, variant):
    """bf16 calls go to the tensor-core kernel, fp32 calls to the FMA
    kernel: a choice by dtype in the wrapper.  CPU tensors run the plain
    version and count no launch of either."""
    q, kv = (torch.zeros((1, h, 8, 64), dtype=dtype) for h in (4, 2))
    assert tflash.Call(q, kv, kv, 0).variant == variant
    tflash.reset_launch_count()
    tflash.flash_attention(q, kv, kv)
    assert tflash.launch_count_by_variant() == {"sm90_bf16": 0,
                                                "fma_fp32": 0}
    assert tflash.launch_count() == 0


def strided(strides, dtype=torch.bfloat16, offset=0, shape=(2, 4, 8, 64)):
    """A (b, h, s, d) view of a flat buffer with the given strides."""
    buf = torch.zeros(offset + 8 * 4 * 8 * 272, dtype=dtype)
    return buf.as_strided(shape, strides, offset)


# (b, h, s, d) strides of a (B, S, H, D) view, then one flaw each: the
# base 2 bytes past alignment; s, h or b strides of 520, 136, 4104 bytes
TMA_CASES = [(dict(strides=(2048, 64, 256, 1), offset=1), "base address"),
             (dict(strides=(2080, 64, 260, 1)), "s stride 260"),
             (dict(strides=(2176, 68, 272, 1)), "h stride 68"),
             (dict(strides=(2052, 64, 256, 1)), "b stride 2052")]


@pytest.mark.parametrize("kwargs,msg", TMA_CASES)
@pytest.mark.parametrize("which", ["q", "k"])
def test_bf16_call_refuses_what_tma_cannot_read(kwargs, msg, which):
    """The bf16 kernel reads q, k and v by TMA: a 16-byte aligned base and
    b, h, s strides of whole 16 bytes, checked by Call before any launch
    (so here, without a card).  The fp32 kernel has no such limit."""
    good = strided((2048, 64, 256, 1))
    bad = strided(**kwargs)
    args = (bad, good, good) if which == "q" else (good, bad, good)
    with pytest.raises(ValueError, match=f"{which}'s {msg}"):
        tflash.Call(*args, 0)
    assert tflash.Call(*(x.float() for x in args), 0).variant == "fma_fp32"
    # an axis of length 1 takes any stride
    one = strided((7, 64, 256, 1), shape=(1, 4, 8, 64))
    tflash.Call(one, one, one, 0)


# ---------------------------------------------------------------------------
# The dense decoder
# ---------------------------------------------------------------------------

B, S, STEPS = 2, 32, 8


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


MODEL_CASES = [("llama3.2-1b", "float32"), ("llama3.2-1b", "bfloat16"),
               ("yi-9b", "float32"), ("granite-20b", "float32")]


@pytest.mark.parametrize("name,dtype", MODEL_CASES)
def test_reduced_model_matches_repro(name, dtype):
    """forward logits, prefill logits and cache, then STEPS decode steps
    from that cache fed the same tokens, all against repro."""
    import jax.numpy as jnp
    from repro.models import transformer as jt
    cfg = reduced(ARCHS[name], dtype=dtype)
    params, model = models(cfg)
    t = tol(dtype)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (B, S + STEPS))
    prompt, tprompt = jnp.asarray(toks[:, :S]), torch.from_numpy(toks[:, :S])

    with torch.no_grad():
        logits, aux = model(tprompt)
    jlogits, _ = jt.forward(params, cfg, {"tokens": prompt})
    close(logits, jlogits, t)
    assert logits.shape == (B, S, cfg.padded_vocab) and float(aux) == 0.0

    last, cache = make_prefill_step(model)(tprompt)
    jlast, jcache = jt.prefill(params, cfg, {"tokens": prompt})
    close(last, jlast, t)
    for name_ in ("k", "v"):
        close(cache[name_], jcache[name_], t)

    full = model.init_cache(B, S + STEPS)
    jfull = jt.init_cache(cfg, B, S + STEPS)
    for name_ in ("k", "v"):
        full[name_][:, :, :S] = cache[name_]
        jfull[name_] = jfull[name_].at[:, :, :S].set(jcache[name_])
    step = make_serve_step(model)
    for i in range(STEPS):
        pos = S + i
        tok = toks[:, pos:pos + 1]
        got, full = step(full, torch.from_numpy(tok), pos)
        want, jfull = jt.decode_step(params, cfg, jfull, jnp.asarray(tok),
                                     jnp.int32(pos))
        close(got, want, t)
    for name_ in ("k", "v"):
        close(full[name_], jfull[name_], t)


def test_prefill_then_stepwise_decode_equals_forward():
    """repro's tests/test_models.py TestDecodeConsistency on the port:
    prefill + stepwise decode reproduce the full-sequence forward."""
    cfg = REDUCED_ARCHS["llama3.2-1b"]
    gen = torch.Generator().manual_seed(0)
    model = Transformer(cfg, device="cpu", gen=gen)
    toks = torch.randint(0, cfg.vocab, (B, 8), generator=gen)
    with torch.no_grad():
        full, _ = model(toks)
    last, _ = model.prefill(toks)
    close(last[:, 0], full[:, -1].numpy(), F32_TOL)
    cache = model.init_cache(B, 16)
    outs = []
    for i in range(8):
        lg, cache = model.decode_step(cache, toks[:, i:i + 1], i)
        outs.append(lg[:, 0])
    close(torch.stack(outs, dim=1), full.numpy(), F32_TOL)


def test_decode_loop_tokens_match_repro():
    import jax.numpy as jnp
    from repro.models import transformer as jt
    from repro.train import decode_loop as jdecode_loop
    cfg = REDUCED_ARCHS["llama3.2-1b"]
    params, model = models(cfg)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (B, 12))
    first = toks[:, -1:]
    jcache = jt.init_cache(cfg, B, 32)
    jcache = {n: c.at[:, :, :11].set(jt.prefill(
        params, cfg, {"tokens": jnp.asarray(toks[:, :11])})[1][n])
        for n, c in jcache.items()}
    cache = model.init_cache(B, 32)
    _, filled = model.prefill(torch.from_numpy(toks[:, :11]))
    for n in cache:
        cache[n][:, :, :11] = filled[n]
    want, _ = jdecode_loop(cfg, params, jcache, jnp.asarray(first), 11, 12)
    got, _ = decode_loop(model, cache, torch.from_numpy(first), 11, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_sample_masks_padded_vocab():
    logits = torch.tensor([[[0.0, 1.0, 5.0, 2.0]]])
    assert tm.greedy_sample(logits).item() == 2
    assert tm.greedy_sample(logits, vocab=2).item() == 1


def test_init_from_generator_is_seeded_and_scaled():
    cfg = REDUCED_ARCHS["granite-20b"]
    a = Transformer(cfg, device="cpu", gen=torch.Generator().manual_seed(3))
    b = Transformer(cfg, device="cpu", gen=torch.Generator().manual_seed(3))
    for (name, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), name
    d = cfg.d_model
    assert abs(float(a.layers[0].attn.wq.std()) - d ** -0.5) < 0.1 * d ** -0.5
    assert abs(float(a.embed.std()) - 0.02) < 0.002
    assert torch.equal(a.layers[1].ln2, torch.ones(d))


@pytest.mark.parametrize("name", ["mamba2-1.3b", "deepseek-moe-16b",
                                  "hymba-1.5b", "minicpm3-4b",
                                  "whisper-large-v3", "internvl2-26b"])
def test_unported_families_raise(name):
    """Every family of the zoo is ported (tests/test_torch_zoo.py holds
    them to repro): the arch builds and counts; the same arch with a
    family outside the zoo raises."""
    cfg = REDUCED_ARCHS[name]
    Transformer(cfg, device="cpu")
    assert tm.count_params_analytic(ARCHS[name])["total"] > 0
    for bad in (dataclasses.replace(cfg, family="rnn"),
                dataclasses.replace(ARCHS[name], family="rnn")):
        with pytest.raises(ValueError, match="not in the zoo"):
            Transformer(bad, device="cpu")
        with pytest.raises(ValueError, match="not in the zoo"):
            tm.count_params_analytic(bad)


# ---------------------------------------------------------------------------
# Accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["llama3.2-1b", "yi-9b", "granite-20b",
                                  "deepseek-moe-16b", "granite-moe-3b-a800m",
                                  "minicpm3-4b", "mamba2-1.3b", "hymba-1.5b",
                                  "whisper-large-v3", "internvl2-26b"])
def test_accounting_matches_repro(name):
    from repro.configs import ARCHS as JARCHS
    from repro.configs import SHAPES as JSHAPES
    from repro.models import model as jm
    cfg = ARCHS[name]
    assert tm.count_params_analytic(cfg) == \
        jm.count_params_analytic(JARCHS[name])
    for s in SHAPES:
        assert tm.model_flops(cfg, SHAPES[s]) == \
            jm.model_flops(JARCHS[name], JSHAPES[s])
    if name == "llama3.2-1b":
        assert tm.count_params_analytic(cfg)["total"] == 1_235_746_816


def test_count_params_matches_repro():
    import jax
    from repro.models import model as jm
    from repro.models import transformer as jt
    cfg = REDUCED_ARCHS["yi-9b"]
    params = jt.init_params(jax.random.PRNGKey(0), cfg)
    assert tm.count_params(Transformer(cfg, device="cpu")) == \
        jm.count_params(params)


# ---------------------------------------------------------------------------
# The decode demo CLI
# ---------------------------------------------------------------------------

def test_decode_demo_runs_on_cpu(capsys):
    res = decode_demo.main(["--device", "cpu", "--arch", "llama3.2-1b",
                            "--reduced", "--batch", "2", "--prompt-len",
                            "8", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "prefill 2x8:" in out and "decode: 4 steps x 2 seqs" in out
    assert "flash_attention launches in the prefill: 0" in out
    assert res.tokens.shape == (2, 5) and res.step_logits.shape[:2] == (2, 4)
    assert int(res.tokens.max()) < REDUCED_ARCHS["llama3.2-1b"].vocab
    assert res.flash_launches == 0 and res.peak_bytes is None
    # the same decode through the serving library
    cache = res.model.init_cache(2, 12)
    _, filled = res.model.prefill(res.prompts)
    for n in cache:
        cache[n][:, :, :8] = filled[n]
    again, _ = decode_loop(res.model, cache, res.tokens[:, :1], 8, 4)
    assert torch.equal(again, res.tokens)


def test_decode_demo_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default runs there")
    with pytest.raises(RuntimeError, match="--device cpu"):
        decode_demo.main(["--arch", "llama3.2-1b", "--reduced"])


def repro_demo_parser(monkeypatch):
    """repro's decode_demo builds its parser inside main(): capture it at
    parse_args."""
    from repro.launch import decode_demo as jdemo

    class Captured(Exception):
        pass

    def capture(self, *a, **k):
        raise Captured(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Captured) as exc:
        jdemo.main()
    monkeypatch.undo()
    return exc.value.args[0]


def test_decode_demo_flags_match_repro(monkeypatch):
    theirs = {a.dest: a for a in repro_demo_parser(monkeypatch)._actions}
    mine = {a.dest: a for a in decode_demo.build_parser()._actions}
    for dest in ("arch", "reduced", "batch", "prompt_len", "new_tokens",
                 "mesh"):
        assert mine[dest].default == theirs[dest].default, dest
        assert mine[dest].required == theirs[dest].required, dest
    assert list(mine["arch"].choices) == list(theirs["arch"].choices)
    assert list(mine["mesh"].choices) == list(theirs["mesh"].choices)
    assert mine["device"].default == "cuda"


def test_decode_demo_unported_arch_raises():
    """The token-only server refuses enc-dec and VLM, as repro's (every
    decoder-only family runs: tests/test_torch_zoo.py)."""
    with pytest.raises(SystemExit, match="decoder-only"):
        decode_demo.main(["--device", "cpu", "--arch", "internvl2-26b",
                          "--reduced"])
    with pytest.raises(SystemExit, match="decoder-only"):
        decode_demo.main(["--device", "cpu", "--arch", "whisper-large-v3",
                          "--reduced"])
