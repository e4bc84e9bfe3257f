"""The RESCAL side's last public names in the port, against repro:
``select_k``, ``reconstruct``, the sanitizer's ``check_factors`` /
``last_failure`` / ``reset_failures``, the custom ``member_runner`` loop
of ``rescalk`` and ``trade_like``.

The sweeps run on repro's draws (``ArrayDraws`` filled from repro's
member keys, tests/test_torch_dense.py's ``repro_draws``), except where
a test says it runs on the port's own (``TorchDraws``).  ``jax`` and
``repro`` are imported inside the tests only.

Tolerances: ``reconstruct`` rtol 1e-6 (one einsum of the same products
in another order); the sweeps' per-k s_min / s_mean / rel_err rtol and
atol 1e-4 and member errors rtol 1e-3, as tests/test_torch_dense.py
holds the scheduler's sweeps (fp32 MU iterations summed in another
order); the sanitizer's messages character for character.
"""
import numpy as np
import pytest
import torch

from repro_torch.analysis import sanitizer as tsan
from repro_torch.core.rescal import RescalState, reconstruct
from repro_torch.core.rescalk import default_member_runner, rescalk, select_k
from repro_torch.data import trade_like
from repro_torch.selection import RescalkConfig

from test_torch_dense import jcfg, planted_dense, repro_draws, t, tcfg


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: several test workers share the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# select_k and reconstruct
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ks,s,e,thr,want", [
    # repro's tests/test_rescalk.py: the largest stable k, and the
    # stability x fit fallback when no k is stable
    ([2, 3, 4, 5], [0.99, 0.98, 0.97, 0.3], [0.5, 0.2, 0.05, 0.04], 0.75,
     4),
    ([2, 3], [0.5, 0.4], [0.4, 0.1], 0.9, 3),
])
def test_select_k_matches_repro(ks, s, e, thr, want):
    from repro.core import select_k as jselect_k
    got = select_k(ks, np.array(s), np.array(e), sil_threshold=thr)
    assert got == want == jselect_k(ks, np.array(s), np.array(e),
                                    sil_threshold=thr)


def test_reconstruct_matches_repro():
    import jax.numpy as jnp
    from repro.core import reconstruct as jreconstruct
    rng = np.random.default_rng(0)
    A = rng.uniform(size=(9, 3)).astype(np.float32)
    R = rng.uniform(size=(4, 3, 3)).astype(np.float32)
    got = reconstruct(t(A), t(R))
    assert got.shape == (4, 9, 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jreconstruct(jnp.asarray(A), jnp.asarray(R))), rtol=1e-6)


# ---------------------------------------------------------------------------
# The sanitizer
# ---------------------------------------------------------------------------

def _factor_cases():
    rng = np.random.default_rng(1)
    A = rng.uniform(size=(2, 6, 4)).astype(np.float32)
    R = rng.uniform(size=(2, 3, 4, 4)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], np.float32)
    A_ok = A * mask[:, None, :]
    R_ok = R * (mask[:, :, None] * mask[:, None, :])[:, None]
    nan_a = A.copy()
    nan_a[1, 2, 3] = np.nan
    nan_a[0, 4, 0] = np.inf
    neg_r = R.copy()
    neg_r[0, 1, 2, 2] = -0.25
    neg_r[1, 0, 0, 1] = -3.0
    return {
        "clean": (A, R, None),
        "clean-masked": (A_ok, R_ok, mask),
        "non-finite": (nan_a, R, None),
        "negative": (A, neg_r, None),
        "masked": (A, R, mask),
        "all": (nan_a, neg_r, mask),
    }


@pytest.mark.parametrize("case", sorted(_factor_cases()))
def test_check_factors_messages_match_repro(case):
    from repro.analysis import sanitizer as jsan
    A, R, mask = _factor_cases()[case]
    msgs = []
    for mod, conv in ((jsan, np.asarray), (tsan, torch.from_numpy)):
        mod.reset_failures()
        args = (conv(A), conv(R)) + (() if mask is None else
                                     (conv(mask),))
        try:
            mod.check_factors(*args, where="unit_k3")
            msgs.append(None)
        except mod.FactorSanitizerError as err:
            msgs.append(str(err))
            assert mod.last_failure() == str(err)
    assert msgs[0] == msgs[1]
    assert (msgs[1] is None) == case.startswith("clean")
    tsan.reset_failures()
    assert tsan.last_failure() is None


def test_sanitize_state_reports_through_check_factors():
    A, R, mask = _factor_cases()["masked"]
    tsan.reset_failures()
    got = tsan.sanitize_state(t(A), t(R), where="off", mask=t(mask))
    assert got[0].shape == A.shape                  # off: no check
    assert tsan.last_failure() is None
    with pytest.raises(tsan.FactorSanitizerError,
                       match=r"^\[sanitizer:mu_step\] A has \d+ non-zero"):
        tsan.sanitize_state(t(A), t(R), where="mu_step", mask=t(mask),
                            enabled=True)
    assert tsan.last_failure().startswith("[sanitizer:mu_step]")
    tsan.reset_failures()


# ---------------------------------------------------------------------------
# The custom member_runner loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("init", ["random", "nndsvd"])
def test_custom_runner_loop_matches_repro(init):
    """repro's legacy loop with a runner that wraps its default, against
    the port's with a runner that wraps the port's default, on repro's
    draws: each runner sees every member of every rank once."""
    import jax.numpy as jnp
    from repro.core import rescalk as jrescalk
    from repro.core.rescalk import default_member_runner as jdefault
    X = planted_dense()
    jc = jcfg(init=init)
    seen = {"repro": [], "port": []}

    def jrunner(X_q, k, key, cfg):
        seen["repro"].append(k)
        return jdefault(X_q, k, key, cfg)

    def trunner(X_q, k, generator, cfg, init=None):
        assert isinstance(generator, torch.Generator)
        seen["port"].append(k)
        return default_member_runner(X_q, k, generator, cfg, init=init)

    ref = jrescalk(jnp.asarray(X), jc, member_runner=jrunner)
    got = rescalk(t(X), tcfg(init=init), member_runner=trunner,
                  draws=repro_draws(jc, X))
    assert seen["port"] == seen["repro"] == [k for k in jc.ks
                                             for _ in range(4)]
    assert got.k_opt == ref.k_opt
    for name in ("s_min", "s_mean", "rel_err"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=1e-4, atol=1e-4)
    for k in got.ks:
        np.testing.assert_allclose(got.per_k[k].member_errors,
                                   ref.per_k[k].member_errors, rtol=1e-3)


def test_custom_runner_loop_equals_loop_mode_bit_for_bit(capsys):
    """On the port's own draws, a wrapping runner gives loop mode's sweep
    exactly: both are the same members and the same reduce_k."""
    X = t(planted_dense())
    cfg = tcfg()
    loop = rescalk(X, cfg, mode="loop")
    got = rescalk(X, cfg, member_runner=lambda *a, **kw:
                  default_member_runner(*a, **kw), verbose=True)
    assert got.k_opt == loop.k_opt
    for name in ("s_min", "s_mean", "rel_err"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(loop, name))
    out = capsys.readouterr().out
    assert out.count("[rescalk] k=") == len(cfg.ks)


def test_default_runner_draws_from_its_generator():
    """Called alone, the runner draws its initial factors from the
    generator: the same generator state gives the same factors."""
    X = t(planted_dense())
    cfg = tcfg(rescal_iters=5)
    runs = [default_member_runner(X, 3, torch.Generator().manual_seed(5),
                                  cfg) for _ in range(2)]
    assert isinstance(runs[0], RescalState)
    assert torch.equal(runs[0].A, runs[1].A)
    assert runs[0].A.shape == (X.shape[1], 3)


@pytest.mark.parametrize("kw", [
    {"mode": "loop"}, {"criterion": "elbow"}, {"ckpt_dir": "/nonexistent"},
    {"grid": object()}, {"n_pods": 2}, {"grid_chunk": 2},
])
def test_custom_runner_refuses_scheduler_options(kw):
    X = t(planted_dense())
    with pytest.raises(ValueError, match="legacy sequential loop"):
        rescalk(X, tcfg(), member_runner=lambda *a, **k: None, **kw)


# ---------------------------------------------------------------------------
# trade_like
# ---------------------------------------------------------------------------

def test_trade_like_follows_repros_recipe():
    X, A, R = trade_like(n=24, m=12, k=3, seed=7, device="cpu")
    assert X.shape == (12, 24, 24) and A.shape == (24, 3)
    assert R.shape == (12, 3, 3)
    assert float(X.min()) > 0 and float(A.min()) >= float(np.float32(0.01))
    ratio = X / reconstruct(A, R)
    assert 0.98 - 1e-6 <= float(ratio.min()) <= float(ratio.max()) \
        <= 1.02 + 1e-6
    growth = R / R[:1]                                     # trade grows
    np.testing.assert_allclose(growth[:, 0, 0].numpy(),
                               np.linspace(0.2, 1.0, 12) / 0.2, rtol=1e-5)
    again = trade_like(n=24, m=12, k=3, seed=7, device="cpu")[0]
    assert torch.equal(X, again)


def test_trade_like_selects_k_on_repros_tensor():
    """repro's tests/test_rescalk.py case on repro's own trade tensor
    (PRNGKey(0)), swept by the port on its own draws: k_opt is the
    planted 3."""
    import jax
    from repro.data.synthetic import trade_like as jtrade_like
    X, _, _ = jtrade_like(jax.random.PRNGKey(0), n=24, m=12, k=3)
    cfg = RescalkConfig(k_min=2, k_max=5, n_perturbations=4,
                        rescal_iters=300, regress_iters=60, seed=2,
                        init="nndsvd")
    res = rescalk(t(X), cfg)
    assert res.k_opt == 3, res.summary()
