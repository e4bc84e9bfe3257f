"""The port's BCSR kernels: plain versions against repro's, dispatch rules
and the wrappers' argument checks.

On the CPU the wrappers run their plain versions (kernels/ref.py), held
here against ``repro.kernels.ref`` at rtol 1e-5.  The CUDA kernels against
their plain versions on a card: ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparse as jsp
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import sparse as tsp
from repro_torch.kernels import _build, bcsr_fused, bcsr_spmm, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.policy import KernelPolicy

RTOL = 1e-5

# (n, bs, block density, k): bs | n; bs not dividing n; empty block rows
CASES = [(64, 16, 0.4, 3), (70, 16, 0.4, 4), (96, 16, 0.05, 5)]


def make(seed, n, bs, density, m=2):
    rng = np.random.default_rng(seed)
    nb = -(-n // bs)
    keep = rng.random((nb, nb)) < density
    keep[nb - 1, 0] = True
    rows, cols = np.nonzero(keep)
    data = rng.random((m, rows.shape[0], bs, bs), dtype=np.float32)
    mask = (np.arange(nb * bs) < n).astype(np.float32).reshape(nb, bs)
    data *= mask[rows][None, :, :, None] * mask[cols][None, :, None, :]
    j = jsp.BCSR(data=jnp.asarray(data),
                 block_rows=jnp.asarray(rows, jnp.int32),
                 block_cols=jnp.asarray(cols, jnp.int32), n=n)
    return j, rng


def close(a, b):
    a, b = convert.to_numpy(a), np.asarray(b)
    assert a.shape == b.shape
    scale = max(float(np.abs(b).max()), 1e-30)
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("n,bs,density,k", CASES)
def test_ref_bcsr_xa_xta_matches_repro(n, bs, density, k):
    j, rng = make(0, n, bs, density)
    B1 = rng.random((n, k), dtype=np.float32)
    B2 = rng.random((n, k), dtype=np.float32)
    rxa, rxt = jref.ref_bcsr_xa_xta(j, jnp.asarray(B1), jnp.asarray(B2))
    t = convert.bcsr(j, device="cpu")
    xa, xt = tref.ref_bcsr_xa_xta(t, torch.from_numpy(B1),
                                  torch.from_numpy(B2))
    close(xa, rxa)
    close(xt, rxt)


@pytest.mark.parametrize("n,bs,density,k", CASES)
def test_ref_bcsr_spmm_matches_repro(n, bs, density, k):
    j, rng = make(1, n, bs, density)
    B = rng.random((n, k), dtype=np.float32)
    t = convert.bcsr(j, device="cpu")
    close(tref.ref_bcsr_spmm(t, torch.from_numpy(B)),
          jref.ref_bcsr_spmm(j, jnp.asarray(B)))


def test_empty_block_rows_and_cols_are_exact_zero():
    j, rng = make(2, 96, 16, 0.05)
    t = convert.bcsr(j, device="cpu")
    B = torch.from_numpy(rng.random((96, 3), dtype=np.float32))
    xa, xt = tref.ref_bcsr_xa_xta(t, B, B)
    rows = set(np.asarray(j.block_rows).tolist())
    cols = set(np.asarray(j.block_cols).tolist())
    for i in range(t.nblocks):
        sl = slice(i * 16, (i + 1) * 16)
        assert bool((xa[:, sl] == 0).all()) == (i not in rows)
        assert bool((xt[:, sl] == 0).all()) == (i not in cols)


def test_nnzb_zero_gives_zeros():
    t = tsp.BCSR(data=torch.zeros((2, 0, 32, 32)),
                 block_rows=torch.zeros(0, dtype=torch.int32),
                 block_cols=torch.zeros(0, dtype=torch.int32), n=50)
    B = torch.rand(3, 50, 4)            # member-batched operand
    xa, xt = ops.bcsr_xa_xta(t, B, B)
    assert xa.shape == xt.shape == (3, 2, 50, 4)
    assert not xa.any() and not xt.any()
    assert not ops.bcsr_spmm(t, B).any()


def test_member_batched_plain_versions():
    """Data (r, m, ...) and operands (r, n, k): member q of the result is
    the single-member product."""
    j, rng = make(3, 70, 16, 0.4)
    t = convert.bcsr(j, device="cpu")
    data = torch.stack([t.data, 2 * t.data])
    B = torch.from_numpy(rng.random((2, 70, 4), dtype=np.float32))
    xa, xt = tref.ref_bcsr_xa_xta(t.with_data(data), B, B)
    for q in range(2):
        sq = t.with_data(data[q])
        close(xa[q], tsp.spmm(sq, B[q]))
        close(xt[q], tsp.spmm_t(sq, B[q]))


def test_cpu_dispatch_uses_plain_version_and_counts_nothing():
    j, rng = make(4, 64, 16, 0.4)
    t = convert.bcsr(j, device="cpu")
    B = torch.from_numpy(rng.random((64, 3), dtype=np.float32))
    ops.reset_launch_counts()
    for impl in ("auto", "ref"):
        xa, xt = ops.bcsr_xa_xta(t, B, B, impl=impl)
        close(xa, tsp.spmm(t, B))
        close(xt, tsp.spmm_t(t, B))
        close(ops.bcsr_spmm(t, B, impl=impl), tsp.spmm(t, B))
    xa, xt = bcsr_fused.bcsr_xa_xta(t, B, B)      # the wrappers themselves
    close(xt, tsp.spmm_t(t, B))
    close(bcsr_spmm.bcsr_spmm(t, B), tsp.spmm(t, B))
    assert ops.launch_counts() == {"bcsr_xa_xta": 0, "bcsr_spmm": 0}


@pytest.mark.parametrize("kernel", ["bcsr_xa_xta", "bcsr_spmm"])
def test_cuda_impl_on_cpu_tensor_raises(kernel):
    j, rng = make(5, 64, 16, 0.4)
    t = convert.bcsr(j, device="cpu")
    B = torch.from_numpy(rng.random((64, 3), dtype=np.float32))
    args = (t, B, B) if kernel == "bcsr_xa_xta" else (t, B)
    with pytest.raises(ValueError, match="impl='cuda'"):
        getattr(ops, kernel)(*args, impl="cuda")


def test_policy_rejects_unknown_impl():
    with pytest.raises(ValueError, match="impl"):
        KernelPolicy(impl="pallas")


def test_build_is_keyed_by_sources(tmp_path, monkeypatch):
    """Both kernels' sources are compiled, and an edit to any source —
    the shared header included — gives a new build directory
    (test_torch_cli checks that importing builds nothing)."""
    names = {p.name for p in _build.sources()}
    assert names == {"bcsr_spmm.cu", "bcsr_fused.cu"}
    assert set(_build.SIGNATURES) == {"repro_bcsr_spmm",
                                      "repro_bcsr_xa_xta"}
    for src in _build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._digest()
    assert before == _build._digest()
    with open(tmp_path / "bcsr_tile.cuh", "a") as f:
        f.write("\n")
    assert _build._digest() != before


def _launch_args(*, k=4, bs=32, dtype=torch.float32, operand_members=None,
                 transpose=False):
    rng = np.random.default_rng(9)
    t = tsp.random_bcsr(rng, m=2, n=70, bs=bs, block_density=0.5,
                        device="cpu")
    shape = (70, k) if operand_members is None else (operand_members, 70, k)
    B = torch.rand(shape, dtype=dtype)
    if transpose:
        B = B.transpose(-1, -2).contiguous().transpose(-1, -2)
    return t, B


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(k=65), ValueError, "rank k=65"),
    (dict(bs=16), ValueError, "block size 16"),
    (dict(dtype=torch.float64), TypeError, "float32"),
    (dict(transpose=True), ValueError, "contiguous"),
    (dict(), ValueError, "one CUDA device"),
])
@pytest.mark.parametrize("kernel", ["bcsr_xa_xta", "bcsr_spmm"])
def test_wrapper_checks_reject_what_the_kernels_cannot_take(kernel, kwargs,
                                                            error, match):
    """The checks a CUDA launch passes first: the shared-memory layout's
    limits (k <= 64, bs a multiple of 32 up to 128), float32, contiguity,
    and every tensor on one CUDA device."""
    from repro_torch.kernels._launch import Launch
    t, B = _launch_args(**kwargs)
    operands = (B, B) if kernel == "bcsr_xa_xta" else (B,)
    with pytest.raises(error, match=match):
        Launch(kernel, t, *operands)


def test_wrapper_rejects_mismatched_member_counts():
    from repro_torch.kernels._launch import Launch
    t, B = _launch_args(operand_members=3)
    t2 = t.with_data(torch.stack([t.data, t.data]))
    with pytest.raises(ValueError, match="2 members, operands 3"):
        Launch("bcsr_spmm", t2, B)
