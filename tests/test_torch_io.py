"""The port's data layer against ``repro`` on the CPU: ``VirtualSpec``, the
stored-block pattern, the virtual shards, the balanced partition and
``ShardedBCSR``, their manifests, the numpy threefry draws and the
byte ledger.

Inputs are drawn from a seed with numpy, or are ``repro``'s own
``jax.random`` draws handed to the port through ``io.ArraySource``.
Layouts (patterns, permutations, block indices, nnzb, index digests) are
held exactly; values at rtol 1e-6 (fp32 products of k terms in another
order); the manifests' value moments against float64 sums of the same
values at rtol 1e-6, and against ``repro``'s printed ones at rtol 1e-4:
XLA's CPU float32 sum drifts from the float64 sum (8917.6768 against
8917.4784 on the grid-1 spec below, 2.2e-5; the port's 8917.4785).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import io as jio
from repro.core import sparse as jsp
from repro.io import virtual as jv
from repro_torch import convert
from repro_torch import io as tio
from repro_torch.dist.elastic import choose_grid
from repro_torch.io import threefry
from repro_torch.io.virtual import pattern_from_uniforms, shard_pattern

SPECS = [
    "virtual:bcsr:n=256,m=2,k=3,bs=32,density=0.2,grid=2,noise=0.01,seed=7",
    "virtual:bcsr:n=1024,m=2,k=3,bs=32,density=0.08,skew=1.3,seed=0",
    "virtual:bcsr:n=512,m=3,k=4,bs=64,density=0.1,skew=0.7,grid=2,seed=3",
    "virtual:dense:n=48,m=2,k=3,grid=2,seed=1",
    "virtual:dense:n=40,m=2,k=2,noise=0.05,seed=4,correlated=1",
    "virtual:bcsr:n=128,m=1,k=2,bs=16,dtype=float64,seed=2",
]


def pair(s):
    return jio.VirtualSpec.parse(s), tio.VirtualSpec.parse(s)


def repro_source(jspec) -> tio.ArraySource:
    """repro's draws for every shard of a spec: the ground truth, each
    shard's pattern uniforms and noise, as io/virtual.py makes them."""
    A, R = jspec.ground_truth()
    _, _, kp, kn = jspec._keys()
    g = jspec.grid
    uniforms, noise = {}, {}
    for i in range(g):
        for j in range(g):
            lin = i * g + j
            uniforms[(i, j)] = np.array(jax.random.uniform(
                jax.random.fold_in(kp, lin), (jspec.nb_loc, jspec.nb_loc)))
            if jspec.kind == "bcsr":
                shape = (jspec.m, int(jv._shard_pattern(jspec, i, j).sum()),
                         jspec.bs, jspec.bs)
            else:
                shape = (jspec.m, jspec.n_loc, jspec.n_loc)
            noise[(i, j)] = np.array(jax.random.uniform(
                jax.random.fold_in(kn, lin), shape, jspec.jnp_dtype,
                1.0 - jspec.noise, 1.0 + jspec.noise))
    return tio.ArraySource(np.array(A), np.array(R), uniforms, noise)


def close(got, want, rtol=1e-6):
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               rtol=rtol, atol=0)


# ---------------------------------------------------------------------------
# VirtualSpec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", SPECS)
def test_spec_parse_and_string_match_repro(s):
    jspec, tspec = pair(s)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    assert tspec.spec_string() == jspec.spec_string()
    assert tio.VirtualSpec.parse(tspec.spec_string()) == tspec
    for name in ("n_loc", "nb", "nb_loc", "logical_bytes"):
        assert getattr(tspec, name) == getattr(jspec, name), name


@pytest.mark.parametrize("s,match", [
    ("notvirtual:dense:n=8,m=1,k=1", "bad virtual spec"),
    ("virtual:bcsr:n=8,m=1,k=1,zap=3", "unknown virtual spec field"),
    ("virtual:bcsr:n=64,m=1", "needs k="),
    ("virtual:sparse:n=64,m=1,k=2", "unknown virtual kind"),
    ("virtual:dense:n=64,m=1,k=2,skew=1.0", "bcsr patterns only"),
    ("virtual:bcsr:n=64,m=1,k=2,bs=16,skew=-0.5", ">= 0"),
    ("virtual:bcsr:n=100,m=1,k=2,bs=16,grid=2", "grid"),
    ("virtual:dense:n=33,m=1,k=2,grid=2", "grid"),
])
def test_spec_validation_matches_repro(s, match):
    with pytest.raises(ValueError, match=match):
        jio.VirtualSpec.parse(s)
    with pytest.raises(ValueError, match=match):
        tio.VirtualSpec.parse(s)


# ---------------------------------------------------------------------------
# The stored-block pattern
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [SPECS[0], SPECS[1], SPECS[2],
                               SPECS[0].replace("grid=2", "grid=1")])
def test_pattern_from_repros_uniforms_is_bit_identical(s):
    jspec, tspec = pair(s)
    src = repro_source(jspec)
    for i in range(tspec.grid):
        for j in range(tspec.grid):
            want = jv._shard_pattern(jspec, i, j)
            got = shard_pattern(tspec, i, j, src)
            assert got.dtype == want.dtype == np.bool_
            np.testing.assert_array_equal(got, want)


@pytest.fixture
def planted_uniforms(monkeypatch):
    """Hand repro's _shard_pattern chosen uniforms: jax.random.uniform is
    replaced for the test, and the pattern's memo cleared around it."""
    state = {}

    def fake(_key, shape, *a, **kw):
        return jnp.asarray(state["u"][:shape[0], :shape[1]])

    jv._shard_pattern.cache_clear()
    monkeypatch.setattr(jax.random, "uniform", fake)
    yield state
    jv._shard_pattern.cache_clear()


@pytest.mark.parametrize("skew", [0.0, 1.3])
def test_pattern_compares_like_repro_at_the_boundary(planted_uniforms, skew):
    """A uniform equal to float32(density) (or to float32 of a skewed
    row's threshold): repro compares the uniform path in float32 (keep is
    False there) and the skewed path in float64 (float32(t) < t, keep is
    True for a threshold that float32 rounds down)."""
    s = "virtual:bcsr:n=256,m=1,k=2,bs=32,density=0.02,seed=0"
    if skew:
        s += f",skew={skew}"
    jspec, tspec = pair(s)
    nb = tspec.nb_loc
    if skew:
        w = (np.arange(tspec.nb) + 1.0) ** -skew
        w *= tspec.nb / w.sum()
        thresh = np.minimum(0.02 * w, 1.0)
        u = np.repeat(thresh.astype(np.float32)[:, None], nb, axis=1)
    else:
        u = np.full((nb, nb), np.float32(0.02))
    u[::3, ::2] = np.float32(0.5)
    planted_uniforms["u"] = u
    want = jv._shard_pattern(jspec, 0, 1)
    got = pattern_from_uniforms(tspec, 0, 1, u)
    np.testing.assert_array_equal(got, want)
    if skew:
        assert got.any()              # float32(t) < t in float64 holds
    else:
        assert not got.any()          # float32(0.02) < float32(0.02) fails


def test_seeded_pattern_is_repros_pattern():
    """The seeded source draws the pattern's uniforms with the numpy
    threefry, so a spec string stores the same blocks in both packages."""
    for s in SPECS[:3]:
        jspec, tspec = pair(s)
        for i in range(tspec.grid):
            for j in range(tspec.grid):
                np.testing.assert_array_equal(
                    shard_pattern(tspec, i, j), jv._shard_pattern(jspec, i, j))
        np.testing.assert_array_equal(tio.virtual_shard_nnzb(tspec),
                                      jv.virtual_shard_nnzb(jspec))


def test_seeded_ground_truth_is_repros():
    for s in (SPECS[0], SPECS[4]):
        jspec, tspec = pair(s)
        A, R = jspec.ground_truth()
        tA, tR = tspec.ground_truth(device="cpu")
        close(tA, A, rtol=1e-5)
        close(tR, R, rtol=1e-5)


# ---------------------------------------------------------------------------
# Shard values from repro's draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", SPECS[:3])
def test_bcsr_shards_match_repro(s):
    jspec, tspec = pair(s)
    src = repro_source(jspec)
    for i in range(tspec.grid):
        for j in range(tspec.grid):
            want = jv.virtual_bcsr_shard(jspec, i, j, pad_to=40)
            got = tio.virtual_bcsr_shard(tspec, i, j, pad_to=40, source=src,
                                         device="cpu")
            for name in ("block_rows", "block_cols"):
                np.testing.assert_array_equal(getattr(got, name).numpy(),
                                              np.asarray(getattr(want, name)))
            assert got.n == want.n
            close(got.data, want.data)
    want = jv.virtual_sharded_bcsr(jspec)
    got = tio.virtual_sharded_bcsr(tspec, source=src, device="cpu")
    np.testing.assert_array_equal(got.nnzb, want.nnzb)
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
    np.testing.assert_array_equal(got.cols.numpy(), np.asarray(want.cols))
    np.testing.assert_array_equal(got.part.perm, want.part.perm)
    close(got.data, want.data)
    close(got.to_dense(), want.to_dense())


def test_dense_shards_match_repro():
    jspec, tspec = pair(SPECS[3])
    src = repro_source(jspec)
    full = tio.virtual_dense_full(tspec, source=src, device="cpu")
    close(full, jv.virtual_dense_full(jspec))
    for i in range(2):
        for j in range(2):
            got = tio.virtual_dense_shard(tspec, i, j, source=src,
                                          device="cpu")
            close(got, jv.virtual_dense_shard(jspec, i, j))
            np.testing.assert_array_equal(
                got.numpy(), full[:, i * 24:(i + 1) * 24,
                                  j * 24:(j + 1) * 24].numpy())


# ---------------------------------------------------------------------------
# The seeded source on its own (repro's tests/test_io.py:150-236)
# ---------------------------------------------------------------------------

SMALL = "virtual:bcsr:n=128,m=2,k=3,bs=16,grid=2,density=0.3,seed=0"
SKEWED = "virtual:bcsr:n=1024,m=2,k=3,bs=32,density=0.08,skew=1.3,seed=0"


def test_seeded_generation_is_deterministic():
    spec = tio.VirtualSpec.parse(SMALL)
    a = tio.virtual_sharded_bcsr(spec, device="cpu")
    b = tio.virtual_sharded_bcsr(spec, device="cpu")
    assert torch.equal(a.data, b.data) and torch.equal(a.rows, b.rows)
    other = tio.virtual_sharded_bcsr(
        dataclasses.replace(spec, seed=1), device="cpu")
    assert not torch.equal(a.data[0, 0, :, -1], other.data[0, 0, :, -1])
    noisy = a.data[a.data > 0]
    assert float(noisy.min()) > 0


def test_shard_alone_equals_the_shard_in_the_stack():
    spec = tio.VirtualSpec.parse(SMALL)
    sh = tio.virtual_sharded_bcsr(spec, device="cpu")
    for i in range(2):
        for j in range(2):
            alone = tio.virtual_bcsr_shard(spec, i, j, pad_to=sh.z_max,
                                           device="cpu")
            stacked = sh.shard(i, j)
            assert torch.equal(alone.data, stacked.data)
            assert torch.equal(alone.block_rows, stacked.block_rows)
    # the dense shard of the merged operand is the shard's dense block
    blk = tio.virtual_bcsr_shard(spec, 1, 0, device="cpu")
    from repro_torch.core.sparse import to_dense
    np.testing.assert_array_equal(to_dense(blk).numpy(),
                                  sh.to_dense()[:, 64:, :64].numpy())


def test_nnzb_accounting_equals_generation():
    spec = tio.VirtualSpec.parse(SMALL)
    counts = tio.virtual_shard_nnzb(spec)
    sh = tio.virtual_sharded_bcsr(spec, device="cpu")
    np.testing.assert_array_equal(counts, sh.nnzb)
    for i in range(2):             # the diagonal blocks are always stored
        shard = sh.shard(i, i)
        stored = set(zip(shard.block_rows.tolist(),
                         shard.block_cols.tolist()))
        assert all((b, b) in stored for b in range(spec.nb_loc))


def test_skew_zero_is_the_uniform_pattern_and_skew_loads_the_head():
    spec = tio.VirtualSpec.parse(SKEWED)
    uniform = tio.VirtualSpec.parse(SKEWED.replace("skew=1.3,", ""))
    assert dataclasses.replace(spec, skew=0.0) == uniform
    np.testing.assert_array_equal(
        shard_pattern(dataclasses.replace(spec, skew=0.0), 0, 0),
        shard_pattern(uniform, 0, 0))
    keep = shard_pattern(spec, 0, 0)
    quarter = spec.nb // 4
    assert keep[:quarter].sum() > 2 * keep[-quarter:].sum()


def test_torch_noise_differs_by_shard_and_chunk():
    spec = tio.VirtualSpec.parse(SMALL)
    src = tio.SeededSource()
    outs = []
    for i, j, part in ((0, 0, 0), (0, 1, 0), (0, 0, 1)):
        out = torch.empty(2, 3, 16, 16)
        src.noise(spec, i, j, part, None, out)
        outs.append(out)
        assert float(out.min()) >= 0.99 and float(out.max()) <= 1.01
    assert not torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


# ---------------------------------------------------------------------------
# The balanced partition
# ---------------------------------------------------------------------------

def powerlaw(n=240, m=3, nnz=6000, seed=0, alpha=1.5):
    """Zipf entity degrees (repro's tests/test_partition.py), as arrays
    both packages' builders take."""
    rng = np.random.default_rng(seed)
    ii = np.minimum(rng.zipf(alpha, nnz) - 1, n - 1)
    jj = (np.minimum(rng.zipf(alpha, nnz) - 1, n - 1)
          + rng.integers(0, n, nnz)) % n
    rr = rng.integers(0, m, nnz)
    vv = (rng.random(nnz) + 0.1).astype(np.float32)
    return (jio.COOBuilder().add(rr, ii, jj, vv).finalize(n=n, m=m),
            tio.COOBuilder().add(rr, ii, jj, vv).finalize(n=n, m=m))


def assert_same_sharded(got, want, rtol=1e-6):
    for name in ("perm", "pos"):
        a, b = getattr(got.part, name), getattr(want.part, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    for name in ("n", "bs", "grid", "nb", "nb_loc"):
        assert getattr(got.part, name) == getattr(want.part, name)
    assert got.nnzb.dtype == want.nnzb.dtype
    assert got.nnzb.tobytes() == np.asarray(want.nnzb).tobytes()
    for name in ("rows", "cols"):
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    close(got.data, want.data, rtol)
    assert got.balance == want.balance
    if got.data.dtype == torch.float32:     # repro's jax keeps float32
        assert got.resident_bytes == want.resident_bytes


@pytest.mark.parametrize("g", [1, 2, 3])
def test_partition_coo_is_byte_identical_to_repro(g):
    jcoo, tcoo = powerlaw()
    want = jio.partition_coo(jcoo, bs=16, grid=g)
    got = tio.partition_coo(tcoo, bs=16, grid=g, device="cpu")
    assert_same_sharded(got, want)
    merged, jmerged = got.to_bcsr(), want.to_bcsr()
    np.testing.assert_array_equal(merged.block_rows.numpy(),
                                  np.asarray(jmerged.block_rows))
    np.testing.assert_array_equal(merged.block_cols.numpy(),
                                  np.asarray(jmerged.block_cols))
    assert merged.n == jmerged.n
    close(merged.data, jmerged.data)
    close(got.to_dense(), tcoo_dense(tcoo))
    assert got.balance <= 1.5


def tcoo_dense(coo):
    X = np.zeros((coo.m, coo.n, coo.n), np.float32)
    np.add.at(X, (coo.rels, coo.rows, coo.cols), coo.vals)
    return X


def test_balanced_partition_with_ties_matches_repro():
    """Equal weights everywhere but a few: the stable argsort and the
    least-loaded choice break the ties as repro's do."""
    w = np.ones(23)
    w[[3, 17]] = 5.0
    for g in (1, 2, 3, 4):
        want = jio.balanced_partition(w, g, n=23 * 8 - 3, bs=8)
        got = tio.balanced_partition(w, g, n=23 * 8 - 3, bs=8)
        assert got.perm.tobytes() == want.perm.tobytes()
        assert got.pos.tobytes() == want.pos.tobytes()
        assert (got.nb_loc, got.n_loc, got.n_pad) == \
            (want.nb_loc, want.n_loc, want.n_pad)


def test_partition_reuse_and_identity_layout_match_repro():
    jcoo, tcoo = powerlaw(seed=3)
    jpart = jio.partition_coo(jcoo, bs=16, grid=2).part
    part = convert.block_partition(jpart)
    want = jio.partition_coo(jcoo, bs=64, part=jpart)      # part fixes bs
    got = tio.partition_coo(tcoo, bs=64, part=part, device="cpu")
    assert got.bs == 16
    assert_same_sharded(got, want)
    ident = tio.identity_partition(tcoo.n, 16, 2)
    jident = jio.identity_partition(jcoo.n, 16, 2)
    assert ident.perm.tobytes() == jident.perm.tobytes()
    naive = tio.partition_coo(tcoo, part=ident, device="cpu")
    assert_same_sharded(naive, jio.partition_coo(jcoo, part=jident))
    bal = tio.partition_coo(tcoo, bs=16, grid=2, device="cpu")
    assert bal.balance <= naive.balance + 1e-9
    with pytest.raises(ValueError, match="built for n="):
        tio.partition_coo(tio.COOBuilder().add([0], [0], [1], [1.0])
                          .finalize(n=5, m=1), part=ident, device="cpu")
    with pytest.raises(ValueError, match="need grid="):
        tio.partition_coo(tcoo, bs=16, device="cpu")


def test_partition_by_device_count_and_empty_shards():
    _, tcoo = powerlaw(n=100)
    assert [choose_grid(d) for d in (1, 3, 4, 8, 9, 16)] == [1, 1, 2, 2, 3, 4]
    sh = tio.partition_coo(tcoo, bs=16, n_devices=9, device="cpu")
    assert sh.g == 3
    empty = tio.COOBuilder().finalize(n=40, m=2)
    jempty = jio.COOBuilder().finalize(n=40, m=2)
    got = tio.partition_coo(empty, bs=16, grid=2, device="cpu")
    assert_same_sharded(got, jio.partition_coo(jempty, bs=16, grid=2))
    assert got.z_max == 1 and got.to_bcsr().nnzb == 0


@pytest.mark.parametrize("g", [1, 2])
def test_partition_dense_matches_repro(g):
    rng = np.random.default_rng(5)
    X = rng.random((2, 50, 50)) * (rng.random((2, 50, 50)) < 0.1)
    want = jio.partition_dense(X, bs=8, grid=g)
    got = tio.partition_dense(X, bs=8, grid=g, device="cpu")
    # float64 in, float64 stored (repro means to, but its jax truncates
    # to float32 without x64)
    assert got.data.dtype == torch.float64
    assert_same_sharded(got, want)
    np.testing.assert_array_equal(got.to_dense().numpy(), X)


def test_factor_permutation_round_trip():
    _, tcoo = powerlaw(n=100)
    part = tio.partition_coo(tcoo, bs=16, grid=3, device="cpu").part
    jpart = jio.partition_coo(powerlaw(n=100)[0], bs=16, grid=3).part
    A = np.random.default_rng(0).random((100, 4)).astype(np.float32)
    Ap = part.permute_factor(A)
    np.testing.assert_array_equal(Ap, jpart.permute_factor(A))
    np.testing.assert_array_equal(part.unpermute_factor(Ap), A)
    np.testing.assert_array_equal(
        part.permute_factor(torch.from_numpy(A)).numpy(), Ap)
    np.testing.assert_array_equal(
        part.unpermute_factor(torch.from_numpy(Ap)).numpy(), A)
    assert Ap.shape == (part.n_pad, 4)
    pad = part.perm < 0
    assert not Ap.reshape(-1, 16, 4)[pad].any()


def test_balancer_within_1_5x_under_skew():
    """The greedy balancer holds <= 1.5x of ideal on the skewed pattern
    (repro's TestVirtualSkew), with the layout repro's gives."""
    jspec, tspec = pair(SKEWED)
    rows, cols = np.nonzero(shard_pattern(tspec, 0, 0))
    args = (np.zeros(len(rows), np.int64), rows.astype(np.int64) * 32,
            cols.astype(np.int64) * 32, np.ones(len(rows), np.float32))
    got = tio.partition_coo(tio.COOBuilder().add(*args).finalize(n=1024,
                                                                 m=1),
                            bs=32, grid=2, device="cpu")
    want = jio.partition_coo(jio.COOBuilder().add(*args).finalize(n=1024,
                                                                  m=1),
                             bs=32, grid=2)
    assert_same_sharded(got, want)
    assert got.balance <= 1.5
    naive = tio.virtual_shard_nnzb(dataclasses.replace(tspec, grid=2))
    assert naive.max() * 4 / naive.sum() > got.balance


def test_convert_sharded_bcsr_round_trip():
    jcoo, tcoo = powerlaw(n=90)
    want = jio.partition_coo(jcoo, bs=16, grid=2)
    got = convert.sharded_bcsr(want, device="cpu")
    assert_same_sharded(got, want, rtol=0)
    assert_same_sharded(tio.partition_coo(tcoo, bs=16, grid=2,
                                          device="cpu"), want)
    cell = got.cell(1, 0)
    assert (cell.i, cell.j, cell.nnzb) == (1, 0, int(want.nnzb[1, 0]))
    sp = cell.sp
    jshard = want.shard(1, 0)
    np.testing.assert_array_equal(sp.block_rows.numpy(),
                                  np.asarray(jshard.block_rows))
    np.testing.assert_array_equal(jsp.to_dense(jshard),
                                  tio_dense(sp))


def tio_dense(sp):
    from repro_torch.core.sparse import to_dense
    return to_dense(sp).numpy()


# ---------------------------------------------------------------------------
# Manifests and the byte ledger
# ---------------------------------------------------------------------------

def assert_same_manifest(got, want, values=None):
    """Field by field; a moments digest against repro's at rtol 1e-4 and,
    given the ``values``, against their float64 moments at rtol 1e-6."""
    got, want = got.fingerprint(), want.fingerprint()
    gd, wd = got.pop("digest"), want.pop("digest")
    if ":" in wd:                       # moments:index
        (gm, gi), (wm, wi) = gd.split(":"), wd.split(":")
        assert gi == wi
        moments = [float(x) for x in gm.split("/")]
        np.testing.assert_allclose(moments, [float(x) for x in
                                             wm.split("/")], rtol=1e-4)
        if values is not None:
            x = np.asarray(values, np.float64)
            np.testing.assert_allclose(moments, [x.sum(), (x * x).sum()],
                                       rtol=1e-6)
    else:                               # the spec's sha1: exact
        assert gd == wd
    assert got == want


@pytest.mark.parametrize("s", [SPECS[0], SPECS[1], SPECS[2], SPECS[3],
                               SPECS[5]])
def test_virtual_manifest_matches_repro(s, tmp_path):
    jspec, tspec = pair(s)
    man = tio.manifest_of(tspec, extra={"run": 1})
    assert_same_manifest(man, jio.manifest_of(jspec, extra={"run": 1}))
    assert tio.manifest_of(tspec, source=repro_source(jspec)) == \
        tio.manifest_of(tspec)
    back = tio.DatasetManifest.load(man.save(str(tmp_path / "m.json")))
    assert back == man
    assert tio.operand_dims(tspec) == jio.operand_dims(jspec)


@pytest.mark.parametrize("g", [1, 2])
def test_sharded_manifest_matches_repro(g, tmp_path):
    jspec, tspec = pair(SPECS[0].replace("grid=2", f"grid={g}"))
    want = jv.virtual_sharded_bcsr(jspec)
    got = tio.virtual_sharded_bcsr(tspec, source=repro_source(jspec),
                                   device="cpu")
    man = tio.manifest_of(got)
    assert_same_manifest(man, jio.manifest_of(want), want.data)
    assert tio.DatasetManifest.load(man.save(str(tmp_path / "m.json"))) \
        == man
    assert tio.operand_dims(got) == jio.operand_dims(want)
    merged = tio.manifest_of(got.to_bcsr())
    assert_same_manifest(merged, jio.manifest_of(want.to_bcsr()), want.data)


def test_memory_ledger_takes_the_new_manifests():
    """accounted_ensemble_bytes and MemoryLedger.from_manifest on the
    virtual-bcsr and bcsr-sharded manifests, against repro's."""
    from repro.obs import memory as jmem
    from repro_torch.obs import memory as tmem
    jspec, tspec = pair(SPECS[0])
    sharded = tio.virtual_sharded_bcsr(tspec, device="cpu")
    jsharded = jv.virtual_sharded_bcsr(jspec)
    for man, jman in ((tio.manifest_of(tspec), jio.manifest_of(jspec)),
                      (tio.manifest_of(sharded),
                       jio.manifest_of(jsharded))):
        for r, k in ((4, 5), (1, 2)):
            assert tmem.accounted_ensemble_bytes(man, n_members=r,
                                                 k_max=k) == \
                jmem.accounted_ensemble_bytes(jman, n_members=r, k_max=k)
        led = tmem.MemoryLedger.from_manifest(man, peak_host_bytes=1)
        jled = jmem.MemoryLedger.from_manifest(jman, peak_host_bytes=1)
        assert led.to_dict()["ledger"] == jled.to_dict()["ledger"]
        assert led.compression > 1.0


# ---------------------------------------------------------------------------
# The numpy threefry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 123456789, 2 ** 31 - 1])
def test_threefry_matches_jax_random(seed):
    key = jax.random.PRNGKey(seed)
    tkey = threefry.prng_key(seed)
    assert tuple(np.asarray(key).tolist()) == tkey
    keys = jax.random.split(key, 4)
    tkeys = threefry.split(tkey, 4)
    assert [tuple(k) for k in np.asarray(keys).tolist()] == tkeys
    f = jax.random.fold_in(keys[2], 5)
    tf = threefry.fold_in(tkeys[2], 5)
    assert tuple(np.asarray(f).tolist()) == tf
    for shape in ((7,), (33, 33), (4, 5, 6)):
        np.testing.assert_array_equal(threefry.uniform(tf, shape),
                                      np.asarray(jax.random.uniform(f,
                                                                    shape)))
        np.testing.assert_array_equal(
            threefry.uniform(tf, shape, 0.99, 1.01),
            np.asarray(jax.random.uniform(f, shape, jnp.float32, 0.99,
                                          1.01)))
        np.testing.assert_allclose(threefry.exponential(tf, shape),
                                   jax.random.exponential(f, shape),
                                   rtol=1e-6)
        np.testing.assert_allclose(threefry.normal(tf, shape),
                                   jax.random.normal(f, shape),
                                   rtol=1e-4, atol=1e-6)
