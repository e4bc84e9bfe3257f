"""The port's serving slice against ``repro`` on the CPU: TSV ingest, the
BCSR manifest, the FactorBundle both ways, the ServeEngine on the same
bundle and query stream, the query sources, and the CLIs end to end.

Inputs are drawn from a seed with numpy and handed to both packages.
Scores are held at rtol 1e-5 (fp32 sums in another order), everything
else exactly.  The CUDA kernel on a card: ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro import io as jio
from repro import serve as jserve
from repro.kernels.policy import KernelPolicy as JPolicy
from repro.selection import types as jtypes
from repro_torch import convert
from repro_torch.io import coo_to_bcsr, ingest_npz, ingest_tsv, manifest_of
from repro_torch.kernels.policy import KernelPolicy
from repro_torch.launch import rescalk_run
from repro_torch.launch import serve as tserve
from repro_torch.selection.types import RescalkResult
from repro_torch.serve import (BundleError, FactorBundle, Query, ServeConfig,
                               ServeEngine, parse_queries_tsv, random_queries)

RTOL = 1e-5


def write_tsv(path, n=60, m=2, seed=0, dups=True):
    """A planted TSV triple list with names: three communities, a weight
    column on some lines, comments, blank lines and repeated triples."""
    rng = np.random.default_rng(seed)
    comm = np.arange(n) * 3 // n
    lines = ["# head\trel\ttail\tweight", ""]
    for r in range(m):
        for h in range(n):
            for t in rng.choice(n, 6, replace=False):
                if comm[t] != (comm[h] + r) % 3:
                    continue
                w = f"\t{rng.uniform(0.5, 2):.3f}" if rng.random() < .5 \
                    else ""
                lines.append(f"e{h * 7 % n}\trel{r}\te{t * 7 % n}{w}")
    if dups:
        lines += lines[2:12]
    path.write_text("\n".join(lines) + "\n")
    return path


def random_bundle(n=300, m=3, k=5, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((n, k), np.float32), rng.random((m, k, k), np.float32)


def both_bundles(n=300, m=3, k=5, seed=0):
    A, R = random_bundle(n, m, k, seed)
    return FactorBundle(A=A, R=R), jserve.FactorBundle(A=A, R=R)


# ---------------------------------------------------------------------------
# ingest and manifest
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [7, 1 << 16])
def test_ingest_tsv_matches_repro(tmp_path, chunk):
    path = str(write_tsv(tmp_path / "x.tsv"))
    coo, vocab = ingest_tsv(path, chunk=chunk)
    jcoo, jvocab = jio.ingest_tsv(path, chunk=chunk)
    assert (coo.n, coo.m, coo.nnz) == (jcoo.n, jcoo.m, jcoo.nnz)
    for name in ("rels", "rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(coo, name),
                                      getattr(jcoo, name))
    assert vocab.entities == jvocab.entities
    assert vocab.relations == jvocab.relations
    assert coo.nnz < 10 + sum(1 for _ in open(path))   # duplicates summed


def write_npz(path, n=50, m=3, nnz=200, seed=0, **extra):
    """A seeded pre-numbered COO file with repeated coordinates, its ids
    below n and m (the largest entity id below n - 1 when n > 40)."""
    rng = np.random.default_rng(seed)
    arrays = dict(row=rng.integers(0, min(n, 40), nnz),
                  rel=rng.integers(0, m, nnz),
                  col=rng.integers(0, min(n, 40), nnz),
                  val=rng.random(nnz, np.float32))
    arrays.update(extra)
    np.savez(path, **arrays)
    return str(path)


def assert_same_coo(coo, jcoo):
    assert (coo.n, coo.m, coo.nnz) == (jcoo.n, jcoo.m, jcoo.nnz)
    for name in ("rels", "rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(coo, name),
                                      getattr(jcoo, name))


@pytest.mark.parametrize("dims", [dict(), dict(n=50), dict(n=50, m=5)])
def test_ingest_npz_declared_dims_match_repro(tmp_path, dims):
    """Declared dimensions override the inferred ones, as in repro: the
    file's largest id is below n - 1, so n = 50 gives a larger tensor."""
    path = write_npz(tmp_path / "x.npz")
    coo = ingest_npz(path, chunk=64, **dims)
    assert_same_coo(coo, jio.ingest_npz(path, chunk=64, **dims))
    assert coo.n == dims.get("n", 40)


@pytest.mark.parametrize("dims,bad", [
    (dict(n=30), {}),                                  # ids >= declared n
    (dict(n=50, m=2), {}),                             # rel >= declared m
    (dict(), dict(row=np.full(200, -1))),              # a negative id
])
def test_ingest_npz_out_of_bounds_raises_as_repro(tmp_path, dims, bad):
    path = write_npz(tmp_path / "x.npz", **bad)
    msg = "coordinate out of bounds for declared"
    with pytest.raises(ValueError, match=msg):
        jio.ingest_npz(path, **dims)
    with pytest.raises(ValueError, match=msg):
        ingest_npz(path, **dims)


@pytest.mark.parametrize("dims", [dict(), dict(n=7, m=2)])
def test_ingest_npz_empty_file_matches_repro(tmp_path, dims):
    path = tmp_path / "empty.npz"
    np.savez(path, row=np.zeros(0, np.int64), rel=np.zeros(0, np.int64),
             col=np.zeros(0, np.int64))
    coo = ingest_npz(str(path), **dims)
    assert_same_coo(coo, jio.ingest_npz(str(path), **dims))
    assert (coo.n, coo.m) == (dims.get("n", 0), dims.get("m", 0))


def test_manifest_of_matches_repro(tmp_path):
    path = str(write_tsv(tmp_path / "x.tsv"))
    coo, _ = ingest_tsv(path)
    sp = coo_to_bcsr(coo, bs=16, device="cpu")
    jsp = jio.coo_to_bcsr(jio.ingest_tsv(path)[0], bs=16)
    got = manifest_of(sp).fingerprint()
    want = jio.manifest_of(jsp).fingerprint()
    assert got.pop("dtype") == want.pop("dtype") == "float32"
    moments, index = got.pop("digest").split(":")
    jmoments, jindex = want.pop("digest").split(":")
    assert index == jindex
    np.testing.assert_allclose([float(x) for x in moments.split("/")],
                               [float(x) for x in jmoments.split("/")],
                               rtol=RTOL)
    assert got == want
    assert manifest_of(sp).byte_ledger() == jio.manifest_of(jsp).byte_ledger()


# ---------------------------------------------------------------------------
# FactorBundle
# ---------------------------------------------------------------------------

def test_bundle_digest_matches_repro():
    ours, theirs = both_bundles()
    assert ours.digest() == theirs.digest()


@pytest.mark.parametrize("writer", ["port", "repro"])
def test_bundle_loads_in_the_other_package(tmp_path, writer):
    A, R = random_bundle()
    kw = dict(A=A, R=R, entities=[f"e{i}" for i in range(300)],
              relations=["a", "b", "c"], permutation=np.arange(300)[::-1],
              manifest={"kind": "bcsr", "n": 300},
              meta={"k_opt": 5, "criterion": "threshold"})
    src, dst = ((FactorBundle, jserve.FactorBundle) if writer == "port"
                else (jserve.FactorBundle, FactorBundle))
    src(**kw).save(str(tmp_path / "b"))
    back = dst.load(str(tmp_path / "b"))
    np.testing.assert_array_equal(back.A, A)
    np.testing.assert_array_equal(back.R, R)
    np.testing.assert_array_equal(back.permutation, kw["permutation"])
    for name in ("entities", "relations", "manifest", "meta"):
        assert getattr(back, name) == kw[name]
    assert back.digest() == src(**kw).digest()
    assert json.loads((tmp_path / "b" / "bundle.json").read_text())[
        "format_version"] == 1


def test_from_sweep_matches_repro():
    rng = np.random.default_rng(4)
    per_k = {k: jtypes.KResult(
        k=k, s_min=0.9 - 0.1 * k, s_mean=0.95 - 0.1 * k, rel_err=0.3 / k,
        A_median=rng.random((40, k), np.float32),
        R_regress=rng.random((2, k, k), np.float32),
        member_errors=rng.random(3)) for k in (2, 3, 4)}
    jres = jtypes.RescalkResult(ks=np.array([2, 3, 4]),
                                s_min=np.array([.7, .6, .5]),
                                s_mean=np.array([.8, .7, .6]),
                                rel_err=np.array([.15, .1, .075]), k_opt=3,
                                per_k=per_k)
    res = RescalkResult(ks=jres.ks, s_min=jres.s_min, s_mean=jres.s_mean,
                        rel_err=jres.rel_err, k_opt=3,
                        per_k={k: convert.k_result(v)
                               for k, v in per_k.items()})
    meta = {"criterion": "threshold"}
    got = FactorBundle.from_sweep(res, meta=meta, entities=["x"] * 40)
    want = jserve.FactorBundle.from_sweep(jres, meta=meta,
                                          entities=["x"] * 40)
    np.testing.assert_array_equal(got.A, want.A)
    np.testing.assert_array_equal(got.R, want.R)
    assert got.meta == want.meta and got.digest() == want.digest()
    assert convert.factor_bundle(want).digest() == want.digest()


def _tamper(bdir, how):
    npz = bdir / "factors.npz"
    man = bdir / "bundle.json"
    if how == "digest":
        arrs = dict(np.load(npz))
        arrs["A"] = arrs["A"] + 1.0
        np.savez(npz, **arrs)
    elif how == "truncated":
        npz.write_bytes(npz.read_bytes()[:200])
    elif how == "not_npz":
        npz.write_bytes(b"not an npz file at all")
    elif how == "missing":
        npz.unlink()
    elif how == "json":
        man.write_text("{not json")
    elif how == "version":
        doc = json.loads(man.read_text())
        doc["format_version"] = 99
        man.write_text(json.dumps(doc))
    elif how == "shape":
        doc = json.loads(man.read_text())
        doc["n"] += 1
        man.write_text(json.dumps(doc))


@pytest.mark.parametrize("how", ["digest", "truncated", "not_npz", "missing",
                                 "json", "version", "shape"])
def test_corrupt_bundle_raises_and_reload_keeps_old_factors(tmp_path, how):
    A, R = random_bundle(n=50, seed=1)
    engine = ServeEngine(FactorBundle(A=A, R=R), ServeConfig(topk=4),
                         device="cpu")
    q = [Query("sro", 3, 1)]
    before = engine.query(q)[0]
    A2, R2 = random_bundle(n=60, seed=2)
    FactorBundle(A=A2, R=R2).save(str(tmp_path / "new"))
    _tamper(tmp_path / "new", how)
    with pytest.raises(BundleError):
        FactorBundle.load(str(tmp_path / "new"))
    with pytest.raises(BundleError):
        engine.reload(str(tmp_path / "new"))
    assert engine.n == 50 and engine.stats()["reloads"] == 0
    np.testing.assert_array_equal(engine.A.numpy(), A)
    after = engine.query(q)[0]
    assert after.cached
    np.testing.assert_array_equal(after.indices, before.indices)


def test_reload_swaps_factors_and_clears_the_cache(tmp_path):
    A, R = random_bundle(n=50, seed=1)
    engine = ServeEngine(FactorBundle(A=A, R=R), ServeConfig(topk=4),
                         device="cpu")
    engine.query([Query("sro", 3, 1)])
    A2, R2 = random_bundle(n=60, seed=2)
    FactorBundle(A=A2, R=R2).save(str(tmp_path / "new"))
    assert engine.reload(str(tmp_path / "new")).n == 60
    st = engine.stats()
    assert (engine.n, st["reloads"], st["cache_size"]) == (60, 1, 0)
    assert not engine.query([Query("sro", 55, 1)])[0].cached


# ---------------------------------------------------------------------------
# ServeEngine against repro's
# ---------------------------------------------------------------------------

ENGINE_CASES = [dict(), dict(admit=3), dict(deadline=0.0),
                dict(cache_entries=0), dict(cache_entries=5, batch=4)]


@pytest.mark.parametrize("kw", ENGINE_CASES,
                         ids=["default", "admit3", "deadline0", "nocache",
                              "evict"])
def test_engine_matches_repro(kw):
    """The same bundle and zipf stream through both engines (repro's on
    its panel stream): identical cached/shed flags, indices and stats(),
    scores at rtol 1e-5."""
    ours, theirs = both_bundles(n=300, m=3, k=5, seed=3)
    cfg = {**dict(topk=7, batch=8, pn=128), **kw}
    engine = ServeEngine(ours, ServeConfig(**cfg), device="cpu")
    jengine = jserve.ServeEngine(theirs, jserve.ServeConfig(
        kernel=JPolicy(impl="stream"), **cfg))
    queries = random_queries(300, 3, 160, skew=1.1, seed=5)
    assert queries == [Query(*q) for q in jserve.random_queries(
        300, 3, 160, skew=1.1, seed=5)]
    for c0 in range(0, 160, 20):
        req = queries[c0:c0 + 20]
        got = engine.query(req)
        want = jengine.query([jserve.Query(*q) for q in req])
        for g, w in zip(got, want):
            assert (g.cached, g.shed) == (w.cached, w.shed)
            np.testing.assert_array_equal(g.indices, np.asarray(w.indices))
            assert g.indices.dtype == np.int32
            np.testing.assert_allclose(g.scores, np.asarray(w.scores),
                                       rtol=RTOL)
    assert engine.stats() == jengine.stats()
    if "deadline" in kw:
        assert engine.stats()["sheds"] > 0
    if "admit" in kw:
        assert engine.stats()["sheds"] > 0


def test_engine_pads_every_batch_to_its_width():
    """Pad rows are anchor 0, relation 0: what the scorer sees is always
    cfg.batch rows, and the answers do not depend on the padding."""
    ours, _ = both_bundles(n=40)
    engine = ServeEngine(ours, ServeConfig(topk=3, batch=8,
                                           cache_entries=0), device="cpu")
    widths = []
    score = engine._score
    engine._score = lambda a, r, s: widths.append(len(a)) or score(a, r, s)
    one = engine.query([Query("sor", 5, 2)])[0]
    many = engine.query([Query("sro", i, 1) for i in range(11)]
                        + [Query("sor", 5, 2)])[-1]
    assert widths == [8, 8, 8]
    np.testing.assert_array_equal(one.indices, many.indices)


def test_engine_rejects_bad_queries():
    engine = ServeEngine(both_bundles(n=20)[0], device="cpu")
    with pytest.raises(ValueError, match="mode"):
        engine.query([Query("rso", 0, 0)])
    with pytest.raises(ValueError, match="out of range"):
        engine.query([Query("sro", 20, 0)])
    with pytest.raises(ValueError, match="out of range"):
        engine.query([Query("sor", 0, 3)])


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(both_bundles(n=20)[0])


def test_engine_impl_cuda_on_cpu_raises():
    engine = ServeEngine(both_bundles(n=20)[0], ServeConfig(
        kernel=KernelPolicy(impl="cuda")), device="cpu")
    with pytest.raises(ValueError, match="impl='cuda'"):
        engine.query([Query("sro", 1, 0)])


# ---------------------------------------------------------------------------
# query sources
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(skew=1.1, seed=0), dict(skew=2.0,
                                                               seed=7),
                                dict(mode="sor", seed=1),
                                dict(mode="sro", skew=0.5, seed=2)])
def test_random_queries_match_repro(kw):
    got = random_queries(50, 4, 300, **kw)
    assert got == [Query(*q) for q in jserve.random_queries(50, 4, 300,
                                                             **kw)]
    with pytest.raises(ValueError, match="mode"):
        random_queries(5, 1, 3, mode="both")


def test_parse_queries_tsv_matches_repro(tmp_path):
    p = tmp_path / "q.tsv"
    p.write_text("# kg-completion queries\n\nalice\tknows\t?\n"
                 "?\tknows\tbob\n2\t0\t?\n?\t1\t0\n")
    vocab = dict(entities=["alice", "bob", "carol"],
                 relations=["knows", "likes"])
    got = parse_queries_tsv(str(p), **vocab)
    assert got == [Query(*q) for q in jserve.parse_queries_tsv(str(p),
                                                                **vocab)]
    assert got[:2] == [Query("sro", 0, 0), Query("sor", 1, 0)]
    for text, match in (("dave\t0\t?\n", "unknown entity"),
                        ("a\tb\n", "TAB"), ("?\t0\t?\n", "TAB")):
        p.write_text(text)
        with pytest.raises(ValueError, match=match):
            parse_queries_tsv(str(p), entities=["alice"], relations=["r"])
        with pytest.raises(ValueError, match=match):
            jserve.parse_queries_tsv(str(p), entities=["alice"],
                                     relations=["r"])


# ---------------------------------------------------------------------------
# the CLIs end to end
# ---------------------------------------------------------------------------

def test_tsv_sweep_bundle_serve_end_to_end(tmp_path, capsys):
    """TSV -> the port's sweep with --bundle -> the port's serve CLI;
    repro's FactorBundle.load accepts the bundle, and --report alone puts
    it at <report>.bundle."""
    data = str(write_tsv(tmp_path / "x.tsv"))
    sweep = ["--data", data, "--bs", "32", "--k-min", "2", "--k-max", "3",
             "--r", "2", "--iters", "20", "--device", "cpu"]
    res, rep = rescalk_run.main(sweep + ["--bundle", str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert "[io] " in out and " entities, 2 relations" in out
    bundle = jserve.FactorBundle.load(str(tmp_path / "b"))
    assert bundle.meta["k_opt"] == res.k_opt
    assert bundle.meta["criterion"] == "threshold"
    assert bundle.relations == ["rel0", "rel1"]
    assert f"digest={bundle.digest()[:12]}" in out
    assert bundle.manifest["kind"] == "bcsr"
    np.testing.assert_array_equal(bundle.A, res.per_k[res.k_opt].A_median)

    run = tserve.main(["--factors", str(tmp_path / "b"), "--queries",
                       "random:64:1.5", "--batch", "8", "--topk", "5",
                       "--requests", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(run.results) == 64 and len(run.latencies) == 4
    assert run.stats["hits"] + run.stats["misses"] == 64
    assert f"{run.stats['batches']} device batches" in out and "p99" in out
    assert all(r.indices.shape == (5,) for r in run.results)

    q = tmp_path / "q.tsv"
    q.write_text(f"{bundle.entities[0]}\trel1\t?\n?\trel0\t"
                 f"{bundle.entities[3]}\n")
    run = tserve.main(["--factors", str(tmp_path / "b"), "--queries",
                       str(q), "--device", "cpu", "--impl", "ref"])
    assert [r.cached for r in run.results] == [False, False]

    report = tmp_path / "r.json"
    rescalk_run.main(sweep + ["--report", str(report)])
    saved = json.loads(report.read_text())
    assert saved["meta"]["bundle"] == str(tmp_path / "r.bundle")
    assert jserve.FactorBundle.load(saved["meta"]["bundle"]).digest() == \
        FactorBundle.load(str(tmp_path / "b")).digest()


def test_serve_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default runs there")
    both_bundles(n=20)[0].save(str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="--device cpu"):
        tserve.main(["--factors", str(tmp_path / "b")])


def test_serve_flags_match_repro_meanings():
    from repro.launch.serve import build_parser as repro_parser
    mine = {a.dest: a for a in tserve.build_parser()._actions}
    theirs = {a.dest: a for a in repro_parser()._actions}
    assert set(theirs) - set(mine) == set()
    assert set(mine) - set(theirs) == {"device"}
    for dest, action in theirs.items():
        if dest not in ("help", "impl"):
            assert mine[dest].default == action.default, dest
            assert mine[dest].choices == action.choices, dest
    assert mine["impl"].choices == ("auto", "cuda", "ref")
    assert mine["device"].default == "cuda"


def test_rescalk_run_bundle_flag_and_serve_config_match_repro():
    from repro.launch.rescalk_run import build_parser as repro_parser
    mine = {a.dest: a for a in rescalk_run.build_parser()._actions}
    theirs = {a.dest: a for a in repro_parser()._actions}
    assert mine["bundle"].default == theirs["bundle"].default is None
    ours = {f.name: f.default for f in dataclasses.fields(ServeConfig)}
    want = {f.name: f.default
            for f in dataclasses.fields(jserve.ServeConfig)}
    assert ours.pop("kernel") == KernelPolicy()
    assert ours == {k: v for k, v in want.items() if k in ours}
    assert set(want) - set(ours) <= {"kernel", "use_fused_kernel",
                                     "fused_impl", "impl"}
