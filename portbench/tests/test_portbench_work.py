"""``portbench/work``'s counts for the cells' shares, against numbers
worked out by hand from the shapes (m = 20, k = 10; the dense block
n = 12288; the sparse shard n = 23,347,200, 6,653 blocks of 128^2)."""
import ast
from pathlib import Path

import pytest

from portbench import work
from portbench.work import bcsr_xa_xta, fused_xa_xtb
from portbench.harness import spec

DENSE_CONFIG = spec.config("rescal-dense-3tb.r16")
SPARSE_CONFIG = spec.config("rescal-sparse-eb.r16")
DENSE, SPARSE = DENSE_CONFIG["share"], SPARSE_CONFIG["share"]


def test_dense_mu_iteration():
    # per slice 4 * 12288^2 * 10 + 6 * 12288 * 10^2, twenty slices, then
    # A^T A and A S: 4 * 12288 * 10^2
    w = work.mu_iteration(DENSE, 10)
    assert w.flops == 120_948_326_400
    # X once, A in and out, R in and out
    assert w.bytes == 12_079_595_520 + 983_040 + 16_000
    assert w.bound_by == "bytes"
    assert w.bound_s == pytest.approx(12_080_594_560 / 3.35e12, rel=1e-12)


def test_sparse_mu_iteration():
    # per slice 4 * 109,002,752 * 10 + 6 * 23,347,200 * 10^2
    w = work.mu_iteration(SPARSE, 10)
    assert w.flops == 20 * 18_368_430_080 + 9_338_880_000
    # the blocks' values once, their coordinates, A in and out, R in and out
    assert w.bytes == 8_720_220_160 + 53_224 + 1_867_776_000 + 16_000
    assert w.bound_by == "operations"
    assert w.bound_s == pytest.approx(376_707_481_600 / 67e12, rel=1e-12)


def test_fused_xa_xtb_call_of_the_dense_cells():
    # the batched schedule: one call over all 20 slices
    w = fused_xa_xtb.per_iteration(DENSE_CONFIG)
    assert w.flops == 120_795_955_200
    assert w.bytes == 4 * (3_019_898_880 + 2 * 122_880 + 2 * 2_457_600)
    assert w.bound_by == "bytes"


def test_bcsr_xa_xta_call_of_the_sparse_cell():
    # the sliced schedule: one call per slice, twenty an iteration
    w = bcsr_xa_xta.call(1, 6653, 128, 23_347_200, 10)
    assert w.flops == 4_360_110_080
    assert w.bytes == 436_011_008 + 53_224 + 4 * 933_888_000
    assert w.bound_s == pytest.approx(4_171_616_232 / 3.35e12, rel=1e-12)
    it = bcsr_xa_xta.per_iteration(SPARSE_CONFIG)
    assert (it.flops, it.bytes) == (20 * w.flops, 20 * w.bytes)


def test_fused_xa_xtb_under_the_sliced_schedule():
    # twenty one-slice calls: B1 and B2 read by each
    w = fused_xa_xtb.per_iteration(dict(DENSE_CONFIG, schedule="sliced"))
    assert w.flops == 120_795_955_200
    assert w.bytes == 20 * 4 * (150_994_944 + 2 * 122_880 + 2 * 122_880)


def test_every_roofline_has_its_kernels_work_file(bench):
    for m in bench["per_layer"]:
        if m["name"].endswith("_roofline"):
            kernel = m["name"][:-len("_roofline")]
            path = Path(work.__file__).parent / f"{kernel}.py"
            assert path.is_file(), path


def test_work_imports_nothing_of_the_program():
    for path in sorted(Path(work.__file__).parent.glob("*.py")):
        tree = ast.parse(path.read_text())
        tops = {(a.name if isinstance(node, ast.Import)
                 else node.module or "").split(".")[0]
                for node in ast.walk(tree)
                if isinstance(node, (ast.Import, ast.ImportFrom))
                for a in getattr(node, "names", [])}
        assert not tops & {"repro_torch", "repro"}, path
