"""repro_torch.ckpt: atomic, digest-verified, self-healing checkpoints in
repro's on-disk format, each held against repro's ckpt."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as jckpt
from repro_torch import ckpt
from repro_torch.obs import trace as obs
from repro_torch.resilience import FaultPlan, FaultSpec, faults


def make_tree(seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 4, generator=g),
                       "b": torch.zeros(4, dtype=torch.bfloat16)},
            "opt": [torch.ones(3), torch.zeros((), dtype=torch.int32)]}


def like_of(tree):
    """The tree's shapes and dtypes as meta tensors."""
    if isinstance(tree, dict):
        return {k: like_of(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [like_of(v) for v in tree]
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_at(v: float):
    return {"w": torch.full((4, 3), v), "b": torch.full((3,), v,
                                                        dtype=torch.bfloat16)}


@pytest.fixture
def tracer(tmp_path):
    t = obs.Tracer(str(tmp_path / "trace"))
    prev = obs.install(t)
    yield t
    obs.install(prev)
    t.close()


def test_roundtrip_latest_and_no_partial_files(tmp_path):
    tree = make_tree()
    ckpt.save(str(tmp_path), 1, tree)
    ckpt.save(str(tmp_path), 7, tree)
    assert ckpt.latest_step(str(tmp_path)) == 7
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    restored, step = ckpt.restore(str(tmp_path), like_of(tree))
    assert step == 7
    for a, b in zip(leaves(tree), leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
        assert b.device.type == "cpu"


def test_restore_puts_leaves_on_the_device_asked_for(tmp_path):
    ckpt.save(str(tmp_path), 0, {"A": torch.rand(5, 2)})
    got, _ = ckpt.restore(str(tmp_path), {"A": torch.empty(5, 2)},
                          device="meta")
    assert got["A"].device.type == "meta"
    got, _ = ckpt.restore(str(tmp_path),
                          {"A": torch.empty(5, 2, dtype=torch.float64)})
    assert got["A"].dtype == torch.float64


@pytest.mark.parametrize("tree_fn", [make_tree, lambda: tree_at(2.5)])
def test_checkpoint_saved_by_repro_restores_in_the_port(tmp_path, tree_fn):
    """repro's step, leaf for leaf: the same values and dtypes (bfloat16
    included), and the port's manifest of the same tree is repro's."""
    tree = tree_fn()
    jtree = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else
            jnp.dtype(str(t.dtype).split(".")[1])), tree)
    jckpt.save(str(tmp_path / "j"), 3, jtree)
    got, step = ckpt.restore(str(tmp_path / "j"), like_of(tree))
    assert step == 3
    for a, b in zip(leaves(tree), leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ckpt.save(str(tmp_path / "t"), 3, tree)
    with open(tmp_path / "j" / "step_3.json") as f:
        theirs = json.load(f)
    with open(tmp_path / "t" / "step_3.json") as f:
        ours = json.load(f)
    assert ours == theirs


def test_checkpoint_saved_by_the_port_restores_in_repro(tmp_path):
    """The port's step under repro's restore (digests verified there)."""
    tree = {"A": torch.rand(6, 3), "R": torch.rand(2, 3, 3),
            "errors": torch.rand(2), "n": torch.arange(4, dtype=torch.int32)}
    ckpt.save(str(tmp_path), 0, tree)
    assert jckpt.verify_step(str(tmp_path), 0)
    like = {k: jax.ShapeDtypeStruct(tuple(v.shape),
                                    jnp.dtype(str(v.dtype).split(".")[1]))
            for k, v in tree.items()}
    got, step = jckpt.restore(str(tmp_path), like)
    assert step == 0
    for k, v in tree.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v.numpy())


def test_save_async_snapshots_then_writes(tmp_path):
    """save_async copies to host numpy before it returns: a later write to
    the tensor does not reach the checkpoint."""
    t = torch.zeros(1000)
    handle = ckpt.save_async(str(tmp_path), 9, {"A": t})
    t.fill_(7.0)
    path = handle.result(timeout=30)
    assert path.endswith("step_9.npz") and handle.done()
    got, _ = ckpt.restore(str(tmp_path), {"A": torch.empty(1000)})
    assert not got["A"].any()
    assert ckpt.verify_step(str(tmp_path), 9)


def test_async_save_surfaces_write_failure(tmp_path):
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("")
    handle = ckpt.save_async(str(blocker), 7, tree_at(1.0))
    with pytest.raises(ckpt.CheckpointError, match="async save"):
        handle.join(timeout=30)
    with pytest.raises(ckpt.CheckpointError, match="async save"):
        handle.result(timeout=30)


def test_restore_missing_and_shape_mismatch(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), {})
    ckpt.save(str(tmp_path), 1, {"w": torch.zeros(4)})
    with pytest.raises(ckpt.CheckpointError, match="shape"):
        ckpt.restore(str(tmp_path), {"w": torch.empty(5)})
    with pytest.raises(ckpt.CheckpointError, match="missing"):
        ckpt.restore(str(tmp_path), {"v": torch.empty(4)})
    assert not [f for f in os.listdir(tmp_path) if ".corrupt" in f]


def test_manifest_digests_and_bit_rot(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 2, tree_at(1.0))
    with open(tmp_path / "step_2.json") as f:
        manifest = json.load(f)
    assert manifest["step"] == 2
    assert all(len(leaf["sha256"]) == 64
               for leaf in manifest["leaves"].values())
    assert ckpt.verify_step(d, 2)
    FaultPlan({"ckpt/write": [
        FaultSpec(kind="corrupt-bytes", always=True, nbytes=8)]}
              ).fire("ckpt/write", path=os.path.join(d, "step_2.npz"))
    assert not ckpt.verify_step(d, 2)
    assert not jckpt.verify_step(d, 2)


def test_corrupt_newest_quarantined_falls_back(tmp_path, tracer):
    d = str(tmp_path)
    ckpt.save(d, 1, tree_at(1.0))
    ckpt.save(d, 5, tree_at(5.0))
    npz = os.path.join(d, "step_5.npz")
    os.truncate(npz, os.path.getsize(npz) // 2)
    with pytest.warns(UserWarning, match="quarantined"):
        tree, step = ckpt.restore(d, like_of(tree_at(0.0)))
    assert step == 1 and torch.equal(tree["w"], torch.full((4, 3), 1.0))
    names = sorted(os.listdir(d))
    assert "step_5.corrupt.npz" in names and "step_5.npz" not in names
    with open(os.path.join(d, "LATEST")) as f:
        assert f.read().strip() == "1"
    (ev,) = [e["args"] for e in tracer.events
             if e.get("name") == "ckpt/quarantine"]
    assert ev["step"] == 5 and ev["files"] == 2
    _, step = ckpt.restore(d, like_of(tree_at(0.0)))
    assert step == 1


def test_kill_between_replaces_detected(tmp_path):
    """npz replaced, manifest stale: the leaf sets disagree, nothing
    restores."""
    d = str(tmp_path)
    ckpt.save(d, 3, tree_at(3.0))
    with open(os.path.join(d, "step_3.npz"), "wb") as f:
        np.savez(f, other=np.zeros(2, np.float32))
    with pytest.warns(UserWarning, match="quarantined"), \
            pytest.raises(ckpt.CheckpointError, match="no verifiable"):
        ckpt.restore(d, like_of(tree_at(0.0)))


def test_corrupt_latest_falls_back_to_scan_and_explicit_step(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 4, tree_at(4.0))
    ckpt.save(d, 9, tree_at(9.0))
    _, step = ckpt.restore(d, like_of(tree_at(0.0)), step=4)
    assert step == 4
    with pytest.raises(ckpt.CheckpointError, match="<= 0"):
        ckpt.restore(d, like_of(tree_at(0.0)), step=0)
    with open(os.path.join(d, "LATEST"), "w") as f:
        f.write("not-a-step")
    with pytest.warns(UserWarning, match="LATEST"):
        assert ckpt.latest_step(d) == 9


def test_write_and_read_seams_heal(tmp_path):
    """A FaultPlan tears the second save through ckpt/write; restore
    probes ckpt/read per candidate step, quarantines the torn one and
    serves the first, as repro's does under the same plan."""
    results = []
    for pkg, plan_cls, spec_cls, act, tree_fn, like in (
            (ckpt, FaultPlan, FaultSpec, faults.active, tree_at,
             lambda: like_of(tree_at(0.0))),
            (jckpt, *_repro_plan(), lambda v: {"w": jnp.full((4, 3), v)},
             lambda: {"w": jax.ShapeDtypeStruct((4, 3), jnp.float32)})):
        d = str(tmp_path / pkg.__name__)
        pkg.save(d, 1, tree_fn(1.0))
        plan = plan_cls({"ckpt/write": [
            spec_cls(kind="truncate-file", always=True, fraction=0.3)]})
        with act(plan):
            pkg.save(d, 2, tree_fn(2.0))
            with pytest.warns(UserWarning, match="quarantined"):
                tree, step = pkg.restore(d, like())
        results.append((plan.hits, step, float(np.asarray(tree["w"])[0, 0])))
    assert results[0] == results[1] == (
        {"ckpt/write": 1, "ckpt/read": 2}, 1, 1.0)


def _repro_plan():
    from repro.resilience import FaultPlan as JPlan
    from repro.resilience import FaultSpec as JSpec
    from repro.resilience import faults as j_faults
    return JPlan, JSpec, j_faults.active


def test_atomic_writers_still_importable_from_the_package(tmp_path):
    path = ckpt.atomic_json_dump(str(tmp_path / "a" / "x.json"), {"k": 1})
    assert json.load(open(path)) == {"k": 1}
    ckpt.atomic_write(str(tmp_path / "b.bin"), "wb",
                      lambda f: f.write(b"abc"))
    assert (tmp_path / "b.bin").read_bytes() == b"abc"
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
