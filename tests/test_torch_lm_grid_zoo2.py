"""The LM zoo's SSM (mamba2-1.3b), hybrid (hymba-1.5b), enc-dec
(whisper-large-v3) and VLM (internvl2-26b) families on the process grid
against repro: tests/test_torch_lm_grid_zoo.py's train and serve checks,
with its tolerances, on spawned 2 x 2 and 1 x 4 CPU gloo grids.

What each grid exercises at the reduced configs: mamba2's in_proj and
out_proj replicate (the block runs whole on every model rank), its
cache's state splits over its 8 heads and its conv window over its 144
channels (gathered whole for each decode step); hymba's 4 query and 2
KV heads go through the sliding window on each rank's heads, and its
ring's 16 slots split over "model" (the decode combines the ranks'
partial attention); whisper's encoder (non-causal) and cross attention
are tensor parallel and its read-only xk and xv (8 frames) are
sequence-sharded; internvl2's 4 patches go before the vocab-parallel
lookup's tokens.  A 6-head whisper on 1 x 4 takes the gather path in
the encoder, the decoder and the cross attention.
"""
import pytest

import test_torch_lm_grid_zoo as zoo
from repro_torch.launch.mesh import spawn_grid

ARCHS_HERE = ("mamba2-1.3b", "hymba-1.5b", "whisper-large-v3",
              "internvl2-26b")
EDGES = {"six-heads-encdec": ("whisper-large-v3", dict(n_heads=6,
                                                       n_kv=6))}


@pytest.fixture(scope="module")
def refs():
    return zoo.family_refs(ARCHS_HERE, EDGES)


@pytest.fixture(scope="module")
def grid22(refs, tmp_path_factory):
    return spawn_grid(zoo.cell_jobs, tmp_path_factory.mktemp("y22"),
                      data=2, model=2, lm=True,
                      args=(zoo.family_jobs(refs),))


@pytest.fixture(scope="module")
def grid14(refs, tmp_path_factory):
    return spawn_grid(zoo.cell_jobs, tmp_path_factory.mktemp("y14"),
                      data=1, model=4, lm=True,
                      args=(zoo.family_jobs(refs),))


@pytest.mark.parametrize("shape", ["grid22", "grid14"])
@pytest.mark.parametrize("name", ARCHS_HERE + tuple(EDGES))
def test_grid_train_steps_match_repro(name, shape, refs, request):
    cells = request.getfixturevalue(shape)
    zoo.check_train(zoo.job(cells, zoo.family_index(refs, name, False)),
                    refs[name]["train"])


@pytest.mark.parametrize("shape", ["grid22", "grid14"])
@pytest.mark.parametrize("name", ARCHS_HERE + tuple(EDGES))
def test_grid_prefill_and_decode_match_repro(name, shape, refs, request):
    cells = request.getfixturevalue(shape)
    zoo.check_serve(zoo.job(cells, zoo.family_index(refs, name, True)),
                    refs[name])


def test_cache_blocks_follow_cache_specs(refs, grid14):
    """1 x 4: mamba2's state over its heads (8 / 4) and conv window over
    its channels (144 / 4); hymba's ring over its window's 16 slots;
    whisper's k / v over positions (40 / 4) and xk / xv over its 8
    frames."""
    want = {"mamba2-1.3b": {"ssm": (2, 4, 2, 16, 8), "conv": (2, 4, 3, 36)},
            "hymba-1.5b": {"k": (2, 4, 4, 2, 16), "v": (2, 4, 4, 2, 16),
                           "ssm": (2, 4, 2, 16, 8), "conv": (2, 4, 3, 36)},
            "whisper-large-v3": {"k": (2, 4, 10, 2, 16),
                                 "v": (2, 4, 10, 2, 16),
                                 "xk": (2, 4, 2, 2, 16),
                                 "xv": (2, 4, 2, 2, 16)}}
    for name, shapes in want.items():
        for c in zoo.job(grid14, zoo.family_index(refs, name, True)):
            assert c["cache"] == shapes, name
