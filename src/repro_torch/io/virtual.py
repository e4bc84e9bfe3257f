"""Virtual datasets: shard-local generation of tensors that never exist
(port of ``repro/io/virtual.py``).

The paper's 11 TB dense and 9 EB sparse runs (§6.3) work because each
rank generates its shard in place.  A ``VirtualSpec`` describes the
tensor; every shard (i, j) is made from the spec and its index alone:

  * factor-sized ground truth: A (n, k) Gaussian bumps and R (m, k, k)
    Exponential(1), the recipe of ``data/synthetic.py``;
  * the stored-block pattern of a bcsr shard: uniform density, or zipf
    block-row weights under ``skew`` (w_r ~ (r + 1)^-skew over the global
    block rows, normalized to mean 1, keep probability clamped at 1), the
    diagonal blocks always stored;
  * values A_i R_t A_j^T times uniform noise in [1 - noise, 1 + noise],
    on the stored blocks only, generated on the device a chunk of blocks
    at a time (``CHUNK_BLOCKS``), never as one product of the shard's
    size.

Spec strings (the ``rescalk_run --data`` syntax) mean the same as in
``repro``, character for character:

    virtual:dense:n=1024,m=4,k=5,grid=2,noise=0.01,seed=0
    virtual:bcsr:n=16384,m=4,k=5,bs=128,grid=1,density=0.02,seed=0
    virtual:bcsr:n=16384,m=4,k=5,bs=128,density=0.02,skew=1.2,seed=0

The draws come from a source, as the ensemble's do (``selection/
draws.py``).  ``SeededSource`` (the default) takes the factor-sized draws
from ``repro``'s own ``jax.random`` key tree, recomputed in numpy
(``io/threefry.py``): the ground truth (A from the spec's first key, R
from its second) and every shard's pattern uniforms (the third, folded
with the linear shard index) — so a spec string stores the same blocks
with the same ground truth in both packages, and its manifest is
``repro``'s.  The value noise (m * nnzb * bs^2 draws, 820M at full size)
comes from torch generators on the data's device, one per (spec seed,
stream, linear shard index, chunk) through ``device.seeded_generator``:
there the two packages' tensors share a recipe, not bits.
``ArraySource`` serves arrays drawn elsewhere; the parity tests fill it
with ``repro``'s own draws, noise included.  The pattern is a pure
function of the uniforms that reproduces ``repro``'s comparisons: ``u <
density`` in float32 (numpy's weak Python float), ``u < min(density * w,
1)`` in float64 under skew.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Mapping, Protocol

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.sparse import BCSR
from repro_torch.obs import trace as obs

from . import threefry
from .partition import ShardedBCSR, identity_partition

__all__ = ["ArraySource", "SeededSource", "VirtualSpec", "virtual_bcsr_shard",
           "virtual_dense_full", "virtual_dense_shard", "virtual_shard_nnzb",
           "virtual_sharded_bcsr"]

# stored blocks generated per chunk: m * CHUNK_BLOCKS * bs^2 values at a
# time (134 MB at m = 8, bs = 128); the seeded noise depends on it
CHUNK_BLOCKS = 256
# stream word of SeededSource's value noise
_NOISE = 3


@dataclasses.dataclass(frozen=True)
class VirtualSpec:
    """Deterministic description of a virtual dataset; the manifest digest
    is the sha1 of ``spec_string()``."""
    kind: str                  # "dense" | "bcsr"
    n: int
    m: int
    k: int
    bs: int = 128
    grid: int = 1              # g (square)
    density: float = 0.02      # stored-block density (bcsr)
    skew: float = 0.0          # zipf block-row exponent (bcsr; 0 = uniform)
    noise: float = 0.01
    seed: int = 0
    correlated: bool = False
    dtype: str = "float32"

    def __post_init__(self):
        if self.kind not in ("dense", "bcsr"):
            raise ValueError(f"unknown virtual kind {self.kind!r}")
        if self.skew and self.kind != "bcsr":
            raise ValueError("skew= applies to bcsr patterns only")
        if self.skew < 0:
            raise ValueError(f"skew must be >= 0, got {self.skew}")
        if self.kind == "bcsr":
            if self.n % (self.grid * self.bs):
                raise ValueError(
                    f"virtual bcsr requires grid*bs | n "
                    f"({self.grid}*{self.bs} vs n={self.n})")
        elif self.n % self.grid:
            raise ValueError(f"virtual dense requires grid | n "
                             f"({self.grid} vs n={self.n})")

    # -- derived -------------------------------------------------------------
    @property
    def n_loc(self) -> int:
        return self.n // self.grid

    @property
    def nb(self) -> int:
        return self.n // self.bs

    @property
    def nb_loc(self) -> int:
        return self.nb // self.grid

    @property
    def torch_dtype(self) -> torch.dtype:
        dt = getattr(torch, self.dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        return dt

    @property
    def logical_bytes(self) -> int:
        """Bytes of the dense (m, n, n) tensor this dataset represents."""
        return self.m * self.n * self.n * self.torch_dtype.itemsize

    def spec_string(self) -> str:
        fields = [f"n={self.n}", f"m={self.m}", f"k={self.k}"]
        if self.kind == "bcsr":
            fields += [f"bs={self.bs}", f"density={self.density:g}"]
            if self.skew:
                fields.append(f"skew={self.skew:g}")
        fields += [f"grid={self.grid}", f"noise={self.noise:g}",
                   f"seed={self.seed}"]
        if self.correlated:
            fields.append("correlated=1")
        if self.dtype != "float32":
            fields.append(f"dtype={self.dtype}")
        return f"virtual:{self.kind}:" + ",".join(fields)

    @classmethod
    def parse(cls, s: str) -> "VirtualSpec":
        """Parse a ``virtual:<kind>:k1=v1,k2=v2`` spec string."""
        parts = s.split(":")
        if len(parts) != 3 or parts[0] != "virtual":
            raise ValueError(
                f"bad virtual spec {s!r} (want virtual:<kind>:k=v,...)")
        kind = parts[1]
        kw: dict = {}
        casts = {"n": int, "m": int, "k": int, "bs": int, "grid": int,
                 "seed": int, "density": float, "skew": float,
                 "noise": float,
                 "correlated": lambda v: bool(int(v)), "dtype": str}
        for item in filter(None, parts[2].split(",")):
            name, _, val = item.partition("=")
            if name not in casts:
                raise ValueError(f"unknown virtual spec field {name!r}")
            kw[name] = casts[name](val)
        for req in ("n", "m", "k"):
            if req not in kw:
                raise ValueError(f"virtual spec needs {req}= ({s!r})")
        return cls(kind=kind, **kw)

    def ground_truth(self, source=None, device=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """(A_true (n, k), R_true (m, k, k)) on ``device`` (default
        ``cuda``) in the spec's dtype."""
        return _source(source).ground_truth(self, _device.resolve(device))


# ---------------------------------------------------------------------------
# Draw sources
# ---------------------------------------------------------------------------

class VirtualSource(Protocol):
    def ground_truth(self, spec: VirtualSpec, device: torch.device
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """(A (n, k), R (m, k, k)) in the spec's dtype on ``device``."""

    def uniforms(self, spec: VirtualSpec, i: int, j: int) -> np.ndarray:
        """Shard (i, j)'s (nb_loc, nb_loc) float32 pattern uniforms."""

    def noise(self, spec: VirtualSpec, i: int, j: int, part: int, index,
              out: torch.Tensor) -> None:
        """Write chunk ``part`` of shard (i, j)'s noise into ``out``: the
        part ``index`` selects of the shard's whole noise array ((m,
        nnzb, bs, bs) over the unpadded stored blocks, or (m, n_loc,
        n_loc) dense)."""


def _threefry_features(key, n: int, k: int, *, correlated: bool,
                       width: float = 0.06, floor: float = 0.01
                       ) -> np.ndarray:
    """``repro``'s ``gaussian_features`` (data/synthetic.py:16) on the
    numpy threefry: (n, k) float32 Gaussian bumps over the entity axis."""
    kc, kw = threefry.split(key)
    f32 = np.float32
    if correlated:
        centers = f32(0.25) + f32(0.5) * threefry.uniform(kc, (k,))
    else:
        centers = ((np.arange(k, dtype=f32) + f32(0.5)) / f32(k)
                   + f32(0.1) / f32(k) * threefry.normal(kc, (k,)))
    widths = f32(width) * (f32(0.5) + threefry.uniform(kw, (k,)))
    t = np.linspace(0.0, 1.0, n, dtype=f32)[:, None]
    A = np.exp(f32(-0.5) * ((t - centers[None, :]) / widths[None, :]) ** 2)
    return (A + f32(floor)).astype(f32)


class SeededSource:
    """The default source: ``repro``'s key tree for the ground truth and
    the pattern (numpy threefry, on the host), torch generators for the
    value noise."""

    @staticmethod
    def _keys(spec):
        return threefry.split(threefry.prng_key(spec.seed), 4)  # a r p n

    def ground_truth(self, spec, device):
        ka, kr, _, _ = self._keys(spec)
        A = _threefry_features(ka, spec.n, spec.k,
                               correlated=spec.correlated)
        R = threefry.exponential(kr, (spec.m, spec.k, spec.k))
        dt = spec.torch_dtype
        return (torch.from_numpy(A).to(device=device, dtype=dt),
                torch.from_numpy(R).to(device=device, dtype=dt))

    def uniforms(self, spec, i, j):
        kp = self._keys(spec)[2]
        return threefry.uniform(threefry.fold_in(kp, i * spec.grid + j),
                                (spec.nb_loc, spec.nb_loc))

    def noise(self, spec, i, j, part, index, out):
        g = _device.seeded_generator(spec.seed, _NOISE, i * spec.grid + j,
                                     part, device=out.device)
        out.uniform_(1.0 - spec.noise, 1.0 + spec.noise, generator=g)


class ArraySource:
    """Draws handed in as arrays: the ground truth ``A`` (n, k) and ``R``
    (m, k, k), ``uniforms[(i, j)]`` (nb_loc, nb_loc) and ``noise[(i, j)]``
    (the shard's whole noise array), numpy or anything ``np.asarray``
    takes."""

    def __init__(self, A, R, uniforms: Mapping | None = None,
                 noise: Mapping | None = None):
        self.A, self.R = np.array(A), np.array(R)
        self._uniforms = dict(uniforms or {})
        self._noise = {key: np.array(v) for key, v in (noise or {}).items()}

    def ground_truth(self, spec, device):
        dt = spec.torch_dtype
        return (torch.as_tensor(self.A).to(device=device, dtype=dt),
                torch.as_tensor(self.R).to(device=device, dtype=dt))

    def uniforms(self, spec, i, j):
        return np.asarray(self._uniforms[(i, j)], np.float32)

    def noise(self, spec, i, j, part, index, out):
        out.copy_(torch.as_tensor(self._noise[(i, j)][index]))


def _source(source) -> VirtualSource:
    return SeededSource() if source is None else source


# ---------------------------------------------------------------------------
# The stored-block pattern
# ---------------------------------------------------------------------------

def pattern_from_uniforms(spec: VirtualSpec, i: int, j: int,
                          u: np.ndarray) -> np.ndarray:
    """(nb_loc, nb_loc) bool stored-block pattern of shard (i, j) from its
    uniforms ``u``: ``repro``'s ``_shard_pattern`` comparisons, the
    uniform one in float32, the skewed one in float64."""
    u = np.asarray(u, np.float32)
    if spec.skew:
        w = (np.arange(spec.nb) + 1.0) ** -spec.skew
        w *= spec.nb / w.sum()
        rows_w = w[i * spec.nb_loc:(i + 1) * spec.nb_loc]
        keep = u.astype(np.float64) < np.minimum(spec.density * rows_w,
                                                 1.0)[:, None]
    else:
        keep = u < np.float32(spec.density)
    if i == j:
        keep |= np.eye(spec.nb_loc, dtype=bool)
    return keep


@functools.lru_cache(maxsize=256)
def _seeded_pattern(spec: VirtualSpec, i: int, j: int) -> np.ndarray:
    """Memoized: the manifest, the stacking pass and the value generation
    all consult the same pattern."""
    keep = pattern_from_uniforms(spec, i, j,
                                 SeededSource().uniforms(spec, i, j))
    keep.setflags(write=False)
    return keep


def shard_pattern(spec: VirtualSpec, i: int, j: int,
                  source=None) -> np.ndarray:
    """Shard (i, j)'s stored-block pattern under ``source``."""
    if source is None or type(source) is SeededSource:
        return _seeded_pattern(spec, i, j)
    return pattern_from_uniforms(spec, i, j, source.uniforms(spec, i, j))


def virtual_shard_nnzb(spec: VirtualSpec, source=None) -> np.ndarray:
    """(g, g) stored-block counts: index-only accounting, no block data
    is generated (what the manifest reports for huge specs)."""
    g = spec.grid
    return np.array([[int(shard_pattern(spec, i, j, source).sum())
                      for j in range(g)] for i in range(g)], np.int64)


# ---------------------------------------------------------------------------
# Values
# ---------------------------------------------------------------------------

def _fill_blocks(spec: VirtualSpec, i: int, j: int, rows: np.ndarray,
                 cols: np.ndarray, out: torch.Tensor, truth, source) -> None:
    """Shard (i, j)'s stored blocks (row-major ``rows``/``cols``, shard-
    local) into ``out`` (m, nnzb, bs, bs): A_i R_t A_j^T times the noise,
    CHUNK_BLOCKS blocks at a time."""
    A, R = truth
    dev = out.device
    bs, k = spec.bs, spec.k
    Ab = A.reshape(spec.nb, bs, k)
    ri = torch.from_numpy(i * spec.nb_loc + rows.astype(np.int64)).to(dev)
    ci = torch.from_numpy(j * spec.nb_loc + cols.astype(np.int64)).to(dev)
    for part, z0 in enumerate(range(0, rows.shape[0], CHUNK_BLOCKS)):
        z1 = min(z0 + CHUNK_BLOCKS, rows.shape[0])
        AR = torch.einsum("zak,mkl->mzal", Ab[ri[z0:z1]], R)
        vals = AR @ Ab[ci[z0:z1]].transpose(-1, -2)      # (m, zc, bs, bs)
        noise = torch.empty_like(vals)
        source.noise(spec, i, j, part, (slice(None), slice(z0, z1)), noise)
        out[:, z0:z1].copy_(vals.mul_(noise))


def virtual_bcsr_shard(spec: VirtualSpec, i: int, j: int,
                       pad_to: int | None = None, *, source=None,
                       device=None) -> BCSR:
    """Shard (i, j)'s local BCSR on ``device`` (default ``cuda``): low-rank
    Gaussian-bump content on the stored blocks only, with shard-local
    noise.  Memory is O(nnzb_loc * bs^2): the dense block never exists.
    ``pad_to`` front-pads with zero blocks at (0, 0) to a fixed nnzb (the
    stacking contract of ``ShardedBCSR``)."""
    if spec.kind != "bcsr":
        raise ValueError("virtual_bcsr_shard needs a bcsr spec")
    dev = _device.resolve(device)
    source = _source(source)
    rows, cols = np.nonzero(shard_pattern(spec, i, j, source))
    z = max(pad_to or 0, rows.shape[0])
    pad = z - rows.shape[0]
    data = torch.zeros((spec.m, z, spec.bs, spec.bs),
                       dtype=spec.torch_dtype, device=dev)
    _fill_blocks(spec, i, j, rows, cols, data[:, pad:],
                 source.ground_truth(spec, dev), source)
    idx = np.zeros((2, z), np.int32)
    idx[0, pad:], idx[1, pad:] = rows, cols
    return BCSR(data=data, block_rows=torch.from_numpy(idx[0]).to(dev),
                block_cols=torch.from_numpy(idx[1]).to(dev), n=spec.n_loc)


def virtual_sharded_bcsr(spec: VirtualSpec, *, source=None,
                         device=None) -> ShardedBCSR:
    """All shards of a virtual sparse dataset, stacked into the grid
    operand layout on ``device`` (default ``cuda``), each generated in its
    slot of the stack.  The partition is the identity (the generator lays
    its blocks out itself)."""
    if spec.kind != "bcsr":
        raise ValueError("virtual_sharded_bcsr needs a bcsr spec")
    dev = _device.resolve(device)
    source = _source(source)
    g = spec.grid
    with obs.span("ingest/virtual", spec=spec.spec_string()):
        nnzb = virtual_shard_nnzb(spec, source)
        z_max = max(int(nnzb.max()), 1)
        data = torch.zeros((g, g, spec.m, z_max, spec.bs, spec.bs),
                           dtype=spec.torch_dtype, device=dev)
        idx = np.zeros((2, g, g, z_max), np.int32)
        truth = source.ground_truth(spec, dev)
        for i in range(g):
            for j in range(g):
                rows, cols = np.nonzero(shard_pattern(spec, i, j, source))
                pad = z_max - rows.shape[0]
                idx[0, i, j, pad:], idx[1, i, j, pad:] = rows, cols
                _fill_blocks(spec, i, j, rows, cols, data[i, j, :, pad:],
                             truth, source)
        return ShardedBCSR(part=identity_partition(spec.n, spec.bs, g),
                           data=data, rows=torch.from_numpy(idx[0]).to(dev),
                           cols=torch.from_numpy(idx[1]).to(dev), nnzb=nnzb)


def _fill_dense(spec: VirtualSpec, i: int, j: int, out: torch.Tensor,
                truth, source) -> None:
    """Block X^(i,j) into ``out`` (m, n_loc, n_loc), one relation slice at
    a time."""
    A, R = truth
    nl = spec.n_loc
    Ai, Aj = A[i * nl:(i + 1) * nl], A[j * nl:(j + 1) * nl]
    noise = torch.empty((nl, nl), dtype=A.dtype, device=A.device)
    for t in range(spec.m):
        source.noise(spec, i, j, t, (t,), noise)
        out[t].copy_(((Ai @ R[t]) @ Aj.T).mul_(noise))


def virtual_dense_shard(spec: VirtualSpec, i: int, j: int, *, source=None,
                        device=None) -> torch.Tensor:
    """Block X^(i,j) (m, n_loc, n_loc) of the virtual dense tensor on
    ``device`` (default ``cuda``), from (spec, shard index) alone."""
    if spec.kind != "dense":
        raise ValueError("virtual_dense_shard needs a dense spec")
    dev = _device.resolve(device)
    source = _source(source)
    out = torch.empty((spec.m, spec.n_loc, spec.n_loc),
                      dtype=spec.torch_dtype, device=dev)
    _fill_dense(spec, i, j, out, source.ground_truth(spec, dev), source)
    return out


def virtual_dense_full(spec: VirtualSpec, *, source=None,
                       device=None) -> torch.Tensor:
    """The full (m, n, n) tensor assembled from its shards on ``device``
    (default ``cuda``): single-device runs and the parity oracle; memory
    O(n^2), so only where that fits."""
    if spec.kind != "dense":
        raise ValueError("virtual_dense_full needs a dense spec")
    dev = _device.resolve(device)
    source = _source(source)
    nl = spec.n_loc
    out = torch.empty((spec.m, spec.n, spec.n), dtype=spec.torch_dtype,
                      device=dev)
    with obs.span("ingest/virtual", spec=spec.spec_string()):
        truth = source.ground_truth(spec, dev)
        for i in range(spec.grid):
            for j in range(spec.grid):
                _fill_dense(spec, i, j,
                            out[:, i * nl:(i + 1) * nl, j * nl:(j + 1) * nl],
                            truth, source)
    return out
