"""FactorBundle — the versioned on-disk artifact of the swept factors
(port of ``repro/serve/bundle.py``).

Layout (one directory), the same as ``repro``'s, so a bundle written by
either package loads in the other:

    bundle.json    format_version, shapes, sha1 digest of the factor
                   bytes, optional vocab (entities/relations in id order),
                   optional training-operand manifest fingerprint, meta
                   (k_opt, criterion, rel_err, ...)
    factors.npz    A (n, k) f32, R (m, k, k) f32, optional permutation

Both files are written through a temporary file and ``os.replace``.
``load`` re-derives the digest and refuses factors that do not match
their manifest.  The arrays are numpy; ``ServeEngine`` moves them to the
device.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import zipfile

import numpy as np

from repro_torch.ckpt import atomic_json_dump, atomic_write

FORMAT_VERSION = 1
ARRAYS_NAME = "factors.npz"
MANIFEST_NAME = "bundle.json"

# what np.load raises on a file that is not a readable npz (pickles are
# refused, so a non-npz file gives ValueError)
_NOT_NPZ = (ValueError, EOFError, zipfile.BadZipFile)


class BundleError(Exception):
    """Missing/malformed/corrupt bundle artifact."""


def _digest(A: np.ndarray, R: np.ndarray) -> str:
    h = hashlib.sha1()
    for arr in (A, R):
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class FactorBundle:
    A: np.ndarray                              # (n, k) float32
    R: np.ndarray                              # (m, k, k) float32
    entities: list[str] | None = None          # vocab, id order
    relations: list[str] | None = None
    permutation: np.ndarray | None = None      # row permutation of A
    manifest: dict | None = None               # training-operand fingerprint
    meta: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.A = np.ascontiguousarray(self.A, dtype=np.float32)
        self.R = np.ascontiguousarray(self.R, dtype=np.float32)
        if self.A.ndim != 2 or self.R.ndim != 3 or \
                self.R.shape[1] != self.R.shape[2] or \
                self.R.shape[1] != self.A.shape[1]:
            raise BundleError(f"inconsistent factor shapes A{self.A.shape} "
                              f"R{self.R.shape}")

    @property
    def n(self) -> int:
        return self.A.shape[0]

    @property
    def k(self) -> int:
        return self.A.shape[1]

    @property
    def m(self) -> int:
        return self.R.shape[0]

    def digest(self) -> str:
        return _digest(self.A, self.R)

    @classmethod
    def from_sweep(cls, res, *, entities=None, relations=None,
                   permutation=None, manifest=None,
                   meta: dict | None = None) -> "FactorBundle":
        """Package a RescalkResult's selected-k factors: the member-median
        A and its regressed R."""
        kr = res.per_k[res.k_opt]
        info = {"k_opt": int(res.k_opt),
                "ks": [int(k) for k in np.asarray(res.ks).tolist()],
                "rel_err": float(np.asarray(res.rel_err)[
                    list(res.ks).index(res.k_opt)])}
        info.update(meta or {})
        return cls(A=kr.A_median, R=kr.R_regress, entities=entities,
                   relations=relations, permutation=permutation,
                   manifest=manifest, meta=info)

    def save(self, bundle_dir: str) -> str:
        """Write factors.npz, then bundle.json, each whole or not at all.
        A crash between the two leaves old JSON beside new arrays, which
        ``load`` refuses by their digest."""
        os.makedirs(bundle_dir, exist_ok=True)
        arrays = {"A": self.A, "R": self.R}
        if self.permutation is not None:
            arrays["permutation"] = np.asarray(self.permutation)
        atomic_write(os.path.join(bundle_dir, ARRAYS_NAME), "wb",
                     lambda f: np.savez(f, **arrays))
        doc = {"format_version": FORMAT_VERSION,
               "n": self.n, "m": self.m, "k": self.k,
               "digest": self.digest(),
               "arrays": ARRAYS_NAME,
               "entities": self.entities,
               "relations": self.relations,
               "manifest": self.manifest,
               "meta": self.meta}
        atomic_json_dump(os.path.join(bundle_dir, MANIFEST_NAME), doc,
                         indent=1, default=str)
        return bundle_dir

    @classmethod
    def load(cls, bundle_dir: str) -> "FactorBundle":
        man_path = os.path.join(bundle_dir, MANIFEST_NAME)
        try:
            with open(man_path) as f:
                doc = json.load(f)
        except OSError as ex:
            raise BundleError(f"cannot read {man_path}: "
                              f"{ex.strerror or ex}") from ex
        except json.JSONDecodeError as ex:
            raise BundleError(f"{man_path} is not valid JSON: {ex}") from ex
        if doc.get("format_version") != FORMAT_VERSION:
            raise BundleError(f"{man_path}: format_version "
                              f"{doc.get('format_version')!r}, this build "
                              f"reads {FORMAT_VERSION}")
        npz_path = os.path.join(bundle_dir, doc.get("arrays", ARRAYS_NAME))
        try:
            data = np.load(npz_path)
        except OSError as ex:
            raise BundleError(f"cannot read {npz_path}: "
                              f"{ex.strerror or ex}") from ex
        except _NOT_NPZ as ex:
            raise BundleError(f"{npz_path} is not a readable npz: "
                              f"{ex}") from ex
        with data:
            if "A" not in data.files or "R" not in data.files:
                raise BundleError(f"{npz_path}: needs 'A' and 'R' arrays, "
                                  f"has {sorted(data.files)}")
            try:
                A, R = data["A"], data["R"]
                perm = data["permutation"] if "permutation" in data.files \
                    else None
            except (OSError, *_NOT_NPZ) as ex:    # a truncated member
                raise BundleError(f"{npz_path} is not a readable npz: "
                                  f"{ex}") from ex
        bundle = cls(A=A, R=R, entities=doc.get("entities"),
                     relations=doc.get("relations"), permutation=perm,
                     manifest=doc.get("manifest"),
                     meta=doc.get("meta") or {})
        for field, want in (("n", bundle.n), ("m", bundle.m),
                            ("k", bundle.k)):
            if doc.get(field) != want:
                raise BundleError(f"{man_path}: {field}={doc.get(field)!r} "
                                  f"but {npz_path} holds {field}={want}")
        if doc.get("digest") != bundle.digest():
            raise BundleError(f"{bundle_dir}: factor digest mismatch — "
                              f"manifest {doc.get('digest')!r} vs arrays "
                              f"{bundle.digest()!r}")
        return bundle
