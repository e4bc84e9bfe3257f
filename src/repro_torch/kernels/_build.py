"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``.  The library
lives under ``build/repro_torch_kernels/<hash>/`` at the root of the
checkout, keyed by a hash of the sources and flags, and is built on first
use: one ``nvcc -c`` per source, all started together, then one link.
Nothing is downloaded or prebuilt.

Every launcher is ``extern "C"``, takes ``void*`` for each pointer and
the stream, and returns the launch's ``cudaGetLastError()`` as an int.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# flash_attention's two launchers: q, k, v, out; b, hq, hkv, sq, skv, d;
# the (b, h, s) strides of q, k, v, out; causal, q_offset, sm_scale; stream
_FLASH = [_P] * 4 + [_I] * 6 + [_L] * 12 + [_I, _I, _F, _P]

# launcher name -> argtypes (pointers and the stream as void*)
SIGNATURES = {
    "repro_bcsr_spmm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _L,
                        _P],
    "repro_flash_attention": _FLASH,        # fp32, FMA
    "repro_flash_attention_sm90": _FLASH,   # bf16, tensor cores
    "repro_bcsr_xa_xta": [_P] * 10 + [_I] * 8 + [_L] * 3 + [_P],
    "repro_fused_xa_xtb": [_P] * 9 + [_I] * 5 + [_L] * 5 + [_I] * 4 + [_P],
    "repro_mu_update_a": [_P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _F, _P],
    "repro_score_topk": [_P] * 8 + [_I] * 9 + [_P],
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join((ARCH,) + FLAGS).encode())
    return h.hexdigest()[:16]


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {path}); "
                           f"the CUDA kernels build on a machine with the "
                           f"CUDA toolkit")
    return path


def build(verbose: bool = False) -> Path:
    """Compile the sources (if this hash is not built yet) and return the
    library path.  ``verbose`` adds ``-Xptxas -v`` and prints nvcc's
    report of registers, shared memory and spills."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / "librepro_torch_kernels.so"
    if lib.exists() and not verbose:
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    extra = ("-Xptxas", "-v") if verbose else ()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [exe, ARCH, *FLAGS, *extra, "-c", str(src), "-o", obj]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
            objs.append(obj)
        failed = []
        for src, proc in procs:
            log, _ = proc.communicate()
            if verbose and log:
                print(f"[nvcc] {src.name}\n{log}")
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = os.path.join(tmp, lib.name)
        link = subprocess.run([exe, ARCH, "-shared", *objs, "-o", tmp_lib],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(tmp_lib, lib)   # atomic: concurrent builders agree
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with argtypes and
    restype set for every launcher."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, kernel: str) -> None:
    """Raise when a launcher (or a plan) reported a CUDA error (a refused
    launch never runs, and a later synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: refused or failed with CUDA error "
                           f"{rc}")
