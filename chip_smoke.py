#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero; nothing is caught and passed over):

  1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with
     nvcc (sm_90a; ptxas register/shared-memory report printed) and print
     the card's name and power limit.
  2. Hold each kernel against its plain PyTorch version on the card: at
     edge shapes (bs not dividing n, empty block rows and cols, nnzb == 0,
     k in {3, 16}, r in {1, 4}) and at the sweep's shape with k = 8, to a
     relative Frobenius error <= 1e-5 and max |diff| <= 1e-4 * max |ref|
     (XTB's atomics and the plain version's sums add in different
     orders).  Times kernel, plain version and, for bcsr_spmm, the
     ``torch.sparse_bsr_tensor @ B`` yardstick with CUDA events.
  3. Run the RESCALk sweep through the CLI's own entry point
     (``repro_torch.launch.rescalk_run.main``) at full size on a seeded
     planted COO file: n = 131072 entities, m = 8 relations, bs = 128, the
     diagonal blocks plus 0.5% of the off-diagonal ones, ~2% of each
     stored block's entries per relation (~16M triples, ~3.3 GB of
     stored blocks), k = 2..5, r = 4 members, --use-fused-kernel.  The
     kernels' launch counters are zeroed just before and read just after:
     both must have launched.  One cut: 300 MU iterations per member
     (the CLI's default; the paper runs 1000).  The regression keeps its
     100 iterations; n, m, bs, the density and r are not cut.
  4. The same sweep with --fused-impl ref (plain PyTorch products on the
     card, the same TorchDraws numbers): the same k_opt, and per-k
     s_min/s_mean/rel_err within 1e-4.

The line before the last is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``.  Without CUDA, or without the port's
sources beside it, the script exits 1 and prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# The card's published peaks (H100 SXM data sheet): HBM bandwidth and
# fp32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12

REL_TOL = 1e-5        # relative Frobenius error, kernel vs plain version
ABS_TOL = 1e-4        # max |diff| / max |ref|
SWEEP_TOL = 1e-4      # per-k s_min / s_mean / rel_err, kernel vs ref sweep

FULL = dict(n=131072, m=8, bs=128, off_density=0.005, fill=0.02,
            k_min=2, k_max=5, r=4, iters=300, seed=0)


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseError(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# ---------------------------------------------------------------------------
# Phase 1: build and report
# ---------------------------------------------------------------------------

def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    _build.library()
    log(f"[build] {lib.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def compare(name: str, got, ref) -> float:
    """Raise unless got ~ ref; return max |got - ref|."""
    import torch
    require(got.shape == ref.shape,
            f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    diff = (got - ref).abs()
    max_abs = float(diff.max()) if diff.numel() else 0.0
    ref_max = float(ref.abs().max()) if ref.numel() else 0.0
    ref_norm = float(torch.linalg.vector_norm(ref))
    if ref_norm == 0.0:
        require(max_abs == 0.0, f"{name}: reference is zero, kernel is not")
        return 0.0
    rel = float(torch.linalg.vector_norm(got - ref)) / ref_norm
    require(rel <= REL_TOL, f"{name}: relative error {rel:.3e} > {REL_TOL}")
    require(max_abs <= ABS_TOL * ref_max,
            f"{name}: max |diff| {max_abs:.3e} > {ABS_TOL} * {ref_max:.3e}")
    return max_abs


def pattern_bcsr(rows, cols, n, bs, m, r, gen, dev):
    """A BCSR with the given (row-major) block pattern and uniform values,
    zero in the padded tail; member-stacked when r is not None."""
    import torch
    from repro_torch.core.sparse import BCSR, tail_mask
    nb = -(-n // bs)
    lead = (r, m) if r is not None else (m,)
    data = torch.rand(lead + (len(rows), bs, bs), generator=gen, device=dev)
    if rows:
        mask = tail_mask(n, bs, nb, device=dev).reshape(nb, bs)
        rt = torch.tensor(rows, device=dev)
        ct = torch.tensor(cols, device=dev)
        data *= mask[rt][:, :, None] * mask[ct][:, None, :]
    return BCSR(data=data.contiguous(),
                block_rows=torch.tensor(rows, dtype=torch.int32, device=dev),
                block_cols=torch.tensor(cols, dtype=torch.int32, device=dev),
                n=n)


def check_edges(dev) -> None:
    """Both kernels at the edge shapes, against their plain versions."""
    import torch
    from repro_torch.kernels import bcsr_fused, bcsr_spmm, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    # nb = 5: block rows 1 and 3 and block cols 0 and 4 store nothing
    gappy = ([0, 0, 2, 2, 4], [1, 3, 1, 2, 3])
    cases = [  # (n, bs, pattern, k, data members, operand members)
        (600, 128, gappy, 3, None, None),      # bs does not divide n
        (600, 128, gappy, 16, 4, 4),           # r = 4, k = 16
        (150, 32, gappy, 3, 4, 4),             # bs = 32, tail 10
        (160, 32, gappy, 16, None, 4),         # shared data, r = 4 operand
        (256, 128, ([], []), 3, None, None),   # nnzb == 0
        (256, 128, ([], []), 16, 4, 4),
    ]
    for n, bs, (rows, cols), k, dr, br in cases:
        sp = pattern_bcsr(rows, cols, n, bs, 3, dr, gen, dev)
        shape = (br, n, k) if br is not None else (n, k)
        B1 = torch.rand(shape, generator=gen, device=dev)
        B2 = torch.rand(shape, generator=gen, device=dev)
        xa, xt = bcsr_fused.bcsr_xa_xta(sp, B1, B2)
        sa = bcsr_spmm.bcsr_spmm(sp, B1)
        torch.cuda.synchronize()
        ra, rt = ref.ref_bcsr_xa_xta(sp, B1, B2)
        tag = f"n={n} bs={bs} nnzb={sp.nnzb} k={k} r={dr or br or 1}"
        compare(f"bcsr_xa_xta XA [{tag}]", xa, ra)
        compare(f"bcsr_xa_xta XTB [{tag}]", xt, rt)
        compare(f"bcsr_spmm [{tag}]", sa, ra)
        nb = -(-n // bs)
        for i in range(nb):
            sl = slice(i * bs, min((i + 1) * bs, n))
            if i not in rows:
                require(not xa[..., sl, :].any() and not sa[..., sl, :].any(),
                        f"empty block-row {i} not exactly zero [{tag}]")
            if i not in cols:
                require(not xt[..., sl, :].any(),
                        f"empty block-col {i} not exactly zero [{tag}]")
        log(f"[kernels] edge case {tag}: ok")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call, by CUDA events around `reps` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: int, flops: int) -> tuple[float, str]:
    """Least time the card could take: bytes over HBM bandwidth vs fp32
    operations over the fp32 peak, whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main_pattern(n, bs, off_density, seed):
    """The sweep's block pattern: the diagonal plus a seeded share of the
    off-diagonal blocks, row-major."""
    import numpy as np
    rng = np.random.default_rng(seed)
    nb = n // bs
    keep = rng.random((nb, nb)) < off_density
    keep |= np.eye(nb, dtype=bool)
    rows, cols = np.nonzero(keep)
    return rng, rows, cols


def bsr_yardstick(sp, B):
    """torch.sparse_bsr_tensor @ B for X_t @ B, all t: the m slices
    stacked as one (m * n_pad, n_pad) BSR matrix over the same values."""
    import torch
    m, nnzb, bs = sp.m, sp.nnzb, sp.bs
    offs = torch.arange(m, device=sp.device, dtype=torch.int32) * nnzb
    crow = torch.cat([(sp.row_ptr[:-1][None, :] + offs[:, None]).reshape(-1),
                      torch.tensor([m * nnzb], dtype=torch.int32,
                                   device=sp.device)])
    col = sp.block_cols.repeat(m)
    mat = torch.sparse_bsr_tensor(crow, col, sp.data.reshape(-1, bs, bs),
                                  size=(m * sp.n_pad, sp.n_pad),
                                  check_invariants=True)
    return lambda: mat @ B


def phase_kernels(dev) -> list[dict]:
    import numpy as np
    import torch
    from repro_torch.core.sparse import BCSR
    from repro_torch.kernels import bcsr_fused, bcsr_spmm, ref

    check_edges(dev)

    cfg = FULL
    n, m, bs, r, k = cfg["n"], cfg["m"], cfg["bs"], cfg["r"], 8
    _, rows, cols = main_pattern(n, bs, cfg["off_density"], cfg["seed"])
    nnzb = len(rows)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    idx = dict(block_rows=torch.from_numpy(rows.astype(np.int32)).to(dev),
               block_cols=torch.from_numpy(cols.astype(np.int32)).to(dev),
               n=n)
    # the MU step's operand: r perturbed members, factors (r, n, k)
    sp_r = BCSR(data=torch.rand((r, m, nnzb, bs, bs), generator=gen,
                                device=dev), **idx)
    A_r = torch.rand((r, n, k), generator=gen, device=dev)
    log(f"[kernels] main-path shape: r={r} m={m} nnzb={nnzb} bs={bs} n={n} "
        f"k={k} ({sp_r.data.numel() * 4 / 1e9:.2f} GB of stored blocks)")
    xa, xt = bcsr_fused.bcsr_xa_xta(sp_r, A_r, A_r)
    torch.cuda.synchronize()
    ra, rt = ref.ref_bcsr_xa_xta(sp_r, A_r, A_r)
    err_f = max(compare("bcsr_xa_xta XA [main]", xa, ra),
                compare("bcsr_xa_xta XTB [main]", xt, rt))
    del xa, xt, ra, rt
    T = r * m
    f_bytes = sp_r.data.numel() * 4 + 2 * A_r.numel() * 4 + 2 * T * n * k * 4
    f_flops = T * nnzb * bs * bs * 4 * k
    f_ms = cuda_ms(lambda: bcsr_fused.bcsr_xa_xta(sp_r, A_r, A_r), reps=10)
    f_plain = cuda_ms(lambda: ref.ref_bcsr_xa_xta(sp_r, A_r, A_r), reps=3,
                      warmup=1)
    f_bound, f_by = bound(f_bytes, f_flops)
    del sp_r, A_r
    torch.cuda.empty_cache()

    # the error / regression operand: the unperturbed tensor, A (n, k)
    sp = BCSR(data=torch.rand((m, nnzb, bs, bs), generator=gen, device=dev),
              **idx)
    A = torch.rand((n, k), generator=gen, device=dev)
    sa = bcsr_spmm.bcsr_spmm(sp, A)
    torch.cuda.synchronize()
    rs = ref.ref_bcsr_spmm(sp, A)
    err_s = compare("bcsr_spmm [main]", sa, rs)
    # the member-error call shares the data across r operand members
    A_r = torch.rand((r, n, k), generator=gen, device=dev)
    compare("bcsr_spmm [main, shared data, r operands]",
            bcsr_spmm.bcsr_spmm(sp, A_r), ref.ref_bcsr_spmm(sp, A_r))
    s_shared_ms = cuda_ms(lambda: bcsr_spmm.bcsr_spmm(sp, A_r), reps=10)
    del sa, rs
    s_bytes = sp.data.numel() * 4 + A.numel() * 4 + m * n * k * 4
    s_flops = m * nnzb * bs * bs * 2 * k
    s_ms = cuda_ms(lambda: bcsr_spmm.bcsr_spmm(sp, A), reps=20)
    s_plain = cuda_ms(lambda: ref.ref_bcsr_spmm(sp, A), reps=5, warmup=1)
    s_bound, s_by = bound(s_bytes, s_flops)
    lib_fn = bsr_yardstick(sp, A)
    compare("torch.sparse_bsr_tensor @ B (yardstick)",
            lib_fn().reshape(m, n, k), bcsr_spmm.bcsr_spmm(sp, A))
    s_lib = cuda_ms(lib_fn, reps=10)
    del lib_fn
    log(f"[kernels] bcsr_spmm with shared data and r={r} operand members: "
        f"{s_shared_ms:.3f} ms (reads the stored blocks once per member)")
    del sp, A, A_r
    torch.cuda.empty_cache()

    rows_out = [
        dict(name="bcsr_xa_xta", route="cuda",
             source="src/repro_torch/kernels/csrc/bcsr_fused.cu",
             replaces="src/repro/kernels/bcsr_fused.py:123",
             launches=0, max_abs_err=err_f, ms=f_ms, plain_ms=f_plain,
             bound_ms=f_bound, bound_by=f_by, library_ms=None),
        dict(name="bcsr_spmm", route="cuda",
             source="src/repro_torch/kernels/csrc/bcsr_spmm.cu",
             replaces="src/repro/kernels/bcsr_spmm.py:89",
             launches=0, max_abs_err=err_s, ms=s_ms, plain_ms=s_plain,
             bound_ms=s_bound, bound_by=s_by, library_ms=s_lib),
    ]
    for row in rows_out:
        log(f"[kernels] {row['name']}: kernel {row['ms']:.3f} ms, plain "
            f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
            f"({row['bound_by']}), library {row['library_ms']}, "
            f"max |diff| {row['max_abs_err']:.3e}")
    return rows_out


# ---------------------------------------------------------------------------
# Phases 3 and 4: the sweep through the CLI
# ---------------------------------------------------------------------------

def write_planted_npz(path: Path, cfg: dict) -> int:
    """A seeded planted COO file at the sweep's size: values A R A^T (rank
    4, community-structured A) at ~fill of each stored block's entries."""
    import numpy as np
    n, m, bs = cfg["n"], cfg["m"], cfg["bs"]
    rng, brows, bcols = main_pattern(n, bs, cfg["off_density"], cfg["seed"])
    per = int(round(cfg["fill"] * bs * bs))
    nnzb = len(brows)
    k_true = 4
    A = 0.05 + 0.1 * rng.random((n, k_true), dtype=np.float32)
    A[np.arange(n), rng.integers(0, k_true, n)] += 1.0
    R = rng.uniform(0.05, 0.5, (m, k_true, k_true)).astype(np.float32)
    R[:, np.arange(k_true), np.arange(k_true)] += 1.0
    pos = rng.integers(0, bs * bs, (m, nnzb, per), dtype=np.int64)
    rel = np.broadcast_to(np.arange(m)[:, None, None], pos.shape).ravel()
    row = (brows[None, :, None] * bs + pos // bs).ravel()
    col = (bcols[None, :, None] * bs + pos % bs).ravel()
    val = np.empty(row.shape[0], np.float32)
    step = 1 << 22
    for s in range(0, row.shape[0], step):
        e = s + step
        val[s:e] = np.einsum("ea,eab,eb->e", A[row[s:e]], R[rel[s:e]],
                             A[col[s:e]])
    np.savez(path, row=row, rel=rel, col=col, val=val)
    return row.shape[0]


def run_sweep(npz: Path, report: Path, impl: str, cfg: dict):
    from repro_torch.launch import rescalk_run
    argv = ["--data", str(npz), "--bs", str(cfg["bs"]),
            "--k-min", str(cfg["k_min"]), "--k-max", str(cfg["k_max"]),
            "--r", str(cfg["r"]), "--iters", str(cfg["iters"]),
            "--report", str(report), "--use-fused-kernel",
            "--fused-impl", impl]
    log(f"[sweep] rescalk_run {' '.join(argv)}")
    t0 = time.perf_counter()
    res, rep = rescalk_run.main(argv)
    units = " ".join(f"k={u.k}:{u.seconds:.3f}s" for u in rep.units)
    log(f"[sweep] impl={impl}: {time.perf_counter() - t0:.1f}s wall; "
        f"ensemble units {units}; per MU iteration "
        f"{1e3 * rep.total_seconds / (len(rep.units) * cfg['iters']):.2f} "
        f"ms")
    return res, rep


def check_sweep(res, report: Path, cfg: dict) -> None:
    import numpy as np
    require(report.exists(), f"report {report} not written")
    saved = json.loads(report.read_text())
    require(saved["k_opt"] == res.k_opt, "report k_opt differs")
    require(list(res.ks) == list(range(cfg["k_min"], cfg["k_max"] + 1)),
            f"unexpected ks {list(res.ks)}")
    for name in ("s_min", "s_mean", "rel_err"):
        require(bool(np.isfinite(getattr(res, name)).all()),
                f"non-finite {name}: {getattr(res, name)}")
    for k, kr in res.per_k.items():
        require(kr.A_median.shape == (cfg["n"], k), f"A_median shape, k={k}")
        require(bool(np.isfinite(kr.A_median).all())
                and bool((kr.A_median >= 0).all()), f"A_median, k={k}")
        require(bool(np.isfinite(kr.R_regress).all())
                and bool((kr.R_regress >= 0).all()), f"R_regress, k={k}")
        require(bool(np.isfinite(kr.member_errors).all()),
                f"member errors, k={k}")


def phase_sweeps(kernel_rows: list[dict]) -> None:
    import numpy as np
    from repro_torch.kernels import ops
    cfg = FULL
    with tempfile.TemporaryDirectory() as tmp:
        npz = Path(tmp) / "planted.npz"
        t0 = time.perf_counter()
        nnz = write_planted_npz(npz, cfg)
        log(f"[sweep] wrote {nnz} triples in {time.perf_counter() - t0:.1f}s")

        ops.reset_launch_counts()
        res, rep = run_sweep(npz, Path(tmp) / "cuda.json", "auto", cfg)
        launches = ops.launch_counts()
        log(f"[sweep] kernel launches in the main path: {launches}")
        for name, count in launches.items():
            require(count > 0, f"{name} was not launched in the main path")
        check_sweep(res, Path(tmp) / "cuda.json", cfg)
        for row in kernel_rows:
            row["launches"] = launches[row["name"]]

        ops.reset_launch_counts()
        ref, _ = run_sweep(npz, Path(tmp) / "ref.json", "ref", cfg)
        require(ops.launch_counts() == {"bcsr_xa_xta": 0, "bcsr_spmm": 0},
                "the ref sweep launched a kernel")
        check_sweep(ref, Path(tmp) / "ref.json", cfg)

    require(res.k_opt == ref.k_opt,
            f"k_opt differs: kernels {res.k_opt}, ref {ref.k_opt}")
    for name in ("s_min", "s_mean", "rel_err"):
        a, b = getattr(res, name), getattr(ref, name)
        worst = float(np.abs(a - b).max())
        log(f"[sweep] {name}: kernels {np.round(a, 6).tolist()} ref "
            f"{np.round(b, 6).tolist()} max |diff| {worst:.2e}")
        require(worst <= SWEEP_TOL, f"{name} differs by {worst:.2e}")
    log(f"[sweep] k_opt = {res.k_opt} on both paths")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check",
              file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}; run "
              f"from the root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch import device as _device
    _device.strict_fp32()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    smi = smi_line()
    log(f"[card] {smi} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda})")
    phase_build()
    rows = phase_kernels(dev)
    phase_sweeps(rows)
    for row in rows:
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            if row[key] is not None:
                require(math.isfinite(row[key]) and row[key] > 0,
                        f"{row['name']}: bad {key} {row[key]}")
    for row in rows:
        log(f"[kernels] {row['name']}: launches {row['launches']}, kernel "
            f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, bound "
            f"{row['bound_ms']:.3f} ms, library {row['library_ms']}")
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
