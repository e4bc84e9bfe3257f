#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero; nothing is caught and passed over):

  1. Build the four CUDA kernels from ``src/repro_torch/kernels/csrc``
     with nvcc (sm_90a; ptxas register/shared-memory report printed) and
     print the card's name and power limit.
  2. Hold each kernel against its plain PyTorch version on the card.  The
     BCSR kernels: at edge shapes (bs not dividing n, empty block rows and
     cols, nnzb == 0, k in {3, 16}, r in {1, 4}) and at the sweep's shape
     with k = 8, to a relative Frobenius error <= 1e-5 and max |diff| <=
     1e-4 * max |ref| (XTB's atomics and the plain version's sums add in
     different orders).  Times kernel, plain version and, for bcsr_spmm,
     the ``torch.sparse_bsr_tensor @ B`` yardstick with CUDA events.
     score_topk: n in {1, 5, 1000, 3000}, b in {1, 32, 128}, k in {3, 32},
     topk in {1, 10, 100, 1024}, held as a top-k (``topk_check``), and
     exact-tie cases (integer factors, rows of A repeated; n = 500, and
     n = 40000, where chunks hold several tiles) whose indices must equal
     the plain version's.  Timed at the serving-scale shape
     b = 128, n = 4194304, k = 32, topk = 32 beside the plain version and
     the ``torch.topk(V @ A.T, topk)`` yardstick.
     fused_xa_xtb: n1 != n2 with n in {1, 37, 1000} (no tile multiple),
     m = 1 (the sliced schedule's call, a slice view of X), k in {1, 3, 5,
     16, 64}, r in {1, 4}, B2 broadcast over m (stride 0), n2 odd and
     n2 % 4 == 0 (the scalar and the float4 path), to the BCSR kernels'
     tolerances; then held and timed beside its plain version (two
     batched products) on the grid sweep's operands (r = 4, m = 8,
     n = 16384, X 34.4 GB, B1 = A, B2 = A broadcast over m) at k = 4 and
     k = 5, the largest rank of each KMAX build (4 and 8) the sweep runs;
     the kernels line reports k = 5.
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
  5. Serve the bundle phase 3 wrote through the serve CLI's entry point
     (``repro_torch.launch.serve.main``): 4096 zipf queries (skew 1.1,
     mixed directions) in 16 requests, batch 32, topk 10.  The
     score_topk counter, zeroed just before, must equal the engine's
     device batches and be above 0.  The first request's latency (the
     engine's one-time set-up) is printed apart from the other 15.
     Again with --impl ref: identical stats(), and every answer of both
     runs passes ``topk_check``.  Then
     score_topk is timed at the serve path's own shape (b = 32, the
     bundle's A) beside its plain version and the yardstick, and the
     stream is served once more under ``torch.profiler`` (the device's
     idle share and its time by kernel).
  6. The dense grid sweep on a 1 x 1 ``torch.distributed`` grid over a
     one-rank NCCL group (``launch.mesh.make_grid``): ``rescalk(X, cfg,
     grid=grid)`` on X from the port's ``synthetic_rescal`` built on the
     card (n = 16384 entities, m = 8 relations, planted k = 4, noise
     0.01, seed 0; 8.6 GB, and 34.4 GB more for the 4 perturbed members),
     k = 2..5, r = 4, 300 MU iterations, 100 regression iterations, the
     batched schedule, use_fused.  n = 16384 is the largest power of two
     whose ensemble one H100 holds; the one cut is the MU iterations (300,
     the CLI's default; the paper runs 1000).  The counters, zeroed just
     before: fused_xa_xtb must launch once per MU iteration (1200) and the
     grid's collective count be above 0.  The same sweep with
     impl="ref": the same k_opt, per-k s_min/s_mean/rel_err within 1e-4.
     Then ``dist_rescal`` with the sliced schedule at the same n for 20
     iterations (m launches per iteration), kernel and ref, A and R within
     1e-4 of the largest |value|.  The group is destroyed at the end.

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
# score_topk: scores against the plain version's and against float64
# recomputation, relative to the row's largest |score| (fp32 sums of k
# terms in another order differ by a few ulps)
TOPK_TOL = 1e-5

FULL = dict(n=131072, m=8, bs=128, off_density=0.005, fill=0.02,
            k_min=2, k_max=5, r=4, iters=300, seed=0)
# the serve phase's stream, and score_topk's serving-scale timing shape
SERVE = dict(queries="random:4096:1.1", batch=32, topk=10, requests=16,
             mode="mixed", seed=0)
TOPK_SCALE = dict(b=128, n=4194304, k=32, topk=32)
# the dense grid sweep (phase 6), and fused_xa_xtb's timing shape
GRID = dict(n=16384, m=8, k_true=4, noise=0.01, seed=0, k_min=2, k_max=5,
            r=4, iters=300, regress_iters=100, sliced_iters=20, sliced_k=4)
# fused_xa_xtb on the grid sweep's operands: ranks 2..4 run the kernel's
# KMAX = 4 build and rank 5 its KMAX = 8 build, so both are held at their
# largest rank in the sweep; the kernels line reports k = 5
FUSED_SCALE = dict(r=4, m=8, n=16384, ks=(4, 5), sliced_k=4)


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


def check_fused_edges(dev) -> None:
    """fused_xa_xtb against its plain version at the edge shapes."""
    import torch
    from repro_torch.kernels import fused_bilinear, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    cases = [  # (m, n1, n2, k, r, B2 shared over m)
        (3, 37, 1000, 3, None, False), (3, 1000, 37, 5, 4, True),
        (2, 1, 37, 1, None, True), (2, 37, 1, 16, 4, False),
        (1, 1000, 1000, 64, None, False), (4, 1000, 1000, 5, 4, True),
        (2, 37, 37, 64, 4, True), (2, 1000, 999, 16, 1, False),
        (2, 300, 1000, 3, 4, True),
    ]
    for m, n1, n2, k, r, shared in cases:
        lead = (r,) if r is not None else ()
        X = torch.rand(lead + (m, n1, n2), generator=gen, device=dev)
        B1 = torch.rand(lead + (n2, k), generator=gen, device=dev)
        if shared:
            B2 = torch.rand(lead + (1, n1, k), generator=gen,
                            device=dev).expand(lead + (m, n1, k))
        else:
            B2 = torch.rand(lead + (m, n1, k), generator=gen, device=dev)
        tag = f"m={m} n1={n1} n2={n2} k={k} r={r or 1} shared={shared}"
        xa, xt = fused_bilinear.fused_xa_xtb(X, B1, B2)
        torch.cuda.synchronize()
        ra, rt = ref.ref_fused_xa_xtb(X, B1, B2)
        compare(f"fused_xa_xtb XA [{tag}]", xa, ra)
        compare(f"fused_xa_xtb XTB [{tag}]", xt, rt)
        if m > 1:   # the sliced schedule's call: a slice view, m = 1
            Xt = X[..., 1:2, :, :]
            B2t = B2[..., 1:2, :, :]
            xa, xt = fused_bilinear.fused_xa_xtb(Xt, B1, B2t)
            torch.cuda.synchronize()
            ra, rt = ref.ref_fused_xa_xtb(Xt, B1, B2t)
            compare(f"fused_xa_xtb XA [slice, {tag}]", xa, ra)
            compare(f"fused_xa_xtb XTB [slice, {tag}]", xt, rt)
        log(f"[fused] edge case {tag}: ok")


def fused_bound(X, B1, B2u, k) -> tuple[float, str]:
    """fused_xa_xtb's bound: X, B1 and B2's own (unbroadcast) values read
    once, XA and XTB written once; 4k flop per value of X."""
    r, m, n1, n2 = X.shape
    nbytes = 4 * (X.numel() + B1.numel() + B2u.numel()
                  + r * m * (n1 + n2) * k)
    return bound(nbytes, 4 * X.numel() * k)


def phase_fused(dev) -> dict:
    """fused_xa_xtb at the edge shapes, then held and timed on the grid
    sweep's operands: X (r, m, n, n), B1 = A (r, n, k) and B2 = A broadcast
    over the m slices (stride 0), as ``dist.engine._fused_products`` passes
    them on a 1 x 1 grid, at each KMAX build the sweep runs."""
    import torch
    from repro_torch.kernels import fused_bilinear, ref
    check_fused_edges(dev)
    cfg = FUSED_SCALE
    r, m, n = cfg["r"], cfg["m"], cfg["n"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    X = torch.rand((r, m, n, n), generator=gen, device=dev)
    log(f"[fused] main-path shape: r={r} m={m} n={n} k in {cfg['ks']} "
        f"({X.numel() * 4 / 1e9:.2f} GB of X)")
    by_k = {}
    for k in cfg["ks"]:
        A = torch.rand((r, n, k), generator=gen, device=dev)
        B2 = A.unsqueeze(-3).expand(r, m, n, k)
        xa, xt = fused_bilinear.fused_xa_xtb(X, A, B2)
        torch.cuda.synchronize()
        ra, rt = ref.ref_fused_xa_xtb(X, A, B2)
        err = max(compare(f"fused_xa_xtb XA [main, k={k}]", xa, ra),
                  compare(f"fused_xa_xtb XTB [main, k={k}]", xt, rt))
        del xa, xt, ra, rt
        ms = cuda_ms(lambda: fused_bilinear.fused_xa_xtb(X, A, B2), reps=10)
        plain = cuda_ms(lambda: ref.ref_fused_xa_xtb(X, A, B2), reps=3,
                        warmup=1)
        b_ms, by = fused_bound(X, A, A, k)
        by_k[k] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                       bound_by=by)
        log(f"[fused] fused_xa_xtb at k={k}: kernel {ms:.3f} ms, plain "
            f"{plain:.3f} ms, bound {b_ms:.3f} ms ({by}), max |diff| "
            f"{err:.3e}")
        if k == cfg["sliced_k"]:
            # the sliced schedule's call at full size: one slice of one member
            Xt, B2t = X[0, 2:3], B2[0, 2:3]
            compare(f"fused_xa_xtb XA [main, one slice, k={k}]",
                    fused_bilinear.fused_xa_xtb(Xt, A[0], B2t)[0],
                    ref.ref_fused_xa_xtb(Xt, A[0], B2t)[0])
            slice_ms = cuda_ms(
                lambda: fused_bilinear.fused_xa_xtb(Xt, A[0], B2t), reps=20)
            log(f"[fused] one slice (m = 1, n = {n}, k = {k}): "
                f"{slice_ms:.3f} ms")
            del Xt, B2t
        del A, B2
    del X
    torch.cuda.empty_cache()
    return dict(name="fused_xa_xtb", route="cuda",
                source="src/repro_torch/kernels/csrc/fused_bilinear.cu",
                replaces="src/repro/kernels/fused_bilinear.py:90",
                launches=0, library_ms=None, **by_k[max(cfg["ks"])])


def topk_check(name: str, V64, A64, s, i, ref_s) -> float:
    """Hold a score_topk result (s, i) to the plain version's scores ref_s
    and to float64 scores recomputed from V64 (b, k) and A64 (n, k).  Near
    ties may swap between two correct answers, so this checks a top-k, not
    index by index: the scores match the plain version's; each returned
    index's float64 score matches its reported score; no index left out
    scores above the last reported score; scores descend; the indices are
    distinct; slots past n are (-inf, -1).  Tolerance TOPK_TOL times the
    row's largest |score|.  Returns max |s - ref_s| over the real slots."""
    import torch
    b, topk = s.shape
    n = A64.shape[0]
    require(s.dtype == torch.float32 and i.dtype == torch.int32
            and tuple(i.shape) == (b, topk) == tuple(ref_s.shape),
            f"{name}: got {s.dtype} {tuple(s.shape)}, {i.dtype} "
            f"{tuple(i.shape)}; plain {tuple(ref_s.shape)}")
    t = min(topk, n)
    require(bool((i[:, t:] == -1).all()) and bool(torch.isneginf(
        s[:, t:]).all()), f"{name}: slots past n are not (-inf, -1)")
    S, I = s[:, :t].double(), i[:, :t].long()
    require(bool(((I >= 0) & (I < n)).all()), f"{name}: index out of range")
    require(bool((S[:, :-1] >= S[:, 1:]).all()), f"{name}: not descending")
    srt = torch.sort(I, dim=1).values
    require(bool((srt[:, 1:] > srt[:, :-1]).all()),
            f"{name}: repeated index")
    worst = 0.0
    for r0 in range(0, b, 16):                 # (16, n) float64 at a time
        rows = slice(r0, min(b, r0 + 16))
        full = V64[rows] @ A64.T
        tol = TOPK_TOL * full.abs().amax(dim=1)
        diff = (S[rows] - ref_s[rows, :t].double()).abs()
        worst = max(worst, float(diff.max()))
        require(bool((diff <= tol[:, None]).all()),
                f"{name}: scores differ from the plain version's by "
                f"{float(diff.max()):.3e}")
        exact = full.gather(1, I[rows])
        require(bool(((exact - S[rows]).abs() <= tol[:, None]).all()),
                f"{name}: a reported score differs from its float64 value")
        left = full.scatter(1, I[rows], -torch.inf).amax(dim=1)
        require(bool((left <= S[rows, -1] + tol).all()),
                f"{name}: an index left out scores above the last "
                f"reported score")
    return worst


def time_topk(V, A, topk: int, reps: int, plain_reps: int) -> dict:
    """score_topk kernel, plain version and yardstick times on (V, A), with
    the bound from this call's bytes and operations."""
    import torch
    from repro_torch.kernels import ref, score_topk
    b, k = V.shape
    n = A.shape[0]
    ms = cuda_ms(lambda: score_topk.score_topk(V, A, topk=topk), reps=reps)
    plain = cuda_ms(lambda: ref.ref_score_topk_stream(V, A, topk),
                    reps=plain_reps, warmup=1)
    lib = cuda_ms(lambda: torch.topk(V @ A.T, topk, dim=1), reps=reps)
    nbytes = 4 * (n * k + b * k) + 8 * b * topk
    bound_ms, by = bound(nbytes, 2 * b * n * k)
    log(f"[score_topk] b={b} n={n} k={k} topk={topk}: kernel {ms:.4f} ms, "
        f"plain {plain:.4f} ms, torch.topk(V @ A.T) {lib:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({by})")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound_ms,
                bound_by=by)


def phase_topk(dev) -> dict:
    """score_topk against its plain version at edge shapes and an
    exact-tie case, and timed at the serving-scale shape."""
    import torch
    from repro_torch.kernels import ref, score_topk
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    cases = [(n, topk) for n, topk in ((1, 1), (1, 10), (5, 10), (1000, 1),
                                       (1000, 10), (1000, 100))]
    for b in (1, 32, 128):
        for k in (3, 32):
            for n, topk in cases + ([(3000, 1024)] if b == 32 else []):
                V = torch.rand((b, k), generator=gen, device=dev)
                A = torch.rand((n, k), generator=gen, device=dev)
                s, i = score_topk.score_topk(V, A, topk=topk)
                torch.cuda.synchronize()
                rs, _ = ref.ref_score_topk_stream(V, A, topk)
                topk_check(f"score_topk [b={b} n={n} k={k} topk={topk}]",
                           V.double(), A.double(), s, i, rs)
            log(f"[score_topk] edge cases b={b} k={k}: ok")
    # exact ties: small integers sum exactly in any order, and the rows of
    # A repeat every 250 rows.  At n = 500 each chunk is one tile; at
    # n = 40000 chunks hold several, so ties are also broken between a
    # full running list and a later tile's candidates
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    base = torch.randint(0, 3, (250, 8), generator=gen, device=dev)
    for b, n in ((32, 500), (32, 40000), (128, 40000)):
        A = base[torch.arange(n, device=dev) % 250].float().contiguous()
        V = torch.randint(0, 3, (b, 8), generator=gen, device=dev).float()
        p = score_topk.plan(b, n, 8, 100, sms)
        require(n == 500 or p.chunk_rows > 256,
                f"score_topk: the tie case b={b} n={n} has one-tile chunks")
        for topk in (1, 10, 100):
            s, i = score_topk.score_topk(V, A, topk=topk)
            rs, ri = ref.ref_score_topk_stream(V, A, topk)
            require(torch.equal(s, rs) and torch.equal(i, ri),
                    f"score_topk: exact-tie case b={b} n={n} topk={topk} "
                    f"differs from the plain version")
        log(f"[score_topk] exact-tie case b={b} n={n} ({p.n_chunks} chunks "
            f"of {p.chunk_rows} rows): scores and indices equal the plain "
            f"version's")

    cfg = TOPK_SCALE
    V = torch.rand((cfg["b"], cfg["k"]), generator=gen, device=dev)
    A = torch.rand((cfg["n"], cfg["k"]), generator=gen, device=dev)
    s, i = score_topk.score_topk(V, A, topk=cfg["topk"])
    torch.cuda.synchronize()
    rs, _ = ref.ref_score_topk_stream(V, A, cfg["topk"])
    err = topk_check("score_topk [serving scale]", V.double(), A.double(),
                     s, i, rs)
    log(f"[score_topk] serving scale: max |diff| {err:.3e}")
    time_topk(V, A, cfg["topk"], reps=10, plain_reps=2)
    del V, A, s, i, rs
    torch.cuda.empty_cache()
    return dict(name="score_topk", route="cuda",
                source="src/repro_torch/kernels/csrc/score_topk.cu",
                replaces="src/repro/kernels/score_topk.py:112",
                launches=0, max_abs_err=None, ms=None, plain_ms=None,
                bound_ms=None, bound_by=None, library_ms=None)


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


def phase_sweeps(kernel_rows: list[dict], tmp: Path) -> Path:
    """Phases 3 and 4; returns the bundle the kernel sweep wrote."""
    import numpy as np
    from repro_torch.kernels import ops
    cfg = FULL
    sweep_kernels = ("bcsr_xa_xta", "bcsr_spmm")
    npz = tmp / "planted.npz"
    t0 = time.perf_counter()
    nnz = write_planted_npz(npz, cfg)
    log(f"[sweep] wrote {nnz} triples in {time.perf_counter() - t0:.1f}s")

    ops.reset_launch_counts()
    res, rep = run_sweep(npz, tmp / "cuda.json", "auto", cfg)
    launches = ops.launch_counts()
    log(f"[sweep] kernel launches in the main path: {launches}")
    for name in sweep_kernels:
        require(launches[name] > 0, f"{name} was not launched in the sweep")
    check_sweep(res, tmp / "cuda.json", cfg)
    for row in kernel_rows:
        if row["name"] in sweep_kernels:
            row["launches"] = launches[row["name"]]
    bundle = tmp / "cuda.bundle"
    require(json.loads((tmp / "cuda.json").read_text())["meta"].get(
        "bundle") == str(bundle), "the report does not point at its bundle")

    ops.reset_launch_counts()
    ref, _ = run_sweep(npz, tmp / "ref.json", "ref", cfg)
    require(not any(ops.launch_counts().values()),
            "the ref sweep launched a kernel")
    check_sweep(ref, tmp / "ref.json", cfg)

    require(res.k_opt == ref.k_opt,
            f"k_opt differs: kernels {res.k_opt}, ref {ref.k_opt}")
    for name in ("s_min", "s_mean", "rel_err"):
        a, b = getattr(res, name), getattr(ref, name)
        worst = float(np.abs(a - b).max())
        log(f"[sweep] {name}: kernels {np.round(a, 6).tolist()} ref "
            f"{np.round(b, 6).tolist()} max |diff| {worst:.2e}")
        require(worst <= SWEEP_TOL, f"{name} differs by {worst:.2e}")
    log(f"[sweep] k_opt = {res.k_opt} on both paths")
    return bundle


# ---------------------------------------------------------------------------
# Phase 5: serve the sweep's bundle through the CLI
# ---------------------------------------------------------------------------

def run_serve(bundle: Path, impl: str):
    import numpy as np
    from repro_torch.launch import serve
    cfg = SERVE
    argv = ["--factors", str(bundle), "--queries", cfg["queries"],
            "--batch", str(cfg["batch"]), "--topk", str(cfg["topk"]),
            "--requests", str(cfg["requests"]), "--mode", cfg["mode"],
            "--seed", str(cfg["seed"]), "--impl", impl]
    log(f"[serve] serve {' '.join(argv)}")
    out = serve.main(argv)
    lat = out.latencies
    log(f"[serve] impl={impl}: {len(out.results)} queries, p50 "
        f"{float(np.percentile(lat, 50)) * 1e3:.3f} ms, p99 "
        f"{float(np.percentile(lat, 99)) * 1e3:.3f} ms, "
        f"{len(out.results) / out.seconds:.1f} q/s, stats {out.stats}")
    # the first request pays the engine's one-time set-up; apart from it,
    # the p99 of 16 requests is their maximum
    log(f"[serve] impl={impl}: first request (cold) {lat[0] * 1e3:.3f} ms; "
        f"requests 2-{len(lat)}: p50 "
        f"{float(np.percentile(lat[1:], 50)) * 1e3:.3f} ms, max "
        f"{float(lat[1:].max()) * 1e3:.3f} ms")
    return out


def query_vectors(A, R, queries):
    """V (b, k) of queries, as the engine forms them: A[anchor] @ R[rel]
    for (s, r, ?), A[anchor] @ R[rel]^T for (?, r, o), in A's dtype."""
    import torch
    dev = A.device
    Rq = R[torch.tensor([q.rel for q in queries], device=dev)]
    sro = torch.tensor([q.mode == "sro" for q in queries], device=dev)
    Rq = torch.where(sro[:, None, None], Rq, Rq.transpose(1, 2))
    anchors = torch.tensor([q.anchor for q in queries], device=dev)
    return torch.einsum("bi,bij->bj", A[anchors], Rq).contiguous()


def phase_serve(bundle: Path, row: dict, dev) -> None:
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref, score_topk
    from repro_torch.serve import FactorBundle, random_queries
    ops.reset_launch_counts()
    got = run_serve(bundle, "auto")
    launches = ops.launch_counts()["score_topk"]
    log(f"[serve] score_topk launches in the serve path: {launches}")
    require(launches == got.stats["batches"] > 0,
            f"score_topk launched {launches} times for "
            f"{got.stats['batches']} device batches")
    row["launches"] = launches
    ops.reset_launch_counts()
    plain = run_serve(bundle, "ref")
    require(not any(ops.launch_counts().values()),
            "the ref serve run launched a kernel")
    require(got.stats == plain.stats,
            f"stats differ: {got.stats} vs {plain.stats}")

    # every answer of both runs, against float64 scores
    fb = FactorBundle.load(str(bundle))
    cfg = SERVE
    count, skew = (float(x) for x in cfg["queries"].split(":")[1:])
    queries = random_queries(fb.n, fb.m, int(count), skew=skew,
                             seed=cfg["seed"], mode=cfg["mode"])
    A64 = torch.from_numpy(fb.A).double().to(dev)
    V64 = query_vectors(A64, torch.from_numpy(fb.R).double().to(dev),
                        queries)

    def stack(out, attr):
        return torch.from_numpy(np.stack([getattr(r, attr)
                                          for r in out.results])).to(dev)

    for out, name in ((got, "kernel"), (plain, "plain")):
        require(not any(r.shed for r in out.results), f"{name}: shed")
        topk_check(f"serve answers [{name}]", V64, A64, stack(out, "scores"),
                   stack(out, "indices"), stack(plain, "scores"))
    log(f"[serve] {len(queries)} answers of both runs pass the top-k check")

    # the kernel at the serve path's own shape: the bundle's A, and V of
    # the stream's first batch of distinct queries
    A = torch.from_numpy(fb.A).to(dev)
    V = query_vectors(A, torch.from_numpy(fb.R).to(dev),
                      list(dict.fromkeys(queries))[:cfg["batch"]])
    s, i = score_topk.score_topk(V, A, topk=cfg["topk"])
    torch.cuda.synchronize()
    rs, _ = ref.ref_score_topk_stream(V, A, cfg["topk"])
    row["max_abs_err"] = topk_check("score_topk [serve shape]", V.double(),
                                    A.double(), s, i, rs)
    row.update(time_topk(V, A, cfg["topk"], reps=50, plain_reps=5))
    profile_serve(fb, queries)


def profile_serve(fb, queries) -> None:
    """The serve stream once more, on a fresh engine, under
    torch.profiler: wall time, the device's busy time and idle share, and
    device time by kernel, per device batch."""
    import torch
    from repro_torch.serve import ServeConfig, ServeEngine
    cfg = SERVE
    engine = ServeEngine(fb, ServeConfig(topk=cfg["topk"],
                                         batch=cfg["batch"]))
    per = -(-len(queries) // cfg["requests"])
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for c0 in range(0, len(queries), per):
            engine.query(queries[c0:c0 + per])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    batches = engine.stats()["batches"]
    cuda_type = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and (getattr(e, "device_type", None) == cuda_type
                   or e.cpu_time_total == 0)]
    busy = sum(e.device_time_total for e in events) / 1e6
    log(f"[serve] profiled stream: {batches} device batches, wall "
        f"{wall * 1e3:.3f} ms, device busy {busy * 1e3:.3f} ms "
        f"({100 * (1 - busy / wall):.1f}% idle); per batch "
        f"{wall / batches * 1e3:.4f} ms wall, "
        f"{busy / batches * 1e3:.4f} ms device")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:8]:
        log(f"[serve]   {e.device_time_total / 1e3 / batches:8.4f} ms/batch "
            f"{100 * e.device_time_total / 1e6 / busy:5.1f}%  "
            f"x{e.count:<4d} {e.key[:70]}")


# ---------------------------------------------------------------------------
# Phase 6: the dense grid sweep on a 1 x 1 NCCL grid
# ---------------------------------------------------------------------------

def run_grid_sweep(grid, X, impl: str, report: Path):
    from repro_torch.core.rescalk import rescalk
    from repro_torch.kernels.policy import KernelPolicy
    from repro_torch.selection import RescalkConfig
    cfg = GRID
    rc = RescalkConfig(k_min=cfg["k_min"], k_max=cfg["k_max"],
                       n_perturbations=cfg["r"], rescal_iters=cfg["iters"],
                       regress_iters=cfg["regress_iters"], seed=cfg["seed"],
                       schedule="batched",
                       kernel=KernelPolicy(use_fused=True, impl=impl))
    t0 = time.perf_counter()
    res = rescalk(X, rc, grid=grid, report_path=str(report))
    wall = time.perf_counter() - t0
    units = json.loads(report.read_text())["units"]
    unit_s = sum(u["seconds"] for u in units)
    log(f"[grid] impl={impl}: sweep {wall:.1f}s wall; ensemble units "
        + " ".join(f"k={u['k']}:{u['seconds']:.3f}s" for u in units)
        + f"; per MU iteration {1e3 * unit_s / (len(units) * cfg['iters']):.2f}"
        f" ms")
    return res


def check_grid_result(res, n) -> None:
    import numpy as np
    cfg = GRID
    require(list(res.ks) == list(range(cfg["k_min"], cfg["k_max"] + 1)),
            f"unexpected ks {list(res.ks)}")
    for name in ("s_min", "s_mean", "rel_err"):
        require(bool(np.isfinite(getattr(res, name)).all()),
                f"non-finite {name}: {getattr(res, name)}")
    for k, kr in res.per_k.items():
        require(kr.A_median.shape == (n, k) and bool(
            np.isfinite(kr.A_median).all()) and bool(
            (kr.A_median >= 0).all()), f"A_median, k={k}")
        require(bool(np.isfinite(kr.R_regress).all())
                and bool((kr.R_regress >= 0).all()), f"R_regress, k={k}")


def phase_grid(row: dict, tmp: Path, dev) -> None:
    """Phase 6 (see the module docstring); sets row's launches."""
    import numpy as np
    import torch
    import torch.distributed
    from repro_torch.data.synthetic import synthetic_rescal
    from repro_torch.dist.engine import DistRescalConfig, dist_rescal
    from repro_torch.kernels import ops
    from repro_torch.kernels.policy import KernelPolicy
    from repro_torch.launch.mesh import make_grid
    cfg = GRID
    n, m = cfg["n"], cfg["m"]
    torch.cuda.empty_cache()
    grid = make_grid(data=1, model=1, device=dev)
    try:
        t0 = time.perf_counter()
        X, _, _ = synthetic_rescal(n, m, cfg["k_true"], seed=cfg["seed"],
                                   noise=cfg["noise"], device=dev)
        torch.cuda.synchronize()
        log(f"[grid] 1 x 1 grid on {torch.distributed.get_backend()}; "
            f"synthetic X (m={m}, n={n}, planted "
            f"k={cfg['k_true']}): {X.numel() * 4 / 1e9:.2f} GB in "
            f"{time.perf_counter() - t0:.2f}s")
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        c0 = grid.collectives
        res = run_grid_sweep(grid, X, "auto", tmp / "grid_cuda.json")
        launches = ops.launch_counts()
        collectives = grid.collectives - c0
        peak = torch.cuda.max_memory_allocated(dev)
        want = (cfg["k_max"] - cfg["k_min"] + 1) * cfg["iters"]
        log(f"[grid] kernel launches in the main path: {launches}; "
            f"collectives {collectives}; peak device memory "
            f"{peak / 1e9:.2f} GB")
        require(launches["fused_xa_xtb"] == want,
                f"fused_xa_xtb launched {launches['fused_xa_xtb']} times, "
                f"want {want} (one per MU iteration)")
        require(collectives > 0, "the grid issued no collective")
        row["launches"] = launches["fused_xa_xtb"]
        check_grid_result(res, n)

        ops.reset_launch_counts()
        ref = run_grid_sweep(grid, X, "ref", tmp / "grid_ref.json")
        require(not any(ops.launch_counts().values()),
                "the ref grid sweep launched a kernel")
        check_grid_result(ref, n)
        require(res.k_opt == ref.k_opt,
                f"k_opt differs: kernel {res.k_opt}, ref {ref.k_opt}")
        for name in ("s_min", "s_mean", "rel_err"):
            a, b = getattr(res, name), getattr(ref, name)
            worst = float(np.abs(a - b).max())
            log(f"[grid] {name}: kernel {np.round(a, 6).tolist()} ref "
                f"{np.round(b, 6).tolist()} max |diff| {worst:.2e}")
            require(worst <= SWEEP_TOL, f"{name} differs by {worst:.2e}")
        log(f"[grid] k_opt = {res.k_opt} on both paths (planted "
            f"{cfg['k_true']}: {'equal' if res.k_opt == cfg['k_true'] else 'differs'})")

        # the sliced schedule: m launches per iteration
        out = {}
        for impl in ("auto", "ref"):
            gen = torch.Generator(device=dev)
            gen.manual_seed(cfg["seed"])
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            st, err = dist_rescal(
                X, cfg["sliced_k"], grid, generator=gen,
                iters=cfg["sliced_iters"],
                cfg=DistRescalConfig(schedule="sliced", kernel=KernelPolicy(
                    use_fused=True, impl=impl)))
            torch.cuda.synchronize()
            out[impl] = st
            log(f"[grid] dist_rescal sliced impl={impl}: "
                f"{cfg['sliced_iters']} iterations in "
                f"{time.perf_counter() - t0:.2f}s, rel_err {float(err):.6f}, "
                f"launches {ops.launch_counts()['fused_xa_xtb']}")
            if impl == "auto":
                require(ops.launch_counts()["fused_xa_xtb"]
                        == m * cfg["sliced_iters"],
                        "the sliced schedule did not launch m times per "
                        "iteration")
        for name in ("A", "R"):
            a, b = getattr(out["auto"], name), getattr(out["ref"], name)
            rel = float((a - b).abs().max() / b.abs().max())
            log(f"[grid] dist_rescal sliced {name}: max |diff| / max |ref| "
                f"{rel:.2e}")
            require(bool(torch.isfinite(a).all()) and rel <= SWEEP_TOL,
                    f"dist_rescal sliced {name} differs by {rel:.2e}")
        del X
    finally:
        grid.destroy()
    torch.cuda.empty_cache()


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
    rows = phase_kernels(dev) + [phase_fused(dev), phase_topk(dev)]
    by_name = {row["name"]: row for row in rows}
    with tempfile.TemporaryDirectory() as tmp:
        bundle = phase_sweeps(rows, Path(tmp))
        phase_serve(bundle, by_name["score_topk"], dev)
        torch.cuda.empty_cache()
        phase_grid(by_name["fused_xa_xtb"], Path(tmp), dev)
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
