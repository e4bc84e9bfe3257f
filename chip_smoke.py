#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero; nothing is caught and passed over):

  1. Build the six CUDA kernels (seven sources: flash_attention has a
     bf16 and an fp32 kernel) from ``src/repro_torch/kernels/csrc`` with
     nvcc (sm_90a; ptxas register/shared-memory report printed; the
     library's build time on a line of its own) and print the card's
     name and power limit.
  2. Hold each kernel against its plain PyTorch version on the card.  The
     BCSR kernels: at edge shapes (bs in {32, 64, 96, 128}, bs not dividing
     n, empty block rows and cols, one block row of 44 blocks beside empty
     ones, nnzb == 0, k in {1, 3, 4, 5, 8, 9, 12, 16, 33, 64}, r in {1, 4},
     shared data with r operand members), to a relative Frobenius error
     <= 1e-5 and max |diff| <= 1e-4 * max |ref| (XTB's atomics and the
     plain version's sums add in different orders); empty block rows and
     cols exactly zero; bcsr_xa_xta's XA bit-identical across two calls.
     bcsr_xa_xta then on the sweep's operands (r = 4 members, m = 8, n =
     131072, bs = 128, 13.1 GB of stored blocks, B1 = B2 = A) at k = 4 and
     5, the largest rank of each of its builds (4 and 8 columns) that the
     sweep runs, and at k = 8, the shape earlier PRs reported, held, XA
     compared across two calls, and timed; the kernels line reports k = 5.
     bcsr_spmm at that shape with k = 8.  Times kernel, plain version and,
     for bcsr_spmm, the ``torch.sparse_bsr_tensor @ B`` yardstick with CUDA
     events.
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
     mu_update_a: n in {0, 1, 37, 1000}, k in {1, 3, 5, 16, 64}, r in
     {1, 4}, S per member or shared (stride 0), padded cells whose masked
     columns must stay exact zeros, and k = 65 refused; then held and timed
     beside its plain version at the BCSR sweep's shape (r = 4, n =
     131072, k = 5) and the dense sweeps' (r = 4, n = 16384, k = 5), with
     its device time per launch from ``torch.profiler``; the kernels line
     reports the dense shape.
  3. Run the RESCALk sweep through the CLI's own entry point
     (``repro_torch.launch.rescalk_run.main``) at full size on a seeded
     planted COO file: n = 131072 entities, m = 8 relations, bs = 128, the
     diagonal blocks plus 0.5% of the off-diagonal ones, ~2% of each
     stored block's entries per relation (~16M triples, ~3.3 GB of
     stored blocks), k = 2..5, r = 4 members, --use-fused-kernel.  The
     kernels' launch counters are zeroed just before and read just after:
     both BCSR kernels must have launched, and mu_update_a once per MU
     iteration (1200).  One cut: 300 MU iterations per member
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
     before: fused_xa_xtb and mu_update_a must launch once per MU
     iteration (1200 each) and the grid's collective count be above 0.  The same sweep with
     impl="ref": the same k_opt, per-k s_min/s_mean/rel_err within 1e-4.
     Then ``dist_rescal`` with the sliced schedule at the same n for 20
     iterations (m launches per iteration), kernel and ref, A and R within
     1e-4 of the largest |value|.  The group is destroyed at the end.
  7. The CLI's default path, ``rescalk_run.main`` without --data: the
     dense sweep on one device on the synthetic tensor it builds on the
     card, ``--n 16384 --m 8 --k-true 4 --k-min 2 --k-max 5 --r 4 --iters
     300 --use-fused-kernel`` (phase 6's X and draws: X 8.6 GB, the 4
     members 34.4 GB).  The counters, zeroed just before: fused_xa_xtb
     and mu_update_a once per MU iteration (1200 each); k_opt = 4, the
     planted rank; per-k values within 1e-4 of phase 6's grid sweep.  The
     same run with --fused-impl ref (no launches), and with --mode grid
     --grid-chunk 4 (4 padded cells per chunk, 34.4 GB, where the whole
     16-cell grid would need 137 GB): the same k_opt, per-k within 1e-4
     of the batched run.  Then at n = 4096 (an exact eigh of an (n, n)
     surrogate per member, and a member loop, are why these run smaller)
     the batched run, --mode loop, --schedule sliced and --init nndsvd:
     the kernels launched and the same k_opt as the batched run.
  8. LM serving, the dense decoder through flash_attention: bf16 runs
     the tensor-core kernel (variant ``sm90_bf16``, wgmma and a TMA
     ring), fp32 the FMA kernel (``fma_fp32``), each case through its
     dtype's variant (per-variant counters).  The kernels against their
     plain version (``ref_attention``) on permuted (B, S, H, D) views
     over FLASH_CHECK: fp32 and bf16, d in {16, 32, 64, 128},
     (hq, hkv) in {(4, 4), (8, 2), (5, 1), (32, 8)}, causal or not,
     q_offset 0 and 64, sq in {1, 37, 256, 1000} x skv in {37, 1000,
     4096}; fp32 to REL_TOL / ABS_TOL, bf16 to BF16_REL_TOL /
     BF16_ABS_TOL against the plain version in bf16 and on fp32 copies.
     Timed (bf16, causal) at the LM cell's prefill shape (b = 4, hq = 32,
     hkv = 8, s = 4096, d = 64; the kernels line) and at one 32k sequence,
     beside its plain version, its bound (TFLOP/s and the share of the
     bound printed) and the ``scaled_dot_product_attention`` yardstick.  Then llama3.2-1b at full
     width in fp32 (seeded init): one prefill of 2 x 1024 through the
     kernel and one through the plain chunked path, 16 launches, logits
     and caches within LM_F32_TOL.  Then the slice through the CLI's entry
     point (``repro_torch.launch.decode_demo.main``), llama3.2-1b at full
     width in bf16, --batch 4 --prompt-len 4096 --new-tokens 64 (after a
     short warm-up run): the counters, zeroed just before, show one
     tensor-core flash_attention launch per layer (16) and no other
     kernel; prefill
     and decode times, tok/s and peak device memory are printed.  The
     same prompts through the plain chunked path: last-position logits,
     and each decode step's logits when fed the kernel path's tokens,
     within LM_BF16_TOL.  Last, the prefill and 16 decode steps under
     ``torch.profiler`` (device idle share, time by kernel, attention's
     share of the prefill).  The cut
     against ``repro``'s prefill_32k shape (B = 32 x 32768): B = 4 x 4096.

Printed last, each on a line of its own: ``{"kernels": [...]}``, the
card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` prints them, and ``{"ok": true, "device":
{...}}``.  Without CUDA, or without the port's sources beside it, the
script exits 1 and prints no result.
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
# bcsr_xa_xta on the BCSR sweep's operands: ranks 2..4 run the kernel's
# 4-column build and rank 5 its 8-column build, so each is timed at its
# largest rank in the sweep (the kernels line reports k = 5); k = 8 is the
# shape earlier PRs reported
BCSR_KS = (4, 5, 8)
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
# mu_update_a at the BCSR sweep's and the dense sweeps' shapes (A (r, n,
# k) at k = k_max); the kernels line reports the dense one
MU_SCALES = (dict(r=4, n=131072, k=5), dict(r=4, n=16384, k=5))
# phase 8: flash_attention's check grid (inputs as permuted (B, S, H, D)
# views), its timing shapes (the LM cell's prefill and one 32k sequence;
# the kernels line reports the first), and the LM serve cell
FLASH_CHECK = dict(b=2, dtypes=("float32", "bfloat16"),
                   dims=(16, 32, 64, 128),
                   heads=((4, 4), (8, 2), (5, 1), (32, 8)), q_offsets=(0, 64),
                   sq=(1, 37, 256, 1000), skv=(37, 1000, 4096))
FLASH_SCALES = (dict(b=4, hq=32, hkv=8, s=4096, d=64),
                dict(b=1, hq=32, hkv=8, s=32768, d=64))
LM = dict(arch="llama3.2-1b", batch=4, prompt=4096, new_tokens=64,
          parity_batch=2, parity_len=1024)
# bf16 flash_attention against the plain version: the kernel rounds p to
# bf16 for p @ v, per 128-key tile, and the output to bf16
BF16_REL_TOL = 1e-2   # relative Frobenius error
BF16_ABS_TOL = 2e-2   # max |diff| / max |ref|
# the model's logits and caches, kernel path vs plain chunked path: fp32
# differs by summation order through 16 layers; bf16 also rounds p at
# other tiles (64 keys against 1024) and every activation after it
LM_F32_TOL = 1e-4
LM_BF16_TOL = 5e-2
# the card's published bf16 dense tensor-core peak (H100 SXM data sheet)
PEAK_BF16_FLOP_PER_S = 989e12
# the CLI's default path (phase 7): the dense single-device sweep at the
# grid sweep's size, and the modes whose member loop or exact eigh of an
# (n, n) surrogate per member make them run smaller
DENSE = dict(n=16384, m=8, k_true=4, k_min=2, k_max=5, r=4, iters=300,
             grid_chunk=4, small_n=4096)


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
    log(f"[build] kernel library {lib.relative_to(ROOT)}: "
        f"{len(_build.sources())} sources built and loaded in "
        f"{time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def compare(name: str, got, ref, rel_tol: float = REL_TOL,
            abs_tol: float = ABS_TOL) -> float:
    """Raise unless got ~ ref (relative Frobenius error <= rel_tol, max
    |diff| <= abs_tol * max |ref|); return max |got - ref|."""
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
    require(rel <= rel_tol, f"{name}: relative error {rel:.3e} > {rel_tol}")
    require(max_abs <= abs_tol * ref_max,
            f"{name}: max |diff| {max_abs:.3e} > {abs_tol} * {ref_max:.3e}")
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
    """Both kernels at the edge shapes, against their plain versions; XA
    bit-identical across two calls; empty block rows and cols exactly
    zero."""
    import torch
    from repro_torch.kernels import bcsr_fused, bcsr_spmm, ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    # nb = 5 (or 7): block rows 1 and 3 and block cols 0 and 4 store nothing
    gappy = ([0, 0, 2, 2, 4], [1, 3, 1, 2, 3])
    # nb = 47: block row 0 holds 44 blocks, rows 1-2 and 4-45 none, block
    # cols 44 and 45 none (uneven work per block row)
    uneven = ([0] * 44 + [3, 3, 46], list(range(44)) + [0, 5, 46])
    cases = [  # (n, bs, pattern, k, data members, operand members)
        (600, 128, gappy, 3, None, None),      # bs does not divide n
        (600, 128, gappy, 16, 4, 4),           # r = 4, k = 16
        (150, 32, gappy, 3, 4, 4),             # bs = 32, tail 10
        (160, 32, gappy, 16, None, 4),         # shared data, r = 4 operand
        (256, 128, ([], []), 3, None, None),   # nnzb == 0
        (256, 128, ([], []), 16, 4, 4),
        (6000, 128, uneven, 5, 4, 4),          # 44 blocks beside empty rows
        (6000, 128, uneven, 8, None, 4),       # the same, shared data
        (300, 64, gappy, 5, None, None),       # bs = 64
        (300, 64, gappy, 4, 4, 4),
        (450, 96, gappy, 9, 4, 4),             # bs = 96, two k-slices
        (450, 96, gappy, 8, None, 4),
        (600, 128, gappy, 1, None, 4),         # k = 1, shared data
        (600, 128, gappy, 12, 4, 4),           # k = 12: a half-full k-slice
        (600, 128, gappy, 33, 4, 4),           # k = 33: five k-slices
        (200, 32, gappy, 64, None, 4),         # k = 64, shared data
    ]
    for n, bs, (rows, cols), k, dr, br in cases:
        sp = pattern_bcsr(rows, cols, n, bs, 3, dr, gen, dev)
        shape = (br, n, k) if br is not None else (n, k)
        B1 = torch.rand(shape, generator=gen, device=dev)
        B2 = torch.rand(shape, generator=gen, device=dev)
        xa, xt = bcsr_fused.bcsr_xa_xta(sp, B1, B2)
        xa2, _ = bcsr_fused.bcsr_xa_xta(sp, B1, B2)
        sa = bcsr_spmm.bcsr_spmm(sp, B1)
        torch.cuda.synchronize()
        ra, rt = ref.ref_bcsr_xa_xta(sp, B1, B2)
        tag = f"n={n} bs={bs} nnzb={sp.nnzb} k={k} r={dr or br or 1}"
        compare(f"bcsr_xa_xta XA [{tag}]", xa, ra)
        compare(f"bcsr_xa_xta XTB [{tag}]", xt, rt)
        compare(f"bcsr_spmm [{tag}]", sa, ra)
        require(torch.equal(xa, xa2), f"bcsr_xa_xta XA differs between two "
                                      f"calls [{tag}]")
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


def device_ms(fn, name: str, reps: int) -> float:
    """Mean device milliseconds per call of the kernels whose name holds
    ``name``, from ``torch.profiler`` over ``reps`` calls (0.0 when the
    profiler records no device time)."""
    import torch
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.key_averages()
                if name in e.key)
    return total / 1e3 / reps


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
    n, m, bs, r = cfg["n"], cfg["m"], cfg["bs"], cfg["r"]
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
    log(f"[kernels] main-path shape: r={r} m={m} nnzb={nnzb} bs={bs} n={n} "
        f"k in {BCSR_KS} ({sp_r.data.numel() * 4 / 1e9:.2f} GB of stored "
        f"blocks)")
    T = r * m
    by_k = {}
    for k in BCSR_KS:
        A_r = torch.rand((r, n, k), generator=gen, device=dev)
        xa, xt = bcsr_fused.bcsr_xa_xta(sp_r, A_r, A_r)
        xa2, _ = bcsr_fused.bcsr_xa_xta(sp_r, A_r, A_r)
        torch.cuda.synchronize()
        require(torch.equal(xa, xa2), f"bcsr_xa_xta XA differs between two "
                                      f"calls [main, k={k}]")
        del xa2
        ra, rt = ref.ref_bcsr_xa_xta(sp_r, A_r, A_r)
        err = max(compare(f"bcsr_xa_xta XA [main, k={k}]", xa, ra),
                  compare(f"bcsr_xa_xta XTB [main, k={k}]", xt, rt))
        del xa, xt, ra, rt
        f_bytes = (sp_r.data.numel() * 4 + 2 * A_r.numel() * 4
                   + 2 * T * n * k * 4)
        f_flops = T * nnzb * bs * bs * 4 * k
        ms = cuda_ms(lambda: bcsr_fused.bcsr_xa_xta(sp_r, A_r, A_r), reps=10)
        plain = cuda_ms(lambda: ref.ref_bcsr_xa_xta(sp_r, A_r, A_r), reps=3,
                        warmup=1)
        b_ms, by = bound(f_bytes, f_flops)
        by_k[k] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                       bound_by=by)
        log(f"[kernels] bcsr_xa_xta at k={k}: kernel {ms:.3f} ms "
            f"({100 * b_ms / ms:.1f}% of the bound), plain {plain:.3f} ms, "
            f"bound {b_ms:.3f} ms ({by}), max |diff| {err:.3e}, XA "
            f"bit-identical across calls")
        del A_r
    log(f"[kernels] bcsr_xa_xta at k=8: {by_k[8]['ms']:.3f} ms (PR 16's "
        f"kernel: 8.322 ms)")
    del sp_r
    torch.cuda.empty_cache()

    # the error / regression operand: the unperturbed tensor, A (n, k), at
    # the k = 8 of earlier PRs' rows
    k = 8
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
             launches=0, library_ms=None, **by_k[FULL["k_max"]]),
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
    over the m slices (stride 0), as ``core.rescal.dense_products`` passes
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


def check_mu_edges(dev) -> None:
    """mu_update_a against its plain version at the edge shapes: any n
    (empty and ragged), k from 1 to 64, one or four members, S per member
    or shared (member stride 0), and padded columns, which must stay
    exact zeros; k = 65 is refused."""
    import torch
    from repro_torch.kernels import mu_update_a as mu
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    eps = 1e-16
    for n in (0, 1, 37, 1000):
        for k in (1, 3, 5, 16, 64):
            for r, shared in ((None, False), (4, False), (4, True)):
                lead = (r,) if r is not None else ()
                A = torch.rand(lead + (n, k), generator=gen, device=dev)
                Num = torch.rand(lead + (n, k), generator=gen, device=dev)
                S = torch.rand((k, k) if shared or r is None
                               else lead + (k, k), generator=gen, device=dev)
                if shared:
                    S = S.expand(r, k, k)
                got = mu.mu_update_a(A, Num, S, eps)
                torch.cuda.synchronize()
                compare(f"mu_update_a [n={n} k={k} r={r or 1} "
                        f"shared={shared}]", got,
                        ref.ref_mu_update_a(A, Num, S, eps))
        log(f"[mu] edge cases n={n}: ok")
    # padded cells (the cross-k grid): columns past each cell's rank zero
    # in A and in S's rows and columns
    ks, k_max, n = (2, 3, 4, 5), 5, 1000
    mask = (torch.arange(k_max, device=dev)[None, :]
            < torch.tensor(ks, device=dev)[:, None]).float()
    A = torch.rand((len(ks), n, k_max), generator=gen, device=dev) \
        * mask[:, None, :]
    Num = torch.rand(A.shape, generator=gen, device=dev) * mask[:, None, :]
    S = torch.rand((len(ks), k_max, k_max), generator=gen, device=dev) \
        * (mask[:, :, None] * mask[:, None, :])
    got = mu.mu_update_a(A, Num, S, eps)
    torch.cuda.synchronize()
    compare("mu_update_a [padded cells]", got,
            ref.ref_mu_update_a(A, Num, S, eps))
    require(not (got * (1 - mask[:, None, :])).any(),
            "mu_update_a: a padded column is not exactly zero")
    try:
        mu.mu_update_a(torch.rand((4, 65), device=dev),
                       torch.rand((4, 65), device=dev),
                       torch.rand((65, 65), device=dev), eps)
    except ValueError:
        pass
    else:
        raise PhaseError("mu_update_a accepted k = 65")
    log("[mu] padded cells stay exact zeros; k = 65 refused")


def phase_mu(dev) -> dict:
    """mu_update_a at the edge shapes, then held and timed at the sweeps'
    shapes (A and Num (r, n, k), S (r, k, k)) beside its plain version and
    its bound: A and Num read and the update written once (12 bytes per
    element, S's k*k per member besides), 2k + 2 flop per element."""
    import torch
    from repro_torch.kernels import mu_update_a as mu
    from repro_torch.kernels import ref
    check_mu_edges(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    eps = 1e-16
    row = None
    for cfg in MU_SCALES:
        r, n, k = cfg["r"], cfg["n"], cfg["k"]
        A = torch.rand((r, n, k), generator=gen, device=dev)
        Num = torch.rand((r, n, k), generator=gen, device=dev)
        S = torch.rand((r, k, k), generator=gen, device=dev)
        got = mu.mu_update_a(A, Num, S, eps)
        torch.cuda.synchronize()
        err = compare(f"mu_update_a [r={r} n={n} k={k}]", got,
                      ref.ref_mu_update_a(A, Num, S, eps))
        ms = cuda_ms(lambda: mu.mu_update_a(A, Num, S, eps), reps=200)
        plain = cuda_ms(lambda: ref.ref_mu_update_a(A, Num, S, eps),
                        reps=200)
        dev_ms = device_ms(lambda: mu.mu_update_a(A, Num, S, eps),
                           "mu_update_a_kernel", reps=50)
        b_ms, by = bound(4 * (3 * A.numel() + S.numel()),
                         (2 * k + 2) * A.numel())
        log(f"[mu] mu_update_a at r={r} n={n} k={k}: kernel {ms:.4f} ms "
            f"per call ({dev_ms:.4f} ms on the device per launch, "
            f"torch.profiler), plain {plain:.4f} ms, bound {b_ms:.4f} ms "
            f"({by}), max |diff| {err:.3e}")
        row = dict(name="mu_update_a", route="cuda",
                   source="src/repro_torch/kernels/csrc/mu_update_a.cu",
                   replaces="src/repro/kernels/mu_ratio.py:43",
                   launches=0, max_abs_err=err, ms=ms, plain_ms=plain,
                   bound_ms=b_ms, bound_by=by, library_ms=None)
        del A, Num, S, got
    torch.cuda.empty_cache()
    return row


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
    want = (cfg["k_max"] - cfg["k_min"] + 1) * cfg["iters"]
    require(launches["mu_update_a"] == want,
            f"mu_update_a launched {launches['mu_update_a']} times, want "
            f"{want} (one per MU iteration)")
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


def profiled(fn):
    """Run ``fn`` under torch.profiler, ending in a synchronize: (wall
    seconds, device busy seconds, device events by descending time)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda_type = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and (getattr(e, "device_type", None) == cuda_type
                   or e.cpu_time_total == 0)]
    busy = sum(e.device_time_total for e in events) / 1e6
    return wall, busy, sorted(events, key=lambda e: -e.device_time_total)


def profile_serve(fb, queries) -> None:
    """The serve stream once more, on a fresh engine, under
    torch.profiler: wall time, the device's busy time and idle share, and
    device time by kernel, per device batch."""
    from repro_torch.serve import ServeConfig, ServeEngine
    cfg = SERVE
    engine = ServeEngine(fb, ServeConfig(topk=cfg["topk"],
                                         batch=cfg["batch"]))
    per = -(-len(queries) // cfg["requests"])

    def stream():
        for c0 in range(0, len(queries), per):
            engine.query(queries[c0:c0 + per])

    wall, busy, events = profiled(stream)
    batches = engine.stats()["batches"]
    log(f"[serve] profiled stream: {batches} device batches, wall "
        f"{wall * 1e3:.3f} ms, device busy {busy * 1e3:.3f} ms "
        f"({100 * (1 - busy / wall):.1f}% idle); per batch "
        f"{wall / batches * 1e3:.4f} ms wall, "
        f"{busy / batches * 1e3:.4f} ms device")
    for e in events[:8]:
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


def check_grid_result(res, n, cfg=GRID) -> None:
    import numpy as np
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


def phase_grid(row: dict, tmp: Path, dev):
    """Phase 6 (see the module docstring); sets row's launches and
    returns the kernel sweep's result."""
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
        for name in ("fused_xa_xtb", "mu_update_a"):
            require(launches[name] == want,
                    f"{name} launched {launches[name]} times, want {want} "
                    f"(one per MU iteration)")
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
    return res


# ---------------------------------------------------------------------------
# Phase 7: the CLI's default path, the dense sweep on one device
# ---------------------------------------------------------------------------

def run_dense_cli(tmp: Path, name: str, n: int, *extra: str):
    """One sweep through ``rescalk_run.main`` on the synthetic tensor
    (no --data); returns (result, report, launches of this run)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import rescalk_run
    cfg = DENSE
    argv = ["--n", str(n), "--m", str(cfg["m"]),
            "--k-true", str(cfg["k_true"]), "--k-min", str(cfg["k_min"]),
            "--k-max", str(cfg["k_max"]), "--r", str(cfg["r"]),
            "--iters", str(cfg["iters"]), "--use-fused-kernel",
            "--report", str(tmp / f"{name}.json"), *extra]
    log(f"[dense] rescalk_run {' '.join(argv)}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res, rep = rescalk_run.main(argv)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    iters = sum(len(u.cells) if u.cells else len(u.members)
                for u in rep.units) * cfg["iters"] // cfg["r"]
    log(f"[dense] {name}: {wall:.1f}s wall, units "
        + " ".join(f"{u.uid}:{u.seconds:.3f}s" for u in rep.units)
        + f"; {1e3 * rep.total_seconds / iters:.2f} ms per MU iteration of "
        f"{cfg['r']} members; launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    check_grid_result(res, n, DENSE)
    require(rep.mode == (extra[extra.index("--mode") + 1]
                         if "--mode" in extra else "batched"),
            f"{name}: the report's mode is {rep.mode}")
    torch.cuda.empty_cache()
    return res, rep, launches


def same_curves(tag: str, a, b, tol: float = SWEEP_TOL) -> None:
    """The same k_opt and per-k s_min / s_mean / rel_err within tol."""
    import numpy as np
    require(a.k_opt == b.k_opt, f"{tag}: k_opt {a.k_opt} vs {b.k_opt}")
    for name in ("s_min", "s_mean", "rel_err"):
        x, y = getattr(a, name), getattr(b, name)
        worst = float(np.abs(x - y).max())
        log(f"[dense] {tag} {name}: {np.round(x, 6).tolist()} vs "
            f"{np.round(y, 6).tolist()} max |diff| {worst:.2e}")
        require(worst <= tol, f"{tag}: {name} differs by {worst:.2e}")


def phase_dense(rows: dict, grid_res, tmp: Path) -> None:
    """Phase 7 (see the module docstring); sets the launches of
    fused_xa_xtb and mu_update_a from the full-width kernel run."""
    cfg = DENSE
    n, want = cfg["n"], (cfg["k_max"] - cfg["k_min"] + 1) * cfg["iters"]
    res, _, launches = run_dense_cli(tmp, "dense", n)
    for name in ("fused_xa_xtb", "mu_update_a"):
        require(launches[name] == want,
                f"{name} launched {launches[name]} times in the dense "
                f"sweep, want {want} (one per MU iteration)")
        rows[name]["launches"] = launches[name]
    require(res.k_opt == cfg["k_true"],
            f"the dense sweep picked k_opt = {res.k_opt}, planted "
            f"{cfg['k_true']}")
    same_curves("dense vs the 1 x 1 grid sweep (phase 6)", res, grid_res)

    ref, _, launches = run_dense_cli(tmp, "dense_ref", n, "--fused-impl",
                                     "ref")
    require(not any(launches.values()), "the ref sweep launched a kernel")
    same_curves("dense kernel vs ref", res, ref)

    chunked, rep, launches = run_dense_cli(
        tmp, "dense_grid", n, "--mode", "grid", "--grid-chunk",
        str(cfg["grid_chunk"]))
    cells = (cfg["k_max"] - cfg["k_min"] + 1) * cfg["r"]
    require(len(rep.units) == -(-cells // cfg["grid_chunk"]),
            f"grid mode ran {len(rep.units)} chunks")
    for name in ("fused_xa_xtb", "mu_update_a"):
        require(launches[name] == len(rep.units) * cfg["iters"],
                f"{name} launched {launches[name]} times in grid mode")
    same_curves("dense batched vs grid mode", res, chunked)

    small = cfg["small_n"]
    base, _, _ = run_dense_cli(tmp, "small", small)
    for name, extra in (("small_loop", ("--mode", "loop")),
                        ("small_sliced", ("--schedule", "sliced")),
                        ("small_nndsvd", ("--init", "nndsvd"))):
        other, _, launches = run_dense_cli(tmp, name, small, *extra)
        require(launches["mu_update_a"] > 0 and launches["fused_xa_xtb"] > 0,
                f"{name}: the kernels were not launched")
        require(other.k_opt == base.k_opt,
                f"{name}: k_opt {other.k_opt}, batched {base.k_opt}")
        log(f"[dense] {name}: k_opt = {other.k_opt}, as the batched run at "
            f"n = {small}")


# ---------------------------------------------------------------------------
# Phase 8: LM serving, the dense decoder through flash_attention
# ---------------------------------------------------------------------------

def flash_inputs(gen, dev, dtype, b, sq, skv, hq, hkv, d):
    """q, k, v as (b, h, s, d) views of (b, s, h, d) tensors, the model's
    layout."""
    import torch
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev)
               .to(dtype).transpose(1, 2)
               for s, h in ((sq, hq), (skv, hkv), (skv, hkv)))
    return q, k, v


def check_flash(name: str, got, q, k, v, **kw) -> tuple[float, float]:
    """Hold a flash_attention result to the plain version on the same
    inputs: fp32 to REL_TOL / ABS_TOL; bf16 to BF16_REL_TOL /
    BF16_ABS_TOL against the plain version in bf16 and against it on the
    fp32 copies.  Returns (relative error, max |diff|) against the plain
    version."""
    import torch
    from repro_torch.kernels import ref
    want = ref.ref_attention(q, k, v, **kw)
    require(got.dtype == q.dtype and got.shape == q.shape,
            f"{name}: {got.dtype} {tuple(got.shape)}")
    if q.dtype == torch.float32:
        err = compare(name, got, want)
    else:
        err = compare(name + " vs plain bf16", got.float(), want.float(),
                      BF16_REL_TOL, BF16_ABS_TOL)
        want32 = ref.ref_attention(q.float(), k.float(), v.float(), **kw)
        compare(name + " vs plain fp32", got.float(), want32, BF16_REL_TOL,
                BF16_ABS_TOL)
        want = want32
    return rel_frob(got, want), err


def check_flash_grid(dev) -> None:
    """flash_attention against its plain version over FLASH_CHECK: every
    dtype, head dim, (hq, hkv), causal or not, q_offset and (sq, skv)."""
    import itertools
    import torch
    from repro_torch.kernels import flash_attention as fa
    cfg = FLASH_CHECK
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    for dtype, d in itertools.product(cfg["dtypes"], cfg["dims"]):
        t0 = time.perf_counter()
        worst, worst_abs, n = 0.0, 0.0, 0
        fa.reset_launch_count()
        for (hq, hkv), causal, q_offset, sq, skv in itertools.product(
                cfg["heads"], (True, False), cfg["q_offsets"], cfg["sq"],
                cfg["skv"]):
            q, k, v = flash_inputs(gen, dev, getattr(torch, dtype),
                                   cfg["b"], sq, skv, hq, hkv, d)
            kw = dict(causal=causal, q_offset=q_offset)
            got = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            rel, err = check_flash(
                f"flash_attention [{dtype} d={d} hq={hq} hkv={hkv} "
                f"causal={causal} q_offset={q_offset} sq={sq} skv={skv}]",
                got, q, k, v, **kw)
            worst, worst_abs, n = max(worst, rel), max(worst_abs, err), n + 1
        variant = fa.VARIANTS[getattr(torch, dtype)]
        by_variant = fa.launch_count_by_variant()
        require(by_variant[variant] == n == fa.launch_count(),
                f"flash_attention {dtype} d={d}: launches {by_variant}, want "
                f"{n} of {variant}")
        log(f"[flash] {dtype} d={d} ({variant}): {n} cases ok, largest "
            f"relative error "
            f"{worst:.3e}, largest max |diff| {worst_abs:.3e} "
            f"({time.perf_counter() - t0:.1f}s)")


def sdpa_call(q, k, v):
    """torch's scaled_dot_product_attention, causal, GQA, on the same (b,
    h, s, d) tensors: the yardstick, timed here and never called by the
    port."""
    import torch
    F = torch.nn.functional
    return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)


def time_flash(dev, cfg: dict, reps: int, plain_reps: int) -> dict:
    """flash_attention at one timing shape (bf16, causal): checked against
    the plain version, then the kernel, the plain version and the
    yardstick timed with CUDA events, beside the bound from this shape's
    operations (4 b hq d times the s (s + 1) / 2 visible pairs, over the
    bf16 tensor-core peak) and bytes (q, k and v read once, the output
    written once, over the HBM rate)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    b, hq, hkv, s, d = (cfg[x] for x in ("b", "hq", "hkv", "s", "d"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(s)
    q, k, v = flash_inputs(gen, dev, torch.bfloat16, b, s, s, hq, hkv, d)
    tag = f"b={b} hq={hq} hkv={hkv} s={s} d={d} bf16 causal"
    fa.reset_launch_count()
    got = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    require(fa.launch_count_by_variant()["sm90_bf16"] == 1,
            f"flash_attention [{tag}]: not the tensor-core kernel "
            f"({fa.launch_count_by_variant()})")
    rel, err = check_flash(f"flash_attention [{tag}]", got, q, k, v,
                           causal=True)
    lib_fn = sdpa_call(q, k, v)
    compare(f"scaled_dot_product_attention [{tag}] (yardstick)",
            lib_fn().float(), got.float(), BF16_REL_TOL, BF16_ABS_TOL)
    del got
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True), reps=reps)
    plain = cuda_ms(lambda: ref.ref_attention(q, k, v, causal=True),
                    reps=plain_reps, warmup=1)
    lib = cuda_ms(lib_fn, reps=reps)
    flops = 4 * b * hq * d * s * (s + 1) // 2
    nbytes = 2 * (2 * b * hq * s * d + 2 * b * hkv * s * d)
    t_ops = flops / PEAK_BF16_FLOP_PER_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms, by = (t_ops, "operations") if t_ops >= t_bytes else \
        (t_bytes, "bytes")
    log(f"[flash] {tag}: kernel sm90_bf16 {ms:.3f} ms ({flops / ms / 1e9:.1f}"
        f" TFLOP/s, {100 * bound_ms / ms:.1f}% of the bound), plain "
        f"{plain:.3f} ms, scaled_dot_product_attention {lib:.3f} ms "
        f"({ms / lib:.2f}x), bound {bound_ms:.3f} ms ({by}), relative error "
        f"{rel:.3e}, max |diff| {err:.3e}")
    del q, k, v, lib_fn
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound_ms,
                bound_by=by, max_abs_err=err)


def rel_frob(a, b) -> float:
    import torch
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def check_full_width_fp32(dev) -> None:
    """llama3.2-1b at full width in fp32 (seeded torch init): one prefill
    through the kernel and one through the plain chunked path; last-
    position logits and both caches within LM_F32_TOL, one flash_attention
    launch per layer."""
    import dataclasses
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import make_prefill_step
    cfg = dataclasses.replace(ARCHS[LM["arch"]], dtype="float32")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = Transformer(cfg, device=dev, gen=gen)
    toks = torch.randint(0, cfg.vocab, (LM["parity_batch"],
                                        LM["parity_len"]),
                         generator=gen, device=dev)
    ops.reset_launch_counts()
    logits, cache = make_prefill_step(model)(toks)
    torch.cuda.synchronize()
    launches = ops.launch_counts()["flash_attention"]
    require(launches == cfg.n_layers
            == fa.launch_count_by_variant()["fma_fp32"],
            f"fp32 prefill launched flash_attention {launches} times "
            f"({fa.launch_count_by_variant()}), want {cfg.n_layers} of "
            f"fma_fp32")
    ref_logits, ref_cache = make_prefill_step(model, impl="ref")(toks)
    require(ops.launch_counts()["flash_attention"] == launches,
            "the ref prefill launched flash_attention")
    errs = {"logits": rel_frob(logits, ref_logits)}
    errs.update({name: rel_frob(cache[name], ref_cache[name])
                 for name in ("k", "v")})
    for name, e in errs.items():
        require(e <= LM_F32_TOL, f"fp32 full-width prefill: {name} relative "
                f"error {e:.3e} > {LM_F32_TOL}")
    log(f"[lm] {cfg.name} fp32 full width, prefill {LM['parity_batch']}x"
        f"{LM['parity_len']}: {launches} flash_attention launches; kernel vs "
        f"plain relative error " + ", ".join(f"{n} {e:.3e}"
                                             for n, e in errs.items()))
    del model, logits, cache, ref_logits, ref_cache
    torch.cuda.empty_cache()


def run_demo(*extra: str):
    from repro_torch.launch import decode_demo
    argv = ["--arch", LM["arch"], *extra]
    log(f"[lm] decode_demo {' '.join(argv)}")
    return decode_demo.main(argv)


def profile_lm(res, steps: int) -> None:
    """The cell's prefill once more, then ``steps`` decode steps fed the
    run's tokens, each under torch.profiler: wall, device busy time and
    idle share, and device time by kernel."""
    import torch
    from repro_torch.train import make_prefill_step, make_serve_step
    model, prompts = res.model, res.prompts
    B, Pn = prompts.shape
    prefill = make_prefill_step(model)
    serve = make_serve_step(model)
    out = {}
    wall, busy, events = profiled(lambda: out.update(
        zip(("logits", "cache"), prefill(prompts))))
    windows = [("prefill", 1, wall, busy, events)]
    with torch.inference_mode():
        cache = model.init_cache(B, Pn + steps)
        for name in cache:
            cache[name][:, :, :Pn] = out["cache"][name]
    del out

    def decode():
        for t in range(steps):
            serve(cache, res.tokens[:, t:t + 1], Pn + t)

    windows.append(("decode", steps, *profiled(decode)))
    for label, n, wall, busy, events in windows:
        log(f"[lm] profiled {label} ({n} call(s)): wall {wall * 1e3:.3f} ms, "
            f"device busy {busy * 1e3:.3f} ms ({100 * (1 - busy / wall):.1f}%"
            f" idle)")
        if label == "prefill":
            attn = sum(e.device_time_total for e in events
                       if "flash_sm90" in e.key) / 1e6
            log(f"[lm]   attention (flash_sm90) {attn * 1e3:.3f} ms, "
                f"{100 * attn / busy:.1f}% of the device's busy time, "
                f"{100 * attn / wall:.1f}% of the wall")
        for e in events[:8]:
            log(f"[lm]   {e.device_time_total / 1e3 / n:9.4f} ms/call "
                f"{100 * e.device_time_total / 1e6 / busy:5.1f}%  "
                f"x{e.count:<5d} {e.key[:70]}")
    del cache
    torch.cuda.empty_cache()


def phase_lm(dev, smi: str) -> dict:
    """Phase 8 (see the module docstring); returns flash_attention's row of
    the kernels line."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.train import make_prefill_step, make_serve_step
    check_flash_grid(dev)
    row = dict(name="flash_attention", route="cuda",
               source="src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
               replaces="src/repro/kernels/flash_attention.py:99",
               launches=0, max_abs_err=None, ms=None, plain_ms=None,
               bound_ms=None, bound_by=None, library_ms=None)
    row.update(time_flash(dev, FLASH_SCALES[0], reps=10, plain_reps=3))
    time_flash(dev, FLASH_SCALES[1], reps=3, plain_reps=1)
    check_full_width_fp32(dev)

    B, Pn, T = LM["batch"], LM["prompt"], LM["new_tokens"]
    run_demo("--batch", str(B), "--prompt-len", "256", "--new-tokens",
             "2")                                      # warm-up, unchecked
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    res = run_demo("--batch", str(B), "--prompt-len", str(Pn),
                   "--new-tokens", str(T))
    launches = ops.launch_counts()
    cfg = res.model.cfg
    require(launches["flash_attention"] == cfg.n_layers
            == res.flash_launches,
            f"decode_demo launched flash_attention "
            f"{launches['flash_attention']} times, want {cfg.n_layers}")
    require(not any(n for name, n in launches.items()
                    if name != "flash_attention"),
            f"decode_demo launched other kernels: {launches}")
    by_variant = fa.launch_count_by_variant()
    require(by_variant == {"sm90_bf16": cfg.n_layers, "fma_fp32": 0},
            f"decode_demo's bf16 prefill launched {by_variant}, want "
            f"{cfg.n_layers} tensor-core (sm90_bf16) launches")
    row["launches"] = launches["flash_attention"]
    require(res.tokens.shape == (B, T + 1) and int(res.tokens.max())
            < cfg.vocab and int(res.tokens.min()) >= 0,
            "decode_demo: bad tokens")
    require(bool(torch.isfinite(res.prefill_logits).all())
            and bool(torch.isfinite(res.step_logits).all()),
            "decode_demo: non-finite logits")

    ref_logits, ref_cache = make_prefill_step(res.model, impl="ref")(
        res.prompts)
    require(ops.launch_counts()["flash_attention"] == cfg.n_layers,
            "the ref prefill launched flash_attention")
    pre_err = rel_frob(res.prefill_logits, ref_logits)
    require(pre_err <= LM_BF16_TOL, f"decode_demo: last-position logits "
            f"{pre_err:.3e} from the plain path (> {LM_BF16_TOL})")
    serve = make_serve_step(res.model)
    with torch.inference_mode():
        cache = res.model.init_cache(B, Pn + T)
        for name in cache:
            cache[name][:, :, :Pn] = ref_cache[name]
    del ref_cache
    step_errs, same = [], 0
    for t in range(T):
        logits, cache = serve(cache, res.tokens[:, t:t + 1], Pn + t)
        step_errs.append(rel_frob(res.step_logits[:, t:t + 1], logits))
        same += int((logits.argmax(-1) == res.tokens[:, t + 1:t + 2]).sum())
    require(max(step_errs) <= LM_BF16_TOL, f"decode_demo: step logits "
            f"{max(step_errs):.3e} from the plain path (> {LM_BF16_TOL})")
    log(f"[lm] {cfg.name} {cfg.dtype} full width ({smi}): prefill {B}x{Pn} "
        f"{res.prefill_ms:.1f} ms ({B * Pn / res.prefill_ms * 1e3:.0f} "
        f"tok/s); decode {T} steps {res.decode_ms / T:.2f} ms/step "
        f"({B * T / res.decode_ms * 1e3:.0f} tok/s); flash_attention "
        f"launches {launches['flash_attention']} (sm90_bf16 "
        f"{by_variant['sm90_bf16']}); peak device memory "
        f"{res.peak_bytes / 1e9:.2f} GB")
    log(f"[lm] kernel vs plain path: last-position logits relative error "
        f"{pre_err:.3e}; decode logits fed the kernel path's tokens, "
        f"largest relative error {max(step_errs):.3e}; the plain path's "
        f"greedy token equals the kernel path's in {same} of {B * T}")
    del cache
    profile_lm(res, min(16, T))
    del res
    torch.cuda.empty_cache()
    return row


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
    rows = phase_kernels(dev) + [phase_fused(dev), phase_mu(dev),
                                 phase_topk(dev)]
    by_name = {row["name"]: row for row in rows}
    with tempfile.TemporaryDirectory() as tmp:
        bundle = phase_sweeps(rows, Path(tmp))
        phase_serve(bundle, by_name["score_topk"], dev)
        torch.cuda.empty_cache()
        grid_res = phase_grid(by_name["fused_xa_xtb"], Path(tmp), dev)
        phase_dense(by_name, grid_res, Path(tmp))
    torch.cuda.empty_cache()
    rows.append(phase_lm(dev, smi))
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
