#!/usr/bin/env python3
"""Where one sparse MU iteration of the port spends its device time.

Runs ``repro_torch.core.sparse.sparse_mu_step`` at the shape of
``chip_smoke.py``'s sweep (r = 4 members, m = 8, n = 131072, bs = 128,
the same block pattern) on one CUDA device, times it with CUDA events,
and traces a window of iterations with ``torch.profiler`` to split the
device time by kernel.

    python3 scripts/torch_profile_mu.py [--k 5] [--iters 10] [--impl auto]
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--impl", default="auto", choices=("auto", "ref"))
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_profile_mu: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import FULL, cuda_ms, main_pattern
    from repro_torch import device as _device
    from repro_torch.core.sparse import BCSR, sparse_mu_step
    from repro_torch.kernels.policy import KernelPolicy

    _device.strict_fp32()
    dev = torch.device("cuda")
    n, m, bs, r, k = FULL["n"], FULL["m"], FULL["bs"], FULL["r"], args.k
    _, rows, cols = main_pattern(n, bs, FULL["off_density"], FULL["seed"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    sp = BCSR(data=torch.rand((r, m, len(rows), bs, bs), generator=gen,
                              device=dev),
              block_rows=torch.from_numpy(rows.astype(np.int32)).to(dev),
              block_cols=torch.from_numpy(cols.astype(np.int32)).to(dev),
              n=n)
    A = torch.rand((r, n, k), generator=gen, device=dev) + 0.05
    R = torch.rand((r, m, k, k), generator=gen, device=dev) + 0.05
    policy = KernelPolicy(use_fused=True, impl=args.impl)

    def step():
        sparse_mu_step(sp, A, R, policy=policy)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    ms = cuda_ms(step, reps=args.iters, warmup=3)
    print(f"[profile] {smi}; r={r} m={m} nnzb={len(rows)} bs={bs} n={n} "
          f"k={k} impl={args.impl}: {ms:.3f} ms per MU iteration "
          f"(CUDA events, {args.iters} iterations)")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.iters):
            step()
        torch.cuda.synchronize()
    cuda_type = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and (getattr(e, "device_type", None) == cuda_type
                   or e.cpu_time_total == 0)]
    total = sum(e.device_time_total for e in events)
    print(f"[profile] device time {total / 1e3 / args.iters:.3f} ms per "
          f"iteration over {len(events)} kernels")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:12]:
        share = e.device_time_total / total if total else 0.0
        print(f"  {e.device_time_total / 1e3 / args.iters:8.3f} ms "
              f"{100 * share:5.1f}%  x{e.count // args.iters:<3d} "
              f"{e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
