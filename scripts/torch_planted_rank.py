#!/usr/bin/env python3
"""Which full-width virtual BCSR cell recovers its planted rank?

Runs the port's sweep CLI (``repro_torch.launch.rescalk_run.main``, the
fused kernels) on ``virtual:bcsr:`` specs that differ from chip_smoke.py
phase 10's (``n=131072,m=8,k=4,bs=128,density=0.005,seed=0``, which
selects k = 2) only in the grammar's own ``density`` and ``skew`` fields
(and m, where the density's bytes need it), and prints, for each, the
selected k beside the planted 4 and the per-k s_min curve; ``--out``
keeps them as JSON.  A finding, not a check: the exit code is 0 whatever
is selected, non-zero only if a sweep fails.

    python3 scripts/torch_planted_rank.py                 # on the card
    python3 scripts/torch_planted_rank.py --device cpu \\
        --spec virtual:bcsr:n=4096,m=3,k=4,bs=128,density=0.05,seed=0
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# phase 10's operand with a denser, or skewed, block pattern: m = 8 at
# density 0.02 (~13 GB resident, 4 members beside it), and density 0.05
# at m = 3 (~10 GB)
SPECS = (
    "virtual:bcsr:n=131072,m=8,k=4,bs=128,density=0.02,seed=0",
    "virtual:bcsr:n=131072,m=3,k=4,bs=128,density=0.05,seed=0",
    "virtual:bcsr:n=131072,m=8,k=4,bs=128,density=0.02,skew=1.2,seed=0",
)
PLANTED = 4


def sweep(spec: str, args, tmp: Path) -> dict:
    from repro_torch.launch import rescalk_run
    argv = ["--data", spec, "--k-min", str(args.k_min), "--k-max",
            str(args.k_max), "--r", str(args.r), "--iters", str(args.iters),
            "--use-fused-kernel", "--device", args.device,
            "--report", str(tmp / "report.json")]
    t0 = time.perf_counter()
    res, _ = rescalk_run.main(argv)
    out = {"spec": spec, "k_opt": int(res.k_opt), "planted": PLANTED,
           "recovered": int(res.k_opt) == PLANTED,
           "ks": [int(k) for k in res.ks],
           "s_min": [float(x) for x in res.s_min],
           "s_mean": [float(x) for x in res.s_mean],
           "rel_err": [float(x) for x in res.rel_err],
           "seconds": time.perf_counter() - t0}
    print(f"[planted] {spec}: k_opt {out['k_opt']} (planted {PLANTED}; "
          f"{'recovered' if out['recovered'] else 'missed'}) in "
          f"{out['seconds']:.1f}s; s_min "
          + " ".join(f"k={k}:{s:.4f}" for k, s in zip(out["ks"],
                                                      out["s_min"]))
          + "; rel_err " + " ".join(f"{e:.4f}" for e in out["rel_err"]),
          flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spec", action="append",
                    help="a virtual:bcsr: spec (repeatable; default the "
                         "three SPECS)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--k-min", type=int, default=2)
    ap.add_argument("--k-max", type=int, default=6)
    ap.add_argument("--r", type=int, default=4)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--out", default=None, help="write the results as JSON")
    args = ap.parse_args(argv)
    from repro_torch import device as _device
    _device.strict_fp32()
    if args.device == "cuda":
        import subprocess
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        print(f"[planted] on {smi}", flush=True)
    results = []
    for spec in args.spec or SPECS:
        with tempfile.TemporaryDirectory() as tmp:
            results.append(sweep(spec, args, Path(tmp)))
        if args.device == "cuda":
            import torch
            torch.cuda.empty_cache()
    hits = [r["spec"] for r in results if r["recovered"]]
    print(f"[planted] {len(hits)} of {len(results)} specs recover k = "
          f"{PLANTED}" + (": " + ", ".join(hits) if hits else ""))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
