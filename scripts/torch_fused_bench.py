#!/usr/bin/env python3
"""fused_xa_xtb on one CUDA device: kernel time beside its bytes bound.

Times ``repro_torch.kernels.fused_bilinear.fused_xa_xtb`` by CUDA events
at the shapes of ``chip_smoke.py``: the dense sweep's operands
(``FUSED_SCALE``: X (4, 8, 16384, 16384), 34.4 GB, B1 = A (4, n, k), B2 =
A broadcast over the slices) at every k of ``FUSED_SCALE["ks"]``, one
slice of it (the sliced schedule's call) at ``FUSED_SCALE["sliced_k"]``,
and the exascale dense share's X (20, 12288, 12288), 12.08 GB, at k =
10.  Beside each: the bound (X, B1, B2 read once, XA and XTB written
once, over 3.35 TB/s), the relative Frobenius error against the plain
version, and, as a yardstick of reading X twice, the two cuBLAS calls
``X @ B1`` and ``X^T @ B2`` in strict fp32 (the port never calls them).

    python3 scripts/torch_fused_bench.py [--src DIR] [--tag NAME]
        [--reps 5] [--out FILE]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so that two trees can be timed in turns in
one run on one card.  Prints one line per shape and, last, a JSON object
with every number and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PEAK_BYTES_PER_S = 3.35e12
EXA_SHAPE = dict(m=20, n=12288, k=10)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_fused_bench: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    from chip_smoke import FUSED_SCALE, cuda_ms
    from repro_torch import device as _device
    from repro_torch.kernels import fused_bilinear, ref

    _device.strict_fp32()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    rows = []

    def rel(got, want) -> float:
        return float(torch.linalg.vector_norm(got - want)
                     / torch.linalg.vector_norm(want))

    def run(tag, X, A, B2):
        k = A.shape[-1]
        xa, xt = fused_bilinear.fused_xa_xtb(X, A, B2)
        ra, rt = ref.ref_fused_xa_xtb(X, A, B2)
        err = max(rel(xa, ra), rel(xt, rt))
        del xa, xt, ra, rt
        ms = cuda_ms(lambda: fused_bilinear.fused_xa_xtb(X, A, B2),
                     reps=args.reps)
        Xt = X.transpose(-1, -2)
        lib = cuda_ms(lambda: (X @ A.unsqueeze(-3), Xt @ B2),
                      reps=args.reps)
        slices = X.numel() // (X.shape[-1] * X.shape[-2])
        nbytes = 4 * (X.numel() + A.numel() + A.numel()
                      + slices * (X.shape[-2] + X.shape[-1]) * k)
        bound = nbytes / PEAK_BYTES_PER_S * 1e3
        row = dict(shape=tag, k=k, x_gb=X.numel() * 4 / 1e9, ms=ms,
                   bound_ms=bound, share=bound / ms, rel_err=err,
                   cublas_pair_ms=lib)
        rows.append(row)
        print(f"[{args.tag}] {tag} k={k}: kernel {ms:.3f} ms, bound "
              f"{bound:.3f} ms ({100 * bound / ms:.1f}%), cuBLAS pair "
              f"{lib:.3f} ms, rel err {err:.2e}", flush=True)

    cfg = FUSED_SCALE
    r, m, n = cfg["r"], cfg["m"], cfg["n"]
    X = torch.rand((r, m, n, n), generator=gen, device=dev)
    for k in cfg["ks"]:
        A = torch.rand((r, n, k), generator=gen, device=dev)
        run("sweep", X, A, A.unsqueeze(-3).expand(r, m, n, k))
        if k == cfg["sliced_k"]:
            Xt = X[0, 2:3]
            run("one slice", Xt, A[0], A[0].unsqueeze(0))
        del A
    del X
    torch.cuda.empty_cache()
    e = EXA_SHAPE
    X = torch.rand((e["m"], e["n"], e["n"]), generator=gen, device=dev)
    A = torch.rand((e["n"], e["k"]), generator=gen, device=dev)
    run("exascale (a)", X, A, A.unsqueeze(0).expand(e["m"], e["n"], e["k"]))
    out = {"tag": args.tag, "src": args.src, "card": smi, "rows": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
