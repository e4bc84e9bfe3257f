"""RESCALk model-selection CLI of the port (port of
``repro/launch/rescalk_run.py``): a BCSR sweep on a TSV triple list or an
NPZ COO file, which persists the selected factors as a FactorBundle.

Runs on the H100 by default; ``--device cpu`` runs the plain PyTorch path
on the CPU.  ``--use-fused-kernel`` routes every BCSR product through the
hand-written CUDA kernels (``--fused-impl ref`` keeps the plain PyTorch
products on the card instead).

    PYTHONPATH=src python -m repro_torch.launch.rescalk_run \\
        --data X.npz --bs 128 --k-min 2 --k-max 5 --r 4 --use-fused-kernel \\
        --report /tmp/r.json          # the bundle goes to /tmp/r.bundle

Flags of ``repro``'s CLI that are not ported yet are not defined here
(ROADMAP.md lists them).
"""
from __future__ import annotations

import argparse
import os
import time

from repro_torch import device as _device
from repro_torch.io import coo_to_bcsr, ingest_npz, ingest_tsv, manifest_of
from repro_torch.kernels.policy import IMPLS, KernelPolicy
from repro_torch.selection import CRITERIA, RescalkConfig, SweepScheduler
from repro_torch.serve import FactorBundle


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", required=True,
                    help="a .tsv triple list (head, relation, tail, "
                         "optional weight) or an .npz COO file (arrays "
                         "row/rel/col and optional val)")
    ap.add_argument("--bs", type=int, default=128,
                    help="BCSR block size")
    ap.add_argument("--k-min", type=int, default=2)
    ap.add_argument("--k-max", type=int, default=7)
    ap.add_argument("--r", type=int, default=4)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--criterion", default="threshold",
                    choices=sorted(CRITERIA),
                    help="k-selection rule (selection/criteria.py)")
    ap.add_argument("--report", default=None,
                    help="write the SelectionReport JSON here")
    ap.add_argument("--bundle", default=None, metavar="DIR",
                    help="persist the selected-k factors as a FactorBundle "
                         "here; default: <report>.bundle next to --report. "
                         "The report's meta gains a 'bundle' pointer")
    ap.add_argument("--use-fused-kernel", action="store_true",
                    help="route the BCSR products through the CUDA "
                         "kernels (kernels/ops.py)")
    ap.add_argument("--fused-impl", default="auto", choices=IMPLS,
                    help="kernel impl for --use-fused-kernel (auto: the "
                         "CUDA kernel on the card, the plain version on "
                         "the CPU)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def run(args):
    """Ingest, sweep and print; returns (RescalkResult, SelectionReport)."""
    dev = _device.resolve(args.device)
    t0 = time.perf_counter()
    vocab = None
    if args.data.endswith(".tsv"):
        coo, vocab = ingest_tsv(args.data)
        print(f"[io] {args.data}: {vocab.n} entities, {vocab.m} relations, "
              f"{coo.nnz} triples")
    elif args.data.endswith(".npz"):
        coo = ingest_npz(args.data)
        print(f"[io] {args.data}: n={coo.n} m={coo.m} nnz={coo.nnz}")
    else:
        raise SystemExit(f"--data must be .tsv or .npz, got {args.data!r}")
    sp = coo_to_bcsr(coo, bs=args.bs, device=dev)
    del coo
    resident = sp.data.numel() * sp.data.element_size()
    print(f"[io] bcsr bs={args.bs} nnzb={sp.nnzb} resident "
          f"{resident / 2**20:.1f} MiB on {dev} "
          f"({time.perf_counter() - t0:.1f}s)")
    print(f"operand m={sp.m} n={sp.n}, schedule=batched, mode=batched, "
          f"criterion={args.criterion}")
    cfg = RescalkConfig(k_min=args.k_min, k_max=args.k_max,
                        n_perturbations=args.r, rescal_iters=args.iters,
                        kernel=KernelPolicy(use_fused=args.use_fused_kernel,
                                            impl=args.fused_impl))
    sched = SweepScheduler(cfg, criterion=args.criterion,
                           report_path=args.report, verbose=True)
    res = sched.run(sp)
    print("\n" + res.summary())
    print(f"\nselected k_opt = {res.k_opt}")
    rep = sched.report
    print(f"[sweep] {len(rep.units)} units, {rep.n_reused} reused, "
          f"{rep.total_seconds:.2f}s compute, kernel launches "
          f"{rep.meta['kernel_launches']}")
    _persist_bundle(args, sp, res, vocab, rep)
    return res, rep


def _bundle_dir(args) -> str | None:
    if args.bundle is not None:
        return args.bundle
    if args.report is not None:
        return os.path.splitext(args.report)[0] + ".bundle"
    return None


def _persist_bundle(args, sp, res, vocab, report) -> None:
    """Persist the selected-k factors (member-median A, regressed R) as a
    FactorBundle, with the vocab of a TSV ingest and the operand's
    manifest, and point the report's meta at it."""
    bundle_dir = _bundle_dir(args)
    if bundle_dir is None:
        return
    ents, rels = vocab.names() if vocab is not None else (None, None)
    bundle = FactorBundle.from_sweep(
        res, entities=ents, relations=rels,
        manifest=manifest_of(sp).fingerprint(),
        meta={"criterion": args.criterion})
    bundle.save(bundle_dir)
    print(f"[bundle] {bundle_dir}: n={bundle.n} m={bundle.m} "
          f"k={bundle.k} digest={bundle.digest()[:12]}")
    if args.report:
        report.meta["bundle"] = bundle_dir
        report.save(args.report)


def main(argv=None):
    _device.strict_fp32()
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
