"""RESCALk model-selection CLI of the port (port of
``repro/launch/rescalk_run.py``): the sweep on the synthetic dense tensor
of ``--n/--m/--k-true`` (the default, built on the run's device), a BCSR
sweep on a TSV triple list or an NPZ COO file, or a virtual dataset
generated on the device (``--data virtual:{dense|bcsr}:k=v,...``, the
``io.virtual`` spec grammar); it persists the selected factors as a
FactorBundle.

Runs on the H100 by default; ``--device cpu`` runs the plain PyTorch path
on the CPU.  ``--use-fused-kernel`` routes the MU products and the A
update through the hand-written CUDA kernels (``--fused-impl ref`` keeps
the plain PyTorch versions on the card instead).  ``--mode`` runs the
members batched, as a loop, or as the cross-k grid in chunks of
``--grid-chunk`` cells.

    PYTHONPATH=src python -m repro_torch.launch.rescalk_run \\
        --n 256 --m 4 --k-true 5 --k-min 2 --k-max 7 --use-fused-kernel

    PYTHONPATH=src python -m repro_torch.launch.rescalk_run \\
        --data X.npz --bs 128 --k-min 2 --k-max 5 --r 4 --use-fused-kernel \\
        --report /tmp/r.json          # the bundle goes to /tmp/r.bundle

    PYTHONPATH=src python -m repro_torch.launch.rescalk_run --data \\
        virtual:bcsr:n=131072,m=8,k=4,bs=128,density=0.005,seed=0 \\
        --k-min 2 --k-max 6 --r 4 --use-fused-kernel

A virtual bcsr spec is generated as a ShardedBCSR (the identity layout of
its ``grid``), merged into one BCSR on the run's device (a view when
grid = 1); a virtual dense spec as the full (m, n, n) tensor.  The
``[io]`` line prints its logical bytes against the resident ones.

``--trace DIR`` records the run (spans, per-iteration metrics, the byte
ledger) and writes ``trace.jsonl``, ``trace_chrome.json``, ``metrics.npz``,
``summary.txt`` and ``memory.json`` to DIR, the artifact set
``scripts/check_trace.py`` validates; ``--sanitize`` checks the factors
after every MU step.

``--ckpt-dir`` checkpoints every unit and makes a rerun resume from them;
``--stop-after-units N`` stops after N computed units (a deterministic
kill: the run prints ``[sweep] sweep interrupted ...`` and exits 0).
``--max-retries``, ``--retry-base-delay`` and ``--unit-deadline`` set the
unit RetryPolicy; ``--fault-plan FILE`` installs a ``resilience.faults``
plan (``repro``'s JSON) before the tracer, so every ``fault/inject``
instant lands in the trace; ``--async-ckpt`` writes the checkpoints on a
thread.  ``scripts/torch_chaos_drill.py`` drives all of them.

    CK=$(mktemp -d)       # a fresh directory per sweep; delete it after
    ... rescalk_run --ckpt-dir $CK --stop-after-units 2   # "kill"
    ... rescalk_run --ckpt-dir $CK                        # resume
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.rescal import MU_SCHEDULES
from repro_torch.data.synthetic import synthetic_rescal
from repro_torch.io import (ShardedBCSR, VirtualSpec, coo_to_bcsr,
                            ingest_npz, ingest_tsv, manifest_of, operand_dims,
                            virtual_dense_full, virtual_sharded_bcsr)
from repro_torch.kernels.policy import IMPLS, KernelPolicy
from repro_torch.obs import costs as obs_costs
from repro_torch.obs import memory as obs_memory
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs
from repro_torch.resilience import RetryPolicy, faults
from repro_torch.selection import (CRITERIA, INITS, RescalkConfig,
                                   SweepInterrupted, SweepScheduler)
from repro_torch.selection.scheduler import SWEEP_MODES
from repro_torch.serve import FactorBundle


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--m", type=int, default=4)
    ap.add_argument("--k-true", type=int, default=5)
    ap.add_argument("--data", default=None,
                    help="a .tsv triple list (head, relation, tail, "
                         "optional weight), an .npz COO file (arrays "
                         "row/rel/col and optional val), or a virtual "
                         "dataset spec virtual:{dense|bcsr}:n=..,m=..,k=.."
                         "[,bs=,grid=,density=,skew=,noise=,seed=,"
                         "correlated=,dtype=] generated on the device; "
                         "default: the synthetic dense tensor of "
                         "--n/--m/--k-true")
    ap.add_argument("--bs", type=int, default=128,
                    help="BCSR block size")
    ap.add_argument("--k-min", type=int, default=2)
    ap.add_argument("--k-max", type=int, default=7)
    ap.add_argument("--r", type=int, default=4)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--schedule", default="batched",
                    choices=tuple(MU_SCHEDULES))
    ap.add_argument("--init", default="random", choices=INITS)
    ap.add_argument("--mode", default="batched", choices=SWEEP_MODES,
                    help="ensemble execution: one batched loop per rank, "
                         "the sequential per-member loop, or the cross-k "
                         "grid (the (k, q) grid padded to k_max)")
    ap.add_argument("--grid-chunk", type=int, default=None,
                    help="mode=grid: cells per chunk (default: the whole "
                         "grid in one chunk)")
    ap.add_argument("--criterion", default="threshold",
                    choices=sorted(CRITERIA),
                    help="k-selection rule (selection/criteria.py)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="per-unit checkpoint directory; a rerun with the "
                         "same directory resumes")
    ap.add_argument("--report", default=None,
                    help="write the SelectionReport JSON here")
    ap.add_argument("--bundle", default=None, metavar="DIR",
                    help="persist the selected-k factors as a FactorBundle "
                         "here; default: <report>.bundle next to --report. "
                         "The report's meta gains a 'bundle' pointer")
    ap.add_argument("--stop-after-units", type=int, default=None,
                    help="compute at most this many units, then exit "
                         "(deterministic kill for resume drills)")
    ap.add_argument("--max-retries", type=int, default=1,
                    help="per-unit transient-retry budget "
                         "(resilience.RetryPolicy max_attempts - 1; "
                         "deterministic errors always fail fast)")
    ap.add_argument("--retry-base-delay", type=float, default=0.05,
                    metavar="SEC",
                    help="first-retry backoff; doubles per attempt with "
                         "deterministic seeded jitter")
    ap.add_argument("--unit-deadline", type=float, default=None,
                    metavar="SEC",
                    help="per-attempt wall-clock budget for one unit; "
                         "overruns raise DeadlineExceeded (transient) and "
                         "retried attempts shrink to the straggler "
                         "baseline")
    ap.add_argument("--fault-plan", default=None, metavar="FILE",
                    help="JSON FaultPlan (resilience.faults) installed "
                         "for the run; every firing emits a fault/inject "
                         "trace event")
    ap.add_argument("--async-ckpt", action="store_true",
                    help="write unit checkpoints on a background thread "
                         "(failures surface at the next checkpoint "
                         "boundary)")
    ap.add_argument("--use-fused-kernel", action="store_true",
                    help="route the MU products and the A update "
                         "through the CUDA kernels (kernels/ops.py)")
    ap.add_argument("--fused-impl", default="auto", choices=IMPLS,
                    help="kernel impl for --use-fused-kernel (auto: the "
                         "CUDA kernel on the card, the plain version on "
                         "the CPU)")
    ap.add_argument("--sanitize", action="store_true",
                    help="runtime factor sanitizer after every MU step "
                         "(finite / non-negative / masked-zero checks; "
                         "analysis.sanitizer)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write trace artifacts to DIR (trace.jsonl, "
                         "trace_chrome.json, metrics.npz, summary.txt, "
                         "memory.json) and record per-iteration "
                         "convergence metrics (cfg.trace_metrics; obs)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def load_operand(args, dev):
    """The sweep's operand: (X, A_true | None, vocab | None).  Ground truth
    exists only for the synthetic tensor, the vocab only for TSV
    ingest."""
    if args.data is None:
        X, A_true, _ = synthetic_rescal(args.n, args.m, args.k_true, seed=0,
                                        device=dev)
        print(f"[io] synthetic X m={args.m} n={args.n} k_true={args.k_true}:"
              f" {X.numel() * X.element_size() / 2**20:.1f} MiB on {dev}")
        return X, A_true, None
    t0 = time.perf_counter()
    if args.data.startswith("virtual:"):
        return load_virtual(args.data, dev), None, None
    vocab = None
    if args.data.endswith(".tsv"):
        coo, vocab = ingest_tsv(args.data)
        print(f"[io] {args.data}: {vocab.n} entities, {vocab.m} relations, "
              f"{coo.nnz} triples")
    elif args.data.endswith(".npz"):
        coo = ingest_npz(args.data)
        print(f"[io] {args.data}: n={coo.n} m={coo.m} nnz={coo.nnz}")
    else:
        raise SystemExit(f"--data must be .tsv, .npz or virtual:..., got "
                         f"{args.data!r}")
    sp = coo_to_bcsr(coo, bs=args.bs, device=dev)
    del coo
    resident = sp.data.numel() * sp.data.element_size()
    print(f"[io] bcsr bs={args.bs} nnzb={sp.nnzb} resident "
          f"{resident / 2**20:.1f} MiB on {dev} "
          f"({time.perf_counter() - t0:.1f}s)")
    return sp, None, vocab


def load_virtual(data: str, dev):
    """A virtual spec's operand on ``dev``: the dense tensor, or the
    ShardedBCSR (merged into its one BCSR when grid = 1; the scheduler
    merges a larger grid's once)."""
    spec = VirtualSpec.parse(data)
    man = manifest_of(spec)
    print(f"[io] {man.kind} logical {man.logical_bytes / 2**30:.2f} GiB -> "
          f"resident {man.resident_bytes / 2**30:.3f} GiB "
          f"({man.compression:.0f}x)")
    t0 = time.perf_counter()
    if spec.kind == "dense":
        X = virtual_dense_full(spec, device=dev)
    else:
        X = virtual_sharded_bcsr(spec, device=dev)
        if spec.grid == 1:
            X = X.to_bcsr()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"[io] {spec.spec_string()}: generated on {dev} in "
          f"{time.perf_counter() - t0:.2f}s")
    return X


def feature_correlations(A_true, A_median) -> list[float]:
    """For each planted column, its best |correlation| with a column of
    the selected median factor."""
    A = A_true.cpu().numpy()
    return [max(abs(np.corrcoef(A[:, c], A_median[:, j])[0, 1])
                for j in range(A_median.shape[1]))
            for c in range(A.shape[1])]


def load(args):
    """Check the flags and load the operand on the run's device:
    (X, A_true | None, vocab | None)."""
    dev = _device.resolve(args.device)
    if args.grid_chunk is not None and args.mode != "grid":
        raise SystemExit("--grid-chunk requires --mode grid")
    return load_operand(args, dev)


def run(args):
    """Load, sweep and print; returns (RescalkResult, SelectionReport)."""
    return sweep(args, *load(args))


def _config(args) -> RescalkConfig:
    return RescalkConfig(k_min=args.k_min, k_max=args.k_max,
                         n_perturbations=args.r, rescal_iters=args.iters,
                         schedule=args.schedule, init=args.init,
                         kernel=KernelPolicy(use_fused=args.use_fused_kernel,
                                             impl=args.fused_impl),
                         sanitize=args.sanitize,
                         trace_metrics=args.trace is not None)


def sweep(args, X, A_true, vocab):
    """Sweep a loaded operand and print; returns (RescalkResult,
    SelectionReport), or (None, None) when ``--stop-after-units`` stopped
    the sweep."""
    m, n = operand_dims(X)
    print(f"operand m={m} n={n}, schedule={args.schedule}, "
          f"mode={args.mode}, criterion={args.criterion}")
    cfg = _config(args)
    retry = RetryPolicy(max_attempts=args.max_retries + 1,
                        base_delay=args.retry_base_delay,
                        deadline=args.unit_deadline)
    sched = SweepScheduler(cfg, mode=args.mode, grid_chunk=args.grid_chunk,
                           criterion=args.criterion, ckpt_dir=args.ckpt_dir,
                           retry=retry, async_ckpt=args.async_ckpt,
                           stop_after_units=args.stop_after_units,
                           report_path=args.report, verbose=True)
    try:
        res = sched.run(X)
    except SweepInterrupted as stop:
        print(f"[sweep] {stop}")
        return None, None
    print("\n" + res.summary())
    print(f"\nselected k_opt = {res.k_opt}"
          + (f" (planted {args.k_true})" if A_true is not None else ""))
    rep = sched.report
    print(f"[sweep] {len(rep.units)} units, {rep.n_reused} reused, "
          f"{rep.total_seconds:.2f}s compute, kernel launches "
          f"{rep.meta['kernel_launches']}")
    if A_true is not None and res.k_opt == args.k_true:
        corrs = feature_correlations(A_true, res.per_k[res.k_opt].A_median)
        print(f"feature correlation vs ground truth: "
              f"min={min(corrs):.3f} mean={np.mean(corrs):.3f}")
    _persist_bundle(args, X, res, vocab, rep)
    return res, rep


def _bundle_dir(args) -> str | None:
    if args.bundle is not None:
        return args.bundle
    if args.report is not None:
        return os.path.splitext(args.report)[0] + ".bundle"
    return None


def _persist_bundle(args, X, res, vocab, report) -> None:
    """Persist the selected-k factors (member-median A, regressed R) as a
    FactorBundle, with the vocab of a TSV ingest and the operand's
    manifest, and point the report's meta at it."""
    bundle_dir = _bundle_dir(args)
    if bundle_dir is None:
        return
    ents, rels = vocab.names() if vocab is not None else (None, None)
    bundle = FactorBundle.from_sweep(
        res, entities=ents, relations=rels,
        manifest=manifest_of(X).fingerprint(),
        meta={"criterion": args.criterion})
    bundle.save(bundle_dir)
    print(f"[bundle] {bundle_dir}: n={bundle.n} m={bundle.m} "
          f"k={bundle.k} digest={bundle.digest()[:12]}")
    if args.report:
        report.meta["bundle"] = bundle_dir
        report.save(args.report)


def _memory_ledger(tracer, report, operand, op, ks, args):
    """The sweep's byte ledger (obs.memory.MemoryLedger): manifest
    accounting, runtime watermarks, then per-rank peaks.  The allocator's
    peak is read before ``measure_mu_memory`` resets it; the fallback count
    is the tracer's ``kernel/fallback`` instants, the stream
    check_trace.py recounts."""
    man = manifest_of(operand)
    n_fb = sum(1 for e in tracer.events
               if e.get("ph") == "i" and e.get("name") == "kernel/fallback")
    sampler = tracer.memory_sampler
    peak_host = (sampler.peak_bytes if sampler is not None else
                 obs_memory.read_host_memory().get("hwm_bytes"))
    peak_device = obs_memory.device_watermark(op.device)
    cfg = _config(args)
    return obs_memory.MemoryLedger.from_manifest(
        man,
        peak_host_bytes=peak_host,
        peak_device_bytes=peak_device,
        per_k=obs_memory.measure_mu_memory(op, ks, policy=cfg.kernel,
                                           schedule=cfg.schedule),
        accounted_sweep_bytes=obs_memory.accounted_ensemble_bytes(
            man, n_members=args.r, k_max=args.k_max),
        kernel_fallbacks=n_fb,
        meta={"n_units": 0 if report is None else len(report.units),
              "n_samples": 0 if sampler is None else len(sampler.samples)})


def _write_trace_artifacts(trace_dir, tracer, buf, report, operand, args):
    """Flush the run's trace into its on-disk artifact set (the contract
    README "Observability" documents and scripts/check_trace.py
    validates).  The report was saved before this runs, so the ledger's
    measurement launches stay out of its ``kernel_launches``."""
    tracer.export_chrome(os.path.join(trace_dir, "trace_chrome.json"))
    buf.save_npz(os.path.join(trace_dir, "metrics.npz"))
    parts = [tracer.summarize(), "", buf.summarize()]
    artifacts = "trace.jsonl trace_chrome.json metrics.npz summary.txt"
    if operand is not None:
        # the per-rank measurements and the cost model run on the one
        # BCSR a sharded operand merges into, as repro's do
        op = operand.to_bcsr() if isinstance(operand, ShardedBCSR) \
            else operand
        ks = sorted({k for rec in (report.units if report else [])
                     for k in obs_costs.unit_ks(rec)})
        # first: the ledger reads the allocator's peak, the sweep's own
        ledger = _memory_ledger(tracer, report, operand, op, ks, args)
        if ks:
            # the run's own MU step under its kernel policy, counted on
            # the operand (one iteration per rank; on meta tensors the
            # ops would import torch._dynamo and sympy, seconds at every
            # traced run's exit)
            measured = obs_costs.measure_mu_costs(
                op, ks, policy=_config(args).kernel)
            rows = obs_costs.cost_table(report.units, op, iters=args.iters,
                                        measured=measured)
            parts += ["", obs_costs.format_cost_table(rows)]
        ledger.save(os.path.join(trace_dir, "memory.json"))
        parts += ["", ledger.summarize()]
        artifacts += " memory.json"
        print(f"[obs] memory: {ledger.summary_line()}")
    with open(os.path.join(trace_dir, "summary.txt"), "w") as f:
        f.write("\n".join(parts) + "\n")
    print(f"[obs] trace artifacts in {trace_dir}: {artifacts}")
    print(f"[obs] {len(tracer.events)} events, {len(buf)} metric records"
          + (f" ({buf.dropped} dropped)" if buf.dropped else ""))


def run_traced(args):
    """``run`` with the tracer, the metrics buffer and the host-memory
    sampler installed; the artifacts are written even when the run
    fails."""
    os.makedirs(args.trace, exist_ok=True)
    tracer = obs.Tracer(args.trace, meta={"argv": vars(args)})
    buf = obs_metrics.MetricsBuffer()
    prev_tracer = obs.install(tracer)
    prev_buf = obs_metrics.install_buffer(buf)
    # started after install, so its mem/sample instants land in this trace
    tracer.memory_sampler = obs_memory.HostMemorySampler().start()
    operand = report = None
    try:
        X, A_true, vocab = load(args)
        operand = X
        res, report = sweep(args, X, A_true, vocab)
    finally:
        tracer.memory_sampler.stop()
        try:
            _write_trace_artifacts(args.trace, tracer, buf, report,
                                   operand, args)
        finally:
            obs_metrics.install_buffer(prev_buf)
            obs.install(prev_tracer)
            tracer.close()
    return res, report


def main(argv=None):
    _device.strict_fp32()
    args = build_parser().parse_args(argv)
    go = run if args.trace is None else run_traced
    if args.fault_plan is None:
        return go(args)
    # installed before the tracer, so every fault/inject instant of the
    # run lands in the trace
    plan = faults.FaultPlan.load(args.fault_plan)
    print(f"[faults] {args.fault_plan}: {plan.summary()}")
    with faults.active(plan):
        return go(args)


if __name__ == "__main__":
    main()
