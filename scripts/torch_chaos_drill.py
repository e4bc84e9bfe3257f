#!/usr/bin/env python
"""Chaos drill of the port's CLI: a faulted sweep must agree with its
fault-free twin.

Every phase shells out to ``python -m repro_torch.launch.rescalk_run`` (on
``--device``, with ``--use-fused-kernel``, so the kernel dispatch seam is
on the path), the process boundary a production kill crosses:

  baseline   fault-free run -> report R0; its trace passes
             scripts/check_trace.py --report
  repeat     a second fault-free run: its report equals R0 (determinism
             end to end)
  transient  one TransientError on the second unit's first attempt: the
             unit retries (attempts == 2, a ``sched/retry`` event) and the
             report equals R0
  torn write ``ckpt/write`` truncates the first unit's checkpoint in a run
             stopped after 1 unit; the resume quarantines the step
             (``ckpt/quarantine``), recomputes the unit and equals R0
  fail fast  a DeterministicFault on the first attempt: nonzero exit
             after ONE attempt, no ``sched/retry``, a ``sched/fail_fast``
             event and no selected k
  overflow   ``kernel/dispatch`` forces one ``budget-overflow`` on the
             first kernel call (a ``kernel/fallback`` event,
             ``n_kernel_fallbacks == 1``) and the report equals R0.  On
             the card the call is refused with a TransientError and its
             unit retries on the kernel (``chosen="retry"``, attempts ==
             2, a ``sched/retry`` event); on the CPU, where the kernel
             path is the plain one, the call runs it (``chosen="ref"``)
  kill       ``--async-ckpt`` run killed with SIGKILL once the first
             unit's LATEST exists (a ``delay`` fault holds the second
             unit open); the resume reuses every unit that had a LATEST,
             recomputes the rest, and equals R0

Reports are compared after dropping the execution telemetry (timings,
watermarks, retry counters, meta), as scripts/chaos_drill.py does: the
ks, the curves, k_opt and the unit identities must be equal.

    PYTHONPATH=src python scripts/torch_chaos_drill.py --device cpu
    python scripts/torch_chaos_drill.py --device cuda -- \\
        --data virtual:bcsr:n=131072,m=8,k=4,bs=128,density=0.005,seed=0 \\
        --k-min 2 --k-max 5 --r 4 --iters 60

Exit codes: 0 all phases green, 1 a drill check failed, 2 the drill could
not run.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")

# the sweep of scripts/chaos_drill.py, by default
SWEEP = ["--data", "virtual:bcsr:n=512,m=2,k=3,bs=128,density=0.02",
         "--k-min", "2", "--k-max", "3", "--r", "2", "--iters", "10"]
RETRY = ["--use-fused-kernel", "--max-retries", "2",
         "--retry-base-delay", "0.01"]

# per-unit execution telemetry: differs between a faulted run and its
# fault-free twin; everything else must be equal
VOLATILE_UNIT_FIELDS = frozenset({
    "seconds", "reused", "retries", "attempts", "backoff_seconds",
    "straggler", "baseline_seconds", "peak_host_bytes",
    "peak_device_bytes", "kernel_fallbacks", "fail_fast"})


class DrillFailure(AssertionError):
    """A drill check failed: exit 1."""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise DrillFailure(what)


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    return env


def _cli(args: list[str]) -> list[str]:
    return [sys.executable, "-m", "repro_torch.launch.rescalk_run", *args]


def _log(log: str, cmd: list[str], out: str, err: str, rc) -> None:
    with open(log, "w") as f:
        f.write(f"$ {' '.join(cmd)}\n-- stdout --\n{out}\n-- stderr --\n"
                f"{err}\n-- exit {rc}\n")


def run_cli(args: list[str], *, log: str, expect_fail: bool = False
            ) -> subprocess.CompletedProcess:
    cmd = _cli(args)
    proc = subprocess.run(cmd, capture_output=True, text=True, env=_env(),
                          cwd=REPO)
    _log(log, cmd, proc.stdout, proc.stderr, proc.returncode)
    if expect_fail:
        check(proc.returncode != 0,
              f"expected a nonzero exit, got {proc.returncode} (see {log})")
    elif proc.returncode != 0:
        sys.stderr.write(proc.stdout[-2000:] + proc.stderr[-4000:])
        raise DrillFailure(f"rescalk_run exited {proc.returncode} "
                           f"(see {log})")
    return proc


def run_cli_killed(args: list[str], marker: str, *, log: str,
                   timeout: float = 600.0) -> float:
    """Start the CLI, SIGKILL it as soon as ``marker`` exists; returns the
    seconds until the marker appeared."""
    cmd = _cli(args)
    with open(log + ".out", "w") as out, open(log + ".err", "w") as err:
        proc = subprocess.Popen(cmd, stdout=out, stderr=err, env=_env(),
                                cwd=REPO)
        t0 = time.perf_counter()
        try:
            while not os.path.exists(marker):
                check(proc.poll() is None,
                      f"the run ended ({proc.returncode}) before {marker} "
                      f"existed (see {log}.err)")
                check(time.perf_counter() - t0 < timeout,
                      f"no {marker} after {timeout:.0f}s")
                time.sleep(0.01)
            seen = time.perf_counter() - t0
            proc.send_signal(signal.SIGKILL)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    with open(log + ".out") as o, open(log + ".err") as e:
        _log(log, cmd, o.read(), e.read(), proc.returncode)
    check(proc.returncode == -signal.SIGKILL,
          f"the run was not killed (exit {proc.returncode}, see {log})")
    return seen


def check_trace_cli(trace_dir: str, report: str) -> None:
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "check_trace.py"),
         trace_dir, "--report", report],
        capture_output=True, text=True, cwd=REPO)
    check(proc.returncode == 0,
          f"check_trace.py failed on {trace_dir}:\n{proc.stdout}"
          f"{proc.stderr}")


def events(trace_dir: str) -> list[dict]:
    with open(os.path.join(trace_dir, "trace.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def instants(evs: list[dict], name: str) -> list[dict]:
    return [e.get("args") or {} for e in evs
            if e.get("ph") == "i" and e.get("name") == name]


def load(report_path: str) -> dict:
    with open(report_path) as f:
        return json.load(f)


def normalize(report_path: str) -> dict:
    d = load(report_path)
    for key in ("total_seconds", "n_reused", "meta"):
        d.pop(key, None)
    d["units"] = sorted(
        ({k: v for k, v in u.items() if k not in VOLATILE_UNIT_FIELDS}
         for u in d.get("units", [])),
        key=lambda u: u["uid"])
    return d


def check_parity(report_path: str, baseline: dict, phase: str) -> None:
    got = normalize(report_path)
    if got == baseline:
        return
    diff = [k for k in sorted(set(got) | set(baseline))
            if got.get(k) != baseline.get(k)]
    raise DrillFailure(f"{phase}: report diverged from the fault-free "
                       f"baseline in {diff}: got k_opt={got.get('k_opt')} "
                       f"s_min={got.get('s_min')}, want "
                       f"k_opt={baseline.get('k_opt')} "
                       f"s_min={baseline.get('s_min')}")


def write_plan(path: str, specs: dict[str, list[dict]]) -> str:
    with open(path, "w") as f:
        json.dump({"specs": specs}, f, indent=1)
    return path


def unit_uids(report_path: str) -> list[str]:
    return [u["uid"] for u in load(report_path)["units"]]


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--workdir", default=None,
                    help="keep artifacts here instead of a temp dir")
    ap.add_argument("sweep", nargs=argparse.REMAINDER,
                    help="after --: the sweep's arguments (default: "
                         "scripts/chaos_drill.py's sweep)")
    args = ap.parse_args(argv)
    sweep = [a for a in args.sweep if a != "--"] or SWEEP
    sweep = [*sweep, *RETRY, "--device", args.device]

    work = args.workdir or tempfile.mkdtemp(prefix="torch-chaos-drill-")
    os.makedirs(work, exist_ok=True)
    try:
        summary = _drill(work, sweep, args.device)
    except DrillFailure as ex:
        print(f"[chaos-drill] FAIL: {ex}")
        print(f"[chaos-drill] artifacts kept in {work}")
        return 1
    except Exception as ex:     # infrastructure, not a graded regression
        print(f"[chaos-drill] ERROR: {type(ex).__name__}: {ex}")
        print(f"[chaos-drill] artifacts kept in {work}")
        return 2
    if args.workdir is None:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[chaos-drill] summary {json.dumps(summary)}")
    print("[chaos-drill] OK: faulted sweeps match the fault-free "
          "baseline; every fault had its recovery event")
    return 0


def _drill(work: str, sweep: list[str], device: str) -> dict:
    j = lambda *p: os.path.join(work, *p)  # noqa: E731
    summary: dict = {"device": device}

    def timed_run(name, *a, **kw):
        t0 = time.perf_counter()
        proc = run_cli(*a, **kw)
        summary[f"{name}_s"] = round(time.perf_counter() - t0, 3)
        return proc

    print("[chaos-drill] phase 0: fault-free baseline")
    timed_run("baseline", [*sweep, "--trace", j("t0"),
                           "--report", j("r0.json")], log=j("phase0.log"))
    check_trace_cli(j("t0"), j("r0.json"))
    baseline = normalize(j("r0.json"))
    r0 = load(j("r0.json"))
    check(len(baseline["units"]) >= 2,
          f"baseline sweep too small to drill: {baseline['units']}")
    check(not instants(events(j("t0")), "fault/inject"),
          "fault-free baseline emitted fault/inject events")
    check(r0["meta"]["n_kernel_fallbacks"] == 0,
          f"fault-free baseline fell back: {r0['meta']}")
    summary["k_opt"] = r0["k_opt"]

    print("[chaos-drill] phase 1: a second fault-free run")
    timed_run("repeat", [*sweep, "--report", j("r1.json")],
              log=j("phase1.log"))
    check_parity(j("r1.json"), baseline, "repeat")
    check(load(j("r1.json"))["meta"]["n_kernel_fallbacks"] == 0,
          "a fault-free run fell back")

    print("[chaos-drill] phase 2: transient unit failure")
    plan = write_plan(j("plan2.json"), {
        # hit 1 = the second unit's first attempt
        "sched/unit": [{"kind": "raise-transient", "at": [1]}]})
    timed_run("transient", [*sweep, "--fault-plan", plan, "--trace",
                            j("t2"), "--report", j("r2.json")],
              log=j("phase2.log"))
    check_trace_cli(j("t2"), j("r2.json"))
    check_parity(j("r2.json"), baseline, "transient")
    ev = events(j("t2"))
    faulted = [e for e in instants(ev, "fault/inject")
               if e.get("seam") == "sched/unit"]
    check(len(faulted) == 1, f"expected 1 injected unit fault, got "
                             f"{faulted}")
    uid = faulted[0].get("uid")
    check(uid in {e.get("uid") for e in instants(ev, "sched/retry")},
          f"no sched/retry event for the faulted unit {uid!r}")
    by_uid = {u["uid"]: u for u in load(j("r2.json"))["units"]}
    check(by_uid[uid]["attempts"] == 2 and by_uid[uid]["retries"] == 1,
          f"the faulted unit should record attempts=2, retries=1: "
          f"{by_uid[uid]}")
    check(all(u["attempts"] == 1 for v, u in by_uid.items() if v != uid),
          f"unfaulted units must record attempts=1: {list(by_uid.values())}")

    print("[chaos-drill] phase 3: torn checkpoint + self-healing resume")
    plan = write_plan(j("plan3.json"), {
        "ckpt/write": [{"kind": "truncate-file", "at": [0],
                        "fraction": 0.5}]})
    proc = timed_run("torn", [*sweep, "--fault-plan", plan, "--ckpt-dir",
                              j("ck3"), "--stop-after-units", "1",
                              "--trace", j("t3a")], log=j("phase3a.log"))
    check("interrupted after 1 computed units" in proc.stdout,
          "the killed run did not stop after 1 unit")
    torn = [e for e in instants(events(j("t3a")), "fault/inject")
            if e.get("seam") == "ckpt/write"]
    check(len(torn) == 1 and torn[0].get("kind") == "truncate-file",
          f"expected one truncate-file injection, got {torn}")
    timed_run("torn_resume", [*sweep, "--ckpt-dir", j("ck3"), "--trace",
                              j("t3b"), "--report", j("r3.json")],
              log=j("phase3b.log"))
    check_trace_cli(j("t3b"), j("r3.json"))
    check_parity(j("r3.json"), baseline, "torn write")
    check(bool(instants(events(j("t3b")), "ckpt/quarantine")),
          "the resume never quarantined the torn step")
    check(load(j("r3.json"))["n_reused"] == 0,
          "the torn checkpoint must not be reused")

    print("[chaos-drill] phase 4: deterministic fault fails fast")
    plan = write_plan(j("plan4.json"), {
        "sched/unit": [{"kind": "raise-deterministic", "at": [0],
                        "message": "chaos drill"}]})
    proc = run_cli([*sweep, "--fault-plan", plan, "--trace", j("t4")],
                   log=j("phase4.log"), expect_fail=True)
    check("DeterministicFault" in proc.stderr,
          f"expected DeterministicFault to surface, stderr:\n"
          f"{proc.stderr[-800:]}")
    check("selected k_opt" not in proc.stdout,
          "a deterministically failing sweep still selected a k")
    ev = events(j("t4"))
    check(len([e for e in instants(ev, "fault/inject")
               if e.get("seam") == "sched/unit"]) == 1,
          "the deterministic fault must see exactly 1 attempt")
    check(not instants(ev, "sched/retry"),
          "a deterministic error burned retry budget (sched/retry seen)")
    check(bool(instants(ev, "sched/fail_fast")),
          "no sched/fail_fast event for the deterministic error")

    print("[chaos-drill] phase 5: forced budget-overflow at dispatch")
    plan = write_plan(j("plan5.json"), {
        # hit 0 = the first kernel call of the run
        "kernel/dispatch": [{"kind": "budget-overflow", "at": [0]}]})
    timed_run("overflow", [*sweep, "--fault-plan", plan, "--trace",
                           j("t5"), "--report", j("r5.json")],
              log=j("phase5.log"))
    check_trace_cli(j("t5"), j("r5.json"))
    check_parity(j("r5.json"), baseline, "overflow")
    ev = events(j("t5"))
    refused = instants(ev, "kernel/fallback")
    chosen = "retry" if device == "cuda" else "ref"
    check(len(refused) == 1 and refused[0].get("chosen") == chosen,
          f"expected 1 kernel/fallback event with chosen={chosen!r}, got "
          f"{refused}")
    r5 = load(j("r5.json"))
    check(r5["meta"]["n_kernel_fallbacks"] == 1,
          "the report does not count the forced budget-overflow")
    (hit,) = [u for u in r5["units"] if u["kernel_fallbacks"]]
    attempts = 2 if device == "cuda" else 1
    check(hit["attempts"] == attempts
          and r5["meta"]["n_retries"] == attempts - 1,
          f"the overflowed unit should record attempts={attempts} and the "
          f"sweep {attempts - 1} retries: {hit}, {r5['meta']}")
    check(len(instants(ev, "sched/retry")) == attempts - 1,
          f"expected {attempts - 1} sched/retry event(s)")
    summary["overflow_attempts"] = hit["attempts"]
    summary["overflow_unit_s"] = [
        round(u["seconds"], 3) for u in r0["units"]
        if u["uid"] == hit["uid"]] + [round(hit["seconds"], 3)]

    print("[chaos-drill] phase 6: SIGKILL during an async checkpointed "
          "run, then resume")
    uids = unit_uids(j("r0.json"))
    plan = write_plan(j("plan6.json"), {
        # hold the second unit open until the kill
        "sched/unit": [{"kind": "delay", "at": [1], "seconds": 600.0}]})
    summary["kill_after_s"] = round(run_cli_killed(
        [*sweep, "--fault-plan", plan, "--ckpt-dir", j("ck6"),
         "--async-ckpt", "--trace", j("t6a")], j("ck6", uids[0], "LATEST"),
        log=j("phase6a.log")), 3)
    saved = [u for u in uids
             if os.path.exists(j("ck6", u, "LATEST"))]
    timed_run("kill_resume", [*sweep, "--ckpt-dir", j("ck6"),
                              "--async-ckpt", "--trace", j("t6"),
                              "--report", j("r6.json")],
              log=j("phase6b.log"))
    check_trace_cli(j("t6"), j("r6.json"))
    check_parity(j("r6.json"), baseline, "kill")
    reused = [u["uid"] for u in load(j("r6.json"))["units"] if u["reused"]]
    check(reused == saved and saved,
          f"the resume must reuse exactly the checkpointed units {saved}, "
          f"reused {reused}")
    summary["kill_reused"] = len(reused)
    summary["kill_units"] = len(uids)
    return summary


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
