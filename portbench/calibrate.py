"""Readings that a cell's limits are set from, in one process on the card:
the program's compared numbers over many seeds (the lower readings) and
the control's, the plain reference computed with TF32 allowed in the
program's place (the upper readings), each run at the cell's own sizes
with a short window.  The benchmark's own runs never run the control.

    python3 portbench/calibrate.py --workload dense3tb.mu \
        --seeds 101-112 --control-seeds 201-203 --seconds 1

Prints one JSON line per run and a last line with, per number, the
largest program reading and the smallest control reading.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for path in (ROOT, ROOT / "src"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))


def seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        if "-" in part:
            lo, hi = part.split("-")
            out.extend(range(int(lo), int(hi) + 1))
        elif part:
            out.append(int(part))
    return out


def readings(bench, workload, seed, seconds, device, control) -> dict:
    from portbench.harness import cell
    out = cell.run_cell(bench, workload, seed, seconds, False, device,
                        time.perf_counter(), control=control)
    return {name: c["value"] for name, c in out["checks"].items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from portbench.harness import spec
    bench = spec.load_benchmark()
    lower: dict[str, float] = {}
    upper: dict[str, float] = {}
    for control, group in ((False, args.seeds), (True, args.control_seeds)):
        for seed in group:
            got = readings(bench, args.workload, seed, args.seconds,
                           torch.device(args.device), control)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "control": control, "readings": got}),
                  flush=True)
            into, pick = (upper, min) if control else (lower, max)
            for name, value in got.items():
                into[name] = pick(into.get(name, value), value)
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper, "seeds": args.seeds,
                      "control_seeds": args.control_seeds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
