"""Run one cell of the port's benchmark traced, as ``run.py --trace 1``
does, and read the device time of each of the program's own spans:

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s>

Prints one JSON line: the traced result line's ``correct``,
``attempted``, ``metrics`` and ``device``, then ``spans``: each program
span's count of host ranges, its device milliseconds in total and self
(``harness/spans.py``) and the operations that take most of its self
time, per unit of work (``attempted``: MU iterations or sweeps); then
``unclaimed_ms`` and ``unlinked_ms`` per unit (device time under no
program span, and without a launch in the profile), ``busy_ms`` per
unit, and ``idle_gaps`` named by the program's innermost span beside the
harness's names.  Without a card it exits 1.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for path in (ROOT, ROOT / "src"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import cell, profile, spans, spec
    if not torch.cuda.is_available():
        print("[portbench] no CUDA device: spans are read on the card only",
              file=sys.stderr)
        return 1
    kept = {}
    read = profile.read

    def keep(events, spans=()):
        kept["events"] = events
        return read(events, spans)

    profile.read = keep
    try:
        out = cell.run_cell(spec.load_benchmark(), args.workload, args.seed,
                            args.seconds, True, torch.device("cuda", 0),
                            T_START)
    finally:
        profile.read = read
    at = spans.read(kept.pop("events"))
    units = max(out["attempted"], 1)
    info = out["device"]
    per = 1e3 / units
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "metrics": out["metrics"],
            "device": {"window_s": info["window_s"],
                       "busy_s": info["busy_s"]},
            "busy_ms": info["busy_s"] * per,
            "unclaimed_ms": at.unclaimed_s() * per,
            "unlinked_ms": at.unlinked_s * per,
            "spans": {name: {"count": at.count(name),
                             "total_ms": at.span_device_s(name) * per,
                             "self_ms": at.span_device_s(
                                 name, self_only=True) * per,
                             "self_ops_ms": [[op, t * per] for op, t in
                                             at.by_name(name)]}
                      for name in at.names()},
            "idle_gaps": {"program": at.idle_gaps(),
                          "harness": out["breakdown"]["idle_gaps"]}}
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
