"""Run one cell of the port's benchmark once, on this machine's card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell's configuration and traffic by name (``BENCHMARK.json``),
builds its inputs from the seed on the card, warms up, measures for
``--seconds`` (with ``--trace 1`` under the profiler, for the per-layer
metrics), holds what the window produced to the plain reference, and
prints one JSON line: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (and ``breakdown`` when traced), then ``checks``,
each compared number beside its limit.  The same numbers end standard
error.  Without a card, with fewer cards than the cell asks for, or
with ``jax``, ``jaxlib``, ``flax``, ``repro`` or ``chip_smoke`` loaded
once the window has closed, it prints no result and exits 1.
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


def fail(msg: str) -> int:
    print(f"[portbench] {msg}", file=sys.stderr)
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import cell, spec
    bench = spec.load_benchmark()
    chips = spec.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        return fail(f"{args.workload} needs {chips} cards, this machine "
                    f"has {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)
    out = cell.run_cell(bench, args.workload, args.seed, args.seconds,
                        bool(args.trace), dev, T_START)
    found = cell.forbidden_modules()
    if found:
        return fail(f"the run loaded {found}: the benchmark measures the "
                    f"PyTorch port alone")
    info = out.pop("device")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": chips, "memory_peak_bytes": int(info["peak"])}
    if args.trace:
        device.update(busy_s=info["busy_s"], window_s=info["window_s"])
    checks = out.pop("checks")
    line = {**out, "device": device, "checks": checks}
    for name, c in checks.items():
        print(f"[portbench] check {name} {c['value']!r} limit "
              f"{c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
