"""Everything a cell needs, found by name: the cell in ``BENCHMARK.json``,
its configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), the driver that mix names
(``drivers/<driver>.py``), its limits (``limits/<cell>.json``) and each
metric's reader (``metrics/<metric>.py``, end-to-end and per-layer
alike).  Adding a cell, a configuration, a mix, a driver or a metric
adds files and entries; nothing here changes."""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]       # portbench/
ROOT = HERE.parent                               # the checkout
BENCHMARK = ROOT / "BENCHMARK.json"


def load_benchmark(path: Path = BENCHMARK) -> dict:
    with open(path) as f:
        return json.load(f)


def _file(kind: str, name: str, suffix: str) -> Path:
    path = HERE / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r} ({path})")
    return path


def _json(kind: str, name: str) -> dict:
    with open(_file(kind, name, ".json")) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[c['name'] for c in bench['workloads']]}")


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def limits(cell: str) -> dict:
    return _json("limits", cell)["limits"]


def driver(name: str):
    """The ``Driver`` class of ``drivers/<name>.py``."""
    _file("drivers", name, ".py")
    return importlib.import_module(f"portbench.drivers.{name}").Driver


def end_to_end(bench: dict, cell: str) -> list[dict]:
    """The end-to-end metrics this cell reports: those listing it, and
    those without a list."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def per_layer(bench: dict, cell: str) -> list[dict]:
    """The per-layer metrics that list this cell."""
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


def reader(name: str):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = _file("metrics", name, ".py")
    mod_name = "portbench_metric_" + name.replace(".", "_").replace(
        "-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
