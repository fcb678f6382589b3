"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix and lists the metrics; everything else is a
file of its own, found by name:

* ``configs/<config>.json``: the configuration (scene, renderer, frame);
* ``traffic/<traffic>.json``: the traffic mix (the loop's parameters);
* ``cells/<cell>.json``: the limits of the numbers that decide ``correct``;
* ``metrics/<metric>.py``: a reader of one metric (its ``read(run)``).
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]  # the check's numbers and their limits
    end_to_end: List[dict]  # BENCHMARK.json's end-to-end metrics this cell reports
    per_layer: List[dict]  # and its per-layer metrics


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    # a per-layer metric without workloads goes with every cell that
    # reports the end-to-end metric it moves; an end-to-end one with all
    return "moves" not in metric or metric["moves"] in e2e_names


def cell(name: str, bench: dict = None, here: Path = HERE) -> Cell:
    """The cell ``name`` of ``bench`` (default: the checkout's
    ``BENCHMARK.json``) with its files; raises KeyError for an unknown one."""
    bench = benchmark() if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, ())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, int(w["chips"]), load_json(here / "configs" / f"{w['config']}.json"),
                load_json(here / "traffic" / f"{w['traffic']}.json"),
                load_json(here / "cells" / f"{name}.json")["limits"], e2e, per_layer)


def reader(metric: str, here: Path = HERE) -> Callable:
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = here / "metrics" / f"{metric}.py"
    mod_name = "bench_port_metric_" + metric.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader for metric {metric!r} ({path})")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
