"""Tiny versions of the benchmark's cells, for CPU tests: the same scene,
renderer and traffic, a frame small enough that the port's plain torch
versions and the reference render it in seconds."""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port import spec  # noqa: E402

SEED = 2**31 + 12345  # past 32 signed bits, as the driver's seeds may be


def tiny(name: str, width: int = 24, height: int = 16, depth: int = 6) -> spec.Cell:
    """The cell ``name`` at ``width × height``; a request of 4 samples."""
    c = spec.cell(name)
    cfg = json.loads(json.dumps(c.config))
    cfg["frame"].update(width=width, height=height, depth=depth)
    cfg["renderer"]["args"]["sample_group"] = 4
    cfg["check"] = {"paths_per_request": 512, "paths_per_run": 2048}
    mix = dict(c.traffic, warmup=1)
    if mix["entry"] == "render_sums":
        mix["group_samples"] = 4
        cfg["frame"]["spp"] = 8
    return c._replace(config=cfg, traffic=mix)
