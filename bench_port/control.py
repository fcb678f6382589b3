"""The check's control: the plain reference put in the program's place and
computed one precision below the configuration's float32, in bfloat16.

    python3 bench_port/control.py --workload <cell> --seeds <n> [<n> ...] [--requests <k>]

For each seed it makes the requests a run of that seed would check (the
same seeds, sample ranges and pixels; ``--requests`` of them answered, as
many as a run's window holds), lets the bfloat16 reference answer them and
judges those answers by the run's own comparison against the float32
reference.  It prints each seed's numbers, one JSON line each.  A sound
check reads them far above its limits.  The benchmark's runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench_port import check, scenes, spec, traffic  # noqa: E402


def requests_of(cfg: dict, mix: dict, seed: int, n: int):
    """The window's first ``n`` requests of a run with ``seed``, marked
    answered, with the pixels a run would keep of each displayed image."""
    import numpy as np

    class Stub:  # stands in for the program: it answers nothing itself
        renderer = None

    loop = traffic.Loop(Stub(), cfg, mix, seed, check.probe_pixels(cfg, traffic.shape(cfg, mix)))
    s = loop.shape
    loop.sent = int(mix.get("warmup", 1)) if s.entry == "render" else 0
    out = []
    for i in range(n):
        req = loop._next(loop.sent if s.entry == "render" else i)
        req.ok = True
        if s.entry == "render":
            loop.sent += 1  # render() reseeds: seed + renders before
            g = np.random.default_rng([seed & traffic.SEED_MASK, req.index, 1])
            flat = g.choice(s.width * s.height, size=min(loop.probe_pixels, s.width * s.height),
                            replace=False)
            req.probe = (flat // s.width, flat % s.width, None)
        out.append(req)
    return out


def control_numbers(cell: spec.Cell, seed: int, n: int, device, dtype=None):
    """The check's numbers when the bfloat16 reference answers ``n``
    requests of a run with ``seed``."""
    import torch

    cfg, mix = cell.config, cell.traffic
    sd = scenes.describe(cfg["scene"])
    shape = traffic.shape(cfg, mix)
    ref = check.Reference(cfg, sd, shape, device)
    low = check.Reference(cfg, sd, shape, device, torch.bfloat16 if dtype is None else dtype)
    reqs = requests_of(cfg, mix, seed, n)

    def values(shape, req, pixels):
        if shape.entry == "render_sums":
            return low.sums(pixels, req.seed, req.sample0, req.samples)
        rows, cols, _ = req.probe
        return low.image(rows, cols, req.seed)

    return check.compare(cfg, shape, reqs, seed, ref, values)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    for seed in args.seeds:
        numbers, details = control_numbers(cell, seed, args.requests, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed, "numbers": numbers,
                          "limits": cell.limits, "details": details}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
