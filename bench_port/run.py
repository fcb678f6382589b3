"""The benchmark of the PyTorch and CUDA port (``path_tracing__ray_tracer_tpu_torch``).

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run is one process, on one card, from the root of a checkout:

1. builds the cell's scene from its configuration (``configs/<config>.json``)
   and the renderer it names;
2. set-up: compiles the scene, sends the traffic mix's warm-up requests of
   the window's own shape (kernel builds, graph captures), all timed into
   ``setup_s`` from the process's start;
3. the window: a closed loop of one client (``traffic.py``,
   ``traffic/<mix>.json``) for ``--seconds``; the request in flight at the
   deadline finishes and counts.  With ``--trace 1`` the profiler records
   the span the mix names (``tracing.py``);
4. reads the device's memory peak, frees the program's state, and checks
   what the window answered against the plain reference (``check.py``,
   ``reference/``), each number against its limit in ``cells/<cell>.json``;
5. prints the numbers compared, each beside its limit, as the last lines of
   standard error, and one JSON line as the last line of standard output:
   ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
   metrics, or with ``--trace 1`` its per-layer ones, each read by
   ``metrics/<name>.py``), ``device`` and, last, ``check``.

It exits non-zero and prints no result when no card is seen (or fewer than
the cell asks for), when a run's process holds a module of JAX or of the JAX
package after the window, or when the checkout lacks the program.

Adding a piece is adding files and entries (no file here changes):

* a configuration: ``configs/<name>.json`` (source, assumed, reduced, renderer
  and its arguments, frame, bounce wrapper, check budget, scene as data);
* a traffic mix: ``traffic/<name>.json`` (parameters of ``traffic.Loop``);
* a per-layer metric: ``metrics/<name>.py`` with ``read(run)`` returning a
  number or None, and its entry in ``BENCHMARK.json``;
* a cell: its entry in ``BENCHMARK.json`` and ``cells/<name>.json`` with the
  limits of its check.

A run writes nothing but the program's own kernel build cache inside the
checkout (``path_tracing__ray_tracer_tpu_torch/_build/``) and Python's
bytecode caches.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()  # the process's start, as set-up counts it

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):  # run as a script: the checkout's root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench_port import check, program, scenes, spec, tracing, traffic  # noqa: E402

FOREIGN = ("jax", "jaxlib", "flax", "path_tracing__ray_tracer_tpu")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def foreign_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FOREIGN})


def _sync(device) -> None:
    if str(device).startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def execute(cell: spec.Cell, seed: int, seconds: float, trace: bool, device="cuda",
            t_start: float = None) -> dict:
    """One run of ``cell`` on ``device``: the result line as a dict."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cfg, mix = cell.config, cell.traffic
    sd = scenes.describe(cfg["scene"])
    shape = traffic.shape(cfg, mix)
    system = program.make(sd, cfg["renderer"], shape.width, shape.height, shape.spp, shape.depth,
                          seed=seed & traffic.SEED_MASK, device=device,
                          **mix.get("renderer_args", {}))
    t = time.perf_counter()
    system.renderer.compiled(system.scene)
    _sync(device)
    compile_s = time.perf_counter() - t
    cap0 = program.captures()
    loop = traffic.Loop(system, cfg, mix, seed, check.probe_pixels(cfg, shape))
    warm = loop.warm_up()
    _sync(device)
    cap1 = program.captures()
    setup_s = time.perf_counter() - t_start

    spans = None
    if trace:
        wrapper = cfg["bounce_wrapper"]
        prof = tracing.Profiler(lambda: program.launch_counts()[wrapper])
        prof.warm()  # the profiler's own start-up stays out of the window
        spans = tracing.Spans(system.renderer, mix.get("trace", {"requests": [1, 1]}), prof)
    requests = loop.window(seconds, spans)
    _sync(device)
    cap2 = program.captures()
    on_card = str(device).startswith("cuda")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    run = types.SimpleNamespace(
        requests=requests, window_start=loop.start, shape=shape, setup_s=setup_s,
        compile_s=compile_s, capture_s=cap1["seconds"] - cap0["seconds"],
        captures_in_window=cap2["count"] - cap1["count"], span=spans.result() if spans else None)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = spec.reader(m["name"])(run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # the program's state goes before the reference runs on the card
    del system, loop.system
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers, details = check.compare(cfg, shape, requests, seed, check.Reference(cfg, sd, shape,
                                                                                 device))
    numbers["failed_requests"] += check.failed(warm)
    details["check_s"] = time.perf_counter() - t
    correct = (details["requests_checked"] > 0 and set(numbers) == set(cell.limits)
               and all(numbers[k] <= cell.limits[k] for k in numbers))
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(requests),
           "failed": int(numbers["failed_requests"]), "metrics": metrics, "device": dev}
    if run.span is not None:
        s = tracing.summary(run.span)
        dev.update(busy_s=s["busy_s"], window_s=s["window_s"])
        out["breakdown"] = s["breakdown"]
    out["details"] = dict(details, captures_in_window=run.captures_in_window,
                          setup_s=setup_s, compile_s=compile_s)
    out["seconds"] = [r.seconds for r in requests]
    out["errors"] = [r.error for r in warm + requests if r.error][:3]
    out["check"] = {k: {"value": v, "limit": cell.limits.get(k)} for k, v in numbers.items()}
    return out


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench_port: the cell needs {cell.chips} card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = foreign_modules()
    if found:
        print(f"bench_port: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    print(f"bench_port: {card_line()}; {json.dumps(result['details'])}", file=sys.stderr)
    print("bench_port: request seconds " + " ".join(f"{s:.4f}" for s in result.pop("seconds")),
          file=sys.stderr)
    for e in result.pop("errors"):
        print(f"bench_port: a request failed: {e}", file=sys.stderr)
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
