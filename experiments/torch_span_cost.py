#!/usr/bin/env python3
"""The host cost of the port's spans and counters (``utils/profiling``) with
no profiler recording, on one NVIDIA GPU's host:

1. an empty span, a span nested in another (as ``block.compact`` sits in
   ``block.host``) and a counter, each timed over a loop inside a function
   (the least of 7 repeats, ns a call);
2. a fixed chunk of the path tracer's main path (the textured Cornell box,
   1024², depth 8, the first 128-sample group of chunk 0: 131,072 lanes, its
   graphs captured beforehand), timed by the host clock between two
   synchronisations with the spans live and with ``span`` and ``count``
   replaced by a no-op, in turns (live, stub, stub, live, ...); the
   difference of the medians over the spans and counts one chunk makes
   (the mean µs of each span in one chunk beside them);
   and the median self time of the live calls (the host clock less the
   ``drive`` span: the chunk's eager set-up and ``rebin``), its plan made.

    python3 experiments/torch_span_cost.py [--device cpu --size 64 --samples 4]
    python3 experiments/torch_span_cost.py --after-profiler

``--after-profiler`` first records one tiny ``torch.profiler`` session (host
and card, as ``bench_port/tracing.Profiler.warm`` does), so that the chunk
runs in a process where a profiler has run, as a traced benchmark run's
window does.

Prints one JSON line, with the card's name and power limit.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
import timeit
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


class _Nothing:
    """A span that does nothing."""

    def __init__(self, name):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def loop_ns() -> dict:
    from path_tracing__ray_tracer_tpu_torch.utils.profiling import count, span

    def one():
        with span("cost.span"):
            pass

    def nested():
        with span("cost.outer"):
            with span("cost.inner"):
                pass

    def counter():
        count("cost.count", 3)

    n = 100_000
    return {name: min(timeit.repeat(fn, number=n, repeat=7)) / n * 1e9
            for name, fn in (("span", one), ("two_nested_spans", nested), ("count", counter))}


def chunk_cost(device: str, size: int, samples: int, pairs: int) -> dict:
    import torch

    import path_tracing__ray_tracer_tpu_torch as pt
    from path_tracing__ray_tracer_tpu_torch.compiler import pack_camera
    from path_tracing__ray_tracer_tpu_torch.models import path_tracer, wavefront
    from path_tracing__ray_tracer_tpu_torch.utils import profiling

    dev = torch.device(device)
    b = pt.CustomSceneBuilder()
    scene, cam = b.build_scene(), b.create_camera(1.0)
    r = pt.RendererFactory.create("cuda_path_raytracer", sample_group=samples,
                                  chunk_rays=1 << 24, texture_budget=0, device=dev)
    cs = r.compiled(scene)
    n_pix, _ = r._plan(size, size, samples, 8)
    sums = torch.zeros((3, n_pix), dtype=torch.float32, device=dev)
    kw = dict(n_pix=n_pix, width=size, height=size, n_samples=samples, max_depth=8, spp=samples)
    cam12 = pack_camera(cam, dev)

    def one() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        r._chunk(cs, cam12, sums, 0, 7, 0, col0=0, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    one()  # the plan and its captures
    before = profiling.record()
    one()
    after = profiling.record()
    made = {k: n - before.get(k, (0, 0))[0] for k, (n, _) in after.items()
            if n != before.get(k, (0, 0))[0]}
    us_each = {k: (after[k][1] - before.get(k, (0, 0))[1]) / n / 1e3 for k, n in made.items()
               if not k.startswith("lanes.")}
    spans = sum(n for k, n in made.items() if not k.startswith("lanes."))
    counts = sum(1 for k in made if k.startswith("lanes.")) * made.get("block.host", 0)
    live, stub, self_ms = [], [], []
    real = (path_tracer.span, path_tracer.count, wavefront.span)
    for i in range(pairs):
        for stubbed in ((False, True) if i % 2 == 0 else (True, False)):
            if stubbed:
                path_tracer.span = wavefront.span = _Nothing
                path_tracer.count = lambda name, n: None
            try:
                drive_ns = profiling.record()["drive"][1]
                (stub if stubbed else live).append(one())
                if not stubbed:
                    drive_ns = profiling.record()["drive"][1] - drive_ns
                    self_ms.append((live[-1] - drive_ns / 1e9) * 1e3)
            finally:
                path_tracer.span, path_tracer.count, wavefront.span = real
    med_live, med_stub = statistics.median(live), statistics.median(stub)
    q_live, q_stub = statistics.quantiles(live, n=4), statistics.quantiles(stub, n=4)
    return {"chunk_lanes": n_pix, "samples": samples, "spans_a_chunk": made, "us_each": us_each,
            "spans": spans,
            "counts": counts, "chunk_self_ms": statistics.median(self_ms), "live_s": live,
            "stub_s": stub, "live_median_s": med_live, "stub_median_s": med_stub,
            "live_iqr_s": q_live[2] - q_live[0], "stub_iqr_s": q_stub[2] - q_stub[0],
            "us_a_span_or_count": (med_live - med_stub) / max(spans + counts, 1) * 1e6}


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--samples", type=int, default=128)
    p.add_argument("--pairs", type=int, default=24)
    p.add_argument("--after-profiler", action="store_true")
    a = p.parse_args()
    if a.after_profiler:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if a.device == "cuda" else [])
        with profile(activities=acts):
            torch.ones(1, device=a.device).add_(1)
    out = {"after_profiler": a.after_profiler, "loop_ns": loop_ns(),
           "chunk": chunk_cost(a.device, a.size, a.samples, a.pairs),
           "card": card_line() if a.device.startswith("cuda") else "cpu"}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
