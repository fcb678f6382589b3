#!/usr/bin/env python3
"""Device time per launch of K4a, K5, K9 and K10a by the torch profiler, each
group in a fresh process, on one NVIDIA GPU.

Late in ``chip_smoke.py``'s process the profiler's short traces keep only
some launches of these kernels, so its kernel table falls back to CUDA
events around each launch for their rows (``ms_by: "events"``, 0.003-0.006
ms above the profiler).  Here each group of ``chip_smoke.py``'s own timing
phases runs first thing in a process of its own, with the same inputs and
the same ``chip_smoke.timed`` / ``device_ms``:

* ``mesh``: ``phase_mesh_check`` then ``phase_mesh_timing`` on config 5's
  131,072 camera rays over the 1920x1080 frame (K4a ``bvh_closest_persistent``,
  K4b, K5 ``path_bounce_bvh_persistent``);
* ``modes``: ``phase_modes_check`` on the main path's first chunk (K7, K8,
  K9 ``gather_rgb_kernel`` on the defer mip, and the library
  ``index_select`` beside K8/K9);
* ``mxu``: ``phase_mxu_check`` on config 5's three ray sets, timed on the
  camera rays (K10a ``mat_scene_closest_persistent``, K10b-d, their K4 twins).

A row that still falls back to events is also given the median of the
launches one more trace kept, and their count.  Run with no argument, it
runs the three groups as subprocesses, one after the other, and prints each
row's device ms, how it was timed, and the card's name and power limit:

    python3 experiments/torch_profiler_times.py
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

GROUPS = ("mesh", "modes", "mxu")
ROWS = {"mesh": ("scene_closest", "scene_any", "path_bounce_bvh"),
        "modes": ("path_step", "atlas_gather", "mip_gather"),
        "mxu": ("scene_closest_mat", "scene_any_mat", "tri_closest_mat", "tri_any_mat")}


def kept_ms(fn, symbol, reps=25):
    """The device ms of each launch of ``symbol`` that one profiler trace of
    ``reps`` calls of ``fn`` kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as S

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(S.TRACE_PAD_S)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(S.TRACE_PAD_S)
    return [e.time_range.elapsed_us() / 1e3 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and S.kernel_is(e.name, symbol)]


def run_group(group: str) -> dict:
    import torch

    import chip_smoke as S
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import bounce_bvh, bvh

    S.phase_environment()
    S.phase_build()
    dev = torch.device("cuda", 0)
    calls = {}
    if group == "mesh":
        cs, tables, spread, _errs = S.phase_mesh_check(dev)
        times, _bounds = S.phase_mesh_timing(cs, tables, spread)
        o, d, thr, key, depth = spread
        so, sd, lim = S.mesh_shadow(cs, o, d, key, depth)
        calls = {"scene_any": lambda: bvh.scene_any(cs, so, sd, 1e-3, lim),
                 "path_bounce_bvh": lambda: bounce_bvh.path_bounce_bvh(
                     cs, tables, o, d, thr, key, depth, shadow_light=True)}
    elif group == "modes":
        times = S.phase_modes_check(dev)[3]
    else:
        times = S.phase_mxu_check(dev)[0]
    rows = {name: {k: times[name].get(k) for k in ("symbol", "ms", "ms_by", "library_ms",
                                                   "twin_ms")}
            for name in ROWS[group]}
    for name, row in rows.items():
        if row["ms_by"] != "profiler" and name in calls:
            kept = kept_ms(calls[name], row["symbol"])
            row["kept"] = (statistics.median(kept), len(kept)) if kept else None
    return rows


def main(argv) -> int:
    if argv:
        print("ROWS " + json.dumps(run_group(argv[0])), flush=True)
        return 0
    rows = {}
    for group in GROUPS:
        out = subprocess.run([sys.executable, __file__, group], capture_output=True, text=True)
        sys.stdout.write(out.stdout)
        sys.stderr.write(out.stderr)
        if out.returncode:
            print(f"[profiler] group {group} failed ({out.returncode})")
            return out.returncode
        rows.update(json.loads(next(line for line in out.stdout.splitlines()
                                    if line.startswith("ROWS "))[5:]))
    import chip_smoke as S

    for name, r in rows.items():
        extra = "".join(f", {k} {r[k]:.4f}" for k in ("library_ms", "twin_ms") if r.get(k))
        if r.get("kept"):
            extra += f"; one more trace kept {r['kept'][1]} of 25, their median {r['kept'][0]:.4f}"
        print(f"[profiler] {name} ({r['symbol']}): {r['ms']:.4f} ms a launch by {r['ms_by']}"
              f"{extra}")
    print(S.card_line())
    by_events = [name for name, r in rows.items() if r["ms_by"] != "profiler"]
    print(f"[summary] {len(rows)} rows, timed by the profiler in fresh processes: "
          f"{len(rows) - len(by_events)}; by events: {by_events or 'none'}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
