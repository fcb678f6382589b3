#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (``path_tracing__ray_tracer_tpu_torch``, the
Cornell path tracer behind ``RendererFactory.create("cuda_path_raytracer")``)
once on the card, in phases; any failed phase raises and the script exits
non-zero.  It imports no JAX.

1. environment: torch/CUDA/nvcc/Triton versions and ``nvidia-smi``'s card
   name and power limit; fails when ``torch.cuda.is_available()`` is false;
2. build: compiles the bounce kernel from ``csrc/`` (timed);
3. the kernel against its plain torch version on the card, at 131,072 rays:
   camera rays at depth 0 and the state after three plain bounces, both
   shadow bounds;
4. timing of the kernel and the plain version (CUDA events, median);
5. the golden render of ``tests/goldens/path.npy`` on the card;
6. the main path at bench size: 1024², depth 8, one 128-sample group after a
   warm-up group, with the kernel's launch count from that run.

Prints a ``{"kernels": [...]}`` line and the card's name and power limit,
then, as its last line, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_RAYS = 131072  # lanes of one bench chunk
WIDTH = HEIGHT = 1024
DEPTH = 8
GROUP_SPP = 128
CHUNK_RAYS = 1 << 24
TOL = 1e-4  # atol = rtol on float fields, lanes where both versions hit
HIT_AGREE = 0.9999  # share of lanes with equal hit flag and winning primitive
KILL_AGREE = 0.999  # share of lanes with equal Russian-roulette verdict


def _run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def card_line() -> str:
    return _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])


def phase_environment():
    import torch

    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    try:
        import triton

        print(f"[env] triton {triton.__version__}")
    except ImportError:
        print("[env] triton: not installed")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a GPU")
    from path_tracing__ray_tracer_tpu_torch.ops.cuda.build import nvcc_path

    print(f"[env] nvcc: {_run([nvcc_path(), '--version']).splitlines()[-1]}")
    print(f"[env] card: {card_line()}")
    print(f"[env] torch sees {torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}")


def phase_build():
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import bounce

    t0 = time.perf_counter()
    built = bounce.build()
    secs = time.perf_counter() - t0
    print(f"[build] path_bounce: {secs:.2f} s total, nvcc {built.seconds:.2f} s -> {built.path.name}")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            print(f"[build]   {line.strip()}")
    return secs


def camera_state(cs, camera, n, device):
    """Bench-camera rays at depth 0: every 8th pixel of the 1024² frame,
    independent jitter, seed 0, sample 0 (the path tracer's own ray)."""
    import torch

    from path_tracing__ray_tracer_tpu_torch.compiler import pack_camera
    from path_tracing__ray_tracer_tpu_torch.ops import rng
    from path_tracing__ray_tracer_tpu_torch.ops.camera import generate_rays
    from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3

    idx = torch.arange(n, dtype=torch.int64, device=device) * (WIDTH * HEIGHT // n)
    key = rng.ray_key(0, idx, 0)
    x = (idx % WIDTH).to(torch.float32)
    y = (idx // WIDTH).to(torch.float32)
    u = (x + rng.uniform(key, DEPTH, 0)) / WIDTH
    v = (y + rng.uniform(key, DEPTH, 1)) / HEIGHT
    o, d = generate_rays(pack_camera(camera, device), u, v)
    one = torch.ones(n, dtype=torch.float32, device=device)
    return o, d, V3(one, one, one), key, torch.zeros(n, dtype=torch.int32, device=device)


def advance_plain(cs, state, bounces):
    """``bounces`` plain bounces with the scheduler's update; lanes that end
    keep their last ray.  Depths end at 3, 4 or 5 (by lane), so Russian
    roulette is on."""
    import torch

    from path_tracing__ray_tracer_tpu_torch.ops.cuda.bounce import path_bounce_plain
    from path_tracing__ray_tracer_tpu_torch.ops.texture import resolve_base_color
    from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3

    o, d, thr, key, depth = state
    for _ in range(bounces):
        out = path_bounce_plain(cs, o, d, thr, key, depth)
        base = resolve_base_color(cs, out.mat_color, (out.tex_id >= 0).float(),
                                  out.tex_id.int(), out.u, out.v)
        live = out.hit & ~out.killed
        thr = V3.where(live, thr * out.rr_scale * (base * out.t_thr + V3(out.s_thr, out.s_thr,
                                                                        out.s_thr)), thr)
        o = V3.where(live, out.new_org, o)
        d = V3.where(live, out.new_dir, d)
        depth = depth + 1
    lane = torch.arange(depth.shape[0], device=depth.device)
    return o, d, thr, key, (depth + (lane % 3)).to(torch.int32)


FLOAT_FIELDS = ("w_sky", "w_nee", "rr_scale", "s_thr", "t_thr", "new_org", "new_dir", "u", "v",
                "tex_id", "mat_color")


def compare(name, got, want):
    """The kernel's record against the plain version's; returns max |diff|."""
    import torch

    n = got.hit.shape[0]
    same_hit = (got.hit == want.hit) & (got.prim == want.prim)
    hit_share = float(same_hit.float().mean())
    kill_share = float((got.killed == want.killed).float().mean())
    lanes = same_hit & got.hit & (got.killed == want.killed)
    print(f"[check] {name}: hit+prim agree {hit_share:.6f} ({int((~same_hit).sum())} of {n} differ), "
          f"killed agree {kill_share:.6f}, hit lanes {int(lanes.sum())}")
    worst, bad_total = 0.0, 0
    for f in FLOAT_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(a, tuple):
            a, b = torch.stack(list(a)), torch.stack(list(b))
            m = lanes.expand_as(a)
        else:
            m = lanes
        diff = (a - b).abs()[m]
        bad = int((diff > TOL + TOL * b.abs()[m]).sum())
        mx = float(diff.max()) if diff.numel() else 0.0
        worst = max(worst, mx)
        bad_total += bad
        print(f"[check]   {f:10s} max |diff| {mx:.3e}  out of tolerance {bad}")
    if hit_share < HIT_AGREE or kill_share < KILL_AGREE or bad_total:
        raise SystemExit(f"chip_smoke: kernel disagrees with its plain version on {name}")
    return worst


def phase_kernel_check(cs, camera, device):
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import bounce

    blobs = (bounce.pack_scene_blob(cs), bounce.pack_mat_blob(cs), bounce.pack_light_blob(cs))
    start = camera_state(cs, camera, N_RAYS, device)
    states = {"camera rays, depth 0": start, "after 3 plain bounces, depth 3-5":
              advance_plain(cs, start, 3)}
    worst = 0.0
    for label, (o, d, thr, key, depth) in states.items():
        for shadow_light in (False, True):
            got = bounce.path_bounce(cs, *blobs, o, d, thr, key, depth, shadow_light=shadow_light)
            want = bounce.path_bounce_plain(cs, o, d, thr, key, depth, shadow_light=shadow_light)
            worst = max(worst, compare(f"{label}, shadow_light={shadow_light}", got, want))
    return blobs, start, worst


def cuda_ms(fn, reps=25):
    """Median milliseconds of one call (CUDA events, after two warm-up calls)."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_timing(cs, blobs, state):
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import bounce

    o, d, thr, key, depth = state
    ms = cuda_ms(lambda: bounce.path_bounce(cs, *blobs, o, d, thr, key, depth))
    plain_ms = cuda_ms(lambda: bounce.path_bounce_plain(cs, o, d, thr, key, depth))
    print(f"[time] path_bounce at N={N_RAYS}: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms "
          f"(median of 25, CUDA events)")
    return ms, plain_ms


def phase_golden(device):
    import numpy as np

    import path_tracing__ray_tracer_tpu_torch as pt
    from path_tracing__ray_tracer_tpu_torch.ops.cuda.bounce import path_bounce

    golden = np.load(ROOT / "tests" / "goldens" / "path.npy")
    b = pt.CustomSceneBuilder()
    scene, cam = b.build_scene(), b.create_camera(4.0 / 3.0)
    before = path_bounce.launches
    r = pt.RendererFactory.create("cuda_path_raytracer", seed=42, device=device)
    img = np.asarray(r.render(scene, cam, pt.RenderSettings(48, 36, 8, 4)))
    diff = np.abs(img.astype(np.int32) - golden.astype(np.int32))
    share = float((diff > 2).mean())
    print(f"[golden] 48x36 8 spp depth 4 seed 42: {share:.5f} of channels differ by >2/255 "
          f"(max {int(diff.max())}), kernel launches {path_bounce.launches - before}")
    if img.shape != golden.shape or share >= 0.01:
        raise SystemExit("chip_smoke: golden render outside the golden tolerance")
    if path_bounce.launches == before:
        raise SystemExit("chip_smoke: the golden render did not launch the kernel")


def phase_main_path(device):
    import numpy as np
    import torch

    import path_tracing__ray_tracer_tpu_torch as pt
    from path_tracing__ray_tracer_tpu_torch.ops.cuda.bounce import path_bounce

    b = pt.CustomSceneBuilder()
    scene, cam = b.build_scene(), b.create_camera(WIDTH / HEIGHT)
    settings = pt.RenderSettings(width=WIDTH, height=HEIGHT, samples_per_pixel=GROUP_SPP,
                                 max_depth=DEPTH)
    r = pt.RendererFactory.create("cuda_path_raytracer", sample_group=GROUP_SPP,
                                  chunk_rays=CHUNK_RAYS, texture_budget=0, device=device)
    t0 = time.perf_counter()
    r.render_sums(scene, cam, settings, sample_offset=0, n_samples=GROUP_SPP)
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    path_bounce.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sums = r.render_sums(scene, cam, settings, sample_offset=GROUP_SPP, n_samples=GROUP_SPP)
    secs = time.perf_counter() - t0
    launches = path_bounce.launches
    peak = torch.cuda.max_memory_allocated() / 2**20
    mrays = WIDTH * HEIGHT * GROUP_SPP * DEPTH / secs / 1e6
    mean = sums.mean(axis=0) / GROUP_SPP
    print(f"[main] 1024x1024 depth 8, one {GROUP_SPP}-sample group: warm-up {warm:.3f} s, "
          f"timed {secs:.3f} s -> {mrays:.2f} Mrays/s (W*H*spp*depth/t); kernel launches "
          f"{launches}; peak device memory {peak:.0f} MiB; mean radiance/sample {mean}")
    if sums.shape != (WIDTH * HEIGHT, 3) or not np.isfinite(sums).all() or not (sums >= 0).all():
        raise SystemExit("chip_smoke: main-path sums are not finite and non-negative")
    if not 0.05 < float(mean.mean()) < 5.0:
        raise SystemExit(f"chip_smoke: implausible mean radiance {mean}")
    if launches == 0:
        raise SystemExit("chip_smoke: the main path never launched the bounce kernel")
    return launches, secs, mrays


def main() -> int:
    phase_environment()
    import torch

    import path_tracing__ray_tracer_tpu_torch as pt

    device = torch.device("cuda", 0)
    build_s = phase_build()
    b = pt.CustomSceneBuilder()
    cs = pt.compile_scene(b.build_scene(), device=device)
    blobs, state, worst = phase_kernel_check(cs, b.create_camera(WIDTH / HEIGHT), device)
    ms, plain_ms = phase_timing(cs, blobs, state)
    phase_golden(device)
    launches, secs, mrays = phase_main_path(device)
    torch.cuda.synchronize()

    print(json.dumps({"kernels": [{
        "name": "path_bounce", "route": "cuda",
        "source": "path_tracing__ray_tracer_tpu_torch/csrc/path_bounce.cu",
        "replaces": "path_tracing__ray_tracer_tpu/ops/pallas/bounce_pallas.py:308",
        "launches": launches, "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
    }]}))
    print(f"build {build_s:.2f} s; main path {mrays:.2f} Mrays/s "
          f"({secs:.3f} s per 128-sample group at 1024x1024 depth 8) on:")
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
