#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives each path of the port (``path_tracing__ray_tracer_tpu_torch``) once on
the card, in phases; any failed phase raises and the script exits non-zero.
It imports no JAX.

1. environment: torch/CUDA/nvcc/Triton versions and ``nvidia-smi``'s card
   name and power limit; fails when ``torch.cuda.is_available()`` is false;
2. build: compiles every kernel library from ``csrc/``, one ``nvcc`` per
   source, all at once (timed, with each kernel's registers, stack, spills
   and static shared memory);
3. each kernel against its plain torch version on the card, at 131,072 rays:
   K1 (path bounce) on camera rays at depth 0 and the state after three plain
   bounces, both shadow bounds, after the plans of the persistent K1 and K2
   (dynamic shared memory, resident blocks an SM, grid) and the share of
   K1's lanes whose NEE shadow ray needs a sweep (``care``; here and on the
   main path's first chunk); K3a/K3b (closest / any hit) on the Whitted
   frame's camera rays and one light-sample shadow ray per lane with its own
   bound, also at 131,077 and 262,149 lanes (past the resident blocks; the
   lane counter left zero); K2 (Whitted bounce), both variants, on those camera rays and the
   rays one plain bounce on, each with the share of (light, lane) pairs
   whose shadow ray needs a sweep.  Then at the shapes the paths launch: K2 on the
   Whitted frame's first chunk (2,099,200 camera rays, both variants, and
   the compacted second bounce; its plan and pair shares), K3a/K3b on
   level 0 of the oracle frame's first chunk (its 262,144 camera rays, and
   the 4,194,304 shadow rays of all 16 light samples from every lane in one
   batch) and of the CLI default frame's first and middle chunks through
   the oracle (25,600 camera rays, 409,600 shadow rays), occlusion on
   every shadow ray;
4. timing of each kernel at 131,072 rays: its own device time per launch
   (``device_ms``: the torch profiler over 25 calls of its wrapper, the
   median of the launches of the kernel's own symbol), the call time of its
   wrapper and the call time of its plain version (``cuda_ms``: CUDA events
   around one call, median of 25; host and device), and each kernel's bound
   (the least time the card could take for the same work) from this run's
   inputs; K3a and K3b also at the oracle's launch shapes above, with their
   bounds' three terms (bytes, operations at the FP32 peak, operations one
   an issue slot);
5. the four golden renders of ``tests/goldens/`` on the card, each failing
   if its kernel did not launch;
6. the path tracer's main path at bench size: 1024², depth 8, one
   128-sample group after a warm-up group (K1's launch count); then the
   CLI (``path_tracing__ray_tracer_tpu_torch/main.py``) on that shape,
   ``-r cuda_path_raytracer -w 1024 --height 1024 --path-samples 128 -d 8
   --progressive 64 --checkpoint ...``: its PNG within the golden tolerance
   of the warm-up group's image (the same samples; the channels that differ
   printed), and a fresh CLI run resuming from a checkpoint that holds only
   the first batch, bit-equal to it;
7. the Whitted CLI default: ``cuda_texture_raytracer`` at 2000×1500, 25 spp,
   depth 16, a warm-up render then a timed one, with its RMSE/255 against
   ``reference_artifacts/output_RayTracer.png`` (K2's launch count); then
   the torch profiler over the same frame: device operations per Whitted
   bounce, device busy time and K2's share of it; the CLI at its defaults
   (``-o`` a temporary file, ``--no-show``): its PNG bit-equal to that
   frame's image, its RMSE within the limit; and ``python -m
   path_tracing__ray_tracer_tpu_torch`` in a fresh process on a 160x120
   frame with ``--trace-dir``, whose trace must name one of the port's
   kernels;
8. the oracle ``cpu_raytracer`` at 320×240, 4 spp, depth 6 (K3a/K3b's
   launch counts);
9. the BVH mesh scene of BASELINE.json config 5 (``MeshSceneBuilder(3, 3)``,
   11,520 triangles): K4a (scene closest hit) against its plain version on
   131,072 rays over the 1920×1080 frame and on the frame's first chunk;
   the persistent K4b (scene any hit) on one light-sample shadow ray per
   lane with a care mask, of those two ray sets and of the first chunk
   three plain bounces on, and the persistent K5 (BVH path bounce) on the
   first chunk at depth 0 and three plain bounces on, both shadow bounds:
   each against its plain version (occlusion; hit, prim and killed, on
   every lane), with the node table staged in shared memory and read from
   device memory; their times and bounds at 131,072 rays, and K4b and K5
   with the tree in device memory and staged, timed in turns
   (``WALK_STEPS``);
10. the mesh main path: ``cuda_path_raytracer`` at 1920×1080, depth 12,
   ``shadow_tmax="light"``, one ``MESH_SPP``-sample group after a warm-up on
   a small frame (K5's and K4b's launch counts), then a profile of a
   one-sample frame: device operations per bounce, busy time, K5's and K4b's
   shares, launches and device time per launch;
11. the mesh Whitted frame: ``cuda_texture_raytracer`` at 480×270, 4 spp,
   depth 16 (K4a's and K4b's launch counts);
12. the paged BVH of config 6 (``MeshSceneBuilder(5, 4)``, 128,000
   triangles, the CLI's ``--scene mesh_big``): the layout, then on 131,072
   camera rays over the 1920×1080 frame and on the first chunk three plain
   bounces on, K6 closest (K6a + K6c) against the plain paged walk and
   against K4a over the whole tree, K6's pending masks against the page
   roots each lane enters, K6 occlusion (K6b + K6d) on the light-sample
   shadow rays against the plain walk and K4b, and the per-ray-bound
   closest hit (K4c) and the whole-tree occlusion walk (K4d) against their
   plain versions; then the times and bounds
   of K6a-d and K4c/K4d (the page walks K6c/K6d and K4c/K4d with their tree
   traffic, their plans and resident lanes a SM; the top walks' plan: staged
   or not, shared bytes, blocks a SM and grid), and of K6, K4a/K4b and
   K5 + K4b on the same rays; the lane counter left zero;
13. config 6's path: ``cuda_path_raytracer`` at 1920×1080, depth 12,
   ``shadow_tmax="light"``, one ``B_SPP``-sample group after a warm-up frame
   (K6a-d's launch counts; K5 must stay idle), then a profile of a one-sample
   frame: device operations per bounce, busy time, K6a-d's shares;
14. the 512,000-triangle scene (``MeshSceneBuilder(5, 5)``): its set-up, its
   pages (more than 32, so both pending words are used), K6 closest and
   occlusion against K4a/K4b over the whole tree, and K4a against the plain
   walk on a slice of the rays; then the 48-page scene (``paged_48``), whose
   top leaves hold triangles: K6a and K6b, staged and read from device
   memory, against their plain versions and each other;
15. the oracle on BVH scenes: the mesh oracle golden of ``tests/goldens/``
   and a config-5 frame (K4a's and K4b's launch counts);
16. the path tracer's scheduler modes (``models/experimental.py``): K7 (the
   fused step, persistent) against its plain version on the main path's
   first chunk (131,072 lanes, 2 samples) after six plain fused steps, when
   retired, regenerated and live lanes are all present, the lane counter
   left zero; K8 (atlas gather) and K9
   (mip gather) on that chunk's texel indices into the route's atlas, the
   defer64 mip and the LOD mip, bit-equal; their times, the library call ``index_select`` beside
   K8/K9, and bounds;
17. four runs at the main path's shape (1024², depth 8, one 128-sample
   group after an 8-sample warm-up group, seed 0), each image held against
   the default run's: (a) the pipe (``_PIPE_REGEN``, K7), bit-equal to
   it; (b) deferred texture ``mip_budget=64`` and (c) texture LOD
   ``texture_lod=256, texture_lod_depth=2`` (K9), their RMSE/255 under
   ``DEFER_RMSE_MAX`` and ``LOD_RMSE_MAX``; (d) the
   atlas route (``ENABLED``, K8) at the largest ``texture_budget`` whose
   atlas fits ``MAX_ROWS``, bit-equal to the default path at that budget;
   then profiles of a 4-sample frame, default and pipe, and of a 128-sample
   pipe frame: device operations per bounce and busy share;
18. at 160x120, deferred texture and LOD with the mip equal to the atlas
   (texture budget 64) against the default render;
19. the split BVH route on config 5 (``ops/cuda/bvh.tri_route``): on
   131,072 camera rays over the 1920×1080 frame, K4e's skip-link and
   ordered closest walks (t_max 1e6 and a per-ray bound) against the plain
   skip-link walk (misses equal on every lane, the winner on ≥ 99.99%, t
   within tolerance), K4e's occlusion walks on the light-sample shadow rays
   (equal on every ray that needs an answer), each K11 pass against its
   plain version and the whole multipass walk against the single-pass K4c;
   the plans of the persistent K11, the three persistent K4e closest and
   occlusion walks and K10b-d; their times
   (the plain walks median of ``PLAIN_REPS``), bounds and tree traffic;
20. the config-5 mesh path at 1920×1080, depth 12, ``shadow_tmax="light"``,
   one ``SPLIT_SPP``-sample group, seed 0: the default route (K5), then
   ``BVH_QUAD = False`` (K4e ordered, K5 idle) and ``BVH_ATTRS = False,
   BVH_MULTIPASS = True`` (K11), each image within the golden tolerance of
   the default's, Mrays/s beside it;
21. the fault closed: config 5's tree reported 33 levels deep (past the
   BVH4 walks' stack) is routed to K4e; its queries answer, and its path at
   480×270, 4 spp, depth 12 with ``BVH_ORDERED = False`` (K4e skip-link)
   renders within the golden tolerance of the default route's;
22. the K10 walks through the leaf coefficient table
   (``ops/cuda/bvh_leafmat.py``) on config 5, before phase 20's renders: on
   the three ray sets of phase 19, K10a (scene closest), K10b (scene
   occlusion), K10c (triangle closest with a per-ray bound) and K10d
   (triangle occlusion) against their plain versions (the winner on
   ≥ 99.99% of lanes, floats within tolerance, the share bit-equal,
   occlusion equal on every ray that needs an answer), and against their
   K4 twins (reported only); their times, their twins' and their bounds on
   the camera rays;
23. within phase 20, three more renders of its frame: ``BVH_MXU_LEAF``
   (K5 with K10b), ``BVH_MXU_LEAF`` with ``BVH_ATTRS = False`` (K10c +
   K10d) and ``BVH_ATTRS = False`` alone (K4c + K4d), each within the golden
   tolerance of the default route's, the kernels each replaces idle;
24. config 5's mesh Whitted frame (as phase 11) on the default route and
   with ``BVH_MXU_LEAF`` (K10a + K10b, K4a/K4b idle), within the golden
   tolerance of each other;
25. ``[graph]``, after phase 10: the path tracer's bounce blocks replayed as
   CUDA graphs (``models/path_tracer._GRAPH_BLOCKS``, on by default, so
   every other phase renders through them) against the same blocks run
   eagerly: the main path's group (phase 6's shape) and config 5's mesh-path
   group (phase 10's) with ``_GRAPH_BLOCKS`` False, then True with a fresh
   renderer (its captures timed in), then True again (replays only): float
   sums bit-equal and per-wrapper launch counts equal, or it fails; seconds,
   Mrays/s, captures and their seconds, peak device memory; then a profile
   of one 131,072-lane chunk of each at ``GRAPH_PROFILE_SPP`` spp, eager
   and graphed: device ops and host launch calls per bounce, busy share.
   Phase 17's pipe also runs with ``_GRAPH_BLOCKS = False``, its sums
   bit-equal to the graphed run's;
26. ``[mesh]``, the (tile × sample) split on a (2, 2) mesh of four entries
   of the one card (``phase_mesh``), each entry in a worker process of its
   own: ``graft_entry``'s dry run (four sub-checks against their
   single-device renders, the launches of K1; K5 and K4b; K2; K6a-d), the
   main path at full width through the split against phase 6's first group
   (with each entry's pid and busy seconds, the overlap ratio and the cost
   of a call's block transport; fails unless four processes rendered and
   the ratio is at least 1.5), the CLI's ``--devices 1`` (bit-equal to no
   flag) and ``--devices <cards + 1>`` (exits non-zero), and
   ``graft_entry.entry()`` bit-equal to ``PathTracer.device_sums``.

Prints a ``{"kernels": [...]}`` line (``ms``: device time per launch;
``call_ms``: the wrapper's call time; ``twin_ms`` for K10a-d: their K4
twin's device time in turns; ``tree_ms`` for the BVH walks K4a-e, K5,
K6c/K6d and K11: the tree traffic the plain walk counts, over the memory
rate; ``bound_terms`` and ``shapes`` for K3a/K3b: their bound's terms, and
their device time, bound and terms at the oracle's launch shapes) and
the card's name and power limit, then, as its last line,
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
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
OCC_AGREE = 0.9999  # share of shadow rays with equal occlusion verdict
# the Whitted CLI default (reference README; the JAX package's bench.py)
W_WIDTH, W_HEIGHT, W_SPP, W_DEPTH, W_CHUNK = 2000, 1500, 25, 16, 1 << 21
RMSE_LIMIT = 2.0  # /255, against reference_artifacts/output_RayTracer.png
# the oracle frame (cut from the CLI's 2000x1500: the oracle is the reference's slow mode)
O_WIDTH, O_HEIGHT, O_SPP, O_DEPTH = 320, 240, 4, 6
# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# float operations (add, sub, mul, div, sqrt) of one primitive test of
# csrc/sweep.cuh, by primitive type (plane, sphere, quad, triangle)
TEST_FLOPS = (33, 28, 33, 45)
# float operations (sub, mul, min, max, compare) of one slab test of
# csrc/bvh_walk.cuh
BOX_FLOPS = 25
# BASELINE.json config 5 (benchmarks.py:87-90): the mesh path at full width;
# spp cut from 512 to one of its 128-sample groups (about half a minute on an
# H100; 256 would take about a minute)
M_WIDTH, M_HEIGHT, M_DEPTH, MESH_SPP = 1920, 1080, 12, 128
# the profiled mesh and config-6 frames: one sample (cut from two to keep the
# script well inside its time limit; the profiler's cost grows with the
# frame's device operations, and its ratios are per bounce)
MESH_PROFILE_SPP = 1
# the mesh Whitted frame (small: its bounces run the plain Whitted glue)
MW_WIDTH, MW_HEIGHT, MW_SPP, MW_DEPTH = 480, 270, 4, 16
# config 6 (benchmarks.py:91-99, the CLI's --scene mesh_big): 25 icospheres of
# 5,120 triangles at the config-5 frame; spp cut from 512 to one B_SPP group
B_GRID, B_SUB, B_SPP = 5, 4, 16
# the 512K scene of experiments/measure_512k.py: 25 icospheres at 5 subdivisions
K512_SUB = 5
PLAIN_REPS = 3  # the plain paged walks take seconds per call at 131,072 rays
# the oracle on BVH scenes: the golden of tests/test_torch_oracle.py, then a
# config-5 frame
MO_GOLDEN = (40, 30, 1, 3)
MO_WIDTH, MO_HEIGHT, MO_SPP, MO_DEPTH = 160, 120, 4, 6
# the scheduler modes: K7's check chunk holds MODE_SPP samples so that lanes
# retire within MODE_STEPS steps; the defer64 configuration of the JAX
# package's experiments/measure_defer.py:76; the LOD run; the warm-up group
MODE_SPP, MODE_STEPS = 2, 6
DEFER_MIP, LOD_BUDGET, LOD_DEPTH = 64, 256, 2
# bounds on the defer and LOD runs' RMSE/255 against the default image: a
# little above the 5.3930 and 3.2385 this script measures on an H100 80GB
# HBM3 at 700 W (PERF.md); the samples are seeded, so the numbers repeat
DEFER_RMSE_MAX, LOD_RMSE_MAX = 5.6, 3.4
MODE_WARM_SPP = 8
# the split route on config 5: one 8-sample group of its full-width path on
# each forced route (the plain bounce glue runs each bounce; 16 samples
# until the [mesh] phase needed the time), and the frame of the 33-deep
# tree's render
SPLIT_SPP = 8
SPLIT_QUAD, SPLIT_MP = "BVH_QUAD = False", "BVH_ATTRS = False, BVH_MULTIPASS = True"
FAULT_WIDTH, FAULT_HEIGHT, FAULT_SPP = 480, 270, 4
# the K10 walks (the leaf coefficient table, ops/cuda/bvh.BVH_MXU_LEAF): config
# 5's path on the two routes they serve and the scalar twin of the second
MXU_FUSED, MXU_QUAD = "BVH_MXU_LEAF = True", "BVH_MXU_LEAF = True, BVH_ATTRS = False"
SCALAR_QUAD = "BVH_ATTRS = False"
# float operations every slot visit of csrc/bvh_walk.cuh's MatQuadLeaf makes (the
# forms det, u·det and v·det, det², u·det·det, v·det·det and the inside test);
# the t form and its tests run only on slots inside the triangle
MAT_UV_FLOPS = 37
PROP_BUDGET = 64  # texture budget (= mip budget) of the mip == atlas property


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
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import (
        bounce, bounce_bvh, build, bvh, bvh2, bvh_leafmat, bvh_paged, intersect, step, texture,
        whitted)

    t0 = time.perf_counter()
    libs = build.load_all()
    secs = time.perf_counter() - t0
    for mod in (bounce, intersect, whitted, bvh, bounce_bvh, bvh_paged, step, texture, bvh2,
                bvh_leafmat):
        mod.build()  # binds the argument types
    print(f"[build] {len(libs)} libraries, nvcc in parallel: {secs:.2f} s wall")
    for name, built in libs.items():
        print(f"[build] {name}: nvcc {built.seconds:.2f} s; {ptxas_summary(built.log)}")
    return secs


def ptxas_summary(log: str) -> str:
    """``kernel<template arguments> regs/stack/spill/static smem`` for each
    kernel of ``nvcc -Xptxas -v``'s log, and any error line."""
    import re

    out, kernel = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for _ZN4ptrt(\d+)", line)
        if m:
            start = m.end() + int(m.group(1))
            kernel = line[m.end():start]
            targs = re.match(r"I((?:L[a-z]+\d+E)+)E", line[start:])
            if targs:
                kernel += f"<{','.join(re.findall(r'L[a-z]+(\d+)E', targs.group(1)))}>"
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m and kernel:
            stack, spill = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{kernel} {m.group(1)} regs/{stack} B stack/{spill} B spill/"
                       f"{smem.group(1) if smem else 0} B static smem")
            kernel = None
        if "rror" in line:
            out.append(line.strip())
    return "; ".join(out)


def camera_state(cs, camera, n, device, width=WIDTH, height=HEIGHT, depth=DEPTH, stride=None):
    """Path-tracer camera rays at depth 0: every ``stride``-th pixel (by
    default spread over the frame; 1 is the frame's first chunk), independent
    jitter, seed 0, sample 0 (the path tracer's own ray).  By default the
    bench frame: 1024², depth 8, every 8th pixel."""
    import torch

    from path_tracing__ray_tracer_tpu_torch.compiler import pack_camera
    from path_tracing__ray_tracer_tpu_torch.ops import rng
    from path_tracing__ray_tracer_tpu_torch.ops.camera import generate_rays
    from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3

    idx = torch.arange(n, dtype=torch.int64, device=device) * (stride or width * height // n)
    key = rng.ray_key(0, idx, 0)
    x = (idx % width).to(torch.float32)
    y = (idx // width).to(torch.float32)
    u = (x + rng.uniform(key, depth, 0)) / width
    v = (y + rng.uniform(key, depth, 1)) / height
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


def compare(name, got, want, exact=False):
    """The kernel's record against the plain version's; returns max |diff|.
    ``exact``: hit, prim and killed must agree on every lane."""
    n = got.hit.shape[0]
    same_hit = (got.hit == want.hit) & (got.prim == want.prim)
    hit_share = float(same_hit.float().mean())
    kill_share = float((got.killed == want.killed).float().mean())
    lanes = same_hit & got.hit & (got.killed == want.killed)
    print(f"[check] {name}: hit+prim agree {hit_share:.6f} ({int((~same_hit).sum())} of {n} differ), "
          f"killed agree {kill_share:.6f}, hit lanes {int(lanes.sum())}")
    worst = compare_fields(name, got, want, lanes, FLOAT_FIELDS)
    hit_bar, kill_bar = (1.0, 1.0) if exact else (HIT_AGREE, KILL_AGREE)
    if hit_share < hit_bar or kill_share < kill_bar:
        raise SystemExit(f"chip_smoke: kernel disagrees with its plain version on {name}")
    return worst


def same_bits(a, b) -> bool:
    """Are two tensors equal bit for bit (floats by their int32 patterns)?"""
    import torch

    if a.dtype == torch.float32:
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def phase_kernel_check(cs, camera, device):
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import bounce

    blobs = (bounce.pack_scene_blob(cs), bounce.pack_mat_blob(cs), bounce.pack_light_blob(cs))
    start = camera_state(cs, camera, N_RAYS, device)
    states = {"camera rays, depth 0": start, "after 3 plain bounces, depth 3-5":
              advance_plain(cs, start, 3)}
    sweep_plans("Cornell box", cs, N_RAYS, device)
    chunk = camera_state(cs, camera, N_RAYS, device, stride=1)
    shares = {"the main path's first chunk, depth 0": chunk,
              "its first chunk after 3 plain bounces": advance_plain(cs, chunk, 3),
              **{f"spread {k}": v for k, v in states.items()}}
    for label, state in shares.items():
        care_shares(label, cs, k1_state=state)
    worst = 0.0
    for label, (o, d, thr, key, depth) in states.items():
        for shadow_light in (False, True):
            got = bounce.path_bounce(cs, *blobs, o, d, thr, key, depth, shadow_light=shadow_light)
            want = bounce.path_bounce_plain(cs, o, d, thr, key, depth, shadow_light=shadow_light)
            worst = max(worst, compare(f"{label}, shadow_light={shadow_light}", got, want))
    return blobs, start, worst


def cuda_ms(fn, reps=25, warm=2):
    """Median milliseconds of one call, host and device (CUDA events around
    the call, after ``warm`` warm-up calls): the *call time*.  It covers the
    wrapper's host work (checks, allocations, the ctypes call) whenever that
    takes longer than the kernel."""
    import torch

    for _ in range(warm):
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


def kernel_is(name: str, symbol: str) -> bool:
    """Is the profiler's device event ``name`` the kernel ``symbol`` (its
    function name, demangled or mangled, whatever its namespace, template
    arguments and parameters)?"""
    import re

    sym = re.escape(symbol)
    return bool(re.search(rf"(?<!\w){sym}\s*[<(]|(?<!\d){len(symbol)}{sym}[IE]", name))


# each kernel symbol's library (ops/cuda/build.KERNELS) and C entries (csrc/*.cu)
C_ENTRIES = {
    "path_bounce_persistent": ("path_bounce", ("ptrt_path_bounce",)),
    "whitted_bounce_persistent": ("whitted_bounce", ("ptrt_whitted_bounce",)),
    "closest_hit_persistent": ("intersect", ("ptrt_closest_hit",)),
    "any_hit_persistent": ("intersect", ("ptrt_any_hit",)),
    "bvh_closest_persistent": ("bvh_scene", ("ptrt_bvh_closest",)),
    "bvh_any_persistent": ("bvh_scene", ("ptrt_bvh_any",)),
    "bvh4_rooted_persistent": ("bvh_scene", ("ptrt_bvh4_closest_rooted",)),
    "path_bounce_bvh_persistent": ("path_bounce_bvh", ("ptrt_path_bounce_bvh",)),
    "paged_top_closest_persistent": ("bvh_paged", ("ptrt_paged_top_closest",)),
    "paged_top_any_persistent": ("bvh_paged", ("ptrt_paged_top_any",)),
    "pages_closest_persistent": ("bvh_paged", ("ptrt_pages_closest",)),
    "pages_any_persistent": ("bvh_paged", ("ptrt_pages_any",)),
    "bvh2_closest_skiplink_persistent": ("bvh2", ("ptrt_bvh2_closest",)),
    "bvh2_closest_persistent": ("bvh2", ("ptrt_bvh2_closest",)),
    "bvh2_any_skiplink_persistent": ("bvh2", ("ptrt_bvh2_any",)),
    "bvh2_any_persistent": ("bvh2", ("ptrt_bvh2_any",)),
    "mat_scene_closest_persistent": ("bvh_leafmat", ("ptrt_mat_scene_closest",)),
    "mat_scene_any_persistent": ("bvh_leafmat", ("ptrt_mat_scene_any",)),
    "mat_tri_closest_persistent": ("bvh_leafmat", ("ptrt_mat_tri_closest",)),
    "mat_tri_any_persistent": ("bvh_leafmat", ("ptrt_mat_tri_any",)),
    "path_step_persistent": ("path_step", ("ptrt_path_step",)),
    "gather_rgb_kernel": ("texture_gather", ("ptrt_atlas_gather", "ptrt_mip_gather")),
}


# the pause at each end of a profiler trace (device_ms)
TRACE_PAD_S = 0.1


def device_ms(fn, symbol, reps=25, warm=2, tries=3, per_call=1):
    """The kernel ``symbol``'s own device time per launch over ``reps``
    calls of ``fn`` after ``warm`` warm-up calls, each of which launches it
    ``per_call`` times: ``(median, min, max, launches seen per call,
    method)`` in ms.  ``symbol=None`` takes every device operation of a
    call (``per_call`` of them), per call (a library call's time).

    Method ``"profiler"``: the torch profiler (CUDA activity), the launches
    of the kernel's symbol, taken only from a trace that kept every one of
    them.  Late in a long process a short trace may keep only some launches,
    or none (0-100% of them, on an H100), and the launches it drops are not
    a fair sample, so such a trace is taken again, up to ``tries`` times.
    Each trace opens and closes with a pause of ``TRACE_PAD_S`` (launches
    near a trace's ends are the ones suspected lost; PERF.md §7).  After
    that, method ``"events"``: CUDA
    events recorded on the stream right before and right after each call of
    the kernel's C entry (``C_ENTRIES``), with the calls queued behind a
    device spin that outlasts their host work, so that no event waits on the
    host (a library call: events around the whole call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / warm
    kept = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_PAD_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(TRACE_PAD_S)
        times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and (symbol is None or kernel_is(e.name, symbol))]
        if len(times) == per_call * reps:
            if symbol is None:
                total = sum(times) / reps
                return total, total, total, per_call, "profiler"
            return statistics.median(times), min(times), max(times), per_call, "profiler"
        kept.append(len(times))
    times = bracketed_ms(fn, symbol, reps, host_s)
    print(f"[time] no trace of {tries} kept all {per_call * reps} launches of "
          f"{symbol or 'the call'} (kept {kept}); timed by CUDA events around each launch: "
          f"{statistics.median(times):.4f} ms")
    return (statistics.median(times), min(times), max(times), len(times) / reps, "events")


def bracketed_ms(fn, symbol, reps, host_s):
    """Device ms of each launch of ``symbol``'s C entries (of each call of
    ``fn`` when ``symbol`` is None) during ``reps`` calls of ``fn``, by CUDA
    events around it, the calls queued behind a spin of twice their host
    time (at the H100's ~1.98 GHz)."""
    import torch

    from path_tracing__ray_tracer_tpu_torch.ops.cuda import build

    marks = []

    def bracket(call):
        def run(*args):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = call(*args)
            b.record()
            marks.append((a, b))
            return out
        return run

    lib_name, entries = C_ENTRIES[symbol] if symbol else (None, ())
    lib = build.load(lib_name).lib if lib_name else None
    real = {e: getattr(lib, e) for e in entries}
    for e, call in real.items():
        setattr(lib, e, bracket(call))
    try:
        torch.cuda._sleep(int(min(2 * reps * host_s, 1.0) * 1.98e9))
        for _ in range(reps):
            bracket(fn)() if symbol is None else fn()
        torch.cuda.synchronize()
    finally:
        for e, call in real.items():
            setattr(lib, e, call)
    return [a.elapsed_time(b) for a, b in marks]


def timed(fn, symbol, plain=None, plain_reps=25, per_call=1):
    """The timing record of one kernel row: ``ms``, its device time per
    launch (median, with ``ms_min``/``ms_max``; ``fn`` launches it
    ``per_call`` times); ``call_ms``, the call time of its wrapper;
    ``plain_ms``, the call time of its plain version; ``symbol``, the
    kernel's function name."""
    ms, lo, hi, per_call, method = device_ms(fn, symbol, per_call=per_call)
    rec = {"symbol": symbol, "ms": ms, "ms_min": lo, "ms_max": hi, "per_call": per_call,
           "ms_by": method, "call_ms": cuda_ms(fn)}
    if plain is not None:
        rec["plain_ms"] = cuda_ms(plain, plain_reps, 1 if plain_reps < 25 else 2)
    return rec


def show_time(name, rec, note=""):
    print(f"[time] {name} at N={N_RAYS}: device {rec['ms']:.4f} ms per launch (min "
          f"{rec['ms_min']:.4f}, max {rec['ms_max']:.4f}; {rec['per_call']:g} a call seen; "
          f"{rec['ms_by']}), call "
          f"{rec['call_ms']:.4f} ms" + (f", plain torch {rec['plain_ms']:.4f} ms"
                                        if "plain_ms" in rec else "") + note)


def phase_timing(cs, blobs, state):
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import bounce

    o, d, thr, key, depth = state
    rec = timed(lambda: bounce.path_bounce(cs, *blobs, o, d, thr, key, depth),
                "path_bounce_persistent",
                lambda: bounce.path_bounce_plain(cs, o, d, thr, key, depth))
    show_time("path_bounce", rec)
    return rec


GOLDENS = (  # tests/test_golden.py's configs, seed 42
    ("path", "cuda_path_raytracer", (48, 36, 8, 4), ("path_bounce",)),
    ("whitted_tex", "cuda_texture_raytracer", (48, 36, 4, 4), ("whitted_bounce",)),
    ("whitted_basic", "cuda_raytracer", (48, 36, 4, 3), ("whitted_bounce",)),
    ("oracle", "cpu_raytracer", (48, 36, 1, 3), ("closest_hit", "any_hit")),
)


def wrappers():
    """Every kernel wrapper by kernel name; each counts its own launches."""
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import (
        bounce, bounce_bvh, bvh, bvh2, bvh_leafmat, bvh_paged, intersect, step, texture, whitted)

    return {"path_bounce": bounce.path_bounce, "path_step": step.path_step,
            "atlas_gather": texture.atlas_gather, "mip_gather": texture.mip_gather,
            "whitted_bounce": whitted.whitted_bounce,
            "closest_hit": intersect.closest_hit, "any_hit": intersect.any_hit,
            "scene_closest": bvh.scene_closest, "scene_any": bvh.scene_any,
            "path_bounce_bvh": bounce_bvh.path_bounce_bvh,
            "paged_top_closest": bvh_paged.paged_top_closest,
            "paged_top_any": bvh_paged.paged_top_any, "pages_closest": bvh_paged.pages_closest,
            "pages_any": bvh_paged.pages_any, "closest_skiplink": bvh2.closest_skiplink,
            "closest_ordered": bvh2.closest_ordered, "any_skiplink": bvh2.any_skiplink,
            "any_ordered": bvh2.any_ordered, "closest_rooted": bvh.closest_rooted,
            "scene_closest_mat": bvh_leafmat.scene_closest,
            "scene_any_mat": bvh_leafmat.scene_any, "tri_closest_mat": bvh_leafmat.tri_closest,
            "tri_any_mat": bvh_leafmat.tri_any}


def reset_counts():
    for w in wrappers().values():
        w.launches = 0


def counts():
    """Launches since ``reset_counts()``."""
    return {name: w.launches for name, w in wrappers().items()}


def phase_golden(device):
    import numpy as np

    import path_tracing__ray_tracer_tpu_torch as pt

    b = pt.CustomSceneBuilder()
    scene, cam = b.build_scene(), b.create_camera(4.0 / 3.0)
    for name, renderer, cfg, kernels in GOLDENS:
        golden = np.load(ROOT / "tests" / "goldens" / f"{name}.npy")
        reset_counts()
        r = pt.RendererFactory.create(renderer, seed=42, device=device)
        img = np.asarray(r.render(scene, cam, pt.RenderSettings(*cfg)))
        launched = {k: counts()[k] for k in kernels}
        diff = np.abs(img.astype(np.int32) - golden.astype(np.int32))
        share = float((diff > 2).mean())
        print(f"[golden] {name}: {renderer} {cfg[0]}x{cfg[1]} {cfg[2]} spp depth {cfg[3]} seed 42: "
              f"{share:.5f} of channels differ by >2/255 (max {int(diff.max())}), "
              f"kernel launches {launched}")
        if img.shape != golden.shape or share >= 0.01:
            raise SystemExit(f"chip_smoke: golden render {name} outside the golden tolerance")
        if not all(launched.values()):
            raise SystemExit(f"chip_smoke: the golden render {name} did not launch {kernels}")


def phase_main_path(device):
    import numpy as np
    import torch

    import path_tracing__ray_tracer_tpu_torch as pt
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import CAPTURES
    from path_tracing__ray_tracer_tpu_torch.ops.cuda.bounce import path_bounce

    b = pt.CustomSceneBuilder()
    scene, cam = b.build_scene(), b.create_camera(WIDTH / HEIGHT)
    settings = pt.RenderSettings(width=WIDTH, height=HEIGHT, samples_per_pixel=GROUP_SPP,
                                 max_depth=DEPTH)
    r = pt.RendererFactory.create("cuda_path_raytracer", sample_group=GROUP_SPP,
                                  chunk_rays=CHUNK_RAYS, texture_budget=0, device=device)
    caps = dict(CAPTURES)
    t0 = time.perf_counter()
    warm_sums = r.render_sums(scene, cam, settings, sample_offset=0, n_samples=GROUP_SPP)
    warm = time.perf_counter() - t0
    warm_caps = captures_since(caps)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    caps = dict(CAPTURES)
    t0 = time.perf_counter()
    sums = r.render_sums(scene, cam, settings, sample_offset=GROUP_SPP, n_samples=GROUP_SPP)
    secs = time.perf_counter() - t0
    launches = path_bounce.launches
    print(f"[main] launches in the timed group: {counts()}; graph captures {captures_since(caps)} "
          f"(the warm-up group's: {warm_caps})")
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
    return (launches, secs, mrays, image_of(sums, GROUP_SPP), image_of(warm_sums, GROUP_SPP),
            warm_sums)


def captures_since(before) -> str:
    """The graph captures of this process since ``before`` (a copy of
    ``ops/cuda.CAPTURES``) and their seconds."""
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import CAPTURES

    return (f"{CAPTURES['count'] - before['count']} in "
            f"{CAPTURES['seconds'] - before['seconds']:.3f} s")


def image_of(sums, spp):
    """The uint8 (H*W, 3) image of host radiance sums over ``spp`` samples
    (the path tracer's ACES and truncating quantise)."""
    import torch

    from path_tracing__ray_tracer_tpu_torch.ops.tonemap import aces, quantize_u8
    from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3

    img = aces(torch.from_numpy(sums).T / float(spp))
    return quantize_u8(V3(img[0], img[1], img[2])).to_array().numpy()


# ---- K2 / K3: the Whitted bounce and the standalone sweeps ---------------------
def whitted_camera_rays(cs, camera, n, device):
    """Camera rays of the Whitted CLI-default frame: every k-th pixel of the
    2000x1500 frame, cell 0 of the 5x5 grid, diagonal jitter, seed 0."""
    import torch

    from path_tracing__ray_tracer_tpu_torch.compiler import pack_camera
    from path_tracing__ray_tracer_tpu_torch.ops import rng
    from path_tracing__ray_tracer_tpu_torch.ops.camera import generate_rays

    idx = torch.arange(n, dtype=torch.int64, device=device) * (W_WIDTH * W_HEIGHT // n)
    r = rng.uniform(rng.ray_key(0, idx, 0), W_DEPTH, 0)
    u = ((idx % W_WIDTH).to(torch.float32) + r / 5) / W_WIDTH
    v = ((idx // W_WIDTH).to(torch.float32) + r / 5) / W_HEIGHT
    return generate_rays(pack_camera(camera, device), u, v)


def light_sample_rays(cs, o, d, light_of_lane):
    """From each closest hit (plain sweep), one ray to light sample
    ``light_of_lane`` with the Whitted bound ``dist - 1e-3``."""
    from path_tracing__ray_tracer_tpu_torch.ops.intersect import scene_hit
    from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3

    h = scene_hit(cs, o, d, 1e-3, 1e6)
    to_light = V3(*(c[light_of_lane] for c in cs.lights)) - h.point
    dist = to_light.norm()
    return h.point + h.normal * 1e-3, to_light.normalized(), dist - 1e-3


def sweep_flops(cs, o, d, bound, first_only, lanes=None, kinds=4):
    """Float operations of the primitive tests of one sweep per ray: every
    primitive (closest hit), or those up to the first occluder in sweep
    order (any hit), as this run's rays need them; rays outside the bool
    mask ``lanes`` do not sweep.  ``kinds=3`` leaves the triangles out (the
    BVH kernels' plane/sphere/quad sweep)."""
    import torch

    from path_tracing__ray_tracer_tpu_torch.ops.intersect import _ALL, _CANDIDATES, _bound, _lift

    n = o.x.shape[0]
    b = _bound(bound, n, o.x)[:, None]
    valid = torch.cat([c(cs, _ALL, _lift(o), _lift(d), 1e-3, b)[0]
                       for c in _CANDIDATES[:kinds]], 1)
    k = valid.shape[1]
    tested = torch.full((n,), k, dtype=torch.int64, device=o.x.device)
    if first_only:
        first = valid.to(torch.int32).argmax(1) + 1
        tested = torch.where(valid.any(1), first, tested)
    if lanes is not None:
        tested = torch.where(lanes, tested, 0)
    flops, start = 0.0, 0
    for count, per_test in zip((cs.n_planes, cs.n_spheres, cs.n_quads, cs.n_triangles)[:kinds],
                               TEST_FLOPS):
        flops += float((tested - start).clamp(0, count).sum()) * per_test
        start += count
    return flops


def tree_ms(c, slot_bytes):
    """The tree traffic of a walk whose plain version counted ``c``, over
    the memory rate, in ms: 32 B a box test (a quarter of a 128 B BVH4
    record, or a BVH2 record), a slot record of ``slot_bytes`` a triangle
    test."""
    return (32 * c.get("boxes", 0) + slot_bytes * c.get("tri_tests", 0)) / PEAK_BYTES * 1e3


def bound_ms(flops, n_bytes):
    """The least time the card could take: the larger of operations over the
    FP32 peak and bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS, n_bytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def compare_fields(name, got, want, lanes, fields, verbose=True):
    """Max |diff| over ``fields`` on ``lanes``; raises when out of tolerance."""
    import torch

    worst, worst_f, bad_total = 0.0, fields[0], 0
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(a, tuple):
            a, b, m = torch.stack(list(a)), torch.stack(list(b)), lanes.expand(3, -1)
        else:
            m = lanes
        diff = (a - b).abs()[m]
        bad_total += int((diff > TOL + TOL * b.abs()[m]).sum())
        mx = float(diff.max()) if diff.numel() else 0.0
        if mx > worst:
            worst, worst_f = mx, f
    if verbose:
        print(f"[check]   max |diff| {worst:.3e} ({worst_f}) over {', '.join(fields)}; "
              f"{bad_total} out of tolerance")
    if bad_total:
        raise SystemExit(f"chip_smoke: kernel disagrees with its plain version on {name}")
    return worst


def check_closest(label, got, want, name="closest_hit"):
    """K3a's (or K4a's) record against the plain one: equal primitive on
    ≥ 99.99% of lanes, floats within tolerance where it is equal; returns
    max |diff|."""
    n = got.prim.shape[0]
    same = got.prim == want.prim
    share = float(same.float().mean())
    print(f"[check] {name}, {label}: prim agree {share:.6f} "
          f"({int((~same).sum())} of {n} differ), hit lanes {int((same & got.hit).sum())}")
    worst = compare_fields(f"{name}, {label}", got, want, same, ("t", "normal", "u", "v"))
    if share < HIT_AGREE:
        raise SystemExit(f"chip_smoke: {name} disagrees with its plain version on {label}")
    return worst


def check_occlusion(label, occ, want, lanes, name="any_hit", exact=False):
    """K3b's (or K4b's) verdicts against the plain ones on the shadow rays
    in ``lanes`` (those whose verdict the caller reads); returns max |diff|.
    ``exact``: equal on every one of them."""
    agree = float((occ == want)[lanes].float().mean())
    print(f"[check] {name}, {label}: occlusion agree {agree:.6f} on {int(lanes.sum())} of "
          f"{occ.shape[0]} rays (all rays {float((occ == want).float().mean()):.6f}), "
          f"occluded {float(occ[lanes].float().mean()):.4f}")
    if agree < (1.0 if exact else OCC_AGREE):
        raise SystemExit(f"chip_smoke: {name} disagrees with its plain version on {label}")
    diff = (occ[lanes].float() - want[lanes].float()).abs()
    return float(diff.max()) if diff.numel() else 0.0


def phase_intersect_check(cs, camera, device):
    import torch

    from path_tracing__ray_tracer_tpu_torch.ops.cuda import intersect
    from path_tracing__ray_tracer_tpu_torch.ops.cuda.bounce import pack_scene_blob

    blob = pack_scene_blob(cs)
    worst_a = worst_b = 0.0
    for n in (N_RAYS, N_RAYS + 5, 2 * N_RAYS + 5):  # then past the resident blocks
        o, d = whitted_camera_rays(cs, camera, n, device)
        worst_a = max(worst_a, check_closest(
            f"{n} Whitted camera rays", intersect.closest_hit(cs, blob, o, d, 1e-3, 1e6),
            intersect.closest_hit_plain(cs, o, d, 1e-3, 1e6)))
        lane = torch.arange(n, device=device)
        so, sd, bound = light_sample_rays(cs, o, d, lane % cs.n_lights)
        worst_b = max(worst_b, check_occlusion(
            f"{n} rays, one light-sample shadow ray per lane (bound dist - 1e-3)",
            intersect.any_hit(cs, blob, so, sd, 1e-3, bound),
            intersect.any_hit_plain(cs, so, sd, 1e-3, bound),
            torch.ones_like(lane, dtype=torch.bool)))
        check_counter(f"K3a/K3b at {n} lanes", device)
        if n == N_RAYS:
            timed_sets = (o, d), (so, sd, bound)
    return (*timed_sets, worst_a, worst_b)


def oracle_level0(device, width, height, spp, depth, chunk_rays=None, middle=False):
    """``(cs, blob, (o, d), (so, sd, dist), hit)``: the K3a and K3b launches
    of level 0 of the first chunk (``middle``: the middle one) of an oracle
    frame, as the renderer makes them (host conventions): its camera rays
    (bound 1e30), and the shadow rays of all light samples from every lane
    in one batch, light-major, each bounded at its light's distance;
    ``hit``: the shadow rays whose lane hit at level 0 (the renderer
    discards a miss's shading)."""
    import math

    import path_tracing__ray_tracer_tpu_torch as pt
    from path_tracing__ray_tracer_tpu_torch.compiler import pack_camera
    from path_tracing__ray_tracer_tpu_torch.models import whitted_oracle as wo
    from path_tracing__ray_tracer_tpu_torch.models.whitted import grid_camera_rays
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import intersect
    from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3

    b = pt.CustomSceneBuilder()
    scene, cam = b.build_scene(), b.create_camera(width / height)
    kw = {} if chunk_rays is None else {"chunk_rays": chunk_rays}
    r = pt.RendererFactory.create("cpu_raytracer", seed=0, device=device, **kw)
    cs = r.compiled(scene)
    n_pix, group = r._plan(width, height, spp, depth)
    pix0 = -(-width * height // n_pix) // 2 * n_pix if middle else 0
    o, d = grid_camera_rays(pack_camera(cam, device), pix0, n_pix, width, height, r.seed, 0,
                            group, math.isqrt(group), min(depth, wo.ORACLE_MAX_DEPTH), r.jitter)
    want = intersect.closest_hit_plain(cs, o, d, wo._T_MIN, wo._T_FAR)
    so, sd, dist = wo.shadow_rays(cs, *wo.surface(o, d, want))
    shadow = (V3(*(c.reshape(-1) for c in so)), V3(*(c.reshape(-1) for c in sd)),
              dist.reshape(-1))
    return cs, r.blobs(cs)[0], (o, d), shadow, want.hit.expand(cs.n_lights, -1).reshape(-1)


# the oracle's launch shapes that phase_oracle_check checks and
# phase_oracle_timing times: level 0 of the first chunk of the oracle frame
# and of the CLI default frame through the oracle (depth clamped to 12; its
# first chunk, the bottom row, hits nothing, so its middle chunk too)
ORACLE_SHAPES = {
    "oracle frame": (O_WIDTH, O_HEIGHT, O_SPP, O_DEPTH, None),
    "CLI default through the oracle": (W_WIDTH, W_HEIGHT, W_SPP, W_DEPTH, W_CHUNK),
    "CLI default through the oracle, middle chunk": (W_WIDTH, W_HEIGHT, W_SPP, W_DEPTH, W_CHUNK,
                                                     True)}


def phase_oracle_check(device):
    """K3a and K3b against their plain versions on the launches of level 0
    of each ``ORACLE_SHAPES`` chunk (``oracle_level0``); occlusion compared
    on every shadow ray (the share where level 0 hit printed too).  Returns
    the max errors and the launches' inputs."""
    import torch

    from path_tracing__ray_tracer_tpu_torch.models import whitted_oracle as wo
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import intersect

    worst_a = worst_b = 0.0
    shapes = {}
    for name, shape in ORACLE_SHAPES.items():
        cs, blob, (o, d), (so, sd, dist), hit = shapes[name] = oracle_level0(device, *shape)
        label = f"{name} level 0, first chunk ({o.x.shape[0]} rays, t_max {wo._T_FAR:g})"
        worst_a = max(worst_a, check_closest(
            label, intersect.closest_hit(cs, blob, o, d, wo._T_MIN, wo._T_FAR),
            intersect.closest_hit_plain(cs, o, d, wo._T_MIN, wo._T_FAR)))
        occ = intersect.any_hit(cs, blob, so, sd, wo._T_MIN, dist)
        want = intersect.any_hit_plain(cs, so, sd, wo._T_MIN, dist)
        label = f"{name} level 0 shadow batch ({cs.n_lights} lights x {o.x.shape[0]} lanes"
        worst_b = max(worst_b, check_occlusion(f"{label}, bound dist)", occ, want,
                                               torch.ones_like(hit)))
        if hit.any():
            check_occlusion(f"{label}, where level 0 hit)", occ, want, hit)
        check_counter(f"K3a/K3b on the {name}", device)
    return worst_a, worst_b, shapes


def k3_bound(flops, n_bytes):
    """``(bound_ms, bound_by, terms)`` of K3a or K3b: ``bound_ms`` as every
    row's (``bound_ms``), and its terms: bytes over the memory rate, the
    operations over the 67 TFLOP/s FP32 peak (which counts a fused
    multiply-add as two), and the operations one an issue slot (the kernels
    build with ``--fmad=false``, so no multiply fuses with an add: half that
    rate)."""
    ms, by = bound_ms(flops, n_bytes)
    return ms, by, {"bytes_ms": n_bytes / PEAK_BYTES * 1e3, "ops_ms": flops / PEAK_FLOPS * 1e3,
                    "issue_ms": flops / (PEAK_FLOPS / 2) * 1e3}


def phase_oracle_timing(shapes):
    """K3a's and K3b's device time a launch, bound and bound terms at each
    ``ORACLE_SHAPES`` launch: ``{kernel: [row, ...]}``."""
    from path_tracing__ray_tracer_tpu_torch.models import whitted_oracle as wo
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import intersect

    rows = {"closest_hit": [], "any_hit": []}
    for name, (cs, blob, (o, d), (so, sd, dist), _hit) in shapes.items():
        n, m = o.x.shape[0], so.x.shape[0]
        for kernel, fn, symbol, lanes, (ms_b, by, terms) in (
                ("closest_hit", lambda: intersect.closest_hit(cs, blob, o, d, wo._T_MIN,
                                                              wo._T_FAR),
                 "closest_hit_persistent", n,
                 k3_bound(sweep_flops(cs, o, d, wo._T_FAR, False), n * (4 * 6 + 4 * 7))),
                ("any_hit", lambda: intersect.any_hit(cs, blob, so, sd, wo._T_MIN, dist),
                 "any_hit_persistent", m,
                 k3_bound(sweep_flops(cs, so, sd, dist, True), m * (4 * 7 + 1)))):
            ms, lo, hi, _per, method = device_ms(fn, symbol)
            rows[kernel].append({"shape": name, "lanes": lanes, "ms": ms, "ms_by": method,
                                 "bound_ms": ms_b, "bound_by": by, **terms})
            print(f"[time] {kernel} on the {name}'s level 0, {lanes} lanes: device {ms:.4f} ms "
                  f"(min {lo:.4f}, max {hi:.4f}; {method}); bound {ms_b:.5f} ms ({by}; bytes "
                  f"{terms['bytes_ms']:.5f}, ops {terms['ops_ms']:.5f}, issue slots "
                  f"{terms['issue_ms']:.5f})")
    return rows


def advance_whitted_plain(cs, o, d, variant):
    """The rays one plain Whitted bounce on: every hit lane's reflected or
    refracted ray; miss lanes keep their ray."""
    from path_tracing__ray_tracer_tpu_torch.ops.cuda.whitted import whitted_bounce_plain
    from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3

    out = whitted_bounce_plain(cs, o, d, variant)
    return (V3(*(c.contiguous() for c in V3.where(out.hit, out.new_org, o))),
            V3(*(c.contiguous() for c in V3.where(out.hit, out.new_dir, d))))


def check_whitted(label, cs, blobs, o, d, variant):
    """K2 against its plain version on rays ``(o, d)``: hit+prim on ≥ 99.99%
    of lanes, ``cont`` equal and floats within tolerance on the hit lanes;
    returns ``(max |diff|, the plain record)``."""
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import whitted

    got = whitted.whitted_bounce(cs, *blobs, o, d, variant)
    want = whitted.whitted_bounce_plain(cs, o, d, variant)
    same = (got.hit == want.hit) & (got.prim == want.prim)
    share = float(same.float().mean())
    lanes = same & got.hit
    cont_ok = bool((got.cont[lanes] == want.cont[lanes]).all())
    print(f"[check] whitted_bounce {label}: hit+prim agree {share:.6f} "
          f"({int((~same).sum())} of {same.shape[0]} differ), hit lanes {int(lanes.sum())}, "
          f"continuing {int(got.cont.sum())}, cont agree {cont_ok}")
    worst = compare_fields(f"whitted_bounce {label}", got, want, lanes,
                           ("a", "w", "mult", "new_org", "new_dir", "u", "v", "tex_id",
                            "mat_color"))
    if share < HIT_AGREE or not cont_ok:
        raise SystemExit(f"chip_smoke: whitted_bounce disagrees on {label}")
    return worst, want


def phase_whitted_check(cs, blobs, camera_rays):
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import whitted

    worst = 0.0
    for vname, variant in (("basic", whitted.BASIC), ("texture", whitted.TEXTURE)):
        states = {"camera rays, depth 0": camera_rays,
                  "one plain bounce on, depth 1": advance_whitted_plain(cs, *camera_rays, variant)}
        for label, (o, d) in states.items():
            care_shares(f"{vname}, {label}", cs, k2_rays=(o, d), variant=variant)
            worst = max(worst, check_whitted(f"{vname}, {label}", cs, blobs, o, d, variant)[0])
    return worst


def phase_whitted_frame_check(device):
    """K2 against its plain version on the launches of two chunks of the
    Whitted CLI frame, as the renderer makes them: the first chunk (the
    floor's rows) and the middle one (the spheres).  For each variant, all
    the chunk's grid cells' camera rays, then every later bounce on the
    lanes that continue, compacted, until none is left."""
    import math

    import torch

    import path_tracing__ray_tracer_tpu_torch as pt
    from path_tracing__ray_tracer_tpu_torch.compiler import pack_camera
    from path_tracing__ray_tracer_tpu_torch.models.whitted import grid_camera_rays
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import whitted

    b = pt.CustomSceneBuilder()
    scene, cam = b.build_scene(), b.create_camera(W_WIDTH / W_HEIGHT)
    r = pt.RendererFactory.create("cuda_texture_raytracer", chunk_rays=W_CHUNK, seed=0,
                                  device=device)
    cs = r.compiled(scene)
    blobs = r.blobs(cs)
    n_pix, group = r._plan(W_WIDTH, W_HEIGHT, W_SPP, W_DEPTH)
    n_chunks = -(-W_WIDTH * W_HEIGHT // n_pix)
    worst = 0.0
    for chunk in (0, n_chunks // 2):
        for vname, variant in (("basic", whitted.BASIC), ("texture", whitted.TEXTURE)):
            o, d = grid_camera_rays(pack_camera(cam, device), chunk * n_pix, n_pix, W_WIDTH,
                                    W_HEIGHT, r.seed, 0, group, math.isqrt(group), W_DEPTH,
                                    r.jitter)
            if chunk == 0:
                sweep_plans(f"Whitted frame chunk 0, {vname}", cs, o.x.shape[0], device,
                            ("whitted_bounce",))
            for bounce in range(1, W_DEPTH + 1):
                if chunk == 0 and bounce <= 2:
                    care_shares(f"{vname}, Whitted frame chunk 0, bounce {bounce}", cs,
                                k2_rays=(o, d), variant=variant)
                err, rec = check_whitted(
                    f"{vname}, Whitted frame chunk {chunk} of {n_chunks} ({n_pix} px x {group} "
                    f"cells), bounce {bounce}", cs, blobs, o, d, variant)
                worst = max(worst, err)
                sel = torch.nonzero(rec.hit & rec.cont)[:, 0]
                if sel.numel() == 0:
                    break
                o, d = rec.new_org.take(sel), rec.new_dir.take(sel)
    return worst


def phase_new_timing(cs, blobs, camera_rays, shadow):
    """Kernel and plain times of K2, K3a and K3b, and the bounds of all four
    kernels, at N = 131,072 from this run's inputs."""
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import intersect, whitted

    o, d = camera_rays
    so, sd, bound = shadow
    times = {
        "whitted_bounce": (lambda: whitted.whitted_bounce(cs, *blobs, o, d, whitted.TEXTURE),
                           lambda: whitted.whitted_bounce_plain(cs, o, d, whitted.TEXTURE),
                           "whitted_bounce_persistent"),
        "closest_hit": (lambda: intersect.closest_hit(cs, blobs[0], o, d, 1e-3, 1e6),
                        lambda: intersect.closest_hit_plain(cs, o, d, 1e-3, 1e6),
                        "closest_hit_persistent"),
        "any_hit": (lambda: intersect.any_hit(cs, blobs[0], so, sd, 1e-3, bound),
                    lambda: intersect.any_hit_plain(cs, so, sd, 1e-3, bound),
                    "any_hit_persistent"),
    }
    out = {}
    for name, (kernel, plain, symbol) in times.items():
        out[name] = timed(kernel, symbol, plain)
        show_time(name, out[name])
    return out


def k1_care(cs, o, d, key, depth):
    """``(closest hit, NEE light direction, care)``: K1's ``care`` per lane
    (``csrc/path_shade.cuh`` nee_query: a hit facing the picked light
    sample with a diffuse material), from the plain ops."""
    import torch

    from path_tracing__ray_tracer_tpu_torch.ops import rng
    from path_tracing__ray_tracer_tpu_torch.ops.intersect import resolve_material, scene_hit
    from path_tracing__ray_tracer_tpu_torch.ops.sampling import pick_light

    h = scene_hit(cs, o, d, 1e-3, 1e6)
    ldir, _dist, _pdf = pick_light(cs, h.point, rng.uniform(key, depth, 0))
    care = h.hit & (torch.clamp(ldir.dot(h.normal), min=0.0) > 0) & (
        resolve_material(cs, h.prim)[1] > 0)
    return h, ldir, care


def k2_lights(cs, o, d, spec_table=True):
    """For each light sample, ``(care, shadow origin, direction, dist)``:
    K2's ``care`` per lane (``csrc/whitted_bounce.cu`` light_term: the
    Lambert or Phong term is not zero whatever the occlusion), from the
    plain ops; ``spec_table``: the texture variant's specular gate."""
    import torch

    from path_tracing__ray_tracer_tpu_torch.ops.intersect import resolve_material, scene_hit
    from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3

    h = scene_hit(cs, o, d, 1e-3, 1e6)
    _c, diffuse, specular, _r, _t, _i, _h, _x = resolve_material(cs, h.prim)
    nrm = h.normal
    for li in range(cs.n_lights):
        tl = cs.lights.at_index(li) - h.point
        dist = tl.norm()
        near_ok = dist > 0.001
        ld = tl * (1.0 / torch.where(near_ok, dist, 1.0))
        dot_nl = nrm.dot(ld)
        diff = torch.clamp(dot_nl, min=0.0)
        refl = V3(2.0 * dot_nl * nrm.x - ld.x, 2.0 * dot_nl * nrm.y - ld.y,
                  2.0 * dot_nl * nrm.z - ld.z)
        dot_rv = torch.clamp(-refl.dot(d), min=0.0)
        spec_on = (specular > 0.01) & (diff > 0) if spec_table else specular > 0.01
        care = h.hit & near_ok & (((diff > 0) & (diffuse > 0)) | (spec_on & (dot_rv > 0)))
        yield care, h.point + nrm * 1e-3, ld, dist


def care_shares(label, cs, k1_state=None, k2_rays=None, variant=None):
    """Print the share of K1's lanes whose NEE ``care`` is set (their shadow
    ray needs a sweep), or of K2's (light, lane) pairs whose ``care`` is set
    (and of its lanes with any, and that hit), on these inputs."""
    import torch

    if k1_state is not None:
        o, d, _thr, key, depth = k1_state
        care = k1_care(cs, o, d, key, depth)[2]
        print(f"[care] K1, {label}: {float(care.float().mean()):.4f} of {care.shape[0]} lanes "
              f"need a NEE shadow sweep")
    if k2_rays is not None:
        from path_tracing__ray_tracer_tpu_torch.ops.intersect import scene_hit

        hit = scene_hit(cs, *k2_rays, 1e-3, 1e6).hit
        cares = torch.stack([c for c, *_ in k2_lights(cs, *k2_rays, variant.spec_table)])
        print(f"[care] K2, {label}: {float(cares.float().mean()):.4f} of "
              f"{cares.shape[0]} x {cares.shape[1]} (light, lane) pairs need a shadow sweep; "
              f"{float(cares.any(0).float().mean()):.4f} of lanes need any, "
              f"{float(hit.float().mean()):.4f} hit")


def sweep_plans(label, cs, n, device, names=("path_bounce", "whitted_bounce")):
    """Print the launch plans of K1 and K2 (those in ``names``) on ``cs``
    for ``n`` lanes: dynamic shared memory, resident blocks an SM, grid."""
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import bounce, bvh, whitted

    plan = bounce.sweep_plan("sweep_plans", bounce.blob_layout(cs)[:4],
                             int(cs.materials.diffuse.shape[0]), cs.n_lights,
                             bvh.smem_limit(device))
    occupancy = {"path_bounce": bounce.build().lib.ptrt_path_bounce_occupancy,
                 "whitted_bounce": whitted.build().lib.ptrt_whitted_bounce_occupancy}
    for who in names:
        grid = bvh.launch_grid(who, occupancy[who], plan, n, device)
        print(f"[plan] {who}, {label}: {plan.smem_bytes} B of dynamic shared memory, "
              f"{bvh._RESIDENT[(who, device.index, plan)]} resident blocks of "
              f"{bvh.WALK_THREADS} an SM, grid {grid} blocks at N={n}")


def k1_flops(cs, o, d, key, depth):
    """Float operations of K1's sweeps on these rays: the closest sweep,
    then the NEE shadow sweep (bound t_max = 1e6, the reference quirk) to
    its first occluder on hit lanes facing the light with a diffuse
    material (the kernel's ``care``)."""
    h, ldir, care = k1_care(cs, o, d, key, depth)
    return sweep_flops(cs, o, d, 1e6, False) + sweep_flops(cs, h.point + h.normal * 1e-3, ldir,
                                                           1e6, True, care)


def kernel_bounds(cs, k1_state, camera_rays, shadow):
    """``{name: (bound_ms, bound_by)}`` for K1, K2, K3a, K3b (with their
    terms, ``k3_bound``) on the inputs
    they were timed on: full closest sweeps, and shadow sweeps to their
    first occluder only where the result can change the record (the
    kernels' own ``care`` predicates); each input read once, each output
    written once."""
    n = N_RAYS
    closest = {}
    o, d, _thr, key, depth = k1_state
    closest["path_bounce"] = bound_ms(k1_flops(cs, o, d, key, depth), n * (4 * 11 + 4 * 19 + 4))
    # K2 (texture variant, as timed): closest sweep + one shadow sweep (bound
    # dist - 1e-3) per light sample whose Lambert or Phong term is not zero
    # whatever the occlusion (csrc/whitted_bounce.cu's `care`)
    wo, wd = camera_rays
    k2 = sweep_flops(cs, wo, wd, 1e6, False)
    for care, so, ld, dist in k2_lights(cs, wo, wd):
        k2 += sweep_flops(cs, so, ld, dist - 1e-3, True, care)
    closest["whitted_bounce"] = bound_ms(k2, n * (4 * 6 + 4 * 17 + 4))
    closest["closest_hit"] = k3_bound(sweep_flops(cs, wo, wd, 1e6, False), n * (4 * 6 + 4 * 7))
    so, sd, b = shadow
    closest["any_hit"] = k3_bound(sweep_flops(cs, so, sd, b, True), n * (4 * 7 + 1))
    for name, (ms, by, *terms) in closest.items():
        print(f"[bound] {name}: {ms:.5f} ms ({by})" + (f"; terms {terms[0]}" if terms else ""))
    return closest


def phase_whitted_frame(device):
    """The Whitted CLI default on the card, with its RMSE against the
    reference's published render."""
    import numpy as np
    import torch
    from PIL import Image

    import path_tracing__ray_tracer_tpu_torch as pt
    from path_tracing__ray_tracer_tpu_torch.utils.assets import reference_render_path

    b = pt.CustomSceneBuilder()
    scene, cam = b.build_scene(), b.create_camera(W_WIDTH / W_HEIGHT)
    settings = pt.RenderSettings(W_WIDTH, W_HEIGHT, W_SPP, W_DEPTH)
    r = pt.RendererFactory.create("cuda_texture_raytracer", chunk_rays=W_CHUNK, seed=0,
                                  device=device)
    t0 = time.perf_counter()
    r.render(scene, cam, settings)
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    img = np.asarray(r.render(scene, cam, settings))
    secs = time.perf_counter() - t0
    launched = counts()
    peak = torch.cuda.max_memory_allocated() / 2**20
    ref = np.asarray(Image.open(reference_render_path()).convert("RGB")).astype(np.float64)
    rmse = float(np.sqrt(((img.astype(np.float64) - ref) ** 2).mean()))
    mrays = W_WIDTH * W_HEIGHT * W_SPP * W_DEPTH / secs / 1e6
    print(f"[whitted] {W_WIDTH}x{W_HEIGHT} {W_SPP} spp depth {W_DEPTH} seed 0 "
          f"(chunk_rays {W_CHUNK}): warm-up {warm:.3f} s, timed {secs:.3f} s -> {mrays:.2f} "
          f"Mrays/s (W*H*spp*depth/t); launches {launched}; peak device memory {peak:.0f} MiB; "
          f"RMSE {rmse:.4f}/255 against output_RayTracer.png")
    if img.shape != ref.shape or not rmse <= RMSE_LIMIT:
        raise SystemExit(f"chip_smoke: Whitted frame RMSE {rmse} above {RMSE_LIMIT}/255")
    if launched["whitted_bounce"] == 0:
        raise SystemExit("chip_smoke: the Whitted frame never launched the Whitted kernel")
    return launched["whitted_bounce"], secs, mrays, rmse, img


# ---- the CLI: python -m path_tracing__ray_tracer_tpu_torch ------------------------
def cli_run(argv, kernels):
    """``main(argv)`` of the port's CLI in this process, on the card; raises
    unless it returned 0 and launched each of ``kernels``.  Returns its
    seconds and the launches."""
    import torch

    from path_tracing__ray_tracer_tpu_torch import main as cli

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    secs = time.perf_counter() - t0
    launched = {k: counts()[k] for k in kernels}
    print(f"[cli] {' '.join(argv)}: rc {rc}, {secs:.3f} s, launches {launched}")
    if rc != 0 or not all(launched.values()):
        raise SystemExit(f"chip_smoke: the CLI run {argv} failed or did not launch {kernels}")
    return secs, launched


def png(path):
    import numpy as np
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def phase_cli_default(whitted_img):
    """The CLI at its defaults (the Whitted CLI frame: 2000x1500, 25 spp,
    depth 16, ``cuda_texture_raytracer``), saving to a temporary file: its
    PNG bit-equal to ``phase_whitted_frame``'s image, its RMSE against the
    reference's render within ``RMSE_LIMIT``."""
    import tempfile

    import numpy as np
    from PIL import Image

    from path_tracing__ray_tracer_tpu_torch.utils.assets import reference_render_path

    with tempfile.TemporaryDirectory() as tmp:
        out = f"{tmp}/output.png"
        secs, _ = cli_run(["-o", out, "--no-show"], ("whitted_bounce",))
        img = png(out)
    ref = np.asarray(Image.open(reference_render_path()).convert("RGB")).astype(np.float64)
    rmse = float(np.sqrt(((img.astype(np.float64) - ref) ** 2).mean()))
    same = img.shape == whitted_img.shape and bool((img == whitted_img).all())
    print(f"[cli] default frame: bit-equal to the Whitted frame's image: {same}; RMSE "
          f"{rmse:.4f}/255 against output_RayTracer.png")
    if not same or not rmse <= RMSE_LIMIT:
        raise SystemExit("chip_smoke: the CLI's default frame is not the Whitted frame")
    return secs, rmse


def phase_cli_progressive(oneshot_img):
    """The CLI on the main path's shape, progressive with a checkpoint
    (``-r cuda_path_raytracer -w 1024 --height 1024 --path-samples 128 -d 8
    --progressive 64 --checkpoint ...``): its image within the golden
    tolerance of the one-shot image of the same 128 samples
    (``phase_main_path``'s first group), with the channels that differ; then
    a fresh CLI run resuming from a checkpoint that holds only the first
    batch (a copy of the file the first run saved after it), bit-equal to
    the uninterrupted progressive image."""
    import shutil
    import tempfile

    import numpy as np

    from path_tracing__ray_tracer_tpu_torch.parallel import progressive

    shape = ["-r", "cuda_path_raytracer", "-w", str(WIDTH), "--height", str(HEIGHT),
             "--path-samples", str(GROUP_SPP), "-d", str(DEPTH), "--progressive",
             str(GROUP_SPP // 2), "--no-show"]
    with tempfile.TemporaryDirectory() as tmp:
        first_batch = f"{tmp}/first_batch.npz"
        save = progressive.save_state

        def keep_first_batch(path, sums, samples_done, fp):
            save(path, sums, samples_done, fp)
            if samples_done == GROUP_SPP // 2:
                shutil.copy(path, first_batch)

        progressive.save_state = keep_first_batch
        try:
            secs, _ = cli_run(shape + ["--checkpoint", f"{tmp}/acc.npz", "-o", f"{tmp}/p.png"],
                              ("path_bounce",))
        finally:
            progressive.save_state = save
        prog = png(f"{tmp}/p.png")
        with np.load(first_batch) as ckpt:
            done = int(ckpt["samples_done"])
        r_secs, _ = cli_run(shape + ["--checkpoint", first_batch, "-o", f"{tmp}/r.png"],
                            ("path_bounce",))
        resumed = png(f"{tmp}/r.png")
    # phase_main_path's image is bottom-up (H*W, 3); the PNG top-down
    want = np.flip(oneshot_img.reshape(HEIGHT, WIDTH, 3), axis=0)
    diff = np.abs(prog.astype(np.int32) - want.astype(np.int32))
    share = float((diff > 2).mean())
    bits = bool((resumed == prog).all())
    print(f"[cli] progressive {WIDTH}x{HEIGHT} {GROUP_SPP} spp in batches of {GROUP_SPP // 2}: "
          f"{secs:.3f} s; against the one-shot image of the same samples "
          f"{int((diff > 0).sum())} of {diff.size} channels differ ({share:.6f} by >2/255, max "
          f"{int(diff.max())}); the resumed run ({done} samples in its checkpoint, "
          f"{r_secs:.3f} s) bit-equal to the uninterrupted one: {bits}")
    if share >= 0.01 or done != GROUP_SPP // 2:
        raise SystemExit("chip_smoke: the progressive CLI image is outside the golden tolerance")
    if not bits:
        raise SystemExit("chip_smoke: the resumed progressive render differs from the "
                         "uninterrupted one")
    return secs, int((diff > 0).sum()), share


def phase_cli_trace():
    """``python -m path_tracing__ray_tracer_tpu_torch`` in a fresh process on a
    small Whitted frame (160x120, 4 spp, depth 4) with ``--trace-dir``: the
    Chrome trace it writes must name one of the port's kernels."""
    import glob
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "path_tracing__ray_tracer_tpu_torch", "-w", "160",
               "--height", "120", "-s", "4", "-d", "4", "-o", f"{tmp}/t.png", "--no-show",
               "--trace-dir", f"{tmp}/trace"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=ROOT,
                              env={**os.environ, "PYTHONPATH": str(ROOT)})
        secs = time.perf_counter() - t0
        traces = glob.glob(f"{tmp}/trace/trace_*.json")
        text = "".join(Path(t).read_text() for t in traces)
    named = sorted(sym for sym in C_ENTRIES if sym in text)
    print(f"[cli] {' '.join(cmd[1:4])} ... --trace-dir: rc {proc.returncode}, {secs:.1f} s, "
          f"{len(traces)} trace(s), {len(text)} bytes, kernels named: {named}")
    if proc.returncode != 0 or not named:
        print(proc.stdout[-2000:], proc.stderr[-2000:])
        raise SystemExit("chip_smoke: the CLI's trace names none of the port's kernels")


def phase_whitted_profile(device, frame_secs):
    """Device operations per Whitted bounce, the device's busy time and K2's
    share of it, from the torch profiler over the device sums of the Whitted
    CLI frame itself (``frame_secs``: the untraced render's time)."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    import path_tracing__ray_tracer_tpu_torch as pt
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import whitted

    b = pt.CustomSceneBuilder()
    scene, cam = b.build_scene(), b.create_camera(W_WIDTH / W_HEIGHT)
    r = pt.RendererFactory.create("cuda_texture_raytracer", chunk_rays=W_CHUNK, seed=0,
                                  device=device)
    settings = pt.RenderSettings(W_WIDTH, W_HEIGHT, W_SPP, W_DEPTH)
    r.device_sums(scene, cam, settings)
    torch.cuda.synchronize()
    before = whitted.whitted_bounce.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r.device_sums(scene, cam, settings)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    bounces = whitted.whitted_bounce.launches - before
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ops:
        print("[whitted] profile: not measured (the profiler saw no device operation)")
        return
    by_name = collections.Counter()
    for e in ops:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    k2 = sum(ms for name, ms in by_name.items() if "whitted_bounce" in name)
    print(f"[whitted] profile of the {W_WIDTH}x{W_HEIGHT} {W_SPP} spp depth {W_DEPTH} frame's "
          f"device sums: {len(ops)} device operations in {bounces} bounces -> "
          f"{len(ops) / bounces:.1f} per bounce; device busy {busy:.3f} ms = "
          f"{100 * busy / wall_ms:.1f}% of the {wall_ms:.3f} ms traced and "
          f"{100 * busy / (1e3 * frame_secs):.1f}% of the untraced frame's {frame_secs:.3f} s; "
          f"K2 {k2:.3f} ms ({100 * k2 / busy:.1f}% of busy)")
    for name, ms in by_name.most_common(6):
        print(f"[whitted]   {ms:9.3f} ms  {name[:90]}")


def phase_oracle(device):
    import numpy as np
    import torch

    import path_tracing__ray_tracer_tpu_torch as pt

    b = pt.CustomSceneBuilder()
    scene, cam = b.build_scene(), b.create_camera(O_WIDTH / O_HEIGHT)
    r = pt.RendererFactory.create("cpu_raytracer", seed=0, device=device)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    sums = r.render_sums(scene, cam, pt.RenderSettings(O_WIDTH, O_HEIGHT, O_SPP, O_DEPTH))
    secs = time.perf_counter() - t0
    launched = counts()
    mean = sums.mean(axis=0) / O_SPP
    print(f"[oracle] cpu_raytracer {O_WIDTH}x{O_HEIGHT} {O_SPP} spp depth {O_DEPTH}: "
          f"{secs:.3f} s; launches {launched}; mean radiance/sample {mean}")
    if not np.isfinite(sums).all() or not (sums >= 0).all() or not 0.05 < float(mean.mean()) < 5:
        raise SystemExit("chip_smoke: oracle sums are not finite, non-negative and plausible")
    if not (launched["closest_hit"] and launched["any_hit"]):
        raise SystemExit("chip_smoke: the oracle did not launch both intersection kernels")
    return launched


# ---- K4a / K4b / K5: the BVH mesh scene (BASELINE.json config 5) ----------------
def mesh_scene(device):
    import path_tracing__ray_tracer_tpu_torch as pt

    b = pt.MeshSceneBuilder(grid=3, subdivisions=3)
    scene, cam = b.build_scene(), b.create_camera(M_WIDTH / M_HEIGHT)
    return scene, cam, pt.compile_scene(scene, device=device, use_bvh=True)


def mesh_shadow(cs, o, d, key, depth, h=None):
    """The NEE shadow ray of each lane's closest hit ``h`` (by default the
    plain one), as K5 makes it (``shadow_tmax="light"``): origin, direction
    and bound, −1 where the answer is not needed (missed, light below the
    horizon, no diffuse)."""
    import torch

    from path_tracing__ray_tracer_tpu_torch.ops import rng
    from path_tracing__ray_tracer_tpu_torch.ops.intersect import (
        resolve_material, scene_hit_bvh_plain)
    from path_tracing__ray_tracer_tpu_torch.ops.sampling import pick_light

    if h is None:
        h = scene_hit_bvh_plain(cs, o, d, 1e-3, 1e6)
    ldir, dist, _pdf = pick_light(cs, h.point, rng.uniform(key, depth, 0))
    care = h.hit & (torch.clamp(ldir.dot(h.normal), min=0.0) > 0) & (
        resolve_material(cs, h.prim)[1] > 0)
    return h.point + h.normal * 1e-3, ldir, torch.where(care, dist - 1e-3, -1.0)


@contextlib.contextmanager
def bvh_set(**values):
    """``ops/cuda/bvh``'s module globals set to ``values`` inside, restored
    after (the route flags, the walks' shared-memory budgets)."""
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import bvh

    saved = {k: getattr(bvh, k) for k in values}
    try:
        for k, v in values.items():
            setattr(bvh, k, v)
        yield
    finally:
        for k, v in saved.items():
            setattr(bvh, k, v)


def walk_plans(cs, tables, n=N_RAYS):
    """The persistent K4b's and K5's plans on ``cs`` and their grids for
    ``n`` lanes, as their wrappers pick them (the budget as now set)."""
    import torch

    from path_tracing__ray_tracer_tpu_torch.ops.cuda import bounce_bvh, bvh

    dev = torch.device("cuda", 0)
    limit = bvh.smem_limit(dev)
    out = {}
    for name, plan, occupancy in (
            ("K4b", bvh.any_plan(cs, limit), bvh.build().lib.ptrt_bvh_any_occupancy),
            ("K5", bounce_bvh.bounce_plan(cs, tables, limit),
             bounce_bvh.build().lib.ptrt_path_bounce_bvh_occupancy)):
        out[name] = (plan, bvh.launch_grid(name, occupancy, plan, n, dev))
    return out


def show_plans(label, plans):
    print(f"[mesh] {label}: " + "; ".join(
        f"{k} stage {p.stage}, depth class {p.depth_class}, {p.smem_bytes} B of shared memory "
        f"a block, {grid} blocks of 256 threads" for k, (p, grid) in plans.items()))


def phase_mesh_check(device):
    """K4a against its plain version; K4b and K5 against their plain
    versions, with the node table staged in shared memory
    (``SMEM_TREE_BYTES`` lifted) and read from device memory
    (``SMEM_TREE_BYTES = 0``, the default):
    K4b on the light-sample shadow rays of camera rays over the frame, of
    the frame's first chunk and of that chunk three plain bounces on (equal
    on every ray that needs an answer), K5 on the first chunk at depth 0 and
    three plain bounces on, both shadow bounds (hit, prim and killed equal
    on every lane).  K5's plain version is ``path_bounce_plain``, whose
    intersections launch K4a and K4b on the card (checked first)."""
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import bounce, bounce_bvh, bvh
    from path_tracing__ray_tracer_tpu_torch.ops.intersect import (
        scene_hit_any_bvh_plain, scene_hit_bvh_plain)

    _scene, cam, cs = mesh_scene(device)
    print(f"[mesh] config-5 scene: {cs.n_triangles} triangles, BVH {cs.bvh.n_nodes} nodes, "
          f"BVH4 {cs.bvh.nodes4.shape[0] // 32} nodes ({cs.bvh.nodes4.numel() * 4} B), depth "
          f"{cs.bvh.depth4}; slot records {cs.bvh.slot_rec.numel() * 4} B, padded "
          f"{cs.bvh.slot16.numel() * 4} B")
    tables = bounce_bvh.pack_bvh_tables(cs)
    spread = camera_state(cs, cam, N_RAYS, device, M_WIDTH, M_HEIGHT, M_DEPTH)
    chunk = camera_state(cs, cam, N_RAYS, device, M_WIDTH, M_HEIGHT, M_DEPTH, stride=1)
    bounced = advance_plain(cs, chunk, 3)
    plan = bvh.closest_plan(cs)
    grid = bvh.launch_grid("K4a", bvh.build().lib.ptrt_bvh_closest_occupancy, plan, N_RAYS, device)
    print(f"[mesh] K4a: depth class {plan.depth_class}, {plan.smem_bytes} B of shared memory a "
          f"block, {grid} blocks of {bvh.WALK_THREADS} threads at {N_RAYS} lanes")
    k4a = k4b = k5 = 0.0
    for label, (o, d, _t, _key, _depth) in (("131,072 rays over the 1920x1080 frame", spread),
                                            ("the frame's first chunk", chunk)):
        k4a = max(k4a, check_closest(label, bvh.scene_closest(cs, o, d, 1e-3, 1e6),
                                     scene_hit_bvh_plain(cs, o, d, 1e-3, 1e6), "scene_closest"))
    shadow = {label: mesh_shadow(cs, o, d, key, depth) for label, (o, d, _t, key, depth) in (
        ("131,072 rays over the 1920x1080 frame", spread), ("the frame's first chunk", chunk),
        ("the first chunk, 3 plain bounces on", bounced))}
    states = {"first chunk, depth 0": chunk, "first chunk, 3 plain bounces on, depth 3-5": bounced}
    for staged in (True, False):
        where = "tree in shared memory" if staged else "tree in device memory"
        with bvh_set(SMEM_TREE_BYTES=STAGE_ALL if staged else 0):
            plans = walk_plans(cs, tables)
            show_plans(where, plans)
            if any(p.stage != staged for p, _ in plans.values()):
                raise SystemExit(f"chip_smoke: the walk plan did not put the {where}")
            for label, (so, sd, lim) in shadow.items():
                occ = bvh.scene_any(cs, so, sd, 1e-3, lim)
                k4b = max(k4b, check_occlusion(
                    f"{where}, {label}, one light-sample shadow ray per lane", occ,
                    scene_hit_any_bvh_plain(cs, so, sd, 1e-3, lim), lim > 0, "scene_any", True))
            for label, (o, d, thr, key, depth) in states.items():
                for shadow_light in (False, True):
                    name = f"path_bounce_bvh, {where}, {label}, shadow_light={shadow_light}"
                    got = bounce_bvh.path_bounce_bvh(cs, tables, o, d, thr, key, depth,
                                                     shadow_light=shadow_light)
                    want = bounce.path_bounce_plain(cs, o, d, thr, key, depth,
                                                    shadow_light=shadow_light)
                    k5 = max(k5, compare(name, got, want, exact=True))
    return cs, tables, spread, (k4a, k4b, k5)


def in_turns(new, twin):
    """Device ms per launch of a kernel and its twin timed in turns (new,
    twin, twin, new): ``(new mean, twin mean, the four times)``;
    ``new``/``twin`` are ``(call, symbol)``."""
    got = [device_ms(*x) for x in (new, twin, twin, new)]
    if any(g[4] != "profiler" for g in got):
        print(f"[turns] {new[1]} / {twin[1]}: some times are by CUDA events around the launch "
              f"({[g[4] for g in got]})")
    n1, t1, t2, n2 = (g[0] for g in got)
    return (n1 + n2) / 2, (t1 + t2) / 2, (n1, t1, t2, n2)


# a tree budget that stages every node table a block can hold
STAGE_ALL = 1 << 30
# K4b's and K5's two plans, timed in turns: the budget each sets
WALK_STEPS = (
    ("tree in device memory (the default plan)", {"SMEM_TREE_BYTES": 0}),
    ("tree in shared memory (TMA)", {"SMEM_TREE_BYTES": STAGE_ALL}),
)
# float operations of K5's shading on a lane that hits (csrc/path_bounce_bvh.cu:
# "the shading adds about 60 float operations")
SHADE_FLOPS = 60


def phase_mesh_timing(cs, tables, spread):
    """K4a, K4b and K5 at N = 131,072 on the camera rays ``spread``: device
    time per launch of each kernel's own symbol (K5 alone: its wrapper's K4b
    launch and glue belong to K4b's row and to the call time), call and
    plain times; K4b and K5 with the tree in device memory and staged, in
    turns; and the bounds from the same inputs: lane bytes, each input
    read once and each output written once; operations, the plane/sphere/quad
    sweeps plus the box and triangle tests the plain skip-link walk counts
    (K5: its closest walk and its shading); beside them, the tree traffic the
    plain walk counts (a quarter of a 128 B node record a box test, a slot
    record a triangle test)."""
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import bounce, bounce_bvh, bvh
    from path_tracing__ray_tracer_tpu_torch.ops.intersect import (
        scene_hit_any_bvh_plain, scene_hit_bvh_plain)

    o, d, thr, key, depth = spread
    so, sd, lim = mesh_shadow(cs, o, d, key, depth)
    walks = {
        "scene_any": (lambda: bvh.scene_any(cs, so, sd, 1e-3, lim), "bvh_any_persistent"),
        "path_bounce_bvh": (lambda: bounce_bvh.path_bounce_bvh(cs, tables, o, d, thr, key, depth,
                                                               shadow_light=True),
                            "path_bounce_bvh_persistent"),
    }
    times = {
        "scene_closest": timed(lambda: bvh.scene_closest(cs, o, d, 1e-3, 1e6),
                               "bvh_closest_persistent",
                               lambda: scene_hit_bvh_plain(cs, o, d, 1e-3, 1e6)),
        "scene_any": timed(walks["scene_any"][0], "bvh_any_persistent",
                           lambda: scene_hit_any_bvh_plain(cs, so, sd, 1e-3, lim)),
        "path_bounce_bvh": timed(walks["path_bounce_bvh"][0], "path_bounce_bvh_persistent",
                                 lambda: bounce.path_bounce_plain(cs, o, d, thr, key, depth,
                                                                  shadow_light=True)),
    }
    for name, rec in times.items():
        show_time(name, rec, " (K5 alone; the call adds K4b and the glue)"
                  if name == "path_bounce_bvh" else "")
    for name, call in walks.items():
        got = {label: [] for label, _ in WALK_STEPS}
        for label, budgets in WALK_STEPS + WALK_STEPS[::-1]:
            with bvh_set(**budgets):
                got[label].append(device_ms(*call)[0])
        print(f"[steps] {name} on camera rays (device ms per launch, each the mean of two "
              f"timed in a palindrome order): " + "; ".join(
                  f"{label} {statistics.mean(v):.4f}" for label, v in got.items()))
    for label, budgets in WALK_STEPS:
        with bvh_set(**budgets):
            show_plans(label, walk_plans(cs, tables))

    closest, shadow = {}, {}
    plain_hit = scene_hit_bvh_plain(cs, o, d, 1e-3, 1e6, counts=closest)
    scene_hit_any_bvh_plain(cs, so, sd, 1e-3, lim, counts=shadow)
    care = lim > 0
    ops_a = (sweep_flops(cs, o, d, 1e6, False, kinds=3) + BOX_FLOPS * closest["boxes"]
             + TEST_FLOPS[3] * closest["tri_tests"])
    ops_b = (sweep_flops(cs, so, sd, lim, True, care, kinds=3) + BOX_FLOPS * shadow["boxes"]
             + TEST_FLOPS[3] * shadow["tri_tests"])
    n = N_RAYS
    bounds = {"scene_closest": bound_ms(ops_a, n * (4 * 6 + 4 * 7)),
              "scene_any": bound_ms(ops_b, n * (4 * 7 + 1)),
              # reads 44 B; writes the 76 B record, 4 B of prim, the 28 B shadow ray
              "path_bounce_bvh": bound_ms(ops_a + SHADE_FLOPS * int(plain_hit.hit.sum()),
                                          n * (4 * 11 + 4 * 19 + 4 + 4 * 7))}

    trees = {"scene_closest": tree_ms(closest, 52), "scene_any": tree_ms(shadow, 64),
             "path_bounce_bvh": tree_ms(closest, 64)}
    for name, tree in trees.items():
        times[name]["tree_ms"] = tree
    print(f"[bound] mesh walks at N={N_RAYS}: closest {closest['boxes']} box and "
          f"{closest['tri_tests']} triangle tests, shadow {shadow['boxes']} and "
          f"{shadow['tri_tests']} ({int(care.sum())} rays need an answer); " + "; ".join(
              f"{k} {v[0]:.5f} ms ({v[1]}; tree traffic {trees[k]:.5f} ms, slot records of "
              f"{52 if k == 'scene_closest' else 64} B; old layout "
              f"{tree_ms(closest if k != 'scene_any' else shadow, 52):.5f})"
              for k, v in bounds.items()))
    return times, bounds


def phase_mesh_main(device):
    """The mesh path at full width (config 5, spp cut to one group)."""
    import numpy as np
    import torch

    import path_tracing__ray_tracer_tpu_torch as pt
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import CAPTURES

    b = pt.MeshSceneBuilder(grid=3, subdivisions=3)
    scene, cam = b.build_scene(), b.create_camera(M_WIDTH / M_HEIGHT)
    r = pt.RendererFactory.create("cuda_path_raytracer", sample_group=MESH_SPP,
                                  chunk_rays=CHUNK_RAYS, shadow_tmax="light", seed=0,
                                  compile_overrides={"use_bvh": True}, device=device)
    t0 = time.perf_counter()
    r.render_sums(scene, cam, pt.RenderSettings(256, 144, 4, M_DEPTH))
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    caps = dict(CAPTURES)
    t0 = time.perf_counter()
    sums = r.render_sums(scene, cam, pt.RenderSettings(M_WIDTH, M_HEIGHT, MESH_SPP, M_DEPTH))
    secs = time.perf_counter() - t0
    launched = counts()
    caps = captures_since(caps)
    peak = torch.cuda.max_memory_allocated() / 2**20
    mrays = M_WIDTH * M_HEIGHT * MESH_SPP * M_DEPTH / secs / 1e6
    mean = sums.mean(axis=0) / MESH_SPP
    print(f"[mesh] path {M_WIDTH}x{M_HEIGHT} depth {M_DEPTH} shadow_tmax=light, one {MESH_SPP}-"
          f"sample group: warm-up (256x144, 4 spp) {warm:.3f} s, timed {secs:.3f} s -> "
          f"{mrays:.2f} Mrays/s (W*H*spp*depth/t); launches K5 {launched['path_bounce_bvh']}, "
          f"K4b {launched['scene_any']}, K1 {launched['path_bounce']}; graph captures {caps} "
          f"(other widths than the warm-up's); peak device memory {peak:.0f} MiB; mean "
          f"radiance/sample {mean}")
    if sums.shape != (M_WIDTH * M_HEIGHT, 3) or not np.isfinite(sums).all() or (sums < 0).any():
        raise SystemExit("chip_smoke: mesh-path sums are not finite and non-negative")
    if not 0.01 < float(mean.mean()) < 20.0:
        raise SystemExit(f"chip_smoke: implausible mesh mean radiance {mean}")
    if not (launched["path_bounce_bvh"] and launched["scene_any"]):
        raise SystemExit("chip_smoke: the mesh path never launched K5 and K4b")
    return launched, secs, mrays, r, scene, cam


def profile_frame(tag, r, scene, cam, settings, counter, kernels, top=4):
    """Device operations per bounce, the device's busy share of the untraced
    frame and each kernel's share of the busy time, launches and device time
    per launch, from the torch profiler over ``r.device_sums`` of one frame
    (rendered once before, so that the untraced and traced frames replay
    the path tracer's graphs and capture none).  ``counter()`` counts the
    frame's bounces; ``kernels`` maps a label to a kernel's symbol
    (``kernel_is``)."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    r.device_sums(scene, cam, settings)  # the frame's graph captures, out of its time
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.device_sums(scene, cam, settings)
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0
    before = counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r.device_sums(scene, cam, settings)
        torch.cuda.synchronize()
    bounces = counter() - before
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ops:
        print(f"{tag} profile: not measured (the profiler saw no device operation)")
        return
    by_name = collections.Counter()
    for e in ops:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    shares = []
    for k, sym in kernels.items():
        mine = [e.time_range.elapsed_us() / 1e3 for e in ops if kernel_is(e.name, sym)]
        shares.append(f"{k} {sum(mine):.3f} ms ({100 * sum(mine) / busy:.1f}%; {len(mine)} "
                      f"launches, {sum(mine) / max(len(mine), 1):.4f} ms each)")
    shares = ", ".join(shares)
    print(f"{tag} profile of a {settings.width}x{settings.height} {settings.samples_per_pixel}-spp "
          f"depth {settings.max_depth} frame (untraced {untraced:.3f} s): {len(ops)} device ops in "
          f"{bounces} bounces -> {len(ops) / max(bounces, 1):.1f} per bounce; device busy "
          f"{busy:.3f} ms = {100 * busy / (1e3 * untraced):.1f}% of the untraced frame; {shares}")
    for name, ms in by_name.most_common(top):
        print(f"{tag}   {ms:9.3f} ms  {name[:90]}")


def phase_mesh_profile(r, scene, cam):
    """Device operations per mesh bounce, device busy time and the shares
    of K5 and K4b, from the torch profiler over a one-sample mesh frame."""
    import path_tracing__ray_tracer_tpu_torch as pt
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import bounce_bvh

    r.sample_group = MESH_PROFILE_SPP
    profile_frame("[mesh]", r, scene, cam,
                  pt.RenderSettings(M_WIDTH, M_HEIGHT, MESH_PROFILE_SPP, M_DEPTH),
                  lambda: bounce_bvh.path_bounce_bvh.launches,
                  {"K5": "path_bounce_bvh_persistent", "K4b": "bvh_any_persistent"})


# ---- [graph]: the bounce blocks as CUDA graphs against the eager loop ---------
# the host calls that launch device work, as the profiler's runtime events name them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cuGraphLaunch")
GRAPH_PROFILE_SPP = 32  # the profiled frame: one 131,072-lane chunk of each path at this spp


def graph_group(make, scene, cam, settings, renderer=None):
    """One sample group of ``settings`` (samples 0 on) by ``renderer`` or a
    fresh ``make()``: ``(renderer, sums, launches, seconds, captures,
    capture seconds, peak MiB)``; the scene compile stays out of the time."""
    import torch

    from path_tracing__ray_tracer_tpu_torch.ops.cuda import CAPTURES

    r = make() if renderer is None else renderer
    r.compiled(scene)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    before = dict(CAPTURES)
    t0 = time.perf_counter()
    sums = r.render_sums(scene, cam, settings)
    secs = time.perf_counter() - t0
    return (r, sums, {k: v for k, v in counts().items() if v}, secs,
            CAPTURES["count"] - before["count"], CAPTURES["seconds"] - before["seconds"],
            torch.cuda.max_memory_allocated() / 2**20)


def graph_profile(r, scene, cam, settings, counter):
    """Device ops and host launch calls per bounce, and the device's busy
    share of the untraced frame, from the torch profiler over one frame of
    ``r`` (rendered once untraced before, so a graph run replays only)."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    r.device_sums(scene, cam, settings)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.device_sums(scene, cam, settings)
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0
    before = counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r.device_sums(scene, cam, settings)
        torch.cuda.synchronize()
    bounces = max(counter() - before, 1)
    events = prof.events()
    ops = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    calls = collections.Counter(e.name for e in events
                                if e.device_type == torch.autograd.DeviceType.CPU
                                and e.name in LAUNCH_CALLS)
    busy = sum(e.time_range.elapsed_us() for e in ops) / 1e3
    return dict(bounces=bounces, ops=len(ops) / bounces,
                launches=sum(calls.values()) / bounces, calls=dict(calls),
                busy=100 * busy / (1e3 * untraced) if ops else None, untraced=untraced)


def phase_graph(device):
    """``[graph]``: the main path's group (1024², depth 8, 128 spp) and
    config 5's mesh-path group (1920×1080, depth 12, 128 spp,
    ``shadow_tmax="light"``) with ``_GRAPH_BLOCKS`` False, then True (a
    fresh renderer, its captures in the time), then True again (replays
    only): the float sums bit-equal and the launch counts equal, or it
    fails; seconds, Mrays/s, captures and their seconds, peak memory; then,
    on one 131,072-lane chunk of each path at ``GRAPH_PROFILE_SPP`` spp,
    eager and graphed, device ops and host launch calls per bounce and the
    device's busy share (torch profiler)."""
    import numpy as np

    import path_tracing__ray_tracer_tpu_torch as pt
    from path_tracing__ray_tracer_tpu_torch.models import path_tracer
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import bounce, bounce_bvh

    b = pt.CustomSceneBuilder()
    mb = pt.MeshSceneBuilder(grid=3, subdivisions=3)
    paths = (
        ("main path", b.build_scene(), b.create_camera(WIDTH / HEIGHT),
         pt.RenderSettings(WIDTH, HEIGHT, GROUP_SPP, DEPTH), dict(texture_budget=0),
         (WIDTH, N_RAYS // WIDTH), lambda: bounce.path_bounce.launches),
        ("config 5", mb.build_scene(), mb.create_camera(M_WIDTH / M_HEIGHT),
         pt.RenderSettings(M_WIDTH, M_HEIGHT, MESH_SPP, M_DEPTH),
         dict(shadow_tmax="light", seed=0, compile_overrides={"use_bvh": True}),
         (M_WIDTH, N_RAYS // M_WIDTH), lambda: bounce_bvh.path_bounce_bvh.launches),
    )
    out = {}
    for label, scene, cam, settings, kw, (pw, ph), counter in paths:
        def make():
            return pt.RendererFactory.create("cuda_path_raytracer", sample_group=GROUP_SPP,
                                             chunk_rays=CHUNK_RAYS, device=device, **kw)

        rays = settings.width * settings.height * settings.samples_per_pixel * settings.max_depth
        runs = {}
        for tag, graphed in (("eager", False), ("graphs", True), ("replay", True)):
            path_tracer._GRAPH_BLOCKS = graphed
            try:
                runs[tag] = graph_group(make, scene, cam, settings,
                                        runs["graphs"][0] if tag == "replay" else None)
            finally:
                path_tracer._GRAPH_BLOCKS = True
            _r, _sums, launched, secs, caps, cap_s, peak = runs[tag]
            print(f"[graph] {label} {settings.width}x{settings.height} depth {settings.max_depth}, "
                  f"one {settings.samples_per_pixel}-sample group, {tag}: {secs:.3f} s -> "
                  f"{rays / secs / 1e6:.2f} Mrays/s; launches {launched}; {caps} captures in "
                  f"{cap_s:.3f} s; peak device memory {peak:.0f} MiB")
        same = all(np.array_equal(runs["eager"][1], runs[t][1]) for t in ("graphs", "replay"))
        counted = all(runs["eager"][2] == runs[t][2] for t in ("graphs", "replay"))
        print(f"[graph] {label}: float sums bit-equal {same}, launch counts equal {counted}; "
              f"eager/replay {runs['eager'][3] / runs['replay'][3]:.2f}x")
        if not same or not counted:
            raise SystemExit(f"chip_smoke: the {label}'s graph replay differs from its eager loop")
        prof = {}
        small = pt.RenderSettings(pw, ph, GRAPH_PROFILE_SPP, settings.max_depth)
        for tag, graphed in (("eager", False), ("graphs", True)):
            path_tracer._GRAPH_BLOCKS = graphed
            try:
                prof[tag] = graph_profile(make(), scene, cam, small, counter)
            finally:
                path_tracer._GRAPH_BLOCKS = True
            p = prof[tag]
            busy = "not measured" if p["busy"] is None else f"{p['busy']:.1f}%"
            print(f"[graph] {label} profile, {tag}: one {pw}x{ph} chunk at {GRAPH_PROFILE_SPP} spp "
                  f"(untraced {p['untraced']:.3f} s): {p['bounces']} bounces, {p['ops']:.1f} "
                  f"device ops and {p['launches']:.2f} host launch calls a bounce {p['calls']}; "
                  f"device busy {busy}")
        out[label] = {t: runs[t][2:] for t in runs}, prof
    return out


def phase_mesh_whitted(device):
    import numpy as np
    import torch

    import path_tracing__ray_tracer_tpu_torch as pt

    b = pt.MeshSceneBuilder(grid=3, subdivisions=3)
    scene, cam = b.build_scene(), b.create_camera(MW_WIDTH / MW_HEIGHT)
    r = pt.RendererFactory.create("cuda_texture_raytracer", seed=0, device=device)
    r.compiled(scene)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    sums = r.render_sums(scene, cam, pt.RenderSettings(MW_WIDTH, MW_HEIGHT, MW_SPP, MW_DEPTH))
    secs = time.perf_counter() - t0
    launched = counts()
    mean = sums.mean(axis=0) / MW_SPP
    print(f"[mesh] Whitted {MW_WIDTH}x{MW_HEIGHT} {MW_SPP} spp depth {MW_DEPTH}: {secs:.3f} s; "
          f"launches K4a {launched['scene_closest']}, K4b {launched['scene_any']}, "
          f"K2 {launched['whitted_bounce']}; mean radiance/sample {mean}")
    if not np.isfinite(sums).all() or (sums < 0).any() or not float(mean.mean()) > 0.01:
        raise SystemExit("chip_smoke: mesh Whitted sums are not finite, non-negative, plausible")
    if not (launched["scene_closest"] and launched["scene_any"]):
        raise SystemExit("chip_smoke: the mesh Whitted frame did not launch K4a and K4b")
    return launched


# ---- K6a-d / K4c / K4d: the paged BVH of config 6 and the 512K scene -----------
def one_level(cs):
    """``cs`` without its paged layout: the one-level records that K4a, K4b
    and K5 walk."""
    return cs._replace(bvh=cs.bvh._replace(paged=None))


def big_scene(device, subdivisions):
    """A ``MeshSceneBuilder(B_GRID, subdivisions)`` scene compiled on the
    card, and the compile's seconds (SAH build, records, ``pack_paged``)."""
    import torch

    import path_tracing__ray_tracer_tpu_torch as pt

    b = pt.MeshSceneBuilder(grid=B_GRID, subdivisions=subdivisions)
    scene, cam = b.build_scene(), b.create_camera(M_WIDTH / M_HEIGHT)
    t0 = time.perf_counter()
    cs = pt.compile_scene(scene, device=device, use_bvh=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    pg = cs.bvh.paged
    if pg is None:
        raise SystemExit(f"chip_smoke: the {cs.n_triangles}-triangle scene did not page")
    print(f"[big] {cs.n_triangles} triangles: compile {secs:.2f} s; {pg.n_pages} pages of "
          f"{pg.page_tree.shape[1]} + {pg.page_slot.shape[1]} floats, BVH4 depth <= "
          f"{pg.page_depth}; top tree {pg.top_tree.shape[0] // 32} nodes, depth {pg.top_depth}, "
          f"{pg.top_slot.shape[0] // 208} leaves; one-level BVH4 depth {cs.bvh.depth4}")
    return scene, cam, cs, secs


def check_hits(label, got, want):
    """One line: equal primitive on >= 99.99% of lanes, floats within
    tolerance where equal; returns max |diff|."""
    same = got.prim == want.prim
    share = float(same.float().mean())
    worst = compare_fields(label, got, want, same, ("t", "normal", "u", "v"), verbose=False)
    print(f"[big]   {label}: prim agree {share:.6f} ({int((~same).sum())} differ), "
          f"max |diff| {worst:.2e}")
    if share < HIT_AGREE:
        raise SystemExit(f"chip_smoke: {label} disagree")
    return worst


def check_occ(label, occ, want, lanes):
    agree = float((occ == want)[lanes].float().mean())
    print(f"[big]   {label}: occlusion agree {agree:.6f} on {int(lanes.sum())} rays, occluded "
          f"{float(occ[lanes].float().mean()):.4f}")
    if agree < OCC_AGREE:
        raise SystemExit(f"chip_smoke: {label} disagree")
    return float((occ[lanes].float() - want[lanes].float()).abs().max())


def check_pend(label, cs, o, d, t):
    """K6a's pending words hold every page whose root box the lane enters
    at its final ``t``, on every lane."""
    from path_tracing__ray_tracer_tpu_torch.ops import bvh as tbvh
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import bvh_paged

    _best, plo, phi = bvh_paged.paged_top_closest(cs, o, d, 1e-3, 1e6)
    pend = tbvh.pend_mask(plo, phi)
    missing = int(((tbvh.page_root_mask(cs.bvh.paged, o, d, 1e-3, t) & ~pend) != 0).sum())
    pages = [int((((pend >> p) & 1) != 0).sum()) for p in range(cs.bvh.paged.n_pages)]
    print(f"[big]   {label}: pend masks cover the entered pages on "
          f"{o.x.shape[0] - missing} of {o.x.shape[0]} lanes; lanes pending per page "
          f"min {min(pages)} max {max(pages)}; pages per lane {sum(pages) / o.x.shape[0]:.2f}")
    if missing:
        raise SystemExit(f"chip_smoke: K6a's pending masks miss entered pages ({label})")


def page_walk_plans(cs, n=N_RAYS):
    """The page walks' plans on ``cs`` (K6c/K6d by the page depth, K4c/K4d
    by the whole tree's), each variant's resident blocks per SM and its grid
    for ``n`` lanes, as the wrappers pick them."""
    import ctypes

    import torch

    from path_tracing__ray_tracer_tpu_torch.ops.cuda import bvh, bvh_paged

    dev = torch.device("cuda", 0)
    lib = bvh_paged.build().lib
    out = {}
    for name, depth, occupancy in (
            ("K6c", cs.bvh.paged.page_depth, lib.ptrt_pages_closest_occupancy),
            ("K6d", cs.bvh.paged.page_depth, lib.ptrt_pages_any_occupancy),
            ("K4c", cs.bvh.depth4, lib.ptrt_pages_closest_occupancy),
            ("K4d", cs.bvh.depth4, lib.ptrt_pages_any_occupancy)):
        plan = bvh.page_plan(depth)
        blocks = ctypes.c_int(0)
        bvh._raise_on(name, occupancy(0, plan.depth_class, 0, ctypes.byref(blocks)))
        out[name] = (depth, plan, blocks.value, bvh.launch_grid(name, occupancy, plan, n, dev))
    return out


def top_walk_plans(cs, n=N_RAYS):
    """The top walks' plan on ``cs`` (``ops/cuda/bvh_paged.top_walk_plan``:
    staged or not, the stack's depth class, the shared bytes a block), each
    kernel's resident blocks per SM and its grid for ``n`` lanes, as the
    wrappers pick them."""
    import ctypes

    import torch

    from path_tracing__ray_tracer_tpu_torch.ops.cuda import bvh, bvh_paged

    dev = torch.device("cuda", 0)
    lib = bvh_paged.build().lib
    plan = bvh_paged.top_walk_plan(cs, bvh_paged.smem_limit(dev))
    out = {}
    for name, who, occupancy in (
            ("K6a", "paged_top_closest", lib.ptrt_paged_top_closest_occupancy),
            ("K6b", "paged_top_any", lib.ptrt_paged_top_any_occupancy)):
        blocks = ctypes.c_int(0)
        bvh._raise_on(name, occupancy(*(int(x) for x in plan), ctypes.byref(blocks)))
        out[name] = (plan, blocks.value, bvh.launch_grid(who, occupancy, plan, n, dev))
    return out


@contextlib.contextmanager
def top_variant(cs, staged: bool):
    """While it lasts, the top walks on ``cs`` take the staged variant (the
    card's shared memory) or the one that reads the top tables from device
    memory (a limit that holds only the primitive records): the wrappers'
    ``smem_limit`` replaced and their plans forgotten, both put back after."""
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import bvh_paged
    from path_tracing__ray_tracer_tpu_torch.ops.cuda.bounce import rec_layout

    saved = bvh_paged.smem_limit, bvh_paged._TOP_PLANS
    rec = 4 * rec_layout((cs.n_planes, cs.n_spheres, cs.n_quads, 0)).size
    bvh_paged.smem_limit = saved[0] if staged else (lambda dev: rec)
    bvh_paged._TOP_PLANS = {}
    try:
        yield
    finally:
        bvh_paged.smem_limit, bvh_paged._TOP_PLANS = saved


def show_top_plans(tag, cs, n=N_RAYS):
    pg = cs.bvh.paged
    print(f"{tag} top walk plans at N={n} (top tree {pg.top_tree.shape[0] // 32} nodes, depth "
          f"{pg.top_depth}, {pg.top_slot.shape[0] // 13} top slots): " + "; ".join(
              f"{k} stage {p.stage}, depth class {p.depth_class}, {p.smem_bytes} B of shared "
              f"memory a block, {per_sm} blocks of 256 a SM ({256 * per_sm} lanes), grid {grid}"
              for k, (p, per_sm, grid) in top_walk_plans(cs, n).items()))


def check_counter(label, device):
    """The persistent walks leave the stream's lane counter zero."""
    import torch

    from path_tracing__ray_tracer_tpu_torch.ops.cuda import bvh

    torch.cuda.synchronize()
    if bvh.lane_counter(device).any():
        raise SystemExit(f"chip_smoke: the lane counter is nonzero after {label}")


def phase_big_check(device):
    """Config 6's paged tree: K6 and K4c against their plain versions and the
    one-level K4a/K4b, the pending-mask property, then times and bounds."""
    import torch

    from path_tracing__ray_tracer_tpu_torch.ops.cuda import bounce, bounce_bvh, bvh, bvh_paged
    from path_tracing__ray_tracer_tpu_torch.ops.intersect import (
        ClosestRecord, scene_hit_any_paged_plain, scene_hit_bvh_plain, scene_hit_paged_plain)
    from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3

    scene, cam, cs, _secs = big_scene(device, B_SUB)
    flat = one_level(cs)
    spread = camera_state(cs, cam, N_RAYS, device, M_WIDTH, M_HEIGHT, M_DEPTH)
    chunk = camera_state(cs, cam, N_RAYS, device, M_WIDTH, M_HEIGHT, M_DEPTH, stride=1)
    err = {"closest": 0.0, "any": 0.0, "k4c": 0.0}
    rays = {}
    for label, (o, d, _t, key, depth) in (("spread", spread),
                                          ("bounced", advance_plain(cs, chunk, 3))):
        got = bvh.scene_closest(cs, o, d, 1e-3, 1e6)  # K6a + K6c
        err["closest"] = max(err["closest"], check_hits(
            f"K6 closest vs plain paged walk, {label}", got, scene_hit_paged_plain(
                cs, o, d, 1e-3, 1e6)), check_hits(
            f"K6 closest vs K4a whole tree, {label}", got, bvh.scene_closest(flat, o, d, 1e-3,
                                                                            1e6)))
        check_pend(label, cs, o, d, got.t)
        so, sd, lim = mesh_shadow(cs, o, d, key, depth, got)
        occ = bvh.scene_any(cs, so, sd, 1e-3, lim)  # K6b + K6d
        err["any"] = max(err["any"], check_occ(
            f"K6 any vs plain paged walk, {label} shadow rays", occ,
            scene_hit_any_paged_plain(cs, so, sd, 1e-3, lim), lim > 0), check_occ(
            f"K6 any vs K4b whole tree, {label} shadow rays", occ,
            bvh.scene_any(flat, so, sd, 1e-3, lim), lim > 0))
        unfound = torch.zeros_like(lim, dtype=torch.bool)
        err["any"] = max(err["any"], check_occ(
            f"K4d (whole tree) vs plain, {label} shadow rays",
            bvh_paged.pages_any(cs, so, sd, 1e-3, lim, unfound),
            bvh_paged.pages_any_plain(cs, so, sd, 1e-3, lim, unfound), torch.ones_like(unfound)))
        err["k4c"] = max(err["k4c"], check_hits(
            f"K4c (per-ray bound) vs plain, {label} shadow rays",
            bvh.scene_closest(cs, so, sd, 1e-3, lim), scene_hit_bvh_plain(cs, so, sd, 1e-3, lim)))
        rays[label] = (o, d, so, sd, lim)

    # times and bounds on the spread rays and their shadow rays
    o, d, so, sd, lim = rays["spread"]
    best, plo, phi = bvh_paged.paged_top_closest(cs, o, d, 1e-3, 1e6)
    found, alo, ahi = bvh_paged.paged_top_any(cs, so, sd, 1e-3, lim)
    check_counter("the top walks (K6a, K6b)", device)
    n = N_RAYS
    zero = torch.zeros(n, device=device)
    seed = ClosestRecord(lim, torch.full((n,), -1, dtype=torch.int32, device=device), zero, zero,
                         V3(zero, zero, zero))
    unfound = torch.zeros(n, dtype=torch.bool, device=device)
    calls = {
        "paged_top_closest": (lambda: bvh_paged.paged_top_closest(cs, o, d, 1e-3, 1e6),
                              lambda: bvh_paged.paged_top_closest_plain(cs, o, d, 1e-3, 1e6)),
        "pages_closest": (lambda: bvh_paged.pages_closest(cs, o, d, 1e-3, best, plo, phi),
                          lambda: bvh_paged.pages_closest_plain(cs, o, d, 1e-3, best, plo, phi)),
        "paged_top_any": (lambda: bvh_paged.paged_top_any(cs, so, sd, 1e-3, lim),
                          lambda: bvh_paged.paged_top_any_plain(cs, so, sd, 1e-3, lim)),
        "pages_any": (lambda: bvh_paged.pages_any(cs, so, sd, 1e-3, lim, found, alo, ahi),
                      lambda: bvh_paged.pages_any_plain(cs, so, sd, 1e-3, lim, found, alo, ahi)),
        "K4c": (lambda: bvh_paged.pages_closest(cs, so, sd, 1e-3, seed),
                lambda: bvh_paged.pages_closest_plain(cs, so, sd, 1e-3, seed)),
        "K4d": (lambda: bvh_paged.pages_any(cs, so, sd, 1e-3, lim, unfound),
                lambda: bvh_paged.pages_any_plain(cs, so, sd, 1e-3, lim, unfound)),
    }
    symbols = {"paged_top_closest": "paged_top_closest_persistent",
               "pages_closest": "pages_closest_persistent",
               "paged_top_any": "paged_top_any_persistent", "pages_any": "pages_any_persistent",
               "K4c": "pages_closest_persistent", "K4d": "pages_any_persistent"}
    times = {name: timed(k, symbols[name], p, PLAIN_REPS) for name, (k, p) in calls.items()}
    routes = {
        "K6 closest": lambda: bvh.scene_closest(cs, o, d, 1e-3, 1e6),
        "K4a whole tree": lambda: bvh.scene_closest(flat, o, d, 1e-3, 1e6),
        "K6 any": lambda: bvh.scene_any(cs, so, sd, 1e-3, lim),
        "K4b whole tree": lambda: bvh.scene_any(flat, so, sd, 1e-3, lim),
    }
    c_o, c_d, c_thr, c_key, c_depth = chunk
    tables = bounce_bvh.pack_bvh_tables(flat)
    routes["K5 + K4b, first chunk"] = lambda: bounce_bvh.path_bounce_bvh(
        flat, tables, c_o, c_d, c_thr, c_key, c_depth, shadow_light=True)
    routes["plain bounce (K6), first chunk"] = lambda: bounce.path_bounce_plain(
        cs, c_o, c_d, c_thr, c_key, c_depth, shadow_light=True)
    route_ms = {name: cuda_ms(fn) for name, fn in routes.items()}
    for name, rec in times.items():
        show_time(name, rec, f" (config 6; plain median of {PLAIN_REPS})")
    print("[big] routes (ms, median of 25): " + "; ".join(
        f"{k} {v:.4f}" for k, v in route_ms.items()))

    # bounds: the tests the plain walks count on the same rays; the bytes of
    # the lane records each lane must read and write.  A lane reads its ray
    # only where the answer depends on it: K6c/K4c where a page is pending or
    # the bound is positive, K6b/K6d/K4d where the lane is not already found
    # and has a page to walk (K6d) or a positive limit.  Beside the page
    # walks' bounds, their tree traffic (tree_ms) from the same counts: a
    # quarter of a 128 B node record a box test, a 64 B padded slot record a
    # triangle test (the packed 52 B record's figure beside it)
    top_c, page_c, top_a, page_a, k4c_c, k4d_c = ({} for _ in range(6))
    bvh_paged.paged_top_closest_plain(cs, o, d, 1e-3, 1e6, counts=top_c)
    bvh_paged.pages_closest_plain(cs, o, d, 1e-3, best, plo, phi, counts=page_c)
    bvh_paged.paged_top_any_plain(cs, so, sd, 1e-3, lim, counts=top_a)
    bvh_paged.pages_any_plain(cs, so, sd, 1e-3, lim, found, alo, ahi, counts=page_a)
    bvh_paged.pages_closest_plain(cs, so, sd, 1e-3, seed, counts=k4c_c)
    bvh_paged.pages_any_plain(cs, so, sd, 1e-3, lim, unfound, counts=k4d_c)
    def walk_ops(c):
        return BOX_FLOPS * c.get("boxes", 0) + TEST_FLOPS[3] * c.get("tri_tests", 0)

    care = int((lim > 0).sum())
    pend = int(((plo != 0) | (phi != 0)).sum())
    unf = int((~found).sum())
    walks = int((~found & ((alo != 0) | (ahi != 0))).sum())
    bounds = {  # ray 24 B, limit 4, closest record 28, masks 8, found 1
        "paged_top_closest": bound_ms(sweep_flops(cs, o, d, 1e6, False, kinds=3)
                                      + walk_ops(top_c), n * (24 + 28 + 8)),
        "pages_closest": bound_ms(walk_ops(page_c), n * (8 + 28 + 28) + pend * 24),
        "paged_top_any": bound_ms(sweep_flops(cs, so, sd, lim, True, lim > 0, kinds=3)
                                  + walk_ops(top_a), n * (4 + 1 + 8) + care * 24),
        "pages_any": bound_ms(walk_ops(page_a), n * (1 + 1) + unf * 8 + walks * (24 + 4)),
        "K4c": bound_ms(walk_ops(k4c_c), n * (28 + 28) + care * 24),
        "K4d": bound_ms(walk_ops(k4d_c), n * (1 + 1 + 4) + care * 24),
    }
    print("[big] bounds (ms): " + "; ".join(f"{k} {v[0]:.5f} ({v[1]})" for k, v in bounds.items())
          + f"; lanes: {pend} pending (K6c), {unf} unfound and {walks} with pages (K6d), {care} "
          f"with limit > 0; tests counted: top {top_c}, pages {page_c}, top any {top_a}, pages "
          f"any {page_a}, K4c {k4c_c}, K4d {k4d_c}")
    page_walks = {"pages_closest": page_c, "pages_any": page_a, "K4c": k4c_c, "K4d": k4d_c}
    for name, c in page_walks.items():
        times[name]["tree_ms"] = tree_ms(c, 64)
    print("[big] page walks' tree traffic (ms; 64 B padded slots, 52 B packed): " + "; ".join(
        f"{k} {tree_ms(c, 64):.5f} ({tree_ms(c, 52):.5f})" for k, c in page_walks.items()))
    print("[big] page walk plans at N=" + str(N_RAYS) + ": " + "; ".join(
        f"{k} depth {depth} -> class {p.depth_class}, stage {p.stage}, {per_sm} blocks of 256 a "
        f"SM ({256 * per_sm} lanes), grid {grid}"
        for k, (depth, p, per_sm, grid) in page_walk_plans(cs).items()))
    show_top_plans("[big]", cs)
    check_counter("config 6's walks", device)
    return scene, cam, times, bounds, err, route_ms


def phase_big_main(device, scene, cam):
    """Config 6's path at full width (spp cut to one B_SPP-sample group),
    then the profile of a one-sample frame."""
    import numpy as np
    import torch

    import path_tracing__ray_tracer_tpu_torch as pt
    from path_tracing__ray_tracer_tpu_torch.models.wavefront import chunk_pixels
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import bvh_paged

    r = pt.RendererFactory.create("cuda_path_raytracer", sample_group=B_SPP,
                                  chunk_rays=CHUNK_RAYS, shadow_tmax="light", seed=0,
                                  compile_overrides={"use_bvh": True}, device=device)
    t0 = time.perf_counter()
    r.render_sums(scene, cam, pt.RenderSettings(256, 144, 2, M_DEPTH))  # + the scene compile
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    sums = r.render_sums(scene, cam, pt.RenderSettings(M_WIDTH, M_HEIGHT, B_SPP, M_DEPTH))
    secs = time.perf_counter() - t0
    launched = counts()
    peak = torch.cuda.max_memory_allocated() / 2**20
    mrays = M_WIDTH * M_HEIGHT * B_SPP * M_DEPTH / secs / 1e6
    mean = sums.mean(axis=0) / B_SPP
    k6 = {k: launched[k] for k in ("paged_top_closest", "pages_closest", "paged_top_any",
                                   "pages_any")}
    print(f"[big] config-6 path {M_WIDTH}x{M_HEIGHT} depth {M_DEPTH} shadow_tmax=light, one "
          f"{B_SPP}-sample group: warm-up (compile + 256x144, 2 spp) {warm:.3f} s, timed "
          f"{secs:.3f} s -> {mrays:.2f} Mrays/s (W*H*spp*depth/t); launches {k6}, K5 "
          f"{launched['path_bounce_bvh']}; each on the chunk's "
          f"{chunk_pixels(M_WIDTH * M_HEIGHT, B_SPP, CHUNK_RAYS)} lanes (chunk_pixels); peak "
          f"device memory {peak:.0f} MiB; mean radiance/sample {mean}")
    if sums.shape != (M_WIDTH * M_HEIGHT, 3) or not np.isfinite(sums).all() or (sums < 0).any():
        raise SystemExit("chip_smoke: config-6 sums are not finite and non-negative")
    if not 0.01 < float(mean.mean()) < 20.0:
        raise SystemExit(f"chip_smoke: implausible config-6 mean radiance {mean}")
    if not all(k6.values()) or launched["path_bounce_bvh"]:
        raise SystemExit("chip_smoke: config 6's path must launch K6a-d and not K5")
    r.sample_group = MESH_PROFILE_SPP
    profile_frame("[big]", r, scene, cam,
                  pt.RenderSettings(M_WIDTH, M_HEIGHT, MESH_PROFILE_SPP, M_DEPTH),
                  lambda: bvh_paged.paged_top_closest.launches,
                  {"K6a": "paged_top_closest_persistent", "K6c": "pages_closest_persistent",
                   "K6b": "paged_top_any_persistent", "K6d": "pages_any_persistent"}, top=3)
    return k6, secs, mrays


def phase_512k_check(device):
    """The 512,000-triangle scene: set-up, more than 32 pages, K6 against the
    one-level K4a/K4b on camera rays over the frame and their shadow rays,
    K4a against the plain walk on a slice."""
    import torch

    from path_tracing__ray_tracer_tpu_torch.ops.cuda import bvh
    from path_tracing__ray_tracer_tpu_torch.ops.intersect import scene_hit_bvh_plain

    t0 = time.perf_counter()
    _scene, cam, cs, compile_s = big_scene(device, K512_SUB)
    if cs.bvh.paged.n_pages <= 32:
        raise SystemExit("chip_smoke: the 512K scene must page into more than 32 pages")
    flat = one_level(cs)
    o, d, _t, key, depth = camera_state(cs, cam, N_RAYS, device, M_WIDTH, M_HEIGHT, M_DEPTH)
    got = bvh.scene_closest(cs, o, d, 1e-3, 1e6)
    want = bvh.scene_closest(flat, o, d, 1e-3, 1e6)
    err = check_hits("512K: K6 closest vs K4a whole tree", got, want)
    check_pend("512K", cs, o, d, got.t)
    so, sd, lim = mesh_shadow(cs, o, d, key, depth, got)
    err = max(err, check_occ("512K: K6 any vs K4b whole tree", bvh.scene_any(cs, so, sd, 1e-3, lim),
                             bvh.scene_any(flat, so, sd, 1e-3, lim), lim > 0))
    idx = torch.arange(min(16384, o.x.shape[0]), device=device)
    ok, dk = o.take(idx), d.take(idx)
    t1 = time.perf_counter()
    plain = scene_hit_bvh_plain(cs, ok, dk, 1e-3, 1e6)
    plain_s = time.perf_counter() - t1
    check_hits(f"512K: K4a vs plain walk on {idx.numel()} rays ({plain_s:.2f} s)",
               bvh.scene_closest(flat, ok, dk, 1e-3, 1e6), plain)
    ms = {"K6 closest": cuda_ms(lambda: bvh.scene_closest(cs, o, d, 1e-3, 1e6), 5),
          "K4a": cuda_ms(lambda: bvh.scene_closest(flat, o, d, 1e-3, 1e6), 5),
          "K6 any": cuda_ms(lambda: bvh.scene_any(cs, so, sd, 1e-3, lim), 5),
          "K4b": cuda_ms(lambda: bvh.scene_any(flat, so, sd, 1e-3, lim), 5)}
    print(f"[big] 512K: set-up {time.perf_counter() - t0:.2f} s (compile {compile_s:.2f} s); "
          "ms at N=131072 (median of 5): " + "; ".join(f"{k} {v:.4f}" for k, v in ms.items()))
    show_top_plans("[big] 512K:", cs)
    check_counter("the 512K scene's walks", device)
    return err


# the 48-page scene: MeshSceneBuilder(2, 2) with paging forced by these
# budgets (tests/test_torch_paged.py::test_pend_masks_cover_entered_pages),
# whose top leaves hold 168 triangles; config 6's and the 512K scene's top
# leaves hold none
P48_ONE_LEVEL, P48_PAGE = 2600, 450


def paged_48(device):
    """The 48-page scene compiled on ``device``."""
    import path_tracing__ray_tracer_tpu_torch as pt
    from path_tracing__ray_tracer_tpu_torch.ops import bvh as tbvh

    saved = tbvh.ONE_LEVEL_LIMIT, tbvh.PAGE_BUDGET_FLOATS
    tbvh.ONE_LEVEL_LIMIT, tbvh.PAGE_BUDGET_FLOATS = P48_ONE_LEVEL, P48_PAGE
    try:
        cs = pt.compile_scene(pt.MeshSceneBuilder(grid=2, subdivisions=2).build_scene(),
                              device=device)
    finally:
        tbvh.ONE_LEVEL_LIMIT, tbvh.PAGE_BUDGET_FLOATS = saved
    if cs.bvh.paged is None or cs.bvh.paged.n_pages != 48:
        raise SystemExit("chip_smoke: the 48-page scene did not page into 48 pages")
    return cs


def rays_48(n, seed, device):
    """``n`` rays from the box [-14, 14]³ in uniform directions, and their
    limits: uniform in [0, 40), every 7th -1, every 11th +inf."""
    import numpy as np
    import torch

    from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3

    g = np.random.default_rng(seed)
    ro = g.uniform(-14, 14, (n, 3)).astype(np.float32)
    rd = g.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    lim = (g.uniform(0, 40, n)).astype(np.float32)
    lane = np.arange(n)
    lim = np.where(lane % 11 == 0, np.inf, np.where(lane % 7 == 0, -1.0, lim)).astype(np.float32)
    o, d = (V3(*(torch.from_numpy(a[:, i].copy()).to(device) for i in range(3))) for a in (ro, rd))
    return o, d, torch.from_numpy(lim).to(device)


def phase_top_leaves_check(device):
    """The 48-page scene, whose top tree has real leaves: K6a and K6b,
    staged and read from device memory, against their plain versions (the
    record's winner on >= 99.99% of lanes, floats within tolerance; the
    pending words cover every page entered at the final t; occlusion on
    every ray that needs an answer at >= 99.99%, lanes with limit <= 0
    found), the two variants bit-equal; the lane counter left zero."""
    import torch

    from path_tracing__ray_tracer_tpu_torch.ops import bvh as tbvh
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import bvh_paged

    cs = paged_48(device)
    o, d, lim = rays_48(N_RAYS, 48, device)
    show_top_plans("[top48]", cs)
    out = {}
    for staged in (True, False):
        with top_variant(cs, staged):
            stage = bvh_paged.top_walk_plan(cs, bvh_paged.smem_limit(device)).stage
            out[stage] = (bvh_paged.paged_top_closest(cs, o, d, 1e-3, 1e6),
                          bvh_paged.paged_top_any(cs, o, d, 1e-3, lim))
    check_counter("the 48-page scene's top walks", device)
    if set(out) != {True, False}:
        raise SystemExit("chip_smoke: the 48-page scene's top walks took one variant only")
    def flat(x):
        return [x] if isinstance(x, torch.Tensor) else [t for part in x for t in flat(part)]

    same = all(same_bits(a, b) for a, b in zip(flat(out[True]), flat(out[False])))
    (best, plo, phi), (found, _alo, _ahi) = out[True]
    want, _wlo, _whi = bvh_paged.paged_top_closest_plain(cs, o, d, 1e-3, 1e6)
    agree = best.prim == want.prim  # the floats where both hit (a miss's attributes are unset)
    err = compare_fields("48 pages: K6a vs plain top walk", best, want, agree & (best.prim >= 0),
                         ("t", "normal", "u", "v"), verbose=False)
    print(f"[top48] K6a vs plain top walk: prim agree {float(agree.float().mean()):.6f} "
          f"({int((~agree).sum())} differ), max |diff| {err:.2e} where both hit")
    if float(agree.float().mean()) < HIT_AGREE:
        raise SystemExit("chip_smoke: 48 pages: K6a and the plain top walk disagree")
    top_tri = int((best.prim >= cs.n_planes + cs.n_spheres + cs.n_quads).sum())
    final = bvh_paged.pages_closest(cs, o, d, 1e-3, best, plo, phi)
    entered = tbvh.page_root_mask(cs.bvh.paged, o, d, 1e-3, final.t)
    missing = int(((entered & ~tbvh.pend_mask(plo, phi)) != 0).sum())
    want_found, _alo_p, _ahi_p = bvh_paged.paged_top_any_plain(cs, o, d, 1e-3, lim)
    care = lim > 0
    err = max(err, check_occ("48 pages: K6b vs plain top walk", found, want_found, care))
    print(f"[top48] {N_RAYS} rays: {top_tri} lanes won by a top-leaf triangle; pending words "
          f"cover the entered pages on {N_RAYS - missing} lanes ({int((phi != 0).sum())} with "
          f"pages past 31); {int((~care).sum())} lanes with limit <= 0 found "
          f"{bool(found[~care].all())}; staged and device-memory variants bit-equal: {same}")
    if missing or not same or not bool(found[~care].all()) or top_tri == 0:
        raise SystemExit("chip_smoke: the 48-page scene's top walks failed their check")
    return err


def phase_mesh_oracle(device):
    """``cpu_raytracer`` on BVH scenes: the mesh oracle golden (made by the
    JAX oracle) and a config-5 frame, which must launch K4a and K4b."""
    import numpy as np

    import path_tracing__ray_tracer_tpu_torch as pt

    b = pt.MeshSceneBuilder(grid=2, subdivisions=1)
    golden = np.load(ROOT / "tests" / "goldens" / "torch_mesh_oracle.npy")
    r = pt.RendererFactory.create("cpu_raytracer", seed=42, device=device)
    img = np.asarray(r.render(b.build_scene(), b.create_camera(4.0 / 3.0),
                              pt.RenderSettings(*MO_GOLDEN)))
    diff = np.abs(img.astype(np.int32) - golden.astype(np.int32))
    share = float((diff > 2).mean())
    b5 = pt.MeshSceneBuilder(grid=3, subdivisions=3)
    r = pt.RendererFactory.create("cpu_raytracer", seed=0, device=device)
    scene = b5.build_scene()
    r.compiled(scene)
    reset_counts()
    t0 = time.perf_counter()
    sums = r.render_sums(scene, b5.create_camera(MO_WIDTH / MO_HEIGHT),
                         pt.RenderSettings(MO_WIDTH, MO_HEIGHT, MO_SPP, MO_DEPTH))
    secs = time.perf_counter() - t0
    launched = counts()
    print(f"[oracle] mesh golden {MO_GOLDEN}: {share:.5f} of channels differ by >2/255 (max "
          f"{int(diff.max())}); config-5 {MO_WIDTH}x{MO_HEIGHT} {MO_SPP} spp depth {MO_DEPTH}: "
          f"{secs:.3f} s, launches K4a {launched['scene_closest']}, K4b {launched['scene_any']}")
    if img.shape != golden.shape or share >= 0.01:
        raise SystemExit("chip_smoke: the mesh oracle is outside the golden tolerance")
    if not np.isfinite(sums).all() or (sums < 0).any() or not float(sums.mean()) > 0:
        raise SystemExit("chip_smoke: the mesh oracle's sums are not finite and positive")
    if not (launched["scene_closest"] and launched["scene_any"]):
        raise SystemExit("chip_smoke: the mesh oracle did not launch K4a and K4b")


# ---- K4e / K11: the split BVH route on config 5 ----------------------------------
def check_walk(label, t, tri, want):
    """A triangle walk's ``(t, tri)`` against the plain one: misses equal on
    every lane, the winner on >= 99.99%, ``t`` within tolerance where the
    winners agree; returns max |diff| of ``t`` there."""
    want_t, want_tri = want
    misses = int(((tri < 0) != (want_tri < 0)).sum())
    same = tri == want_tri
    share = float(same.float().mean())
    diff = (t - want_t).abs()[same]
    bad = int((diff > TOL + TOL * want_t.abs()[same]).sum())
    worst = float(diff.max()) if diff.numel() else 0.0
    print(f"[split]   {label}: misses differ on {misses} lanes, winner agree {share:.6f} "
          f"({int((~same).sum())} differ), hit {float((tri >= 0).float().mean()):.4f}, max |t diff| "
          f"{worst:.2e} ({bad} out of tolerance)")
    if misses or share < HIT_AGREE or bad:
        raise SystemExit(f"chip_smoke: {label} disagrees with its plain version")
    return worst


def split_passes(cs, o, d):
    """The multipass walk's three passes as ``(roots, en)``: the depth-2
    subtree each ray enters first, the one it enters second, the root."""
    import torch

    from path_tracing__ray_tracer_tpu_torch.ops import bvh as tbvh

    table, valid = tbvh.subtree_nodes(cs.bvh.nodes4)
    passes = []
    for s in tbvh.subtree_keys2(cs.bvh.nodes4, o, d):
        sc = torch.clamp(s, 0, 15).long()
        en = valid[sc] & (s < 16)
        passes.append((torch.where(en, table[sc], 0).to(torch.int32).contiguous(), en))
    zero = torch.zeros_like(passes[0][0])
    return passes + [(zero, torch.ones_like(zero, dtype=torch.bool))]


def split_check_rays(cs, label, o, d, key, depth, err, cnt=None):
    """K4e and K11 against their plain versions on the rays ``(o, d)`` and
    their light-sample shadow rays; folds each kernel's max |t diff| into
    ``err``.  Returns ``(so, sd, lim, carried)``: the shadow rays and K11's
    three passes' inputs.  ``cnt`` collects the plain walks' tests."""
    import torch

    from path_tracing__ray_tracer_tpu_torch.ops import bvh as tbvh
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import bvh, bvh2, bvh_paged
    from path_tracing__ray_tracer_tpu_torch.ops.intersect import ClosestRecord
    from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3

    cnt = cnt if cnt is not None else {"closest": {}, "any": {}, "rooted": {}}
    device, n, tris = o.x.device, o.x.shape[0], cs.triangles
    print(f"[split] {label}:")
    so, sd, lim = mesh_shadow(cs, o, d, key, depth)
    want = tbvh.traverse_closest(cs.bvh, tris, o, d, 1e-3, 1e6, counts=cnt["closest"])
    u = torch.rand(n, generator=torch.Generator(device=device).manual_seed(5), device=device)
    bound = (want[0] * (0.5 + u)).contiguous()  # about half of the hits lie beyond it
    want_ray = tbvh.traverse_closest(cs.bvh, tris, o, d, 1e-3, bound)
    occ_sets = (("one light-sample shadow ray per lane", so, sd, lim,
                 tbvh.traverse_any(cs.bvh, tris, so, sd, 1e-3, lim, counts=cnt["any"])),
                ("the rays themselves, limit the per-ray bound", o, d, bound,
                 tbvh.traverse_any(cs.bvh, tris, o, d, 1e-3, bound)))

    def fold(name, x):
        err[name] = max(err.get(name, 0.0), x)

    for w in (bvh2.closest_skiplink, bvh2.closest_ordered):
        fold(w.__name__, check_walk(f"{w.__name__}, t_max 1e6", *w(cs, o, d, 1e-3, 1e6), want))
        fold(w.__name__, check_walk(f"{w.__name__}, per-ray bound", *w(cs, o, d, 1e-3, bound),
                                    want_ray))
    for w in (bvh2.any_skiplink, bvh2.any_ordered):
        for what, ao, ad, alim, want_occ in occ_sets:
            occ, need = w(cs, ao, ad, 1e-3, alim), alim > 0
            differ = int((occ != want_occ)[need].sum())
            print(f"[split]   {w.__name__}, {what}: occlusion differs on {differ} of "
                  f"{int(need.sum())} rays that need an answer, occluded "
                  f"{float(occ[need].float().mean()):.4f}; lanes that need none report occluded: "
                  f"{bool(occ[~need].all())}")
            if differ or not bool(occ[~need].all()):
                raise SystemExit(f"chip_smoke: {w.__name__} disagrees with its plain version")
        fold(w.__name__, 0.0)
    # K11: each pass from the kernel's carried state against the plain pass
    passes = split_passes(cs, o, d)
    bt = torch.full((n,), 1e6, dtype=torch.float32, device=device)
    bi = torch.full((n,), -1, dtype=torch.int32, device=device)
    carried = []
    for k, (roots, en) in enumerate(passes):
        carried.append((roots, en, bt, bi))
        got = bvh.closest_rooted(cs, o, d, 1e-3, roots, en, bt, bi)
        plain = tbvh.rooted(cs.bvh, tris, o, d, 1e-3, roots, en, bt, bi, counts=cnt["rooted"])
        fold("closest_rooted", check_walk(
            f"closest_rooted pass {k + 1} ({int(en.sum())} lanes, "
            f"{int(torch.unique(roots[en]).numel())} roots)", *got, plain))
        bt, bi = got
    hit = bi >= 0  # lanes whose winner the two subtree passes had already found
    found = float(((carried[2][3] == bi) & hit).sum()) / max(int(hit.sum()), 1)
    off = cs.n_planes + cs.n_spheres + cs.n_quads
    zero = torch.zeros((n,), dtype=torch.float32, device=device)
    seed = ClosestRecord(torch.full((n,), 1e6, dtype=torch.float32, device=device),
                         torch.full((n,), -1, dtype=torch.int32, device=device), zero, zero,
                         V3(zero, zero, zero))
    one = bvh_paged.pages_closest(cs, o, d, 1e-3, seed)
    t_mp, i_mp = bvh.multipass_closest(cs, o, d, 1e-3, seed.t)
    fold("closest_rooted", check_walk(
        f"multipass (three K11 passes; {100 * found:.2f}% of the hits found before the cleanup "
        f"pass) against the single-pass K4c", t_mp, i_mp,
        (one.t, torch.where(one.prim >= 0, one.prim - off, -1))))
    check_walk("multipass against the plain skip-link walk", t_mp, i_mp, want)
    return so, sd, lim, carried


def aimed_rays(cs, o, key):
    """Rays from the origins ``o`` at a random point of a random triangle
    each (seed 6): nearly every one hits the mesh, at grazing angles too.
    Returns ``(o, d, key, depth)`` with depth 1, a path's second ray."""
    import torch

    from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3

    n, device = o.x.shape[0], o.x.device
    g = torch.Generator(device=device).manual_seed(6)
    idx = torch.randint(0, cs.n_triangles, (n,), generator=g, device=device)
    r1, r2 = torch.rand(2, n, generator=g, device=device)
    s1 = torch.sqrt(r1)  # uniform over the triangle
    tri = cs.triangles
    p = (tri.v0.take(idx) * (1.0 - s1) + tri.v1.take(idx) * (s1 * (1.0 - r2))
         + tri.v2.take(idx) * (s1 * r2))
    d = (p - o).normalized()
    depth = torch.ones((n,), dtype=torch.int32, device=device)
    return o, V3(*(c.contiguous() for c in (d.x, d.y, d.z))), key, depth


def phase_split_check(device):
    """K4e (skip-link and ordered walks) and K11 against their plain
    versions on config 5, at 131,072 camera rays over the 1920x1080 frame,
    the secondary rays of those (one plain bounce on) and rays from those
    secondary origins aimed at the mesh, each set with its light-sample
    shadow rays; then their times and bounds on the camera rays."""
    import torch

    from path_tracing__ray_tracer_tpu_torch.ops import bvh as tbvh
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import bvh, bvh2, bvh_leafmat, bvh_paged
    from path_tracing__ray_tracer_tpu_torch.ops.intersect import ClosestRecord
    from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3

    _scene, cam, cs = mesh_scene(device)
    print(f"[split] config-5 scene: BVH2 {cs.bvh.n_nodes} nodes, depth {cs.bvh.depth2}; BVH4 "
          f"depth {cs.bvh.depth4}; default route {bvh.tri_route(cs)}")
    camera = camera_state(cs, cam, N_RAYS, device, M_WIDTH, M_HEIGHT, M_DEPTH)
    bo, bd, _bt, bkey, bdepth = advance_plain(cs, camera, 1)
    err = {}
    split_check_rays(cs, "their secondary rays (one plain bounce on, depth 1-3)", bo, bd, bkey,
                     bdepth, err)
    split_check_rays(cs, "rays from those origins aimed at random points of the mesh",
                     *aimed_rays(cs, bo, bkey), err)
    o, d, _t, key, depth = camera
    cnt = {"closest": {}, "any": {}, "rooted": {}}
    so, sd, lim, carried = split_check_rays(cs, "131,072 camera rays over the 1920x1080 frame",
                                            o, d, key, depth, err, cnt)
    n, care, tris = N_RAYS, lim > 0, cs.triangles
    zero = torch.zeros((n,), dtype=torch.float32, device=device)
    seed = ClosestRecord(torch.full((n,), 1e6, dtype=torch.float32, device=device),
                         torch.full((n,), -1, dtype=torch.int32, device=device), zero, zero,
                         V3(zero, zero, zero))

    def k4c():
        return bvh_paged.pages_closest(cs, o, d, 1e-3, seed)

    # times at N = 131,072: device time per launch and call time (median of
    # 25), plain call time (median of PLAIN_REPS); K11's call and plain times
    # are the three passes of one multipass walk
    plain_closest = cuda_ms(lambda: tbvh.traverse_closest(cs.bvh, tris, o, d, 1e-3, 1e6),
                            PLAIN_REPS, 1)
    plain_any = cuda_ms(lambda: tbvh.traverse_any(cs.bvh, tris, so, sd, 1e-3, lim), PLAIN_REPS, 1)
    plans = {"K11": (cs.bvh.depth4, bvh.rooted_plan(cs),
                     bvh.build().lib.ptrt_bvh4_rooted_occupancy),
             "K4e skip-link closest": (cs.bvh.depth2, bvh2.SKIPLINK_PLAN,
                                       bvh2.build().lib.ptrt_bvh2_skiplink_occupancy),
             "K4e skip-link occlusion": (cs.bvh.depth2, bvh2.SKIPLINK_PLAN,
                                         bvh2.build().lib.ptrt_bvh2_skiplink_any_occupancy),
             "K4e ordered closest": (cs.bvh.depth2, bvh2.ordered_plan(cs),
                                     bvh2.build().lib.ptrt_bvh2_closest_occupancy),
             "K4e ordered occlusion": (cs.bvh.depth2, bvh2.ordered_plan(cs),
                                       bvh2.build().lib.ptrt_bvh2_any_occupancy),
             "K10a": (cs.bvh.depth4, bvh_leafmat.scene_any_plan(cs),
                      bvh_leafmat.build().lib.ptrt_mat_scene_closest_occupancy),
             "K10b": (cs.bvh.depth4, bvh_leafmat.scene_any_plan(cs),
                      bvh_leafmat.build().lib.ptrt_mat_scene_any_occupancy),
             "K10c": (cs.bvh.depth4, bvh_leafmat.tri_plan(cs),
                      bvh_leafmat.build().lib.ptrt_mat_tri_closest_occupancy),
             "K10d": (cs.bvh.depth4, bvh_leafmat.tri_plan(cs),
                      bvh_leafmat.build().lib.ptrt_mat_tri_any_occupancy)}
    print(f"[split] persistent plans at N={n}: " + "; ".join(
        f"{k} depth {depth} -> class {plan.depth_class}, grid "
        f"{bvh.launch_grid(k, occupancy, plan, n, device)} blocks of {bvh.WALK_THREADS}"
        for k, (depth, plan, occupancy) in plans.items()))
    times = {
        "closest_skiplink": timed(lambda: bvh2.closest_skiplink(cs, o, d, 1e-3, 1e6),
                                  "bvh2_closest_skiplink_persistent"),
        "closest_ordered": timed(lambda: bvh2.closest_ordered(cs, o, d, 1e-3, 1e6),
                                 "bvh2_closest_persistent"),
        "any_skiplink": timed(lambda: bvh2.any_skiplink(cs, so, sd, 1e-3, lim),
                              "bvh2_any_skiplink_persistent"),
        "any_ordered": timed(lambda: bvh2.any_ordered(cs, so, sd, 1e-3, lim),
                             "bvh2_any_persistent"),
        "closest_rooted": timed(
            lambda: [bvh.closest_rooted(cs, o, d, 1e-3, *c) for c in carried],
            "bvh4_rooted_persistent",
            lambda: [tbvh.rooted(cs.bvh, tris, o, d, 1e-3, *c) for c in carried], PLAIN_REPS,
            per_call=len(carried)),
    }
    for name in ("closest_skiplink", "closest_ordered"):
        times[name]["plain_ms"] = plain_closest
    for name in ("any_skiplink", "any_ordered"):
        times[name]["plain_ms"] = plain_any
    for name, rec in times.items():
        show_time(name, rec, f" (plain median of {PLAIN_REPS})" + (
            "; call and plain: the three passes of one multipass walk"
            if name == "closest_rooted" else ""))
    per_pass = [cuda_ms(lambda c=c: bvh.closest_rooted(cs, o, d, 1e-3, *c)) for c in carried]
    mp_ms = cuda_ms(lambda: bvh.multipass_closest(cs, o, d, 1e-3, seed.t))
    k4c_ms, k4a_ms = cuda_ms(k4c), cuda_ms(lambda: bvh.scene_closest(cs, o, d, 1e-3, 1e6))
    print(f"[time] K11 passes {', '.join(f'{x:.4f}' for x in per_pass)} ms; the multipass walk "
          f"(keys + three launches) {mp_ms:.4f} ms against one K4c pass {k4c_ms:.4f} ms and K4a "
          f"(with the plane/sphere/quad sweep) {k4a_ms:.4f} ms")

    def walk_ops(c):
        return BOX_FLOPS * c.get("boxes", 0) + TEST_FLOPS[3] * c.get("tri_tests", 0)

    en_lanes = sum(int(c[1].sum()) for c in carried)
    walk_bounds = {  # ray 24 B, bound or limit 4, (t, tri) 8, occlusion 1, root 4, en 1
        "closest": bound_ms(walk_ops(cnt["closest"]), n * (24 + 8)),
        "any": bound_ms(walk_ops(cnt["any"]), n * (4 + 1) + int(care.sum()) * 24),
        "closest_rooted": bound_ms(walk_ops(cnt["rooted"]), 3 * n * (1 + 8 + 8)
                                   + en_lanes * (4 + 24)),
    }
    # K11's row is per launch: a third of the three passes' bound
    walk_bounds["closest_rooted"] = (walk_bounds["closest_rooted"][0] / 3,
                                     walk_bounds["closest_rooted"][1])
    bounds = {"closest_skiplink": walk_bounds["closest"],
              "closest_ordered": walk_bounds["closest"], "any_skiplink": walk_bounds["any"],
              "any_ordered": walk_bounds["any"], "closest_rooted": walk_bounds["closest_rooted"]}
    # the tree traffic the plain walks count: a 32 B BVH2 record a box test,
    # a slot record a triangle test (64 B from the padded copy the ordered
    # walks and K11 read, else 52 B); K11's a third of three passes
    trees = {"closest_skiplink": tree_ms(cnt["closest"], 52),
             "closest_ordered": tree_ms(cnt["closest"], 64),
             "any_skiplink": tree_ms(cnt["any"], 52), "any_ordered": tree_ms(cnt["any"], 64),
             "closest_rooted": tree_ms(cnt["rooted"], 64) / 3}
    for name, tree in trees.items():
        times[name]["tree_ms"] = tree
    print("[bound] split walks (ms): " + "; ".join(f"{k} {v[0]:.5f} ({v[1]})"
                                                 for k, v in walk_bounds.items())
          + "; tree traffic " + ", ".join(f"{k} {v:.5f}" for k, v in trees.items())
          + f"; tests counted by the plain walks: closest {cnt['closest']}, shadow {cnt['any']} "
          f"({int(care.sum())} rays need an answer), the three rooted passes {cnt['rooted']} "
          f"({en_lanes} lane walks)")
    return times, bounds, err


def split_render(device, label, scene, cam, settings, flags, kernels, compiled=None):
    """The config-5 mesh path with the route flags ``flags`` set (restored
    after): ``(uint8 image, seconds, Mrays/s, launches)``; fails when a
    kernel of ``kernels`` did not launch or K5 did while the route is not
    ``fused``.  ``compiled`` may alter the compiled scene first."""
    import numpy as np
    import torch

    import path_tracing__ray_tracer_tpu_torch as pt
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import bvh

    with bvh_set(**flags):
        r = pt.RendererFactory.create("cuda_path_raytracer", sample_group=settings.samples_per_pixel,
                                      chunk_rays=CHUNK_RAYS, shadow_tmax="light", seed=0,
                                      compile_overrides={"use_bvh": True}, device=device)
        cs = r.compiled(scene)
        if compiled is not None:
            r._scene_cache = {k: compiled(v) for k, v in r._scene_cache.items()}
            cs = r.compiled(scene)
        route = bvh.tri_route(cs)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        sums = r.render_sums(scene, cam, settings)
        secs = time.perf_counter() - t0
        launched = counts()
    spp, depth = settings.samples_per_pixel, settings.max_depth
    mrays = settings.width * settings.height * spp * depth / secs / 1e6
    shown = {k: launched[k] for k in (*kernels, "path_bounce_bvh", "scene_closest", "scene_any")}
    print(f"[split] {label}: route {route}, {settings.width}x{settings.height} {spp} spp depth "
          f"{depth}: {secs:.3f} s -> {mrays:.2f} Mrays/s (W*H*spp*depth/t); launches {shown}")
    if sums.shape != (settings.width * settings.height, 3) or not np.isfinite(sums).all() or (
            sums < 0).any():
        raise SystemExit(f"chip_smoke: {label}: sums are not finite and non-negative")
    if not all(launched[k] for k in kernels) or (route != "fused" and launched["path_bounce_bvh"]):
        raise SystemExit(f"chip_smoke: {label} did not launch {kernels}, or launched K5")
    return image_of(sums, spp), secs, mrays, launched


def golden_share(label, img, ref):
    """The share of channels off by more than 2/255 (the golden tolerance:
    under 1%)."""
    import numpy as np

    diff = np.abs(img.astype(np.int32) - ref.astype(np.int32))
    share = float((diff > 2).mean())
    print(f"[split]   {label} against the default route's image: {share:.5f} of channels differ "
          f"by >2/255 (max {int(diff.max())})")
    if img.shape != ref.shape or share >= 0.01:
        raise SystemExit(f"chip_smoke: {label} is outside the golden tolerance of the default")
    return share


def phase_split_main(device):
    """The config-5 mesh path at full width through the split route, forced
    by the flags: the BVH2 ordered walks (``BVH_QUAD = False``) and the
    multipass walk (``BVH_ATTRS = False, BVH_MULTIPASS = True``); then
    through the leaf coefficient table, K5 with K10b (``BVH_MXU_LEAF``) and
    the ``quad`` route's K10c + K10d, and that route's scalar twin K4c + K4d
    (``BVH_ATTRS = False``).  Each image against the default route's (K5)
    at the same seed; the twins a route replaces stay idle."""
    import path_tracing__ray_tracer_tpu_torch as pt

    scene, cam, _cs = mesh_scene(device)
    settings = pt.RenderSettings(M_WIDTH, M_HEIGHT, SPLIT_SPP, M_DEPTH)
    default, d_secs, d_mrays, _ = split_render(device, "default route", scene, cam, settings, {},
                                               ("path_bounce_bvh", "scene_any"))
    runs = {"default": (d_secs, d_mrays)}
    for label, flags, kernels in (  # MXU fused beside the default, MXU quad beside its twin
            (MXU_FUSED, dict(BVH_MXU_LEAF=True), ("path_bounce_bvh", "scene_any_mat")),
            (SPLIT_QUAD, dict(BVH_QUAD=False), ("closest_ordered", "any_ordered")),
            (SPLIT_MP, dict(BVH_ATTRS=False, BVH_MULTIPASS=True), ("closest_rooted", "pages_any")),
            (MXU_QUAD, dict(BVH_MXU_LEAF=True, BVH_ATTRS=False),
             ("tri_closest_mat", "tri_any_mat")),
            (SCALAR_QUAD, dict(BVH_ATTRS=False), ("pages_closest", "pages_any"))):
        img, secs, mrays, launched = split_render(device, label, scene, cam, settings, flags,
                                                  kernels)
        idle = {MXU_FUSED: ("scene_any",), MXU_QUAD: ("pages_closest", "pages_any"),
                SCALAR_QUAD: ("tri_closest_mat", "tri_any_mat")}.get(label, ())
        if any(launched[k] for k in idle):
            raise SystemExit(f"chip_smoke: {label} launched {idle}")
        runs[label] = (secs, mrays, golden_share(label, img, default), launched)
    return runs


def phase_split_fault(device):
    """A config-5 tree reported 33 levels deep (past the BVH4 walks' stack):
    routed to K4e, its queries and a path render answer without a raise,
    the render within the golden tolerance of the default route's."""
    import torch

    import path_tracing__ray_tracer_tpu_torch as pt
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import bvh

    scene, cam, cs = mesh_scene(device)
    deep = cs._replace(bvh=cs.bvh._replace(depth4=bvh.MAX_DEPTH4 + 1))
    o, d, _t, _k, _dp = camera_state(cs, cam, 4096, device, M_WIDTH, M_HEIGHT, M_DEPTH)
    got, want = bvh.scene_closest(deep, o, d, 1e-3, 1e6), bvh.scene_closest(cs, o, d, 1e-3, 1e6)
    occ = bvh.scene_any(deep, o, d, 1e-3, torch.full_like(o.x, 1e6))
    print(f"[split] depth4 {deep.bvh.depth4}: route {bvh.tri_route(deep)}; scene_hit on 4,096 "
          f"camera rays agrees with the default route on "
          f"{float((got.prim == want.prim).float().mean()):.6f} of them; scene_hit_any answered "
          f"({float(occ.float().mean()):.4f} of them hit something)")
    if bvh.tri_route(deep) != "ordered" or float((got.prim == want.prim).float().mean()) < HIT_AGREE:
        raise SystemExit("chip_smoke: a BVH4 deeper than the walks' stack is not routed to K4e")
    settings = pt.RenderSettings(FAULT_WIDTH, FAULT_HEIGHT, FAULT_SPP, M_DEPTH)
    ref, *_ = split_render(device, "default route", scene, cam, settings, {},
                           ("path_bounce_bvh", "scene_any"))
    img, *_rest, launched = split_render(
        device, f"depth4 {deep.bvh.depth4}, BVH_ORDERED = False", scene, cam, settings,
        dict(BVH_ORDERED=False), ("closest_skiplink", "any_skiplink"),
        compiled=lambda c: c._replace(bvh=c.bvh._replace(depth4=bvh.MAX_DEPTH4 + 1)))
    golden_share("the 33-deep tree's render", img, ref)
    return launched


# ---- K10: the BVH4 walks through the leaf coefficient table ---------------------
def mat_share(label, got, want):
    """A K10 closest record against its plain version: the winning primitive
    on >= 99.99% of lanes, ``t`` within tolerance where it agrees, the
    winner's normal and u, v where it is a hit (on a miss the kernel passes
    the carried record's through, the plain version writes its defaults);
    prints the share of lanes equal bit for bit; returns max |diff|."""
    same = got.prim == want.prim
    hit = same & (got.prim >= 0)
    attrs = (got.u == want.u) & (got.v == want.v)
    for a, b in zip(got.normal, want.normal):
        attrs = attrs & (a == b)
    bits = same & (got.t == want.t) & (attrs | (got.prim < 0))
    share, hits = float(same.float().mean()), float((got.prim >= 0).float().mean())
    print(f"[mxu]   {label}: prim agree {share:.6f} ({int((~same).sum())} differ), hit {hits:.4f}, "
          f"bit-equal {float(bits.float().mean()):.6f}")
    worst = max(compare_fields(label, got, want, same, ("t",)),
                compare_fields(label, got, want, hit, ("normal", "u", "v")))
    if share < HIT_AGREE:
        raise SystemExit(f"chip_smoke: {label} disagrees with its plain version")
    return worst


def occ_share(label, occ, want, need):
    """K10 occlusion against its plain version: equal on every ray in
    ``need`` (those whose answer the two report alike)."""
    differ = int((occ != want)[need].sum())
    print(f"[mxu]   {label}: occlusion differs on {differ} of {int(need.sum())} rays compared, "
          f"occluded {float(occ[need].float().mean()):.4f}")
    if differ:
        raise SystemExit(f"chip_smoke: {label} disagrees with its plain version")
    return 0.0


def twin_gap(label, got, twin):
    """K10 against its scalar twin K4 (reported only: the forms round
    differently from Möller–Trumbore): the share of equal winners and the
    largest ``t`` gap where they agree."""
    same = got.prim == twin.prim
    gap = (got.t - twin.t).abs()[same & (got.prim >= 0)]
    print(f"[mxu]   {label} against its K4 twin: winner equal {float(same.float().mean()):.6f}, "
          f"max |t gap| {float(gap.max()) if gap.numel() else 0.0:.3e}")


def mxu_check_rays(cs, label, o, d, key, depth, err):
    """K10a-d against their plain versions on the rays ``(o, d)`` (closest:
    t_max 1e6, and a per-ray bound for K10c) and their light-sample shadow
    rays (occlusion); each against its K4 twin, reported.  Folds max |diff|
    into ``err``; returns the shadow rays."""
    import torch

    from path_tracing__ray_tracer_tpu_torch.ops.cuda import bvh, bvh_leafmat, bvh_paged
    from path_tracing__ray_tracer_tpu_torch.ops.cuda.bvh_paged import (
        pages_any_plain, pages_closest_plain)
    from path_tracing__ray_tracer_tpu_torch.ops.intersect import (
        ClosestRecord, scene_hit_any_bvh_plain, scene_hit_bvh_plain)
    from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3

    n, device = o.x.shape[0], o.x.device
    print(f"[mxu] {label}:")
    so, sd, lim = mesh_shadow(cs, o, d, key, depth)
    need = lim > 0
    want_a = scene_hit_bvh_plain(cs, o, d, 1e-3, 1e6, mxu=True)
    u = torch.rand(n, generator=torch.Generator(device=device).manual_seed(7), device=device)
    zero = torch.zeros(n, device=device)
    seed = ClosestRecord((want_a.t * (0.5 + u)).contiguous(),
                         torch.full((n,), -1, dtype=torch.int32, device=device), zero, zero,
                         V3(zero, zero, zero))
    unfound = torch.zeros(n, dtype=torch.bool, device=device)

    def fold(name, x):
        err[name] = max(err.get(name, 0.0), x)

    got_a = bvh_leafmat.scene_closest(cs, o, d, 1e-3, 1e6)
    fold("scene_closest_mat", mat_share("K10a scene closest, t_max 1e6", got_a, want_a))
    twin_gap("K10a", got_a, bvh.scene_closest(cs, o, d, 1e-3, 1e6))
    occ = bvh_leafmat.scene_any(cs, so, sd, 1e-3, lim)
    fold("scene_any_mat", occ_share(
        "K10b scene occlusion, shadow rays that need an answer", occ,
        scene_hit_any_bvh_plain(cs, so, sd, 1e-3, lim, mxu=True), need))
    if not bool(occ[~need].all()):
        raise SystemExit("chip_smoke: K10b does not report the lanes that need no answer")
    twin = bvh.scene_any(cs, so, sd, 1e-3, lim)
    print(f"[mxu]   K10b against K4b: equal on {float((occ == twin)[need].float().mean()):.6f} "
          f"of the rays that need an answer")
    got_c = bvh_leafmat.tri_closest(cs, o, d, 1e-3, seed)
    fold("tri_closest_mat", mat_share("K10c triangle closest, per-ray bound", got_c,
                                      pages_closest_plain(cs, o, d, 1e-3, seed, mxu=True)))
    twin_gap("K10c", got_c, bvh_paged.pages_closest(cs, o, d, 1e-3, seed))
    occ = bvh_leafmat.tri_any(cs, so, sd, 1e-3, lim, unfound)
    fold("tri_any_mat", occ_share("K10d triangle occlusion, every shadow ray", occ,
                                  pages_any_plain(cs, so, sd, 1e-3, lim, unfound, mxu=True),
                                  torch.ones_like(need)))
    twin = bvh_paged.pages_any(cs, so, sd, 1e-3, lim, unfound)
    print(f"[mxu]   K10d against K4d: equal on {float((occ == twin).float().mean()):.6f} of rays")
    return so, sd, lim, seed


def phase_mxu_check(device):
    """K10a-d against their plain versions on config 5, on the ray sets of
    ``phase_split_check`` (camera rays over the 1920x1080 frame, their
    secondary rays, rays from those origins aimed at the mesh), each with its
    light-sample shadow rays; then the times of each K10 kernel, its plain
    version and its K4 twin on the camera rays, and the bounds."""
    import torch

    from path_tracing__ray_tracer_tpu_torch.ops.cuda import bvh, bvh_leafmat, bvh_paged
    from path_tracing__ray_tracer_tpu_torch.ops.cuda.bvh_paged import (
        pages_any_plain, pages_closest_plain)
    from path_tracing__ray_tracer_tpu_torch.ops.intersect import (
        scene_hit_any_bvh_plain, scene_hit_bvh_plain)

    _scene, cam, cs = mesh_scene(device)
    mat = cs.bvh.leaf_mat
    print(f"[mxu] config-5 leaf table: {tuple(mat.shape)} f32, {mat.numel() * 4 / 1e6:.2f} MB "
          f"({mat.shape[1] // 128} leaves) beside {cs.bvh.slot_rec.numel() * 4 / 1e6:.2f} MB of "
          f"slot records")
    camera = camera_state(cs, cam, N_RAYS, device, M_WIDTH, M_HEIGHT, M_DEPTH)
    bo, bd, _bt, bkey, bdepth = advance_plain(cs, camera, 1)
    err = {}
    mxu_check_rays(cs, "their secondary rays (one plain bounce on)", bo, bd, bkey, bdepth, err)
    mxu_check_rays(cs, "rays from those origins aimed at random points of the mesh",
                   *aimed_rays(cs, bo, bkey), err)
    o, d, _t, key, depth = camera
    so, sd, lim, seed = mxu_check_rays(cs, "131,072 camera rays over the 1920x1080 frame", o, d,
                                       key, depth, err)
    n = N_RAYS
    unfound = torch.zeros(n, dtype=torch.bool, device=device)
    calls = {  # kernel, plain version, K4 twin (the K4b twin is the persistent K4b)
        "scene_closest_mat": ((lambda: bvh_leafmat.scene_closest(cs, o, d, 1e-3, 1e6),
                               "mat_scene_closest_persistent"),
                              lambda: scene_hit_bvh_plain(cs, o, d, 1e-3, 1e6, mxu=True),
                              (lambda: bvh.scene_closest(cs, o, d, 1e-3, 1e6),
                               "bvh_closest_persistent")),
        "scene_any_mat": ((lambda: bvh_leafmat.scene_any(cs, so, sd, 1e-3, lim),
                           "mat_scene_any_persistent"),
                          lambda: scene_hit_any_bvh_plain(cs, so, sd, 1e-3, lim, mxu=True),
                          (lambda: bvh.scene_any(cs, so, sd, 1e-3, lim), "bvh_any_persistent")),
        "tri_closest_mat": ((lambda: bvh_leafmat.tri_closest(cs, o, d, 1e-3, seed),
                             "mat_tri_closest_persistent"),
                            lambda: pages_closest_plain(cs, o, d, 1e-3, seed, mxu=True),
                            (lambda: bvh_paged.pages_closest(cs, o, d, 1e-3, seed),
                             "pages_closest_persistent")),
        "tri_any_mat": ((lambda: bvh_leafmat.tri_any(cs, so, sd, 1e-3, lim, unfound),
                         "mat_tri_any_persistent"),
                        lambda: pages_any_plain(cs, so, sd, 1e-3, lim, unfound, mxu=True),
                        (lambda: bvh_paged.pages_any(cs, so, sd, 1e-3, lim, unfound),
                         "pages_any_persistent")),
    }
    times, twins = {}, {}
    for name, (kernel, plain, twin) in calls.items():
        times[name] = timed(*kernel, plain, PLAIN_REPS)
        # kernel and twin in turns (kernel, twin, twin, kernel), by device time
        k_ms, twins[name], each = in_turns(kernel, twin)
        times[name]["twin_ms"] = twins[name]
        show_time(name, times[name], f" (plain median of {PLAIN_REPS}); in turns with its K4 "
                  f"twin (device ms {', '.join(f'{x:.4f}' for x in each)}): {k_ms:.4f} against "
                  f"{twins[name]:.4f} -> {k_ms / twins[name]:.2f}x")

    # bounds: the slot visits the plain walks with the table count, at the
    # forms' uv test; bytes of the lane records only (no tree or table record)
    cnt = {name: {} for name in calls}
    scene_hit_bvh_plain(cs, o, d, 1e-3, 1e6, counts=cnt["scene_closest_mat"], mxu=True)
    scene_hit_any_bvh_plain(cs, so, sd, 1e-3, lim, counts=cnt["scene_any_mat"], mxu=True)
    pages_closest_plain(cs, o, d, 1e-3, seed, counts=cnt["tri_closest_mat"], mxu=True)
    pages_any_plain(cs, so, sd, 1e-3, lim, unfound, counts=cnt["tri_any_mat"], mxu=True)

    def walk_ops(c):
        return BOX_FLOPS * c.get("boxes", 0) + MAT_UV_FLOPS * c.get("tri_tests", 0)

    care = lim > 0
    ncare = int(care.sum())
    bounds = {  # ray 24 B, limit 4, closest record 28, occlusion 1, found 1
        "scene_closest_mat": bound_ms(sweep_flops(cs, o, d, 1e6, False, kinds=3)
                                      + walk_ops(cnt["scene_closest_mat"]), n * (24 + 28)),
        "scene_any_mat": bound_ms(sweep_flops(cs, so, sd, lim, True, care, kinds=3)
                                  + walk_ops(cnt["scene_any_mat"]), n * (4 + 1) + ncare * 24),
        "tri_closest_mat": bound_ms(walk_ops(cnt["tri_closest_mat"]), n * (24 + 28 + 28)),
        "tri_any_mat": bound_ms(walk_ops(cnt["tri_any_mat"]), n * (1 + 1 + 4) + ncare * 24),
    }
    print("[bound] K10 walks (ms): " + "; ".join(f"{k} {v[0]:.5f} ({v[1]})"
                                               for k, v in bounds.items())
          + f"; tests counted by the plain walks: {cnt} ({ncare} shadow rays need an answer)")
    return times, bounds, err, twins


def phase_mxu_whitted(device):
    """Config 5's mesh Whitted frame (480x270, 4 spp, depth 16, seed 0) on
    the default route and with ``BVH_MXU_LEAF`` (K10a, K10b), the second
    image within the golden tolerance of the first; K4a/K4b idle in it."""
    import numpy as np
    import torch

    import path_tracing__ray_tracer_tpu_torch as pt

    b = pt.MeshSceneBuilder(grid=3, subdivisions=3)
    scene, cam = b.build_scene(), b.create_camera(MW_WIDTH / MW_HEIGHT)
    settings = pt.RenderSettings(MW_WIDTH, MW_HEIGHT, MW_SPP, MW_DEPTH)
    imgs = {}
    for flag in (False, True):
        with bvh_set(BVH_MXU_LEAF=flag):
            r = pt.RendererFactory.create("cuda_texture_raytracer", seed=0, device=device)
            r.compiled(scene)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            imgs[flag] = np.asarray(r.render(scene, cam, settings))
            secs = time.perf_counter() - t0
            launched = counts()
        shown = {k: launched[k] for k in ("scene_closest", "scene_any", "scene_closest_mat",
                                          "scene_any_mat")}
        print(f"[mxu] mesh Whitted {MW_WIDTH}x{MW_HEIGHT} {MW_SPP} spp depth {MW_DEPTH}, "
              f"BVH_MXU_LEAF = {flag}: {secs:.3f} s; launches {shown}")
    if not (launched["scene_closest_mat"] and launched["scene_any_mat"]) or (
            launched["scene_closest"] or launched["scene_any"]):
        raise SystemExit("chip_smoke: the MXU mesh Whitted frame did not take K10a and K10b alone")
    golden_share("the MXU mesh Whitted frame", imgs[True], imgs[False])
    return launched


# ---- the scheduler modes: K7, K8, K9 -----------------------------------------
def atlas_route_budget(scene):
    """The largest ``texture_budget`` whose atlas fits the atlas route's
    ``MAX_ROWS`` rows of 128 texels (budgets from 1 to 4096)."""
    from path_tracing__ray_tracer_tpu_torch.compiler import _build_atlas, collect_texture_paths
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import texture

    paths = collect_texture_paths(scene)
    lo, hi = 1, 4096
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if -(-_build_atlas(paths, mid)[0].shape[0] // 128) <= texture.MAX_ROWS:
            lo = mid
        else:
            hi = mid - 1
    return lo


def step_leaves(out):
    for x in out:
        yield from (step_leaves(x) if isinstance(x, tuple) else (x,))


def check_step(label, got, want):
    """K7's 38 outputs against the plain version's: integer and 0/1 outputs
    equal on every lane, floats within tolerance (the next record's
    geometry on its hit lanes, where the scheduler reads it); returns max
    |diff| and whether the floats are bit-equal on those lanes."""
    import torch

    got, want = list(step_leaves(got)), list(step_leaves(want))
    hit = want[1] > 0.5
    worst, bad, int_bad, bit_equal = 0.0, 0, 0, True
    for k, (a, b) in enumerate(zip(got, want)):
        if a.dtype != torch.float32 or k in (1, 2):
            int_bad += int((a != b).sum())
            continue
        m = hit if 3 <= k <= 15 else torch.ones_like(hit)
        bit_equal = bit_equal and torch.equal(a[m], b[m])
        diff = (a - b).abs()[m]
        bad += int((diff > TOL + TOL * b.abs()[m]).sum())
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
    print(f"[modes] path_step, {label}: {int_bad} integer/flag values differ, {bad} floats out "
          f"of tolerance, max |diff| {worst:.3e}, floats bit-equal on those lanes {bit_equal}")
    if int_bad or bad:
        raise SystemExit(f"chip_smoke: K7 disagrees with its plain version on {label}")
    return worst, bit_equal


def phase_modes_check(device):
    """K7 against its plain version on the main path's first chunk after
    ``MODE_STEPS`` plain fused steps; K8 and K9 on that chunk's texel
    indices; times (kernel, plain, the library call) and bounds."""
    import torch

    import path_tracing__ray_tracer_tpu_torch as pt
    from path_tracing__ray_tracer_tpu_torch.models import experimental
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import bounce, bvh, step, texture
    from path_tracing__ray_tracer_tpu_torch.ops.texture import _unpack_rgb

    b = pt.CustomSceneBuilder()
    scene, cam = b.build_scene(), b.create_camera(WIDTH / HEIGHT)
    cs = pt.compile_scene(scene, device=device)
    blobs = (bounce.pack_scene_blob(cs), bounce.pack_mat_blob(cs), bounce.pack_light_blob(cs))
    cam12 = pt.pack_camera(cam, device)
    st, tables, scal, lane = experimental.pipe_start(
        cs, blobs, cam12, 0, 0, 0, n_pix=N_RAYS, width=WIDTH, height=HEIGHT, n_samples=MODE_SPP,
        max_depth=DEPTH, jitter="independent")
    for _ in range(MODE_STEPS):
        out = step.path_step_plain(cs, st, tables, cam12, scal, lane[0],
                                   experimental.step_texel(cs, st, lane[0]), *lane[1:])
        lane = (out[0],) + out[3:11]
    args = (cs, st, tables, cam12, scal, lane[0], experimental.step_texel(cs, st, lane[0]),
            *lane[1:])
    got, want = step.path_step(*args), step.path_step_plain(*args)
    s0, s2, item = lane[5], want[7], want[11]
    kinds = {"retired": s0 == st.ns, "finishing an item": item < st.ns,
             "regenerated": (item < st.ns) & (s2 < st.ns), "live": (s0 < st.ns) & (item == st.ns)}
    print(f"[modes] K7 check: the first {N_RAYS}-lane chunk of the {WIDTH}x{HEIGHT} frame, "
          f"{MODE_SPP} samples, after {MODE_STEPS} plain fused steps: " + ", ".join(
              f"{k} {int(v.sum())}" for k, v in kinds.items()))
    if not all(bool(v.any()) for v in kinds.values()):
        raise SystemExit("chip_smoke: the K7 check's chunk lacks retired, regenerated or "
                         "live lanes")
    k7_err, k7_bits = check_step("main path's first chunk", got, want)
    if bvh.lane_counter(device).any():
        raise SystemExit("chip_smoke: K7 left the stream's lane counter nonzero")

    # the record's hits again through K1: their texel indices into each table
    rec1 = bounce.path_bounce(cs, *blobs, want[1], want[2], want[3], want[5], want[6])
    textured = rec1.tex_id >= 0
    idx_full = texture.texel_index(cs, rec1.tex_id, rec1.u, rec1.v)
    if not torch.equal(torch.where(textured, idx_full, -1), want[0].idx):
        raise SystemExit("chip_smoke: K7's texel indices differ from texel_index of K1's record")
    budget = atlas_route_budget(scene)
    cs_b = pt.compile_scene(scene, texture_budget=budget, device=device)
    cs_m = pt.compile_scene(scene, mip_budget=DEFER_MIP, device=device)
    cs_l = pt.compile_scene(scene, mip_budget=LOD_BUDGET, device=device)
    # (name, table, indices): K9 on the defer mip (timed) and on the LOD mip
    gathers = (("atlas_gather", cs_b.atlas, texture.texel_index(cs_b, rec1.tex_id, rec1.u, rec1.v)),
               ("mip_gather", cs_m.mip_atlas,
                texture.mip_texel_index(cs_m, rec1.tex_id, rec1.u, rec1.v)),
               ("mip_gather", cs_l.mip_atlas,
                texture.mip_texel_index(cs_l, rec1.tex_id, rec1.u, rec1.v)))
    print(f"[modes] atlas route budget {budget}: {cs_b.atlas.shape[0]} texels = "
          f"{texture.atlas_rows(cs_b)} rows of 128 (MAX_ROWS {texture.MAX_ROWS}); defer mip "
          f"budget {DEFER_MIP}: {cs_m.mip_atlas.shape[0]} texels = {texture.mip_rows(cs_m)} rows; "
          f"LOD mip budget {LOD_BUDGET}: {cs_l.mip_atlas.shape[0]} texels = "
          f"{texture.mip_rows(cs_l)} rows; textured lanes {int(textured.sum())} of {N_RAYS}")
    errs, times, bounds = {"path_step": k7_err}, {}, {}
    plain = texture.gather_plain
    for name, table, idx in gathers:
        fn = getattr(texture, name)
        idx = idx.contiguous()
        g, w = fn(table, idx), plain(table, idx)
        same = all(torch.equal(a, c) for a, c in zip(g, w))
        err = max(float((a - c).abs().max()) for a, c in zip(g, w))
        errs[name] = max(errs.get(name, 0.0), err)
        print(f"[modes] {name} on a table of {table.shape[0]} texels: bit-equal {same} on "
              f"{N_RAYS} lanes (max |diff| {err:.3e})")
        if not same:
            raise SystemExit(f"chip_smoke: {name} disagrees with its plain version")
        if name in times:
            continue
        # the library yardstick: one index_select computing the same function
        # from three float32 planes (each byte times float32(1/255), zero
        # padded to 128·R texels), on the indices clamped as the kernel does
        n_tex = table.shape[0]
        padded = torch.nn.functional.pad(table, (0, -(-n_tex // 128) * 128 - n_tex))
        planes = torch.stack(tuple(_unpack_rgb(padded))).contiguous()
        k = idx.clamp(0, planes.shape[1] - 1)
        lib_out = torch.index_select(planes, 1, k)
        if not all(same_bits(lib_out[c], g[c]) for c in range(3)):
            raise SystemExit(f"chip_smoke: the plane index_select differs from {name}")
        lib, _, _, _, lib_by = device_ms(lambda: torch.index_select(planes, 1, k), None)
        packed = device_ms(lambda: torch.index_select(table, 0, idx), None)[0]
        times[name] = timed(lambda: fn(table, idx), "gather_rgb_kernel",
                            lambda: plain(table, idx))
        times[name]["library_ms"] = lib
        bounds[name] = bound_ms(3 * N_RAYS, N_RAYS * (4 + 4 + 12))
        show_time(name, times[name], f"; library index_select on (3, {planes.shape[1]}) float32 "
                  f"planes, bit-equal: {lib:.4f} ms device ({lib_by}; the packed int32 index_select "
                  f"{packed:.4f} ms, no unpack)")
    times["path_step"] = timed(lambda: step.path_step(*args), "path_step_persistent",
                               lambda: step.path_step_plain(*args))
    show_time("path_step", times["path_step"])
    # K7 reads 29 words a lane and writes 38; its sweeps are K1's on the rays it traces
    bounds["path_step"] = bound_ms(k1_flops(cs, want[1], want[2], want[5], want[6]),
                                   N_RAYS * 4 * (29 + 38))
    for name, (ms, by) in bounds.items():
        print(f"[bound] {name}: {ms:.5f} ms ({by})")
    return budget, errs, k7_bits, times, bounds


def mode_run(device, label, default_img, kernel, **kw):
    """One 128-sample group of the main path's shape (after a warm-up group
    of ``MODE_WARM_SPP`` samples) with a mode; returns launches, seconds,
    Mrays/s and the image of the timed group."""
    import numpy as np
    import torch

    import path_tracing__ray_tracer_tpu_torch as pt

    b = pt.CustomSceneBuilder()
    scene, cam = b.build_scene(), b.create_camera(WIDTH / HEIGHT)
    r = pt.RendererFactory.create("cuda_path_raytracer", sample_group=GROUP_SPP,
                                  chunk_rays=CHUNK_RAYS, device=device, **kw)
    t0 = time.perf_counter()
    r.render_sums(scene, cam, pt.RenderSettings(WIDTH, HEIGHT, MODE_WARM_SPP, DEPTH))
    warm = time.perf_counter() - t0
    settings = pt.RenderSettings(WIDTH, HEIGHT, GROUP_SPP, DEPTH)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    sums = r.render_sums(scene, cam, settings, sample_offset=GROUP_SPP, n_samples=GROUP_SPP)
    secs = time.perf_counter() - t0
    launched = {k: v for k, v in counts().items() if v}
    mrays = WIDTH * HEIGHT * GROUP_SPP * DEPTH / secs / 1e6
    img = image_of(sums, GROUP_SPP)
    diff = np.abs(img.astype(np.int32) - default_img.astype(np.int32))
    rmse = float(np.sqrt((diff.astype(np.float64) ** 2).mean()))
    print(f"[modes] ({label}) {WIDTH}x{HEIGHT} depth {DEPTH}, one {GROUP_SPP}-sample group: "
          f"warm-up ({MODE_WARM_SPP} spp) {warm:.3f} s, timed {secs:.3f} s -> {mrays:.2f} Mrays/s; "
          f"launches {launched}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; against the default image: "
          f"RMSE {rmse:.4f}/255, {float((diff > 2).mean()):.5f} of channels off by >2/255, "
          f"max {int(diff.max())}, bit-equal {bool((diff == 0).all())}")
    if not np.isfinite(sums).all() or (sums < 0).any():
        raise SystemExit(f"chip_smoke: ({label}) sums are not finite and non-negative")
    if not launched.get(kernel):
        raise SystemExit(f"chip_smoke: ({label}) never launched {kernel}")
    return launched, secs, mrays, img, (rmse, float((diff > 2).mean())), sums


def phase_modes_main(device, default_img, budget):
    """Runs (a)-(d) at the main path's shape; the profiles of a 4-sample
    frame, default and pipe, and of a 128-sample pipe frame."""
    import numpy as np
    import torch

    import path_tracing__ray_tracer_tpu_torch as pt
    from path_tracing__ray_tracer_tpu_torch.models import path_tracer
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import bounce, step, texture

    runs = {}
    path_tracer._PIPE_REGEN = True
    try:
        runs["pipe"] = mode_run(device, "a: pipe", default_img, "path_step")
        path_tracer._GRAPH_BLOCKS = False
        eager = mode_run(device, "a: pipe, _GRAPH_BLOCKS = False", default_img, "path_step")
    finally:
        path_tracer._PIPE_REGEN = False
        path_tracer._GRAPH_BLOCKS = True
    if runs["pipe"][4][0] != 0.0 or runs["pipe"][0].get("path_bounce"):
        raise SystemExit("chip_smoke: the pipe run's image is not bit-equal to the default "
                         "image, or it ran K1")
    same = np.array_equal(runs["pipe"][5], eager[5])
    print(f"[modes] (a) the pipe's graphs against its eager loop: float sums bit-equal {same}, "
          f"launches equal {runs['pipe'][0] == eager[0]}; {runs['pipe'][1]:.3f} s against "
          f"{eager[1]:.3f} s")
    if not same or runs["pipe"][0] != eager[0]:
        raise SystemExit("chip_smoke: the pipe's graph replay differs from its eager loop")
    runs["defer"] = mode_run(device, f"b: defer, mip_budget={DEFER_MIP}", default_img,
                             "mip_gather", mip_budget=DEFER_MIP)
    runs["lod"] = mode_run(device, f"c: LOD, texture_lod={LOD_BUDGET}, depth {LOD_DEPTH}",
                           default_img, "mip_gather", texture_lod=LOD_BUDGET,
                           texture_lod_depth=LOD_DEPTH)
    for label, bound in (("defer", DEFER_RMSE_MAX), ("lod", LOD_RMSE_MAX)):
        if runs[label][4][0] > bound:
            raise SystemExit(f"chip_smoke: the {label} run's RMSE {runs[label][4][0]:.4f}/255 "
                             f"against the default image is above {bound}/255")
    torch.cuda.empty_cache()
    at_budget = mode_run(device, f"d0: default path at texture_budget={budget}", default_img,
                         "path_bounce", texture_budget=budget)
    texture.ENABLED = True
    try:
        runs["atlas"] = mode_run(device, f"d: atlas route, texture_budget={budget}",
                                 at_budget[3], "atlas_gather", texture_budget=budget)
    finally:
        texture.ENABLED = False
    if not np.array_equal(runs["atlas"][3], at_budget[3]):
        raise SystemExit("chip_smoke: the atlas route's image differs from the default path's")
    torch.cuda.empty_cache()

    b = pt.CustomSceneBuilder()
    scene, cam = b.build_scene(), b.create_camera(WIDTH / HEIGHT)
    for tag, spp, counter, kernels in (
            ("[modes] default", 4, lambda: bounce.path_bounce.launches,
             {"K1": "path_bounce_persistent"}),
            ("[modes] pipe", 4, lambda: step.path_step.launches, {"K7": "path_step_persistent"}),
            ("[modes] pipe", GROUP_SPP, lambda: step.path_step.launches,
             {"K7": "path_step_persistent"})):
        r = pt.RendererFactory.create("cuda_path_raytracer", sample_group=GROUP_SPP,
                                      chunk_rays=CHUNK_RAYS, device=device)
        r.compiled(scene)  # the scene compile stays out of the frame's time
        path_tracer._PIPE_REGEN = tag.endswith("pipe")
        try:
            profile_frame(tag, r, scene, cam, pt.RenderSettings(WIDTH, HEIGHT, spp, DEPTH),
                          counter, kernels, top=3)
        finally:
            path_tracer._PIPE_REGEN = False
    return runs


def phase_modes_property(device):
    """At 160x120, deferred texture and LOD with the mip equal to the atlas
    against the default render: LOD bit for bit; deferred texture at the
    JAX package's bar (its A + base0*B rounds differently)."""
    import numpy as np

    import path_tracing__ray_tracer_tpu_torch as pt

    b = pt.CustomSceneBuilder()
    scene, cam = b.build_scene(), b.create_camera(MO_WIDTH / MO_HEIGHT)
    settings = pt.RenderSettings(MO_WIDTH, MO_HEIGHT, MO_SPP, MO_DEPTH)

    def sums(**kw):
        return pt.RendererFactory.create("cuda_path_raytracer", seed=0, texture_budget=PROP_BUDGET,
                                         device=device, **kw).render_sums(scene, cam, settings)

    want = sums()
    for label, kw in (("LOD", dict(texture_lod=PROP_BUDGET)),
                      ("defer", dict(mip_budget=PROP_BUDGET))):
        got = sums(**kw)
        diff = np.abs(got - want)
        print(f"[modes] property, {label} with mip == atlas (budget {PROP_BUDGET}), "
              f"{MO_WIDTH}x{MO_HEIGHT} {MO_SPP} spp depth {MO_DEPTH}: bit-equal "
              f"{np.array_equal(got, want)}, max |diff| {float(diff.max()):.3e}, "
              f"{float((diff > 1e-3).mean()):.5f} of values off by >1e-3, mean {diff.mean():.3e}")
        if label == "LOD" and not np.array_equal(got, want):
            raise SystemExit("chip_smoke: LOD with mip == atlas differs from the default render")
        if (diff > 1e-3).mean() >= 0.01 or diff.mean() >= 1e-3:
            raise SystemExit(f"chip_smoke: {label} with mip == atlas is off the default render")


# ---- [mesh]: the (tile x sample) split and the entry points -------------------
MESH_ENTRIES = 4  # a (2, 2) mesh, every entry the one card
MESH_OVERLAP_MIN = 1.5  # the entries' busy seconds over the calls' wall seconds, at least
MESH_WARM = (256, 256, 8)  # the frame and spp that start and warm (b)'s workers
SUB_CHECK_KERNELS = {  # the kernels each dry-run sub-check must launch
    "path/cornell": ("path_bounce",),
    "path/bvh-mesh": ("path_bounce_bvh", "scene_any"),
    "whitted/cornell": ("whitted_bounce",),
    "path/paged-mesh": ("paged_top_closest", "paged_top_any", "pages_closest", "pages_any"),
}
CLI_MESH_SHAPE = ["-r", "cuda_path_raytracer", "-w", "160", "--height", "120",
                  "--path-samples", "16", "-d", "4", "--no-show"]


def mesh_workers_line(tag, mesh):
    """Each entry's pid and busy seconds; fails unless every entry rendered
    in a live process of its own."""
    import os

    ws = mesh.workers()
    pids, busy = ws.stats["pids"], ws.stats["busy"]
    alive = [p.pid for p in ws.processes if p.is_alive()]
    print(f"[mesh] {tag} workers: " + ", ".join(
        f"entry {i} pid {pid} busy {b:.3f} s" for i, (pid, b) in enumerate(zip(pids, busy))))
    if None in pids or len(set(pids)) != MESH_ENTRIES or sorted(alive) != sorted(pids) \
            or os.getpid() in pids:
        raise SystemExit(f"chip_smoke: {tag} did not render in {MESH_ENTRIES} worker processes")
    return pids


def mesh_stopped(tag, mesh):
    procs = mesh.workers().processes
    mesh.close()
    if any(p.is_alive() for p in procs):
        raise SystemExit(f"chip_smoke: {tag}'s workers outlived close()")
    print(f"[mesh] {tag}: close() stopped the {len(procs)} workers")


def phase_mesh(device, oneshot_sums, single_secs):
    """The split across a mesh and the entry points, on a ``(2, 2)`` mesh of
    four entries of the one card, each entry in a worker process of its own
    (``parallel/workers.py``; four entries of one card share the card, which
    time-slices their contexts):

    (a) ``graft_entry.dryrun_multichip``'s four sub-checks, each sharded
        render within ``atol=1e-5`` of the single-device one, with the
        launches of each (sharded and single render; the workers' launches
        are added onto this process's counts); fails if a kernel of the
        sub-check never launched, or unless four worker processes rendered;
    (b) the main path at full width through the split (1024², depth 8, one
        128-sample group) on a second set of workers, started and warmed on
        a small frame first: its image within the golden tolerance of
        ``phase_main_path``'s first group (``oneshot_sums``, the same
        samples), with the channels that differ, the largest difference of
        the radiance sums and its seconds beside the single-device group's
        (``single_secs``); each entry's pid and busy seconds and the
        overlap ratio (the entries' busy seconds over the chunk calls' wall
        seconds), which must be at least ``MESH_OVERLAP_MIN``, in four
        distinct processes; and the seconds of one call that sends every
        entry a tile block (65,536 pixels, 786 KB) and takes it back;
    (c) the CLI with ``--devices 1``, bit-equal to the same run without the
        flag, and ``python -m ... --devices <cards + 1>`` in a fresh process,
        which must exit non-zero with ``make_mesh``'s message;
    (d) ``graft_entry.entry()``: finite ``(3, 4096)`` sums, bit-equal to
        ``PathTracer.device_sums`` of the same chunk."""
    import os
    import tempfile

    import numpy as np
    import torch

    import path_tracing__ray_tracer_tpu_torch as pt
    from path_tracing__ray_tracer_tpu_torch import graft_entry
    from path_tracing__ray_tracer_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(MESH_ENTRIES, sample_parallel=2, devices=[device] * MESH_ENTRIES)
    t0 = time.perf_counter()
    reset_counts()
    for label in graft_entry.sub_checks(mesh):
        launched = {k: counts()[k] for k in SUB_CHECK_KERNELS[label]}
        reset_counts()
        print(f"[mesh] (a) {label}: launches {launched}")
        if not all(launched.values()):
            raise SystemExit(f"chip_smoke: dry-run sub-check {label} did not launch "
                             f"{SUB_CHECK_KERNELS[label]}")
    print(f"[mesh] (a) dryrun_multichip OK: mesh={mesh.shape} (4/4 sub-checks), "
          f"{time.perf_counter() - t0:.1f} s with the workers' start")
    mesh_workers_line("(a)", mesh)
    mesh_stopped("(a)", mesh)

    b = pt.CustomSceneBuilder()
    scene, cam = b.build_scene(), b.create_camera(WIDTH / HEIGHT)
    settings = pt.RenderSettings(width=WIDTH, height=HEIGHT, samples_per_pixel=GROUP_SPP,
                                 max_depth=DEPTH)
    mesh = make_mesh(MESH_ENTRIES, sample_parallel=2, devices=[device] * MESH_ENTRIES)
    r = pt.RendererFactory.create("cuda_path_raytracer", sample_group=GROUP_SPP,
                                  chunk_rays=CHUNK_RAYS, texture_budget=0, mesh=mesh)
    r.compiled(scene, device)  # one compile: the four entries share the card
    t0 = time.perf_counter()  # start the workers: spawn, CUDA context, scene, kernels
    warm_w, warm_h, warm_spp = MESH_WARM
    r.render_sums(scene, cam, pt.RenderSettings(warm_w, warm_h, warm_spp, DEPTH))
    warm = time.perf_counter() - t0
    ws = mesh.workers()
    tile_pix = r._plan(WIDTH, HEIGHT, GROUP_SPP, DEPTH)[0] // mesh.shape["tile"]
    block = np.zeros((3, tile_pix), dtype=np.float32)  # an entry's block of the main path
    echo = statistics.median(ws.echo(block) for _ in range(5))
    torch.cuda.synchronize()
    reset_counts()
    ws.reset_stats()
    t0 = time.perf_counter()
    sums = r.render_sums(scene, cam, settings, sample_offset=0, n_samples=GROUP_SPP)
    secs = time.perf_counter() - t0
    launched = counts()["path_bounce"]
    img, want = image_of(sums, GROUP_SPP), image_of(oneshot_sums, GROUP_SPP)
    diff = np.abs(img.astype(np.int32) - want.astype(np.int32))
    share = float((diff > 2).mean())
    overlap = sum(ws.stats["busy"]) / ws.stats["wall"]
    print(f"[mesh] (b) {WIDTH}x{HEIGHT} depth {DEPTH}, one {GROUP_SPP}-sample group on "
          f"{mesh.shape}: {secs:.3f} s (single device: {single_secs:.3f} s, ratio "
          f"{secs / single_secs:.3f}), K1 launches {launched}; against the single-device render "
          f"of the same samples {int((diff > 0).sum())} of {diff.size} channels differ "
          f"({share:.6f} by >2/255, max {int(diff.max())}), radiance sums differ by at most "
          f"{float(np.abs(sums - oneshot_sums).max()):.6g}")
    print(f"[mesh] (b) {ws.stats['calls']} chunk calls, {ws.stats['wall']:.3f} s of wall in "
          f"them, overlap ratio {overlap:.3f} (the entries' busy seconds over the calls' wall); "
          f"the workers' graph captures {ws.stats['captures']} in {ws.stats['capture_s']:.3f} s "
          f"(each captures its own; the warm-up's widths differ); "
          f"workers started and warmed on {warm_w}x{warm_h} at {warm_spp} spp in {warm:.3f} s; "
          f"one call moving a {block.shape[1]}-pixel block ({block.nbytes} B) to every entry's "
          f"card and back: {echo * 1e3:.3f} ms")
    mesh_workers_line("(b)", mesh)
    mesh_stopped("(b)", mesh)
    if not np.isfinite(sums).all() or img.shape != want.shape or share >= 0.01:
        raise SystemExit("chip_smoke: the split main path is outside the golden tolerance")
    if launched == 0:
        raise SystemExit("chip_smoke: the split main path never launched K1")
    if overlap < MESH_OVERLAP_MIN:
        raise SystemExit(f"chip_smoke: the split main path's entries overlapped {overlap:.3f}x, "
                         f"under {MESH_OVERLAP_MIN}")
    del sums

    with tempfile.TemporaryDirectory() as tmp:
        cli_run(CLI_MESH_SHAPE + ["-o", f"{tmp}/one.png"], ("path_bounce",))
        cli_run(CLI_MESH_SHAPE + ["--devices", "1", "-o", f"{tmp}/mesh1.png"], ("path_bounce",))
        same = bool((png(f"{tmp}/one.png") == png(f"{tmp}/mesh1.png")).all())
        too_many = torch.cuda.device_count() + 1
        proc = subprocess.run(
            [sys.executable, "-m", "path_tracing__ray_tracer_tpu_torch", "--devices",
             str(too_many), "-w", "16", "--height", "12", "-o", f"{tmp}/x.png", "--no-show"],
            capture_output=True, text=True, timeout=300, cwd=ROOT,
            env={**os.environ, "PYTHONPATH": str(ROOT)})
    refused = "make_mesh" in proc.stderr
    print(f"[mesh] (c) CLI --devices 1 bit-equal to no flag: {same}; --devices {too_many}: rc "
          f"{proc.returncode}, {proc.stderr.strip().splitlines()[-1:]}")
    if not same:
        raise SystemExit("chip_smoke: the CLI's --devices 1 image differs from the one-device run")
    if proc.returncode == 0 or not refused:
        raise SystemExit(f"chip_smoke: the CLI's --devices {too_many} did not fail in make_mesh")

    fn, args = graft_entry.entry(device)
    reset_counts()
    out = fn(*args)
    launched = counts()["path_bounce"]
    ref = pt.RendererFactory.create("cuda_path_raytracer", seed=0, sample_group=4,
                                    device=device).device_sums(
        *graft_entry._example_scene(), pt.RenderSettings(64, 64, 4, 4))
    bits = out.shape == ref.shape and bool(torch.equal(out, ref))
    print(f"[mesh] (d) entry(): shape {tuple(out.shape)}, finite "
          f"{bool(torch.isfinite(out).all())}, K1 launches {launched}, bit-equal to "
          f"PathTracer.device_sums: {bits}")
    if tuple(out.shape) != (3, 4096) or not bool(torch.isfinite(out).all()) or not bits:
        raise SystemExit("chip_smoke: entry() is not the path tracer's chunk")
    if launched == 0:
        raise SystemExit("chip_smoke: entry() never launched K1")
    return secs, share


def main() -> int:
    phase_environment()
    import torch

    import path_tracing__ray_tracer_tpu_torch as pt

    device = torch.device("cuda", 0)
    build_s = phase_build()
    b = pt.CustomSceneBuilder()
    cs = pt.compile_scene(b.build_scene(), device=device)
    blobs, state, k1_err = phase_kernel_check(cs, b.create_camera(WIDTH / HEIGHT), device)
    k1_times = phase_timing(cs, blobs, state)
    camera_rays, shadow, k3a_err, k3b_err = phase_intersect_check(
        cs, b.create_camera(W_WIDTH / W_HEIGHT), device)
    k2_err = phase_whitted_check(cs, blobs, camera_rays)
    k2_err = max(k2_err, phase_whitted_frame_check(device))
    o_err_a, o_err_b, oracle_shapes = phase_oracle_check(device)
    k3a_err, k3b_err = max(k3a_err, o_err_a), max(k3b_err, o_err_b)
    times = phase_new_timing(cs, blobs, camera_rays, shadow)
    for name, rows in phase_oracle_timing(oracle_shapes).items():
        times[name]["shapes"] = rows
    del oracle_shapes
    times["path_bounce"] = k1_times
    bounds = kernel_bounds(cs, state, camera_rays, shadow)
    phase_golden(device)
    k1_launches, secs, mrays, default_img, first_group_img, first_group = phase_main_path(
        device)
    cli_prog = phase_cli_progressive(first_group_img)
    budget, merrs, k7_bits, mtimes, mbounds = phase_modes_check(device)
    times.update(mtimes)
    bounds.update(mbounds)
    runs = phase_modes_main(device, default_img, budget)
    phase_modes_property(device)
    k2_launches, w_secs, w_mrays, rmse, whitted_img = phase_whitted_frame(device)
    cli_secs, cli_rmse = phase_cli_default(whitted_img)
    phase_cli_trace()
    phase_whitted_profile(device, w_secs)
    oracle = phase_oracle(device)
    mcs, tables, mspread, (k4a_err, k4b_err, k5_err) = phase_mesh_check(device)
    mtimes, mbounds = phase_mesh_timing(mcs, tables, mspread)
    times.update(mtimes)
    bounds.update(mbounds)
    mesh_launched, m_secs, m_mrays, mr, mscene, mcam = phase_mesh_main(device)
    phase_mesh_profile(mr, mscene, mcam)
    del mr
    graph = phase_graph(device)
    mw_launched = phase_mesh_whitted(device)
    bscene, bcam, btimes, bbounds, berr, _routes = phase_big_check(device)
    times.update(btimes)
    bounds.update(bbounds)
    k6_launched, b_secs, b_mrays = phase_big_main(device, bscene, bcam)
    del bscene, bcam
    torch.cuda.empty_cache()
    k512_err = phase_512k_check(device)
    top48_err = phase_top_leaves_check(device)
    phase_mesh_oracle(device)
    stimes, sbounds, serr = phase_split_check(device)
    times.update(stimes)
    bounds.update(sbounds)
    xtimes, xbounds, xerr, _twins = phase_mxu_check(device)
    times.update(xtimes)
    bounds.update(xbounds)
    split_runs = phase_split_main(device)
    fault_launched = phase_split_fault(device)
    xw_launched = phase_mxu_whitted(device)
    mesh_secs, mesh_share = phase_mesh(device, first_group, secs)
    del first_group
    torch.cuda.synchronize()

    src = "path_tracing__ray_tracer_tpu_torch/csrc/"
    tpu = "path_tracing__ray_tracer_tpu/ops/pallas/"
    rows = (
        ("path_bounce", "path_bounce.cu", "bounce_pallas.py:308", k1_launches, k1_err),
        ("whitted_bounce", "whitted_bounce.cu", "whitted_pallas.py:39", k2_launches, k2_err),
        ("closest_hit", "intersect.cu", "intersect_pallas.py:294", oracle["closest_hit"], k3a_err),
        ("any_hit", "intersect.cu", "intersect_pallas.py:312", oracle["any_hit"], k3b_err),
        ("scene_closest", "bvh_scene.cu", "bvh_pallas.py:1164", mw_launched["scene_closest"],
         k4a_err),
        ("scene_any", "bvh_scene.cu", "bvh_pallas.py:1351", mesh_launched["scene_any"], k4b_err),
        ("path_bounce_bvh", "path_bounce_bvh.cu", "bounce_bvh_pallas.py:128",
         mesh_launched["path_bounce_bvh"], k5_err),
        ("paged_top_closest", "bvh_paged.cu", "bvh_paged_pallas.py:512",
         k6_launched["paged_top_closest"], max(berr["closest"], k512_err, top48_err)),
        ("paged_top_any", "bvh_paged.cu", "bvh_paged_pallas.py:547", k6_launched["paged_top_any"],
         max(berr["any"], top48_err)),
        ("pages_closest", "bvh_paged.cu", "bvh_paged_pallas.py:576", k6_launched["pages_closest"],
         max(berr["closest"], berr["k4c"], k512_err)),
        ("pages_any", "bvh_paged.cu", "bvh_paged_pallas.py:605", k6_launched["pages_any"],
         berr["any"]),
        ("path_step", "path_step.cu", "bounce_pallas.py:401", runs["pipe"][0]["path_step"],
         merrs["path_step"]),
        ("atlas_gather", "texture_gather.cu", "texture_pallas.py:64",
         runs["atlas"][0]["atlas_gather"], merrs["atlas_gather"]),
        ("mip_gather", "texture_gather.cu", "texture_pallas.py:172",
         runs["defer"][0]["mip_gather"], merrs["mip_gather"]),
        ("closest_skiplink", "bvh2_walk.cu", "bvh_pallas.py:418",
         fault_launched["closest_skiplink"], serr["closest_skiplink"]),
        ("closest_ordered", "bvh2_walk.cu", "bvh_pallas.py:479",
         split_runs[SPLIT_QUAD][3]["closest_ordered"], serr["closest_ordered"]),
        ("any_skiplink", "bvh2_walk.cu", "bvh_pallas.py:585", fault_launched["any_skiplink"],
         serr["any_skiplink"]),
        ("any_ordered", "bvh2_walk.cu", "bvh_pallas.py:639",
         split_runs[SPLIT_QUAD][3]["any_ordered"], serr["any_ordered"]),
        ("closest_rooted", "bvh_scene.cu", "bvh_pallas.py:1140",
         split_runs[SPLIT_MP][3]["closest_rooted"], serr["closest_rooted"]),
        ("scene_closest_mat", "bvh_leafmat.cu", "bvh_pallas.py:1106",
         xw_launched["scene_closest_mat"], xerr["scene_closest_mat"]),
        ("scene_any_mat", "bvh_leafmat.cu", "bvh_pallas.py:1324",
         split_runs[MXU_FUSED][3]["scene_any_mat"], xerr["scene_any_mat"]),
        ("tri_closest_mat", "bvh_leafmat.cu", "bvh_pallas.py:1083",
         split_runs[MXU_QUAD][3]["tri_closest_mat"], xerr["tri_closest_mat"]),
        ("tri_any_mat", "bvh_leafmat.cu", "bvh_pallas.py:1305",
         split_runs[MXU_QUAD][3]["tri_any_mat"], xerr["tri_any_mat"]),
    )
    rows += (  # K4c / K4d: the whole-tree page walks, timed on config 6
        ("K4c", "bvh_paged.cu", "bvh_pallas.py:1059", split_runs[SCALAR_QUAD][3]["pages_closest"],
         berr["k4c"]),
        ("K4d", "bvh_paged.cu", "bvh_pallas.py:1285", split_runs[SCALAR_QUAD][3]["pages_any"],
         berr["any"]),
    )
    # ms: device time per launch (ms_by "profiler"; "events": the call's device
    # work, when no trace kept a launch); call_ms: one call of the wrapper,
    # host and device (CUDA events); twin_ms: the first design's device time,
    # in turns; tree_ms: the tree traffic the plain walk counts, over the
    # memory rate
    print(json.dumps({"kernels": [{
        "name": name, "symbol": times[name]["symbol"], "route": "cuda", "source": src + source,
        "replaces": tpu + replaces,
        "launches": launches, "max_abs_err": err, "ms": times[name]["ms"],
        "ms_by": times[name]["ms_by"], "call_ms": times[name]["call_ms"],
        "plain_ms": times[name]["plain_ms"],
        "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
        "library_ms": times[name].get("library_ms"),
        **{k: times[name][k] for k in ("twin_ms", "tree_ms", "shapes") if k in times[name]},
        **({"bound_terms": bounds[name][2]} if len(bounds[name]) > 2 else {}),
    } for name, source, replaces, launches, err in rows]}))
    print(f"build {build_s:.2f} s; main path {mrays:.2f} Mrays/s ({secs:.3f} s per 128-sample "
          f"group at 1024x1024 depth 8); its modes: pipe {runs['pipe'][2]:.2f} (K7 bit-equal "
          f"{k7_bits}), defer {runs['defer'][2]:.2f}, LOD {runs['lod'][2]:.2f}, atlas route "
          f"{runs['atlas'][2]:.2f} Mrays/s (budget {budget}); Whitted frame {w_secs:.3f} s "
          f"({w_mrays:.2f} Mrays/s, RMSE {rmse:.4f}/255; through the CLI {cli_secs:.3f} s, "
          f"bit-equal, RMSE {cli_rmse:.4f}/255); the CLI's progressive main path "
          f"{cli_prog[0]:.3f} s ({cli_prog[1]} channels off the one-shot image, "
          f"{cli_prog[2]:.6f} by >2/255; resume bit-equal); mesh path {m_mrays:.2f} Mrays/s "
          f"({m_secs:.3f} s per {MESH_SPP}-sample group at {M_WIDTH}x{M_HEIGHT} depth "
          f"{M_DEPTH}); config-6 path {b_mrays:.2f} Mrays/s ({b_secs:.3f} s per {B_SPP}-sample "
          f"group); config 5's split route at {SPLIT_SPP} spp: default {split_runs['default'][1]:.2f}, "
          f"BVH2 ordered (K4e) {split_runs[SPLIT_QUAD][1]:.2f}, multipass (K11) "
          f"{split_runs[SPLIT_MP][1]:.2f}, leaf table K5 + K10b {split_runs[MXU_FUSED][1]:.2f}, "
          f"quad K10c + K10d {split_runs[MXU_QUAD][1]:.2f}, quad K4c + K4d "
          f"{split_runs[SCALAR_QUAD][1]:.2f} Mrays/s; the main path on a (2, 2) mesh of one "
          f"card {mesh_secs:.3f} s ({mesh_share:.6f} of channels by >2/255 off one device); "
          f"the bounce blocks as CUDA graphs (bit-equal): " + "; ".join(
              f"{label} {runs_['eager'][1]:.3f} s eager, {runs_['graphs'][1]:.3f} s with its "
              f"captures, {runs_['replay'][1]:.3f} s replayed" for label, (runs_, _p) in graph.items())
          + "; on:")
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
