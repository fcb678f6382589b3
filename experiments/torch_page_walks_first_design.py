#!/usr/bin/env python3
"""The PyTorch + CUDA port's page walks (K6c and K6d, and K4c and K4d over
the whole tree) against their first designs, on one NVIDIA GPU: bit for bit
on every lane, and timed in turns (new, first design, first design, new),
on config 6's spread and three-bounce sets as ``chip_smoke.py``'s phase 12
makes them, with their shadow rays; then bit for bit on the
512,000-triangle scene's spread set.

The repository keeps no copy of the first designs.  Extract their sources
from the commit that last had them into a directory and pass it:

    mkdir -p .scratch/first_design
    for f in bvh_paged.cu bvh_walk.cuh sweep.cuh; do
      git show d67e6f1:path_tracing__ray_tracer_tpu_torch/csrc/$f > .scratch/first_design/$f
    done
    python3 experiments/torch_page_walks_first_design.py .scratch/first_design

They are built with the port's ``nvcc`` flags into ``DIR/build`` under
another library name; their kernels keep their own symbols
(``pages_closest_kernel``, ``pages_any_kernel``), so the profiler tells them
from the redesign's.  Each time is the kernel's device time per launch (the
torch profiler over 25 calls, from a trace that kept every launch; else CUDA
events around each call).  Prints the card's name and power limit; exits
non-zero when any lane differs.
"""
import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as S  # noqa: E402
from path_tracing__ray_tracer_tpu_torch.ops.cuda import build, bvh, bvh_paged  # noqa: E402
from path_tracing__ray_tracer_tpu_torch.ops.intersect import ClosestRecord  # noqa: E402
from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3  # noqa: E402

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


def build_first(src: Path):
    """Compile the first design's ``bvh_paged.cu`` and bind its page walks."""
    out = src / "build"
    out.mkdir(exist_ok=True)
    lib_path = out / "libfirst_paged.so"
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib_path), str(src / "bvh_paged.cu")]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    print(f"[first] nvcc {time.perf_counter() - t0:.2f} s; "
          f"{S.ptxas_summary(r.stdout + r.stderr)}", flush=True)
    if r.returncode:
        raise SystemExit(r.stdout + r.stderr)
    lib = ctypes.CDLL(str(lib_path))
    lib.ptrt_pages_closest.argtypes = ([_P, _L, _P, _L, _P, _P, _I, _I, _I] + [_P] * 6 + [_P, _P]
                                       + [_P] * 7 + [_I, _F] + [_P] * 7 + [_P])
    lib.ptrt_pages_any.argtypes = ([_P, _L, _P, _L, _I] + [_P] * 6 + [_P, _P, _P, _P, _I, _F, _P]
                                   + [_P])
    lib.ptrt_pages_closest.restype = lib.ptrt_pages_any.restype = ctypes.c_int
    return lib


def first_tree(cs, whole):
    """The first design's records: the pages with their 13-float slot
    records, or the one-level tree as one page."""
    b = cs.bvh
    if whole:
        return (b.nodes4, b.nodes4.shape[0], b.slot_rec, b.slot_rec.shape[0], b.lo[:1], b.hi[:1],
                1)
    pg = b.paged
    return (pg.page_tree, pg.page_tree.shape[1], pg.page_slot, pg.page_slot.shape[1], pg.page_lo,
            pg.page_hi, pg.n_pages)


def _ptr(x):
    return None if x is None else x.data_ptr()


def _stream():
    return torch.cuda.current_stream().cuda_stream


def first_closest(lib, cs, o, d, best, plo=None, phi=None):
    n = o.x.shape[0]
    tree, tc, slots, sc, lo, hi, n_pages = first_tree(cs, plo is None)
    out = torch.empty((6, n), dtype=torch.float32, device=o.x.device)
    prim = torch.empty((n,), dtype=torch.int32, device=o.x.device)
    t, u, v, nx, ny, nz = out
    carried = (best.t, best.prim, best.u, best.v, *best.normal)
    err = lib.ptrt_pages_closest(
        tree.data_ptr(), tc, slots.data_ptr(), sc, lo.data_ptr(), hi.data_ptr(), n_pages,
        bvh_paged._offset(cs), bvh.gid_mask(cs), *(x.data_ptr() for x in (*o, *d)), _ptr(plo),
        _ptr(phi), *(x.data_ptr() for x in carried), n, 1e-3, t.data_ptr(), prim.data_ptr(),
        u.data_ptr(), v.data_ptr(), nx.data_ptr(), ny.data_ptr(), nz.data_ptr(), _stream())
    bvh._raise_on("first_closest", err)
    return ClosestRecord(t, prim, u, v, V3(nx, ny, nz))


def first_any(lib, cs, o, d, limit, found, plo=None, phi=None):
    n = o.x.shape[0]
    tree, tc, slots, sc, _lo, _hi, n_pages = first_tree(cs, plo is None)
    out = torch.empty((n,), dtype=torch.bool, device=o.x.device)
    err = lib.ptrt_pages_any(tree.data_ptr(), tc, slots.data_ptr(), sc, n_pages,
                             *(x.data_ptr() for x in (*o, *d)), _ptr(plo), _ptr(phi),
                             limit.data_ptr(), found.data_ptr(), n, 1e-3, out.data_ptr(),
                             _stream())
    bvh._raise_on("first_any", err)
    return out


def device_ms(fn, symbol, reps=25, tries=3):
    """``(device ms per launch of symbol, method)``: the profiler's median
    over ``reps`` calls from a trace that kept every launch, else the
    median of CUDA events around each call queued behind a device spin."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(S.TRACE_PAD_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(S.TRACE_PAD_S)
        times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and S.kernel_is(e.name, symbol)]
        if len(times) == reps:
            return statistics.median(times), "profiler"
    marks = []
    torch.cuda._sleep(int(0.05 * 1.98e9))
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in marks), "events"


def _popcount(w):
    w = w.to(torch.int64) & 0xFFFFFFFF
    return sum((w >> b) & 1 for b in range(32))


def walks(lib, cs, o, d, so, sd, lim):
    """Each page walk's call and its first design's on the same inputs:
    K6c and K6d fed by K6a and K6b, K4c and K4d over the whole tree with the
    shadow rays' bound."""
    n = o.x.shape[0]
    dev = o.x.device
    best, plo, phi = bvh_paged.paged_top_closest(cs, o, d, 1e-3, 1e6)
    found, alo, ahi = bvh_paged.paged_top_any(cs, so, sd, 1e-3, lim)
    zero = torch.zeros(n, device=dev)
    seed = ClosestRecord(lim, torch.full((n,), -1, dtype=torch.int32, device=dev), zero, zero,
                         V3(zero, zero, zero))
    unfound = torch.zeros(n, dtype=torch.bool, device=dev)
    pend = (plo != 0) | (phi != 0)
    pages = (_popcount(plo) + _popcount(phi)).float()
    walking = ~found & ((alo != 0) | (ahi != 0))
    apages = (_popcount(alo) + _popcount(ahi)).float()
    print(f"[set]   {int(pend.sum())} lanes pend a page after K6a, {float(pages[pend].mean()):.2f} "
          f"pages each (max {int(pages.max())}); {int(walking.sum())} shadow rays walk pages "
          f"after K6b, {float(apages[walking].mean()):.2f} each", flush=True)
    return {
        "K6c": ("pages_closest", lambda: bvh_paged.pages_closest(cs, o, d, 1e-3, best, plo, phi),
                lambda: first_closest(lib, cs, o, d, best, plo, phi)),
        "K6d": ("pages_any", lambda: bvh_paged.pages_any(cs, so, sd, 1e-3, lim, found, alo, ahi),
                lambda: first_any(lib, cs, so, sd, lim, found, alo, ahi)),
        "K4c": ("pages_closest", lambda: bvh_paged.pages_closest(cs, so, sd, 1e-3, seed),
                lambda: first_closest(lib, cs, so, sd, seed)),
        "K4d": ("pages_any", lambda: bvh_paged.pages_any(cs, so, sd, 1e-3, lim, unfound),
                lambda: first_any(lib, cs, so, sd, lim, unfound)),
    }


def _tensors(x):
    return [x] if isinstance(x, torch.Tensor) else [x.t, x.prim, x.u, x.v, *x.normal]


def bit_equal(a, b) -> bool:
    return all(S.same_bits(x, y) for x, y in zip(_tensors(a), _tensors(b)))


def check_bits(label, ws) -> bool:
    ok = True
    for name, (_sym, new, first) in ws.items():
        eq = bit_equal(new(), first())
        ok &= eq
        print(f"[bits] {name} {label}: bit-equal to the first design on every lane: {eq}",
              flush=True)
    torch.cuda.synchronize()
    if bvh.lane_counter(torch.device("cuda", 0)).any():
        raise SystemExit("the page walks left the lane counter nonzero")
    return ok


def main(argv) -> int:
    if len(argv) != 1:
        raise SystemExit(__doc__)
    S.phase_environment()
    S.phase_build()
    lib = build_first(Path(argv[0]).resolve())
    dev = torch.device("cuda", 0)
    _scene, cam, cs, _secs = S.big_scene(dev, S.B_SUB)
    print("[plans] " + "; ".join(
        f"{k} depth {depth} -> class {p.depth_class}, {per_sm} blocks of 256 a SM, grid {grid}"
        for k, (depth, p, per_sm, grid) in S.page_walk_plans(cs).items()))
    spread = S.camera_state(cs, cam, S.N_RAYS, dev, S.M_WIDTH, S.M_HEIGHT, S.M_DEPTH)
    chunk = S.camera_state(cs, cam, S.N_RAYS, dev, S.M_WIDTH, S.M_HEIGHT, S.M_DEPTH, stride=1)
    ok = True
    for label, (o, d, _t, key, depth) in (("spread", spread),
                                          ("bounced", S.advance_plain(cs, chunk, 3))):
        so, sd, lim = S.mesh_shadow(cs, o, d, key, depth, bvh.scene_closest(cs, o, d, 1e-3, 1e6))
        print(f"[set] {label}: {int((lim > 0).sum())} of {S.N_RAYS} shadow rays need an answer")
        ws = walks(lib, cs, o, d, so, sd, lim)
        ok &= check_bits(label, ws)
        for name, (sym, new, first) in ws.items():
            order = [("new", new, f"{sym}_persistent"), ("first design", first, f"{sym}_kernel")]
            got = {k: [] for k, _, _ in order}
            how = set()
            for k, fn, symbol in order + order[::-1]:
                ms, method = device_ms(fn, symbol)
                got[k].append(ms)
                how.add(method)
            new_ms, first_ms = (statistics.mean(got[k]) for k, _, _ in order)
            print(f"[turns] {name} {label} ({'/'.join(sorted(how))}): new {new_ms:.4f} ms "
                  f"({', '.join(f'{x:.4f}' for x in got['new'])}), first design {first_ms:.4f} ms "
                  f"({', '.join(f'{x:.4f}' for x in got['first design'])}) -> "
                  f"{new_ms / first_ms:.3f}x", flush=True)
    del cs, spread, chunk
    torch.cuda.empty_cache()
    _scene, cam, cs, _secs = S.big_scene(dev, S.K512_SUB)
    o, d, _t, key, depth = S.camera_state(cs, cam, S.N_RAYS, dev, S.M_WIDTH, S.M_HEIGHT, S.M_DEPTH)
    so, sd, lim = S.mesh_shadow(cs, o, d, key, depth, bvh.scene_closest(cs, o, d, 1e-3, 1e6))
    ok &= check_bits("512K spread", walks(lib, cs, o, d, so, sd, lim))
    print(S.card_line())
    print(f"[summary] every lane bit-equal to the first designs: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
