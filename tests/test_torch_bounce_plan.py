"""The host side of the persistent path bounce (K1), Whitted bounce (K2)
and fused pipe step (K7) on the CPU.

* ``ops/cuda/bounce.pack_scene_rec16``: the primitive-major records into
  which each K1 and K2 block copies the scene blob's primitives (the plain
  version of ``csrc/sweep.cuh`` stage_records) hold ``pack_scene_blob``'s
  fields, field for field, with zero padding, each record whole 16-byte
  rows, on the Cornell box (textured), on a scene with all four primitive
  types and on one with only the padding primitives of three.
* ``ops/cuda/bounce.sweep_plan``, ``bvh.smem_limit`` and ``bvh.launch_grid``:
  the shared bytes, the variant and the grid are pure functions of sizes,
  the SM count and the card's shared memory; a scene at the first design's
  48 KB limit is still accepted, and one past the card's limit is refused.
* K3a's and K3b's plan (``sweep_plan`` with no materials or lights): the
  records', within the card's limit, for every blob the first design took.
* ``ops/cuda/step.step_plan``: K7's shared bytes are K1's tables (the
  records, materials and light samples) at every size case, and its grid
  comes from ``launch_grid`` as K1's does.
* ``path_bounce``, ``whitted_bounce`` and ``path_step`` take their plain
  versions on CPU tensors and count no launch.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""
import ctypes
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import path_tracing__ray_tracer_tpu_torch as pt
from path_tracing__ray_tracer_tpu_torch.models import experimental
from path_tracing__ray_tracer_tpu_torch.ops.cuda import bounce, bvh, step, whitted
from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

NAMES = ("plane", "sphere", "quad", "triangle")
# the H100's and a 99 KB card's opt-in shared memory a block
H100, SMALL = 232_448, 101_376


def _four_types():
    """A plane, two spheres, a square of two triangles (merged into a quad)
    and a lone triangle, two light samples."""
    V, M = pt.Vec3, pt.Material
    scene = pt.Scene()
    scene.add_object(pt.Plane(V(-10, -2, 10), V(0, 1, 0), V(20, 0, 0), V(0, 0, -20), 20.0, 20.0,
                              M(V(0.2, 0.9, 0.3), diffuse=0.8, specular=0.1)))
    scene.add_object(pt.Sphere(V(0, 0, -5), 1.0, M(V(0.9, 0.1, 0.1), diffuse=0.7, specular=0.4)))
    scene.add_object(pt.Sphere(V(2.5, 0, -5), 1.0, M(V(0.9, 0.9, 0.9), diffuse=0.1,
                                                     refractive=0.85, ior=1.5)))
    blue = M(V(0.1, 0.2, 0.9), diffuse=0.9)
    a, b, c, d = V(-3, -1, -6), V(-1, -1, -6), V(-1, 1, -6), V(-3, 1, -6)
    uv = [np.array(x, np.float32) for x in ((0, 0), (1, 0), (1, 1), (0, 1))]
    scene.add_object(pt.Triangle(a, b, c, uv[0], uv[1], uv[2], material=blue))
    scene.add_object(pt.Triangle(a, c, d, uv[0], uv[2], uv[3], material=blue))
    scene.add_object(pt.Triangle(V(1, -1, -3), V(2, -1, -3), V(1.5, 0.5, -3.5), material=blue))
    scene.add_light_sample(V(0, 8, 0))
    scene.add_light_sample(V(1, 8, 1))
    return scene


def _spheres_only():
    scene = pt.Scene()
    scene.add_object(pt.Sphere(pt.Vec3(0, 0, -5), 1.0, pt.Material(pt.Vec3(1, 0, 0))))
    scene.add_light_sample(pt.Vec3(0, 8, 0))
    return scene


SCENES = {"cornell": lambda: pt.CustomSceneBuilder().build_scene(), "four types": _four_types,
          "spheres only": _spheres_only}


@pytest.fixture(scope="module", params=list(SCENES))
def compiled(request):
    return request.param, pt.compile_scene(SCENES[request.param](), device="cpu")


def test_rec16_is_the_blob_per_primitive(compiled):
    name, cs = compiled
    layout = bounce.blob_layout(cs)
    counts = layout[:4]
    rec = bounce.pack_scene_rec16(cs)
    blob = bounce.pack_scene_blob(cs)
    rl = bounce.rec_layout(counts)
    assert rec.shape == (rl.size,) and rec.is_contiguous() and rec.data_ptr() % 16 == 0
    assert rl.size % 4 == 0 and all(base % 4 == 0 for base in rl.bases)
    assert all(w % 4 == 0 and w - 4 < f <= w for f, w in zip(bounce.REC_FIELDS, bounce.REC_WIDTHS))
    fbases = (layout.plane_base, layout.sphere_base, layout.quad_base, layout.tri_base)
    for kind, count, rbase, fbase, fields, width in zip(NAMES, counts, rl.bases, fbases,
                                                        bounce.REC_FIELDS, bounce.REC_WIDTHS):
        recs = rec[rbase:rbase + width * count].view(count, width)
        for f in range(fields):  # field f of primitive i: blob[fbase + f·count + i]
            assert torch.equal(recs[:, f], blob[fbase + f * count:fbase + (f + 1) * count]), (
                kind, f)
        assert not recs[:, fields:].any(), kind  # zero padding
    if name == "four types":
        assert counts == (1, 2, 1, 1) and bool(rec.abs().sum() > 0)
    if name == "cornell":
        assert counts == (5, 3, 13, 1) and rl.size == 372
        assert bool((cs.materials.has_tex > 0.5).any())  # the textured scene


def _first_design_bytes(counts, n_mats, n_lights):
    return 4 * (14 * counts[0] + 4 * counts[1] + 18 * counts[2] + 18 * counts[3]
                + 10 * n_mats + 3 * n_lights)


# (P, S, Q, T), materials, light samples: the Cornell box; scenes whose
# field-major tables fill the first design's 48 KB exactly, mostly planes
# and mostly triangles; one past the H100's limit
CASES = {
    "cornell": ((5, 3, 13, 1), 22, 16),
    "48 KB of planes": ((506, 1, 1, 1), 514, 8),
    "48 KB of triangles": ((1, 1, 1, 435), 441, 4),
    "past the card": ((1, 1, 1, 6000), 6003, 16),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sweep_plan_is_a_function_of_sizes(case):
    counts, n_mats, n_lights = CASES[case]
    # the records, the material table padded to float4s, a float4 a light
    want = 4 * (bounce.rec_layout(counts).size + -(-10 * n_mats // 4) * 4 + 4 * n_lights)
    for optin in (H100, SMALL):
        limit = optin - 64  # ops/cuda/bvh.smem_limit
        if want > limit:
            assert case == "past the card"
            with pytest.raises(ValueError, match="shared memory"):
                bounce.sweep_plan("k", counts, n_mats, n_lights, limit)
            continue
        plan = bounce.sweep_plan("k", counts, n_mats, n_lights, limit)
        assert tuple(plan) == (want,)
        assert plan == bounce.sweep_plan("k", counts, n_mats, n_lights, limit)
    if case.startswith("48 KB"):
        # the first design took it with no attribute; the records pad it past
        # 48 KB, which the dynamic shared memory attribute allows
        assert _first_design_bytes(counts, n_mats, n_lights) == bounce._SMEM_LIMIT < want
    if case == "cornell":
        assert want == 4 * (372 + 220 + 64)


# (P, S, Q, T) of K3's scenes: the Cornell box; blobs that fill the first
# design's 48 KB, mostly planes and mostly triangles; one past the H100's limit
ISECT_CASES = {"cornell": (5, 3, 13, 1), "48 KB of planes": (874, 1, 1, 1),
               "48 KB of triangles": (1, 1, 1, 680), "past the card": (1, 1, 1, 3000)}


@pytest.mark.parametrize("case", list(ISECT_CASES))
def test_intersect_plan_is_the_records(case):
    """K3a's and K3b's shared bytes (``sweep_plan`` with no materials or
    lights) are the records' (``csrc/sweep.cuh`` rec_layout); a scene whose
    blob the first design took under 48 KB still fits, though its records
    pass 48 KB; one past the card's limit is refused."""
    counts = ISECT_CASES[case]
    want = 4 * bounce.rec_layout(counts).size
    for optin in (H100, SMALL):
        limit = optin - 64  # ops/cuda/bvh.smem_limit
        if want > limit:
            assert case == "past the card"
            with pytest.raises(ValueError, match="shared memory"):
                bounce.sweep_plan("k", counts, 0, 0, limit)
            continue
        assert tuple(bounce.sweep_plan("k", counts, 0, 0, limit)) == (want,)
    if case.startswith("48 KB"):
        first = 4 * (14 * counts[0] + 4 * counts[1] + 18 * counts[2] + 18 * counts[3])
        assert first <= bounce._SMEM_LIMIT < want
    if case == "cornell":
        assert want == 4 * 372


@pytest.mark.parametrize("n,n_sms,per_sm,want", [
    (131072, 132, 3, 396),  # the main path's chunk: the resident blocks
    (2_099_200, 132, 3, 396),  # the Whitted frame's chunk
    (131072, 132, 4, 512),  # one block a 256-lane batch, fewer than the resident 528
    (4133, 132, 3, 17), (1, 132, 3, 1), (33, 78, 2, 1),
])
def test_launch_grid_is_a_function_of_sizes_and_the_card(monkeypatch, n, n_sms, per_sm, want):
    """``launch_grid`` asks the occupancy entry once per plan, with the
    plan's fields, and launches the resident blocks or fewer."""
    card = SimpleNamespace(multi_processor_count=n_sms, shared_memory_per_block_optin=H100)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: card)
    monkeypatch.setattr(bvh, "_RESIDENT", {})
    asked = []

    def occupancy(smem, blocks):
        asked.append(smem)
        ctypes.cast(blocks, ctypes.POINTER(ctypes.c_int))[0] = per_sm
        return 0

    dev = SimpleNamespace(index=0)
    limit = bvh.smem_limit(dev)
    assert limit == H100 - 64
    plan = bounce.sweep_plan("k", (5, 3, 13, 1), 22, 16, limit)
    for _ in range(2):
        assert bvh.launch_grid("k", occupancy, plan, n, dev) == want
    assert asked == [2624] and want == bvh.persistent_grid(n, n_sms, per_sm)


def _sizes(counts, n_mats, n_lights):
    """What ``step_plan`` reads of a compiled scene."""
    P, S, Q, T = counts
    return SimpleNamespace(n_planes=P, n_spheres=S, n_quads=Q, n_triangles=T, n_lights=n_lights,
                           materials=SimpleNamespace(diffuse=torch.zeros(n_mats)))


@pytest.mark.parametrize("case", list(CASES))
def test_step_plan_is_k1s_tables(case):
    """K7 stages K1's tables: the records, the material table padded to
    float4s and a float4 a light sample, on both cards; refused past them."""
    counts, n_mats, n_lights = CASES[case]
    cs = _sizes(counts, n_mats, n_lights)
    for optin in (H100, SMALL):
        limit = optin - 64
        want = 4 * (bounce.rec_layout(counts).size + -(-10 * n_mats // 4) * 4 + 4 * n_lights)
        if want > limit:
            assert case == "past the card"
            with pytest.raises(ValueError, match="path_step: scene tables need"):
                step.step_plan(cs, limit)
            continue
        plan = step.step_plan(cs, limit)
        assert tuple(plan) == (want,)
        assert plan == bounce.sweep_plan("path_bounce", counts, n_mats, n_lights, limit)


# (P, S, Q, T) of K3's scenes: the Cornell box; blobs that fill the first
# design's 48 KB, mostly planes and mostly triangles; one past the H100's limit
ISECT_CASES = {"cornell": (5, 3, 13, 1), "48 KB of planes": (874, 1, 1, 1),
               "48 KB of triangles": (1, 1, 1, 680), "past the card": (1, 1, 1, 3000)}


@pytest.mark.parametrize("case", list(ISECT_CASES))
def test_intersect_plan_is_the_records(case):
    """K3a's and K3b's shared bytes (``sweep_plan`` with no materials or
    lights) are the records' (``csrc/sweep.cuh`` rec_layout); a scene whose
    blob the first design took under 48 KB still fits, though its records
    pass 48 KB; one past the card's limit is refused."""
    counts = ISECT_CASES[case]
    want = 4 * bounce.rec_layout(counts).size
    for optin in (H100, SMALL):
        limit = optin - 64  # ops/cuda/bvh.smem_limit
        if want > limit:
            assert case == "past the card"
            with pytest.raises(ValueError, match="shared memory"):
                bounce.sweep_plan("k", counts, 0, 0, limit)
            continue
        assert tuple(bounce.sweep_plan("k", counts, 0, 0, limit)) == (want,)
    if case.startswith("48 KB"):
        first = 4 * (14 * counts[0] + 4 * counts[1] + 18 * counts[2] + 18 * counts[3])
        assert first <= bounce._SMEM_LIMIT < want
    if case == "cornell":
        assert want == 4 * 372


@pytest.mark.parametrize("n,n_sms,per_sm,want", [
    (131072, 132, 3, 396),  # the pipe's chunk: the resident blocks
    (131077, 132, 4, 513),  # a ragged chunk: one block a 256-lane batch, fewer than 528
    (4133, 132, 3, 17), (1, 132, 4, 1), (33, 78, 2, 1),
])
def test_step_grid_is_a_function_of_sizes_and_the_card(monkeypatch, cornell, n, n_sms, per_sm,
                                                        want):
    """K7's grid: ``launch_grid`` with the Cornell box's step plan, the
    occupancy entry asked once with its shared bytes (card monkeypatched)."""
    card = SimpleNamespace(multi_processor_count=n_sms, shared_memory_per_block_optin=H100)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: card)
    monkeypatch.setattr(bvh, "_RESIDENT", {})
    asked = []

    def occupancy(smem, blocks):
        asked.append(smem)
        ctypes.cast(blocks, ctypes.POINTER(ctypes.c_int))[0] = per_sm
        return 0

    dev = SimpleNamespace(index=0)
    plan = step.step_plan(cornell, bvh.smem_limit(dev))
    for _ in range(2):
        assert bvh.launch_grid("path_step", occupancy, plan, n, dev) == want
    assert asked == [2624] and want == bvh.persistent_grid(n, n_sms, per_sm)


@pytest.fixture(scope="module")
def cornell():
    return pt.compile_scene(pt.CustomSceneBuilder().build_scene(), device="cpu")


def _rays(n, seed):
    g = torch.Generator().manual_seed(seed)
    o = V3(*(torch.zeros(n) for _ in range(2)), torch.full((n,), 50.0))
    d = V3(torch.rand(n, generator=g) * 0.8 - 0.4, torch.rand(n, generator=g) * 0.8 - 0.4,
           -torch.ones(n)).normalized()
    return o, d


def _same(a, b):
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def test_bounces_take_their_plain_versions_on_the_cpu(cornell):
    n = 64
    o, d = _rays(n, 7)
    thr = V3(*(torch.ones(n) for _ in range(3)))
    key = torch.arange(n, dtype=torch.int32) * 7919
    depth = torch.arange(n, dtype=torch.int32) % 5
    blobs = (bounce.pack_scene_blob(cornell), bounce.pack_mat_blob(cornell),
             bounce.pack_light_blob(cornell))
    before = (bounce.path_bounce.launches, whitted.whitted_bounce.launches)
    for shadow_light in (False, True):
        got = bounce.path_bounce(cornell, *blobs, o, d, thr, key, depth,
                                 shadow_light=shadow_light)
        want = bounce.path_bounce_plain(cornell, o, d, thr, key, depth,
                                        shadow_light=shadow_light)
        assert all(_same(a, b) for a, b in zip(got, want)) and bool(got.hit.any())
    got = whitted.whitted_bounce(cornell, *blobs, o, d, whitted.TEXTURE)
    want = whitted.whitted_bounce_plain(cornell, o, d, whitted.TEXTURE)
    assert all(_same(a, b) for a, b in zip(got, want)) and bool(got.hit.any())
    assert before == (bounce.path_bounce.launches, whitted.whitted_bounce.launches)


def test_step_takes_its_plain_version_on_the_cpu(cornell):
    """``path_step`` on CPU tensors is ``path_step_plain``, output for output,
    after a plain step (some lanes retired), and counts no launch."""
    blobs = (bounce.pack_scene_blob(cornell), bounce.pack_mat_blob(cornell),
             bounce.pack_light_blob(cornell))
    cam12 = pt.pack_camera(pt.CustomSceneBuilder().create_camera(2.0), "cpu")
    st, tables, scal, lane = experimental.pipe_start(
        cornell, blobs, cam12, 0, 3, 0, n_pix=64, width=16, height=8, n_samples=1, max_depth=2,
        jitter="independent")
    before = step.path_step.launches
    for _ in range(2):
        args = (cornell, st, tables, cam12, scal, lane[0],
                experimental.step_texel(cornell, st, lane[0]), *lane[1:])
        got, want = step.path_step(*args), step.path_step_plain(*args)
        assert _same(got, want)
        lane = (got[0],) + got[3:11]
    assert bool((lane[5] == st.ns).any()) and bool(got[0].hit.any())
    assert step.path_step.launches == before
