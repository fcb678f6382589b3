"""The CUDA kernels against their plain torch versions, on an NVIDIA GPU:
the path-tracer bounce (K1), the Whitted bounce (K2), the standalone
closest-hit / any-hit sweeps (K3a, K3b) and, on a BVH mesh scene, the
scene walks (K4a, K4b), the BVH path bounce (K5), the triangle-only walks
over the whole tree (K4c, K4d) and, on the mesh with paging forced, the
two-level walk (K6a-d); the fused scheduler step (K7), the atlas and mip
gathers (K8, K9), and the path tracer's modes launching them; the split
BVH route's walks, the BVH2 walks (K4e) and the rooted multipass walk
(K11), and the path tracer launching them on a forced route or a BVH4 too
deep for the BVH4 walks; the walks through the leaf coefficient table
(K10a-d) and the path tracer launching them on its two routes; the
persistent K4b and K5 against their plain versions, with the node table in
shared memory and out of it, on ragged lane counts, none, and two launches
back to back; the persistent page walks K6c and K6d (and K4c and K4d over
the whole tree) against their plain versions in both depth classes; the
persistent K11 and ordered BVH2 closest walk against their plain versions
in both of their classes, at a ragged lane count, K11 with most lanes
idle; the persistent ordered BVH2 occlusion walk in both classes, on the
mesh and on the 190-deep chain (whose lanes overflow the shallow class),
and the persistent K10c in both classes, at ragged lane counts; the
persistent K10b and K10d in both classes, with infinite, finite and
non-positive limits and found lanes; the persistent K1 and K2 at 131,072,
4,133 and 1 lanes (K1's hit, prim and killed on every lane), and none; the
persistent K7 at 131,077 and 4,133 lanes, none, and queued with K1; the
persistent top walks K6a and K6b on the 48-page mesh whose top leaves hold
triangles, staged and read from device memory, in both depth classes, at
131,077 and 4,133 lanes, staged at 262,149 (past its resident blocks), and
none; the persistent K4a and K10a at 262,149 lanes, with t_max 1e30 and
+inf, in both classes, and none; the persistent K3a and K3b at 131,077
and 262,149 lanes (past their resident blocks) and on the oracle frame's
level 0 (262,144 camera rays and their 4,194,304 shadow rays); and K4a,
K4b, K5, K6a-d, K11, the two ordered walks, the skip-link walks, K10a-d,
K1, K2, K3a and K3b queued on one stream, which share its lane counter; and
the (tile × sample) split on four entries of the card against one device,
and ``graft_entry.entry()`` against the path tracer's chunk.

The kernel has no CPU mode, so every test here is marked ``cuda`` and skips
without a card.  The file imports no JAX (the GPU machine has none); run it
there without the JAX-configuring ``conftest.py``:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Bars as in ``chip_smoke.py``: hit and the winning primitive on ≥ 99.99% of
lanes, ``killed`` on ≥ 99.9%, occlusion on ≥ 99.99%, float fields within
``atol = rtol = 1e-4`` on lanes where both hit; K7's integer and 0/1
outputs equal on every lane, K8's and K9's colours bit for bit.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import path_tracing__ray_tracer_tpu_torch as pt
from path_tracing__ray_tracer_tpu_torch.ops import bvh as tbvh
from path_tracing__ray_tracer_tpu_torch.ops import intersect as plain
from path_tracing__ray_tracer_tpu_torch.models import experimental
from path_tracing__ray_tracer_tpu_torch.models import path_tracer as tpath
from path_tracing__ray_tracer_tpu_torch.ops.cuda import (
    bounce, bounce_bvh, bvh, bvh2, bvh_leafmat, bvh_paged, intersect, step, texture, whitted)
from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3

TOL = 1e-4
FLOATS = ("w_sky", "w_nee", "rr_scale", "s_thr", "t_thr", "new_org", "new_dir", "u", "v",
          "tex_id", "mat_color")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    dev = torch.device("cuda")
    cs = pt.compile_scene(pt.CustomSceneBuilder().build_scene(), device=dev)
    blobs = (bounce.pack_scene_blob(cs), bounce.pack_mat_blob(cs), bounce.pack_light_blob(cs))
    return dev, cs, blobs


def _inputs(n, seed, dev):
    """Half camera rays, half rays from inside the box; random throughput,
    keys on both sides of the int32 sign bit, depths 0-5."""
    g = np.random.default_rng(seed)
    ro = g.uniform(-14, 14, (n, 3)).astype(np.float32)
    rd = g.normal(size=(n, 3)).astype(np.float32)
    ro[: n // 2] = [0, 0, 50]
    rd[: n // 2, 2] = -np.abs(rd[: n // 2, 2]) - 2.0
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    thr = g.uniform(0.02, 1.5, (n, 3)).astype(np.float32)
    key = g.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32).view(np.int32)
    depth = (np.arange(n) % 6).astype(np.int32)
    o, d, t = (V3(*(torch.from_numpy(a[:, i].copy()).to(dev) for i in range(3)))
               for a in (ro, rd, thr))  # contiguous components, as the kernel takes
    return o, d, t, torch.from_numpy(key).to(dev), torch.from_numpy(depth).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("shadow_light", [False, True])
@pytest.mark.parametrize("n", [131072, 4096 + 37])  # the bench chunk; a ragged tail
def test_kernel_matches_plain(card, n, shadow_light):
    dev, cs, blobs = card
    o, d, thr, key, depth = _inputs(n, n, dev)
    before = bounce.path_bounce.launches
    got = bounce.path_bounce(cs, *blobs, o, d, thr, key, depth, shadow_light=shadow_light)
    torch.cuda.synchronize()
    assert bounce.path_bounce.launches == before + 1
    want = bounce.path_bounce_plain(cs, o, d, thr, key, depth, shadow_light=shadow_light)

    same = (got.hit == want.hit) & (got.prim == want.prim)
    assert float(same.float().mean()) >= 0.9999
    assert float((got.killed == want.killed).float().mean()) >= 0.999
    lanes = same & got.hit & (got.killed == want.killed)
    for f in FLOATS:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(a, tuple):
            a, b, m = torch.stack(list(a)), torch.stack(list(b)), lanes.expand(3, -1)
        else:
            m = lanes
        torch.testing.assert_close(a[m], b[m], rtol=TOL, atol=TOL, msg=f)
    assert 0.2 < float(got.hit.float().mean()) < 1.0


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    dev, cs, blobs = card
    o, d, thr, key, depth = _inputs(256, 5, dev)
    before = bounce.path_bounce.launches
    bad_inputs = [
        (V3(o.x.double(), o.y, o.z), d, thr, key, depth),  # dtype
        (o, d, thr, key.long(), depth),  # key must be int32 bits
        (o, V3(d.x[:-1], d.y, d.z), thr, key, depth),  # shape
        (o, d, thr, key, depth.cpu()),  # device
        (V3(torch.zeros(256, 2, device=dev)[:, 0], o.y, o.z), d, thr, key, depth),  # strides
    ]
    for args in bad_inputs:
        with pytest.raises(ValueError):
            bounce.path_bounce(cs, *blobs, *args)
    assert bounce.path_bounce.launches == before


@pytest.mark.cuda
def test_main_path_launches_the_kernel(card):
    dev, _, _ = card
    b = pt.CustomSceneBuilder()
    r = pt.RendererFactory.create("cuda_path_raytracer", seed=1, device=dev)
    before = bounce.path_bounce.launches
    sums = r.render_sums(b.build_scene(), b.create_camera(1.0),
                         pt.RenderSettings(width=64, height=64, samples_per_pixel=4, max_depth=4))
    assert bounce.path_bounce.launches > before
    assert sums.shape == (64 * 64, 3) and np.isfinite(sums).all() and (sums >= 0).all()


def _assert_floats_close(got, want, lanes, fields):
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(a, tuple):
            a, b, m = torch.stack(list(a)), torch.stack(list(b)), lanes.expand(3, -1)
        else:
            m = lanes
        torch.testing.assert_close(a[m], b[m], rtol=TOL, atol=TOL, msg=f)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["basic", "texture"])
@pytest.mark.parametrize("n", [131072, 4096 + 37])
def test_whitted_kernel_matches_plain(card, n, variant):
    dev, cs, blobs = card
    var = whitted.BASIC if variant == "basic" else whitted.TEXTURE
    o, d, _, _, _ = _inputs(n, n + 1, dev)
    before = whitted.whitted_bounce.launches
    got = whitted.whitted_bounce(cs, *blobs, o, d, var)
    torch.cuda.synchronize()
    assert whitted.whitted_bounce.launches == before + 1
    want = whitted.whitted_bounce_plain(cs, o, d, var)
    same = (got.hit == want.hit) & (got.prim == want.prim)
    assert float(same.float().mean()) >= 0.9999
    lanes = same & got.hit
    assert bool((got.cont[lanes] == want.cont[lanes]).all())
    _assert_floats_close(got, want, lanes, ("a", "w", "mult", "new_org", "new_dir", "u", "v",
                                            "tex_id", "mat_color"))
    assert 0.2 < float(got.hit.float().mean()) < 1.0 and bool(got.cont.any())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [131072, 4096 + 37, 1])
def test_persistent_bounces_match_plain(card, n):
    """The persistent K1 and K2 (primitive-major records, lanes from the
    stream's counter) against their plain versions: K1's hit, prim and
    killed on every lane and its floats within tolerance on the hit lanes,
    K2 under ``test_whitted_kernel_matches_plain``'s bars; the counter left
    zero."""
    dev, cs, blobs = card
    o, d, thr, key, depth = _inputs(n, n + 3, dev)
    before = (bounce.path_bounce.launches, whitted.whitted_bounce.launches)
    for shadow_light in (False, True):
        got = bounce.path_bounce(cs, *blobs, o, d, thr, key, depth, shadow_light=shadow_light)
        torch.cuda.synchronize()
        want = bounce.path_bounce_plain(cs, o, d, thr, key, depth, shadow_light=shadow_light)
        for f in ("hit", "prim", "killed"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        _assert_floats_close(got, want, got.hit, FLOATS)
    for var in (whitted.BASIC, whitted.TEXTURE):
        got = whitted.whitted_bounce(cs, *blobs, o, d, var)
        torch.cuda.synchronize()
        want = whitted.whitted_bounce_plain(cs, o, d, var)
        same = (got.hit == want.hit) & (got.prim == want.prim)
        assert float(same.float().mean()) >= 0.9999
        lanes = same & got.hit
        assert bool((got.cont[lanes] == want.cont[lanes]).all())
        _assert_floats_close(got, want, lanes, ("a", "w", "mult", "new_org", "new_dir", "u", "v",
                                                "tex_id", "mat_color"))
    assert (bounce.path_bounce.launches, whitted.whitted_bounce.launches) == (
        before[0] + 2, before[1] + 2)
    assert not bvh.lane_counter(dev).any()


@pytest.mark.cuda
def test_persistent_bounces_launch_nothing_on_no_lanes(card):
    dev, cs, blobs = card
    o, d, thr, key, depth = _inputs(0, 1, dev)
    before = (bounce.path_bounce.launches, whitted.whitted_bounce.launches)
    assert bounce.path_bounce(cs, *blobs, o, d, thr, key, depth).prim.shape == (0,)
    assert whitted.whitted_bounce(cs, *blobs, o, d, whitted.TEXTURE).prim.shape == (0,)
    assert before == (bounce.path_bounce.launches, whitted.whitted_bounce.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [131072, 4096 + 37])
def test_intersect_kernels_match_plain(card, n):
    dev, cs, blobs = card
    o, d, _, _, _ = _inputs(n, n + 2, dev)
    before = (intersect.closest_hit.launches, intersect.any_hit.launches)
    got = intersect.closest_hit(cs, blobs[0], o, d, 1e-3, 1e6)
    t_max = torch.rand(n, generator=torch.Generator(device=dev).manual_seed(n), device=dev) * 60
    occ = intersect.any_hit(cs, blobs[0], o, d, 1e-3, t_max)
    torch.cuda.synchronize()
    assert (intersect.closest_hit.launches, intersect.any_hit.launches) == (
        before[0] + 1, before[1] + 1)
    want = intersect.closest_hit_plain(cs, o, d, 1e-3, 1e6)
    same = got.prim == want.prim
    assert float(same.float().mean()) >= 0.9999
    _assert_floats_close(got, want, same, ("t", "normal", "u", "v"))
    want_occ = intersect.any_hit_plain(cs, o, d, 1e-3, t_max)
    assert float((occ == want_occ).float().mean()) >= 0.9999
    assert 0.1 < float(occ.float().mean()) < 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("n", [131072 + 5, 2 * 131072 + 5])  # past the resident blocks
def test_persistent_intersect_kernels_match_plain(card, n):
    """The persistent K3a (t_max 1e6, 1e30, +inf) and K3b (per-ray bounds, a
    seventh of them -1, a seventh +inf) against their plain versions, the
    lane counter left zero."""
    dev, cs, blobs = card
    o, d, _, _, _, limit = _persistent_inputs(n, dev)
    limit = torch.where(torch.arange(n, device=dev) % 7 == 3, float("inf"), limit)
    for t_max in (1e6, 1e30, float("inf")):
        got = intersect.closest_hit(cs, blobs[0], o, d, 1e-3, t_max)
        torch.cuda.synchronize()
        assert not bvh.lane_counter(dev).any()
        want = intersect.closest_hit_plain(cs, o, d, 1e-3, t_max)
        same = got.prim == want.prim
        assert float(same.float().mean()) >= 0.9999
        _assert_floats_close(got, want, same, ("t", "normal", "u", "v"))
    occ = intersect.any_hit(cs, blobs[0], o, d, 1e-3, limit)
    torch.cuda.synchronize()
    assert not bvh.lane_counter(dev).any()
    want_occ = intersect.any_hit_plain(cs, o, d, 1e-3, limit)
    assert float((occ == want_occ).float().mean()) >= 0.9999
    assert not occ[limit < 0].any()


@pytest.mark.cuda
def test_intersect_kernels_on_the_oracle_shadow_batch(card):
    """K3a on level 0 of the oracle frame's first chunk (320x240, 4 spp,
    depth 6: 262,144 camera rays, t_max 1e30) and K3b on its shadow batch
    (16 light samples x 262,144 lanes = 4,194,304 rays, each bounded at its
    light), as the renderer makes them; occlusion compared where level 0
    hit (the renderer discards a miss's shading)."""
    import math

    from path_tracing__ray_tracer_tpu_torch.compiler import pack_camera
    from path_tracing__ray_tracer_tpu_torch.models import whitted_oracle as wo
    from path_tracing__ray_tracer_tpu_torch.models.whitted import grid_camera_rays

    dev = card[0]
    b = pt.CustomSceneBuilder()
    r = pt.RendererFactory.create("cpu_raytracer", seed=0, device=dev)
    cs = r.compiled(b.build_scene())
    blob = r.blobs(cs)[0]
    n_pix, group = r._plan(320, 240, 4, 6)
    o, d = grid_camera_rays(pack_camera(b.create_camera(4 / 3), dev), 0, n_pix, 320, 240, 0, 0,
                            group, math.isqrt(group), 6, r.jitter)
    got = intersect.closest_hit(cs, blob, o, d, wo._T_MIN, wo._T_FAR)
    want = intersect.closest_hit_plain(cs, o, d, wo._T_MIN, wo._T_FAR)
    same = got.prim == want.prim
    assert float(same.float().mean()) >= 0.9999
    _assert_floats_close(got, want, same, ("t", "normal", "u", "v"))
    so, sd, dist = wo.shadow_rays(cs, *wo.surface(o, d, want))
    so, sd = (V3(*(c.reshape(-1) for c in v)) for v in (so, sd))
    dist = dist.reshape(-1)
    assert dist.shape == (4_194_304,)
    occ = intersect.any_hit(cs, blob, so, sd, wo._T_MIN, dist)
    torch.cuda.synchronize()
    assert not bvh.lane_counter(dev).any()
    lanes = want.hit.expand(cs.n_lights, -1).reshape(-1)
    want_occ = intersect.any_hit_plain(cs, so, sd, wo._T_MIN, dist)
    assert float((occ == want_occ)[lanes].float().mean()) >= 0.9999


@pytest.mark.cuda
@pytest.mark.parametrize("name,counter", [
    ("cuda_texture_raytracer", lambda: whitted.whitted_bounce.launches),
    ("cuda_raytracer", lambda: whitted.whitted_bounce.launches),
    ("cpu_raytracer", lambda: intersect.closest_hit.launches + intersect.any_hit.launches),
])
def test_renderers_launch_their_kernels(card, name, counter):
    b = pt.CustomSceneBuilder()
    r = pt.RendererFactory.create(name, seed=1)
    before = counter()
    sums = r.render_sums(b.build_scene(), b.create_camera(1.0),
                         pt.RenderSettings(width=64, height=64, samples_per_pixel=4, max_depth=4))
    assert counter() > before
    assert sums.shape == (64 * 64, 3) and np.isfinite(sums).all() and (sums >= 0).all()


@pytest.fixture(scope="module")
def mesh_card(card):
    dev = card[0]
    cs = pt.compile_scene(pt.MeshSceneBuilder(grid=3, subdivisions=3).build_scene(), device=dev)
    return dev, cs, bounce_bvh.pack_bvh_tables(cs)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [131072, 4096 + 37, 2 * 131072 + 5])
def test_bvh_scene_kernels_match_plain(mesh_card, n):
    """K4a and K4b against their plain versions, 262,149 lanes past the
    resident ones; K4a also with t_max 1e30 and +inf, each bound's record
    bit-equal with the tree reported 20 deep (stack class 32); the lane
    counter left zero."""
    dev, cs, _ = mesh_card
    deep = cs._replace(bvh=cs.bvh._replace(depth4=20))
    assert (bvh.closest_plan(cs).depth_class, bvh.closest_plan(deep).depth_class) == (8, 32)
    o, d, _, _, _ = _inputs(n, n + 3, dev)
    before = (bvh.scene_closest.launches, bvh.scene_any.launches)
    got = bvh.scene_closest(cs, o, d, 1e-3, 1e6)
    limit = torch.where(torch.arange(n, device=dev) % 7 == 0, -1.0,
                        torch.rand(n, generator=torch.Generator(device=dev).manual_seed(n),
                                   device=dev) * 60)
    occ = bvh.scene_any(cs, o, d, 1e-3, limit)
    torch.cuda.synchronize()
    assert (bvh.scene_closest.launches, bvh.scene_any.launches) == (before[0] + 1, before[1] + 1)
    want = plain.scene_hit_bvh_plain(cs, o, d, 1e-3, 1e6)
    same = got.prim == want.prim
    assert float(same.float().mean()) >= 0.9999 and 0.2 < float(got.hit.float().mean()) < 1.0
    _assert_floats_close(got, want, same & got.hit, ("t", "normal", "u", "v"))
    care = limit > 0
    want_occ = plain.scene_hit_any_bvh_plain(cs, o, d, 1e-3, limit)
    assert float((occ == want_occ)[care].float().mean()) >= 0.9999
    assert bool(occ[~care].all()) and 0.05 < float(occ[care].float().mean()) < 0.95
    for t_max in (1e30, float("inf")):
        got = bvh.scene_closest(cs, o, d, 1e-3, t_max)
        want = plain.scene_hit_bvh_plain(cs, o, d, 1e-3, t_max)
        same = got.prim == want.prim
        assert float(same.float().mean()) >= 0.9999 and bool(got.hit.any())
        _assert_floats_close(got, want, same & got.hit, ("t", "normal", "u", "v"))
    for t_max in (1e6, 1e30, float("inf")):
        _assert_same_bits(bvh.scene_closest(deep, o, d, 1e-3, t_max),
                          bvh.scene_closest(cs, o, d, 1e-3, t_max))
    torch.cuda.synchronize()
    assert not bvh.lane_counter(dev).any()


@pytest.mark.cuda
@pytest.mark.parametrize("shadow_light", [False, True])
def test_bvh_bounce_kernel_matches_plain(mesh_card, shadow_light):
    dev, cs, tables = mesh_card
    o, d, thr, key, depth = _inputs(131072, 11, dev)
    before = (bounce_bvh.path_bounce_bvh.launches, bvh.scene_any.launches)
    got = bounce_bvh.path_bounce_bvh(cs, tables, o, d, thr, key, depth, shadow_light=shadow_light)
    torch.cuda.synchronize()
    assert (bounce_bvh.path_bounce_bvh.launches, bvh.scene_any.launches) == (
        before[0] + 1, before[1] + 1)
    # the plain bounce's scene_hit / scene_hit_any launch K4a / K4b on the card,
    # which the test above holds against their plain versions
    want = bounce.path_bounce_plain(cs, o, d, thr, key, depth, shadow_light=shadow_light)
    same = (got.hit == want.hit) & (got.prim == want.prim)
    assert float(same.float().mean()) >= 0.9999
    assert float((got.killed == want.killed).float().mean()) >= 0.999
    lanes = same & got.hit & (got.killed == want.killed)
    _assert_floats_close(got, want, lanes, FLOATS)
    assert bool((got.w_nee[lanes] > 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("name,counters", [
    ("cuda_path_raytracer", lambda: (bounce_bvh.path_bounce_bvh.launches, bvh.scene_any.launches)),
    ("cuda_texture_raytracer", lambda: (bvh.scene_closest.launches, bvh.scene_any.launches)),
])
def test_mesh_renderers_launch_their_kernels(mesh_card, name, counters):
    b = pt.MeshSceneBuilder(grid=2, subdivisions=1)
    r = pt.RendererFactory.create(name, seed=1)
    before = counters()
    sums = r.render_sums(b.build_scene(), b.create_camera(1.0),
                         pt.RenderSettings(width=64, height=64, samples_per_pixel=4, max_depth=4))
    assert all(a > b for a, b in zip(counters(), before))
    assert sums.shape == (64 * 64, 3) and np.isfinite(sums).all() and (sums >= 0).all()


def _bits(x):
    """A record's tensors by name, floats as their int32 bit patterns (a
    plain tuple's or list's by position)."""
    if isinstance(x, (tuple, list)) and not hasattr(x, "_fields"):
        return {f"{i}.{k}": t for i, part in enumerate(x) for k, t in _bits(part).items()}
    if not hasattr(x, "_fields"):
        return {"": x.view(torch.int32) if x.dtype == torch.float32 else x}
    out = {}
    for f in x._fields:
        v = getattr(x, f)
        parts = zip("xyz", v) if isinstance(v, tuple) else [("", v)]
        out.update({f + c: t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t
                    for c, t in parts})
    return out


def _assert_same_bits(got, other):
    want = _bits(other)
    for k, t in _bits(got).items():
        assert torch.equal(t, want[k]), k


def _persistent_inputs(n, dev):
    o, d, thr, key, depth = _inputs(n, n + 5, dev)
    limit = torch.where(torch.arange(n, device=dev) % 7 == 0, -1.0,
                        torch.rand(n, generator=torch.Generator(device=dev).manual_seed(n),
                                   device=dev) * 60)
    return o, d, thr, key, depth, limit


@pytest.mark.cuda
@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("n", [1, 31, 33, 131089])
def test_persistent_walks_match_plain(mesh_card, monkeypatch, staged, n):
    """The persistent K4b and K5 against their plain versions (occlusion on
    every ray that needs an answer; hit, prim and killed on every lane),
    with the node table staged in shared memory (the budget lifted) and
    read from device memory (no budget)."""
    dev, cs, tables = mesh_card
    monkeypatch.setattr(bvh, "SMEM_TREE_BYTES", 1 << 30 if staged else 0)
    assert bvh.any_plan(cs, bvh.smem_limit(dev)).stage == staged
    assert bounce_bvh.bounce_plan(cs, tables, bvh.smem_limit(dev)).stage == staged
    o, d, thr, key, depth, limit = _persistent_inputs(n, dev)
    before = (bvh.scene_any.launches, bounce_bvh.path_bounce_bvh.launches)
    occ = bvh.scene_any(cs, o, d, 1e-3, limit)
    got = bounce_bvh.path_bounce_bvh(cs, tables, o, d, thr, key, depth, shadow_light=True)
    torch.cuda.synchronize()
    assert (bvh.scene_any.launches, bounce_bvh.path_bounce_bvh.launches) == (
        before[0] + 2, before[1] + 1)
    care = limit > 0
    want_occ = plain.scene_hit_any_bvh_plain(cs, o, d, 1e-3, limit)
    assert torch.equal(occ[care], want_occ[care]) and bool(occ[~care].all())
    want = bounce.path_bounce_plain(cs, o, d, thr, key, depth, shadow_light=True)
    assert torch.equal(got.hit, want.hit) and torch.equal(got.prim, want.prim)
    assert torch.equal(got.killed, want.killed)
    _assert_floats_close(got, want, got.hit, FLOATS)


@pytest.mark.cuda
@pytest.mark.parametrize("grid,subdivisions", [(3, 3), (2, 1)])
def test_occlusion_walks_with_infinite_bounds(mesh_card, grid, subdivisions):
    """Shadow rays with an infinite bound (the oracle's rays from missed
    lanes) enter the empty children's point boxes at +3e38; the walks must
    not push them (that re-walked the tree and overran the shallow stack)."""
    dev = mesh_card[0]
    cs = pt.compile_scene(pt.MeshSceneBuilder(grid=grid, subdivisions=subdivisions).build_scene(),
                          device=dev, use_bvh=True)
    o, d, _thr, _key, _depth = _inputs(4096, 17, dev)
    d = V3(*(x.abs().contiguous() for x in d))  # toward +x, +y, +z: every slab of +3e38 is +inf
    limit = torch.full((4096,), float("inf"), device=dev)
    occ = bvh.scene_any(cs, o, d, 1e-3, limit)
    torch.cuda.synchronize()
    assert torch.equal(occ, plain.scene_hit_any_bvh_plain(cs, o, d, 1e-3, limit))


@pytest.mark.cuda
def test_persistent_walks_launch_nothing_on_no_lanes(mesh_card):
    dev, cs, tables = mesh_card
    o, d, thr, key, depth, limit = _persistent_inputs(0, dev)
    wrappers = (bvh.scene_closest, bvh.scene_any, bounce_bvh.path_bounce_bvh, bvh2.any_ordered,
                bvh2.closest_skiplink, bvh2.any_skiplink, bvh_leafmat.scene_closest,
                bvh_leafmat.tri_closest, bvh_leafmat.scene_any, bvh_leafmat.tri_any)
    before = [w.launches for w in wrappers]
    assert bvh.scene_closest(cs, o, d, 1e-3, 1e6).t.shape == (0,)
    assert bvh_leafmat.scene_closest(cs, o, d, 1e-3, 1e6).prim.shape == (0,)
    assert bvh.scene_any(cs, o, d, 1e-3, limit).shape == (0,)
    out = bounce_bvh.path_bounce_bvh(cs, tables, o, d, thr, key, depth)
    assert bvh2.any_ordered(cs, o, d, 1e-3, limit).shape == (0,)
    assert bvh2.any_skiplink(cs, o, d, 1e-3, limit).shape == (0,)
    assert bvh2.closest_skiplink(cs, o, d, 1e-3, 1e6)[0].shape == (0,)
    assert bvh_leafmat.tri_closest(cs, o, d, 1e-3, _seed(limit)).t.shape == (0,)
    assert bvh_leafmat.scene_any(cs, o, d, 1e-3, limit).shape == (0,)
    assert bvh_leafmat.tri_any(cs, o, d, 1e-3, limit, limit > 0).shape == (0,)
    torch.cuda.synchronize()
    assert out.hit.shape == (0,) and out.prim.shape == (0,)
    assert [w.launches for w in wrappers] == before


@pytest.mark.cuda
def test_persistent_walks_back_to_back_on_one_stream(mesh_card):
    """Two launches of each queued without a sync between them (each leaves
    the stream's lane counter zero for the next) answer bit for bit as each
    does alone after a sync, and as the plain versions on every lane."""
    dev, cs, tables = mesh_card
    sets = [_persistent_inputs(n, dev) for n in (131072, 4096 + 37)]
    calls = [c for o, d, thr, key, depth, limit in sets for c in (
        lambda o=o, d=d, limit=limit: bvh.scene_any(cs, o, d, 1e-3, limit),
        lambda o=o, d=d, thr=thr, key=key, depth=depth: bounce_bvh.path_bounce_bvh(
            cs, tables, o, d, thr, key, depth))]
    queued = [call() for call in calls[::2]] + [call() for call in calls[1::2]]
    torch.cuda.synchronize()
    assert not bvh.lane_counter(dev).any()
    for call, got in zip(calls[::2] + calls[1::2], queued):
        _assert_same_bits(got, call())
    for (o, d, _thr, _key, _depth, limit), occ in zip(sets, queued[:2]):
        care = limit > 0
        want = plain.scene_hit_any_bvh_plain(cs, o, d, 1e-3, limit)
        assert torch.equal(occ[care], want[care])


@pytest.mark.cuda
def test_per_ray_bound_walks_match_plain(mesh_card):
    """K4c (``scene_closest`` with a per-ray bound) and K4d (the whole-tree
    occlusion walk) against their plain versions."""
    dev, cs, _ = mesh_card
    n = 131072
    o, d, _, _, _ = _inputs(n, 17, dev)
    bound = torch.rand(n, generator=torch.Generator(device=dev).manual_seed(17), device=dev) * 60
    before = (bvh_paged.pages_closest.launches, bvh_paged.pages_any.launches)
    got = bvh.scene_closest(cs, o, d, 1e-3, bound)
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    occ = bvh_paged.pages_any(cs, o, d, 1e-3, bound, found)
    torch.cuda.synchronize()
    assert (bvh_paged.pages_closest.launches, bvh_paged.pages_any.launches) == (
        before[0] + 1, before[1] + 1)
    want = plain.scene_hit_bvh_plain(cs, o, d, 1e-3, bound)
    same = got.prim == want.prim
    assert float(same.float().mean()) >= 0.9999 and 0.2 < float(got.hit.float().mean()) < 1.0
    _assert_floats_close(got, want, same & got.hit, ("t", "normal", "u", "v"))
    want_occ = tbvh.traverse_any(cs.bvh, cs.triangles, o, d, 1e-3, bound)
    assert float((occ == want_occ).float().mean()) >= 0.9999 and bool(occ.any())


@pytest.fixture(scope="module")
def paged_card(card):
    """The config-5 mesh cut into 36 pages of at most 8,000 floats (paging
    forced), so both pending words are used; its one-level records stay."""
    dev = card[0]
    saved = tbvh.ONE_LEVEL_LIMIT, tbvh.PAGE_BUDGET_FLOATS
    tbvh.ONE_LEVEL_LIMIT, tbvh.PAGE_BUDGET_FLOATS = 0, 8000
    try:
        cs = pt.compile_scene(pt.MeshSceneBuilder(grid=3, subdivisions=3).build_scene(), device=dev)
    finally:
        tbvh.ONE_LEVEL_LIMIT, tbvh.PAGE_BUDGET_FLOATS = saved
    assert cs.bvh.paged.n_pages == 36
    return dev, cs


@pytest.mark.cuda
@pytest.mark.parametrize("n", [131072, 4096 + 37])
def test_paged_kernels_match_plain(paged_card, n):
    """K6a + K6c and K6b + K6d against the plain paged walks, and against the
    one-level K4a / K4b; K6a's pending words hold every page whose root box
    the lane enters at its final ``t``."""
    dev, cs = paged_card
    o, d, _, _, _ = _inputs(n, n + 5, dev)
    fns = (bvh_paged.paged_top_closest, bvh_paged.paged_top_any, bvh_paged.pages_closest,
           bvh_paged.pages_any)
    before = [f.launches for f in fns]
    got = bvh.scene_closest(cs, o, d, 1e-3, 1e6)
    limit = torch.where(torch.arange(n, device=dev) % 7 == 0, -1.0,
                        torch.rand(n, generator=torch.Generator(device=dev).manual_seed(n),
                                   device=dev) * 60)
    occ = bvh.scene_any(cs, o, d, 1e-3, limit)
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == [b + 1 for b in before]
    care = limit > 0
    one_level = cs._replace(bvh=cs.bvh._replace(paged=None))
    for want, want_occ in ((plain.scene_hit_paged_plain(cs, o, d, 1e-3, 1e6),
                            plain.scene_hit_any_paged_plain(cs, o, d, 1e-3, limit)),
                           (bvh.scene_closest(one_level, o, d, 1e-3, 1e6),
                            bvh.scene_any(one_level, o, d, 1e-3, limit))):
        same = got.prim == want.prim
        assert float(same.float().mean()) >= 0.9999 and 0.2 < float(got.hit.float().mean()) < 1.0
        _assert_floats_close(got, want, same & got.hit, ("t", "normal", "u", "v"))
        assert float((occ == want_occ)[care].float().mean()) >= 0.9999
    assert bool(occ[~care].all()) and 0.05 < float(occ[care].float().mean()) < 0.95
    best, plo, phi = bvh_paged.paged_top_closest(cs, o, d, 1e-3, 1e6)
    entered = tbvh.page_root_mask(cs.bvh.paged, o, d, 1e-3, got.t)
    assert bool((entered & ~tbvh.pend_mask(plo, phi) == 0).all())
    assert bool((phi != 0).any())


@pytest.mark.cuda
def test_paged_path_tracer_launches_k6(paged_card):
    """A paged scene's path tracer takes the plain bounce, whose queries
    launch K6 (K5 stays idle)."""
    dev, cs = paged_card
    from path_tracing__ray_tracer_tpu_torch.models.path_tracer import bounce_fn

    o, d, thr, key, depth = _inputs(4096, 23, dev)
    before = (bounce_bvh.path_bounce_bvh.launches, bvh_paged.paged_top_closest.launches,
              bvh_paged.paged_top_any.launches)
    out = bounce_fn(cs, bounce_bvh.pack_bvh_tables(cs))(o, d, thr, key, depth, True)
    torch.cuda.synchronize()
    assert bounce_bvh.path_bounce_bvh.launches == before[0]
    assert (bvh_paged.paged_top_closest.launches, bvh_paged.paged_top_any.launches) == (
        before[1] + 1, before[2] + 1)
    want = bounce.path_bounce_plain(cs._replace(bvh=cs.bvh._replace(paged=None)), o, d, thr, key,
                                    depth, shadow_light=True)
    same = (out.hit == want.hit) & (out.prim == want.prim)
    assert float(same.float().mean()) >= 0.9999
    _assert_floats_close(out, want, same & out.hit & (out.killed == want.killed), FLOATS)


def _reported_deeper(cs, depth):
    """``cs`` with its whole tree and its pages reported ``depth`` levels
    deep: the page walks then take the deep class's stack, which holds any
    shallower tree too."""
    pg = cs.bvh.paged
    return cs._replace(bvh=cs.bvh._replace(depth4=depth, paged=pg._replace(page_depth=depth)))


@pytest.mark.cuda
@pytest.mark.parametrize("deep", [False, True])
@pytest.mark.parametrize("n", [131072, 4096 + 37])
def test_page_walks_match_plain(paged_card, n, deep):
    """The persistent K6c and K6d, and K4c and K4d over the whole tree,
    against their plain versions on the 36-page ``paged_card`` (pages past
    31: both pending words), with lanes that pend no page, lanes already
    found and bounds of +inf, in both depth classes (the deep one by
    reporting the trees 20 levels deep); each launch leaves the lane
    counter zero."""
    dev, cs = paged_card
    if deep:
        cs = _reported_deeper(cs, 20)
    for depth in (cs.bvh.depth4, cs.bvh.paged.page_depth):
        assert bvh.page_plan(depth) == (False, 32 if deep else 8, 0)
    o, d, _, _, _ = _inputs(n, n + 9, dev)
    lane = torch.arange(n, device=dev)
    bound, limit = _bounds(n, n + 9, dev)
    bound = torch.where(lane % 11 == 0, float("inf"), bound)
    limit = torch.where(lane % 11 == 0, float("inf"), limit)
    idle = lane % 5 == 0  # lanes that pend no page
    best, plo, phi = bvh_paged.paged_top_closest(cs, o, d, 1e-3, 1e6)
    top_found, alo, ahi = bvh_paged.paged_top_any(cs, o, d, 1e-3, limit)
    plo, phi, alo, ahi = (torch.where(idle, 0, w) for w in (plo, phi, alo, ahi))
    found = top_found | (lane % 3 == 0)  # lanes already found, some with pages pending
    zero = torch.zeros(n, device=dev)
    seed = plain.ClosestRecord(bound, torch.full((n,), -1, dtype=torch.int32, device=dev), zero,
                               zero, V3(zero, zero, zero))
    before = (bvh_paged.pages_closest.launches, bvh_paged.pages_any.launches)
    got = {"K6c": bvh_paged.pages_closest(cs, o, d, 1e-3, best, plo, phi),
           "K4c": bvh_paged.pages_closest(cs, o, d, 1e-3, seed)}
    occ = {"K6d": bvh_paged.pages_any(cs, o, d, 1e-3, limit, found, alo, ahi),
           "K4d": bvh_paged.pages_any(cs, o, d, 1e-3, limit, found)}
    torch.cuda.synchronize()
    assert (bvh_paged.pages_closest.launches, bvh_paged.pages_any.launches) == (
        before[0] + 2, before[1] + 2)
    assert not bvh.lane_counter(dev).any()
    want = {"K6c": bvh_paged.pages_closest_plain(cs, o, d, 1e-3, best, plo, phi),
            "K4c": bvh_paged.pages_closest_plain(cs, o, d, 1e-3, seed)}
    for k, rec in got.items():
        same = rec.prim == want[k].prim
        assert float(same.float().mean()) >= 0.9999, k
        assert bool((rec.prim >= 0).any()) and bool((rec.prim < 0).any()), k
        _assert_floats_close(rec, want[k], same & (rec.prim >= 0), ("t", "u", "v", "normal"))
    for x, y in ((got["K6c"].t, best.t), (got["K6c"].prim, best.prim)):
        assert torch.equal(x[idle], y[idle])  # no page pending: the record carried through
    assert bool((got["K6c"].prim != best.prim).any())
    care = limit > 0
    want_occ = {"K6d": bvh_paged.pages_any_plain(cs, o, d, 1e-3, limit, found, alo, ahi),
                "K4d": bvh_paged.pages_any_plain(cs, o, d, 1e-3, limit, found)}
    for k, x in occ.items():
        assert float((x == want_occ[k])[care].float().mean()) >= 0.9999, k
        assert bool(x[found].all()) and bool(x[care & ~found].any()), k


@pytest.fixture(scope="module")
def paged48_card(card):
    """The ``MeshSceneBuilder(2, 2)`` mesh cut into 48 pages (paging forced,
    as ``tests/test_torch_paged.py::test_pend_masks_cover_entered_pages``
    does): its top tree's leaves hold triangles, which config 6's, the 512K
    scene's and ``paged_card``'s do not."""
    dev = card[0]
    saved = tbvh.ONE_LEVEL_LIMIT, tbvh.PAGE_BUDGET_FLOATS
    tbvh.ONE_LEVEL_LIMIT, tbvh.PAGE_BUDGET_FLOATS = 2600, 450
    try:
        cs = pt.compile_scene(pt.MeshSceneBuilder(grid=2, subdivisions=2).build_scene(), device=dev)
    finally:
        tbvh.ONE_LEVEL_LIMIT, tbvh.PAGE_BUDGET_FLOATS = saved
    assert cs.bvh.paged.n_pages == 48 and bool((cs.bvh.paged.top_slot.view(-1, 13)[:, 9] >= 0).any())
    return dev, cs


def _box_rays(n, seed, dev):
    """Rays from [-14, 14]³ in uniform directions, and limits in [0, 40) with
    every 7th -1 and every 11th +inf."""
    g = np.random.default_rng(seed)
    ro = g.uniform(-14, 14, (n, 3)).astype(np.float32)
    rd = g.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    lane = np.arange(n)
    lim = np.where(lane % 11 == 0, np.inf, np.where(lane % 7 == 0, -1.0, g.uniform(0, 40, n)))
    o, d = (V3(*(torch.from_numpy(a[:, i].copy()).to(dev) for i in range(3))) for a in (ro, rd))
    return o, d, torch.from_numpy(lim.astype(np.float32)).to(dev)


def _top_walks(cs, o, d, limit):
    return (bvh_paged.paged_top_closest(cs, o, d, 1e-3, 1e6),
            bvh_paged.paged_top_any(cs, o, d, 1e-3, limit))


def _top_variant(monkeypatch, cs, dev, staged):
    """The top walks' plan on ``cs``, made to stage the top tables (the
    card's shared memory) or read them from device memory (a limit that
    holds only the primitive records): the wrappers' ``smem_limit`` replaced
    and their plans forgotten."""
    limit = bvh.smem_limit(dev)
    if not staged:
        limit = 4 * bounce.rec_layout((cs.n_planes, cs.n_spheres, cs.n_quads, 0)).size
    monkeypatch.setattr(bvh_paged, "smem_limit", lambda dev: limit)
    monkeypatch.setattr(bvh_paged, "_TOP_PLANS", {})
    return bvh_paged.top_walk_plan(cs, limit)


@pytest.mark.cuda
@pytest.mark.parametrize("deep", [False, True])
@pytest.mark.parametrize("n,staged", [(131072 + 5, True), (131072 + 5, False), (4096 + 37, True),
                                      (4096 + 37, False), (2 * 131072 + 5, True)])
def test_top_walks_match_plain(paged48_card, monkeypatch, n, staged, deep):
    """The persistent K6a and K6b against their plain versions on the 48-page
    mesh: K6a's winner on >= 99.99% of lanes (top-leaf triangles among them),
    its floats within tolerance, its pending words covering every page
    entered at the final ``t``; K6b's verdict on every ray that needs an
    answer at >= 99.99%, lanes with limit <= 0 found with no page pending.
    Staged or read from device memory, in the shallow class or the deep one
    (the top tree reported 20 levels deep), each bit for bit the other
    variant; 262,149 lanes outrun the staged variant's resident blocks, so
    its warps take later batches from the lane counter; the counter is left
    zero."""
    dev, cs = paged48_card
    if deep:
        cs = cs._replace(bvh=cs.bvh._replace(paged=cs.bvh.paged._replace(top_depth=20)))
    plan = _top_variant(monkeypatch, cs, dev, staged)
    assert (plan.stage, plan.depth_class) == (staged, 32 if deep else 8)
    if n > 2 * 131072:  # the resident blocks do not span the lanes
        lib = bvh_paged.build().lib
        for who, occupancy in (("paged_top_closest", lib.ptrt_paged_top_closest_occupancy),
                               ("paged_top_any", lib.ptrt_paged_top_any_occupancy)):
            assert bvh.WALK_THREADS * bvh.launch_grid(who, occupancy, plan, n, dev) < n, who
    o, d, limit = _box_rays(n, n + 15, dev)
    before = (bvh_paged.paged_top_closest.launches, bvh_paged.paged_top_any.launches)
    (best, plo, phi), (found, alo, ahi) = got = _top_walks(cs, o, d, limit)
    torch.cuda.synchronize()
    assert (bvh_paged.paged_top_closest.launches, bvh_paged.paged_top_any.launches) == (
        before[0] + 1, before[1] + 1)
    assert not bvh.lane_counter(dev).any()
    monkeypatch.undo()
    _top_variant(monkeypatch, cs, dev, not staged)
    _assert_same_bits(got, _top_walks(cs, o, d, limit))  # the other variant
    torch.cuda.synchronize()
    assert not bvh.lane_counter(dev).any()
    want, _, _ = bvh_paged.paged_top_closest_plain(cs, o, d, 1e-3, 1e6)
    same = best.prim == want.prim
    assert float(same.float().mean()) >= 0.9999
    assert bool((best.prim >= cs.n_planes + cs.n_spheres + cs.n_quads).any())  # top leaves win
    _assert_floats_close(best, want, same & (best.prim >= 0), ("t", "u", "v", "normal"))
    final = bvh_paged.pages_closest(cs, o, d, 1e-3, best, plo, phi)
    entered = tbvh.page_root_mask(cs.bvh.paged, o, d, 1e-3, final.t)
    assert bool((entered & ~tbvh.pend_mask(plo, phi) == 0).all()) and bool((phi != 0).any())
    care = limit > 0
    want_found, _, _ = bvh_paged.paged_top_any_plain(cs, o, d, 1e-3, limit)
    assert float((found == want_found)[care].float().mean()) >= 0.9999
    assert bool(found[~care].all()) and not bool((alo[~care] | ahi[~care]).any())
    assert bool(found[care].any()) and not bool(found[care].all())


@pytest.mark.cuda
def test_top_walks_launch_nothing_on_no_lanes(paged48_card):
    dev, cs = paged48_card
    o, d, limit = _box_rays(0, 3, dev)
    before = (bvh_paged.paged_top_closest.launches, bvh_paged.paged_top_any.launches)
    (best, plo, phi), (found, alo, ahi) = _top_walks(cs, o, d, limit)
    torch.cuda.synchronize()
    assert best.t.shape == plo.shape == found.shape == ahi.shape == (0,)
    assert (bvh_paged.paged_top_closest.launches, bvh_paged.paged_top_any.launches) == before


@pytest.mark.cuda
def test_persistent_walks_share_the_lane_counter(card, mesh_card, paged_card, paged48_card):
    """K4a, K4b, K6a-d, K5, K11, the ordered BVH2 closest and occlusion walks,
    the skip-link closest and occlusion walks, K10a-d, K1, K2, K3a and K3b
    queued on one stream with no sync between them answer bit for bit as each does
    alone after a sync, which leaves the stream's lane counter zero: each
    launch starts from lane 0."""
    dev, mcs, tables = mesh_card
    ccs, blobs = card[1], card[2]
    pcs, tcs = paged_card[1], paged48_card[1]
    o, d, thr, key, depth, limit = _persistent_inputs(131072, dev)
    co, cd, cthr, ckey, cdepth = _inputs(131072, 11, dev)
    wo, wd, _, _, _, wlimit = _persistent_inputs(2 * 131072 + 5, dev)  # K3 past its blocks
    best, plo, phi = bvh_paged.paged_top_closest(pcs, o, d, 1e-3, 1e6)
    found, alo, ahi = bvh_paged.paged_top_any(pcs, o, d, 1e-3, limit)
    roots, en = _rooted_pass(mcs, o, d)
    none = torch.full_like(roots, -1)
    calls = (lambda: bvh.scene_closest(mcs, o, d, 1e-3, 1e6),
             lambda: bvh.scene_any(mcs, o, d, 1e-3, limit),
             lambda: bvh_paged.paged_top_closest(pcs, o, d, 1e-3, 1e6),
             lambda: bvh_paged.paged_top_any(tcs, o, d, 1e-3, limit),
             lambda: bvh_paged.pages_closest(pcs, o, d, 1e-3, best, plo, phi),
             lambda: bvh_paged.pages_any(pcs, o, d, 1e-3, limit, found, alo, ahi),
             lambda: bounce_bvh.path_bounce_bvh(mcs, tables, o, d, thr, key, depth),
             lambda: bvh.closest_rooted(mcs, o, d, 1e-3, roots, en, limit.abs(), none),
             lambda: bvh2.closest_ordered(mcs, o, d, 1e-3, limit.abs()),
             lambda: bvh2.any_ordered(mcs, o, d, 1e-3, limit),
             lambda: bvh2.closest_skiplink(mcs, o, d, 1e-3, limit.abs()),
             lambda: bvh2.any_skiplink(mcs, o, d, 1e-3, limit),
             lambda: bvh_leafmat.scene_closest(mcs, o, d, 1e-3, 1e30),
             lambda: bvh_leafmat.tri_closest(mcs, o, d, 1e-3, _seed(limit.abs())),
             lambda: bvh_leafmat.scene_any(mcs, o, d, 1e-3, limit),
             lambda: bvh_leafmat.tri_any(mcs, o, d, 1e-3, limit, found),
             lambda: bounce.path_bounce(ccs, *blobs, co, cd, cthr, ckey, cdepth),
             lambda: whitted.whitted_bounce(ccs, *blobs, co, cd, whitted.TEXTURE),
             lambda: intersect.closest_hit(ccs, blobs[0], wo, wd, 1e-3, 1e30),
             lambda: intersect.any_hit(ccs, blobs[0], wo, wd, 1e-3, wlimit))
    queued = [call() for call in calls]
    torch.cuda.synchronize()
    assert not bvh.lane_counter(dev).any()
    for call, got in zip(calls, queued):
        alone = call()
        torch.cuda.synchronize()
        assert not bvh.lane_counter(dev).any()
        _assert_same_bits(got, alone)


def _seed(bound):
    """A carried closest record: ``bound`` and no winner, every third lane
    carrying a winner (prim 7) with its attributes."""
    n, dev = bound.shape[0], bound.device
    lane = torch.arange(n, device=dev)
    carry = lane % 3 == 0
    prim = torch.where(carry, 7, -1).to(torch.int32)
    u = torch.where(carry, 0.25, 0.0)
    return plain.ClosestRecord(bound.contiguous(), prim, u, 1.0 - u - 0.5,
                               V3(torch.where(carry, 1.0, 0.0), torch.zeros_like(u), u))


def _bounds(n, seed, dev):
    """A per-ray bound in [0, 60) and the same with every 7th lane at −1."""
    bound = torch.rand(n, generator=torch.Generator(device=dev).manual_seed(seed), device=dev) * 60
    return bound, torch.where(torch.arange(n, device=dev) % 7 == 0, -1.0, bound)


@pytest.mark.cuda
@pytest.mark.parametrize("ordered", [False, True])
@pytest.mark.parametrize("n", [131072, 4096 + 37])
def test_bvh2_walks_match_plain(mesh_card, n, ordered):
    """K4e, closest (scalar and per-ray bound) and occlusion, against the
    plain skip-link walks: misses equal on every lane, the winner on
    ≥ 99.99% and ``t`` within 1e-4 where the winners agree; occlusion equal
    on every lane whose answer is needed (the others report occluded)."""
    dev, cs, _ = mesh_card
    o, d, _, _, _ = _inputs(n, n + 7, dev)
    closest = bvh2.closest_ordered if ordered else bvh2.closest_skiplink
    occluded = bvh2.any_ordered if ordered else bvh2.any_skiplink
    bound, limit = _bounds(n, n, dev)
    before = (closest.launches, occluded.launches)
    got = [closest(cs, o, d, 1e-3, b) for b in (1e6, bound)]
    occ = occluded(cs, o, d, 1e-3, limit)
    torch.cuda.synchronize()
    assert (closest.launches, occluded.launches) == (before[0] + 2, before[1] + 1)
    assert not bvh.lane_counter(dev).any()
    for (t, tri), b in zip(got, (1e6, bound)):
        want_t, want_tri = tbvh.traverse_closest(cs.bvh, cs.triangles, o, d, 1e-3, b)
        assert torch.equal(tri < 0, want_tri < 0) and 0.02 < float((tri >= 0).float().mean()) < 1
        same = tri == want_tri
        assert float(same.float().mean()) >= 0.9999
        torch.testing.assert_close(t[same], want_t[same], rtol=TOL, atol=TOL)
    care = limit > 0
    want_occ = tbvh.traverse_any(cs.bvh, cs.triangles, o, d, 1e-3, limit)
    assert torch.equal(occ[care], want_occ[care]) and bool(occ[~care].all())
    assert 0.05 < float(occ[care].float().mean()) < 0.95


@pytest.mark.cuda
@pytest.mark.parametrize("ordered", [False, True])
def test_bvh2_walks_match_plain_on_a_190_deep_chain(ordered):
    """K4e on a BVH2 190 levels deep, the most the ordered walk's stack
    takes (``tests/torch_chain.py``: its rays along +x fill the stack),
    against the plain walks: misses equal on every lane, the winner on
    ≥ 99.99% and ``t`` within 1e-4 where the winners agree; occlusion equal
    on every lane."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from torch_chain import chain_rays, chain_scene

    dev = torch.device("cuda")
    cs = chain_scene(bvh.STACK_CAP - 2, dev)
    assert cs.bvh.depth2 == bvh.STACK_CAP - 2 and bvh.tri_route(cs) == "ordered"
    assert bvh2.ordered_plan(cs).depth_class == bvh.STACK_CAP  # the largest class
    n = 4096 + 37
    o, d = (_v3_on(a, dev) for a in chain_rays(cs.bvh.depth2, n, 31))
    closest = bvh2.closest_ordered if ordered else bvh2.closest_skiplink
    occluded = bvh2.any_ordered if ordered else bvh2.any_skiplink
    want_t, want_tri = tbvh.traverse_closest(cs.bvh, cs.triangles, o, d, 1e-3, 1e6)
    u = torch.rand(n, generator=torch.Generator(device=dev).manual_seed(32), device=dev)
    bound = want_t * (0.5 + u)  # about half of the hits lie beyond it
    before = (closest.launches, occluded.launches)
    for b in (1e6, bound):
        t, tri = closest(cs, o, d, 1e-3, b)
        wt, wi = tbvh.traverse_closest(cs.bvh, cs.triangles, o, d, 1e-3, b)
        same = tri == wi
        assert torch.equal(tri < 0, wi < 0) and float(same.float().mean()) >= 0.9999
        torch.testing.assert_close(t[same], wt[same], rtol=TOL, atol=TOL)
    assert bool((want_tri[: n // 3] == cs.bvh.depth2 - 1).all())  # the deep stack's rays
    occ = occluded(cs, o, d, 1e-3, bound)
    torch.cuda.synchronize()
    assert (closest.launches, occluded.launches) == (before[0] + 2, before[1] + 1)
    assert not bvh.lane_counter(dev).any()
    assert torch.equal(occ, tbvh.traverse_any(cs.bvh, cs.triangles, o, d, 1e-3, bound))
    assert 0.2 < float(occ.float().mean()) < 0.8


def _v3_on(a, dev):
    return V3(*(torch.from_numpy(a[:, i].copy()).to(dev) for i in range(3)))


@pytest.mark.cuda
def test_multipass_matches_plain(mesh_card):
    """K11: each pass against its plain version (``ops/bvh.rooted``), and the
    whole multipass walk (three launches) against the single-pass K4c."""
    dev, cs, _ = mesh_card
    n = 131072
    o, d, _, _, _ = _inputs(n, 29, dev)
    bound = torch.full((n,), 1e6, device=dev)
    roots, en = _rooted_pass(cs, o, d)
    none = torch.full((n,), -1, dtype=torch.int32, device=dev)
    before = bvh.closest_rooted.launches
    got = bvh.closest_rooted(cs, o, d, 1e-3, roots, en, bound, none)
    want = tbvh.rooted(cs.bvh, cs.triangles, o, d, 1e-3, roots, en, bound, none)
    assert bool(en.any()) and bool((got[1] >= 0).any())
    for gt, gi, wt, wi in ((*got, *want),):
        same = gi == wi
        assert torch.equal(gi < 0, wi < 0) and float(same.float().mean()) >= 0.9999
        torch.testing.assert_close(gt[same], wt[same], rtol=TOL, atol=TOL)
    assert torch.equal(got[0][~en], bound[~en]) and bool((got[1][~en] == -1).all())
    t, tri = bvh.multipass_closest(cs, o, d, 1e-3, bound)
    torch.cuda.synchronize()
    assert bvh.closest_rooted.launches == before + 4
    zero = torch.zeros_like(bound)
    one = bvh_paged.pages_closest(cs, o, d, 1e-3, plain.ClosestRecord(
        bound, none, zero, zero, V3(zero, zero, zero)))
    off = cs.n_planes + cs.n_spheres + cs.n_quads
    same = torch.where(tri >= 0, tri + off, -1) == one.prim
    assert float(same.float().mean()) >= 0.9999 and 0.02 < float((tri >= 0).float().mean()) < 1
    torch.testing.assert_close(t[same], one.t[same], rtol=TOL, atol=TOL)


def _rooted_pass(cs, o, d):
    """The multipass walk's first pass ``(roots, en)``: the depth-2 subtree
    each ray enters first."""
    table, valid = tbvh.subtree_nodes(cs.bvh.nodes4)
    s1, _ = tbvh.subtree_keys2(cs.bvh.nodes4, o, d)
    en = valid[s1.clamp(0, 15).long()] & (s1 < 16)
    return torch.where(en, table[s1.clamp(0, 15).long()], 0).to(torch.int32), en


@pytest.mark.cuda
@pytest.mark.parametrize("n", [131072 + 5, 4096 + 37])
def test_persistent_split_walks_match_plain(mesh_card, n):
    """The persistent K11 (one pass, three lanes in four idle) and ordered
    BVH2 closest walk (scalar and per-ray bound) against their plain
    versions at a lane count that is no multiple of 32: misses equal on
    every lane, the winner on ≥ 99.99% and ``t`` within 1e-4 where the
    winners agree, K11's idle lanes carried through bit for bit; each in
    its deep class too (the trees reported deeper), bit-equal to its
    shallow class; the lane counter left zero."""
    dev, cs, _ = mesh_card
    deep = cs._replace(bvh=cs.bvh._replace(depth4=20, depth2=100))
    assert (bvh.rooted_plan(cs).depth_class, bvh2.ordered_plan(cs).depth_class) == (8, 32)
    assert (bvh.rooted_plan(deep).depth_class, bvh2.ordered_plan(deep).depth_class) == (32, 192)
    o, d, _, _, _ = _inputs(n, n + 13, dev)
    bound, _ = _bounds(n, n + 13, dev)
    roots, en = _rooted_pass(cs, o, d)
    en = en & (torch.arange(n, device=dev) % 4 == 0)
    best_i = torch.where(torch.arange(n, device=dev) % 3 == 0, 7, -1).to(torch.int32)

    def check(got, want):
        (t, tri), (wt, wi) = got, want
        same = tri == wi
        assert torch.equal(tri < 0, wi < 0) and float(same.float().mean()) >= 0.9999
        torch.testing.assert_close(t[same], wt[same], rtol=TOL, atol=TOL)

    before = (bvh.closest_rooted.launches, bvh2.closest_ordered.launches)
    rooted = [bvh.closest_rooted(c, o, d, 1e-3, roots, en, bound, best_i) for c in (cs, deep)]
    ordered = [[bvh2.closest_ordered(c, o, d, 1e-3, b) for b in (1e6, bound)] for c in (cs, deep)]
    torch.cuda.synchronize()
    assert (bvh.closest_rooted.launches, bvh2.closest_ordered.launches) == (
        before[0] + 2, before[1] + 4)
    assert not bvh.lane_counter(dev).any()
    _assert_same_bits(rooted[0], rooted[1])
    _assert_same_bits(ordered[0], ordered[1])
    check(rooted[0], tbvh.rooted(cs.bvh, cs.triangles, o, d, 1e-3, roots, en, bound, best_i))
    assert bool(en.any()) and bool((~en).any())
    assert torch.equal(rooted[0][0][~en], bound[~en])
    assert torch.equal(rooted[0][1][~en], best_i[~en])
    for got, b in zip(ordered[0], (1e6, bound)):
        check(got, tbvh.traverse_closest(cs.bvh, cs.triangles, o, d, 1e-3, b))
        assert 0.02 < float((got[1] >= 0).float().mean()) < 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [131072 + 5, 4096 + 37])
def test_persistent_ordered_occlusion_matches_plain(mesh_card, n):
    """The persistent ordered occlusion walk (K4e) against the plain
    skip-link walk on every ray that needs an answer (the others report
    occluded), in both stack classes (the tree reported 100 deep), the two
    bit-equal; then on the 190-deep chain in its class and in the shallow
    one, where each lane's stack overflows and it finishes by the skip-link
    walk; the lane counter left zero."""
    dev, cs, _ = mesh_card
    deep = cs._replace(bvh=cs.bvh._replace(depth2=100))
    assert (bvh2.ordered_plan(cs).depth_class, bvh2.ordered_plan(deep).depth_class) == (32, 192)
    o, d, _, _, _ = _inputs(n, n + 17, dev)
    _, limit = _bounds(n, n + 17, dev)
    before = bvh2.any_ordered.launches
    got = [bvh2.any_ordered(c, o, d, 1e-3, limit) for c in (cs, deep)]
    torch.cuda.synchronize()
    assert bvh2.any_ordered.launches == before + 2 and not bvh.lane_counter(dev).any()
    assert torch.equal(got[0], got[1])
    care = limit > 0
    want = tbvh.traverse_any(cs.bvh, cs.triangles, o, d, 1e-3, limit)
    assert torch.equal(got[0][care], want[care]) and bool(got[0][~care].all())
    assert 0.05 < float(got[0][care].float().mean()) < 0.95
    from torch_chain import chain_rays, chain_scene

    chain = chain_scene(bvh.STACK_CAP - 2, dev)
    # reported 13 deep: the shallow class, whose stack the chain overflows
    shallow = SimpleNamespace(**{**vars(chain), "bvh": chain.bvh._replace(depth2=13)})
    assert (bvh2.ordered_plan(chain).depth_class, bvh2.ordered_plan(shallow).depth_class) == (
        192, 32)
    co, cd = (_v3_on(a, dev) for a in chain_rays(chain.bvh.depth2, n, 33))
    ct, _ = tbvh.traverse_closest(chain.bvh, chain.triangles, co, cd, 1e-3, 1e6)
    u = torch.rand(n, generator=torch.Generator(device=dev).manual_seed(34), device=dev)
    bound = (ct * (0.5 + u)).contiguous()
    want = tbvh.traverse_any(chain.bvh, chain.triangles, co, cd, 1e-3, bound)
    for c in (chain, shallow):
        assert torch.equal(bvh2.any_ordered(c, co, cd, 1e-3, bound), want)
    assert 0.2 < float(want.float().mean()) < 0.8
    torch.cuda.synchronize()
    assert not bvh.lane_counter(dev).any()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [131072, 131072 + 5, 2 * 131072 + 5])
def test_persistent_skiplink_occlusion_matches_plain(mesh_card, n):
    """The persistent skip-link occlusion walk (K4e) against the plain
    skip-link walk on every ray that needs an answer (the others report
    occluded), on config 5 with finite, ``+inf`` and ≤ 0 limits, then on the
    190-deep chain; at 262,149 lanes past the resident blocks' lanes, which
    warps take from the lane counter; the counter left zero."""
    dev, cs, _ = mesh_card
    o, d, _, _, _ = _inputs(n, n + 19, dev)
    _, limit = _bounds(n, n + 19, dev)
    limit = torch.where(torch.arange(n, device=dev) % 11 == 0, float("inf"), limit).contiguous()
    before = bvh2.any_skiplink.launches
    occ = bvh2.any_skiplink(cs, o, d, 1e-3, limit)
    torch.cuda.synchronize()
    assert bvh2.any_skiplink.launches == before + 1 and not bvh.lane_counter(dev).any()
    care = limit > 0
    want = tbvh.traverse_any(cs.bvh, cs.triangles, o, d, 1e-3, limit)
    assert torch.equal(occ[care], want[care]) and bool(occ[~care].all())
    assert 0.05 < float(occ[care].float().mean()) < 0.95
    from torch_chain import chain_rays, chain_scene

    chain = chain_scene(bvh.STACK_CAP - 2, dev)
    co, cd = (_v3_on(a, dev) for a in chain_rays(chain.bvh.depth2, n, 35))
    ct, _ = tbvh.traverse_closest(chain.bvh, chain.triangles, co, cd, 1e-3, 1e6)
    u = torch.rand(n, generator=torch.Generator(device=dev).manual_seed(36), device=dev)
    bound = (ct * (0.5 + u)).contiguous()
    got = bvh2.any_skiplink(chain, co, cd, 1e-3, bound)
    torch.cuda.synchronize()
    want = tbvh.traverse_any(chain.bvh, chain.triangles, co, cd, 1e-3, bound)
    assert torch.equal(got, want) and 0.2 < float(want.float().mean()) < 0.8
    assert not bvh.lane_counter(dev).any()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [131072 + 5, 4096 + 37])
def test_persistent_tri_closest_matches_plain(mesh_card, n):
    """The persistent K10c against its plain version (``pages_closest_plain``
    with the leaf table): the winner on ≥ 99.99% of lanes, misses equal on
    every lane, t, u, v and the normal within tolerance where the winners
    agree, the carried record passed through where nothing nearer is hit;
    in both depth classes (the tree reported 20 deep), bit-equal; three
    launches queued back to back bit-equal to the first, and the lane
    counter zero after them."""
    dev, cs, _ = mesh_card
    deep = cs._replace(bvh=cs.bvh._replace(depth4=20))
    assert (bvh_leafmat.tri_plan(cs).depth_class,
            bvh_leafmat.tri_plan(deep).depth_class) == (8, 32)
    o, d, _, _, _ = _inputs(n, n + 19, dev)
    bound, _ = _bounds(n, n + 19, dev)
    seed = _seed(bound)
    before = bvh_leafmat.tri_closest.launches
    got = [bvh_leafmat.tri_closest(c, o, d, 1e-3, seed) for c in (cs, deep, cs, cs)]
    torch.cuda.synchronize()
    assert bvh_leafmat.tri_closest.launches == before + 4 and not bvh.lane_counter(dev).any()
    for other in got[1:]:
        _assert_same_bits(got[0], other)
    want = bvh_paged.pages_closest_plain(cs, o, d, 1e-3, seed, mxu=True)
    rec = got[0]
    same = rec.prim == want.prim
    assert torch.equal(rec.prim < 0, want.prim < 0) and float(same.float().mean()) >= 0.9999
    off = cs.n_planes + cs.n_spheres + cs.n_quads
    walked = rec.t != seed.t  # a triangle nearer than the carried record
    tri = same & (rec.prim >= off) & walked
    assert bool(tri.any())
    _assert_floats_close(rec, want, tri, ("t", "normal", "u", "v"))
    assert bool((~walked).any()) and torch.equal(rec.prim[~walked], seed.prim[~walked])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [131072 + 5, 4096 + 37])
def test_persistent_leafmat_occlusion_matches_plain(mesh_card, n):
    """The persistent K10b and K10d against their plain versions (the walks
    with the leaf table): K10b on every ray that needs an answer (the others
    reported occluded), K10d on every lane, found lanes carried; limits
    finite, infinite (a tenth of the lanes) and non-positive (a seventh); in
    both depth classes (the tree reported 20 deep), bit-equal; each call one
    launch, three queued back to back bit-equal to the first, and the lane
    counter zero after them."""
    dev, cs, _ = mesh_card
    deep = cs._replace(bvh=cs.bvh._replace(depth4=20))
    assert (bvh_leafmat.scene_any_plan(cs).depth_class, bvh_leafmat.tri_plan(cs).depth_class,
            bvh_leafmat.scene_any_plan(deep).depth_class,
            bvh_leafmat.tri_plan(deep).depth_class) == (8, 8, 32, 32)
    assert bvh_leafmat.scene_any_plan(cs).smem_bytes == 4 * cs.bvh.ps_blob.numel()
    o, d, _, _, _ = _inputs(n, n + 23, dev)
    _, limit = _bounds(n, n + 23, dev)
    lane = torch.arange(n, device=dev)
    limit = torch.where(lane % 10 == 3, float("inf"), limit).contiguous()
    found = lane % 5 == 0
    unfound = torch.zeros_like(found)
    before = (bvh_leafmat.scene_any.launches, bvh_leafmat.tri_any.launches)
    occ = [bvh_leafmat.scene_any(c, o, d, 1e-3, limit) for c in (cs, deep, cs, cs)]
    tri = [bvh_leafmat.tri_any(c, o, d, 1e-3, limit, f)
           for c, f in ((cs, found), (deep, found), (cs, found), (cs, found), (cs, unfound),
                        (deep, unfound))]
    torch.cuda.synchronize()
    assert (bvh_leafmat.scene_any.launches, bvh_leafmat.tri_any.launches) == (
        before[0] + 4, before[1] + 6)
    assert not bvh.lane_counter(dev).any()
    for other in occ[1:]:
        assert torch.equal(occ[0], other)
    for other in tri[1:4]:
        assert torch.equal(tri[0], other)
    assert torch.equal(tri[4], tri[5])
    care = limit > 0
    want = plain.scene_hit_any_bvh_plain(cs, o, d, 1e-3, limit, mxu=True)
    assert torch.equal(occ[0][care], want[care]) and bool(occ[0][~care].all())
    inf = limit == float("inf")
    assert 0.05 < float(occ[0][care].float().mean()) < 0.95 and bool(occ[0][inf].any())
    for f, got in ((found, tri[0]), (unfound, tri[4])):
        assert torch.equal(got, bvh_paged.pages_any_plain(cs, o, d, 1e-3, limit, f, mxu=True))
    assert bool(tri[0][found].all()) and not bool(tri[4][~care].any())
    assert bool(tri[4][inf].any()) and not bool(tri[4][inf].all())


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["ordered", "skiplink", "multipass", "deep"])
def test_split_route_path_tracer_launches(mesh_card, monkeypatch, route):
    """The path tracer on a forced split route, or on a BVH4 deeper than the
    walks' stack (routed to K4e, rendered without a raise), takes the plain
    bounce, whose queries launch the route's kernels; K5 stays idle."""
    flags = {"ordered": dict(BVH_QUAD=False), "skiplink": dict(BVH_QUAD=False, BVH_ORDERED=False),
             "multipass": dict(BVH_ATTRS=False, BVH_MULTIPASS=True, _MP_MIN_DEPTH4=1),
             "deep": {}}[route]
    for k, v in flags.items():
        monkeypatch.setattr(bvh, k, v)
    if route == "deep":
        to_device = tbvh.to_device
        monkeypatch.setattr(tbvh, "to_device", lambda *a, **k: to_device(*a, **k)._replace(
            depth4=bvh.MAX_DEPTH4 + 1))
    kernels = {"ordered": (bvh2.closest_ordered, bvh2.any_ordered),
               "skiplink": (bvh2.closest_skiplink, bvh2.any_skiplink),
               "multipass": (bvh.closest_rooted, bvh_paged.pages_any),
               "deep": (bvh2.closest_ordered, bvh2.any_ordered)}[route]
    b = pt.MeshSceneBuilder(grid=2, subdivisions=1)
    r = pt.RendererFactory.create("cuda_path_raytracer", seed=1, shadow_tmax="light")
    scene = b.build_scene()
    assert bvh.tri_route(r.compiled(scene)) == ("ordered" if route == "deep" else route)
    before = [k.launches for k in kernels] + [bounce_bvh.path_bounce_bvh.launches]
    sums = r.render_sums(scene, b.create_camera(1.0),
                         pt.RenderSettings(width=64, height=64, samples_per_pixel=4, max_depth=4))
    after = [k.launches for k in kernels] + [bounce_bvh.path_bounce_bvh.launches]
    assert after[0] > before[0] and after[1] > before[1] and after[2] == before[2]
    assert sums.shape == (64 * 64, 3) and np.isfinite(sums).all() and (sums >= 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [131072, 4096 + 37, 2 * 131072 + 5])
def test_leafmat_walks_match_plain(mesh_card, n):
    """K10a-d against their plain versions (the walks of ``ops/bvh.py`` with
    the leaf table): K10a and K10c's records, K10b and K10d's verdicts on
    every ray that needs an answer (K10b reports the others occluded); K10a
    also with t_max 1e30 and +inf, each bound's record bit-equal with the
    tree reported 20 deep (stack class 32); the lane counter left zero."""
    dev, cs, _ = mesh_card
    deep = cs._replace(bvh=cs.bvh._replace(depth4=20))
    assert (bvh_leafmat.scene_any_plan(cs).depth_class,
            bvh_leafmat.scene_any_plan(deep).depth_class) == (8, 32)
    assert cs.bvh.leaf_mat is not None
    o, d, _, _, _ = _inputs(n, n + 5, dev)
    g = torch.Generator(device=dev).manual_seed(n + 5)
    limit = torch.where(torch.arange(n, device=dev) % 7 == 0, -1.0,
                        torch.rand(n, generator=g, device=dev) * 60)
    zero = torch.zeros(n, device=dev)
    seed = plain.ClosestRecord(torch.rand(n, generator=g, device=dev) * 60,
                               torch.full((n,), -1, dtype=torch.int32, device=dev), zero, zero,
                               V3(zero, zero, zero))
    found = torch.arange(n, device=dev) % 5 == 0
    wrappers = (bvh_leafmat.scene_closest, bvh_leafmat.scene_any, bvh_leafmat.tri_closest,
                bvh_leafmat.tri_any)
    before = [w.launches for w in wrappers]
    got_a = bvh_leafmat.scene_closest(cs, o, d, 1e-3, 1e6)
    occ_b = bvh_leafmat.scene_any(cs, o, d, 1e-3, limit)
    got_c = bvh_leafmat.tri_closest(cs, o, d, 1e-3, seed)
    occ_d = bvh_leafmat.tri_any(cs, o, d, 1e-3, limit, found)
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] == [b + 1 for b in before]
    for got, want in ((got_a, plain.scene_hit_bvh_plain(cs, o, d, 1e-3, 1e6, mxu=True)),
                      (got_c, bvh_paged.pages_closest_plain(cs, o, d, 1e-3, seed, mxu=True))):
        same = got.prim == want.prim
        assert float(same.float().mean()) >= 0.9999 and bool((got.prim >= 0).any())
        _assert_floats_close(got, want, same & (got.prim >= 0), ("t", "normal", "u", "v"))
    care = limit > 0
    want_b = plain.scene_hit_any_bvh_plain(cs, o, d, 1e-3, limit, mxu=True)
    assert torch.equal(occ_b[care], want_b[care]) and bool(occ_b[~care].all())
    assert 0.05 < float(occ_b[care].float().mean()) < 0.95
    want_d = bvh_paged.pages_any_plain(cs, o, d, 1e-3, limit, found, mxu=True)
    assert torch.equal(occ_d, want_d) and bool(occ_d[found].all())
    for t_max in (1e30, float("inf")):
        got = bvh_leafmat.scene_closest(cs, o, d, 1e-3, t_max)
        want = plain.scene_hit_bvh_plain(cs, o, d, 1e-3, t_max, mxu=True)
        same = got.prim == want.prim
        assert float(same.float().mean()) >= 0.9999 and bool(got.hit.any())
        _assert_floats_close(got, want, same & got.hit, ("t", "normal", "u", "v"))
    for t_max in (1e6, 1e30, float("inf")):
        _assert_same_bits(bvh_leafmat.scene_closest(deep, o, d, 1e-3, t_max),
                          bvh_leafmat.scene_closest(cs, o, d, 1e-3, t_max))
    torch.cuda.synchronize()
    assert not bvh.lane_counter(dev).any()


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fused", "quad"])
def test_mxu_route_path_tracer_launches(mesh_card, monkeypatch, route):
    """The path tracer with ``BVH_MXU_LEAF``: K5 with K10b answering its
    shadow rays (``fused``), or the plain bounce with K10c and K10d
    (``quad``); the K4 walks they replace stay idle."""
    monkeypatch.setattr(bvh, "BVH_MXU_LEAF", True)
    if route == "quad":
        monkeypatch.setattr(bvh, "BVH_ATTRS", False)
    kernels, idle = {
        "fused": ((bounce_bvh.path_bounce_bvh, bvh_leafmat.scene_any), (bvh.scene_any,)),
        "quad": ((bvh_leafmat.tri_closest, bvh_leafmat.tri_any),
                 (bvh_paged.pages_closest, bvh_paged.pages_any, bounce_bvh.path_bounce_bvh)),
    }[route]
    b = pt.MeshSceneBuilder(grid=2, subdivisions=1)
    r = pt.RendererFactory.create("cuda_path_raytracer", seed=1, shadow_tmax="light")
    scene = b.build_scene()
    assert bvh.tri_route(r.compiled(scene)) == route and bvh.mxu_leaf_ok(r.compiled(scene))
    before = [k.launches for k in kernels + idle]
    sums = r.render_sums(scene, b.create_camera(1.0),
                         pt.RenderSettings(width=64, height=64, samples_per_pixel=4, max_depth=4))
    after = [k.launches for k in kernels + idle]
    assert all(a > b for a, b in zip(after[:2], before[:2])) and after[2:] == before[2:]
    assert sums.shape == (64 * 64, 3) and np.isfinite(sums).all() and (sums >= 0).all()


def _leaves(out):
    for x in out:
        yield from (_leaves(x) if isinstance(x, tuple) else (x,))


def _step_args(cs, blobs, dev, n, steps):
    """``path_step``'s arguments on ``n`` lanes about the middle of a
    512x256 frame (past its 131,072 pixels the lanes' items clamp to the
    last pixel), 2 samples, after ``steps`` plain fused steps (the pipe
    mode's own start)."""
    cam12 = pt.pack_camera(pt.CustomSceneBuilder().create_camera(2.0), dev)
    st, tables, scal, lane = experimental.pipe_start(
        cs, blobs, cam12, max(0, (512 * 256 - n) // 2), 3, 0, n_pix=n, width=512, height=256,
        n_samples=2, max_depth=8, jitter="independent")
    for _ in range(steps):
        out = step.path_step_plain(cs, st, tables, cam12, scal, lane[0],
                                   experimental.step_texel(cs, st, lane[0]), *lane[1:])
        lane = (out[0],) + out[3:11]
    return (cs, st, tables, cam12, scal, lane[0], experimental.step_texel(cs, st, lane[0]),
            *lane[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 6])  # fresh camera rays; retired, finishing and live lanes
@pytest.mark.parametrize("n", [131072 + 5, 4096 + 37])
def test_step_kernel_matches_plain(card, n, steps):
    """The persistent K7 on ``n`` lanes after ``steps`` plain fused steps
    against its plain version: integer and 0/1 outputs on every lane, the
    floats within tolerance (the next record's geometry on its hit lanes);
    the stream's lane counter left zero; K7 and K1 queued back to back on
    one stream answer bit for bit as each does alone."""
    dev, cs, blobs = card
    args = _step_args(cs, blobs, dev, n, steps)
    st, lane = args[1], args[5:]
    before = step.path_step.launches
    alone = step.path_step(*args)
    torch.cuda.synchronize()
    assert step.path_step.launches == before + 1 and not bvh.lane_counter(dev).any()
    got = list(_leaves(alone))
    want = list(_leaves(step.path_step_plain(*args)))
    assert len(got) == len(want) == 38
    hit = want[1] > 0.5
    for k, (a, b) in enumerate(zip(got, want)):
        if a.dtype != torch.float32 or k in (1, 2):  # integers, hit and kill: every lane
            assert torch.equal(a, b), k
        else:  # the next record's geometry is read on its hit lanes only
            m = hit if 3 <= k <= 15 else torch.ones_like(hit)
            torch.testing.assert_close(a[m], b[m], rtol=TOL, atol=TOL, msg=str(k))
    s0, s2, item = lane[6], want[30], want[34]
    if steps > 1:
        assert bool((s0 == st.ns).any()) and bool((item < st.ns).any()) and bool((s2 < st.ns).any())
    assert bool((want[0] >= 0).any()) and 0.2 < float(hit.float().mean()) < 1.0
    o, d, thr, key, depth = _inputs(n, n + 3, dev)
    queued = (step.path_step(*args), bounce.path_bounce(cs, *blobs, o, d, thr, key, depth))
    torch.cuda.synchronize()
    assert not bvh.lane_counter(dev).any()
    _assert_same_bits(queued[0], alone)
    _assert_same_bits(queued[1], bounce.path_bounce(cs, *blobs, o, d, thr, key, depth))


@pytest.mark.cuda
def test_step_kernel_launches_nothing_on_no_lanes(card):
    dev, cs, blobs = card

    def none_of(x):
        return type(x)(*map(none_of, x)) if isinstance(x, tuple) else x[:0].contiguous()

    args = _step_args(cs, blobs, dev, 64, 0)
    args = args[:5] + tuple(none_of(x) for x in args[5:])
    before = step.path_step.launches
    out = list(_leaves(step.path_step(*args)))
    torch.cuda.synchronize()
    assert len(out) == 38 and all(x.shape == (0,) for x in out)
    assert step.path_step.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])  # idx[1:], one element past a 16-byte boundary
@pytest.mark.parametrize("n", [131072, 4096 + 37, 1, 5])
def test_texture_gathers_match_plain(card, n, offset):
    """K8 and K9 against their plain version bit for bit, on indices below
    0, past the texels and past 128·R; at 1 and 5 lanes, and on an index
    view one element past a 16-byte boundary."""
    dev = card[0]
    cs = pt.compile_scene(pt.CustomSceneBuilder().build_scene(), texture_budget=64,
                          mip_budget=16, device=dev)
    for fn, table in ((texture.atlas_gather, cs.atlas), (texture.mip_gather, cs.mip_atlas)):
        m = int(table.shape[0])
        full = torch.randint(-3, m + 200, (n + 1,),
                             generator=torch.Generator(device=dev).manual_seed(n), device=dev,
                             dtype=torch.int32)
        idx = full[offset:offset + n]
        assert idx.data_ptr() // 4 % 4 == offset
        before = fn.launches
        got = fn(table, idx)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        for a, b in zip(got, texture.gather_plain(table, idx)):
            assert torch.equal(a, b)
        with pytest.raises(ValueError):
            fn(table, idx.long())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["pipe", "defer", "lod", "atlas"])
def test_path_tracer_modes_launch_their_kernels(card, monkeypatch, mode):
    kw, counter = {"texture_budget": 64}, {"pipe": step.path_step, "defer": texture.mip_gather,
                                           "lod": texture.mip_gather, "atlas": texture.atlas_gather}
    if mode == "pipe":
        monkeypatch.setattr(tpath, "_PIPE_REGEN", True)
    elif mode == "defer":
        kw["mip_budget"] = 16
    elif mode == "lod":
        kw["texture_lod"] = 16
    else:
        monkeypatch.setattr(texture, "ENABLED", True)
    b = pt.CustomSceneBuilder()
    scene, cam = b.build_scene(), b.create_camera(1.0)
    settings = pt.RenderSettings(width=64, height=64, samples_per_pixel=4, max_depth=4)
    before = (counter[mode].launches, bounce.path_bounce.launches)
    sums = pt.RendererFactory.create("cuda_path_raytracer", seed=1, **kw).render_sums(
        scene, cam, settings)
    assert counter[mode].launches > before[0]
    assert (bounce.path_bounce.launches > before[1]) == (mode != "pipe")
    assert sums.shape == (64 * 64, 3) and np.isfinite(sums).all() and (sums >= 0).all()
    if mode in ("pipe", "atlas"):  # the same image as the default path
        want = pt.RendererFactory.create("cuda_path_raytracer", seed=1, texture_budget=64)
        monkeypatch.setattr(tpath, "_PIPE_REGEN", False)
        monkeypatch.setattr(texture, "ENABLED", False)
        np.testing.assert_array_equal(sums, want.render_sums(scene, cam, settings))


@pytest.mark.cuda
@pytest.mark.parametrize("sample_parallel", [1, 2])
def test_mesh_of_one_card_equals_single(card, sample_parallel):
    """The (tile × sample) split on four entries of the one card, through K1:
    within ``atol=1e-5`` of the single-device sums; the tile-only split
    (``sample_parallel=1``) and the one-sample-per-entry split bit for bit."""
    from path_tracing__ray_tracer_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device("cuda", torch.cuda.current_device())
    b = pt.CustomSceneBuilder()
    scene, cam = b.build_scene(), b.create_camera(4 / 3)
    settings = pt.RenderSettings(width=96, height=72, samples_per_pixel=6, max_depth=4)
    mesh = make_mesh(4, sample_parallel=sample_parallel, devices=[dev] * 4)
    for group in (2, 6):
        single = pt.RendererFactory.create("cuda_path_raytracer", seed=3, sample_group=group,
                                           device=dev).render_sums(scene, cam, settings)
        before = bounce.path_bounce.launches
        sharded = pt.RendererFactory.create("cuda_path_raytracer", seed=3, sample_group=group,
                                            mesh=mesh).render_sums(scene, cam, settings)
        assert bounce.path_bounce.launches > before
        if sample_parallel == 1 or group == 2:
            np.testing.assert_array_equal(sharded, single)
        else:
            np.testing.assert_allclose(sharded, single, atol=1e-5)


@pytest.mark.cuda
def test_graft_entry_on_the_card(card):
    """``graft_entry.entry()`` on the card launches K1 and gives the path
    tracer's chunk sums bit for bit."""
    from path_tracing__ray_tracer_tpu_torch import graft_entry

    dev = torch.device("cuda", torch.cuda.current_device())
    fn, args = graft_entry.entry(dev)
    before = bounce.path_bounce.launches
    out = fn(*args)
    assert bounce.path_bounce.launches > before
    assert tuple(out.shape) == (3, 4096) and bool(torch.isfinite(out).all())
    ref = pt.RendererFactory.create("cuda_path_raytracer", seed=0, sample_group=4,
                                    device=dev).device_sums(*graft_entry._example_scene(),
                                                            pt.RenderSettings(64, 64, 4, 4))
    assert torch.equal(out, ref)
