"""The port's paged BVH (``ops/bvh.pack_paged``, the plain top and page walks,
``ops/intersect.scene_hit_paged_plain`` / ``scene_hit_any_paged_plain``, the
compiler's carry of a JAX paged tree) against the JAX package's.

Paging is forced on small scenes by shrinking the budgets, as the JAX
package's ``tests/test_bvh_paged.py`` does: the port's ``ONE_LEVEL_LIMIT``
(the JAX ``SMEM_BLOB_LIMIT``) and ``PAGE_BUDGET_FLOATS`` are module globals.
The scenes are that file's 160-triangle soup, built by each package from
the same numbers, and the ``MeshSceneBuilder(grid=2, subdivisions=1)`` mesh
(320 triangles).  The JAX side runs its XLA formulation on the CPU under
``jax.jit``: the JAX package's own paged tests hold its paged kernels to
that same walk.

* ``pack_paged``: every array exactly the JAX ``pack_paged``'s, the page
  count and depths equal, with and without the budget escalation.
* The plain paged closest / any walks against the JAX ``scene_hit`` /
  ``scene_hit_any``: the bars of ``tests/test_torch_bvh.py``.
* The pending masks of the plain top walk hold every page whose root box
  the lane enters at its final best ``t`` (more than 32 pages: both words).
* Renders through the paged route against the JAX mesh goldens of
  ``tests/test_torch_mesh.py``, the paged plain walks spied on.
* ``compiled_scene_from_numpy`` of a JAX scene compiled with paging forced
  carries the same paged tensors as the port's own compile.
* ``PagedBlobs.page_slot16``, the port's padded copy of each page's slot
  records that the page walks read as 16-byte loads: the JAX
  ``pack_paged``'s ``page_slot`` float for float in 13 columns of 16, zeros
  in the other 3, as ``to_device`` builds it (the soup, the mesh) and as
  ``compiled_scene_from_numpy`` carries a JAX paged tree.
* The top tables the top walks K6a/K6b copy as 16-byte loads (or read
  from device memory, ``ops/cuda/bvh_paged.top_plan``): whole 128 B node
  records and whole leaves of 16 top slots of 13 floats, contiguous, as
  ``to_device`` builds them (the mesh, and the 48-page scene, which has
  real top slots) and as ``compiled_scene_from_numpy`` carries the JAX
  compile, float for float; the plan of their sizes.

The kernels K6a-d and K4c/K4d run only on a GPU: ``tests/test_torch_cuda.py``
holds them against these plain versions there.
"""
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import path_tracing__ray_tracer_tpu as jp
import path_tracing__ray_tracer_tpu_torch as pt
from path_tracing__ray_tracer_tpu.ops import bvh as jbvh
from path_tracing__ray_tracer_tpu.ops import intersect as jint
from path_tracing__ray_tracer_tpu.ops.pallas import bvh_paged_pallas as jpaged
from path_tracing__ray_tracer_tpu.ops.pallas import bvh_pallas as jpack
from path_tracing__ray_tracer_tpu.ops.v3 import V3 as JV3
from path_tracing__ray_tracer_tpu.scene_builders.mesh_scene_builder import MeshSceneBuilder
from path_tracing__ray_tracer_tpu_torch.compiler import compile_scene, compiled_scene_from_numpy
from path_tracing__ray_tracer_tpu_torch.ops import bvh as tbvh
from path_tracing__ray_tracer_tpu_torch.ops import intersect as tint
from path_tracing__ray_tracer_tpu_torch.ops.cuda import bvh as kbvh
from path_tracing__ray_tracer_tpu_torch.ops.cuda import bvh_paged
from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-4
AGREE = 0.9999
GOLDENS = Path(__file__).parent / "goldens"
PAGED_FIELDS = ("top_tree", "top_slot", "page_tree", "page_slot", "page_lo", "page_hi")


def _soup(pkg, n_tris, seed):
    """``tests/test_bvh_paged.py``'s triangle soup in package ``pkg``."""
    rng = np.random.default_rng(seed)
    scene = pkg.Scene()
    mats = [pkg.Material(pkg.Vec3(0.7, 0.6, 0.5), diffuse=0.8),
            pkg.Material(pkg.Vec3(0.3, 0.5, 0.9), diffuse=0.6, reflective=0.3)]
    for k in range(n_tris):
        a = rng.uniform(-10, 10, 3)
        b = a + rng.uniform(-2, 2, 3)
        c = a + rng.uniform(-2, 2, 3)
        scene.add_object(pkg.Triangle(pkg.Vec3(*a), pkg.Vec3(*b), pkg.Vec3(*c),
                                      material=mats[k % 2]))
    scene.add_object(pkg.Sphere(pkg.Vec3(0, 0, 0), 1.5, mats[0]))
    scene.add_light_sample(pkg.Vec3(0, 20, 0))
    return scene


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd


def _v3(a):
    return V3.from_array(torch.from_numpy(a))


@pytest.fixture
def force_paging(monkeypatch):
    """Page the small scenes: the JAX fixture's budgets, in the port."""
    monkeypatch.setattr(tbvh, "ONE_LEVEL_LIMIT", 2600)
    monkeypatch.setattr(tbvh, "PAGE_BUDGET_FLOATS", 800)


def _soup_arrays():
    """The JAX-compiled 160-triangle soup's triangles ``(v0, v1, v2, nrm)``,
    its ``build_bvh`` arrays and a unique-material id per triangle."""
    jcs = jp.compile_scene(_soup(jp, 160, 2), use_bvh=True)
    t = jcs.n_triangles
    v0, v1, v2, nrm = (np.stack([np.asarray(c) for c in v], -1)[:t]
                       for v in (jcs.triangles.v0, jcs.triangles.v1, jcs.triangles.v2,
                                 jcs.triangles.normal))
    arrs = jbvh.build_bvh(np.minimum(np.minimum(v0, v1), v2), np.maximum(np.maximum(v0, v1), v2),
                          use_native=False)
    return (v0, v1, v2, nrm), arrs, (np.arange(t) % 5).astype(np.int32)


@pytest.mark.parametrize("escalate", [False, True])
def test_pack_paged_matches_jax(monkeypatch, escalate):
    (v0, v1, v2, nrm), arrs, uid = _soup_arrays()
    if escalate:  # 6 pages at 800 floats is over 4: the budget doubles to the ceiling
        for mod in (tbvh, jpaged):
            monkeypatch.setattr(mod, "PAGES_MAX", 4)
            monkeypatch.setattr(mod, "PAGE_BUDGET_CEIL", 1600)
    got = tbvh.pack_paged(arrs, v0, v1, v2, nrm=nrm, uid=uid, budget_floats=800)
    want = jpaged.pack_paged(arrs, v0, v1, v2, nrm=nrm, uid=uid, budget_floats=800)
    assert got is not None and want is not None and got.n_pages == want.n_pages
    assert got.n_pages == (3 if escalate else 6)
    for k in PAGED_FIELDS:
        w = np.asarray(getattr(want, k))
        np.testing.assert_array_equal(getattr(got, k).numpy(), w[0] if w.shape[0] == 1
                                      and k.startswith("top") else w, err_msg=k)
    assert (got.top_depth, got.page_depth) == (want.top_depth_token.shape[0],
                                               want.page_depth_token.shape[0])
    # the page roots, read back from the top tree, are the cut's nodes
    np.testing.assert_array_equal(tbvh.page_roots(arrs, got.top_tree.numpy(), got.n_pages),
                                  got.page_root.numpy())
    np.testing.assert_array_equal(got.page_lo.numpy(), arrs["lo"][got.page_root.numpy()])


@pytest.fixture(scope="module")
def soup():
    """The 160-triangle soup: the JAX scene (XLA walks) and the port's."""
    return jp.compile_scene(_soup(jp, 160, 7), use_bvh=True), _soup(pt, 160, 7)


def test_paged_walks_match_jax(soup, force_paging):
    jcs, scene = soup
    tcs = compile_scene(scene, device="cpu", use_bvh=True)
    assert tcs.bvh.paged is not None and tcs.bvh.paged.n_pages >= 2
    ro, rd = _rays(256, 11)
    limit = np.random.default_rng(5).uniform(0.5, 30.0, 256).astype(np.float32)
    limit[::7] = -1.0

    @jax.jit
    def want(o, d, lim):
        o, d = JV3.from_array(o), JV3.from_array(d)
        return jint.scene_hit(jcs, o, d, 1e-3, 1e6), jint.scene_hit_any(jcs, o, d, 1e-3, lim)

    wh, wocc = want(ro, rd, limit)
    counts = {}
    got = tint.scene_hit_paged_plain(tcs, _v3(ro), _v3(rd), 1e-3, 1e6, counts=counts)
    assert counts["boxes"] > 256 and counts["tri_tests"] > 0
    same = got.prim.numpy() == np.asarray(wh.prim)
    hit = same & np.asarray(wh.hit)
    assert same.mean() >= AGREE and hit.mean() > 0.08  # rays in every direction
    for f in ("t", "point", "normal"):
        a, b = getattr(got, f), getattr(wh, f)
        a = torch.stack(tuple(a), -1).numpy() if isinstance(a, tuple) else a.numpy()
        b = np.asarray(b.to_array()) if isinstance(b, tuple) else np.asarray(b)
        np.testing.assert_allclose(a[hit], b[hit], rtol=TOL, atol=TOL, err_msg=f)
    occ = tint.scene_hit_any_paged_plain(tcs, _v3(ro), _v3(rd), 1e-3, torch.from_numpy(limit))
    care = limit > 0
    assert (occ.numpy() == np.asarray(wocc))[care].mean() >= AGREE
    assert 0.05 < occ.numpy()[care].mean() < 0.95
    # the routes on the CPU: scene_hit / scene_hit_any take the paged plain walks
    assert torch.equal(tint.scene_hit(tcs, _v3(ro), _v3(rd), 1e-3, 1e6).prim, got.prim)
    assert torch.equal(tint.scene_hit_any(tcs, _v3(ro), _v3(rd), 1e-3,
                                          torch.from_numpy(limit)), occ)


@pytest.fixture(scope="module")
def mesh_scene():
    b = pt.MeshSceneBuilder(grid=2, subdivisions=1)
    return b.build_scene(), b.create_camera(4.0 / 3.0)


def test_pend_masks_cover_entered_pages(monkeypatch):
    """K6a's plain version: a lane's words hold every page whose root box it
    enters at its final best ``t`` (a superset: taken at the running best).
    Pages of two leaves cut the 1,280-triangle mesh into 48 pages, so both
    words are used."""
    monkeypatch.setattr(tbvh, "ONE_LEVEL_LIMIT", 2600)
    monkeypatch.setattr(tbvh, "PAGE_BUDGET_FLOATS", 450)
    cs = compile_scene(pt.MeshSceneBuilder(grid=2, subdivisions=2).build_scene(), device="cpu")
    pg = cs.bvh.paged
    assert pg.n_pages == 48
    g = np.random.default_rng(12)
    ro = g.uniform(-14, 14, (512, 3)).astype(np.float32)
    rd = g.normal(size=(512, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    o, d = _v3(ro), _v3(rd)
    best, plo, phi = bvh_paged.paged_top_closest(cs, o, d, 1e-3, 1e6)
    final = bvh_paged.pages_closest(cs, o, d, 1e-3, best, plo, phi)
    want = tint.scene_hit_bvh_plain(cs, o, d, 1e-3, 1e6)  # the one-level walk
    assert (final.prim == want.prim).float().mean() >= AGREE
    pend = tbvh.pend_mask(plo, phi)
    entered = tbvh.page_root_mask(pg, o, d, 1e-3, final.t)
    assert bool((entered & ~pend == 0).all())
    assert bool((entered >> 32 != 0).any())  # pages past 31 are entered too
    assert bool((phi != 0).any()) and bool((plo != 0).any())


@pytest.mark.parametrize("name,renderer,kw,cfg", [
    ("torch_mesh_path", "cuda_path_raytracer", dict(shadow_tmax="light"), (40, 30, 4, 6)),
    ("torch_mesh_whitted", "cuda_texture_raytracer", {}, (48, 36, 4, 4)),
])
def test_mesh_render_through_paged_route_matches_golden(mesh_scene, force_paging, monkeypatch,
                                                        name, renderer, kw, cfg):
    """The JAX package's mesh goldens, rendered with paging forced: the
    path tracer takes the plain bounce, whose queries walk the pages."""
    calls = {"closest": 0, "any": 0}

    def spy(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(kbvh, "scene_hit_paged_plain", spy("closest", kbvh.scene_hit_paged_plain))
    monkeypatch.setattr(kbvh, "scene_hit_any_paged_plain",
                        spy("any", kbvh.scene_hit_any_paged_plain))
    scene, cam = mesh_scene
    r = pt.RendererFactory.create(renderer, seed=42, device="cpu",
                                  compile_overrides={"use_bvh": True}, **kw)
    assert r.compiled(scene).bvh.paged is not None
    img = np.asarray(r.render(scene, cam, pt.RenderSettings(*cfg)))
    golden = np.load(GOLDENS / f"{name}.npy")
    assert img.shape == golden.shape and img.dtype == np.uint8
    diff = np.abs(img.astype(np.int32) - golden.astype(np.int32))
    assert float((diff > 2).mean()) < 0.01, (float((diff > 2).mean()), int(diff.max()))
    assert calls["closest"] > 0 and calls["any"] > 0


def test_compiled_scene_from_numpy_carries_paged(mesh_scene, force_paging, monkeypatch):
    monkeypatch.setattr(jpack, "SMEM_BLOB_LIMIT", 2600)
    monkeypatch.setattr(jpaged, "PAGE_BUDGET_FLOATS", 800)
    jcs = jp.compile_scene(MeshSceneBuilder(grid=2, subdivisions=1).build_scene())
    assert jcs.bvh.paged is not None
    carried = compiled_scene_from_numpy(jax.tree.map(np.asarray, jcs), device="cpu")
    own = compile_scene(mesh_scene[0], device="cpu")
    got, want = carried.bvh.paged, own.bvh.paged
    assert got is not None and want is not None and got.n_pages == want.n_pages >= 2
    for k in PAGED_FIELDS + ("page_root",):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert (got.top_depth, got.page_depth) == (want.top_depth, want.page_depth)


@pytest.fixture(scope="module")
def jax_paged_mesh():
    """The JAX compile of the ``MeshSceneBuilder(2, 1)`` mesh with paging
    forced (``force_paging``'s budgets), its leaves as numpy arrays."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpack, "SMEM_BLOB_LIMIT", 2600)
        mp.setattr(jpaged, "PAGE_BUDGET_FLOATS", 800)
        jcs = jp.compile_scene(MeshSceneBuilder(grid=2, subdivisions=1).build_scene())
    assert jcs.bvh.paged is not None
    return jax.tree.map(np.asarray, jcs)


@pytest.mark.parametrize("source", ["soup", "mesh", "carried"])
def test_page_slot16_is_the_jax_page_slot_padded(mesh_scene, jax_paged_mesh, force_paging,
                                                 source):
    """``page_slot16`` as ``to_device`` builds it for the soup (against the
    JAX ``pack_paged`` of the same arrays) and for the mesh's compile, and
    as ``compiled_scene_from_numpy`` carries the JAX compile of the mesh
    (both against that compile's ``page_slot``)."""
    if source == "soup":
        (v0, v1, v2, nrm), arrs, uid = _soup_arrays()
        got = tbvh.to_device(arrs, v0, v1, v2, nrm, uid=uid).paged
        want = jpaged.pack_paged(arrs, v0, v1, v2, nrm=nrm, uid=uid, budget_floats=800).page_slot
    else:
        cs = (compile_scene(mesh_scene[0], device="cpu") if source == "mesh"
              else compiled_scene_from_numpy(jax_paged_mesh, device="cpu"))
        got, want = cs.bvh.paged, jax_paged_mesh.bvh.paged.page_slot
    want = np.asarray(want)
    n_pages, sc = want.shape
    assert got is not None and got.n_pages == n_pages >= 2 and sc % 13  # a part record at the end
    rec = want[:, : sc // 13 * 13].reshape(n_pages, -1, 13)
    pad = got.page_slot16.numpy().reshape(n_pages, -1, 16)
    assert pad.shape[1] == rec.shape[1] > 0
    np.testing.assert_array_equal(pad[:, :, :13], rec)
    assert not pad[:, :, 13:].any()
    assert bool((pad[:, :, 9] < 0).any())  # the leaves' -1 padding slots carried over
    assert got.page_slot16.is_contiguous() and got.page_slot16.data_ptr() % 16 == 0


def _paged_48(monkeypatch):
    """``test_pend_masks_cover_entered_pages``'s 48-page scene, compiled by
    the port on the CPU: 21 top nodes over 192 top slots, 168 of them real."""
    monkeypatch.setattr(tbvh, "ONE_LEVEL_LIMIT", 2600)
    monkeypatch.setattr(tbvh, "PAGE_BUDGET_FLOATS", 450)
    return compile_scene(pt.MeshSceneBuilder(grid=2, subdivisions=2).build_scene(), device="cpu")


@pytest.mark.parametrize("source", ["mesh", "carried", "48 pages"])
def test_top_tables_are_whole_records(mesh_scene, jax_paged_mesh, force_paging, monkeypatch,
                                      source):
    """The top tree and top slots as ``to_device`` builds them (the mesh;
    the 48-page scene, whose top leaves hold triangles) and as
    ``compiled_scene_from_numpy`` carries the JAX compile of the mesh (float
    for float): whole node records and whole leaves of slots, which the top
    walks copy as 16-byte loads; the plan of their sizes stages them on an
    H100 and reads them from device memory under a limit one byte short."""
    if source == "carried":
        cs = compiled_scene_from_numpy(jax_paged_mesh, device="cpu")
        jpg = jax_paged_mesh.bvh.paged
        np.testing.assert_array_equal(cs.bvh.paged.top_slot.numpy(), np.asarray(jpg.top_slot)[0])
        np.testing.assert_array_equal(cs.bvh.paged.top_tree.numpy(), np.asarray(jpg.top_tree)[0])
    else:
        cs = _paged_48(monkeypatch) if source == "48 pages" else compile_scene(mesh_scene[0],
                                                                               device="cpu")
    pg = cs.bvh.paged
    n_top, n_slots = pg.top_tree.shape[0] // 32, pg.top_slot.shape[0] // 13
    assert pg.top_tree.shape[0] == 32 * n_top and pg.top_slot.shape[0] == 13 * n_slots
    assert n_slots % 16 == 0  # whole leaves: 52 float4s each
    for t in (pg.top_tree, pg.top_slot):
        assert t.is_contiguous() and t.dtype == torch.float32
    real = int((pg.top_slot.view(-1, 13)[:, 9] >= 0).sum())
    if source == "48 pages":
        assert (pg.n_pages, n_top, pg.top_depth, real) == (48, 21, 3, 168)
    else:
        assert real == 0
    limit = 232_448 - 64  # an H100's block
    sizes = ((cs.n_planes, cs.n_spheres, cs.n_quads), n_top, n_slots, pg.top_depth)
    plan = bvh_paged.top_walk_plan(cs, limit)
    assert plan == bvh_paged.top_plan(*sizes, limit) and plan.stage
    assert plan.depth_class == 8
    short = bvh_paged.top_plan(*sizes, plan.smem_bytes - 1)
    assert not short.stage and plan.smem_bytes - short.smem_bytes == 4 * (32 * n_top + 13 * n_slots)


def test_whole_tree_page_walks_are_the_bvh_walks(mesh_scene):
    """K4c / K4d's plain versions: the page walks over the one-level tree,
    seeded with a per-ray bound, are the skip-link walks (config 5 and this
    mesh stay one-level)."""
    cs = compile_scene(mesh_scene[0], device="cpu")
    assert cs.bvh.paged is None
    g = np.random.default_rng(21)
    ro = g.uniform(-14, 14, (384, 3)).astype(np.float32)
    rd = g.normal(size=(384, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    o, d = _v3(ro), _v3(rd)
    bound = torch.from_numpy(g.uniform(-1.0, 40.0, 384).astype(np.float32))
    off = cs.n_planes + cs.n_spheres + cs.n_quads
    zero = torch.zeros(384)
    seed = tint.ClosestRecord(bound, torch.full((384,), -1, dtype=torch.int32), zero, zero,
                              V3(zero, zero, zero))
    rec = bvh_paged.pages_closest(cs, o, d, 1e-3, seed)
    t, prim = tbvh.traverse_closest(cs.bvh, cs.triangles, o, d, 1e-3, bound, tri_offset=off)
    assert torch.equal(rec.prim, prim) and torch.equal(rec.t, t) and bool((prim >= off).any())
    found = torch.arange(384) % 5 == 0
    occ = bvh_paged.pages_any(cs, o, d, 1e-3, bound, found)
    assert torch.equal(occ, found | tbvh.traverse_any(cs.bvh, cs.triangles, o, d, 1e-3, bound))
    assert bvh_paged.pages_closest.launches == bvh_paged.pages_any.launches == 0
