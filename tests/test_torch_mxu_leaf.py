"""The port's leaf coefficient table and its walks (K10's plain versions)
against the JAX package's MXU-leaf walks, on the CPU, where each kernel
wrapper of ``ops/cuda/bvh_leafmat.py`` takes its plain version.

* ``ops/bvh.pack_leaf_mat`` equals the JAX ``pack_leaf_mat`` float for
  float on ``tests/test_mxu_leaf.py``'s 53-triangle set and on a mesh whose
  gids carry unique-material ids; ``to_device`` and
  ``compiled_scene_from_numpy`` give that table, a paged tree none.
* The plain linear forms (``ops/bvh._forms``, f32) against float64
  Möller–Trumbore numerators, at the bars of the JAX
  ``test_pack_leaf_mat_reproduces_mt_numerators``; an infinite occlusion
  limit occludes as a huge finite one does.
* The plain walks with the table against the JAX MXU kernels in interpret
  mode (``intersect.USE_PALLAS`` and ``BVH_MXU_LEAF`` monkeypatched, the
  fixture of ``tests/test_mxu_leaf.py``; each JAX kernel runs once, shared by
  a module fixture), on a 192-triangle soup and a sphere (so the JAX fused
  scene kernels run), 512 rays of which half aim at the triangles, 30% of
  the occlusion lanes don't-care (limit −1):
  K10d (whole-tree occlusion) equal on every lane that needs an answer;
  K10c (whole-tree closest with attributes) ``t`` within ``rtol = atol =
  1e-5``, the triangle on ≥ 99% of lanes, u, v and the normal within 1e-4
  where it agrees; K10a / K10b (``scene_hit`` / ``scene_hit_any``) the same.
* ``scene_closest`` / ``scene_any`` per route case: which walk and which
  leaf test each takes (flag off, a paged tree, ``fused``, ``quad``,
  ``multipass``).
* The mesh path golden ``tests/goldens/torch_mesh_path.npy`` rendered
  through the MXU route, within the golden tolerance.

The kernels run only on a GPU: ``tests/test_torch_cuda.py`` holds them
against these plain versions there.
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
from path_tracing__ray_tracer_tpu_torch.compiler import compiled_scene_from_numpy
from path_tracing__ray_tracer_tpu_torch.ops import bvh as tbvh
from path_tracing__ray_tracer_tpu_torch.ops import intersect as tint
from path_tracing__ray_tracer_tpu_torch.ops.cuda import bvh as kbvh
from path_tracing__ray_tracer_tpu_torch.ops.cuda import bvh_leafmat, bvh_paged
from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3
from test_torch_paged import _soup
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

GOLDENS = Path(__file__).parent / "goldens"
N_RAYS = 512
WRAPPERS = (bvh_leafmat.scene_closest, bvh_leafmat.scene_any, bvh_leafmat.tri_closest,
            bvh_leafmat.tri_any)


def _v3(a):
    return V3.from_array(torch.from_numpy(np.ascontiguousarray(a)))


def _tri53():
    """The 53-triangle set of the JAX ``test_pack_leaf_mat_reproduces_mt_numerators``."""
    rng = np.random.default_rng(3)
    v0 = rng.uniform(-8, 8, (53, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-2, 2, (53, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-2, 2, (53, 3)).astype(np.float32)
    arrs = jbvh.build_bvh(np.minimum(np.minimum(v0, v1), v2), np.maximum(np.maximum(v0, v1), v2),
                          leaf_size=16, use_native=False)
    return arrs, v0, v1, v2


@pytest.mark.parametrize("case", ["tri53", "mesh", "paged"])
def test_pack_leaf_mat_matches_jax(monkeypatch, case):
    if case == "tri53":
        arrs, v0, v1, v2 = _tri53()
        got = tbvh.pack_leaf_mat(arrs, v0, v1, v2)
        assert got.dtype == np.float32 and got.shape == (16, 128 * int(arrs["is_leaf"].sum()))
        np.testing.assert_array_equal(got, jpack.pack_leaf_mat(arrs, v0, v1, v2))
        return
    if case == "paged":  # the budgets of tests/test_torch_paged.py in both packages
        monkeypatch.setattr(tbvh, "ONE_LEVEL_LIMIT", 2600)
        monkeypatch.setattr(tbvh, "PAGE_BUDGET_FLOATS", 800)
        monkeypatch.setattr(jpack, "SMEM_BLOB_LIMIT", 2600)
        monkeypatch.setattr(jpaged, "PAGE_BUDGET_FLOATS", 800)
    jcs = jp.compile_scene(MeshSceneBuilder(grid=2, subdivisions=1).build_scene())
    own = pt.compile_scene(pt.MeshSceneBuilder(grid=2, subdivisions=1).build_scene(), device="cpu")
    carried = compiled_scene_from_numpy(jax.tree.map(np.asarray, jcs), device="cpu").bvh
    assert jcs.bvh.leaf_mat is not None and own.bvh.uid_packed  # gids carry material ids
    if case == "paged":
        assert own.bvh.paged is not None and carried.paged is not None
        assert own.bvh.leaf_mat is None and carried.leaf_mat is None
        return
    want = np.asarray(jcs.bvh.leaf_mat)
    np.testing.assert_array_equal(own.bvh.leaf_mat.numpy(), want)
    np.testing.assert_array_equal(carried.leaf_mat.numpy(), want)
    assert own.bvh.paged is None and want.shape[1] == 128 * int(own.bvh.is_leaf.sum())


def test_leaf_forms_reproduce_mt_numerators():
    """The f32 forms of every real slot, for 64 rays, against float64
    Möller–Trumbore numerators at the JAX test's bars; padding slots give
    ``det == 0``; the gid row holds the triangle."""
    arrs, v0, v1, v2 = _tri53()
    mat = torch.from_numpy(tbvh.pack_leaf_mat(arrs, v0, v1, v2))
    rng = np.random.default_rng(4)
    o = rng.uniform(-10, 10, (64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    f = tbvh.leaf_features(_v3(o), _v3(d))  # (10, 64)
    det, un, vn, tn = (x.double().numpy() for x in tbvh._forms(
        lambda r, q: mat[r].view(-1, 8, 16)[:, q].reshape(-1, 1), f))  # (G·16, 64)
    slots = arrs["slots"][arrs["is_leaf"]].reshape(-1)
    real = slots >= 0
    tri = slots[real]
    e1, e2 = (v1 - v0).astype(np.float64)[tri], (v2 - v0).astype(np.float64)[tri]
    od, dd = o.astype(np.float64), d.astype(np.float64)
    h = np.cross(dd[None], e2[:, None])  # (T, 64, 3)
    s = od[None] - v0.astype(np.float64)[tri][:, None]
    q = np.cross(s, e1[:, None])
    want = (np.einsum("tj,trj->tr", e1, h), np.einsum("trj,trj->tr", s, h),
            np.einsum("trj,rj->tr", q, dd), np.einsum("tj,trj->tr", e2, q))
    for got, w, rel in zip((det, un, vn, tn), want, (1e-4, 1e-3, 1e-3, 1e-3)):
        assert (np.abs(got[real] - w) < rel * np.maximum(1.0, np.abs(w))).all()
    assert (det[~real] == 0.0).all()
    gid = mat[9].view(-1, 8, 16)[:, 7].reshape(-1).numpy()
    np.testing.assert_array_equal(gid[real], tri)
    # an infinite limit: limit·det² is infinite, so every slot hit beyond t_min occludes
    forms = tbvh._forms(lambda r, q: mat[r].view(-1, 8, 16)[:, q].reshape(-1, 1), f)
    occ_inf = tbvh._leaf_any_mat(*forms, 1e-3, torch.tensor(float("inf")))
    assert torch.equal(occ_inf, tbvh._leaf_any_mat(*forms, 1e-3, torch.tensor(1e30)))
    t, hit = tbvh._leaf_closest_mat(*forms, 1e-3, torch.tensor(float("inf")))
    assert torch.equal(occ_inf, hit) and bool(hit.any())


def _soup_rays(tcs, n, seed):
    """Half the rays aim at random points of random triangles of the soup,
    half go anywhere; occlusion limits in (2, 25), 30% of them −1."""
    g = np.random.default_rng(seed)
    ro = g.uniform(-12, 12, (n, 3)).astype(np.float32)
    tri = tcs.triangles
    k = g.integers(0, tcs.n_triangles, n // 2)
    a, b = g.random((2, n // 2))
    s = np.sqrt(a)[:, None]
    v0, v1, v2 = (np.stack([c.numpy() for c in v], 1)[k] for v in (tri.v0, tri.v1, tri.v2))
    aim = v0 * (1 - s) + v1 * (s * (1 - b[:, None])) + v2 * (s * b[:, None])
    rd = np.concatenate([aim - ro[: n // 2], g.normal(size=(n - n // 2, 3))]).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    lim = np.where(g.random(n) < 0.3, -1.0, g.uniform(2.0, 25.0, n)).astype(np.float32)
    return ro, rd, lim


@pytest.fixture(scope="module")
def soup_mxu():
    """The soup in both packages and the JAX MXU kernels' answers, each
    kernel run once in interpret mode."""
    from jax.experimental.pallas import tpu as pltpu

    jcs = jp.compile_scene(_soup(jp, 192, 11), use_bvh=True)
    tcs = pt.compile_scene(_soup(pt, 192, 11), device="cpu", use_bvh=True)
    ro, rd, lim = _soup_rays(tcs, N_RAYS, 12)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jint, "USE_PALLAS", True)
        mp.setattr(jpack, "BVH_MXU_LEAF", True)
        assert jpack._mxu_leaf_ok(jcs.bvh) and jpack._scene_fused_ok(jcs)
        with pltpu.force_tpu_interpret_mode():
            o, d, lj = JV3.from_array(ro), JV3.from_array(rd), jax.numpy.asarray(lim)
            refs = {"any": jpack.bvh_any_pallas(jcs.bvh, o, d, 1e-3, lj),
                    "attrs": jpack.bvh_closest_attrs_pallas(jcs.bvh, o, d, 1e-3, 1e6),
                    "hit": jint.scene_hit(jcs, o, d, 1e-3, 1e6),
                    "occ": jint.scene_hit_any(jcs, o, d, 1e-3, lj)}
            refs = jax.tree.map(np.asarray, refs)
    return tcs, (ro, rd, lim), refs


def _close_on(got, want, lanes, tol):
    np.testing.assert_allclose(np.asarray(got)[lanes], np.asarray(want)[lanes], rtol=tol, atol=tol)


def test_tri_any_matches_jax(soup_mxu):
    """K10d's plain version against ``bvh_any_pallas`` (``_bvh4_any_mxu_kernel``)."""
    tcs, (ro, rd, lim), refs = soup_mxu
    found = torch.zeros(N_RAYS, dtype=torch.bool)
    occ = bvh_leafmat.tri_any(tcs, _v3(ro), _v3(rd), 1e-3, torch.from_numpy(lim), found).numpy()
    care = lim > 0
    np.testing.assert_array_equal(occ[care], refs["any"][care])
    assert 0.2 < occ[care].mean() < 0.8 and refs["any"][~care].all()
    assert all(w.launches == 0 for w in WRAPPERS)


def _barycentrics64(tcs, ro, rd, local):
    """Float64 Möller–Trumbore ``(u, v)`` of each ray against its triangle."""
    tri = tcs.triangles
    v0, v1, v2 = (np.stack([c.numpy() for c in v], 1).astype(np.float64)[np.maximum(local, 0)]
                  for v in (tri.v0, tri.v1, tri.v2))
    e1, e2, s, d = v1 - v0, v2 - v0, ro - v0, rd.astype(np.float64)
    h = np.cross(d, e2)
    det = (e1 * h).sum(1)
    return (s * h).sum(1) / det, (np.cross(s, e1) * d).sum(1) / det


def test_tri_closest_matches_jax(soup_mxu):
    """K10c's plain version against ``bvh_closest_attrs_pallas``
    (``_bvh4_closest_attrs_mxu_kernel``): its local id, ``t``, raw
    barycentrics and stored normal (flipped toward the ray in the port).
    Both sum each form's products in f32, in different orders, and at a
    grazing hit ``u·det / det`` magnifies that rounding: u and v are held
    within 1e-4 plus twice the JAX value's own distance from the float64
    Möller–Trumbore value."""
    tcs, (ro, rd, _lim), refs = soup_mxu
    bt, bi, bu, bv, bn = refs["attrs"]
    zero = torch.zeros(N_RAYS)
    none = torch.full((N_RAYS,), -1, dtype=torch.int32)
    seed = tint.ClosestRecord(torch.full((N_RAYS,), 1e6), none, zero, zero, V3(zero, zero, zero))
    rec = bvh_leafmat.tri_closest(tcs, _v3(ro), _v3(rd), 1e-3, seed)
    off = tcs.n_planes + tcs.n_spheres + tcs.n_quads
    prim = rec.prim.numpy()
    local = np.where(prim >= 0, prim - off, -1)
    np.testing.assert_allclose(rec.t.numpy(), bt, rtol=1e-5, atol=1e-5)
    same = local == bi
    assert same.mean() >= 0.99, same.mean()
    hit = same & (bi >= 0)
    assert 0.4 < hit.mean() < 0.9
    for got, want, exact in zip((rec.u.numpy(), rec.v.numpy()), (bu, bv),
                                _barycentrics64(tcs, ro, rd, local)):
        bar = 1e-4 + 2.0 * np.abs(want - exact)
        assert (np.abs(got - want) <= bar)[hit].all()
    n = np.stack([np.asarray(c) for c in bn])
    n = np.where((n * rd.T).sum(0) > 0.0, -n, n)
    _close_on(torch.stack(tuple(rec.normal)).numpy().T, n.T, hit, 1e-4)


def test_scene_walks_match_jax(soup_mxu, monkeypatch):
    """K10a / K10b's plain versions, through ``scene_hit`` / ``scene_hit_any``
    with the flag on, against the JAX ones through theirs
    (``_bvh4_scene_closest_mxu_kernel`` / ``_bvh4_scene_any_mxu_kernel``)."""
    tcs, (ro, rd, lim), refs = soup_mxu
    monkeypatch.setattr(kbvh, "BVH_MXU_LEAF", True)
    assert kbvh.tri_route(tcs) == "fused" and kbvh.mxu_leaf_ok(tcs)
    o, d = _v3(ro), _v3(rd)
    h, want = tint.scene_hit(tcs, o, d, 1e-3, 1e6), refs["hit"]
    np.testing.assert_array_equal(h.hit.numpy(), want.hit)
    np.testing.assert_allclose(h.t.numpy(), want.t, rtol=1e-5, atol=1e-5)
    same = h.prim.numpy() == want.prim
    assert same.mean() >= 0.99, same.mean()
    lanes = same & want.hit
    assert 0.4 < lanes.mean() < 0.95
    for a, b in ((h.u, want.u), (h.v, want.v), *zip(h.normal, want.normal)):
        _close_on(a.numpy(), b, lanes, 1e-4)
    occ = tint.scene_hit_any(tcs, o, d, 1e-3, torch.from_numpy(lim)).numpy()
    care = lim > 0
    np.testing.assert_array_equal(occ[care], refs["occ"][care])
    assert 0.2 < occ[care].mean() < 0.8
    assert all(w.launches == 0 for w in WRAPPERS)


# flags, paged tree, (closest walk, any walk), (closest leaf test, any leaf test)
ROUTE_CASES = {
    "flag_off": ({}, False, ("K4a", "K4b"), ("slots", "slots")),
    "paged": (dict(BVH_MXU_LEAF=True), True, ("K6", "K6"), ("slots", "slots")),
    "fused": (dict(BVH_MXU_LEAF=True), False, ("K10a", "K10b"), ("table", "table")),
    "quad": (dict(BVH_MXU_LEAF=True, BVH_ATTRS=False), False, ("K10c", "K10d"),
             ("table", "table")),
    "multipass": (dict(BVH_MXU_LEAF=True, BVH_ATTRS=False, BVH_MULTIPASS=True, _MP_MIN_DEPTH4=1),
                  False, ("K11", "K10d"), ("slots", "table")),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_mxu_route(soup_mxu, monkeypatch, case):
    flags, paged, walks, leaves = ROUTE_CASES[case]
    tcs = soup_mxu[0]
    if paged:
        monkeypatch.setattr(tbvh, "ONE_LEVEL_LIMIT", 2600)
        monkeypatch.setattr(tbvh, "PAGE_BUDGET_FLOATS", 800)
        tcs = pt.compile_scene(_soup(pt, 160, 7), device="cpu", use_bvh=True)
        assert tcs.bvh.paged is not None and tcs.bvh.leaf_mat is None
    for k, v in flags.items():
        monkeypatch.setattr(kbvh, k, v)
    calls, tests = [], []
    for mod, name, label in (
            (kbvh, "scene_hit_bvh_plain", "K4a"), (kbvh, "scene_hit_any_bvh_plain", "K4b"),
            (kbvh, "scene_hit_paged_plain", "K6"), (kbvh, "scene_hit_any_paged_plain", "K6"),
            (bvh_paged, "pages_closest", "K4c"), (bvh_paged, "pages_any", "K4d"),
            (kbvh, "closest_rooted", "K11"), (bvh_leafmat, "scene_closest", "K10a"),
            (bvh_leafmat, "scene_any", "K10b"), (bvh_leafmat, "tri_closest", "K10c"),
            (bvh_leafmat, "tri_any", "K10d")):
        def spy(*a, _fn=getattr(mod, name), _label=label, **k):
            calls.append(_label)
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    walk = tbvh._walk

    def spy_walk(*a, **k):
        tests.append((a[6], "slots" if k.get("leaf_mat") is None else "table"))
        return walk(*a, **k)

    monkeypatch.setattr(tbvh, "_walk", spy_walk)
    ro, rd, lim = _soup_rays(tcs, 64, 13)
    o, d = _v3(ro), _v3(rd)
    kbvh.scene_closest(tcs, o, d, 1e-3, 1e6)
    closest, calls[:] = calls[:], []
    closest_tests = {t for any_hit, t in tests if not any_hit}
    tests.clear()
    kbvh.scene_any(tcs, o, d, 1e-3, torch.from_numpy(lim))
    assert (set(closest), set(calls)) == ({walks[0]}, {walks[1]})
    assert closest_tests == {leaves[0]} and {t for _a, t in tests} == {leaves[1]}


@pytest.fixture(scope="module")
def mesh_scene():
    b = pt.MeshSceneBuilder(grid=2, subdivisions=1)
    return b.build_scene(), b.create_camera(4.0 / 3.0)


@pytest.mark.parametrize("route", ["fused", "quad"])
def test_mxu_route_renders_mesh_golden(mesh_scene, monkeypatch, route):
    """The path tracer's golden mesh frame through the MXU route: on the CPU
    its plain bounce's queries take K10a/K10b's plain versions (``fused``,
    where the card runs K5 and K10b) or K10c/K10d's (``quad``)."""
    scene, cam = mesh_scene
    monkeypatch.setattr(kbvh, "BVH_MXU_LEAF", True)
    if route == "quad":
        monkeypatch.setattr(kbvh, "BVH_ATTRS", False)
    walk, tests = tbvh._walk, []
    monkeypatch.setattr(tbvh, "_walk", lambda *a, **k: tests.append(k.get("leaf_mat") is not None)
                        or walk(*a, **k))
    r = pt.RendererFactory.create("cuda_path_raytracer", seed=42, device="cpu",
                                  compile_overrides={"use_bvh": True}, shadow_tmax="light")
    cs = r.compiled(scene)
    assert kbvh.tri_route(cs) == route and kbvh.mxu_leaf_ok(cs)
    img = np.asarray(r.render(scene, cam, pt.RenderSettings(40, 30, 4, 6)))
    golden = np.load(GOLDENS / "torch_mesh_path.npy")
    assert img.shape == golden.shape and tests and all(tests)
    diff = np.abs(img.astype(np.int32) - golden.astype(np.int32))
    assert float((diff > 2).mean()) < 0.01, (float((diff > 2).mean()), int(diff.max()))
    assert img.mean() > 20
