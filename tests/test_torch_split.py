"""The port's split BVH route (``ops/cuda/bvh.tri_route``, ``split_closest``,
``split_any``, the BVH2 walks of ``ops/cuda/bvh2.py`` and the multipass walk)
against the JAX package's, on the CPU, where each kernel wrapper takes its
plain version.

* The BVH2 records ``FlatBVH.tree2`` equal the JAX ``tree_blob`` float for
  float, ``depth2`` the length of its ``depth_token``; ``node2`` names the
  BVH2 node each BVH4 record collapses; ``compiled_scene_from_numpy``
  carries all three.
* ``tri_route`` for each flag combination, a BVH4 deeper than the walks'
  stack (``depth4 = 33``), a BVH2 too deep for the ordered walk's stack,
  and paged trees whose pages fit the stack or do not.
* The split route against the JAX ``scene_hit`` / ``scene_hit_any`` on a
  192-triangle soup (the JAX side: its XLA skip-link walk under
  ``jax.jit``, what its ``BVH_QUAD = False`` kernels are held to in
  ``tests/test_bvh_pallas.py``): hit and misses exactly, ``t`` within
  ``rtol = 1e-5`` (XLA's rounding on the CPU; against the port's default
  route, bit for bit), the winning primitive on > 99% of rays, occlusion
  exactly; the same on the soup's BVH with ``depth4`` set to 33, which must
  answer without a raise.
* ``subtree_nodes`` / ``subtree_keys2`` integer for integer against the JAX
  ``_subtree_nodes`` / ``_subtree_keys2``; the port's multipass walk against
  the JAX ``_bvh_closest_multipass`` (its rooted kernel in interpret mode,
  the fixture of ``tests/test_bvh_pallas.py``, on a tree of 2-triangle
  leaves so that the interpreter stays quick) and against the single pass.
* The mesh goldens of ``tests/test_torch_mesh.py`` rendered through each
  split route and through a tree too deep for the BVH4 walks, within the
  golden tolerance; the path tracer then takes the plain bounce, not K5.

The kernels K4e and K11 run only on a GPU: ``tests/test_torch_cuda.py``
holds them against these plain versions there.
"""
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import path_tracing__ray_tracer_tpu as jp
import path_tracing__ray_tracer_tpu_torch as pt
from path_tracing__ray_tracer_tpu.ops import bvh as jbvh
from path_tracing__ray_tracer_tpu.ops import intersect as jint
from path_tracing__ray_tracer_tpu.ops.pallas import bvh_pallas as jpack
from path_tracing__ray_tracer_tpu.ops.v3 import V3 as JV3
from path_tracing__ray_tracer_tpu_torch.compiler import compiled_scene_from_numpy
from path_tracing__ray_tracer_tpu_torch.models import path_tracer as tpath
from path_tracing__ray_tracer_tpu_torch.ops import bvh as tbvh
from path_tracing__ray_tracer_tpu_torch.ops import intersect as tint
from path_tracing__ray_tracer_tpu_torch.ops.cuda import bvh as kbvh
from path_tracing__ray_tracer_tpu_torch.ops.cuda import bvh2
from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3
from test_torch_paged import _soup
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

GOLDENS = Path(__file__).parent / "goldens"
FLAGS = ("BVH_QUAD", "BVH_ORDERED", "BVH_ATTRS", "BVH_MULTIPASS", "_MP_MIN_DEPTH4")
# the flags that force each split route on the soup and mesh trees (BVH4 depth 3)
ROUTES = {"ordered": dict(BVH_QUAD=False), "skiplink": dict(BVH_QUAD=False, BVH_ORDERED=False),
          "quad": dict(BVH_ATTRS=False),
          "multipass": dict(BVH_ATTRS=False, BVH_MULTIPASS=True, _MP_MIN_DEPTH4=1)}


@pytest.fixture
def flags(monkeypatch):
    """Set the port's route flags for one test (restored after it)."""
    def set_flags(**kw):
        for k, v in kw.items():
            assert k in FLAGS, k
            monkeypatch.setattr(kbvh, k, v)
    return set_flags


@pytest.fixture(scope="module")
def soup():
    """The 192-triangle soup in both packages, compiled with a BVH."""
    jcs = jp.compile_scene(_soup(jp, 192, 11), use_bvh=True)
    tcs = pt.compile_scene(_soup(pt, 192, 11), device="cpu", use_bvh=True)
    assert tcs.bvh is not None and tcs.bvh.paged is None and tcs.bvh.depth4 >= 2
    return jcs, tcs


def _rays(n, seed):
    """Rays from the soup's box toward points inside it."""
    g = np.random.default_rng(seed)
    ro = g.uniform(-12, 12, (n, 3)).astype(np.float32)
    rd = (g.uniform(-8, 8, (n, 3)) - ro).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


def _v3(a):
    return V3.from_array(torch.from_numpy(a))


@pytest.fixture(scope="module")
def soup_refs(soup):
    """JAX ``scene_hit`` (scalar and per-ray bound) and ``scene_hit_any`` on
    the soup, one compile."""
    jcs, _ = soup
    n = 1024
    ro, rd = _rays(n, 12)
    bound = np.random.default_rng(13).uniform(4.0, 30.0, n).astype(np.float32)
    bound[::7] = -1.0  # don't-care lanes of the occlusion query

    @jax.jit
    def refs(ro, rd, bound):
        o, d = JV3.from_array(ro), JV3.from_array(rd)
        hits = [jint.scene_hit(jcs, o, d, 1e-3, t) for t in (1e6, bound)]
        return [(h.hit, h.t, h.prim) for h in hits], jint.scene_hit_any(jcs, o, d, 1e-3, bound)

    hits, occ = refs(ro, rd, bound)
    return (ro, rd, bound), [tuple(np.asarray(x) for x in h) for h in hits], np.asarray(occ)


def test_bvh2_records_match_jax(soup):
    jcs, tcs = soup
    jb, tb = jcs.bvh, tcs.bvh
    np.testing.assert_array_equal(tb.tree2.numpy(), np.asarray(jb.tree_blob)[0])
    assert tb.depth2 == jb.depth_token.shape[0] > tb.depth4
    # node2[r] is the BVH2 node that record r collapses: its child slots hold
    # the boxes of that node's children's children (a leaf child: its own box)
    lo, hi, skip, is_leaf = tb.lo, tb.hi, tb.skip.long(), tb.is_leaf
    recs = tb.nodes4.view(-1, 32)
    assert tb.node2.shape == (recs.shape[0],) and int(tb.node2[0]) == 0
    for r, i in enumerate(tb.node2.tolist()):
        kids = []
        for sub in (i + 1, int(skip[i + 1])):
            kids += [sub, None] if is_leaf[sub] else [sub + 1, int(skip[sub + 1])]
        for c, k in enumerate(kids):
            if k is not None:
                assert torch.equal(recs[r, 6 * c: 6 * c + 6], torch.cat([lo[k], hi[k]])), (r, c)
    carried = compiled_scene_from_numpy(jax.tree.map(np.asarray, jcs), device="cpu").bvh
    assert torch.equal(carried.tree2, tb.tree2) and torch.equal(carried.node2, tb.node2)
    assert carried.depth2 == tb.depth2


def _fake(depth4=3, depth2=6, paged=None):
    """A scene whose BVH has only what ``tri_route`` reads."""
    return SimpleNamespace(bvh=SimpleNamespace(depth4=depth4, depth2=depth2, paged=paged))


def _paged(top, page):
    return SimpleNamespace(top_depth=top, page_depth=page)


@pytest.mark.parametrize("set_flags,scene,per_ray,route", [
    ({}, _fake(), False, "fused"),
    ({}, _fake(), True, "quad"),
    (ROUTES["ordered"], _fake(), False, "ordered"),
    (ROUTES["skiplink"], _fake(), False, "skiplink"),
    (ROUTES["quad"], _fake(), False, "quad"),
    (dict(BVH_ATTRS=False, BVH_MULTIPASS=True), _fake(depth4=4), False, "multipass"),
    (dict(BVH_ATTRS=False, BVH_MULTIPASS=True), _fake(depth4=3), False, "quad"),
    (dict(BVH_MULTIPASS=True), _fake(depth4=6), False, "fused"),
    (dict(BVH_MULTIPASS=True), _fake(depth4=6), True, "multipass"),
    (dict(BVH_QUAD=False, BVH_MULTIPASS=True), _fake(depth4=6), False, "ordered"),
    ({}, _fake(depth4=32), False, "fused"),
    ({}, _fake(depth4=33, depth2=66), False, "ordered"),
    ({}, _fake(depth4=33, depth2=66), True, "ordered"),
    (dict(BVH_ORDERED=False), _fake(depth4=33, depth2=66), False, "skiplink"),
    (ROUTES["ordered"], _fake(depth2=190), False, "ordered"),
    (ROUTES["ordered"], _fake(depth2=191), False, "skiplink"),
    ({}, _fake(paged=_paged(8, 12)), False, "paged"),
    ({}, _fake(paged=_paged(8, 12)), True, "quad"),
    (ROUTES["ordered"], _fake(paged=_paged(8, 12)), False, "paged"),
    ({}, _fake(depth4=40, depth2=80, paged=_paged(8, 33)), False, "ordered"),
    ({}, _fake(depth4=40, depth2=80, paged=_paged(33, 8)), True, "ordered"),
])
def test_tri_route(flags, set_flags, scene, per_ray, route):
    flags(**set_flags)
    assert kbvh.tri_route(scene, per_ray=per_ray) == route


def _check_hits(got, want, default):
    """The split route's ``SceneHit`` against JAX's ``(hit, t, prim)`` and
    against the port's default route on the same rays (``default``): its
    ``t`` bit for bit where the winners agree.  Against JAX ``t`` is held
    within ``rtol = 1e-5``: XLA on the CPU rounds the walk's products
    differently (up to 4e-6 relative measured here)."""
    hit, t, prim = want
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_allclose(got.t.numpy(), t, rtol=1e-5, atol=1e-6)
    assert (got.prim.numpy() == prim).mean() > 0.99
    assert 0.1 < hit.mean() < 1.0
    same = got.prim == default.prim
    assert float(same.float().mean()) > 0.99 and torch.equal(got.t[same], default.t[same])


@pytest.mark.parametrize("route", ["ordered", "skiplink", "quad", "multipass", "deep"])
def test_split_route_matches_jax(soup, soup_refs, flags, route):
    _, tcs = soup
    (ro, rd, bound), (want_scalar, want_ray), want_occ = soup_refs
    if route == "deep":  # a BVH4 too deep for the walks' stack: K4e, no raise
        tcs = tcs._replace(bvh=tcs.bvh._replace(depth4=kbvh.MAX_DEPTH4 + 1))
        route = "ordered"
    else:
        flags(**ROUTES[route])
    o, d = _v3(ro), _v3(rd)
    default = [tint.scene_hit_bvh_plain(tcs, o, d, 1e-3, t) for t in (1e6, torch.from_numpy(bound))]
    assert kbvh.tri_route(tcs) == route
    _check_hits(tint.scene_hit(tcs, o, d, 1e-3, 1e6), want_scalar, default[0])
    _check_hits(tint.scene_hit(tcs, o, d, 1e-3, torch.from_numpy(bound)), want_ray, default[1])
    occ = tint.scene_hit_any(tcs, o, d, 1e-3, torch.from_numpy(bound)).numpy()
    care = bound > 0
    np.testing.assert_array_equal(occ[care], want_occ[care])
    assert 0.05 < occ[care].mean() < 0.95
    counts = (bvh2.closest_ordered, bvh2.closest_skiplink, bvh2.any_ordered, bvh2.any_skiplink,
              kbvh.closest_rooted)
    assert all(w.launches == 0 for w in counts)  # CPU: the plain versions


def test_deep_chain_matches_jax():
    """A BVH2 chain as deep as the ordered walk's stack takes
    (``tests/torch_chain.py``): records equal to JAX's, routed to the
    ordered walk (one level deeper: the skip-link walk), and the walks
    (their plain versions here) against JAX's XLA walk: winners and misses
    equal, ``t`` within 1e-4, occlusion equal."""
    from torch_chain import chain_arrays, chain_rays, chain_scene

    depth2 = kbvh.STACK_CAP - 2
    arrs, v0, v1, v2 = chain_arrays(depth2)
    jb = jbvh.to_device(arrs)  # the XLA walk's arrays; the records packed alone below
    tree_blob, _slots, jdepth2 = jpack.pack_blobs(arrs, v0, v1, v2)
    tcs = chain_scene(depth2)
    np.testing.assert_array_equal(tcs.bvh.tree2.numpy(), tree_blob[0])
    assert tcs.bvh.depth2 == jdepth2 == depth2
    assert kbvh.tri_route(tcs) == kbvh.tri_route(tcs, per_ray=True) == "ordered"
    deeper = chain_scene(depth2 + 1)
    assert deeper.bvh.depth2 == depth2 + 1 and kbvh.tri_route(deeper) == "skiplink"
    ro, rd = chain_rays(depth2, 600, 33)
    jtris = SimpleNamespace(**{k: JV3.from_array(a) for k, a in (("v0", v0), ("v1", v1),
                                                                 ("v2", v2))})
    limit = np.random.default_rng(34).uniform(0.5, 1.5, 600).astype(np.float32)  # hits at ~1

    @jax.jit
    def refs(ro, rd, limit):
        o, d = JV3.from_array(ro), JV3.from_array(rd)
        return (jbvh.traverse_closest(jb, jtris, o, d, 1e-3, 1e6),
                jbvh.traverse_any(jb, jtris, o, d, 1e-3, limit))

    (wt, wi), want_occ = refs(ro, rd, limit)
    for closest, occluded in ((bvh2.closest_ordered, bvh2.any_ordered),
                              (bvh2.closest_skiplink, bvh2.any_skiplink)):
        t, tri = closest(tcs, _v3(ro), _v3(rd), 1e-3, 1e6)
        np.testing.assert_array_equal(tri.numpy(), np.asarray(wi))
        np.testing.assert_allclose(t.numpy(), np.asarray(wt), rtol=1e-4, atol=1e-4)
        assert (tri.numpy()[:200] == depth2 - 1).all()  # the rays that fill the stack
        occ = occluded(tcs, _v3(ro), _v3(rd), 1e-3, torch.from_numpy(limit)).numpy()
        np.testing.assert_array_equal(occ, np.asarray(want_occ))
        assert 0.2 < occ.mean() < 0.95


def test_subtree_keys_match_jax(soup):
    jcs, tcs = soup
    ro, rd = _rays(512, 14)
    ids, valid = jax.jit(jpack._subtree_nodes)(jcs.bvh.quad_blob)
    got_ids, got_valid = tbvh.subtree_nodes(tcs.bvh.nodes4)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(ids))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(valid))
    assert got_valid.any()
    keys = jax.jit(lambda o, d: jpack._subtree_keys2(jcs.bvh, JV3.from_array(o), JV3.from_array(d)))
    s1, s2 = keys(ro, rd)
    got1, got2 = tbvh.subtree_keys2(tcs.bvh.nodes4, _v3(ro), _v3(rd))
    np.testing.assert_array_equal(got1.numpy(), np.asarray(s1))
    np.testing.assert_array_equal(got2.numpy(), np.asarray(s2))
    assert (got1.numpy() < 16).mean() > 0.3 and (got2.numpy() < 16).any()


@pytest.fixture
def interpreted_pallas(monkeypatch):
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(jint, "USE_PALLAS", True)
    with pltpu.force_tpu_interpret_mode():
        yield


def test_multipass_matches_jax_and_single_pass(interpreted_pallas, monkeypatch):
    """The port's multipass (per-lane roots, no sort) against the JAX
    package's (per-block roots after its coherence sort), both exact up to
    ties on equal ``t`` thanks to the cleanup pass, and against the port's
    single pass (the plain skip-link walk)."""
    g = np.random.default_rng(5)
    n_tri, n = 128, 256
    v0 = g.uniform(-10, 10, (n_tri, 3)).astype(np.float32)
    v1 = v0 + g.uniform(-2, 2, (n_tri, 3)).astype(np.float32)
    v2 = v0 + g.uniform(-2, 2, (n_tri, 3)).astype(np.float32)
    arrs = jbvh.build_bvh(np.minimum(np.minimum(v0, v1), v2), np.maximum(np.maximum(v0, v1), v2),
                          leaf_size=2, use_native=False)
    jb = jbvh.to_device(arrs, v0, v1, v2)
    nrm = np.cross(v1 - v0, v2 - v0)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    tris = SimpleNamespace(**{k: _v3(a) for k, a in (("v0", v0), ("v1", v1), ("v2", v2))})
    cs = SimpleNamespace(bvh=tbvh.to_device(arrs, v0, v1, v2, nrm), triangles=tris)
    assert cs.bvh.depth4 == jb.quad_depth_token.shape[0] == 4
    ro, rd = _rays(n, 33)
    for k, v in (("TRAV_ROWS", 1), ("_SORT_MIN_ROWS", 2), ("_MP_MIN_DEPTH4", 1),
                 ("BVH_MULTIPASS", True)):
        monkeypatch.setattr(jpack, k, v)
    assert jpack._mp_ok(jb, n)
    bt_j, bi_j = jax.jit(lambda o, d: jpack._bvh_closest_multipass(
        jb, JV3.from_array(o), JV3.from_array(d), 1e-3, 1e6))(ro, rd)
    bt_j, bi_j = np.asarray(bt_j), np.asarray(bi_j)
    bound = torch.full((n,), 1e6)
    bt, bi = kbvh.multipass_closest(cs, _v3(ro), _v3(rd), 1e-3, bound)
    bt1, bi1 = tbvh.traverse_closest(cs.bvh, tris, _v3(ro), _v3(rd), 1e-3, 1e6)
    for t, i in ((bt_j, bi_j), (bt1.numpy(), bi1.numpy())):
        np.testing.assert_allclose(bt.numpy(), t, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(bi.numpy() < 0, i < 0)
        assert (bi.numpy() == i).mean() > 0.99
    assert 0.1 < (bi_j >= 0).mean() < 1.0
    # the two subtree passes found most winners before the cleanup pass
    table, valid = tbvh.subtree_nodes(cs.bvh.nodes4)
    assert int(valid.sum()) >= 8
    s1, _ = tbvh.subtree_keys2(cs.bvh.nodes4, _v3(ro), _v3(rd))
    en = valid[s1.clamp(0, 15).long()] & (s1 < 16)
    roots = torch.where(en, table[s1.clamp(0, 15).long()], 0)
    pass1, _ = tbvh.rooted(cs.bvh, tris, _v3(ro), _v3(rd), 1e-3, roots, en, bound,
                           torch.full((n,), -1, dtype=torch.int32))
    assert (pass1 == bt).float().mean() > 0.5


@pytest.fixture(scope="module")
def mesh_scene():
    b = pt.MeshSceneBuilder(grid=2, subdivisions=1)
    return b.build_scene(), b.create_camera(4.0 / 3.0)


@pytest.mark.parametrize("route", ["ordered", "skiplink", "quad", "multipass", "deep"])
@pytest.mark.parametrize("name,renderer,kw,cfg", [
    ("torch_mesh_path", "cuda_path_raytracer", dict(shadow_tmax="light"), (40, 30, 4, 6)),
    ("torch_mesh_whitted", "cuda_texture_raytracer", {}, (48, 36, 4, 4)),
])
def test_split_route_renders_mesh_goldens(mesh_scene, flags, monkeypatch, route, name, renderer,
                                          kw, cfg):
    scene, cam = mesh_scene
    if route == "deep":  # every compiled tree reports a BVH4 too deep for the walks
        to_device = tbvh.to_device
        monkeypatch.setattr(tbvh, "to_device", lambda *a, **k: to_device(*a, **k)._replace(
            depth4=kbvh.MAX_DEPTH4 + 1))
        route = "ordered"
    else:
        flags(**ROUTES[route])
    k5 = []
    monkeypatch.setattr(tpath, "path_bounce_bvh", lambda *a, **k: k5.append(1))
    r = pt.RendererFactory.create(renderer, seed=42, device="cpu",
                                  compile_overrides={"use_bvh": True}, **kw)
    assert kbvh.tri_route(r.compiled(scene)) == route
    img = np.asarray(r.render(scene, cam, pt.RenderSettings(*cfg)))
    golden = np.load(GOLDENS / f"{name}.npy")
    assert img.shape == golden.shape and not k5  # the plain bounce, not K5
    diff = np.abs(img.astype(np.int32) - golden.astype(np.int32))
    assert float((diff > 2).mean()) < 0.01, (float((diff > 2).mean()), int(diff.max()))
    assert img.mean() > 20
