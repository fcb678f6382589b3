"""The port's flat BVH (``ops/bvh.py``, ``native/``, the compiler's BVH
branch, the BVH branches of ``ops/intersect.py``) against the JAX package's.

Inputs are the ``MeshSceneBuilder(grid=2, subdivisions=1)`` mesh (320
triangles, over ``BVH_THRESHOLD``) built by each package, and rays made
with numpy from a seed.  The JAX side runs its XLA formulation on the CPU
(the skip-link walks of its ``ops/bvh.py``), under ``jax.jit``: eagerly,
JAX compiles each walk anew at every call.

* ``build_bvh`` arrays, both builders, and the ``pack_blobs`` /
  ``pack_blobs4`` records: exactly equal.
* ``compile_scene`` on the mesh: every table equal, the BVH's arrays and
  records too; ``compiled_scene_from_numpy`` carries the JAX BVH across.
* ``traverse_closest`` / ``traverse_any``: winning triangle on ≥ 99.99% of
  rays, ``t`` within 1e-4 (ties on exactly equal ``t`` may differ).
* ``scene_hit`` on the mesh, the same bars, attributes within 1e-4 where
  the winners agree; ``scene_hit_any`` on the mesh equal, ray for ray, to
  the port's brute-force sweep of the same scene compiled without a BVH
  (occlusion does not depend on visit order).

The kernels K4a/K4b/K5 run only on a GPU: ``tests/test_torch_cuda.py``
holds them against these plain versions there.
"""
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
from path_tracing__ray_tracer_tpu.scene_builders.mesh_scene_builder import MeshSceneBuilder
from path_tracing__ray_tracer_tpu_torch.compiler import compile_scene, compiled_scene_from_numpy
from path_tracing__ray_tracer_tpu_torch.ops import bvh as tbvh
from path_tracing__ray_tracer_tpu_torch.ops import intersect as tint
from path_tracing__ray_tracer_tpu_torch.ops.cuda import bvh as kbvh
from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3
from test_torch_compiler import _assert_tables_equal
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-4
AGREE = 0.9999


@pytest.fixture(scope="module")
def mesh():
    jcs = jp.compile_scene(MeshSceneBuilder(grid=2, subdivisions=1).build_scene())
    tcs = compile_scene(pt.MeshSceneBuilder(grid=2, subdivisions=1).build_scene(), device="cpu")
    return jcs, tcs


def _aabbs(cs):
    t = cs.triangles
    v0, v1, v2 = (np.stack([np.asarray(c) for c in v], -1)[: cs.n_triangles]
                  for v in (t.v0, t.v1, t.v2))
    return v0, v1, v2, np.minimum(np.minimum(v0, v1), v2), np.maximum(np.maximum(v0, v1), v2)


def _rays(n, seed):
    """Half from the mesh camera into the box, half from inside it."""
    g = np.random.default_rng(seed)
    ro = g.uniform(-14, 14, (n, 3)).astype(np.float32)
    rd = g.normal(size=(n, 3)).astype(np.float32)
    ro[: n // 2] = [0, 0, 50]
    rd[: n // 2] = np.stack([g.uniform(-0.45, 0.45, n // 2), g.uniform(-0.45, 0.45, n // 2),
                             -np.ones(n // 2)], -1)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


@pytest.mark.parametrize("native", [True, False])
def test_build_bvh_matches_jax(mesh, native):
    jcs, _ = mesh
    *_v, lo, hi = _aabbs(jcs)
    got = tbvh.build_bvh(lo, hi, use_native=native)
    want = jbvh.build_bvh(lo, hi, use_native=native)
    for k in ("lo", "hi", "skip", "is_leaf", "slots"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["is_leaf"].sum() > 16  # a real tree, several BVH4 levels


def test_native_unavailable_logs_and_builds_in_numpy(mesh, monkeypatch, caplog):
    from path_tracing__ray_tracer_tpu_torch import native

    def unavailable(*_a):
        raise native.NativeUnavailable("no compiler in this test")

    monkeypatch.setattr(native, "native_build_bvh", unavailable)
    jcs, _ = mesh
    *_v, lo, hi = _aabbs(jcs)
    with caplog.at_level("INFO", logger="ptrt"):
        got = tbvh.build_bvh(lo, hi)
    assert "bvh_native_declined" in caplog.text and "no compiler in this test" in caplog.text
    np.testing.assert_array_equal(got["slots"], jbvh.build_bvh(lo, hi, use_native=False)["slots"])


@pytest.mark.parametrize("packed", [True, False])
def test_pack_blobs_match_jax(mesh, packed):
    jcs, _ = mesh
    v0, v1, v2, lo, hi = _aabbs(jcs)
    arrs = jbvh.build_bvh(lo, hi, use_native=False)
    t = v0.shape[0]
    uid = (np.arange(t) % 5).astype(np.int32) if packed else None
    nrm = np.stack([np.asarray(c) for c in jcs.triangles.normal], -1)[:t]
    for got, want in zip(tbvh.pack_blobs(arrs, v0, v1, v2, nrm=nrm, uid=uid),
                         jpack.pack_blobs(arrs, v0, v1, v2, nrm=nrm, uid=uid)):
        np.testing.assert_array_equal(got, want)
    got4, want4 = tbvh.pack_blobs4(arrs), jpack.pack_blobs4(arrs)
    np.testing.assert_array_equal(got4[0], want4[0])
    assert got4[1] == want4[1] > 1


def test_compile_scene_on_mesh_matches_jax(mesh):
    jcs, tcs = mesh
    assert tcs.n_triangles == 320 and tcs.bvh is not None and jcs.bvh is not None
    _assert_tables_equal(tcs._replace(bvh=None), jcs._replace(bvh=None))
    jb, tb = jcs.bvh, tcs.bvh
    for k in ("lo", "hi", "skip", "is_leaf", "slots"):
        np.testing.assert_array_equal(getattr(tb, k).numpy(), np.asarray(getattr(jb, k)), err_msg=k)
    np.testing.assert_array_equal(tb.nodes4.numpy(), np.asarray(jb.quad_blob)[0])
    np.testing.assert_array_equal(tb.slot_rec.numpy(), np.asarray(jb.slot_blob)[0])
    assert tb.depth4 == jb.quad_depth_token.shape[0] and tb.uid_packed == (jb.uid_token is not None)
    assert tb.uid_packed  # the mesh's handful of materials compress
    carried = compiled_scene_from_numpy(jax.tree.map(np.asarray, jcs), device="cpu")
    for k in ("lo", "hi", "skip", "is_leaf", "slots", "nodes4", "slot_rec", "slot16", "ps_blob"):
        assert getattr(carried.bvh, k).equal(getattr(tb, k)), k
    assert (carried.bvh.depth4, carried.bvh.uid_packed) == (tb.depth4, tb.uid_packed)


@pytest.mark.parametrize("walk", ["closest", "any"])
def test_traverse_matches_jax(mesh, walk):
    jcs, tcs = mesh
    ro, rd = _rays(1024, 3)
    tro, trd = (V3.from_array(torch.from_numpy(a)) for a in (ro, rd))
    counts = {}
    if walk == "closest":
        gt, gi = tbvh.traverse_closest(tcs.bvh, tcs.triangles, tro, trd, 1e-3, 1e6, tri_offset=7,
                                       counts=counts)
        wt, wi = jax.jit(lambda o, d: jbvh.traverse_closest(
            jcs.bvh, jcs.triangles, JV3.from_array(o), JV3.from_array(d), 1e-3, 1e6,
            tri_offset=7))(ro, rd)
        same = gi.numpy() == np.asarray(wi)
        assert same.mean() >= AGREE and (gi >= 0).float().mean() > 0.02
        np.testing.assert_allclose(gt.numpy()[same], np.asarray(wt)[same], rtol=TOL, atol=TOL)
    else:
        limit = np.random.default_rng(4).uniform(-1.0, 30.0, 1024).astype(np.float32)
        got = tbvh.traverse_any(tcs.bvh, tcs.triangles, tro, trd, 1e-3, torch.from_numpy(limit),
                                counts=counts)
        want = np.asarray(jax.jit(lambda o, d, lim: jbvh.traverse_any(
            jcs.bvh, jcs.triangles, JV3.from_array(o), JV3.from_array(d), 1e-3, lim))(
            ro, rd, limit))
        assert (got.numpy() == want).mean() >= AGREE and 0.01 < want.mean() < 0.95
        assert not got.numpy()[limit <= 0].any()  # the plain walk: no bound, no hit
    assert counts["boxes"] > 1024 and counts["tri_tests"] > 0


def test_scene_hit_on_mesh_matches_jax(mesh):
    jcs, tcs = mesh
    ro, rd = _rays(1024, 5)
    tro, trd = (V3.from_array(torch.from_numpy(a)) for a in (ro, rd))
    got = tint.scene_hit(tcs, tro, trd, 1e-3, 1e6)
    want = jax.jit(lambda o, d: jint.scene_hit(jcs, JV3.from_array(o), JV3.from_array(d),
                                               1e-3, 1e6))(ro, rd)
    same = got.prim.numpy() == np.asarray(want.prim)
    hit = same & np.asarray(want.hit)
    assert same.mean() >= AGREE and hit.mean() > 0.5
    for f in ("t", "point", "normal", "u", "v"):
        a, b = getattr(got, f), getattr(want, f)
        a = torch.stack(tuple(a), -1).numpy() if isinstance(a, tuple) else a.numpy()
        b = np.asarray(b.to_array()) if isinstance(b, tuple) else np.asarray(b)
        np.testing.assert_allclose(a[hit], b[hit], rtol=TOL, atol=TOL, err_msg=f)
    # triangle winners have UVs 0: no textured triangle reads them
    tri = got.prim.numpy() >= tcs.n_planes + tcs.n_spheres + tcs.n_quads
    assert tri.any() and (got.u.numpy()[tri] == 0).all()
    so = got.point + got.normal * 1e-3
    ld = (V3.of(0.0, 14.0, 0.0) - so).normalized()
    limit = torch.where(got.hit, (V3.of(0.0, 14.0, 0.0) - so).norm(), -1.0)
    occ = tint.scene_hit_any(tcs, so, ld, 1e-3, limit)
    brute = compile_scene(pt.MeshSceneBuilder(grid=2, subdivisions=1).build_scene(),
                          device="cpu", use_bvh=False)
    assert brute.bvh is None
    assert torch.equal(occ, tint.scene_hit_any(brute, so, ld, 1e-3, limit))
    assert 0.02 < float(occ[got.hit].float().mean()) < 0.98
    assert kbvh.scene_closest.launches == kbvh.scene_any.launches == 0  # CPU: plain versions


def test_root_leaf_tree_and_forced_bvh():
    """``use_bvh=True`` on a scene of fewer triangles than one leaf: the
    BVH4 record is one node whose only child is the root leaf, and the hits
    equal the brute-force sweep's."""
    V, M = pt.Vec3, pt.Material
    scene = pt.Scene()
    g = np.random.default_rng(8)
    for _ in range(9):
        a = g.uniform(-3, 3, 3)
        scene.add_object(pt.Triangle(V(*a), V(*(a + g.uniform(-1, 1, 3))),
                                     V(*(a + g.uniform(-1, 1, 3))), material=M(V(1, 1, 1))))
    bvh_cs = compile_scene(scene, device="cpu", use_bvh=True)
    flat_cs = compile_scene(scene, device="cpu")
    assert flat_cs.bvh is None and bvh_cs.bvh.depth4 == 1
    rec = bvh_cs.bvh.nodes4.numpy()
    assert rec.shape == (32,) and rec[24] == 0.0 and (rec[25:28] == -1.0).all()
    np.testing.assert_array_equal(rec[0:6], torch.cat([bvh_cs.bvh.lo[0], bvh_cs.bvh.hi[0]]).numpy())
    ro, rd = _rays(512, 9)
    tro, trd = V3.from_array(torch.from_numpy(ro * 0.2)), V3.from_array(torch.from_numpy(rd))
    got = tint.scene_hit(bvh_cs, tro, trd, 1e-3, 1e6)
    want = tint.scene_hit(flat_cs, tro, trd, 1e-3, 1e6)
    assert torch.equal(got.prim, want.prim) and got.hit.any()
    assert torch.equal(got.t, want.t)
