"""The host side of the persistent ordered BVH2 occlusion walk (K4e) and of
the persistent leaf-table walks (K10b, K10c, K10d) on the CPU.

* The 16-byte loads of K10b-d's leaf visit (``csrc/bvh_walk.cuh``
  ``MatQuadLeaf``): each of a batch's 19 loads lies on a 16-byte boundary
  of the ``(16, 128·G)`` table and holds one coefficient of four
  consecutive slots, on ``tests/test_mxu_leaf.py``'s 53-triangle set and
  the mesh of ``tests/test_torch_mxu_leaf.py`` (whose gids carry material
  ids; the port's table 16-byte aligned).
* The linear forms ``ops/bvh._forms`` evaluated from those loads, in the
  kernel's coefficient order, equal those from the table bit for bit on
  seeded rays.
* The occlusion visit ``MatQuadLeaf::any`` emulated from those loads, in
  its expression order, gives the plain table walk's verdict
  (``ops/bvh._leaf_any_mat``) slot for slot, bit for bit, with finite,
  infinite and non-positive limits; with an infinite limit also
  Möller–Trumbore's (``ops/bvh._leaf_test``, and ``traverse_any`` on the
  mesh).
* The closest visit ``MatQuadLeaf::closest`` (K10a, K10c) emulated from
  those loads, a batch's inside tests first, then its inside slots in order
  against the running best, the winner's gid and normal read last, gives the plain table leaf's
  (``ops/bvh._forms`` and ``_leaf_closest_mat``, the first least t) t, gid,
  u, v and normal bit for bit on config 5's leaves, with bounds 1e6, 1e30
  and ``+inf``.
* ``ops/cuda/bvh2.ordered_plan`` (both ordered walks),
  ``ops/cuda/bvh_leafmat.tri_plan`` (K10c and K10d) and ``scene_any_plan``
  (K10b) are the depth classes of the tree's BVH2 and BVH4 depths, nothing
  staged; K10b's shared memory is the plane/sphere/quad blob's bytes.
* The wrappers take their plain versions on CPU tensors and count no
  launch.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import path_tracing__ray_tracer_tpu_torch as pt
from path_tracing__ray_tracer_tpu_torch.ops import bvh as tbvh
from path_tracing__ray_tracer_tpu_torch.ops.cuda import bvh, bvh2, bvh_leafmat, bvh_paged
from path_tracing__ray_tracer_tpu_torch.ops.intersect import (ClosestRecord,
                                                          scene_hit_any_bvh_plain)
from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3
from test_torch_mxu_leaf import _tri53
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

# MatQuadLeaf's 19 loads of a batch, (quantity, feature row) in its
# coefficient order: det's rows 0-2, u·det's and v·det's 0-5, t·det's 6-9;
# and where each quantity's coefficients start in that order
LOADS = ([(0, r) for r in range(3)] + [(1, r) for r in range(6)] + [(2, r) for r in range(6)]
         + [(3, r) for r in range(6, 10)])
FIRST, LOW = {0: 0, 1: 3, 2: 9, 3: 15}, {0: 0, 1: 0, 2: 0, 3: 6}


@pytest.fixture(scope="module")
def mesh():
    return pt.compile_scene(pt.MeshSceneBuilder(grid=2, subdivisions=1).build_scene(),
                            device="cpu", use_bvh=True)


def _table(case, mesh):
    if case == "tri53":
        arrs, v0, v1, v2 = _tri53()
        return torch.from_numpy(tbvh.pack_leaf_mat(arrs, v0, v1, v2))
    assert mesh.bvh.uid_packed and mesh.bvh.paged is None
    assert mesh.bvh.leaf_mat.data_ptr() % 16 == 0 and mesh.bvh.nodes4.data_ptr() % 16 == 0
    return mesh.bvh.leaf_mat


def _batch(mat, g, k):
    """The 19 loads of leaf ``g``'s slots ``k .. k+3``: ``(19, 4)``, each the
    16 bytes at float ``row·stride + 128g + 16q + k`` of the table."""
    offs = [r * mat.shape[1] + 128 * g + 16 * q + k for q, r in LOADS]
    assert all(o % 4 == 0 for o in offs)  # 16-byte aligned in an aligned table
    return mat.reshape(-1).view(-1, 4)[[o // 4 for o in offs]]


def _coefficients(mat):
    """Each slot's 19 coefficients as the kernel's loads give them:
    ``(16·G, 19)``, slot ``16g + k + j`` from component ``j`` of batch k."""
    n_leaves = mat.shape[1] // 128
    return torch.stack([_batch(mat, g, k)[:, j] for g in range(n_leaves)
                        for k in range(0, 16, 4) for j in range(4)])


@pytest.mark.parametrize("case", ["tri53", "mesh"])
def test_table_loads_hold_four_slots_each(mesh, case):
    mat = _table(case, mesh)
    assert mat.dtype == torch.float32 and mat.is_contiguous() and mat.shape[1] % 128 == 0
    coef = _coefficients(mat)
    slot = torch.arange(coef.shape[0])
    col = slot // 16 * 128 + slot % 16  # slot k of leaf g: column 128g + k of quantity 0
    for x, (q, r) in enumerate(LOADS):
        assert torch.equal(coef[:, x], mat[r, col + 16 * q]), (q, r)
    assert bool((coef != 0).any(1).any()) and not bool((coef != 0).all())  # padding slots zero


@pytest.mark.parametrize("case", ["tri53", "mesh"])
def test_forms_from_the_table_loads_equal_the_table(mesh, case):
    mat = _table(case, mesh)
    coef = _coefficients(mat)
    g = np.random.default_rng(5)
    n = 64
    ro = V3(*(torch.from_numpy(g.uniform(-9, 9, n).astype(np.float32)) for _ in range(3)))
    rd = V3(*(torch.from_numpy(g.normal(size=n).astype(np.float32)) for _ in range(3)))
    feat = tbvh.leaf_features(ro, rd)[:, None, :]  # (10, 1, rays)
    slot = torch.arange(coef.shape[0])
    col = slot // 16 * 128 + slot % 16
    from_table = tbvh._forms(lambda r, q: mat[r, col + 16 * q][:, None], feat)
    from_loads = tbvh._forms(lambda r, q: coef[:, FIRST[q] + r - LOW[q]][:, None], feat)
    for a, b in zip(from_table, from_loads):
        assert a.shape == (coef.shape[0], n)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert bool((from_table[0] != 0).any())


def _any_rays(case, mesh, n, seed):
    """Rays from a box around the triangles, aimed at seeded points of them
    (most hit a triangle) or anywhere (every fourth), and their features."""
    if case == "tri53":
        _arrs, v0, v1, v2 = _tri53()
        v0, v1, v2 = (torch.from_numpy(v) for v in (v0, v1, v2))
    else:
        v0, v1, v2 = (torch.stack(tuple(v), -1) for v in (mesh.triangles.v0, mesh.triangles.v1,
                                                          mesh.triangles.v2))
    g = np.random.default_rng(seed)
    lo, hi = float(v0.min()) - 2, float(v0.max()) + 2
    o = torch.from_numpy(g.uniform(lo, hi, (n, 3)).astype(np.float32))
    tri = torch.from_numpy(g.integers(0, v0.shape[0], n))
    a, b = (torch.from_numpy(g.uniform(0, 0.5, n).astype(np.float32))[:, None] for _ in range(2))
    aim = v0[tri] + a * (v1[tri] - v0[tri]) + b * (v2[tri] - v0[tri])
    d = torch.where(torch.arange(n)[:, None] % 4 == 3,
                    torch.from_numpy(g.normal(size=(n, 3)).astype(np.float32)), aim - o)
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    ro, rd = V3(*o.T.contiguous()), V3(*d.T.contiguous())
    return ro, rd, tbvh.leaf_features(ro, rd)


def _limits(kind, n, seed):
    g = np.random.default_rng(seed)
    if kind == "finite":
        return torch.from_numpy(g.uniform(0.5, 30, n).astype(np.float32))
    if kind == "inf":
        return torch.full((n,), float("inf"))
    return torch.where(torch.arange(n) % 2 == 0, 0.0, -torch.from_numpy(
        g.uniform(0, 5, n).astype(np.float32)))


def _quad_any(coef, feat, t_min, limit):
    """``MatQuadLeaf::any``'s test of each slot (rows of ``coef``, its 19
    coefficients in the kernel's load order) against each ray (columns of
    ``feat``), in the kernel's expression order: ``(slots, rays)``."""
    def form(at, r0, r1):
        acc = coef[:, at, None] * feat[r0]
        for r in range(r0 + 1, r1):
            acc = acc + coef[:, at + r - r0, None] * feat[r]
        return acc

    det, un, vn = form(0, 0, 3), form(3, 0, 6), form(9, 0, 6)
    s2 = det * det
    ud, vd = un * det, vn * det
    inside = (torch.abs(det) > 1e-6) & (ud >= 0.0) & (ud <= s2) & (vd >= 0.0) & (ud + vd <= s2)
    td = form(15, 6, 10) * det
    return inside & (td > t_min * s2) & (td < limit * s2)


@pytest.mark.parametrize("limit_kind", ["finite", "inf", "nonpositive"])
@pytest.mark.parametrize("case", ["tri53", "mesh"])
def test_occlusion_visit_from_the_table_loads_is_the_plain_test(mesh, case, limit_kind):
    mat = _table(case, mesh)
    coef = _coefficients(mat)
    n = 96
    ro, rd, feat = _any_rays(case, mesh, n, 11)
    limit = _limits(limit_kind, n, 12)
    slot = torch.arange(coef.shape[0])
    col = slot // 16 * 128 + slot % 16
    got = _quad_any(coef, feat, 1e-3, limit)
    want = tbvh._leaf_any_mat(*tbvh._forms(lambda r, q: mat[r, col + 16 * q][:, None], feat),
                              1e-3, limit)
    assert got.shape == (coef.shape[0], n) and torch.equal(got, want)
    padding = (coef == 0).all(1)
    assert bool(padding.any()) and not bool(got[padding].any())
    if limit_kind == "nonpositive":
        assert not bool(got.any())
        return
    leaf_hit = got.view(-1, 16, n).any(1)  # the visit's verdict: its first hit in slot order
    assert 0 < int(leaf_hit.sum()) < leaf_hit.numel()
    if limit_kind != "inf":
        return
    # the port's semantics of an infinite limit: any slot hit beyond t_min
    # occludes, as Möller–Trumbore with an infinite bound says
    if case == "tri53":
        arrs, v0, v1, v2 = _tri53()
        tri = torch.from_numpy(arrs["slots"][arrs["is_leaf"]].reshape(-1)).long()
        v0, v1, v2 = (torch.from_numpy(v) for v in (v0, v1, v2))
    else:
        tri = mesh.bvh.slots[mesh.bvh.is_leaf].reshape(-1).long()
        v0, v1, v2 = (torch.stack(tuple(v), -1) for v in (mesh.triangles.v0,
                                                          mesh.triangles.v1, mesh.triangles.v2))
    real = tri >= 0
    t = tri[real]
    _t, mt = tbvh._leaf_test(v0[t][:, None], (v1 - v0)[t][:, None], (v2 - v0)[t][:, None],
                             torch.stack(tuple(ro), -1)[None], torch.stack(tuple(rd), -1)[None],
                             1e-3, limit[None])
    assert torch.equal(got[real], mt) and bool(mt.any())
    if case == "mesh":
        walk = tbvh.traverse_any(mesh.bvh, mesh.triangles, ro, rd, 1e-3, limit, leaf_mat=mat)
        assert torch.equal(walk, tbvh.traverse_any(mesh.bvh, mesh.triangles, ro, rd, 1e-3, limit))
        assert bool(walk.any()) and not bool(walk.all())


@pytest.fixture(scope="module")
def config5():
    """Config 5 and its table's coefficients as the kernel's loads give them."""
    cs = pt.compile_scene(pt.MeshSceneBuilder(grid=3, subdivisions=3).build_scene(),
                          device="cpu", use_bvh=True)
    return cs, _coefficients(_table("mesh", cs))


def _quad_closest(coef, feat, t_min, bound, mat):
    """``MatQuadLeaf::closest`` of every leaf (``coef``'s rows, 16 slots a
    leaf, each slot's 19 coefficients in the kernel's load order) against
    every ray (columns of ``feat``), in its expression order: a batch's four
    inside tests from its 15 det, u·det and v·det loads, then its inside
    slots (the only ones whose t·det loads it issues) in order, strict ``<``
    against the running best (seeded with ``bound``), ``t = t·det / det``
    and ``u``, ``v`` one division each; then the winner's gid and normal
    read from the table's row 9.  ``(t, gid, u, v, nx, ny, nz)``, each
    ``(leaves, rays)``."""
    n_leaves = coef.shape[0] // 16
    c = coef.view(n_leaves, 16, 19)
    shape = (n_leaves, feat.shape[1])
    best = torch.full(shape, float(bound))
    u, v = torch.zeros(shape), torch.zeros(shape)
    won = torch.full(shape, -1)

    def form(ck, at, r0, r1):
        acc = ck[:, at, None] * feat[r0]
        for r in range(r0 + 1, r1):
            acc = acc + ck[:, at + r - r0, None] * feat[r]
        return acc

    for batch in range(0, 16, 4):
        tests = []
        for k in range(batch, batch + 4):
            ck = c[:, k]
            det, un, vn = form(ck, 0, 0, 3), form(ck, 3, 0, 6), form(ck, 9, 0, 6)
            s2 = det * det
            ud, vd = un * det, vn * det
            tests.append((k, ck, det, un, vn, (torch.abs(det) > 1e-6) & (ud >= 0.0)
                          & (ud <= s2) & (vd >= 0.0) & (ud + vd <= s2)))
        for k, ck, det, un, vn, inside in tests:
            t = form(ck, 15, 6, 10) / det
            win = inside & (t > t_min) & (t < best)
            best = torch.where(win, t, best)
            u, v = torch.where(win, un / det, u), torch.where(win, vn / det, v)
            won = torch.where(win, k, won)
    col = 128 * torch.arange(n_leaves)[:, None] + won.clamp(min=0)  # row 9's columns
    read = [torch.where(won >= 0, mat[9][col + 16 * q], miss)
            for q, miss in ((7, -1.0), (4, 0.0), (5, 0.0), (6, 0.0))]
    return (best, read[0], u, v, *read[1:])


def _forms_closest(cs, mat, feat, t_min, bound):
    """The plain table leaf (``ops/bvh._walk`` with the table): every slot's
    forms by ``_forms``, ``_leaf_closest_mat`` below ``bound`` on the leaves'
    real slots, the first least t wins; its ``u·det / det``, ``v·det / det``
    and the table's gid and normal; ``bound``, −1 and zeros where none hits."""
    slot = torch.arange(mat.shape[1] // 8)
    col = slot // 16 * 128 + slot % 16
    det, un, vn, tn = tbvh._forms(lambda r, q: mat[r, col + 16 * q][:, None], feat)
    t, hit = tbvh._leaf_closest_mat(det, un, vn, tn, t_min, bound)
    real = (cs.bvh.slots[cs.bvh.is_leaf].reshape(-1) >= 0)[:, None]
    n_leaves = slot.numel() // 16
    t = torch.where(hit & real, t, torch.inf).view(n_leaves, 16, -1)
    k = torch.argmin(t, dim=1, keepdim=True)
    take = torch.isfinite(torch.gather(t, 1, k))[:, 0]
    rays = feat.shape[1]
    fields = (t, un / det, vn / det, *(mat[9, col + 16 * q][:, None].expand(-1, rays)
                                       for q in (7, 4, 5, 6)))
    t_, u, v, gid, nx, ny, nz = (torch.gather(x.reshape(n_leaves, 16, rays), 1, k)[:, 0]
                                 for x in fields)
    return tuple(torch.where(take, x, miss) for x, miss in (
        (t_, float(bound)), (gid, -1.0), (u, 0.0), (v, 0.0), (nx, 0.0), (ny, 0.0), (nz, 0.0)))


@pytest.mark.parametrize("bound", [1e6, 1e30, float("inf")])
def test_closest_visit_from_the_table_loads_is_the_plain_leaf(config5, bound):
    cs, coef = config5
    mat = cs.bvh.leaf_mat
    _ro, _rd, feat = _any_rays("mesh", cs, 48, 13)
    got = _quad_closest(coef, feat, 1e-3, bound, mat)
    want = _forms_closest(cs, mat, feat, 1e-3, bound)
    for name, a, w in zip(("t", "gid", "u", "v", "nx", "ny", "nz"), got, want):
        assert torch.equal(a.view(torch.int32), w.view(torch.int32)), name
    won = got[1] >= 0
    assert 0 < int(won.sum()) < won.numel() and int(won.any(0).sum()) >= 32  # most rays hit


# config 5's BVH2 is 13 deep and its BVH4 6; the chain of tests/torch_chain.py
# 190, the most the ordered walks take
@pytest.mark.parametrize("depth2,depth4,want2,want4", [
    (1, 1, 32, 8), (13, 6, 32, 8), (30, 8, 32, 8), (31, 9, 192, 32), (190, 32, 192, 32),
])
def test_ordered_and_leafmat_plans_are_the_depth_classes(depth2, depth4, want2, want4):
    cs = SimpleNamespace(bvh=SimpleNamespace(depth2=depth2, depth4=depth4))
    assert tuple(bvh2.ordered_plan(cs)) == (False, want2, 0) and want2 >= depth2 + 2
    assert tuple(bvh_leafmat.tri_plan(cs)) == (False, want4, 0)
    assert want4 == bvh.depth_class(depth4) == bvh.rooted_plan(cs).depth_class


# config 5's blob: no plane, sphere or quad; the Cornell box's 6 quads (108
# floats); a blob past 48 KB, which the occupancy entry allows
@pytest.mark.parametrize("depth4,want4", [(1, 8), (6, 8), (9, 32), (32, 32)])
@pytest.mark.parametrize("blob_floats", [0, 108, 14_000])
def test_scene_any_plan_is_the_depth_class_and_the_blob(depth4, want4, blob_floats):
    cs = SimpleNamespace(bvh=SimpleNamespace(depth4=depth4, ps_blob=torch.zeros(blob_floats)))
    plan = bvh_leafmat.scene_any_plan(cs)
    assert tuple(plan) == (False, want4, 4 * blob_floats)
    assert plan.depth_class == bvh_leafmat.tri_plan(cs).depth_class == bvh.depth_class(depth4)
    # K4b's plan on the same tree, with no tree staged, is the same variant
    assert bvh.walk_plan(521, depth4, 4 * blob_floats, 1 << 30) == plan


def test_any_ordered_and_tri_closest_take_the_plain_versions_on_the_cpu(mesh):
    cs = mesh
    g = torch.Generator().manual_seed(9)
    n = 48
    o = V3(*(torch.rand(n, generator=g) * 8 - 4 for _ in range(3)))
    d = V3(*(torch.randn(n, generator=g) for _ in range(3))).normalized()
    limit = torch.where(torch.arange(n) % 5 == 0, -1.0, torch.rand(n, generator=g) * 20)
    zero = torch.zeros(n)
    seed = ClosestRecord(torch.rand(n, generator=g) * 20, torch.full((n,), -1, dtype=torch.int32),
                         zero, zero, V3(zero, zero, zero))
    before = (bvh2.any_ordered.launches, bvh_leafmat.tri_closest.launches)
    occ = bvh2.any_ordered(cs, o, d, 1e-3, limit)
    assert torch.equal(occ, tbvh.traverse_any(cs.bvh, cs.triangles, o, d, 1e-3, limit))
    assert bool(occ.any()) and not bool(occ.all())
    got = bvh_leafmat.tri_closest(cs, o, d, 1e-3, seed)
    want = bvh_paged.pages_closest_plain(cs, o, d, 1e-3, seed, mxu=True)
    for a, b in zip((got.t, got.prim, got.u, got.v, *got.normal),
                    (want.t, want.prim, want.u, want.v, *want.normal)):
        assert torch.equal(a, b)
    assert bool((got.prim >= 0).any())
    assert before == (bvh2.any_ordered.launches, bvh_leafmat.tri_closest.launches)


@pytest.mark.parametrize("found_every", [0, 3])
def test_leafmat_occlusion_takes_the_plain_versions_on_the_cpu(mesh, found_every):
    """``scene_any`` (K10b) and ``tri_any`` (K10d) on CPU tensors: their
    plain versions with the table, finite, infinite and non-positive
    limits, found lanes carried; no launch counted."""
    cs = mesh
    n = 64
    ro, rd, _feat = _any_rays("mesh", mesh, n, 21)
    lane = torch.arange(n)
    limit = torch.where(lane % 10 == 1, float("inf"), torch.where(
        lane % 10 == 2, -1.0, torch.where(lane % 10 == 7, 0.0, _limits("finite", n, 22))))
    found = (lane % found_every == 0) if found_every else torch.zeros(n, dtype=torch.bool)
    before = (bvh_leafmat.scene_any.launches, bvh_leafmat.tri_any.launches)
    occ_b = bvh_leafmat.scene_any(cs, ro, rd, 1e-3, limit)
    occ_d = bvh_leafmat.tri_any(cs, ro, rd, 1e-3, limit, found)
    assert before == (bvh_leafmat.scene_any.launches, bvh_leafmat.tri_any.launches)
    assert torch.equal(occ_b, scene_hit_any_bvh_plain(cs, ro, rd, 1e-3, limit, mxu=True))
    want_d = bvh_paged.pages_any_plain(cs, ro, rd, 1e-3, limit, found, mxu=True)
    assert torch.equal(occ_d, want_d) and bool(occ_d[found].all())
    walked = tbvh.traverse_any(cs.bvh, cs.triangles, ro, rd, 1e-3, limit, leaf_mat=cs.bvh.leaf_mat)
    assert torch.equal(occ_d, found | walked)
    assert not bool(occ_d[(limit <= 0) & ~found].any())
    assert bool(occ_d[~found].any()) and not bool(occ_d[~found].all())
