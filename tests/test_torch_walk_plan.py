"""The host side of the persistent BVH walks (K4b, K5, K6c/K6d, K4c/K4d,
K11 and K4e's ordered and skip-link closest walks) on the CPU.

* ``ops/bvh.pack_slot16``: the padded copy of the slot records that the
  persistent walks read as 16-byte loads equals the 13-float records field
  for field, with zero padding, 16-byte aligned.
* ``ops/cuda/bvh.walk_plan`` and ``persistent_grid``: the variant (tree
  staged in shared memory or not, depth class) and the grid are pure
  functions of sizes, the budget, the card's shared memory and the SM
  count; ``page_plan``, the page walks' variant (K6c/K6d, K4c/K4d), takes
  the same depth class and never stages a tree, whatever the budget.
* ``ops/cuda/bvh_paged.top_plan``, the top walks' variant (K6a/K6b): the
  primitive records always in shared memory, the top tree's node records and
  13-float slots staged after them whenever they fit the card's shared
  memory, the stack's class from the top tree's depth; a pure function of
  those sizes.
* ``ops/cuda/bvh.rooted_plan`` (K11: the depth class of the whole BVH4)
  and ``depth2_class`` with ``ops/cuda/bvh2.ordered_plan`` (the ordered
  BVH2 closest walk: a stack class that holds ``depth2 + 2``) are pure
  functions of the tree's depths.
* The persistent skip-link closest walk's visit, emulated from the loads
  it issues (each BVH2 node as two 16-byte rows of ``tree2``, the leaves
  four slots at a time from ``slot16``, three rows a slot, the slots tested
  in order against the running best), gives ``ops/bvh.traverse_closest``'s
  ``t`` and triangle on every lane: on a mesh and on the 190-deep chain of
  ``tests/torch_chain.py``, with a scalar and a per-ray bound.  The
  persistent skip-link occlusion walk's visit, emulated the same way (a
  lane done at its first hit below its limit; a limit ≤ 0 loads nothing
  and reports occluded), gives ``ops/bvh.traverse_any``'s verdict on every
  lane that needs one, with finite, ``+inf`` and ≤ 0 limits; its launch
  (``bvh2.SKIPLINK_PLAN``) has no stack whatever the tree's depth.
* K11, the ordered closest walk and the two skip-link walks take their
  plain versions on the CPU, as every wrapper does, and count no launch.
* The persistent K4a's leaf visit (``Slot16Leaf`` with attributes),
  emulated from the loads it issues (four slots a batch, three 16-byte rows
  of ``slot16`` a slot, the slots tested in order against the running best,
  the fourth row's word read on a win), gives the plain Möller–Trumbore
  leaf's t, gid, u, v and normal bit for bit on config 5's leaves, with
  bounds 1e6, 1e30 and ``+inf``; ``ops/cuda/bvh.closest_plan`` (K4a, and
  K10a/K10b through ``bvh_leafmat.scene_any_plan``) is the depth class and
  the plane/sphere/quad blob, never a staged tree, whatever the budget.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""
from types import SimpleNamespace

import pytest
import torch

import path_tracing__ray_tracer_tpu_torch as pt
from path_tracing__ray_tracer_tpu_torch.ops import bvh as tbvh
from path_tracing__ray_tracer_tpu_torch.ops.cuda import bvh, bvh2, bvh_leafmat, bvh_paged
from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3
from torch_chain import chain_rays, chain_scene
from torch_threads import one_torch_thread  # noqa: F401

# config 5 (MeshSceneBuilder(3, 3)): 521 BVH4 nodes, depth 6, a 92-float
# plane/sphere/quad blob; the H100's and a 99 KB card's dynamic shared
# memory a block (opt-in, less the walks' 64 B of static)
C5_NODES, C5_DEPTH, C5_PS = 521, 6, 4 * 92
TREE = 128 * C5_NODES
H100, SMALL = 232_448 - 64, 101_376 - 64


@pytest.fixture(scope="module")
def mesh():
    b = pt.MeshSceneBuilder(grid=2, subdivisions=1)
    return pt.compile_scene(b.build_scene(), device="cpu", use_bvh=True)


def test_slot16_is_the_slot_records_padded(mesh):
    b = mesh.bvh
    rec, pad = b.slot_rec.view(-1, 13), b.slot16.view(-1, 16)
    assert pad.shape[0] == rec.shape[0] > 0 and b.slot16.is_contiguous()
    for name, cols in (("v0", slice(0, 3)), ("e1", slice(3, 6)), ("e2", slice(6, 9)),
                       ("gid", slice(9, 10)), ("normal", slice(10, 13))):
        assert torch.equal(pad[:, cols], rec[:, cols]), name
    assert not pad[:, 13:].any()
    assert bool((pad[:, 9] < 0).any())  # the leaves' -1 padding slots carried over
    assert b.slot16.data_ptr() % 16 == 0 and b.nodes4.data_ptr() % 16 == 0


@pytest.mark.parametrize("budget,n_nodes,depth4,limit,want", [
    (None, C5_NODES, C5_DEPTH, H100, (False, 8, C5_PS)),  # the default: nothing staged
    (TREE, C5_NODES, C5_DEPTH, H100, (True, 8, TREE + C5_PS)),
    (TREE - 1, C5_NODES, C5_DEPTH, H100, (False, 8, C5_PS)),  # one byte over the budget
    (TREE, C5_NODES, 9, H100, (True, 32, TREE + C5_PS)),  # the deep class
    (TREE, C5_NODES, 20, SMALL, (True, 32, TREE + C5_PS)),
    # under a lifted budget, but past what a block may hold
    (1 << 30, 1815, 8, H100, (False, 8, C5_PS)),
    (1 << 30, 1700, 8, H100, (True, 8, 128 * 1700 + C5_PS)),
    (1 << 30, 1700, 8, SMALL, (False, 8, C5_PS)),
    # a config-6 page (~6,250 nodes, 800 KB) under a lifted budget; the
    # deepest tree the BVH4 walks take
    (1 << 30, 6250, 7, H100, (False, 8, C5_PS)),
    (1 << 30, 100, 32, H100, (True, 32, 128 * 100 + C5_PS)),
])
def test_walk_plan_is_a_function_of_sizes(monkeypatch, budget, n_nodes, depth4, limit, want):
    if budget is not None:
        monkeypatch.setattr(bvh, "SMEM_TREE_BYTES", budget)
    plan = bvh.walk_plan(n_nodes, depth4, C5_PS, limit)
    assert tuple(plan) == want
    assert plan == bvh.walk_plan(n_nodes, depth4, C5_PS, limit)
    assert plan.smem_bytes <= limit
    # the page walks' plan at the same sizes: the same depth class, no page staged
    assert tuple(bvh.page_plan(depth4)) == (False, want[1], 0)


# config 6 (MeshSceneBuilder(5, 4)): 5 planes, 1 sphere, 1 quad, whose
# 16-byte records take 104 floats; its top tree 7 BVH4 nodes, depth 3, over
# one leaf of 16 top slots of 13 floats; the 48-page scene of
# tests/test_torch_paged.py 21 nodes over 192 slots
C6_PSQ, C6_REC = (5, 1, 1), 4 * 104
C6_TOP, P48_TOP = 4 * (32 * 7 + 13 * 16), 4 * (32 * 21 + 13 * 192)
BIG_TOP = 4 * (32 * 64 + 13 * 3200)  # 64 nodes over 3,200 slots: 174,592 B


@pytest.mark.parametrize("n_top,n_slots,depth,limit,want", [
    (7, 16, 3, H100, (True, 8, C6_REC + C6_TOP)),  # config 6's tables staged
    (21, 192, 3, H100, (True, 8, C6_REC + P48_TOP)),  # and the 48-page scene's
    (7, 16, 9, SMALL, (True, 32, C6_REC + C6_TOP)),  # the deep class
    (7, 16, 3, C6_REC + C6_TOP, (True, 8, C6_REC + C6_TOP)),  # just fit
    (7, 16, 3, C6_REC + C6_TOP - 1, (False, 8, C6_REC)),  # one byte short: device memory
    (7, 16, 3, C6_REC, (False, 8, C6_REC)),  # room for the primitive records alone
    (64, 3200, 5, H100, (True, 8, C6_REC + BIG_TOP)),  # fits an H100's block
    (64, 3200, 5, SMALL, (False, 8, C6_REC)),  # not a 99 KB card's
])
def test_top_plan_is_a_function_of_sizes(n_top, n_slots, depth, limit, want):
    """The top tables are staged whenever they fit beside the primitive
    records, whatever their size."""
    plan = bvh_paged.top_plan(C6_PSQ, n_top, n_slots, depth, limit)
    assert tuple(plan) == want
    assert plan == bvh_paged.top_plan(C6_PSQ, n_top, n_slots, depth, limit)
    assert plan.smem_bytes <= limit
    assert plan.depth_class == bvh.depth_class(depth)


def test_top_plan_refuses_records_past_the_card():
    with pytest.raises(ValueError, match="primitive records"):
        bvh_paged.top_plan((3000, 0, 0), 7, 16, 3, SMALL)


@pytest.mark.parametrize("n,n_sms,per_sm,want", [
    (131072, 132, 2, 264),  # the resident blocks
    (131089, 132, 4, 513),  # one block a 256-lane batch, fewer than the resident 528
    (33, 132, 2, 1), (1, 132, 2, 1), (257, 78, 1, 2),
])
def test_persistent_grid(n, n_sms, per_sm, want):
    assert bvh.persistent_grid(n, n_sms, per_sm) == want


@pytest.mark.parametrize("depth4,want", [(3, 8), (6, 8), (8, 8), (9, 32), (32, 32)])
def test_rooted_plan_is_the_depth_class_of_the_tree(depth4, want):
    """K11 walks from subtree roots, which are shallower than the tree: the
    whole tree's class holds every walk; nothing is staged."""
    cs = SimpleNamespace(bvh=SimpleNamespace(depth4=depth4))
    assert tuple(bvh.rooted_plan(cs)) == (False, want, 0)


# config 5's BVH2 is 13 deep; the chain of tests/torch_chain.py 190, the
# most the ordered walk takes (STACK_CAP - 2)
@pytest.mark.parametrize("depth2,want", [(1, 32), (13, 32), (30, 32), (31, 192), (190, 192)])
def test_depth2_class_holds_the_ordered_stack(depth2, want):
    assert bvh.depth2_class(depth2) == want >= depth2 + 2
    cs = SimpleNamespace(bvh=SimpleNamespace(depth2=depth2))
    assert tuple(bvh2.ordered_plan(cs)) == (False, want, 0)


def test_split_walks_take_the_plain_versions_on_the_cpu(mesh):
    g = torch.Generator().manual_seed(3)
    n = 48
    o = V3(*(torch.rand(n, generator=g) * 8 - 4 for _ in range(3)))
    d = V3(*(torch.randn(n, generator=g) for _ in range(3))).normalized()
    bound = torch.rand(n, generator=g) * 20
    before = (bvh.closest_rooted.launches, bvh2.closest_ordered.launches,
              bvh2.closest_skiplink.launches)
    any_before = bvh2.any_skiplink.launches
    roots = torch.ones(n, dtype=torch.int32)
    en = torch.arange(n) % 3 != 0
    none = torch.full((n,), -1, dtype=torch.int32)
    got = bvh.closest_rooted(mesh, o, d, 1e-3, roots, en, bound, none)
    want = tbvh.rooted(mesh.bvh, mesh.triangles, o, d, 1e-3, roots, en, bound, none)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    want = tbvh.traverse_closest(mesh.bvh, mesh.triangles, o, d, 1e-3, bound)
    for walk in (bvh2.closest_ordered, bvh2.closest_skiplink):
        got = walk(mesh, o, d, 1e-3, bound)
        assert all(torch.equal(a, b) for a, b in zip(got, want)) and bool((got[1] >= 0).any())
    occ = bvh2.any_skiplink(mesh, o, d, 1e-3, bound)
    assert torch.equal(occ, tbvh.traverse_any(mesh.bvh, mesh.triangles, o, d, 1e-3, bound))
    assert before == (bvh.closest_rooted.launches, bvh2.closest_ordered.launches,
                      bvh2.closest_skiplink.launches)
    assert bvh2.any_skiplink.launches == any_before


def _skiplink_visit(cs, o: V3, d: V3, t_min, bound):
    """``bvh2_closest_skiplink_persistent``'s walk of every lane, from the
    rows it loads: node ``c`` as rows ``2c`` (lo, hi.x) and ``2c + 1`` (hi.y,
    hi.z, skip, code) of ``tree2``; a leaf's 16 slots as four batches of four,
    slot ``s`` as rows ``4s .. 4s + 2`` of ``slot16`` (v0 e1x | e1y e1z e2x e2y
    | e2z gid nx ny), each slot tested in order against the running best."""
    b = cs.bvh
    nodes, slots = b.tree2.view(-1, 4), b.slot16.view(-1, 4)
    m, n = b.tree2.shape[0] // 8, o.x.shape[0]
    org, dirs = torch.stack(tuple(o), -1), torch.stack(tuple(d), -1)
    iv = 1.0 / torch.where(torch.abs(dirs) > 1e-12, dirs, 1e-12)
    best = torch.as_tensor(bound, dtype=torch.float32).expand(n).clone()
    gid = torch.full((n,), -1.0)
    cursor = torch.zeros(n, dtype=torch.int64)
    for _step in range(m + 1):  # the kernel's step <= m guard
        walking = cursor < m
        if not bool(walking.any()):
            break
        c = torch.clamp(cursor, max=m - 1)
        lo, hi = nodes[2 * c], nodes[2 * c + 1]
        box_hi = torch.stack((lo[:, 3], hi[:, 0], hi[:, 1]), -1)
        a, e = (lo[:, :3] - org) * iv, (box_hi - org) * iv
        near, far = torch.minimum(a, e), torch.maximum(a, e)
        enter = torch.maximum(torch.maximum(near[:, 0], near[:, 1]),
                              torch.clamp(near[:, 2], min=t_min))
        exit_ = torch.minimum(torch.minimum(far[:, 0], far[:, 1]), torch.minimum(far[:, 2], best))
        hit = walking & (enter <= exit_)
        code = hi[:, 3]
        rows = torch.nonzero(hit & (code >= 0))[:, 0]
        if rows.numel():
            base = code[rows].long()
            for batch in range(0, tbvh.LEAF_SIZE, 4):  # four slots' rows loaded together
                s = 4 * (base[:, None] + batch + torch.arange(4))
                ra, rb, rc = slots[s], slots[s + 1], slots[s + 2]  # (k, 4, 4) each
                e1 = torch.stack((ra[..., 3], rb[..., 0], rb[..., 1]), -1)
                e2 = torch.stack((rb[..., 2], rb[..., 3], rc[..., 0]), -1)
                t, inside = tbvh._leaf_test(ra[..., :3], e1, e2, org[rows, None], dirs[rows, None],
                                            t_min, float("inf"))
                for j in range(4):  # in slot order, strict < against the running best
                    win = inside[:, j] & (t[:, j] < best[rows]) & (rc[:, j, 1] >= 0.0)
                    best[rows] = torch.where(win, t[:, j], best[rows])
                    gid[rows] = torch.where(win, rc[:, j, 1], gid[rows])
        cursor = torch.where(walking, torch.where(hit & (code < 0), cursor + 1, hi[:, 2].long()),
                             cursor)
    prim = gid.to(torch.int32)
    return best, torch.where(prim >= 0, prim & bvh.gid_mask(cs), prim)


def _mesh_rays(n, seed):
    g = torch.Generator().manual_seed(seed)
    o = V3(*(torch.rand(n, generator=g) * 8 - 4 for _ in range(3)))
    return o, V3(*(torch.randn(n, generator=g) for _ in range(3))).normalized()


@pytest.mark.parametrize("scene", ["mesh", "190-deep chain"])
def test_skiplink_visit_from_its_loads_is_the_plain_walk(mesh, scene):
    if scene == "mesh":
        cs, (o, d) = mesh, _mesh_rays(96, 5)
    else:
        cs = chain_scene(bvh.STACK_CAP - 2)
        o, d = (V3(*(torch.from_numpy(a[:, i].copy()) for i in range(3)))
                for a in chain_rays(cs.bvh.depth2, 96, 31))
    assert cs.bvh.tree2.data_ptr() % 16 == 0 and cs.bvh.slot16.data_ptr() % 16 == 0
    want_t, _ = tbvh.traverse_closest(cs.bvh, cs.triangles, o, d, 1e-3, 1e6)
    bound = want_t * (0.5 + torch.rand(96, generator=torch.Generator().manual_seed(6)))
    for b in (1e6, bound):
        got = _skiplink_visit(cs, o, d, 1e-3, b)
        want = tbvh.traverse_closest(cs.bvh, cs.triangles, o, d, 1e-3, b)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert 0 < int((got[1] >= 0).sum()) < 96  # hits and misses


def _skiplink_any_visit(cs, o: V3, d: V3, t_min, limit):
    """``bvh2_any_skiplink_persistent``'s walk of every lane, from the rows
    it loads, as ``_skiplink_visit``: the slab's far plane and each slot's
    test against the lane's fixed limit, the lane done at its first slot hit
    below it.  A lane whose limit is ≤ 0 loads no ray and reports occluded."""
    b = cs.bvh
    nodes, slots = b.tree2.view(-1, 4), b.slot16.view(-1, 4)
    m, n = b.tree2.shape[0] // 8, o.x.shape[0]
    org, dirs = torch.stack(tuple(o), -1), torch.stack(tuple(d), -1)
    iv = 1.0 / torch.where(torch.abs(dirs) > 1e-12, dirs, 1e-12)
    lim = torch.as_tensor(limit, dtype=torch.float32).expand(n)
    occ = lim <= 0.0
    cursor = torch.where(occ, m, 0)
    for _step in range(m + 1):  # the kernel's step <= m guard
        walking = cursor < m
        if not bool(walking.any()):
            break
        c = torch.clamp(cursor, max=m - 1)
        lo, hi = nodes[2 * c], nodes[2 * c + 1]
        box_hi = torch.stack((lo[:, 3], hi[:, 0], hi[:, 1]), -1)
        a, e = (lo[:, :3] - org) * iv, (box_hi - org) * iv
        near, far = torch.minimum(a, e), torch.maximum(a, e)
        enter = torch.maximum(torch.maximum(near[:, 0], near[:, 1]),
                              torch.clamp(near[:, 2], min=t_min))
        exit_ = torch.minimum(torch.minimum(far[:, 0], far[:, 1]), torch.minimum(far[:, 2], lim))
        hit = walking & (enter <= exit_)
        code = hi[:, 3]
        rows = torch.nonzero(hit & (code >= 0))[:, 0]
        found = torch.zeros(n, dtype=torch.bool)
        if rows.numel():
            base = code[rows].long()
            for batch in range(0, tbvh.LEAF_SIZE, 4):  # four slots' rows loaded together
                s = 4 * (base[:, None] + batch + torch.arange(4))
                ra, rb, rc = slots[s], slots[s + 1], slots[s + 2]  # (k, 4, 4) each
                e1 = torch.stack((ra[..., 3], rb[..., 0], rb[..., 1]), -1)
                e2 = torch.stack((rb[..., 2], rb[..., 3], rc[..., 0]), -1)
                _t, inside = tbvh._leaf_test(ra[..., :3], e1, e2, org[rows, None],
                                             dirs[rows, None], t_min, lim[rows, None])
                found[rows] |= (inside & (rc[..., 1] >= 0.0)).any(-1)
        occ |= found
        cursor = torch.where(found, m, torch.where(
            walking, torch.where(hit & (code < 0), cursor + 1, hi[:, 2].long()), cursor))
    return occ


def test_skiplink_plan_has_no_stack():
    """Both skip-link walks launch on one plan whatever the tree: depth
    class 0 (no stack), nothing staged, no shared memory."""
    assert tuple(bvh2.SKIPLINK_PLAN) == (False, 0, 0)


@pytest.mark.parametrize("scene", ["mesh", "190-deep chain"])
def test_skiplink_any_visit_from_its_loads_is_the_plain_walk(mesh, scene):
    n = 96
    if scene == "mesh":
        cs, (o, d) = mesh, _mesh_rays(n, 7)
    else:
        cs = chain_scene(bvh.STACK_CAP - 2)
        o, d = (V3(*(torch.from_numpy(a[:, i].copy()) for i in range(3)))
                for a in chain_rays(cs.bvh.depth2, n, 33))
    want_t, _ = tbvh.traverse_closest(cs.bvh, cs.triangles, o, d, 1e-3, 1e6)
    bound = want_t * (0.5 + torch.rand(n, generator=torch.Generator().manual_seed(8)))
    lane = torch.arange(n)
    mixed = torch.where(lane % 7 == 0, -1.0, torch.where(lane % 11 == 0, float("inf"), bound))
    mixed[lane % 13 == 0] = 0.0
    for limit in (bound, torch.full((n,), float("inf")), mixed):
        got = _skiplink_any_visit(cs, o, d, 1e-3, limit)
        care = limit > 0
        want = tbvh.traverse_any(cs.bvh, cs.triangles, o, d, 1e-3, limit)
        assert torch.equal(got[care], want[care]) and bool(got[~care].all())
        assert 0 < int(got[care].sum()) < int(care.sum())  # occluded and clear lanes


@pytest.mark.parametrize("budget", [0, TREE, 1 << 30])
@pytest.mark.parametrize("depth4,want", [(C5_DEPTH, 8), (20, 32)])
def test_closest_plan_is_the_depth_class_and_the_blob(monkeypatch, budget, depth4, want):
    monkeypatch.setattr(bvh, "SMEM_TREE_BYTES", budget)
    cs = SimpleNamespace(bvh=SimpleNamespace(depth4=depth4, ps_blob=torch.zeros(C5_PS // 4),
                                             nodes4=torch.zeros(32 * C5_NODES)))
    plan = bvh.closest_plan(cs)
    assert tuple(plan) == (False, want, C5_PS) and want == bvh.depth_class(depth4)
    assert bvh_leafmat.scene_any_plan(cs) == plan


@pytest.fixture(scope="module")
def config5():
    b = pt.MeshSceneBuilder(grid=3, subdivisions=3)
    return pt.compile_scene(b.build_scene(), device="cpu", use_bvh=True)


def _mt_uv(v0, e1, e2, o, d):
    """Möller–Trumbore's raw barycentrics ``(u, v)``, expression for
    expression as ``csrc/sweep.cuh`` ``moller_trumbore`` (and
    ``ops/bvh._leaf_test``) compute them; ``(..., 3)`` operands."""
    h = torch.stack((d[..., 1] * e2[..., 2] - d[..., 2] * e2[..., 1],
                     d[..., 2] * e2[..., 0] - d[..., 0] * e2[..., 2],
                     d[..., 0] * e2[..., 1] - d[..., 1] * e2[..., 0]), -1)
    det = e1[..., 0] * h[..., 0] + e1[..., 1] * h[..., 1] + e1[..., 2] * h[..., 2]
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-6, det, 1.0)
    s = o - v0
    q = torch.stack((s[..., 1] * e1[..., 2] - s[..., 2] * e1[..., 1],
                     s[..., 2] * e1[..., 0] - s[..., 0] * e1[..., 2],
                     s[..., 0] * e1[..., 1] - s[..., 1] * e1[..., 0]), -1)
    return (inv_det * (s[..., 0] * h[..., 0] + s[..., 1] * h[..., 1] + s[..., 2] * h[..., 2]),
            inv_det * (d[..., 0] * q[..., 0] + d[..., 1] * q[..., 1] + d[..., 2] * q[..., 2]))


def _slot16_visit(slot16, n_leaves, o, d, t_min, bound):
    """``Slot16Leaf::closest`` (K4a) of every leaf against every ray, from the
    rows it loads: slot ``s`` as rows ``4s .. 4s + 3`` of ``slot16`` (v0 e1x |
    e1y e1z e2x e2y | e2z gid nx ny | nz 0 0 0), a batch's four slots' first
    three rows loaded together, the slots tested in order (strict ``<``
    against the running best, seeded with ``bound``), the fourth row's first
    word read on a win.  ``(t, gid, u, v, nx, ny, nz)``, each ``(leaves, rays)``."""
    rows = slot16.view(-1, 4)
    shape = (n_leaves, o.shape[0])
    best = torch.full(shape, float(bound))
    gid = torch.full(shape, -1.0)
    u, v, nx, ny, nz = (torch.zeros(shape) for _ in range(5))
    first = 16 * torch.arange(n_leaves)
    for batch in range(0, tbvh.LEAF_SIZE, 4):
        s = first[:, None] + batch + torch.arange(4)  # (leaves, 4)
        ra, rb, rc = rows[4 * s], rows[4 * s + 1], rows[4 * s + 2]  # (leaves, 4, 4) each
        for j in range(4):
            v0 = ra[:, j, None, :3]
            e1 = torch.stack((ra[:, j, 3], rb[:, j, 0], rb[:, j, 1]), -1)[:, None]
            e2 = torch.stack((rb[:, j, 2], rb[:, j, 3], rc[:, j, 0]), -1)[:, None]
            t, inside = tbvh._leaf_test(v0, e1, e2, o[None], d[None], t_min, best)
            win = inside & (rc[:, j, None, 1] >= 0.0)
            bu, bv = _mt_uv(v0, e1, e2, o[None], d[None])
            nz_word = rows[4 * s[:, j] + 3][:, None, 0]  # read on a win
            for acc, x in ((best, t), (gid, rc[:, j, None, 1]), (u, bu), (v, bv),
                           (nx, rc[:, j, None, 2]), (ny, rc[:, j, None, 3]), (nz, nz_word)):
                acc.copy_(torch.where(win, x, acc))
    return best, gid, u, v, nx, ny, nz


def _slot_rec_leaf(slot_rec, n_leaves, o, d, t_min, bound):
    """The plain Möller–Trumbore leaf over the 13-float slot records (v0, e1,
    e2, gid, normal), as ``ops/bvh._walk`` decides it: every slot tested at
    once by ``_leaf_test`` below ``bound``, the first slot with the least t
    wins; its barycentrics and record's gid and normal, ``bound`` and −1 (and
    zeros) where no slot hits."""
    rec = slot_rec.view(n_leaves, tbvh.LEAF_SIZE, 1, 13)  # (leaves, slot, 1, 13)
    v0, e1, e2 = rec[..., 0:3], rec[..., 3:6], rec[..., 6:9]
    t, hit = tbvh._leaf_test(v0, e1, e2, o[None, None], d[None, None], t_min, bound)
    hit = hit & (rec[..., 9] >= 0.0)  # (leaves, slot, rays)
    t = torch.where(hit, t, torch.inf)
    k = torch.argmin(t, dim=1, keepdim=True)  # the first least t
    take = torch.isfinite(torch.gather(t, 1, k))[:, 0]
    bu, bv = _mt_uv(v0, e1, e2, o[None, None], d[None, None])
    gid, nx, ny, nz = (rec[..., c].expand(-1, -1, o.shape[0]) for c in (9, 10, 11, 12))
    return tuple(torch.where(take, torch.gather(x, 1, k)[:, 0], miss) for x, miss in (
        (t, float(bound)), (gid, -1.0), (bu, 0.0), (bv, 0.0), (nx, 0.0), (ny, 0.0), (nz, 0.0)))


def _aimed_rays(cs, n, seed):
    """``(n, 3)`` origins in a box around the triangles and unit directions
    aimed at seeded points of seeded triangles (every third anywhere)."""
    v0, v1, v2 = (torch.stack(tuple(v), -1) for v in (cs.triangles.v0, cs.triangles.v1,
                                                      cs.triangles.v2))
    g = torch.Generator().manual_seed(seed)
    lo, hi = float(v0.min()) - 2, float(v0.max()) + 2
    o = lo + (hi - lo) * torch.rand((n, 3), generator=g)
    tri = torch.randint(0, v0.shape[0], (n,), generator=g)
    a, b = (0.5 * torch.rand((n, 1), generator=g) for _ in range(2))
    d = v0[tri] + a * (v1[tri] - v0[tri]) + b * (v2[tri] - v0[tri]) - o
    d = torch.where(torch.arange(n)[:, None] % 3 == 2, torch.randn((n, 3), generator=g), d)
    return o, d / torch.linalg.norm(d, dim=1, keepdim=True)


@pytest.mark.parametrize("bound", [1e6, 1e30, float("inf")])
def test_attribute_leaf_visit_from_its_loads_is_the_plain_leaf(config5, bound):
    b = config5.bvh
    assert b.slot16.data_ptr() % 16 == 0 and b.paged is None
    n_leaves = b.slot_rec.shape[0] // (13 * tbvh.LEAF_SIZE)
    org, dirs = _aimed_rays(config5, 48, 17)
    got = _slot16_visit(b.slot16, n_leaves, org, dirs, 1e-3, bound)
    want = _slot_rec_leaf(b.slot_rec, n_leaves, org, dirs, 1e-3, bound)
    for name, a, w in zip(("t", "gid", "u", "v", "nx", "ny", "nz"), got, want):
        assert torch.equal(a.view(torch.int32), w.view(torch.int32)), name
    won = got[1] >= 0
    assert 0 < int(won.sum()) < won.numel() and int(won.any(0).sum()) >= 32  # most rays hit
