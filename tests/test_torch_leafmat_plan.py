"""The host side of the persistent ordered BVH2 occlusion walk (K4e) and of
the persistent leaf-table closest walk (K10c) on the CPU.

* The 16-byte loads of K10c's leaf visit (``csrc/bvh_walk.cuh``
  ``MatQuadLeaf``): each of a batch's 19 loads lies on a 16-byte boundary
  of the ``(16, 128·G)`` table and holds one coefficient of four
  consecutive slots, on ``tests/test_mxu_leaf.py``'s 53-triangle set and
  the mesh of ``tests/test_torch_mxu_leaf.py`` (whose gids carry material
  ids; the port's table 16-byte aligned).
* The linear forms ``ops/bvh._forms`` evaluated from those loads, in the
  kernel's coefficient order, equal those from the table bit for bit on
  seeded rays.
* ``ops/cuda/bvh2.ordered_plan`` (both ordered walks) and
  ``ops/cuda/bvh_leafmat.tri_closest_plan`` are the depth classes of the
  tree's BVH2 and BVH4 depths, nothing staged.
* The two wrappers take their plain versions on CPU tensors and count no
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
from path_tracing__ray_tracer_tpu_torch.ops.intersect import ClosestRecord
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


# config 5's BVH2 is 13 deep and its BVH4 6; the chain of tests/torch_chain.py
# 190, the most the ordered walks take
@pytest.mark.parametrize("depth2,depth4,want2,want4", [
    (1, 1, 32, 8), (13, 6, 32, 8), (30, 8, 32, 8), (31, 9, 192, 32), (190, 32, 192, 32),
])
def test_ordered_and_leafmat_plans_are_the_depth_classes(depth2, depth4, want2, want4):
    cs = SimpleNamespace(bvh=SimpleNamespace(depth2=depth2, depth4=depth4))
    assert tuple(bvh2.ordered_plan(cs)) == (False, want2, 0) and want2 >= depth2 + 2
    assert tuple(bvh_leafmat.tri_closest_plan(cs)) == (False, want4, 0)
    assert want4 == bvh.depth_class(depth4) == bvh.rooted_plan(cs).depth_class


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
