"""A BVH2 laid out as a chain ``depth2`` levels deep, for the walks' stack.

No builder makes such a tree from the repo's scenes (the deepest BVH4 that
``experiments/bvh4_depth.py`` found is 23 levels), so the arrays of
``ops/bvh.build_bvh`` are written by hand.  With ``L = depth2 - 1`` inner
nodes: inner node ``k`` (DFS index ``2k``) has leaf ``k`` (``2k + 1``) as its
left child and inner node ``k + 1`` as its right; the last inner node's
right child is the last leaf (``2L``).  Leaf ``k`` holds triangle ``k``,
which lies in the plane ``x = L - k`` and covers ``|y|, |z| <= 3``.  A ray
along +x meets each inner node's right subtree first, so the ordered walk
pushes every leaf before it pops one: its stack holds ``depth2`` nodes.

The module imports neither JAX nor the JAX package, so the ``cuda`` tests
take it on a machine without JAX.
"""
from types import SimpleNamespace

import numpy as np
import torch

from path_tracing__ray_tracer_tpu_torch.ops import bvh as tbvh
from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3


def chain_arrays(depth2: int):
    """``(arrs, v0, v1, v2)``: the chain's ``build_bvh`` arrays and its
    ``depth2`` triangles, numpy."""
    n_inner = depth2 - 1
    m = 2 * n_inner + 1
    x = np.arange(n_inner, -1, -1, dtype=np.float32)  # triangle k at x = L - k
    v0 = np.stack([x, np.full_like(x, -3.0), np.full_like(x, -3.0)], 1)
    v1 = np.stack([x, np.full_like(x, 9.0), np.full_like(x, -3.0)], 1)
    v2 = np.stack([x, np.full_like(x, -3.0), np.full_like(x, 9.0)], 1)
    lo, hi = np.zeros((m, 3), np.float32), np.zeros((m, 3), np.float32)
    skip = np.full(m, m, np.int32)
    is_leaf = np.zeros(m, bool)
    slots = np.full((m, tbvh.LEAF_SIZE), -1, np.int32)
    leaf_of = [2 * k + 1 for k in range(n_inner)] + [2 * n_inner]
    for k, node in enumerate(leaf_of):
        is_leaf[node], slots[node, 0] = True, k
        lo[node] = np.minimum(np.minimum(v0[k], v1[k]), v2[k])
        hi[node] = np.maximum(np.maximum(v0[k], v1[k]), v2[k])
        if k < n_inner:
            skip[node] = node + 1
    for k in range(n_inner):  # inner node k bounds triangles k .. L
        lo[2 * k] = lo[leaf_of[k:]].min(0)
        hi[2 * k] = hi[leaf_of[k:]].max(0)
    arrs = {"lo": lo, "hi": hi, "skip": skip, "is_leaf": is_leaf, "slots": slots}
    return arrs, v0, v1, v2


def chain_scene(depth2: int, device="cpu"):
    """What the BVH2 walks read of a compiled scene: ``bvh`` (a
    :class:`FlatBVH` of the chain) and ``triangles`` (``v0``, ``v1``,
    ``v2``)."""
    arrs, v0, v1, v2 = chain_arrays(depth2)
    bvh = tbvh.to_device(arrs, v0, v1, v2, None, device=device)
    tris = SimpleNamespace(**{k: V3(*(torch.from_numpy(a[:, i].copy()).to(device)
                                      for i in range(3)))
                              for k, a in (("v0", v0), ("v1", v1), ("v2", v2))})
    return SimpleNamespace(bvh=bvh, triangles=tris)


def chain_rays(depth2: int, n: int, seed: int):
    """``(ro, rd)`` numpy ``(n, 3)``: a third along +x from ``x = -1`` (the
    deep stack), a third along −x from past the far end (a shallow one), a
    third from random points in random directions; slightly tilted."""
    g = np.random.default_rng(seed)
    far = float(depth2)
    ro = np.stack([g.uniform(-1.0, far, n), g.uniform(-1.5, 1.5, n), g.uniform(-1.5, 1.5, n)], 1)
    rd = g.normal(size=(n, 3))
    third = n // 3
    ro[:third, 0], ro[third:2 * third, 0] = -1.0, far
    rd[:2 * third, 1:] *= 1e-3
    rd[:third, 0], rd[third:2 * third, 0] = 1.0, -1.0
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro.astype(np.float32), rd.astype(np.float32)
