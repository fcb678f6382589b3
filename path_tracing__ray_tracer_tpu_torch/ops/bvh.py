"""Flat BVH over the triangles: host build, packed records, plain walks.

Port of the JAX package's ``ops/bvh.py`` with the host-side packers of its
``ops/pallas/bvh_pallas.py`` (copied as numpy, not imported):

* **Build** (host): binned SAH over triangle centroids, deterministic,
  nodes in DFS order with *skip links*; node ``i``'s first child is ``i+1``
  and ``skip[i]`` jumps past its subtree.  Leaves hold ``LEAF_SIZE`` slots,
  ``-1`` padded.  The C++ builder of ``native/`` gives the same arrays and
  is taken first.
* **Records** the CUDA walks read: the BVH2 node records of ``pack_blobs``
  (lo, hi, skip link, slot base or split code; ``csrc/bvh2_walk.cu``), the
  BVH4 node records of ``pack_blobs4`` (two BVH2 levels collapsed,
  near-first split codes; ``csrc/bvh_walk.cuh``) and the leaf-ordered
  triangle slot records of ``pack_blobs`` (v0, e1, e2, gid, stored normal),
  whose gid may carry the triangle's unique-material id (``GID_UID_SHIFT``).
* **Paged layout** (host, ``pack_paged``, a numpy copy of the JAX
  package's ``ops/pallas/bvh_paged_pallas.py``): a tree whose one-level
  records exceed ``ONE_LEVEL_LIMIT`` floats is cut into at most
  ``PAGES_MAX`` subtree pages of about ``PAGE_BUDGET_FLOATS`` floats, each
  with its own BVH4 and slot records, under a top tree whose page children
  carry the meta ``-(1 + PAGE_META_BASE + page)``.  ``ONE_LEVEL_LIMIT`` is
  the JAX package's route decision (its ``SMEM_BLOB_LIMIT``, a TPU SMEM
  budget), not a limit of the GPU: it is kept so that the same scenes take
  the same kernels in both packages.  The one-level records stay beside the
  pages.
* **Leaf coefficient table** (host, ``pack_leaf_mat``, a numpy copy of the
  JAX package's): per leaf, the Möller–Trumbore decision quantities of its
  16 slots as linear forms of the ray features ``leaf_features`` (K10, the
  JAX package's MXU leaf visit); built for one-level trees only.
* **Plain walks** ``traverse_closest`` / ``traverse_any``: the JAX skip-link
  walks in torch ops, every lane with its own cursor, compacted to the
  lanes still walking.  Given the leaf table they test a leaf by its linear
  forms (``_leaf_closest_mat`` / ``_leaf_any_mat``) instead of its slot
  records.  ``paged_top`` and ``pages`` are the same walk over a
  paged tree: the top walk treats a page root as a leaf that sets the
  lane's pending bit, and each page is walked, in increasing index, from its
  root to the end of its subtree with the lane's carried best.  They serve
  the CPU and are what the kernels are held against; they can count the box
  and triangle tests they make.
"""
from __future__ import annotations

import sys
from typing import NamedTuple, Optional

import numpy as np
import torch

from .v3 import V3

LEAF_SIZE = 16
_SAH_BINS = 16
_NODE_F = 8  # BVH2 node record: lo(3) hi(3) skip slot_base/split code
_NODE4_F = 32  # BVH4 node record: 4 boxes, 4 metas, 3 split codes, 1 pad
_SLOT_F = 13  # slot record: v0(3) e1(3) e2(3) gid n(3)
# gid = uid · 2^17 + tri, exact in f32 below 2^24 (uid < 128, tri < 2^17)
GID_UID_SHIFT = 1 << 17
GID_TRI_MASK = GID_UID_SHIFT - 1

# The paged layout (the JAX package's constants; module globals, so tests can
# shrink them).  A tree whose one-level BVH4 + slot records exceed
# ONE_LEVEL_LIMIT floats is paged: the JAX package's SMEM_BLOB_LIMIT, its
# route decision, kept so that both packages page the same scenes.
ONE_LEVEL_LIMIT = 240_000
# page children are metas -(1 + PAGE_META_BASE + page)
PAGE_META_BASE = 1 << 20
# per-page budget (BVH4 + slot record floats), escalated toward
# PAGE_BUDGET_CEIL when the cut would need more than PAGES_MAX pages
PAGE_BUDGET_FLOATS = 200_000
PAGE_BUDGET_CEIL = 235_000
# the pending mask holds two 32-bit words
PAGES_MAX = 64


class FlatBVH(NamedTuple):
    lo: torch.Tensor  # (M, 3) f32 box min
    hi: torch.Tensor  # (M, 3) f32 box max
    skip: torch.Tensor  # (M,) int32: next node when this box is missed / leaf done
    is_leaf: torch.Tensor  # (M,) bool
    slots: torch.Tensor  # (M, LEAF_SIZE) int32 triangle ids, -1 padded
    # the records the CUDA walks read, on the same device
    nodes4: torch.Tensor  # (32·M4,) f32 BVH4 node records (pack_blobs4)
    slot_rec: torch.Tensor  # (13·K,) f32 leaf-ordered triangle records (pack_blobs)
    depth4: int  # BVH4 depth, root = 1: bounds the walk's stack
    uid_packed: bool  # slot gids carry packed unique-material ids
    tree2: torch.Tensor  # (8·M,) f32 BVH2 node records (pack_blobs): the JAX tree_blob
    depth2: int  # BVH2 depth, root = 1: bounds the ordered BVH2 walk's stack
    node2: torch.Tensor  # (M4,) int64: the BVH2 node each BVH4 node collapses
    # plane/sphere/quad blob (ops/cuda/bounce.pack_ps_blob) seeding the
    # scene walks; the compiler sets it
    ps_blob: Optional[torch.Tensor] = None
    paged: Optional["PagedBlobs"] = None  # the two-level layout of a big tree
    # (16, G·128) f32 leaf coefficient table (pack_leaf_mat) of a one-level tree
    leaf_mat: Optional[torch.Tensor] = None
    # (16·K,) f32 the slot records padded to 64 B (pack_slot16), read by the
    # persistent K4b and K5 as 16-byte loads
    slot16: Optional[torch.Tensor] = None

    @property
    def n_nodes(self) -> int:
        return int(self.skip.shape[0])


class PagedBlobs(NamedTuple):
    """The two-level layout on the scene's device (the JAX package's
    ``PagedBlobs``; its depth tokens are ints here)."""

    top_tree: torch.Tensor  # (32·M4top,) f32 BVH4 records of the top tree
    top_slot: torch.Tensor  # (13·K,) f32 slot records of the leaves above the cut
    page_tree: torch.Tensor  # (n_pages, TC) f32 each page's BVH4 records, zero padded
    page_slot: torch.Tensor  # (n_pages, SC) f32 each page's slot records, gid −1 padded
    top_depth: int  # BVH4 depth of the top tree (root = 1)
    page_depth: int  # the deepest page's BVH4 depth
    page_lo: torch.Tensor  # (n_pages, 3) f32 page root boxes
    page_hi: torch.Tensor  # (n_pages, 3) f32
    page_root: torch.Tensor  # (n_pages,) int64 BVH2 node of each page root (plain walks)
    # (n_pages, SC // 13 · 16) f32 each page's slot records padded to 64 B
    # (pack_page_slot16), read by the page walks K6c/K6d as 16-byte loads
    page_slot16: Optional[torch.Tensor] = None

    @property
    def n_pages(self) -> int:
        return int(self.page_tree.shape[0])


# ---- build ------------------------------------------------------------------------
class _Node:
    __slots__ = ("lo", "hi", "left", "right", "prims")

    def __init__(self, lo, hi, left=None, right=None, prims=None):
        self.lo, self.hi = lo, hi
        self.left, self.right = left, right
        self.prims = prims


def _build_tree(tri_min, tri_max, centroids, idx, leaf_size) -> _Node:
    lo = tri_min[idx].min(axis=0)
    hi = tri_max[idx].max(axis=0)
    if len(idx) <= leaf_size:
        return _Node(lo, hi, prims=idx)

    # split along the largest centroid extent only (as the C++ builder does)
    c = centroids[idx]
    axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))

    def half_area(a, b):
        d = np.maximum(b - a, 0.0)
        return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]

    left_idx = right_idx = None
    best_cost = np.inf
    cmin, cmax = float(c[:, axis].min()), float(c[:, axis].max())
    if cmax - cmin > 1e-12:
        bins = np.minimum(((c[:, axis] - cmin) / (cmax - cmin) * _SAH_BINS).astype(np.int32),
                          _SAH_BINS - 1)
        for split in range(1, _SAH_BINS):
            mask = bins < split
            nl = int(mask.sum())
            if nl == 0 or nl == len(idx):
                continue
            cost = half_area(tri_min[idx[mask]].min(axis=0), tri_max[idx[mask]].max(axis=0)) * nl \
                + half_area(tri_min[idx[~mask]].min(axis=0),
                            tri_max[idx[~mask]].max(axis=0)) * (len(idx) - nl)
            if cost < best_cost:
                best_cost = cost
                left_idx, right_idx = idx[mask], idx[~mask]

    if left_idx is None:  # degenerate spread → stable median split
        order = np.argsort(c[:, axis], kind="stable")
        half = len(idx) // 2
        left_idx, right_idx = idx[order[:half]], idx[order[half:]]

    return _Node(lo, hi, left=_build_tree(tri_min, tri_max, centroids, left_idx, leaf_size),
                 right=_build_tree(tri_min, tri_max, centroids, right_idx, leaf_size))


def build_bvh(tri_min: np.ndarray, tri_max: np.ndarray, leaf_size: int = LEAF_SIZE,
              use_native: bool = True) -> dict:
    """Binned-SAH BVH over triangle AABBs ``(T, 3)``: numpy ``lo``, ``hi``,
    ``skip``, ``is_leaf``, ``slots``.  Takes the C++ builder of ``native/``
    when ``use_native`` and it is available (same arrays), else this
    module's numpy builder, after logging why."""
    if use_native:
        from ..native import NativeUnavailable, native_build_bvh

        try:
            return native_build_bvh(tri_min, tri_max, leaf_size)
        except NativeUnavailable as e:
            from ..utils.logging import log_event

            log_event("bvh_native_declined", reason=str(e), triangles=int(tri_min.shape[0]))

    t = tri_min.shape[0]
    assert t > 0
    centroids = ((tri_min + tri_max) * 0.5).astype(np.float64)
    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(limit, 8 * t + 1000))
    try:
        root = _build_tree(tri_min.astype(np.float64), tri_max.astype(np.float64), centroids,
                           np.arange(t, dtype=np.int32), leaf_size)
        lo, hi, skip, is_leaf, slots = [], [], [], [], []

        def flatten(node: _Node, skip_to: int):
            """DFS emit; ``skip_to`` is where the walk resumes when this
            subtree is done or missed (-1: patched once the right root is
            known)."""
            me = len(lo)
            lo.append(node.lo)
            hi.append(node.hi)
            skip.append(skip_to)
            row = np.full(leaf_size, -1, dtype=np.int32)
            if node.prims is not None:
                is_leaf.append(True)
                row[: len(node.prims)] = node.prims
                slots.append(row)
                return
            is_leaf.append(False)
            slots.append(row)
            flatten(node.left, skip_to=-1)
            right_root = len(lo)
            for j in range(me + 1, right_root):
                if skip[j] == -1:
                    skip[j] = right_root
            flatten(node.right, skip_to=skip_to)

        flatten(root, skip_to=-2)  # -2: the walk is finished
    finally:
        sys.setrecursionlimit(limit)
    m = len(lo)
    skip_np = np.asarray(skip, dtype=np.int32)
    skip_np[skip_np < 0] = m
    return {"lo": np.asarray(lo, dtype=np.float32), "hi": np.asarray(hi, dtype=np.float32),
            "skip": skip_np, "is_leaf": np.asarray(is_leaf, dtype=bool),
            "slots": np.stack(slots).astype(np.int32)}


# ---- packed records ------------------------------------------------------------------
def _pack_gid(tri: np.ndarray, uid) -> np.ndarray:
    """Slot gid values: plain triangle ids, or uid-packed when ``uid``
    (per-triangle unique-material ids) is given."""
    if uid is None:
        return tri.astype(np.float64)
    uid = np.asarray(uid)
    assert tri.size == 0 or (
        int(tri.max(initial=0)) < GID_UID_SHIFT
        and int(uid.max(initial=0)) * GID_UID_SHIFT + GID_TRI_MASK < (1 << 24)
    ), "packed gid exceeds the f32-exact integer range"
    return uid[tri].astype(np.float64) * GID_UID_SHIFT + tri.astype(np.float64)


def _split_codes(lo, hi, skip, is_leaf) -> np.ndarray:
    """Per-node split code ``axis + 4*flip`` (0..7) for inner nodes, 0 for
    leaves: ``axis`` separates the child centroids most, ``flip`` says the
    left child's centroid is the greater one."""
    codes = np.zeros(len(skip), np.float32)
    inner = np.where(~is_leaf)[0]
    if len(inner):
        left = inner + 1
        right = skip[left]
        diff = (lo[right] + hi[right]) * 0.5 - (lo[left] + hi[left]) * 0.5
        axis = np.argmax(np.abs(diff), axis=1)
        flip = diff[np.arange(len(inner)), axis] < 0.0
        codes[inner] = axis + 4.0 * flip
    return codes


def pack_blobs(arrs: dict, v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
               nrm: np.ndarray = None, uid: np.ndarray = None):
    """``(tree, slots, depth)``: the BVH2 node records ``(1, 8·M)``, the
    leaf-ordered slot records ``(1, 13·K)`` (leaf ``j``'s triangles at slots
    ``16j ..``; padding slots all zero with gid −1, which never hit) and the
    tree's depth (root = 1).  ``nrm`` is the stored unit normal (default:
    the normalized cross product); ``uid`` packs unique-material ids into
    the gids."""
    lo, hi, skip = arrs["lo"], arrs["hi"], arrs["skip"]
    is_leaf, slots = arrs["is_leaf"], arrs["slots"]
    m, leaf_size = slots.shape
    e1 = v1 - v0
    e2 = v2 - v0
    if nrm is None:
        nrm = np.cross(e1, e2)
        nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-30)
    nrm = np.asarray(nrm, np.float32)

    tree = np.zeros((m, _NODE_F), np.float32)
    tree[:, 0:3] = lo
    tree[:, 3:6] = hi
    tree[:, 6] = skip.astype(np.float32)
    leaf_ids = np.where(is_leaf)[0]
    slot_base = np.full(m, -1.0, np.float32)
    slot_base[leaf_ids] = np.arange(len(leaf_ids), dtype=np.float32) * leaf_size
    tree[:, 7] = slot_base
    inner = np.where(~is_leaf)[0]
    codes = _split_codes(lo, hi, skip, is_leaf)
    if len(inner):
        tree[inner, 7] = -(1.0 + codes[inner])

    depth = 1
    stack = [(0, 1)]
    while stack:
        node, d = stack.pop()
        depth = max(depth, d)
        if not is_leaf[node]:
            stack.append((node + 1, d + 1))
            stack.append((int(skip[node + 1]), d + 1))

    rec = np.zeros((len(leaf_ids) * leaf_size, _SLOT_F), np.float32)
    rec[:, 9] = -1.0
    flat = slots[leaf_ids].reshape(-1)
    tri = flat[flat >= 0]
    rows = np.where(flat >= 0)[0]
    rec[rows, 0:3] = v0[tri]
    rec[rows, 3:6] = e1[tri]
    rec[rows, 6:9] = e2[tri]
    rec[rows, 9] = _pack_gid(tri, uid).astype(np.float32)
    rec[rows, 10:13] = nrm[tri]
    return tree.reshape(1, -1), rec.reshape(1, -1), depth


def pack_blobs4(arrs: dict):
    """``(nodes4 (1, 32·M4), depth4, node2 (M4,))``: the BVH2 collapsed into
    BVH4 nodes and, for each, the BVH2 node it collapses (its subtree is
    ``[node2, skip[node2])`` in DFS order), or ``(None, 0, None)`` when the
    root is a leaf.  Each node merges a BVH2 inner
    node with its children: child slots 0-1 come from the left subtree, 2-3
    from the right; a leaf child takes its pair's first slot beside an empty
    (never-hit) one.  Record: 4 child boxes (lo, hi), 4 metas (leaf: its
    slot base ≥ 0; inner: −(1 + BVH4 index)), the split codes of the
    collapsed parent and of its left and right children, one pad."""
    lo, hi, skip = arrs["lo"], arrs["hi"], arrs["skip"]
    is_leaf, slots = arrs["is_leaf"], arrs["slots"]
    m, leaf_size = slots.shape
    if is_leaf[0]:
        return None, 0, None
    leaf_ids = np.where(is_leaf)[0]
    slot_base = np.full(m, -1, np.int64)
    slot_base[leaf_ids] = np.arange(len(leaf_ids), dtype=np.int64) * leaf_size
    codes = _split_codes(lo, hi, skip, is_leaf)
    records, node2 = [], []
    max_depth = [1]

    def build(i: int, d: int) -> int:
        me = len(records)
        records.append(None)
        node2.append(i)
        max_depth[0] = max(max_depth[0], d)
        l, r = i + 1, int(skip[i + 1])
        child_slots = []
        for sub in (l, r):
            if is_leaf[sub]:
                child_slots.extend([(sub, True), None])
            else:
                a, b2 = sub + 1, int(skip[sub + 1])
                child_slots.extend([(a, bool(is_leaf[a])), (b2, bool(is_leaf[b2]))])
        rec = np.zeros(_NODE4_F, np.float32)
        for c, s in enumerate(child_slots):
            if s is None:
                # a point box at +3e38 is never hit (an inverted box would be:
                # the slab test orders each axis' two planes)
                rec[6 * c: 6 * c + 6] = 3e38
                rec[24 + c] = -1.0
            else:
                nid, lf = s
                rec[6 * c: 6 * c + 3] = lo[nid]
                rec[6 * c + 3: 6 * c + 6] = hi[nid]
                rec[24 + c] = float(slot_base[nid]) if lf else -(1.0 + build(nid, d + 1))
        rec[28] = codes[i]
        rec[29] = 0.0 if is_leaf[l] else codes[l]
        rec[30] = 0.0 if is_leaf[r] else codes[r]
        records[me] = rec
        return me

    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(limit, 8 * m + 1000))
    try:
        build(0, 1)
    finally:
        sys.setrecursionlimit(limit)
    return (np.stack(records).astype(np.float32).reshape(1, -1), max_depth[0],
            np.asarray(node2, np.int64))


def pack_leaf_mat(arrs: dict, v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                  nrm: np.ndarray = None, uid: np.ndarray = None) -> np.ndarray:
    """The leaf coefficient table ``(16, G·128)`` f32 of the JAX package's
    ``pack_leaf_mat``, float for float.  Möller–Trumbore's decision
    quantities are linear in the ray features ``f = [d, m = o×d, o, 1]``:

        det   = d·n'                 with n' = e2×e1
        u·det = m·e2 − d·(e2×v0)
        v·det = −m·e1 − d·(v0×e1)
        t·det = n'·v0 − o·n'

    Rows are feature rows (10 used); leaf ``g`` (``pack_blobs``' leaf
    numbering, so ``g = slot base // 16``) owns columns ``g·128 ..``: 8
    quantity blocks × 16 slots, ``det | u·det | v·det | t·det | nx | ny | nz
    | gid``, the last four on the constant row 9.  Padding slots stay zero
    (``det = 0`` never wins).  Computed in float64, as the JAX package does."""
    is_leaf, slots = arrs["is_leaf"], arrs["slots"]
    leaf_size = slots.shape[1]
    assert leaf_size <= 16 and 128 % leaf_size == 0
    leaf_ids = np.where(is_leaf)[0]
    v0 = np.asarray(v0, np.float64)
    e1 = np.asarray(v1, np.float64) - v0
    e2 = np.asarray(v2, np.float64) - v0
    if nrm is None:
        n = np.cross(e1, e2)
        n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-30)
    else:
        n = np.asarray(nrm, np.float64)
    flat = slots[leaf_ids].reshape(-1)
    valid = flat >= 0
    tri = flat[valid]
    rows = np.where(valid)[0]
    g_of, k_of = rows // leaf_size, rows % leaf_size
    mat = np.zeros((16, len(leaf_ids) * 128), np.float32)
    npr = np.cross(e2[tri], e1[tri])

    def put(q, feat_rows, vals):
        cols = g_of * 128 + q * 16 + k_of
        for r, v in zip(feat_rows, vals.T if vals.ndim == 2 else [vals]):
            mat[r, cols] = v.astype(np.float32)

    put(0, [0, 1, 2], npr)
    put(1, [0, 1, 2], -np.cross(e2[tri], v0[tri]))
    put(1, [3, 4, 5], e2[tri])
    put(2, [0, 1, 2], -np.cross(v0[tri], e1[tri]))
    put(2, [3, 4, 5], -e1[tri])
    put(3, [6, 7, 8], -npr)
    put(3, [9], np.einsum("ij,ij->i", npr, v0[tri]))
    for q in range(3):
        put(4 + q, [9], n[tri][:, q])
    put(7, [9], _pack_gid(tri, uid))
    return mat


def _root_leaf_node4(arrs: dict) -> np.ndarray:
    """One BVH4 node whose only child is the root leaf (slot base 0), for a
    tree that ``pack_blobs4`` cannot collapse."""
    rec = np.full(_NODE4_F, 3e38, np.float32)
    rec[0:3], rec[3:6] = arrs["lo"][0], arrs["hi"][0]
    rec[24:28] = (0.0, -1.0, -1.0, -1.0)
    rec[28:32] = 0.0
    return rec[None, :]


def _tensor(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def pack_paged(arrs: dict, v0, v1, v2, nrm=None, uid=None, budget_floats: int = None,
               device="cpu") -> Optional[PagedBlobs]:
    """Cut a ``build_bvh`` tree into a top tree and subtree pages (the JAX
    package's ``pack_paged``, array for array), or ``None`` when paging does
    not apply: the root is a leaf, the whole tree fits one page, or the cut
    needs more than ``PAGES_MAX`` pages even at ``PAGE_BUDGET_CEIL``.

    The cut: walking down from the root, the first inner node whose subtree
    records (``32·BVH4 nodes + 13·16·leaves`` floats) fit the budget becomes
    a page; leaves above the cut stay in the top tree."""
    if budget_floats is None:
        budget_floats = PAGE_BUDGET_FLOATS  # module global: patchable in tests
    lo, hi, skip = arrs["lo"], arrs["hi"], arrs["skip"]
    is_leaf, slots = arrs["is_leaf"], arrs["slots"]
    m, leaf_size = slots.shape
    if is_leaf[0]:
        return None

    # BVH4 records per subtree: children of i are i+1 and skip[i+1], so a
    # reverse scan of the DFS order is post-order
    b4 = np.zeros(m, np.int64)
    leaf_pre = np.concatenate([[0], np.cumsum(is_leaf.astype(np.int64))])

    def children(i):
        return i + 1, int(skip[i + 1])

    for i in range(m - 1, -1, -1):
        if is_leaf[i]:
            continue
        cnt = 1
        for sub in children(i):
            if not is_leaf[sub]:
                for g in children(sub):
                    if not is_leaf[g]:
                        cnt += b4[g]
        b4[i] = cnt

    def sub_end(i) -> int:  # the subtree of i is [i, sub_end(i)) in DFS order
        return m if i == 0 else int(skip[i])

    def cost(i) -> int:
        n_leaves = int(leaf_pre[sub_end(i)] - leaf_pre[i])
        return _NODE4_F * int(b4[i]) + _SLOT_F * leaf_size * n_leaves

    if cost(0) <= budget_floats:
        return None  # one page is the one-level walk

    cut = np.zeros(m, bool)
    pages = []
    stack = [0]
    while stack:
        i = stack.pop()
        if is_leaf[i]:
            continue  # stays a top leaf
        if cost(i) <= budget_floats:
            cut[i] = True
            pages.append(i)
            continue
        left, right = children(i)
        stack.append(right)
        stack.append(left)
    if len(pages) > PAGES_MAX and budget_floats < PAGE_BUDGET_CEIL:
        return pack_paged(arrs, v0, v1, v2, nrm=nrm, uid=uid,
                          budget_floats=min(2 * budget_floats, PAGE_BUDGET_CEIL), device=device)
    if not 2 <= len(pages) <= PAGES_MAX:
        return None
    pages.sort()  # DFS order: pages are visited lowest index first
    page_index = {nid: k for k, nid in enumerate(pages)}
    codes = _split_codes(lo, hi, skip, is_leaf)

    # the top tree: pack_blobs4's emitter with leaf | page | inner children
    records, top_leaves, top_base, max_depth = [], [], {}, [1]

    def leaf_base(nid) -> float:
        if nid not in top_base:
            top_base[nid] = len(top_leaves) * leaf_size
            top_leaves.append(nid)
        return float(top_base[nid])

    def build_top(i: int, d: int) -> int:
        me = len(records)
        records.append(None)
        max_depth[0] = max(max_depth[0], d)
        left, right = children(i)
        child_slots = []
        for sub in (left, right):
            if is_leaf[sub] or cut[sub]:
                child_slots.extend([sub, None])
            else:
                child_slots.extend(children(sub))
        rec = np.zeros(_NODE4_F, np.float32)
        for c, nid in enumerate(child_slots):
            if nid is None:
                rec[6 * c: 6 * c + 6] = 3e38  # never hit
                rec[24 + c] = -1.0
                continue
            rec[6 * c: 6 * c + 3] = lo[nid]
            rec[6 * c + 3: 6 * c + 6] = hi[nid]
            if is_leaf[nid]:
                rec[24 + c] = leaf_base(nid)
            elif cut[nid]:
                rec[24 + c] = -(1.0 + PAGE_META_BASE + page_index[nid])
            else:
                rec[24 + c] = -(1.0 + build_top(nid, d + 1))
        rec[28] = codes[i]
        rec[29] = 0.0 if (is_leaf[left] or cut[left]) else codes[left]
        rec[30] = 0.0 if (is_leaf[right] or cut[right]) else codes[right]
        records[me] = rec
        return me

    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(limit, 8 * m + 1000))
    try:
        build_top(0, 1)
    finally:
        sys.setrecursionlimit(limit)
    top_tree = np.stack(records).astype(np.float32).reshape(-1)

    # the top leaves' slot records (pack_blobs' layout)
    v0, v1, v2 = (np.asarray(a, np.float32) for a in (v0, v1, v2))
    e1, e2 = v1 - v0, v2 - v0
    if nrm is None:
        n_ = np.cross(e1, e2)
        nrm_eff = n_ / np.maximum(np.linalg.norm(n_, axis=1, keepdims=True), 1e-30)
    else:
        nrm_eff = np.asarray(nrm, np.float32)
    rec = np.zeros((max(1, len(top_leaves)) * leaf_size, _SLOT_F), np.float32)
    rec[:, 9] = -1.0
    for k, nid in enumerate(top_leaves):
        row = slots[nid]
        valid = row >= 0
        tri = row[valid]
        rows = k * leaf_size + np.where(valid)[0]
        rec[rows, 0:3] = v0[tri]
        rec[rows, 3:6] = e1[tri]
        rec[rows, 6:9] = e2[tri]
        rec[rows, 9] = _pack_gid(tri, uid).astype(np.float32)
        rec[rows, 10:13] = nrm_eff[tri]
    top_slot = rec.reshape(-1)

    # each page: the one-level packers on its subtree slice
    page_trees, page_slots, pdepth = [], [], 1
    for r_node in pages:
        e = sub_end(r_node)
        sub = {"lo": lo[r_node:e], "hi": hi[r_node:e],
               "skip": np.clip(skip[r_node:e] - r_node, 0, e - r_node).astype(skip.dtype),
               "is_leaf": is_leaf[r_node:e], "slots": slots[r_node:e]}
        _t, s_np, _d = pack_blobs(sub, v0, v1, v2, nrm=nrm, uid=uid)
        q_np, d4, _ = pack_blobs4(sub)
        page_trees.append(q_np[0])
        page_slots.append(s_np[0])
        pdepth = max(pdepth, d4)

    def pad1024(c):  # the JAX package's page widths
        return -(-c // 1024) * 1024

    tc = pad1024(max(a.shape[0] for a in page_trees))
    sc = pad1024(max(a.shape[0] for a in page_slots))
    page_tree = np.zeros((len(pages), tc), np.float32)
    page_slot = np.zeros((len(pages), sc), np.float32)
    page_slot[:, 9::_SLOT_F] = -1.0  # padding: empty slot records
    for k, (a, b) in enumerate(zip(page_trees, page_slots)):
        page_tree[k, : a.shape[0]] = a
        page_slot[k, : b.shape[0]] = b
    return PagedBlobs(
        top_tree=_tensor(top_tree, device), top_slot=_tensor(top_slot, device),
        page_tree=_tensor(page_tree, device), page_slot=_tensor(page_slot, device),
        top_depth=int(max_depth[0]), page_depth=int(pdepth),
        page_lo=_tensor(lo[pages].astype(np.float32), device),
        page_hi=_tensor(hi[pages].astype(np.float32), device),
        page_root=_tensor(np.asarray(pages, np.int64), device))


def page_roots(arrs: dict, top_tree: np.ndarray, n_pages: int) -> np.ndarray:
    """The BVH2 node of each page of a top tree (``pack_paged``'s layout),
    read back by replaying its emitter: the record of BVH2 node ``i`` takes
    its child slots from ``i``'s children, one slot (and an empty one) for a
    leaf or a page, the two children of any other inner child."""
    skip, is_leaf = arrs["skip"], arrs["is_leaf"]
    rec = np.asarray(top_tree, np.float32).reshape(-1, _NODE4_F)
    roots = np.full(n_pages, -1, np.int64)
    stack = [(0, 0)]  # (top record, its BVH2 node)
    while stack:
        r, i = stack.pop()
        nids = []
        for sub in (i + 1, int(skip[i + 1])):
            # a page keeps its pair's second slot empty (meta −1)
            if is_leaf[sub] or rec[r, 24 + len(nids) + 1] == -1.0:
                nids.extend([sub, None])
            else:
                nids.extend([sub + 1, int(skip[sub + 1])])
        for c, nid in enumerate(nids):
            meta = float(rec[r, 24 + c])
            if nid is None or meta >= 0.0:
                continue
            if meta <= -(1.0 + PAGE_META_BASE):
                roots[int(-meta) - 1 - PAGE_META_BASE] = nid
            else:
                stack.append((int(-meta) - 1, nid))
    return roots


def pack_slot16(slot_rec: torch.Tensor) -> torch.Tensor:
    """The 13-float slot records padded to 16 floats each (v0, e1, e2, gid,
    normal, then three zeros): 64 B a slot, so a slot starts on a 16-byte
    boundary and reads as four 16-byte loads.  Stored floats unchanged."""
    rec = slot_rec.view(-1, _SLOT_F)
    return torch.nn.functional.pad(rec, (0, 16 - _SLOT_F)).reshape(-1).contiguous()


def pack_page_slot16(page_slot: torch.Tensor) -> torch.Tensor:
    """:func:`pack_slot16` applied to each page's row of ``page_slot``:
    ``(n_pages, SC // 13 · 16)``.  A row's ``SC`` floats are a multiple of
    1,024, not of 13; the part record at its end is padding that no leaf
    names, and is left out."""
    whole = page_slot.shape[1] // _SLOT_F * _SLOT_F
    return torch.stack([pack_slot16(row[:whole]) for row in page_slot])


def to_device(arrs: dict, v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, nrm: np.ndarray,
              uid: np.ndarray = None, device="cpu") -> FlatBVH:
    """A ``build_bvh`` result and its triangles as a :class:`FlatBVH` on
    ``device``.  ``nrm`` is the compiler's stored normal (``triangles.normal``),
    so the kernels' normals equal the plain gathers'; ``uid`` packs each
    triangle's unique-material id into its slot gid.  A tree whose one-level
    records exceed ``ONE_LEVEL_LIMIT`` floats also gets the paged layout,
    with its padded slot copy (:func:`pack_page_slot16`);
    any other gets the leaf coefficient table (``pack_leaf_mat``, 8 KB a
    leaf), which the paged walks never read."""
    v0, v1, v2 = (np.asarray(a, np.float32) for a in (v0, v1, v2))
    tree_np, slot_np, depth2 = pack_blobs(arrs, v0, v1, v2, nrm=nrm, uid=uid)
    nodes4, depth4, node2 = pack_blobs4(arrs)
    if nodes4 is None:
        nodes4, depth4, node2 = _root_leaf_node4(arrs), 1, np.zeros(1, np.int64)
    paged = leaf_mat = None
    if nodes4.size + slot_np.size > ONE_LEVEL_LIMIT:
        paged = pack_paged(arrs, v0, v1, v2, nrm=nrm, uid=uid, device=device)
    if paged is None:
        leaf_mat = _tensor(pack_leaf_mat(arrs, v0, v1, v2, nrm=nrm, uid=uid), device)
    else:
        paged = paged._replace(page_slot16=pack_page_slot16(paged.page_slot))
    slot_rec = _tensor(slot_np[0], device)
    return FlatBVH(lo=_tensor(arrs["lo"], device), hi=_tensor(arrs["hi"], device),
                   skip=_tensor(arrs["skip"], device), is_leaf=_tensor(arrs["is_leaf"], device),
                   slots=_tensor(arrs["slots"], device), nodes4=_tensor(nodes4[0], device),
                   slot_rec=slot_rec, depth4=int(depth4),
                   uid_packed=uid is not None, tree2=_tensor(tree_np[0], device),
                   depth2=int(depth2), node2=_tensor(node2, device), paged=paged,
                   leaf_mat=leaf_mat, slot16=pack_slot16(slot_rec))


# ---- plain walks -------------------------------------------------------------------
def _walk(bvh: FlatBVH, tris, ro: V3, rd: V3, t_min: float, bound, any_hit: bool,
          counts: Optional[dict], best_i=None, tri_offset: int = 0, lanes=None, start: int = 0,
          end: Optional[int] = None, page_of=None, leaf_mat=None):
    """The skip-link walk of every ray (``traverse_closest`` /
    ``traverse_any``).  Each step tests one node box per walking lane and,
    at a leaf whose box is hit, its ``LEAF_SIZE`` slots at once: the first
    slot with the least ``t`` below the running best wins, as the JAX
    walk's strict-``<`` slot loop decides.

    ``bound`` is the running best's seed (closest; ``best_i`` carries its
    winner, −1 by default) or the fixed limit (any), scalar or per ray.  A
    winning triangle's id is ``tri_offset + triangle``.  Only ``lanes`` (an
    index tensor; default all) walk, over the nodes ``[start, end)`` (a
    subtree in DFS order; default the whole tree).  ``page_of`` (per node: its
    page, −1 off the cut) makes it the paged top walk: a page root whose box
    the lane enters sets the lane's pending bit and is skipped.

    Returns ``(best_t, best_i)`` or the found mask, then, with ``page_of``,
    the pending words ``(plo, phi)`` (int32).  With ``leaf_mat`` (the leaf
    coefficient table) a leaf is tested by its linear forms
    (``_leaf_closest_mat`` / ``_leaf_any_mat``), the K10 walks' leaf visit."""
    n = ro.x.shape[0]
    m = bvh.n_nodes
    stop = m if end is None else end
    dev = ro.x.device
    best_t = torch.as_tensor(bound, dtype=torch.float32, device=dev).expand(n).clone()
    best_i = (torch.full((n,), -1, dtype=torch.int32, device=dev) if best_i is None
              else best_i.to(torch.int32).clone())
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    pend = torch.zeros(n, dtype=torch.int64, device=dev)
    v0 = torch.stack(tuple(tris.v0), -1)
    e1 = torch.stack(tuple(tris.v1), -1) - v0
    e2 = torch.stack(tuple(tris.v2), -1) - v0
    # the walking lanes' state, compacted as lanes finish
    ids = torch.arange(n, device=dev) if lanes is None else lanes
    o = torch.stack(tuple(ro), -1)[ids]
    d = torch.stack(tuple(rd), -1)[ids]
    iv = 1.0 / torch.where(torch.abs(d) > 1e-12, d, 1e-12)
    lim = best_t[ids]
    bt, bi, pd = best_t[ids], best_i[ids], pend[ids]
    feat = None
    if leaf_mat is not None:
        feat = leaf_features(ro, rd).T[ids]  # (lanes, 10), compacted with the lanes
        leaf_rank = torch.cumsum(bvh.is_leaf.long(), 0) - 1  # leaf g of each leaf node
        blocks = leaf_mat.view(16, -1, 8, LEAF_SIZE)  # (row, g, quantity, slot)
    cursor = torch.full((ids.numel(),), start, dtype=torch.int64, device=dev)
    boxes = torch.zeros((), dtype=torch.int64, device=dev)
    tests = torch.zeros((), dtype=torch.int64, device=dev)
    for _step in range(m + 1):  # a correct tree ends within m steps
        if ids.numel() == 0:
            break
        lo, hi = bvh.lo[cursor], bvh.hi[cursor]
        a, b = (lo - o) * iv, (hi - o) * iv
        near, far = torch.minimum(a, b), torch.maximum(a, b)
        enter = torch.maximum(torch.maximum(near[:, 0], near[:, 1]),
                              torch.clamp(near[:, 2], min=t_min))
        exit_ = torch.minimum(torch.minimum(far[:, 0], far[:, 1]),
                              torch.minimum(far[:, 2], lim if any_hit else bt))
        box_hit = enter <= exit_
        leaf = bvh.is_leaf[cursor] & box_hit
        boxes = boxes + ids.numel()
        done = torch.zeros_like(box_hit)
        rows = torch.nonzero(leaf)[:, 0]
        if rows.numel():
            slot = bvh.slots[cursor[rows]]  # (k, LEAF_SIZE)
            valid = slot >= 0
            ti = torch.clamp(slot, min=0).long()
            tests = tests + valid.sum()
            bound_k = (lim if any_hit else bt)[rows, None]
            if leaf_mat is None:
                t, win = _leaf_test(v0[ti], e1[ti], e2[ti], o[rows, None, :], d[rows, None, :],
                                    t_min, bound_k)
            else:
                # the rows and quantities the forms read: (10, k, 4, 16)
                coef = blocks[:10, leaf_rank[cursor[rows]], :4]
                forms = _forms(lambda r, q: coef[r, :, q], feat[rows].T[..., None])
                if any_hit:
                    t, win = None, _leaf_any_mat(*forms, t_min, bound_k)
                else:
                    t, win = _leaf_closest_mat(*forms, t_min, bound_k)
            win = win & valid
            if any_hit:
                done[rows] = win.any(1)
            else:
                t = torch.where(win, t, torch.inf)
                k = torch.argmin(t, dim=1)  # first occurrence of the least t
                tk = torch.gather(t, 1, k[:, None])[:, 0]
                take = torch.isfinite(tk)
                bt[rows] = torch.where(take, tk, bt[rows])
                gi = torch.gather(slot, 1, k[:, None])[:, 0] + tri_offset
                bi[rows] = torch.where(take, gi, bi[rows])
        descend = box_hit & ~bvh.is_leaf[cursor]
        if page_of is not None:  # a page root: pend it, never descend
            pg = page_of[cursor]
            at_page = descend & (pg >= 0)
            pd = pd | torch.where(at_page, torch.ones_like(pd) << pg.clamp(min=0), 0)
            descend = descend & ~at_page
        nxt = torch.where(descend, cursor + 1, bvh.skip[cursor].long())
        cursor = torch.where(done, stop, nxt)
        if any_hit:
            found[ids[done]] = True
        keep = cursor < stop
        fin = ids[~keep]
        best_t[fin], best_i[fin], pend[fin] = bt[~keep], bi[~keep], pd[~keep]
        sel = torch.nonzero(keep)[:, 0]
        ids, o, d, iv, lim, bt, bi, pd, cursor = (
            x[sel] for x in (ids, o, d, iv, lim, bt, bi, pd, cursor))
        if feat is not None:
            feat = feat[sel]
    # lanes cut by the step cap (a corrupted tree) keep their state so far
    best_t[ids], best_i[ids], pend[ids] = bt, bi, pd
    if counts is not None:
        counts["boxes"] = counts.get("boxes", 0) + int(boxes)
        counts["tri_tests"] = counts.get("tri_tests", 0) + int(tests)
    out = (found,) if any_hit else (best_t, best_i)
    if page_of is not None:
        out = out + (_word(pend & 0xFFFFFFFF), _word(pend >> 32))
    return out[0] if len(out) == 1 else out


def _word(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of int64 ``x`` as an int32 bit pattern."""
    x = x & 0xFFFFFFFF
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


def _leaf_test(v0, e1, e2, o, d, t_min, bound):
    """Möller–Trumbore of rays ``(k, 1, 3)`` against slots ``(k, L, 3)``:
    ``(t, hit in (t_min, bound))``, the JAX walk's formulation and epsilons."""
    def cross(a, b):
        return torch.stack((a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]), -1)

    def dot(a, b):
        return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]

    h = cross(d, e2)
    det = dot(e1, h)
    ok = torch.abs(det) > 1e-6
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    s = o - v0
    u = inv_det * dot(s, h)
    q = cross(s, e1)
    v = inv_det * dot(d, q)
    t = inv_det * dot(e2, q)
    hit = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) & (t < bound)
    return t, hit


def traverse_closest(bvh: FlatBVH, tris, ro: V3, rd: V3, t_min: float, t_max,
                     tri_offset: int = 0, counts: Optional[dict] = None, best_i=None,
                     leaf_mat=None):
    """Closest triangle hit by the skip-link walk: ``(best_t, best_idx)``
    with the global id ``tri_offset + triangle`` or −1.  Strict ``<``
    against the running best, so the winner equals a brute-force sweep's up
    to ties on exactly equal ``t`` (visit order is SAH order).  ``counts``
    (a dict) accumulates ``boxes`` and ``tri_tests``.  ``t_max`` and
    ``best_i`` may carry a best so far in (−1: none).  ``leaf_mat``: test
    the leaves by the coefficient table (K10's plain version)."""
    return _walk(bvh, tris, ro, rd, t_min, t_max, False, counts, best_i=best_i,
                 tri_offset=tri_offset, leaf_mat=leaf_mat)


def traverse_any(bvh: FlatBVH, tris, ro: V3, rd: V3, t_min: float, t_max,
                 counts: Optional[dict] = None, leaf_mat=None) -> torch.Tensor:
    """Is any triangle hit in ``(t_min, t_max)``?  A lane stops walking at
    its first accepted hit.  ``leaf_mat`` as for :func:`traverse_closest`."""
    return _walk(bvh, tris, ro, rd, t_min, t_max, True, counts, leaf_mat=leaf_mat)


# ---- the leaf coefficient table's tests (K10's plain versions) -----------------------
# the feature rows each linear form reads: det, u·det, v·det, t·det
_FORM_ROWS = ((0, 1, 2), (0, 1, 2, 3, 4, 5), (0, 1, 2, 3, 4, 5), (6, 7, 8, 9))


def leaf_features(ro: V3, rd: V3) -> torch.Tensor:
    """``(10, N)`` f32 ray features in ``pack_leaf_mat``'s row order:
    ``[d, m = o × d, o, 1]`` (the JAX ``_feat_matrix`` without its limit
    and zero rows)."""
    m = ro.cross(rd)
    return torch.stack((rd.x, rd.y, rd.z, m.x, m.y, m.z, ro.x, ro.y, ro.z, torch.ones_like(ro.x)))


def _forms(coef, f):
    """``(det, u·det, v·det, t·det)``: each quantity ``q``'s sum of
    ``coef(r, q) · f[r]`` over its feature rows, added in increasing row
    order (the K10 kernels add in the same order, so the two agree bit for
    bit).  The JAX product contracts all 16 rows; the others hold zeros."""
    out = []
    for q, rows in enumerate(_FORM_ROWS):
        acc = coef(rows[0], q) * f[rows[0]]
        for r in rows[1:]:
            acc = acc + coef(r, q) * f[r]
        out.append(acc)
    return out


def _mat_uv(det, un, vn):
    """``(ok, inside)``: ``|det| > 1e-6`` and the division-free barycentric
    test ``0 ≤ u·det² ≤ det²``, ``v·det² ≥ 0``, ``(u + v)·det² ≤ det²``
    (the JAX ``_leaf_closest_mxu`` / ``_leaf_any_mxu``)."""
    s2, ud, vd = det * det, un * det, vn * det
    ok = torch.abs(det) > 1e-6
    return ok, s2, ok & (ud >= 0.0) & (ud <= s2) & (vd >= 0.0) & (ud + vd <= s2)


def _leaf_closest_mat(det, un, vn, tn, t_min, bound):
    """``(t, hit in (t_min, bound))`` of the slots' forms: ``t = t·det /
    det``, one rounding.  The least ``t`` with ties to the lowest slot, kept
    only below the running best, is what ``_leaf_closest_mxu`` takes."""
    ok, _s2, inside = _mat_uv(det, un, vn)
    t = tn / torch.where(ok, det, 1.0)
    return t, inside & (t > t_min) & (t < bound)


def _leaf_any_mat(det, un, vn, tn, t_min, limit):
    """Hit in ``(t_min, limit)`` by the forms, division free:
    ``t_min·det² < t·det² < limit·det²`` (``_leaf_any_mxu``).  The limit is
    not a feature row: an infinite one occludes on any hit beyond ``t_min``,
    where the JAX product's ``0 · inf`` would make every form NaN."""
    _ok, s2, inside = _mat_uv(det, un, vn)
    td = tn * det
    return inside & (td > t_min * s2) & (td < limit * s2)


def _leaf_slot_of(bvh: FlatBVH) -> torch.Tensor:
    """The leaf-ordered slot (``16·g + k``) of each triangle."""
    flat = bvh.slots[bvh.is_leaf].reshape(-1)
    real = flat >= 0
    slot_of = torch.zeros(int(flat.max()) + 1, dtype=torch.int64, device=flat.device)
    slot_of[flat[real].long()] = torch.nonzero(real)[:, 0]
    return slot_of


def leaf_attrs(bvh: FlatBVH, ro: V3, rd: V3, tri: torch.Tensor):
    """``(u, v, stored normal V3)`` of each ray against its triangle ``tri``
    (local ids; other lanes get values nobody reads) from the leaf table, as
    the K10 closest walks emit them: ``u = u·det / det`` and ``v = v·det /
    det``, one rounding each, the forms as the walk computed them."""
    pos = _leaf_slot_of(bvh)[torch.clamp(tri, min=0).long()]
    col = (pos // LEAF_SIZE) * 128 + pos % LEAF_SIZE
    mat = bvh.leaf_mat
    det, un, vn, _tn = _forms(lambda r, q: mat[r][col + 16 * q], leaf_features(ro, rd))
    safe = torch.where(det != 0.0, det, 1.0)
    return un / safe, vn / safe, V3(*(mat[9][col + 16 * q] for q in (4, 5, 6)))


def _page_of(bvh: FlatBVH) -> torch.Tensor:
    pg = bvh.paged
    page_of = torch.full((bvh.n_nodes,), -1, dtype=torch.int64, device=bvh.skip.device)
    page_of[pg.page_root] = torch.arange(pg.n_pages, device=page_of.device)
    return page_of


def pend_mask(plo: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """The two pending words as one int64 mask, bit ``p`` for page ``p``."""
    return (phi.long() << 32) | (plo.long() & 0xFFFFFFFF)


def page_root_mask(pg: PagedBlobs, ro: V3, rd: V3, t_min: float, far) -> torch.Tensor:
    """The JAX package's ``_page_root_slab`` for every page: an int64 mask
    whose bit ``p`` says the ray enters page ``p``'s root box in
    ``(t_min, far)`` (the kernels' slab formula, on the same box floats)."""
    iv = [1.0 / torch.where(torch.abs(c) > 1e-12, c, 1e-12) for c in rd]
    mask = torch.zeros(ro.x.shape[0], dtype=torch.int64, device=ro.x.device)
    for p in range(pg.n_pages):
        a = [(pg.page_lo[p, k] - ro[k]) * iv[k] for k in range(3)]
        b = [(pg.page_hi[p, k] - ro[k]) * iv[k] for k in range(3)]
        near = [torch.minimum(x, y) for x, y in zip(a, b)]
        far_ = [torch.maximum(x, y) for x, y in zip(a, b)]
        enter = torch.maximum(torch.maximum(near[0], near[1]), torch.clamp(near[2], min=t_min))
        exit_ = torch.minimum(torch.minimum(far_[0], far_[1]), torch.minimum(far_[2], far))
        mask = mask | ((enter <= exit_).long() << p)
    return mask


def paged_top(bvh: FlatBVH, tris, ro: V3, rd: V3, t_min: float, bound, any_hit: bool = False,
              best_i=None, found=None, tri_offset: int = 0, counts: Optional[dict] = None):
    """The plain top walk of a paged tree (K6a / K6b): the skip-link walk,
    where a page root whose box the lane enters at its running best sets the
    lane's bit in ``(plo, phi)`` and the lane jumps past the page.  Closest:
    ``bound``/``best_i`` carry the best so far; returns ``(best_t, best_i,
    plo, phi)``.  Any: ``bound`` is the limit and lanes already ``found`` do
    not walk; returns ``(found, plo, phi)``."""
    if not any_hit:
        return _walk(bvh, tris, ro, rd, t_min, bound, False, counts, best_i=best_i,
                     tri_offset=tri_offset, page_of=_page_of(bvh))
    walked, plo, phi = _walk(bvh, tris, ro, rd, t_min, bound, True, counts,
                             lanes=torch.nonzero(~found)[:, 0], page_of=_page_of(bvh))
    return found | walked, plo, phi


def pages(bvh: FlatBVH, tris, ro: V3, rd: V3, t_min: float, bound, plo, phi,
          any_hit: bool = False, best_i=None, found=None, tri_offset: int = 0,
          counts: Optional[dict] = None):
    """The plain page walk (K6c / K6d): for page ``p`` in increasing order,
    each lane whose bit ``p`` is set walks the page's subtree
    ``[root, skip[root])`` from its carried best; the walk's first step, the
    root's box against that best, is ``_page_root_slab``'s cull.  Closest
    returns ``(best_t, best_i)``; any returns ``found`` (a found lane walks
    no further)."""
    pg = bvh.paged
    pend = pend_mask(plo, phi)
    best_t = torch.as_tensor(bound, dtype=torch.float32, device=ro.x.device).expand(
        ro.x.shape[0])
    for p, root in enumerate(pg.page_root.tolist()):
        want = ((pend >> p) & 1).bool()
        if any_hit:
            want = want & ~found
        lanes = torch.nonzero(want)[:, 0]
        if lanes.numel() == 0:
            continue
        end = int(bvh.skip[root])
        if any_hit:
            found = found | _walk(bvh, tris, ro, rd, t_min, best_t, True, counts, lanes=lanes,
                                  start=root, end=end)
        else:
            best_t, best_i = _walk(bvh, tris, ro, rd, t_min, best_t, False, counts,
                                   best_i=best_i, tri_offset=tri_offset, lanes=lanes,
                                   start=root, end=end)
    return found if any_hit else (best_t, best_i)


# ---- the multipass walk's plain parts ------------------------------------------------
def subtree_nodes(nodes4: torch.Tensor):
    """``(ids (16,) int32, valid (16,) bool)``: the BVH4 nodes of the root's
    grandchildren in ``4·c0 + c1`` order (the JAX package's
    ``_subtree_nodes``).  Invalid where the slot is empty or the child at
    depth 1 or 2 is a leaf: the cleanup pass answers those lanes."""
    meta = nodes4.view(-1, _NODE4_F)[:, 24:28]
    j = torch.clamp((-meta[0]).to(torch.int32) - 1, min=0)
    inner0 = (meta[0] < 0.0) & (j >= 1)
    meta1 = meta[j.long()]  # (4, 4): row c0 holds the metas of child c0's record
    node1 = (-meta1).to(torch.int32) - 1
    return (torch.clamp(node1, min=0).reshape(16),
            (inner0[:, None] & (meta1 < 0.0) & (node1 >= 1)).reshape(16))


def _slab_keys(rec: torch.Tensor, ro: V3, rd: V3) -> torch.Tensor:
    """``(N, 4)``: does each ray enter each child box of the BVH4 record
    ``rec`` within ``(1e-3, 1e6)``?  (The JAX package's ``_slab_key``.)"""
    box = rec[:24].view(1, 4, 6)
    o = torch.stack(tuple(ro), -1)[:, None, :]
    d = torch.stack(tuple(rd), -1)[:, None, :]
    iv = 1.0 / torch.where(torch.abs(d) > 1e-12, d, 1e-12)
    a, b = (box[..., 0:3] - o) * iv, (box[..., 3:6] - o) * iv
    near, far = torch.minimum(a, b), torch.maximum(a, b)
    enter = torch.clamp(near.amax(-1), min=1e-3)
    exit_ = torch.clamp(far.amin(-1), max=1e6)
    return enter <= exit_


def _child_ranks(rec: torch.Tensor, rd: V3) -> torch.Tensor:
    """``(N, 4)`` int32: each child's rank (0..3) in the ray's own
    near-first visit order of the BVH4 record ``rec`` (the JAX package's
    ``_child_ranks``, mirroring the walk's push order)."""
    k = rec[28:31].to(torch.int32)
    d = torch.stack(tuple(rd), -1)[:, (k % 4).long()]
    p0n, c0n, c2n = ((d > 0.0) ^ (k // 4 > 0)).unbind(1)
    zero = torch.zeros_like(k[0])
    pair0 = torch.where(p0n, zero, 2)
    pair1 = torch.where(p0n, 2, zero)
    return torch.stack((pair0 + torch.where(c0n, zero, 1), pair0 + torch.where(c0n, 1, zero),
                        pair1 + torch.where(c2n, zero, 1), pair1 + torch.where(c2n, 1, zero)), 1)


def subtree_keys2(nodes4: torch.Tensor, ro: V3, rd: V3):
    """Per-ray ``(s1, s2)`` int32: the first and second depth-2 subtrees
    (``4·c0 + c1``; 16 = none) that the ray enters in its own near-first
    order (the JAX package's ``_subtree_keys2``).  A prediction only: a
    wrong one moves work into the cleanup pass and changes no result."""
    recs = nodes4.view(-1, _NODE4_F)
    hits0, ranks0 = _slab_keys(recs[0], ro, rd), _child_ranks(recs[0], rd)
    meta0 = recs[0, 24:28]
    j = torch.clamp((-meta0).to(torch.int32) - 1, min=0).long()
    first = torch.arange(4, device=nodes4.device) == 0  # a leaf child is one unit at (c0, 0)
    rank16 = []
    for c0 in range(4):
        inner = meta0[c0] < 0.0
        rec = recs[j[c0:c0 + 1]][0]  # a one-element index: no host read (CUDA graph capture)
        hit = hits0[:, c0:c0 + 1] & torch.where(inner, _slab_keys(rec, ro, rd), first)
        rank = ranks0[:, c0:c0 + 1] * 4 + torch.where(inner, _child_ranks(rec, rd), 0)
        rank16.append(torch.where(hit, rank, 99))
    rank16 = torch.cat(rank16, 1)
    none = torch.full_like(rank16[:, 0], 16)

    def argmin16(r):  # the first least rank below 99, else 16
        best, arg = r.min(1)
        return torch.where(best < 99, arg.to(torch.int32), none)

    s1 = argmin16(rank16)
    lane16 = torch.arange(16, device=nodes4.device)
    return s1, argmin16(torch.where(lane16 == s1[:, None], 99, rank16))


def rooted(bvh: FlatBVH, tris, ro: V3, rd: V3, t_min: float, roots, en, best_t, best_i,
           counts: Optional[dict] = None):
    """One plain multipass pass (K11's plain version): each lane with ``en``
    walks the BVH2 subtree that its BVH4 root ``roots`` collapses,
    ``[node2, skip[node2])``, from its carried ``(best_t, best_i)``, one
    group of lanes per distinct root; other lanes pass through."""
    for r in torch.unique(roots[en]).tolist():
        i = int(bvh.node2[r])
        best_t, best_i = _walk(bvh, tris, ro, rd, t_min, best_t, False, counts, best_i=best_i,
                               lanes=torch.nonzero(en & (roots == r))[:, 0], start=i,
                               end=bvh.n_nodes if i == 0 else int(bvh.skip[i]))
    return best_t, best_i
