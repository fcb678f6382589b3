"""How deep the port's binned-SAH BVH4 gets on adversarial triangle soups.

    python experiments/bvh4_depth.py

The JAX package walks its BVH2 skip-link kernels (K4e,
``ops/pallas/bvh_pallas.py:418``, ``:479``, ``:585``, ``:639``) only when the
BVH4 route is refused (``_quad_ok``, ``bvh_pallas.py:2079-2087``): ``BVH_QUAD``
off, a root that is a leaf (at most ``LEAF_SIZE`` triangles), or a BVH4
deeper than 63.  The port's per-thread BVH4 walks hold 32 levels
(``csrc/bvh_walk.cuh``, ``kMaxDepth4``).  This script builds fans and strips
whose vertex coordinates grow geometrically (log-spaced up to 3e35, so that
every SAH split peels off a sliver), with 1,024 to 4,096 triangles, through
both of the port's builders (``native/`` and numpy), and prints the BVH2 node
count and the BVH4 depth of each.  CPU only.
"""
import numpy as np

from path_tracing__ray_tracer_tpu_torch.ops import bvh


def soup(kind: str, n: int):
    """``(v0, v1, v2)`` of a fan about the origin or a strip along x, with
    log-spaced coordinates from 1 to 3e35."""
    r = np.logspace(0.0, np.log10(3e35), n + 1)
    z = np.zeros(n)
    if kind == "fan":
        ang = np.linspace(0.0, 1.5, n + 1)
        v0 = np.zeros((n, 3))
        v1 = np.stack([r[:-1] * np.cos(ang[:-1]), r[:-1] * np.sin(ang[:-1]), z], 1)
        v2 = np.stack([r[1:] * np.cos(ang[1:]), r[1:] * np.sin(ang[1:]), z], 1)
    else:
        v0 = np.stack([r[:-1], z, z], 1)
        v1 = np.stack([r[1:], z, z], 1)
        v2 = np.stack([r[:-1], r[:-1] * 0.5, z + 1.0], 1)
    return (v.astype(np.float32) for v in (v0, v1, v2))


def main():
    deepest = 0
    for kind in ("fan", "strip"):
        for n in (1024, 2048, 4096):
            v0, v1, v2 = soup(kind, n)
            lo, hi = np.minimum(np.minimum(v0, v1), v2), np.maximum(np.maximum(v0, v1), v2)
            for native in (True, False):
                arrs = bvh.build_bvh(lo, hi, use_native=native)
                _nodes4, depth4, _node2 = bvh.pack_blobs4(arrs)
                deepest = max(deepest, depth4)
                print(f"{kind:5s} {n:5d} triangles, {'native' if native else 'numpy '} builder: "
                      f"BVH2 {arrs['lo'].shape[0]:5d} nodes, BVH4 depth {depth4}")
    print(f"deepest BVH4: {deepest} (the port's walks hold 32 levels, the JAX BVH4 route 63)")


if __name__ == "__main__":
    main()
