"""Wavefront Monte-Carlo path tracer — port of the JAX package's
``models/path_tracer.py`` (reference ``renderers/cuda_path_tracer.py``):
global illumination with next-event estimation, Russian roulette, the
stochastic three-event glass model and ACES tonemapping, with the
reference's stylized-physics quirks (see the JAX module's docstring).

Each bounce is one launch of the CUDA kernel ``ops/cuda/bounce.path_bounce``
(K1) or, on a BVH scene, of ``ops/cuda/bounce_bvh.path_bounce_bvh`` (K5 and
its K4b shadow walk); a BVH scene that K5 does not take (textured
triangles, no unique-material table) runs ``path_bounce_plain``, whose
intersections launch K4a and K4b.  A paged BVH (a big scene, such as
``--scene mesh_big``'s 128,000 triangles) also runs ``path_bounce_plain``,
as the JAX package's ``bounce_bvh_ok`` sends it there: its closest hit and
shadow rays launch the two-level walk (K6a + K6c, K6b + K6d).  So does a
scene whose triangles take the split route (``ops/cuda/bvh.tri_route``: a
BVH4 deeper than the walks' stack, or the route flags set): its queries
launch K4c/K4d, K11 or the BVH2 walks K4e.  On the CPU
each takes its plain torch version.  Between bounces plain torch ops
resolve the base colour (atlas texel or material colour; the atlas gather
K8 when ``ops/cuda/texture.fits_mxu_atlas`` holds), apply the two
multiply-adds, and regenerate finished lanes.  Randomness is the counter
hash: a pure function of (seed, pixel, sample, depth, use).

The scheduler's modes (deferred texture, texture LOD, the fused step K7)
are gated in ``models/experimental.py``, as in the JAX package: the
texture modes run in ``_regen_loop`` beside the default resolve, the fused
step in its own loop there.

On the card the bounces between two host checks (a *bounce block*, the
JAX package's K-step ``fori_loop`` inside its ``while_loop``) replay as one
CUDA graph: the lane state lives in fixed buffers of a few bucket widths,
and the chunk's camera, pixel offset, seed and sample base are device
tensors that the host fills before each chunk, so one graph per bucket
serves every chunk and sample group of a frame (the counterpart of the JAX
package's jitted chunk, ``lax.map`` and fused group loop).  ``_GRAPH_BLOCKS
= False`` runs the same blocks eagerly; the CPU always does.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from ..ops import rng
from ..ops import texture as _texture
from ..ops.cuda import capture
from ..ops.camera import generate_rays
from ..ops.cuda.bounce import T_MAX, T_MIN, path_bounce, path_bounce_plain
from ..ops.cuda.bounce_bvh import path_bounce_bvh
from ..ops.cuda.bvh import tri_route
from ..ops.cuda.texture import fits_mxu_atlas, resolve_base_color_mxu, texel_index
from ..ops.texture import _unpack_rgb, resolve_base_color, resolve_base_color_lod
from ..ops.tonemap import aces
from ..ops.v3 import V3
from ..utils.logging import log_event
from ..utils.profiling import count, span
from .base import RendererFactory
from .wavefront import WavefrontRenderer, scene_blobs

# jitter slots live at depth == max_depth (outside the bounce counter range)
_U_JITX, _U_JITY = 0, 1

# Scheduling knobs of _regen_chunk; none of them changes a pixel.  The host
# reads the count of unfinished lanes once every _CHECK_EVERY bounces (one
# device sync each); when at most half the lanes are still working, the
# batch is compacted to the smallest bucket of _BUCKET_MIN·2^j lanes that
# holds them.
_CHECK_EVERY = 4
_COMPACT_BELOW = 0.5
_BUCKET_MIN = 1024

# Replay each bounce block as a CUDA graph on the card (False: run the same
# blocks eagerly there, to compare the two); read at each chunk.
_GRAPH_BLOCKS = True

# Fused in-kernel regeneration (the pipe mode of models/experimental.py):
# each bounce is one launch of K7, which also runs the glue between bounces.
# Off by default, as in the JAX package, which measured it flat on its TPU;
# read at each chunk.
_PIPE_REGEN = False


def bounce_fn(cs, blobs):
    """``bounce(o, d, thr, key, depth, shadow_light) -> BounceOut`` for
    ``cs`` and its packed tables ``blobs`` (``WavefrontRenderer.blobs``):
    K1 for a scene without a BVH, K5 for one that K5 takes on the ``fused``
    triangle route (``ops/cuda/bvh.tri_route``, as the JAX package's
    ``bounce_bvh_ok`` asks ``_scene_fused_ok``), else the plain bounce, whose
    queries take the BVH route (the JAX package's
    ``_make_bounce_and_resolve``)."""
    if cs.bvh is None:
        return lambda o, d, thr, key, depth, shadow_light: path_bounce(
            cs, *blobs, o, d, thr, key, depth, T_MIN, T_MAX, shadow_light)
    if blobs is not None and tri_route(cs) == "fused":
        return lambda o, d, thr, key, depth, shadow_light: path_bounce_bvh(
            cs, blobs, o, d, thr, key, depth, T_MIN, T_MAX, shadow_light)
    return lambda o, d, thr, key, depth, shadow_light: path_bounce_plain(
        cs, o, d, thr, key, depth, T_MIN, T_MAX, shadow_light)


def resolve_fn(cs, n_pix: int):
    """``resolve(out) -> base colour`` of a bounce record for a chunk of
    ``n_pix`` lanes: the atlas gather K8 where the JAX package's gate holds
    (``fits_mxu_atlas`` and a chunk of whole 1024-lane blocks), else the
    plain resolve.  Both give the same colours bit for bit."""
    if fits_mxu_atlas(cs) and n_pix % 1024 == 0:
        return lambda out: resolve_base_color_mxu(cs, out.mat_color, out.tex_id, out.u, out.v)
    return lambda out: resolve_base_color(cs, out.mat_color, (out.tex_id >= 0.0).to(torch.float32),
                                          out.tex_id.to(torch.int32), out.u, out.v)


def item_stride(n_pix: int, n_samples: int) -> int:
    """Lane ``i``'s ``s``-th item is pixel ``(i + s·stride) mod n_pix``."""
    return (int(n_pix * 0.6180339887) | 1) % n_pix if n_samples > 1 else 0


def camera_rays(cam12, lane_ids, s, *, pix0, seed, sample_base, n_pix: int, stride: int,
                width: int, height: int, max_depth: int, jitter: str):
    """Camera ray, RNG key and pixel slot of lane ``lane_ids``' item ``s``.
    Out-of-frame lanes clamp to the last pixel but hash their unclamped
    index; the jitter draws sit at depth ``max_depth``, slots 0 and 1.
    ``pix0``, ``seed`` and ``sample_base`` are Python ints or 0-d int64
    tensors on the lanes' device (the same bits: a captured bounce block
    reads them from the device, so one graph serves every chunk)."""
    p_local = (lane_ids + s * stride) % n_pix
    idx = pix0 + p_local
    safe = torch.clamp(idx, max=width * height - 1)
    x = (safe % width).to(torch.float32)
    y = (safe // width).to(torch.float32)
    key = rng.ray_key(seed, idx, sample_base + s)
    if jitter == "center":
        r1 = r2 = 0.5
    else:
        r1 = rng.uniform(key, max_depth, _U_JITX)
        r2 = r1 if jitter == "diagonal" else rng.uniform(key, max_depth, _U_JITY)
    o, d = generate_rays(cam12, (x + r1) / width, (y + r2) / height)
    return o, d, key, p_local


def _take_lanes(state, sel):
    """The lanes ``sel`` of a lane state (a dict of lane tensors and ``V3``s)."""
    return {k: x.take(sel) if isinstance(x, V3) else x[sel] for k, x in state.items()}


def _parts(x):
    return tuple(x) if isinstance(x, V3) else (x,)


def _copy_lanes(dst, src) -> None:
    for name, buf in dst.items():
        for b, x in zip(_parts(buf), _parts(src[name])):
            b.copy_(x)


def _empty_lanes(state, width: int):
    def empty(t):
        return torch.empty((width,), dtype=t.dtype, device=t.device)

    return {k: V3(*map(empty, x)) if isinstance(x, V3) else empty(x) for k, x in state.items()}


def bucket_width(n_left: int, n_pix: int) -> int:
    """The smallest bucket, ``_BUCKET_MIN·2^j`` lanes, that holds ``n_left``
    lanes, capped at the chunk's ``n_pix``."""
    width = max(1, _BUCKET_MIN)
    while width < n_left:
        width *= 2
    return min(width, n_pix)


class BounceBlocks:
    """The lane buffers of one chunk shape, one set per bucket width, and
    the bounce block over them: ``k`` bounces of ``step`` (one bounce, from
    a lane state to the next; the JAX K-step ``fori_loop``), whose result is
    copied back into the buffers (``copy_``, so every tensor that outlives a
    block is written inside it).  A block makes no host read and reads no
    Python value that changes between chunks.  It also marks which lanes
    are unfinished before each of its bounces but the first
    (``unfinished``), which the host check sums with its own count for
    ``lanes.live``.

    With ``graphed`` (the card), each bucket's block is captured once as a
    CUDA graph (``ops/cuda.capture``) and replayed after; each replay adds the
    launches its capture counted onto the wrappers, so the counts equal the
    eager loop's.  Each graph keeps its own memory pool."""

    def __init__(self, step, k: int, n_samples: int, graphed: bool, device):
        self.step, self.k, self.graphed, self.device = step, int(k), bool(graphed), device
        self.n_samples = int(n_samples)  # a lane is unfinished while s < n_samples
        self.buffers = {}  # width -> lane state
        # width -> (k, width) bool, the lanes unfinished before each bounce of
        # a block: row 0 written by the host check, rows 1.. inside the block
        self.unfinished = {}
        self.graphs = {}  # width -> (CUDAGraph, launches)

    def load(self, width: int, state):
        """Copy ``state`` into the buffers of ``width`` lanes (allocated at
        their first use) and return them."""
        if width not in self.buffers:
            self.buffers[width] = _empty_lanes(state, width)
            self.unfinished[width] = torch.zeros((max(self.k, 1), width), dtype=torch.bool,
                                                 device=state["s"].device)
        _copy_lanes(self.buffers[width], state)
        return self.buffers[width]

    def _block(self, state) -> None:
        rows = self.unfinished[int(state["s"].shape[0])]
        cur = state
        for j in range(1, self.k + 1):
            cur = self.step(cur)
            if j < self.k:
                torch.lt(cur["s"], self.n_samples, out=rows[j])
        _copy_lanes(state, cur)

    def drive(self, state, max_bounces: int) -> None:
        """Run blocks from ``state``, a chunk's first lane state, until every
        lane has finished its ``n_samples`` items (``s == n_samples``).
        Between blocks the host reads the count of unfinished lanes (one
        device sync a block); when at most ``_COMPACT_BELOW`` of the pool is
        unfinished, it gathers the pool into the smallest bucket that holds
        them (:func:`bucket_width`): the unfinished lanes first, then
        finished ones, which are never active, write only their own dump
        column of the accumulator and fold nothing (the JAX tail's ``valid``
        mask).  Each lane's path depends on no other lane, so the sums are
        those of the exact compaction bit for bit.  Raises when lanes are
        left after ``max_bounces``.

        Spans (``utils/profiling``): ``drive``; per block ``block.wait`` (the
        host blocked on the previous block's counts), ``block.host`` (from
        those counts to the next launch, ``block.compact`` within it);
        counters ``lanes.slots`` (the bucket's lanes each bounce runs over)
        and ``lanes.live`` (the unfinished ones before each bounce, read
        with the count of the next check)."""
        with span("drive"):
            n_pix = int(state["s"].shape[0])
            width = n_pix
            st = self.load(width, state)
            blocks, n_left = 0, None
            while True:
                with span("block.wait"):
                    rows = self.unfinished[width]
                    left = torch.lt(st["s"], self.n_samples, out=rows[0])
                    counts = rows.sum(dim=1).tolist()  # host sync
                if n_left is not None:  # the block just run, before each of its bounces
                    count("lanes.live", n_left + sum(counts[1:]))
                n_left = counts[0]
                if n_left == 0:
                    return
                with span("block.host"):
                    if blocks > max_bounces // self.k:
                        raise RuntimeError(f"path tracer: {n_left} lanes unfinished after "
                                           f"{blocks * self.k} bounces")
                    if n_left <= _COMPACT_BELOW * width and bucket_width(n_left, n_pix) < width:
                        with span("block.compact"):
                            width = bucket_width(n_left, n_pix)
                            sel = torch.argsort((~left).to(torch.int8), stable=True)[:width]
                            st = self.load(width, _take_lanes(st, sel))
                    count("lanes.slots", width * self.k)
                self.run(width)
                blocks += 1

    def run(self, width: int) -> None:
        """One block on the buffers of ``width`` lanes: eager (span
        ``block.eager``), captured (the bucket's first block on the card;
        ``graph.capture``) or replayed (``block.replay``)."""
        state = self.buffers[width]
        if not self.graphed:
            with span("block.eager"):
                self._block(state)
        elif width not in self.graphs:
            with span("graph.capture"):
                self.graphs[width] = capture(lambda: self._block(state), self.device)
        else:
            with span("block.replay"):
                graph, launches = self.graphs[width]
                graph.replay()
                for wrapper, n in launches:
                    wrapper.launches += n


def block_plan(graphs, key, make):
    """The cached plan of ``key`` in ``graphs`` (a renderer's cache; None:
    no cache, a plan for this call only), made by ``make()`` at its first
    use."""
    if graphs is None:
        return make()
    if key not in graphs:
        graphs[key] = make()
    return graphs[key]


def graph_gate(cs) -> Optional[str]:
    """Why the bounce blocks of ``cs`` run eagerly on the card, or None when
    they are captured.  One setting cannot be captured: ``TEX_COMPACT``,
    whose compacted texel gather counts the textured lanes on the host
    every bounce (``ops/texture._gather_texels_compact``)."""
    if _texture.TEX_COMPACT and cs.any_textured.shape[0] > 0:
        return "ops/texture.TEX_COMPACT reads the host every bounce"
    return None


def graphed(device, cs) -> bool:
    """Are the bounce blocks of ``cs`` on ``device`` captured?  On the card
    with ``_GRAPH_BLOCKS`` and no gate (:func:`graph_gate`); never on the
    CPU.  Asked once per plan; a plan that the gate keeps eager on the card
    logs ``graphs_declined`` with the reason."""
    if device.type != "cuda" or not _GRAPH_BLOCKS:
        return False
    reason = graph_gate(cs)
    if reason is not None:
        log_event("graphs_declined", reason=reason, device=str(device))
    return reason is None


def scheduler_key(device, *shape):
    """The cache key of a chunk shape's plan: the shape, the device and
    every module knob the bounce block reads (``parallel/workers.KNOBS``),
    since a captured block freezes the routes they pick."""
    from ..parallel.workers import knob_values

    return (str(device), *shape, tuple(sorted(knob_values().items())))


def rebin(sums, acc, col0: int, n_pix: int, n_samples: int) -> None:
    """Add each pixel's items onto ``sums[:, col0:col0 + n_pix]`` in
    ascending sample order."""
    chunk = sums[:, col0:col0 + n_pix]
    for si in range(n_samples):
        chunk += acc[:, si * n_pix:(si + 1) * n_pix]


def _regen_chunk(cs, blobs, cam12, sums, pix0: int, seed: int, sample_base: int, *,
                 n_pix: int, width: int, height: int, n_samples: int, max_depth: int,
                 jitter: str, shadow_tmax: str = "reference", lod_depth: int = 0,
                 col0: Optional[int] = None, graphs: Optional[dict] = None) -> None:
    """Add ``n_samples`` radiance samples for the pixels
    ``[pix0, pix0 + n_pix)`` into ``sums[:, col0:col0 + n_pix]`` (``col0``
    defaults to ``pix0``: ``sums`` is the frame's), by *ray regeneration*: a
    pool of ``n_pix`` lanes in which a lane that finishes a path (miss / RR
    kill / throughput cutoff / max depth) starts its next (pixel, sample)
    item at once.

    Lane ``i``'s ``s``-th item is pixel ``(i + s·STRIDE) mod n_pix``: the
    golden-ratio stride spreads the slow pixels (glass) over all lanes.

    What defines the result (equal to the JAX package's ``_regen_chunk``):
    each item's path sum is the left fold of its per-bounce contributions;
    each pixel adds its items onto ``sums`` in ascending sample order; the
    jitter draws sit at depth ``max_depth``, slots 0 and 1.  Each lane
    carries its item's running sum and parks it in ``acc[sample, pixel]``
    when the item finishes, so the fold order holds whatever the lane
    schedule, stride, compaction or chunk width.  Out-of-frame lanes clamp
    to the last pixel but hash their unclamped index; the caller cuts them.

    ``graphs``: the cache of the plans (lane buffers, accumulator, captured
    bounce blocks) of each chunk shape, kept by the renderer so that every
    chunk and sample group of a frame replays the same graphs; None makes
    them for this call only.

    A mode (``_PIPE_REGEN``; ``lod_depth`` > 0; a scene with a mip atlas)
    goes through ``models/experimental.regen_chunk_modes``, the JAX
    package's mode gate, which runs the pipe's own loop or
    :func:`_regen_loop` with a texture mode.
    """
    kw = dict(n_pix=n_pix, width=width, height=height, n_samples=n_samples,
              max_depth=max_depth, jitter=jitter, shadow_tmax=shadow_tmax,
              col0=pix0 if col0 is None else col0, graphs=graphs)
    if _PIPE_REGEN or lod_depth > 0 or cs.mip_atlas is not None:
        from .experimental import regen_chunk_modes

        return regen_chunk_modes(cs, blobs, cam12, sums, pix0, seed, sample_base,
                                 lod_depth=lod_depth, **kw)
    _regen_loop(cs, blobs, cam12, sums, pix0, seed, sample_base, **kw)


class RegenPlan(NamedTuple):
    """What the bounce blocks of one chunk shape read besides the lane
    state: the camera and the chunk's scalars (0-d int64 tensors the host
    fills before each chunk), the accumulators (zeroed for each chunk), and
    the blocks."""
    cam: torch.Tensor
    pix0: torch.Tensor
    seed: torch.Tensor
    sample_base: torch.Tensor
    acc: torch.Tensor
    acc_idx: Optional[torch.Tensor]  # the camera bounce's texel of each item (deferred mode)
    make_ray: object
    blocks: BounceBlocks


def _regen_plan(cs, blobs, dev, *, n_pix: int, width: int, height: int, n_samples: int,
                max_depth: int, jitter: str, shadow_tmax: str, lod_depth: int,
                mip_resolve) -> RegenPlan:
    NS, N = n_samples, n_pix
    defer = mip_resolve is not None
    bounce = bounce_fn(cs, blobs)
    resolve = resolve_fn(cs, N)
    shadow_light = shadow_tmax == "light"
    stride = item_stride(N, NS)
    cam = torch.zeros((12,), dtype=torch.float32, device=dev)
    pix0, seed, sample_base = (torch.zeros((), dtype=torch.int64, device=dev) for _ in range(3))
    # finished item sums by (sample, pixel slot), then B in deferred mode;
    # row NS catches the lanes that finish nothing in a bounce (each at its
    # own slot: no duplicates)
    acc = torch.zeros((6 if defer else 3, (NS + 1) * N), dtype=torch.float32, device=dev)
    acc_idx = torch.zeros(((NS + 1) * N,), dtype=torch.int32, device=dev) if defer else None

    def make_ray(lane_ids, s):
        return camera_rays(cam, lane_ids, s, pix0=pix0, seed=seed, sample_base=sample_base,
                           n_pix=N, stride=stride, width=width, height=height,
                           max_depth=max_depth, jitter=jitter)

    def step(st):
        """One bounce of every lane: the lane state after it."""
        thr, psum, depth, s, lane = st["thr"], st["psum"], st["depth"], st["s"], st["lane"]
        if defer:
            e, b0m, psum_b, idx0 = st["e"], st["b0m"], st["psum_b"], st["idx0"]
        active = s < NS
        out = bounce(st["o"], st["d"], V3.where(e, thr * b0m, thr) if defer else thr, st["key"],
                     depth, shadow_light)
        if defer:
            base = mip_resolve(out)
            defer_now = (depth == 0) & (out.tex_id >= 0.0)
            full = thr * out.w_sky + thr * (base * out.w_nee)
            contrib = V3.where(defer_now, thr * out.w_sky,
                               V3(*(torch.where(e, 0.0, ch) for ch in full)))
            contrib_b = V3.where(defer_now, thr * out.w_nee,
                                 V3(*(torch.where(e, ch, 0.0) for ch in full)))
            psum_b = V3.where(active, psum_b + contrib_b, psum_b)
            idx0 = torch.where(active & defer_now, texel_index(cs, out.tex_id, out.u, out.v), idx0)
            base_thr = V3.where(defer_now, V3(*(torch.ones_like(out.u),) * 3), base)
            e = torch.where(defer_now, out.t_thr > 0.0, e)
            b0m = V3.where(defer_now, base, b0m)
        else:
            if lod_depth > 0:
                base = resolve_base_color_lod(cs, out.mat_color, out.tex_id, out.u, out.v,
                                              depth < lod_depth)
            else:
                base = resolve(out)
            contrib = thr * out.w_sky + thr * (base * out.w_nee)
            base_thr = base
        psum = V3.where(active, psum + contrib, psum)
        live = active & out.hit & ~out.killed
        thr_new = thr * out.rr_scale * (base_thr * out.t_thr + V3(out.s_thr, out.s_thr, out.s_thr))
        thr = V3.where(live, thr_new, thr)
        thr_cut = V3.where(e, thr * b0m, thr) if defer else thr
        live = live & (thr_cut.max_component() >= 0.001)
        ndepth = depth + 1
        live = live & (ndepth < max_depth)
        done = active & ~live

        slot = torch.where(done, s * N + st["ploc"], NS * N + lane)
        acc[:, slot] = torch.stack(tuple(psum) + (tuple(psum_b) if defer else ()))
        psum = V3(*(torch.where(done, 0.0, ch) for ch in psum))
        if defer:
            acc_idx[slot] = idx0
            psum_b = V3(*(torch.where(done, 0.0, ch) for ch in psum_b))
            idx0 = torch.where(done, 0, idx0)

        s = s + done.to(torch.int64)
        regen = done & (s < NS)
        o_new, d_new, key_new, ploc_new = make_ray(lane, s)
        nxt = dict(o=V3.where(regen, o_new, V3.where(live, out.new_org, st["o"])),
                   d=V3.where(regen, d_new, V3.where(live, out.new_dir, st["d"])),
                   thr=V3(*(torch.where(regen, 1.0, ch) for ch in thr)), psum=psum,
                   key=torch.where(regen, key_new, st["key"]),
                   depth=torch.where(live, ndepth, 0), s=s,
                   ploc=torch.where(regen, ploc_new, st["ploc"]), lane=lane)
        if defer:
            nxt.update(psum_b=psum_b, idx0=idx0, e=e & ~regen,
                       b0m=V3(*(torch.where(regen, 1.0, ch) for ch in b0m)))
        return nxt

    blocks = BounceBlocks(step, _CHECK_EVERY, NS, graphed(dev, cs), dev)
    return RegenPlan(cam, pix0, seed, sample_base, acc, acc_idx, make_ray, blocks)


def _regen_loop(cs, blobs, cam12, sums, pix0: int, seed: int, sample_base: int, *,
                n_pix: int, width: int, height: int, n_samples: int, max_depth: int,
                jitter: str, shadow_tmax: str, col0: int, lod_depth: int = 0,
                mip_resolve=None, graphs: Optional[dict] = None) -> None:
    """The scheduler of :func:`_regen_chunk`, with the default resolve, or
    texture LOD when ``lod_depth`` > 0 (bounces below it read the atlas,
    deeper ones the mip), or deferred texture when ``mip_resolve`` (the mip
    resolve of the bounces past the camera's) is given.

    The lane state (``o, d, thr, psum, key, depth, s, ploc, lane``; in
    deferred mode also ``psum_b, idx0, e, b0m``) lives in the fixed buffers
    of :class:`BounceBlocks`, which runs it in blocks of ``_CHECK_EVERY``
    bounces with a host check between them and compacts it into buckets
    (:meth:`BounceBlocks.drive`; a finished lane writes only its own dump
    column ``NS·N + lane``).  On the card each bucket's block is a CUDA
    graph, replayed by every chunk and sample group of the shape
    (``_GRAPH_BLOCKS``; :func:`graph_gate`).

    In deferred mode ``thr`` is the throughput without the camera bounce's
    base colour ``base₀``, ``e`` says whether ``base₀`` is pending in it and
    ``b0m`` is the mip estimate of ``base₀``.  Each lane also carries ``B``
    (``psum_b``, the sum that ``base₀`` multiplies) and the camera bounce's
    exact texel index (``idx0``); one bulk gather per chunk resolves every
    item's ``base₀`` into ``A + base₀·B``.
    """
    NS, N = int(n_samples), int(n_pix)
    dev = sums.device
    defer = mip_resolve is not None
    shape = dict(n_pix=N, width=width, height=height, n_samples=NS, max_depth=max_depth,
                 jitter=jitter, shadow_tmax=shadow_tmax, lod_depth=lod_depth)
    plan_key = scheduler_key(dev, "regen", id(cs), id(blobs), defer, *shape.values())
    plan = block_plan(graphs, plan_key, lambda: _regen_plan(cs, blobs, dev, mip_resolve=mip_resolve,
                                                       **shape))
    plan.cam.copy_(cam12)
    for t, value in ((plan.pix0, pix0), (plan.seed, seed), (plan.sample_base, sample_base)):
        t.fill_(int(value))
    plan.acc.zero_()
    if defer:
        plan.acc_idx.zero_()

    lane = torch.arange(N, dtype=torch.int64, device=dev)
    s = torch.zeros(N, dtype=torch.int64, device=dev)
    o, d, key, ploc = plan.make_ray(lane, s)
    one = torch.ones(N, dtype=torch.float32, device=dev)
    zero = torch.zeros_like(one)
    state = dict(o=o, d=d, thr=V3(one, one, one), psum=V3(zero, zero, zero), key=key,
                 depth=torch.zeros(N, dtype=torch.int32, device=dev), s=s, ploc=ploc, lane=lane)
    if defer:
        state.update(psum_b=V3(zero, zero, zero), idx0=torch.zeros(N, dtype=torch.int32, device=dev),
                     e=torch.zeros(N, dtype=torch.bool, device=dev), b0m=V3(one, one, one))
    plan.blocks.drive(state, NS * max_depth)  # a lane needs at most NS·max_depth bounces

    acc = plan.acc
    if defer:
        # base₀ of every item: ONE bulk gather of the exact atlas per chunk
        n_tex = int(cs.atlas.shape[0])
        b0 = _unpack_rgb(cs.atlas[torch.clamp(plan.acc_idx[:NS * N], 0, n_tex - 1).long()])
        acc = torch.stack([acc[c, :NS * N] + b0[c] * acc[3 + c, :NS * N] for c in range(3)])
    rebin(sums, acc, col0, N, NS)


def path_radiance(cs, org: V3, rd: V3, key: torch.Tensor, max_depth: int,
                  shadow_tmax: str = "reference", blobs=None) -> V3:
    """Trace one batch of camera rays to completion (one radiance sample a
    ray), as the JAX package's ``path_radiance``: one loop over the bounce
    of :func:`bounce_fn` and the resolve of :func:`resolve_fn` (the
    physics of :func:`_regen_chunk` without its lane scheduling), while any
    lane is active and below ``max_depth``.  ``key`` holds each ray's int32
    RNG key bits; ``blobs`` the kernels' tables of ``cs``
    (``models/wavefront.scene_blobs``, made here when None)."""
    bounce = bounce_fn(cs, scene_blobs(cs) if blobs is None else blobs)
    resolve = resolve_fn(cs, int(org.x.shape[0]))
    shadow_light = shadow_tmax == "light"
    one = torch.ones_like(org.x)
    o, d, thr = org, rd, V3(one, one, one)
    color = V3(*(torch.zeros_like(one),) * 3)
    active = torch.ones_like(one, dtype=torch.bool)
    for depth in range(max_depth):
        if not bool(active.any()):  # host sync, as the JAX loop's condition
            break
        out = bounce(o, d, thr, key, depth, shadow_light)
        base = resolve(out)
        contrib = thr * out.w_sky + thr * (base * out.w_nee)
        color = color + V3.where(active, contrib, V3(*(torch.zeros_like(one),) * 3))
        live = active & out.hit & ~out.killed
        thr_new = thr * out.rr_scale * (base * out.t_thr + V3(out.s_thr, out.s_thr, out.s_thr))
        thr = V3.where(live, thr_new, thr)
        live = live & (thr.max_component() >= 0.001)
        o = V3.where(live, out.new_org, o)
        d = V3.where(live, out.new_dir, d)
        active = live
    return color


class PathTracer(WavefrontRenderer):
    """The flagship renderer, ``cuda_path_raytracer`` (alias
    ``tpu_path_raytracer``)."""

    def __init__(self, sample_group: int = 128, jitter: str = "independent",
                 shadow_tmax: str = "reference", mip_budget: int = 0, texture_lod: int = 0,
                 texture_lod_depth: int = 2, **kw):
        # sample_group: samples per chunk call; renders are group-invariant
        # bit for bit (every pixel folds its samples in ascending order).
        # shadow_tmax="light" bounds NEE occlusion at the sampled light
        # instead of the reference's 1e6 quirk.
        # mip_budget > 0: deferred-texture mode (models/experimental.py):
        # the camera bounce's texel stays exact, later bounces sample a mip
        # capped at mip_budget.  texture_lod > 0: texture-LOD mode: bounces
        # below texture_lod_depth sample the full atlas, deeper ones a mip
        # capped at texture_lod.  Both compile the mip; they exclude each other.
        if shadow_tmax not in ("reference", "light"):
            raise ValueError(f"shadow_tmax must be reference or light, not {shadow_tmax!r}")
        if mip_budget and texture_lod:
            raise ValueError("deferred-texture (mip_budget) and texture-LOD (texture_lod) "
                             "modes are mutually exclusive")
        if mip_budget or texture_lod:
            co = dict(kw.pop("compile_overrides", None) or {})
            co.setdefault("mip_budget", int(mip_budget or texture_lod))
            kw["compile_overrides"] = co
        super().__init__("cuda_path_raytracer", jitter=jitter, **kw)
        self.sample_group = int(sample_group)
        self.shadow_tmax = str(shadow_tmax)
        self.lod_depth = int(texture_lod_depth) if texture_lod else 0

    def get_capabilities(self) -> List[str]:
        return [
            "path_tracing", "global_illumination", "monte_carlo",
            "next_event_estimation", "russian_roulette", "soft_shadows", "caustics",
            "reflection", "refraction", "textures", "aces_tonemapping",
            "cuda_acceleration", "progressive_rendering",
        ]

    def _samples_per_group(self, spp: int) -> int:
        return max(1, min(self.sample_group, spp))

    def _chunk(self, cs, cam12, sums, pix0, seed, sample_base, *, spp, **kw):
        # spp: a split's overshoot is clipped before the chunk (parallel/sharding.py)
        _regen_chunk(cs, self.blobs(cs), cam12, sums, pix0, seed, sample_base,
                     jitter=self.jitter, shadow_tmax=self.shadow_tmax, lod_depth=self.lod_depth,
                     graphs=self._graphs, **kw)

    def device_sums(self, scene, camera, settings, sample_offset=0, n_samples=None):
        spp = settings.samples_per_pixel if n_samples is None else n_samples
        group = self._samples_per_group(settings.samples_per_pixel)
        if spp % group != 0:
            # keep groups uniform (the JAX package's rule)
            group = next(g for g in range(min(group, spp), 0, -1) if spp % g == 0)
            self.sample_group = group
        return super().device_sums(scene, camera, settings, sample_offset=sample_offset,
                                   n_samples=spp)

    def _finalize_dev(self, sums, spp_total: int, settings):
        return aces(sums / float(spp_total))


RendererFactory.register("cuda_path_raytracer", PathTracer)
RendererFactory.register_alias("tpu_path_raytracer", "cuda_path_raytracer")
