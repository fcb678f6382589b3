"""The path tracer's scheduler modes — port of the JAX package's
``models/experimental.py``, where the three modes were built, held equal to
the default path, measured as losses or flat on its TPU, and gated off:

* **Deferred texture** (``compile_scene(mip_budget=...)``,
  ``PathTracer(mip_budget=...)``): a path's radiance is linear in its
  camera-bounce base colour ``base₀``, so each item carries ``A + base₀·B``
  with ``base₀`` symbolic.  The camera bounce records its exact atlas texel
  index; bounces past it sample the small mip (K9, ``mip_gather``); one
  bulk gather per chunk resolves every item's ``base₀``.  Russian roulette
  and the cutoff see the throughput with the mip estimate of ``base₀``, so
  with ``mip_budget == texture_budget`` the mode renders the default image
  up to the reassociation of ``A + base₀·B``.
* **Texture LOD** (``PathTracer(texture_lod=...)``): bounces below
  ``lod_depth`` sample the full atlas, deeper ones the mip (K9).  With the
  mip equal to the atlas it is the default path bit for bit.  It takes
  precedence over deferred texture.
* **Fused in-kernel regeneration** (``path_tracer._PIPE_REGEN``): one launch
  of K7 (``ops/cuda/step.path_step``) per bounce runs the glue of the
  previous bounce and the next bounce; between launches only the record's
  texel gather and the park into the accumulator remain.  Taken only on a
  scene that K1 takes (no BVH), with neither texture mode.

The texture modes run in the default scheduler, ``path_tracer._regen_loop``,
which switches only the resolve and, for deferred texture, the state it
carries; the pipe has its own step (``_pipe_chunk``).  Both keep the port's
scheduler (``path_tracer.BounceBlocks``): per-lane path sums parked at
``(sample, pixel)`` slots, a host check every ``_CHECK_EVERY`` bounces,
compaction into fixed buckets, and on the card each block a CUDA graph.  The JAX tail phase (``_TAIL_DIV``, ``_TAIL_QUANT``) and slot fold
(``_FOLD_EVERY``) are its own schedule and are not ported; the per-item
left fold and the ascending-sample re-bin that define the result are the
same.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.cuda.bounce import T_MAX, T_MIN
from ..ops.cuda.step import StepRec, StepStatics, pack_tex_blob, path_step
from ..ops.cuda.texture import fits_mip, resolve_base_color_mip
from ..ops.v3 import V3
from . import path_tracer as _pt


def _make_mip_resolve(cs):
    """The resolve of bounces past the camera's in deferred-texture mode
    (the mip gather K9), or None when the scene has no mip that fits."""
    if cs.mip_atlas is None or not fits_mip(cs):
        return None
    return lambda out: resolve_base_color_mip(cs, out.mat_color, out.tex_id, out.u, out.v)


def regen_chunk_modes(cs, blobs, cam12, sums, pix0: int, seed: int, sample_base: int, *,
                      n_pix: int, width: int, height: int, n_samples: int, max_depth: int,
                      jitter: str, col0: int, shadow_tmax: str = "reference",
                      lod_depth: int = 0, graphs=None) -> None:
    """``path_tracer._regen_chunk`` with its modes (module docstring); the
    mode gate is the JAX package's: LOD over deferred texture, and the pipe
    (``path_tracer._PIPE_REGEN``) only without either and on a scene that
    K1 takes.  The texture modes run in ``path_tracer._regen_loop``."""
    lod = lod_depth > 0 and cs.mip_atlas is not None
    mip_resolve = None if lod else _make_mip_resolve(cs)
    kw = dict(n_pix=n_pix, width=width, height=height, n_samples=n_samples,
              max_depth=max_depth, jitter=jitter, shadow_tmax=shadow_tmax, col0=col0,
              graphs=graphs)
    if _pt._PIPE_REGEN and mip_resolve is None and not lod and cs.bvh is None:
        return _pipe_chunk(cs, blobs, cam12, sums, pix0, seed, sample_base, **kw)
    _pt._regen_loop(cs, blobs, cam12, sums, pix0, seed, sample_base,
                    lod_depth=lod_depth if lod else 0, mip_resolve=mip_resolve, **kw)


def pipe_start(cs, blobs, cam12, pix0, seed, sample_base, *, n_pix, width, height,
               n_samples, max_depth, jitter, shadow_tmax="reference"):
    """The pipe mode's first state of a chunk: ``(st, tables, scal, lane)``
    with ``lane = (rec, thr, psum, key, depth, s, ploc, ux, uy)``, the
    arguments of ``path_step`` after ``texel``.  The priming record, which
    the first step's glue leaves unchanged (hit 1, kill 0, w_nee 0, s_thr 1,
    t_thr 0, depth −1), starts every lane on its first camera ray."""
    NS, N = int(n_samples), int(n_pix)
    dev = cam12.device
    stride = _pt.item_stride(N, NS)
    st = StepStatics(n_tex=cs.n_textures, tex_on=cs.any_textured.shape[0] > 0, t_min=T_MIN,
                     t_max=T_MAX, shadow_light=shadow_tmax == "light", jitter=jitter,
                     width=width, height=height, total=width * height, stride=stride, n_pix=N,
                     ns=NS, max_depth=max_depth)
    lane = torch.arange(N, dtype=torch.int64, device=dev)
    o0, d0, key, _ = _pt.camera_rays(
        cam12, lane, torch.zeros_like(lane), pix0=pix0, seed=seed, sample_base=sample_base,
        n_pix=N, stride=stride, width=width, height=height, max_depth=max_depth, jitter=jitter)
    one = torch.ones(N, dtype=torch.float32, device=dev)
    zero = torch.zeros_like(one)
    rec = StepRec(idx=torch.full((N,), -1, dtype=torch.int32, device=dev), hit=one, kill=zero,
                  wnee=zero, rrs=one, sthr=one, tthr=zero, no=o0, nd=d0, mc=V3(zero, zero, zero))
    state = (rec, V3(one, one, one), V3(zero, zero, zero), key,
             torch.full((N,), -1, dtype=torch.int32, device=dev),
             torch.zeros(N, dtype=torch.int32, device=dev), lane.to(torch.int32),
             ((pix0 + lane) % width).to(torch.int32), ((pix0 + lane) // width).to(torch.int32))
    return st, (*blobs, pack_tex_blob(cs)), (pix0, seed, sample_base), state


def step_texel(cs, st, rec):
    """The packed texel of each record's hit, gathered between steps
    (``atlas[max(idx, 0)]``; zeros when no primitive is textured)."""
    if not st.tex_on:
        return torch.zeros_like(rec.idx)
    return cs.atlas[torch.clamp(rec.idx, min=0).long()]


class PipePlan(NamedTuple):
    """What the pipe's blocks read besides the lane state and K7's tables:
    the camera (a buffer filled before each chunk), the accumulator (zeroed
    for each chunk), the chunk's scalars and the blocks."""
    cam: torch.Tensor
    acc: torch.Tensor
    scal: list  # [(pix0, seed, sample_base)] of the blocks' graphs
    blocks: "_pt.BounceBlocks"


def _pipe_plan(cs, blobs, dev, *, n_pix, n_samples, max_depth, width, height, jitter,
               shadow_tmax) -> PipePlan:
    NS, N = n_samples, n_pix
    cam = torch.zeros((12,), dtype=torch.float32, device=dev)
    st, tables, _scal, _lanes = pipe_start(cs, blobs, cam, 0, 0, 0, n_pix=N, n_samples=NS,
                                           max_depth=max_depth, width=width, height=height,
                                           jitter=jitter, shadow_tmax=shadow_tmax)
    acc = torch.zeros((3, (NS + 1) * N), dtype=torch.float32, device=dev)
    scal = [None]

    def step(lanes):
        """One fused step (K7) of every lane and the park of its finished
        item: the lane state after it."""
        rec = StepRec(**{f: lanes[f] for f in StepRec._fields})
        (rec2, _o, _d, thr, psum, key, depth, s, ploc, ux, uy, item, park) = path_step(
            cs, st, tables, cam, scal[0], rec, step_texel(cs, st, rec), lanes["thr"],
            lanes["psum"], lanes["key"], lanes["depth"], lanes["s"], lanes["ploc"], lanes["ux"],
            lanes["uy"])
        slot = torch.where(item < NS, item.long() * N + lanes["ploc"], NS * N + lanes["lane"])
        acc[:, slot] = torch.stack(park)
        return dict(rec2._asdict(), thr=thr, psum=psum, key=key, depth=depth, s=s, ploc=ploc,
                    ux=ux, uy=uy, lane=lanes["lane"])

    blocks = _pt.BounceBlocks(step, _pt._CHECK_EVERY, NS, _pt.graphed(dev, cs), dev)
    return PipePlan(cam, acc, scal, blocks)


def _pipe_chunk(cs, blobs, cam12, sums, pix0, seed, sample_base, *, n_pix, n_samples,
                max_depth, col0, graphs=None, **kw):
    """The scheduler with one fused step (K7) per bounce, in blocks of
    ``_CHECK_EVERY`` steps over fixed bucket buffers, as
    ``path_tracer._regen_loop`` runs its bounces.  The loop ends when every
    lane has finished its items, so the last record, all retired lanes, is
    dropped.

    K7 takes the chunk's ``pix0``, ``seed`` and ``sample_base`` by value
    (``csrc/path_step.cu`` ``StepConsts``), so a captured step freezes them:
    the pipe's graphs serve one chunk and sample group, and a chunk with
    other scalars drops them and captures its own (one per bucket)."""
    NS, N = int(n_samples), int(n_pix)
    dev = sums.device
    shape = dict(n_pix=N, n_samples=NS, max_depth=max_depth, **kw)
    plan = _pt.block_plan(graphs, _pt.scheduler_key(dev, "pipe", id(cs), id(blobs),
                                                    *sorted(shape.items())),
                          lambda: _pipe_plan(cs, blobs, dev, **shape))
    scal = (int(pix0), int(seed), int(sample_base))
    if plan.scal[0] != scal:
        plan.scal[0] = scal
        plan.blocks.graphs.clear()
    plan.cam.copy_(cam12)
    plan.acc.zero_()
    _st, _tables, _scal, (rec, thr, psum, key, depth, s, ploc, ux, uy) = pipe_start(
        cs, blobs, cam12, pix0, seed, sample_base, n_pix=N, n_samples=NS, max_depth=max_depth,
        **kw)
    lanes = dict(rec._asdict(), thr=thr, psum=psum, key=key, depth=depth, s=s, ploc=ploc, ux=ux,
                 uy=uy, lane=torch.arange(N, dtype=torch.int64, device=dev))
    # the priming step adds one to the NS·max_depth steps a lane needs
    plan.blocks.drive(lanes, NS * max_depth + 1)
    _pt.rebin(sums, plan.acc, col0, N, NS)
