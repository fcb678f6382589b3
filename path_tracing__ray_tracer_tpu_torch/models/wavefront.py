"""Shared wavefront render loop: chunking, sample groups, device sums, image.

Port of the JAX package's ``models/wavefront.py``.  The (pixel × sample)
space streams through a *chunk function* in fixed-size pixel chunks
(``chunk_rays`` budget) and sample groups.  Every chunk adds its samples, in
ascending order, into one device-resident buffer of per-pixel radiance sums;
the subclass then finalizes (divide by spp, tonemap) on the device, the
image is quantized there, and one transfer brings it to the host.

With a ``mesh`` (``parallel/mesh.make_mesh``) of more than one entry each
chunk call is split over its ``(tile, sample)`` entries
(``parallel/sharding.shard_chunk_fn``): the pixel chunk is rounded up to
whole 1024-pixel blocks per tile, and every entry renders its part at once
in its worker process (``parallel/workers.py``) on its own device, with the
scene that this process compiled for that device; the renderer's device
(the mesh's first entry) holds the sums.  A mesh of one entry renders on the
caller's thread, as no mesh does.

The JAX package makes each chunk one device program and batches chunks
and sample groups into one dispatch each (``lax.map``, fused group loops)
against a fixed cost per dispatch.  The card has the same kind of floor, a
host launch per kernel, so the path tracer replays its bounce blocks as
CUDA graphs (``models/path_tracer.BounceBlocks``).  Their plans (lane
buffers, accumulator, graphs), one per chunk shape, live in the renderer's
graph cache (``_graphs``): made at the first chunk of a shape and replayed
by every later chunk and sample group of every render, they go with the
renderer (a mesh worker keeps one cache per scene it was sent).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..compiler import CompiledScene, compile_scene, pack_camera, scene_summary
from ..core.camera import Camera
from ..core.scene import RenderSettings, Scene
from ..ops.cuda.bounce import pack_light_blob, pack_mat_blob, pack_scene_blob
from ..ops.cuda.bounce_bvh import bounce_bvh_ok, pack_bvh_tables
from ..ops.tonemap import quantize_u8
from ..ops.v3 import V3
from ..parallel.mesh import DeviceMesh, mesh_shape
from ..parallel.sharding import device_scope, shard_chunk_fn
from ..utils import debug
from ..utils.image import assemble_image
from ..utils.logging import log_event
from ..utils.profiling import mrays_per_sec, span
from .base import BaseRenderer

# Lane-width cap of one chunk (the JAX package's measured knee; a scheduling
# knob that never changes a pixel).
_MAX_CHUNK_LANES = 131072

# What a renderer holds for its own process: a mesh worker's twin of it
# (``WavefrontRenderer.settings`` / ``twin``) takes everything else
_PROCESS_LOCAL = ("mesh", "device", "_scene_cache", "_blobs", "_graphs")


def pixel_coords(pix0: int, n_pix: int, width: int, height: int, device):
    """Flat pixel ids of a chunk → ``(idx, x, y)`` with ``y`` from the bottom
    row.  Out-of-frame lanes clamp to the last pixel (the caller cuts them)
    but keep their unclamped ``idx``, which the RNG hashes."""
    idx = pix0 + torch.arange(n_pix, dtype=torch.int64, device=device)
    safe = torch.clamp(idx, max=width * height - 1)
    return idx, (safe % width).to(torch.float32), (safe // width).to(torch.float32)


def scene_blobs(cs: CompiledScene):
    """The kernels' packed tables of ``cs``: the primitives, materials and
    lights; for a BVH scene the tables of ``ops/cuda/bounce_bvh`` (None when
    K5 does not take the scene), whose triangles are in the BVH's slot
    records."""
    if cs.bvh is None:
        return pack_scene_blob(cs), pack_mat_blob(cs), pack_light_blob(cs)
    return pack_bvh_tables(cs) if bounce_bvh_ok(cs) else None


def chunk_pixels(n_pixels: int, group: int, chunk_rays: int) -> int:
    """Pixels per chunk for a ``chunk_rays`` ray budget and ``group`` samples
    per pixel: capped at the frame and at ``_MAX_CHUNK_LANES``, rounded up to
    a multiple of 1024."""
    n_pix = max(1024, min(n_pixels, max(1, chunk_rays // max(group, 1)), _MAX_CHUNK_LANES))
    return int(math.ceil(n_pix / 1024) * 1024)


def _renderer_device(device, mesh: Optional[DeviceMesh]) -> torch.device:
    """The device that holds a renderer's sums: ``device`` (default
    ``"cuda"``, the current card when torch sees one), or the mesh's first
    entry, with which an explicit ``device`` must agree (``"cuda"`` without
    an index agrees with any card)."""
    if mesh is None:
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    first = mesh.rows[0][0]
    if device is not None:
        dev = torch.device(device)
        if dev.type != first.type or (dev.index is not None and dev != first):
            raise ValueError(f"device {dev} conflicts with the mesh's first entry {first}")
    return first


class WavefrontRenderer(BaseRenderer):
    convention = "gpu"
    gpu_parity = True

    def __init__(
        self,
        name: str,
        chunk_rays: int = 1 << 20,
        seed: int = 0,
        jitter: str = "diagonal",  # 'diagonal' (reference quirk) | 'independent' | 'center'
        texture_budget: int = 0,  # 0 = reference-exact full-res atlas
        device=None,  # default: the mesh's first entry, else "cuda"
        mesh: Optional[DeviceMesh] = None,  # split each chunk call over its entries
        compile_overrides: Optional[dict] = None,  # extra compile_scene kwargs (use_bvh)
        reseed_per_render: bool = False,  # the reference's frame_count reseed quirk
    ):
        super().__init__(name)
        if jitter not in ("diagonal", "independent", "center"):
            raise ValueError(f"jitter must be diagonal, independent or center, not {jitter!r}")
        self.chunk_rays = int(chunk_rays)
        self.seed = int(seed)
        # Opt-in parity with the reference's per-render RNG advance: its
        # frame_count reseeds the kernel at each render() call
        # (cuda_path_tracer.py:28,739,809), so back-to-back renders differ.
        # Off by default: renders stay deterministic per (seed, settings);
        # progressive accumulation (parallel/progressive.py) is the better
        # replacement.
        self.reseed_per_render = bool(reseed_per_render)
        self.frame_count = 0  # renders done (the reference's frame_count)
        self.jitter = jitter
        self.texture_budget = int(texture_budget)
        self.mesh = mesh
        self.device = _renderer_device(device, mesh)
        self.compile_overrides = dict(compile_overrides or {})
        self._scene_cache: Dict[Tuple, CompiledScene] = {}
        self._blobs: Dict[int, object] = {}  # blobs() by id of the compiled scene
        self._graphs: Dict[tuple, object] = {}  # the path tracer's plans by chunk shape

    def _run_seed(self) -> int:
        """The seed of this render: ``seed + frame_count`` (mod 2^32) when the
        reseed quirk is opted in (``rng.ray_key`` hashes the seed, so +1 is
        an independent stream), else ``seed``."""
        if self.reseed_per_render:
            return (self.seed + self.frame_count) & 0xFFFFFFFF
        return self.seed

    # -- a mesh worker's twin (parallel/workers.py) ----------------------------
    def settings(self) -> dict:
        """The renderer's attributes but its mesh, device and caches: what a
        mesh worker's twin of it takes."""
        return {k: v for k, v in vars(self).items() if k not in _PROCESS_LOCAL}

    @classmethod
    def twin(cls, settings: dict, device, blobs: dict, graphs: dict) -> "WavefrontRenderer":
        """The renderer of ``settings`` on ``device`` with no mesh, its
        kernels' tables kept in ``blobs`` (by id of the compiled scene) and
        its graph cache in ``graphs``."""
        r = cls.__new__(cls)
        r.__dict__.update(settings, mesh=None, device=torch.device(device), _scene_cache={},
                          _blobs=blobs, _graphs=graphs)
        return r

    # -- scene compilation (cached) -----------------------------------------
    def compiled(self, scene: Scene, device=None) -> CompiledScene:
        """``scene`` compiled on ``device`` (default: the renderer's), once
        per scene and device."""
        device = self.device if device is None else torch.device(device)
        key = (id(scene), self.convention, self.gpu_parity, self.texture_budget, str(device),
               tuple(sorted(self.compile_overrides.items())))
        if key not in self._scene_cache:
            cs = compile_scene(
                scene,
                convention=self.convention,
                gpu_parity=self.gpu_parity,
                texture_budget=self.texture_budget,
                device=device,
                **self.compile_overrides,
            )
            self._scene_cache[key] = cs
            log_event("scene_compiled", renderer=self.name, **scene_summary(cs))
        return self._scene_cache[key]

    def blobs(self, cs: CompiledScene):
        """:func:`scene_blobs` of ``cs``, made once per compiled scene."""
        if id(cs) not in self._blobs:
            self._blobs[id(cs)] = scene_blobs(cs)
        return self._blobs[id(cs)]

    # -- subclass contract ---------------------------------------------------
    def _samples_per_group(self, spp: int) -> int:
        raise NotImplementedError

    def _chunk(self, cs: CompiledScene, cam12: torch.Tensor, sums: torch.Tensor, pix0: int,
               seed: int, sample_base: int, *, n_pix: int, width: int, height: int,
               n_samples: int, max_depth: int, spp: int, col0: int) -> None:
        """Add the radiance of ``n_samples`` samples from ``sample_base`` on,
        in ascending sample order, for the pixels ``[pix0, pix0 + n_pix)``
        into ``sums[:, col0:col0 + n_pix]`` (``col0 == pix0`` when ``sums``
        is the frame's); ``spp`` is the frame's samples per pixel."""
        raise NotImplementedError

    def _finalize_dev(self, sums: torch.Tensor, spp_total: int, settings: RenderSettings):
        """(3, H*W) radiance sums → display-ready [0,1] image, on the device."""
        raise NotImplementedError

    def _finalize(self, sums: np.ndarray, spp_total: int, settings: RenderSettings) -> np.ndarray:
        """Host ``(H*W, 3)`` radiance sums → the ``(H*W, 3)`` [0,1] image
        (``_finalize_dev`` on the renderer's device)."""
        dev = torch.from_numpy(np.ascontiguousarray(sums)).to(self.device).T
        return self._finalize_dev(dev, spp_total, settings).T.cpu().numpy()

    # -- chunk plan ----------------------------------------------------------
    def _chunk_rays(self, max_depth: int, group: int) -> int:
        """The ray budget of one chunk call (a renderer may bound its memory
        by depth)."""
        return self.chunk_rays

    def _plan(self, w: int, h: int, spp: int, max_depth: int) -> Tuple[int, int]:
        """``(n_pix, group)``: pixels per chunk and samples per chunk call.
        With a mesh, ``n_pix`` is rounded up to whole 1024-pixel blocks per
        tile entry, as in the JAX package."""
        group = self._samples_per_group(spp)
        n_pix = chunk_pixels(w * h, group, self._chunk_rays(max_depth, group))
        if self.mesh is not None:
            block = mesh_shape(self.mesh)[0] * 1024
            n_pix = -(-n_pix // block) * block
        return n_pix, group

    # -- rendering ------------------------------------------------------------
    def device_sums(self, scene: Scene, camera: Camera, settings: RenderSettings,
                    sample_offset: int = 0, n_samples: Optional[int] = None) -> torch.Tensor:
        """Radiance sums over ``n_samples`` samples from ``sample_offset`` on:
        a ``(3, H*W)`` float32 tensor on the renderer's device.  Spans
        ``device_sums`` (the call) and ``chunk`` (each chunk call, a split's
        included)."""
        with span("device_sums"):
            w, h, spp = settings.width, settings.height, settings.samples_per_pixel
            if n_samples is None:
                n_samples = spp
            n_pix, group = self._plan(w, h, spp, settings.max_depth)
            pix0_list = list(range(0, w * h, n_pix))
            mesh = self.mesh or DeviceMesh([[self.device]])
            tile, samp = mesh_shape(mesh)
            log_event(
                "render_start", renderer=self.name, width=w, height=h, spp=n_samples,
                max_depth=settings.max_depth, chunk_pixels=n_pix, sample_group=group,
                chunks=len(pix0_list), device=str(self.device), mesh=mesh.shape,
            )
            cams = {dev: pack_camera(camera, dev) for dev in mesh.devices()}
            seed = self._run_seed()
            local_pix, local_samples = n_pix // tile, -(-group // samp)
            kw = dict(n_pix=local_pix, width=w, height=h, max_depth=settings.max_depth, spp=spp)
            if tile * samp == 1:
                cs, cam12 = self.compiled(scene), cams[self.device]

                def chunk(sums, pix0, s0, n):
                    with device_scope(self.device):
                        self._chunk(cs, cam12, sums, pix0, seed, s0, n_samples=n, col0=pix0, **kw)
            else:
                # every device's scene compiles here, under this process's knobs,
                # before any worker starts its part
                scenes = {dev: self.compiled(scene, dev) for dev in mesh.devices()}
                workers = mesh.workers()
                chunk = shard_chunk_fn(
                    lambda parts, sums: workers.render(self, scenes, cams, seed, kw, parts, sums),
                    mesh, local_pix, local_samples)
            # padded to whole chunks: out-of-frame lanes land past H*W and are cut
            sums = torch.zeros((3, len(pix0_list) * n_pix), dtype=torch.float32, device=self.device)
            for c, pix0 in enumerate(pix0_list):
                for s0 in range(sample_offset, sample_offset + n_samples, group):
                    with span("chunk"):
                        chunk(sums, pix0, s0, min(group, sample_offset + n_samples - s0))
                if debug.nans_checked():
                    debug.check_chunk(sums[:, pix0:pix0 + n_pix], c, pix0, n_pix)
            return sums[:, : w * h]

    def render_sums(self, scene: Scene, camera: Camera, settings: RenderSettings,
                    sample_offset: int = 0, n_samples: Optional[int] = None) -> np.ndarray:
        """Host float32 ``(H*W, 3)`` radiance sums (bottom-up row order)."""
        sums = self.device_sums(scene, camera, settings, sample_offset, n_samples)
        return sums.T.cpu().numpy()

    def render_array(self, scene: Scene, camera: Camera, settings: RenderSettings) -> np.ndarray:
        """Float image in [0,1], shape (H*W, 3), bottom-up row order."""
        sums = self.device_sums(scene, camera, settings)
        return self._finalize_dev(sums, settings.samples_per_pixel, settings).T.cpu().numpy()

    def render(self, scene: Scene, camera: Camera, settings: RenderSettings):
        """The frame as an image; spans ``render`` (the call) and ``finish``
        (tone map, quantise, the uint8 transfer and the image's assembly)."""
        with span("render") as t:
            sums = self.device_sums(scene, camera, settings)
            with span("finish"):
                img = self._finalize_dev(sums, settings.samples_per_pixel, settings)
                rgb = quantize_u8(V3(img[0], img[1], img[2])).to_array()
                arr = rgb.cpu().numpy()  # the one transfer: the uint8 image
                image = assemble_image(arr, settings.width, settings.height)
        self.frame_count += 1
        log_event(
            "render_done", renderer=self.name, seconds=round(t.seconds, 3),
            mrays_per_sec=round(mrays_per_sec(settings.width, settings.height,
                                              settings.samples_per_pixel,
                                              settings.max_depth, t.seconds), 2),
        )
        return image
