"""Shared wavefront render loop: chunking, sample groups, device sums, image.

Port of the single-device path of the JAX package's ``models/wavefront.py``.
The (pixel × sample) space streams through a *chunk function* in fixed-size
pixel chunks (``chunk_rays`` budget) and sample groups.  Every chunk adds its
samples, in ascending order, into one device-resident buffer of per-pixel
radiance sums; the subclass then finalizes (divide by spp, tonemap) on the
device, the image is quantized there, and one transfer brings it to the host.

The JAX package's dispatch batching (``lax.map`` over chunks, fused group
loops) works around a per-dispatch floor of its TPU connection and is not
ported: one device-resident path is enough here.
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
from ..utils.image import assemble_image
from ..utils.logging import log_event
from ..utils.profiling import Timer, mrays_per_sec
from .base import BaseRenderer

# Lane-width cap of one chunk (the JAX package's measured knee; a scheduling
# knob that never changes a pixel).
_MAX_CHUNK_LANES = 131072


def pixel_coords(pix0: int, n_pix: int, width: int, height: int, device):
    """Flat pixel ids of a chunk → ``(idx, x, y)`` with ``y`` from the bottom
    row.  Out-of-frame lanes clamp to the last pixel (the caller cuts them)
    but keep their unclamped ``idx``, which the RNG hashes."""
    idx = pix0 + torch.arange(n_pix, dtype=torch.int64, device=device)
    safe = torch.clamp(idx, max=width * height - 1)
    return idx, (safe % width).to(torch.float32), (safe // width).to(torch.float32)


def chunk_pixels(n_pixels: int, group: int, chunk_rays: int) -> int:
    """Pixels per chunk for a ``chunk_rays`` ray budget and ``group`` samples
    per pixel: capped at the frame and at ``_MAX_CHUNK_LANES``, rounded up to
    a multiple of 1024."""
    n_pix = max(1024, min(n_pixels, max(1, chunk_rays // max(group, 1)), _MAX_CHUNK_LANES))
    return int(math.ceil(n_pix / 1024) * 1024)


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
        device="cuda",
        compile_overrides: Optional[dict] = None,  # extra compile_scene kwargs (use_bvh)
    ):
        super().__init__(name)
        if jitter not in ("diagonal", "independent", "center"):
            raise ValueError(f"jitter must be diagonal, independent or center, not {jitter!r}")
        self.chunk_rays = int(chunk_rays)
        self.seed = int(seed)
        self.jitter = jitter
        self.texture_budget = int(texture_budget)
        self.device = torch.device(device)
        self.compile_overrides = dict(compile_overrides or {})
        self._scene_cache: Dict[Tuple, CompiledScene] = {}
        self._blobs: Dict[int, object] = {}  # blobs() by id of the compiled scene

    # -- scene compilation (cached) -----------------------------------------
    def compiled(self, scene: Scene) -> CompiledScene:
        key = (id(scene), self.convention, self.gpu_parity, self.texture_budget, str(self.device),
               tuple(sorted(self.compile_overrides.items())))
        if key not in self._scene_cache:
            cs = compile_scene(
                scene,
                convention=self.convention,
                gpu_parity=self.gpu_parity,
                texture_budget=self.texture_budget,
                device=self.device,
                **self.compile_overrides,
            )
            self._scene_cache[key] = cs
            log_event("scene_compiled", renderer=self.name, **scene_summary(cs))
        return self._scene_cache[key]

    def blobs(self, cs: CompiledScene):
        """The kernels' packed tables of ``cs``, made once per compiled
        scene: the primitives, materials and lights; for a BVH scene the
        tables of ``ops/cuda/bounce_bvh`` (None when K5 does not take the
        scene), whose triangles are in the BVH's slot records."""
        if id(cs) not in self._blobs:
            if cs.bvh is None:
                self._blobs[id(cs)] = (pack_scene_blob(cs), pack_mat_blob(cs),
                                       pack_light_blob(cs))
            else:
                self._blobs[id(cs)] = pack_bvh_tables(cs) if bounce_bvh_ok(cs) else None
        return self._blobs[id(cs)]

    # -- subclass contract ---------------------------------------------------
    def _samples_per_group(self, spp: int) -> int:
        raise NotImplementedError

    def _chunk(self, cs: CompiledScene, cam12: torch.Tensor, sums: torch.Tensor, pix0: int,
               seed: int, sample_base: int, *, n_pix: int, width: int, height: int,
               n_samples: int, max_depth: int) -> None:
        """Add the radiance of ``n_samples`` samples from ``sample_base`` on,
        in ascending sample order, into ``sums[:, pix0:pix0 + n_pix]``."""
        raise NotImplementedError

    def _finalize_dev(self, sums: torch.Tensor, spp_total: int, settings: RenderSettings):
        """(3, H*W) radiance sums → display-ready [0,1] image, on the device."""
        raise NotImplementedError

    # -- chunk plan ----------------------------------------------------------
    def _plan(self, w: int, h: int, spp: int, max_depth: int) -> Tuple[int, int]:
        """``(n_pix, group)``: lanes per chunk and samples per chunk call
        (``max_depth`` lets a renderer bound its memory by depth)."""
        group = self._samples_per_group(spp)
        return chunk_pixels(w * h, group, self.chunk_rays), group

    # -- rendering ------------------------------------------------------------
    def device_sums(self, scene: Scene, camera: Camera, settings: RenderSettings,
                    sample_offset: int = 0, n_samples: Optional[int] = None) -> torch.Tensor:
        """Radiance sums over ``n_samples`` samples from ``sample_offset`` on:
        a ``(3, H*W)`` float32 tensor on the renderer's device."""
        cs = self.compiled(scene)
        cam12 = pack_camera(camera, self.device)
        w, h, spp = settings.width, settings.height, settings.samples_per_pixel
        if n_samples is None:
            n_samples = spp
        n_pix, group = self._plan(w, h, spp, settings.max_depth)
        pix0_list = list(range(0, w * h, n_pix))
        log_event(
            "render_start", renderer=self.name, width=w, height=h, spp=n_samples,
            max_depth=settings.max_depth, chunk_pixels=n_pix, sample_group=group,
            chunks=len(pix0_list), device=str(self.device),
        )
        # padded to whole chunks: out-of-frame lanes land past H*W and are cut
        sums = torch.zeros((3, len(pix0_list) * n_pix), dtype=torch.float32, device=self.device)
        for pix0 in pix0_list:
            for s0 in range(sample_offset, sample_offset + n_samples, group):
                self._chunk(
                    cs, cam12, sums, pix0, self.seed, s0, n_pix=n_pix, width=w,
                    height=h, n_samples=min(group, sample_offset + n_samples - s0),
                    max_depth=settings.max_depth,
                )
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
        with Timer() as t:
            sums = self.device_sums(scene, camera, settings)
            img = self._finalize_dev(sums, settings.samples_per_pixel, settings)
            rgb = quantize_u8(V3(img[0], img[1], img[2])).to_array()
            arr = rgb.cpu().numpy()  # the one transfer: the uint8 image
        log_event(
            "render_done", renderer=self.name, seconds=round(t.seconds, 3),
            mrays_per_sec=round(mrays_per_sec(settings.width, settings.height,
                                              settings.samples_per_pixel,
                                              settings.max_depth, t.seconds), 2),
        )
        return assemble_image(arr, settings.width, settings.height)
