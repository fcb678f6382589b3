"""Progressive sample-batched rendering with checkpoint/resume (port of the
JAX package's ``parallel/progressive.py``).

The reference hints at this (``CUDAPathTracer.frame_count`` reseeds the RNG
per render, ``cuda_path_tracer.py:739,809``) but never accumulates.  Here
spp is rendered in batches, the running radiance-sum buffer (plus the
sample count and a settings fingerprint) is saved as ``.npz`` after each
batch, and an interrupted render resumes from the last saved batch.  The
file's keys, dtypes and fingerprint are the JAX package's, so a checkpoint
written by either package loads in the other.

The RNG is counter-based over absolute sample indices, so a batch draws the
same samples as the same samples of a one-shot render.  Each batch's sums
are added on the host, while a one-shot render adds every sample of a pixel
onto one running sum on the device (``models/path_tracer._regen_chunk``), so
the two round differently; a resumed render equals an uninterrupted
progressive one bit for bit (the same batches, added in the same order).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..core.camera import Camera
from ..core.scene import RenderSettings, Scene
from ..ops.tonemap import quantize_u8
from ..ops.v3 import V3
from ..utils.image import assemble_image
from ..utils.logging import log_event


def _fingerprint(settings: RenderSettings, seed: int) -> np.ndarray:
    return np.asarray(
        [settings.width, settings.height, settings.samples_per_pixel,
         settings.max_depth, seed],
        dtype=np.int64,
    )


def save_state(path: str, sums: np.ndarray, samples_done: int, fp: np.ndarray):
    """Write the checkpoint atomically: a temporary file, then ``os.replace``."""
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, sums=sums, samples_done=np.int64(samples_done),
                        fingerprint=fp)
    os.replace(tmp, path)


def load_state(path: str, fp: np.ndarray):
    """``(sums, samples_done)`` of the checkpoint at ``path``, or
    ``(None, 0)`` when there is none or its fingerprint is not ``fp``."""
    if not path or not os.path.exists(path):
        return None, 0
    with np.load(path) as data:
        if not np.array_equal(data["fingerprint"], fp):
            log_event("progressive_checkpoint_mismatch", path=path)
            return None, 0
        return data["sums"].copy(), int(data["samples_done"])


def render_progressive(
    renderer,
    scene: Scene,
    camera: Camera,
    settings: RenderSettings,
    batch_spp: int,
    checkpoint_path: Optional[str] = None,
):
    """Render ``settings.samples_per_pixel`` in batches of ``batch_spp``,
    checkpointing after each batch; returns the final PIL image."""
    total = settings.samples_per_pixel
    fp = _fingerprint(settings, renderer.seed)
    sums, done = (None, 0)
    if checkpoint_path:
        sums, done = load_state(checkpoint_path, fp)
        if done:
            log_event("progressive_resume", samples_done=done, path=checkpoint_path)
    if sums is None:
        sums = np.zeros((settings.width * settings.height, 3), dtype=np.float32)

    while done < total:
        batch = min(batch_spp, total - done)
        sums += renderer.render_sums(
            scene, camera, settings, sample_offset=done, n_samples=batch
        )
        done += batch
        log_event("progressive_batch", samples_done=done, total=total)
        if checkpoint_path:
            save_state(checkpoint_path, sums, done, fp)

    img = renderer._finalize(sums, total, settings)
    rgb = quantize_u8(V3.from_array(torch.from_numpy(img)))
    return assemble_image(rgb.to_array().numpy(), settings.width, settings.height)
