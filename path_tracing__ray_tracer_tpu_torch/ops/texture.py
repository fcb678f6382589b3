"""Texture-atlas sampling (JAX package ``ops/texture.py``; reference
``cuda_sample_texture``, ``cuda_texture_renderer.py:117-143``):
nearest-neighbour with V flip, one gather into the packed-int32 atlas.

The per-texture info lookup is plain indexing; the JAX package's select
chain copies the same rows bit for bit.
"""
from __future__ import annotations

import torch

from .v3 import V3


def _nearest_index(tex_id, u, v, widths, heights, offsets, n_textures: int):
    """Flat texel index for nearest-neighbour + V-flip sampling."""
    tid = torch.clamp(tex_id, 0, n_textures - 1).long()
    w, h, off = widths[tid], heights[tid], offsets[tid]
    uu = torch.clamp(u, 0.0, 1.0)
    vv = torch.clamp(v, 0.0, 1.0)
    iu = torch.minimum(torch.clamp((uu * (w - 1).to(torch.float32)).to(torch.int32), min=0), w - 1)
    iv = torch.minimum(
        torch.clamp(((1.0 - vv) * (h - 1).to(torch.float32)).to(torch.int32), min=0), h - 1
    )
    return off + iv * w + iu


def _unpack_rgb(texel: torch.Tensor) -> V3:
    inv255 = 1.0 / 255.0
    return V3(
        (texel & 0xFF).to(torch.float32) * inv255,
        ((texel >> 8) & 0xFF).to(torch.float32) * inv255,
        ((texel >> 16) & 0xFF).to(torch.float32) * inv255,
    )


def sample_atlas(cs, tex_id: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> V3:
    """Sample RGB in [0, 1] for each ray; ``tex_id < 0`` yields white (the
    reference default, ``cuda_texture_renderer.py:143``)."""
    idx = _nearest_index(tex_id, u, v, cs.tex_width, cs.tex_height,
                         cs.tex_offset, cs.n_textures)
    rgb = _unpack_rgb(cs.atlas[idx.long()])
    white = torch.ones_like(u)
    return V3.where(tex_id >= 0, rgb, V3(white, white, white))


def resolve_base_color(cs, mat_color: V3, has_tex, tex_id, u, v) -> V3:
    """Texture sample where textured, material colour elsewhere
    (``cuda_texture_renderer.py:206-219``)."""
    if cs.any_textured.shape[0] == 0:
        # no textured primitive: the select below is identically mat_color
        return mat_color
    textured = has_tex > 0.5
    sampled = sample_atlas(cs, torch.where(textured, tex_id, -1), u, v)
    return V3.where(textured, sampled, mat_color)
