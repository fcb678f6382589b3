"""Texture-atlas sampling (JAX package ``ops/texture.py``; reference
``cuda_sample_texture``, ``cuda_texture_renderer.py:117-143``):
nearest-neighbour with V flip, one gather into the packed-int32 atlas.

The per-texture info lookup is plain indexing; the JAX package's select
chain copies the same rows bit for bit.
"""
from __future__ import annotations

import torch

from .v3 import V3

# The compacted per-bounce gather of the JAX package, gated off there as a
# measured loss (its ``ops/texture.py`` note): only the textured-hit lanes
# need a texel, so they are stably sorted to the front, one static prefix of
# ``N / TEX_COMPACT_DIV`` lanes is gathered and the texels are scattered
# back; a batch whose textured count overflows the prefix takes the full
# gather (the same texels either way).  Off by default here too.
TEX_COMPACT = False
TEX_COMPACT_DIV = 4
# below this lane count the full gather is taken (the JAX package's floor)
_COMPACT_MIN_LANES = 8192


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


def _gather_texels_compact(cs, textured, idx) -> torch.Tensor:
    """Packed int32 texels for the ``textured`` lanes through the compacted
    prefix gather (module note at ``TEX_COMPACT``): the lanes of the sorted
    prefix get ``atlas[idx]``, the others 0; the full gather when the
    textured count overflows the prefix."""
    n = int(idx.shape[0])
    cap = -(-n // TEX_COMPACT_DIV)
    if int(textured.sum()) > cap:  # host sync
        return cs.atlas[idx.long()]
    # textured lanes first; stable, so their lane order survives
    order = torch.argsort((~textured).to(torch.int8), stable=True)[:cap]
    tex = torch.zeros(n, dtype=cs.atlas.dtype, device=idx.device)
    tex[order] = cs.atlas[idx[order].long()]
    return tex


def resolve_base_color(cs, mat_color: V3, has_tex, tex_id, u, v) -> V3:
    """Texture sample where textured, material colour elsewhere
    (``cuda_texture_renderer.py:206-219``)."""
    if cs.any_textured.shape[0] == 0:
        # no textured primitive: the select below is identically mat_color
        return mat_color
    textured = has_tex > 0.5
    if TEX_COMPACT and textured.ndim == 1 and int(textured.shape[0]) >= _COMPACT_MIN_LANES:
        idx = _nearest_index(tex_id, u, v, cs.tex_width, cs.tex_height,
                             cs.tex_offset, cs.n_textures)
        # untextured lanes point at texel 0 (masked below)
        idx = torch.where(textured, idx, 0)
        rgb = _unpack_rgb(_gather_texels_compact(cs, textured, idx))
        return V3.where(textured, rgb, mat_color)
    sampled = sample_atlas(cs, torch.where(textured, tex_id, -1), u, v)
    return V3.where(textured, sampled, mat_color)


def resolve_base_color_lod(cs, mat_color: V3, tex_id_f, u, v, exact_lane) -> V3:
    """The texture-LOD resolve of the path tracer (``texture_lod`` mode):
    textured lanes with ``exact_lane`` True sample the full atlas, the
    others the small ``mip_budget`` atlas, through ``mip_gather`` (K9 on a
    CUDA tensor).  Lanes that do not read a table point at texel 0."""
    from .cuda.texture import mip_gather

    textured = tex_id_f >= 0.0
    tex_id = torch.where(textured, tex_id_f, 0.0).to(torch.int32)
    idx = _nearest_index(tex_id, u, v, cs.tex_width, cs.tex_height,
                         cs.tex_offset, cs.n_textures)
    take_exact = textured & exact_lane
    rgb_exact = _unpack_rgb(cs.atlas[torch.where(take_exact, idx, 0).long()])
    midx = _nearest_index(tex_id, u, v, cs.mip_width, cs.mip_height,
                          cs.mip_offset, cs.n_textures)
    rgb_mip = mip_gather(cs.mip_atlas, torch.where(textured & ~exact_lane, midx, 0)
                         .to(torch.int32).contiguous())
    rgb = V3.where(exact_lane, rgb_exact, rgb_mip)
    return V3.where(textured, rgb, mat_color)
