"""Texture gathers: the CUDA kernels ``csrc/texture_gather.cu`` (K8, K9),
their plain torch versions, and the resolves that call them.

The kernels replace the JAX package's
``ops/pallas/texture_pallas.py::_gather_kernel`` (entered there through
``mxu_gather_rgb``) and ``::_mip_kernel`` (``mip_gather_rgb``).  The JAX
tables are three bf16 one-hot planes of ``(R, 128)``; the port keeps the
packed int32 atlas as its table, and each lane reads its own texel.

* :func:`atlas_gather` (K8) serves the gated atlas route of the path
  tracer's resolve (:func:`resolve_base_color_mxu`, taken when
  :func:`fits_mxu_atlas`: ``ENABLED`` and at most ``MAX_ROWS`` rows of 128
  texels, the JAX package's gate);
* :func:`mip_gather` (K9) serves the deferred-texture resolve
  (:func:`resolve_base_color_mip`, gated by :func:`fits_mip`) and the mip
  lanes of the texture-LOD resolve (``ops/texture.resolve_base_color_lod``).

Both clamp an index to ``[0, 128·R - 1]`` and read texel 0 past the atlas
(the zero padding of the TPU planes); they are one device function under
two launch symbols, and :func:`gather_plain` is the plain version of both.
A CUDA tensor goes to the kernel (the wrapper raises on what the kernel
does not take); a CPU tensor takes the plain version.

The gates are the JAX package's on purpose, so that a scene takes the same
route on both packages: ``MAX_ROWS`` and ``MIP_MAX_ROWS`` are its VMEM caps
and the path tracer's 1024-lane chunk rule is its tiling rule; the CUDA
kernels have neither limit.  So ``PathTracer(mip_budget=...)`` whose mip
exceeds ``MIP_MAX_ROWS`` renders the exact path, as in the JAX package.
The texture-LOD resolve reads its mip through K9 with no row cap, where the
JAX package takes a plain gather.
"""
from __future__ import annotations

import ctypes

import torch

from ..texture import _unpack_rgb
from ..v3 import V3
from .bounce import _check

MAX_ROWS = 1024  # rows of 128 texels the atlas route takes (the JAX package's VMEM cap)
MIP_MAX_ROWS = 512  # the same for the deferred-texture mip
ENABLED = False  # the atlas route is off by default, as in the JAX package


def atlas_rows(cs) -> int:
    return -(-int(cs.atlas.shape[0]) // 128)


def fits_mxu_atlas(cs) -> bool:
    return ENABLED and atlas_rows(cs) <= MAX_ROWS


def mip_rows(cs) -> int:
    return -(-int(cs.mip_atlas.shape[0]) // 128)


def fits_mip(cs) -> bool:
    return cs.mip_atlas is not None and mip_rows(cs) <= MIP_MAX_ROWS


def _index(tex_id_f, u, v, widths, heights, offsets, n_textures: int) -> torch.Tensor:
    """Flat int32 texel index per lane (nearest, V flip); untextured lanes
    clamp to texture 0 and are masked by the caller."""
    textured = tex_id_f >= 0.0
    tid = torch.clamp(torch.where(textured, tex_id_f, 0.0).to(torch.int32), 0,
                      n_textures - 1).long()
    w, h, off = widths[tid], heights[tid], offsets[tid]
    uu = torch.clamp(u, 0.0, 1.0)
    vv = torch.clamp(v, 0.0, 1.0)
    iu = torch.minimum(torch.clamp((uu * (w - 1).to(torch.float32)).to(torch.int32), min=0), w - 1)
    iv = torch.minimum(
        torch.clamp(((1.0 - vv) * (h - 1).to(torch.float32)).to(torch.int32), min=0), h - 1)
    return off + iv * w + iu


def texel_index(cs, tex_id_f, u, v) -> torch.Tensor:
    """Flat texel index into the atlas (``ops.texture.sample_atlas``'s mapping)."""
    return _index(tex_id_f, u, v, cs.tex_width, cs.tex_height, cs.tex_offset, cs.n_textures)


def mip_texel_index(cs, tex_id_f, u, v) -> torch.Tensor:
    """Flat texel index into the mip atlas (the same mapping over the mip tables)."""
    return _index(tex_id_f, u, v, cs.mip_width, cs.mip_height, cs.mip_offset, cs.n_textures)


# ---- the plain version --------------------------------------------------------
def gather_plain(table: torch.Tensor, idx: torch.Tensor) -> V3:
    """RGB in [0, 1] of the flat texels ``idx`` of a packed int32 atlas or
    mip: the plain version of both kernels (the JAX ``mxu_gather_rgb`` and
    ``mip_gather_rgb``)."""
    n = int(table.shape[0])
    k = torch.clamp(idx, 0, -(-n // 128) * 128 - 1).long()
    texel = torch.where(k < n, table[torch.clamp(k, max=n - 1)], 0)
    return _unpack_rgb(texel)


# ---- the kernels ------------------------------------------------------------------
_P, _I = ctypes.c_void_p, ctypes.c_int


def build():
    """Compile (once per source hash) and load ``csrc/texture_gather.cu``."""
    from . import build as _build

    built = _build.load("texture_gather")
    for fn in (built.lib.ptrt_atlas_gather, built.lib.ptrt_mip_gather):
        fn.argtypes = [_P, _I, _P, _P, _I, _P]
        fn.restype = ctypes.c_int
    return built


def _gather(wrapper, table, idx) -> V3:
    """The gather of ``wrapper`` (``atlas_gather`` or ``mip_gather``): its
    kernel on a CUDA tensor, counted on ``wrapper.launches``; the plain
    version on a CPU one."""
    who = wrapper.__name__
    device = idx.device
    if device.type == "cpu":
        return gather_plain(table, idx)
    if device.type != "cuda":
        raise ValueError(f"{who}: no kernel for device {device}")
    n = idx.numel()
    _check("idx", idx, torch.int32, n, device, who)
    _check("table", table, torch.int32, table.numel(), device, who)
    if table.numel() == 0:
        raise ValueError(f"{who}: the table is empty")
    out = torch.empty((3, n), dtype=torch.float32, device=device)
    err = getattr(build().lib, "ptrt_" + who)(table.data_ptr(), int(table.shape[0]),
                                              idx.data_ptr(), out.data_ptr(), n,
                                              torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{who}: kernel launch failed with cudaError {err}")
    wrapper.launches += 1
    return V3(out[0], out[1], out[2])


def atlas_gather(atlas: torch.Tensor, idx: torch.Tensor) -> V3:
    """RGB in [0, 1] of the flat atlas texels ``idx`` (int32, (N,)): K8."""
    return _gather(atlas_gather, atlas, idx)


def mip_gather(mip: torch.Tensor, idx: torch.Tensor) -> V3:
    """RGB in [0, 1] of the flat mip texels ``idx`` (int32, (N,)): K9."""
    return _gather(mip_gather, mip, idx)


atlas_gather.launches = 0  # kernel launches; the plain version does not count
mip_gather.launches = 0


# ---- the resolves ------------------------------------------------------------------
def resolve_base_color_mxu(cs, mat_color: V3, tex_id_f, u, v) -> V3:
    """The atlas route of the path tracer's resolve: the texel through
    :func:`atlas_gather` where textured, the material colour elsewhere."""
    rgb = atlas_gather(cs.atlas, texel_index(cs, tex_id_f, u, v).contiguous())
    return V3.where(tex_id_f >= 0.0, rgb, mat_color)


def resolve_base_color_mip(cs, mat_color: V3, tex_id_f, u, v) -> V3:
    """The deferred-texture resolve of bounces past the camera's: the mip
    texel through :func:`mip_gather` where textured, the material colour
    elsewhere."""
    rgb = mip_gather(cs.mip_atlas, mip_texel_index(cs, tex_id_f, u, v).contiguous())
    return V3.where(tex_id_f >= 0.0, rgb, mat_color)
