"""Counter-based stateless RNG, bit-equal to the JAX package's ``ops/rng.py``.

Every random number is a pure function of (seed, pixel, sample, depth, use):
the murmur3 finalizer (fmix32) over the counter words, as in the JAX package.
No ``torch.Generator`` enters the render path.

torch has no usable ``uint32`` arithmetic (on the CPU ``uint32`` tensors have
no ``add`` or ``>>``, and ``int32 >>`` is an arithmetic shift), so the mixing
runs in int64 on values held in ``[0, 2**32)``.  A 32×32-bit product would
overflow int64, so ``_mul32`` multiplies by the two 16-bit halves of the
constant and keeps the low 32 bits of each partial product.

Keys travel as int32 tensors holding the uint32 bit pattern
(:func:`to_i32_bits`), which is what the CUDA kernels take; :func:`bits`
returns the uint32 value as int64 and :func:`uniform` a float32 in [0, 1)
from its top 24 bits.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_GAMMA_DEPTH = 0x9E3779B9
_GAMMA_USE = 0x85EBCA6B
_INC = 0x9E3779B9
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35


def to_u32(x) -> torch.Tensor:
    """Any integer tensor (int32 bit patterns included) → int64 in [0, 2**32)."""
    return torch.as_tensor(x).to(torch.int64) & _MASK


def to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2**32) → int32 with the same 32-bit pattern (explicit
    two's-complement fold, not a wrapping cast)."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2**32`` for ``h`` in [0, 2**32) without int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _MASK


def pcg_hash(x: torch.Tensor) -> torch.Tensor:
    """SplitMix increment, then murmur3 fmix32 (JAX ``rng.pcg_hash``)."""
    h = (to_u32(x) + _INC) & _MASK
    h = _mul32(h ^ (h >> 16), _M1)
    h = _mul32(h ^ (h >> 13), _M2)
    return h ^ (h >> 16)


def ray_key(seed, pixel_idx, sample_idx) -> torch.Tensor:
    """Per-(pixel, sample) stream key as int32 bits (JAX ``rng.ray_key``).
    Each argument is a Python int or an integer tensor (a 0-d int64 tensor
    on the lanes' device included: the path tracer's captured bounce blocks
    read the seed and the chunk's offsets so); all give the same bits over
    the whole unsigned range."""
    s = to_u32(seed)
    p = to_u32(pixel_idx)
    k = pcg_hash(p ^ _mul32(s, _GAMMA_DEPTH))
    return to_i32_bits(pcg_hash((k + _mul32(to_u32(sample_idx), _GAMMA_USE)) & _MASK))


def bits(key: torch.Tensor, depth, use) -> torch.Tensor:
    """Random uint32 (as int64) for a (stream, depth, use) counter triple."""
    d = to_u32(depth)
    h = pcg_hash(to_u32(key) ^ _mul32(d, _GAMMA_DEPTH))
    return pcg_hash((h + _mul32(to_u32(use), _GAMMA_USE)) & _MASK)


def uniform(key: torch.Tensor, depth, use) -> torch.Tensor:
    """Uniform float32 in [0, 1) from the top 24 bits (exact in float32)."""
    return (bits(key, depth, use) >> 8).to(torch.float32) * (1.0 / 16777216.0)
