"""The counter-hash RNG of the path tracer, as plain torch integer arithmetic.

Every random number is a pure function of (seed, pixel, sample, depth,
use): a SplitMix increment then the murmur3 finalizer (fmix32) over the
counter words, each uniform float from the top 24 bits of its hash.  Values
live in int64 in ``[0, 2**32)`` (torch lacks uint32 shifts and products on
every device); a 32x32-bit product is taken as two 16-bit halves so that it
never overflows int64.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
GAMMA_DEPTH = 0x9E3779B9
GAMMA_USE = 0x85EBCA6B
INC = 0x9E3779B9
M1, M2 = 0x85EBCA6B, 0xC2B2AE35


def u32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int64) & MASK


def mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2**32`` for ``h`` in ``[0, 2**32)``."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & MASK


def hash32(x: torch.Tensor) -> torch.Tensor:
    h = (u32(x) + INC) & MASK
    h = mul32(h ^ (h >> 16), M1)
    h = mul32(h ^ (h >> 13), M2)
    return h ^ (h >> 16)


def ray_key(seed: int, pixel: torch.Tensor, sample: torch.Tensor) -> torch.Tensor:
    """The stream key of (pixel, sample) under ``seed``, as a uint32 in int64."""
    k = hash32(u32(pixel) ^ mul32(u32(seed), GAMMA_DEPTH))
    return hash32((k + mul32(u32(sample), GAMMA_USE)) & MASK)


def uniform(key: torch.Tensor, depth: int, use: int, dtype=torch.float32) -> torch.Tensor:
    """A uniform number in ``[0, 1)`` for (key, depth, use)."""
    h = hash32(u32(key) ^ mul32(u32(depth), GAMMA_DEPTH))
    h = hash32((h + mul32(u32(use), GAMMA_USE)) & MASK)
    return ((h >> 8).to(torch.float32) * (1.0 / 16777216.0)).to(dtype)
