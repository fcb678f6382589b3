"""Numeric debugging helpers (port of the JAX package's ``utils/debug.py``).

The reference has no sanitizers (SURVEY.md §5: each CUDA thread writes only
its own pixel, nothing to race on).  The failure mode that matters is
numeric: NaN/Inf escaping a masked lane.  JAX's ``jax_debug_nans`` has no
torch counterpart, so :func:`debug_nans` turns on a check of each chunk's
radiance sums in ``WavefrontRenderer.device_sums``, which names the first
chunk that holds one (slow: one host sync a chunk; debugging only).
"""
from __future__ import annotations

import contextlib

import numpy as np

from .logging import log_event

_CHECK_NANS = False  # set within a debug_nans() scope


def nans_checked() -> bool:
    """Is a :func:`debug_nans` scope open?"""
    return _CHECK_NANS


def check_chunk(sums, chunk: int, pix0: int, n_pix: int):
    """Raise ``FloatingPointError`` naming the chunk when its ``(3, n_pix)``
    radiance sums hold a NaN or an Inf."""
    import torch

    bad = ~torch.isfinite(sums)
    count = int(bad.sum())
    if count:
        first = int(bad.any(0).nonzero()[0, 0])
        log_event("nonfinite_sums", chunk=chunk, pixel0=pix0, count=count,
                  first_pixel=pix0 + first)
        raise FloatingPointError(
            f"chunk {chunk} (pixels {pix0}-{pix0 + n_pix - 1}): {count} non-finite radiance "
            f"sums, first at pixel {pix0 + first}")


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Check each chunk's radiance sums for NaN/Inf within the scope."""
    global _CHECK_NANS

    if not enable:
        yield
        return
    old = _CHECK_NANS
    _CHECK_NANS = True
    try:
        yield
    finally:
        _CHECK_NANS = old


def assert_finite_image(img, context: str = "render") -> np.ndarray:
    """Host-side validation of a finished render; raises on NaN/Inf."""
    arr = np.asarray(img)
    bad = ~np.isfinite(arr.astype(np.float64))
    if bad.any():
        log_event(
            "nonfinite_pixels", context=context, count=int(bad.sum()),
            first_index=[int(i) for i in np.argwhere(bad)[0]],
        )
        raise FloatingPointError(
            f"{context}: {int(bad.sum())} non-finite pixel components"
        )
    return arr
