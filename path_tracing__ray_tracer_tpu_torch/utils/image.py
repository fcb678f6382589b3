"""Image assembly: accumulation buffer → PIL, with the reference's Y flip.

The renderers generate rows bottom-up (``v = (y + dv) / height`` with y
counted from the bottom); the final image is flipped so row 0 is the top —
the same convention as the reference (``np.flip(axis=0)``,
``cuda_texture_renderer.py:780``).
"""
from __future__ import annotations

import numpy as np


def assemble_image(rgb_u8: np.ndarray, width: int, height: int):
    """``(H*W, 3)`` or ``(H, W, 3)`` uint8, bottom-up rows → PIL Image (top-down)."""
    from PIL import Image

    arr = np.asarray(rgb_u8, dtype=np.uint8).reshape(height, width, 3)
    arr = np.flip(arr, axis=0)
    return Image.fromarray(arr, "RGB")


def flip_rows(arr: np.ndarray, width: int, height: int) -> np.ndarray:
    return np.flip(np.asarray(arr).reshape(height, width, -1), axis=0)
