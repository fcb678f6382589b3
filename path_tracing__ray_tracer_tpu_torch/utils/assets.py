"""Texture asset resolution.

The reference ships seven JPEGs under ``textures/`` (six Rubik's-cube face
scans ~1300² px and the 2978×2393 canvas painting).  Since round 3 these are
vendored under ``textures/`` at the repo root (provenance documented in
``textures/PROVENANCE.md``) so a mount-less clone reproduces the parity
renders.  Resolution order at runtime:

1. ``$PTRT_TEXTURE_DIR`` if set,
2. ``textures/`` next to the repo root,
3. otherwise procedurally generated stand-ins (flat face color with a dark
   border, mimicking a Rubik's sticker; a gradient for the canvas) cached
   under ``textures_generated/``.

Renders are pixel-comparable with the reference only when the real files are
found (cases 1–2); the fallback keeps every test and demo runnable anywhere.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np

_TEXTURE_FILES = {
    "blue.jpg": (40, 80, 200),
    "green.jpg": (30, 160, 60),
    "orange.jpg": (240, 130, 20),
    "red.jpg": (200, 30, 30),
    "white.jpg": (235, 235, 235),
    "yellow.jpg": (250, 220, 30),
    "meinsf.jpg": None,  # canvas painting → gradient stand-in
}

_SEARCH_DIRS = [
    os.environ.get("PTRT_TEXTURE_DIR"),
    str(Path(__file__).resolve().parents[2] / "textures"),
]


def texture_dir() -> str:
    """Directory containing the texture set (generating stand-ins if needed)."""
    for d in _SEARCH_DIRS:
        if d and os.path.isdir(d) and all(
            os.path.isfile(os.path.join(d, f)) for f in _TEXTURE_FILES
        ):
            return d
    return _generate_stand_ins()


def texture_path(name: str) -> str:
    return os.path.join(texture_dir(), name)


def reference_render_path() -> str | None:
    """The reference's published 2000×1500 render (``output_RayTracer.png``),
    the RMSE comparison target: the copy vendored under
    ``reference_artifacts/`` (see ``textures/PROVENANCE.md``), or None."""
    p = Path(__file__).resolve().parents[2] / "reference_artifacts" / "output_RayTracer.png"
    return str(p) if p.is_file() else None


def _generate_stand_ins() -> str:
    from PIL import Image

    out_dir = Path(__file__).resolve().parents[2] / "textures_generated"
    out_dir.mkdir(exist_ok=True)
    for fname, color in _TEXTURE_FILES.items():
        path = out_dir / fname
        if path.exists():
            continue
        if color is not None:
            size = 256
            img = np.full((size, size, 3), color, dtype=np.uint8)
            border = size // 16
            img[:border], img[-border:] = (20, 20, 20), (20, 20, 20)
            img[:, :border], img[:, -border:] = (20, 20, 20), (20, 20, 20)
        else:
            h, w = 192, 240
            yy, xx = np.mgrid[0:h, 0:w]
            img = np.stack(
                [
                    (120 + 100 * xx / w).astype(np.uint8),
                    (90 + 80 * yy / h).astype(np.uint8),
                    (140 + 60 * (xx + yy) / (w + h)).astype(np.uint8),
                ],
                axis=-1,
            )
        Image.fromarray(img, "RGB").save(path, quality=92)
    return str(out_dir)
