"""The comparison that decides ``correct``: what the timed path answered,
against the plain reference (``reference/``), after the window has closed.

Which answers: every request of the window that returned, or, past the
configuration's budget (``check.paths_per_run`` paths over
``check.paths_per_request`` a request), a sample of them drawn from the
run's seed.  Of each, a sample of pixels drawn from the seed: all samples of
the request at those pixels, traced by the reference from the same scene
description, seed and sample range.

The numbers (each held to a limit in ``cells/<cell>.json``):

* ``sums_off_share`` (``render_sums``): the share of checked channels whose
  radiance sum differs from the reference's by more than
  ``SUM_ATOL + SUM_RTOL·|reference|``;
* ``pixels_off_share`` (``render``): the share of checked channels of the
  displayed uint8 image (ACES, truncating quantise, rows top-down) that
  differ from the reference's by more than ``PIXEL_TOL``;
* ``failed_requests``: requests of the window that raised, or whose sums are
  not finite or negative.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np

from .scenes import SceneData, camera12
from .traffic import SEED_MASK, Request, Shape

SUM_ATOL = 1e-3
SUM_RTOL = 1e-3
PIXEL_TOL = 1


def probe_pixels(cfg: dict, shape: Shape) -> int:
    """Pixels of each request the check compares."""
    return max(1, int(cfg["check"]["paths_per_request"]) // shape.samples)


def failed(requests: List[Request]) -> int:
    bad = 0
    for r in requests:
        if not r.ok or (r.answer is not None and not (np.isfinite(r.answer).all()
                                                      and (r.answer >= 0).all())):
            bad += 1
    return bad


def chosen(cfg: dict, requests: List[Request], seed: int) -> List[Request]:
    """The answered requests the check compares: all, or a sample drawn
    from ``seed`` where they exceed the budget."""
    ok = [r for r in requests if r.ok]
    n = max(1, int(cfg["check"]["paths_per_run"]) // int(cfg["check"]["paths_per_request"]))
    if len(ok) <= n:
        return ok
    pick = np.random.default_rng([seed & SEED_MASK, 2]).choice(len(ok), size=n, replace=False)
    return [ok[i] for i in sorted(pick)]


def group_pixels(shape: Shape, n: int, seed: int, index: int) -> np.ndarray:
    g = np.random.default_rng([seed & SEED_MASK, index, 3])
    return np.sort(g.choice(shape.width * shape.height, size=min(n, shape.width * shape.height),
                            replace=False))


class Reference:
    """The reference's answers at given pixels, on ``device`` in ``dtype``."""

    def __init__(self, cfg: dict, sd: SceneData, shape: Shape, device, dtype=None):
        import torch

        from .reference import pathtrace, tables

        torch.backends.cuda.matmul.allow_tf32 = False  # float32 means float32 on the card
        torch.backends.cudnn.allow_tf32 = False
        self.pt, self.shape = pathtrace, shape
        self.tb = tables.build(sd, device, torch.float32 if dtype is None else dtype)
        self.cam = camera12(sd.camera, shape.width / shape.height)
        self.light = cfg["shadow_tmax"] == "light"

    def sums(self, pixels, seed: int, sample0: int, samples: int) -> np.ndarray:
        s = self.shape
        return self.pt.render_pixels(self.tb, self.cam, pixels, seed, sample0, samples,
                                     width=s.width, height=s.height, max_depth=s.depth,
                                     shadow_light=self.light)

    def image(self, rows, cols, seed: int) -> np.ndarray:
        s = self.shape
        pix = self.pt.image_pixels(rows, cols, s.width, s.height)
        return self.pt.tonemap_u8(self.sums(pix, seed, 0, s.spp), s.spp, self.tb.dtype)


def program_values(shape: Shape, req: Request, pixels: np.ndarray):
    """What the program answered at the checked pixels of ``req``."""
    if shape.entry == "render_sums":
        return req.answer[pixels]
    return req.probe[2]


def compare(cfg: dict, shape: Shape, requests: List[Request], seed: int, ref: Reference,
            values: Callable = program_values) -> Tuple[Dict[str, float], dict]:
    """``(numbers, details)``: the check's numbers over ``requests`` against
    ``ref``; ``values(shape, req, pixels)`` gives the answers judged (the
    program's by default)."""
    n_pix = probe_pixels(cfg, shape)
    off = total = 0
    worst = 0.0
    checked = chosen(cfg, requests, seed)
    for req in checked:
        if shape.entry == "render_sums":
            pixels = group_pixels(shape, n_pix, seed, req.index)
            want = ref.sums(pixels, req.seed, req.sample0, req.samples)
            got = np.asarray(values(shape, req, pixels), np.float64)
            gap = np.abs(got - want)
            bad = ~(gap <= SUM_ATOL + SUM_RTOL * np.abs(want))  # NaN counts as off
        else:
            rows, cols, _ = req.probe
            want = ref.image(rows, cols, req.seed).astype(np.int64)
            got = np.asarray(values(shape, req, None), np.int64)
            gap = np.abs(got - want)
            bad = gap > PIXEL_TOL
        off += int(bad.sum())
        total += bad.size
        worst = max(worst, float(np.nanmax(gap)) if gap.size else 0.0)
    name = "sums_off_share" if shape.entry == "render_sums" else "pixels_off_share"
    numbers = {name: off / total if total else 1.0, "failed_requests": float(failed(requests))}
    return numbers, {"requests_checked": len(checked), "channels_checked": total,
                     "channels_off": off, "largest_gap": worst}
