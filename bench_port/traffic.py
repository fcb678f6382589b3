"""The one general generator of the benchmark's traffic: a closed loop of
one client that sends its next request when the last one has returned.

A traffic mix (``traffic/<name>.json``) is data for it:

* ``entry``: ``render_sums`` (a request is one sample group of a frame,
  ``WavefrontRenderer.render_sums`` with ``sample_offset`` advancing, as
  progressive rendering calls it; a frame's groups take the same seed, the
  next frame the next seed) or ``render`` (a request is one whole frame,
  ``render()`` to the uint8 image on the host);
* ``group_samples``: the samples of one ``render_sums`` request;
* ``spp``: the frame's samples per pixel, where the mix sets them (else the
  configuration's ``frame``);
* ``renderer_args``: arguments the mix adds to the renderer's (e.g. the
  reference's per-render reseed);
* ``warmup``: requests sent in set-up, of the window's own shape;
* ``trace``: the span the profiler records in a ``--trace 1`` run:
  ``{"requests": [first, count]}`` (whole requests of the window) or
  ``{"chunks": [first, count]}`` (chunk calls of the window's first request).

Every request's inputs come from the run's ``--seed``: the same seed gives
the same requests.
"""
from __future__ import annotations

import time
from typing import List, NamedTuple, Optional

import numpy as np

SEED_MASK = 0xFFFFFFFF


class Shape(NamedTuple):
    entry: str
    width: int
    height: int
    spp: int  # of the frame
    depth: int
    samples: int  # of one request


def shape(cfg: dict, mix: dict) -> Shape:
    f = cfg["frame"]
    spp = int(mix.get("spp", f["spp"]))
    samples = int(mix["group_samples"]) if mix["entry"] == "render_sums" else spp
    if mix["entry"] not in ("render_sums", "render") or spp % samples:
        raise ValueError(f"traffic: entry {mix['entry']!r} with {samples} samples a request "
                         f"of a {spp}-spp frame")
    return Shape(mix["entry"], int(f["width"]), int(f["height"]), spp, int(f["depth"]), samples)


class Request:
    """One request as sent and answered."""

    __slots__ = ("index", "seed", "sample0", "samples", "t0", "t1", "ok", "error", "rays",
                 "answer", "probe", "traced")

    def __init__(self, index: int, seed: int, sample0: int, samples: int, rays: int):
        self.index, self.seed, self.sample0, self.samples = index, seed, sample0, samples
        self.rays = rays  # W·H·samples·depth: the reference's ray count of the request
        self.t0 = self.t1 = 0.0
        self.ok, self.error = False, None
        self.answer: Optional[np.ndarray] = None  # render_sums: (H*W, 3) float32 sums
        self.probe = None  # render: (rows, cols, (P, 3) uint8) of the displayed image
        self.traced = False  # under the profiler (a --trace 1 run's span)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Loop:
    """The closed loop over ``system`` (``program.System``) for ``mix``."""

    def __init__(self, system, cfg: dict, mix: dict, seed: int, probe_pixels: int = 0):
        self.system, self.mix, self.seed = system, mix, int(seed)
        self.shape = shape(cfg, mix)
        self.sent = 0  # requests sent, warm-up included
        self.probe_pixels = int(probe_pixels)  # pixels of each render() answer kept for the check

    def _next(self, index: int) -> Request:
        s = self.shape
        rays = s.width * s.height * s.samples * s.depth
        if s.entry == "render_sums":
            per_frame = s.spp // s.samples
            frame, group = divmod(index, per_frame)
            seed = (self.seed + frame) & SEED_MASK
            return Request(index, seed, group * s.samples, s.samples, rays)
        # render() reseeds itself per render: seed + renders done before
        return Request(index, (self.seed + self.sent) & SEED_MASK, 0, s.samples, rays)

    def send(self, req: Request) -> Request:
        """Send ``req`` and wait for its answer; an exception marks it failed."""
        r, sysm = self.system.renderer, self.system
        req.t0 = time.perf_counter()
        try:
            if self.shape.entry == "render_sums":
                r.seed = req.seed
                req.answer = r.render_sums(sysm.scene, sysm.camera, sysm.settings,
                                           sample_offset=req.sample0, n_samples=req.samples)
                req.t1 = time.perf_counter()
            else:
                img = r.render(sysm.scene, sysm.camera, sysm.settings)
                req.t1 = time.perf_counter()
                req.probe = self._probe(req, np.asarray(img))
            req.ok = True
        except Exception as e:  # a request that raises is a failed request, not a crash
            req.t1 = time.perf_counter()
            req.error = f"{type(e).__name__}: {e}"
        self.sent += 1
        return req

    def _probe(self, req: Request, img: np.ndarray):
        s = self.shape
        if img.shape != (s.height, s.width, 3) or img.dtype != np.uint8:
            raise ValueError(f"render() gave a {img.shape} {img.dtype} image")
        g = np.random.default_rng([self.seed & SEED_MASK, req.index, 1])
        flat = g.choice(s.width * s.height, size=min(self.probe_pixels, s.width * s.height),
                        replace=False)
        rows, cols = flat // s.width, flat % s.width
        return rows, cols, img[rows, cols].copy()

    def warm_up(self) -> List[Request]:
        """The mix's warm-up requests, of the window's shape, on seeds the
        window does not use (for ``render_sums``: the seed before the run's);
        one that fails counts with the window's failures."""
        out = []
        for i in range(int(self.mix.get("warmup", 1))):
            req = self._next(i)
            if self.shape.entry == "render_sums":
                req.seed = (self.seed - 1 - i) & SEED_MASK
            out.append(self.send(req))
        return out

    def window(self, seconds: float, spans=None) -> List[Request]:
        """Requests sent back to back from now until ``seconds`` have passed;
        the request in flight at the deadline finishes and counts.  With
        ``spans`` (``tracing.Spans``) its ``on_request(i)`` runs before the
        ``i``-th request, and the window goes on until its spans are done."""
        first = self.sent
        out = []
        self.start = start = time.perf_counter()
        deadline = start + seconds
        while True:
            i = len(out)
            req = self._next(i) if self.shape.entry == "render_sums" else self._next(first + i)
            if spans is not None:
                spans.on_request(i)
            out.append(self.send(req))
            if req.t1 >= deadline and (spans is None or spans.done(out)):
                return out
