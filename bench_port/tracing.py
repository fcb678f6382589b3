"""The traced span of a ``--trace 1`` run: ``torch.profiler`` (host and
device activity) over a fixed part of the window, reduced to what the
per-layer readers need.

* device operations: every device event (kernels, copies, sets), its name
  and interval; the port's own kernels are those of the ``ptrt``
  namespace (``csrc/*.cu``), every other one is glue;
* busy time: the union of the device intervals; idle: the span less it;
* host launch calls: the runtime calls that launch device work
  (``cudaLaunchKernel``..., ``cudaGraphLaunch``);
* bounces: launches of the configuration's bounce wrapper in the span (the
  program's launch counters, which graph replays add to);
* idle gaps: each gap between busy intervals, named by the innermost host
  operation in flight at its middle.
"""
from __future__ import annotations

import collections
import heapq
import time
from typing import Dict, List, NamedTuple, Tuple

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cuGraphLaunch")


def is_port_kernel(name: str) -> bool:
    """Is the device event ``name`` one of the port's hand-written kernels
    (namespace ``ptrt``, demangled or mangled)?"""
    return "ptrt::" in name or "4ptrt" in name


class Span(NamedTuple):
    seconds: float  # host clock over the span, synchronised at both ends
    bounces: int
    ops: List[Tuple[str, float, float]]  # device events: name, start us, end us
    host: List[Tuple[str, float, float]]  # host events: name, start us, end us
    launch_calls: int
    untraced_s: float = None  # host clock over the same calls of a later request, untraced

    def busy_s(self) -> float:
        total, end = 0.0, float("-inf")
        for _, a, b in sorted(self.ops, key=lambda e: e[1]):
            if b <= end:
                continue
            total += b - max(a, end)
            end = b
        return total / 1e6

    def device_ms(self, port: bool) -> float:
        return sum(b - a for n, a, b in self.ops if is_port_kernel(n) == port) / 1e3

    def top_ops(self, k: int = 10) -> List[list]:
        by = collections.Counter()
        for n, a, b in self.ops:
            by[n] += (b - a) / 1e6
        return [[n[:200], s] for n, s in by.most_common(k)]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """Idle time summed by the host operation in flight at each gap's
        middle (the shortest host event covering it), the largest first."""
        ops = sorted(self.ops, key=lambda e: e[1])
        gaps, end = [], None
        for _, a, b in ops:
            if end is not None and a > end:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        host = sorted(self.host, key=lambda e: e[1])
        by = collections.Counter()
        live, j = [], 0  # host events begun by the sweep, a heap by end time
        for a, b in gaps:  # in time order
            mid = (a + b) / 2
            while j < len(host) and host[j][1] <= mid:
                heapq.heappush(live, (host[j][2], host[j][1], host[j][0]))
                j += 1
            while live and live[0][0] < mid:
                heapq.heappop(live)
            inner = min(live, key=lambda h: h[0] - h[1])[2] if live else "(no host event)"
            by[inner] += (b - a) / 1e6
        return [[n[:200], s] for n, s in by.most_common(k)]


class Profiler:
    """Start and stop the profiler around a span; ``bounces()`` reads the
    bounce wrapper's launch count."""

    def __init__(self, bounces):
        self._bounces = bounces
        self.span = None
        self._prof = None

    @staticmethod
    def warm() -> None:
        """One tiny profiled session, so that the profiler's first start-up
        (seconds of it) falls outside the span."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._b0 = self._bounces()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        seconds = time.perf_counter() - self._t0
        bounces = self._bounces() - self._b0
        self._prof.__exit__(None, None, None)
        ops, host, calls = [], [], 0
        for e in self._prof.events():
            a, b = e.time_range.start, e.time_range.end
            if e.device_type == torch.autograd.DeviceType.CUDA:
                ops.append((e.name, a, b))
            else:
                host.append((e.name, a, b))
                calls += e.name in LAUNCH_CALLS
        self._prof = None
        self.span = Span(seconds, bounces, ops, host, calls)

    @property
    def active(self) -> bool:
        return self._prof is not None


class Spans:
    """The traced span a mix names and its untraced twin, by the window's
    requests (``on_request(i)`` runs before the ``i``-th):

    * ``{"requests": [first, count]}``: requests ``first`` .. ``first+count-1``
      traced; the twin is the next ``count`` requests, untraced (each ends in
      a host transfer, so their latencies add up to the span's time);
    * ``{"chunks": [first, count]}``: the renderer's chunk calls ``first`` ..
      ``first+count-1`` of request 0 traced, and the same calls of request 1
      timed untraced (synchronised at both ends).

    The profiler slows the host (every graph node is traced), so the twin's
    time, not the traced span's, is what an idle share divides by."""

    def __init__(self, renderer, spec: dict, prof: Profiler):
        (self.kind, (self.first, self.count)), = spec.items()
        if self.kind not in ("requests", "chunks"):
            raise ValueError(f"unknown trace span {self.kind!r}")
        self.renderer, self.prof = renderer, prof
        self.untraced_s = None

    def on_request(self, i: int) -> None:
        if self.kind == "requests":
            if i == self.first:
                self.prof.start()
            elif i == self.first + self.count:
                self.prof.stop()
        elif i in (0, 1):
            self._wrap_chunks(traced=i == 0)

    def _wrap_chunks(self, traced: bool) -> None:
        import torch

        r, chunk, calls, t0 = self.renderer, self.renderer._chunk, [0], [0.0]
        last = self.first + self.count - 1

        def wrapped(*a, **k):  # the renderer's chunk calls of one request
            n = calls[0]
            calls[0] += 1
            if n == self.first:
                if traced:
                    self.prof.start()
                else:
                    torch.cuda.synchronize()
                    t0[0] = time.perf_counter()
            try:
                return chunk(*a, **k)
            finally:
                if n == last:
                    if traced:
                        self.prof.stop()
                    else:
                        torch.cuda.synchronize()
                        self.untraced_s = time.perf_counter() - t0[0]
                    del r._chunk  # the class's own method again

        r._chunk = wrapped

    def done(self, requests) -> bool:
        """Have the span and its twin passed (or the requests that would
        hold them, where a request has fewer chunk calls than the span)?"""
        if self.kind == "chunks":
            requests[0].traced = True
            return len(requests) >= 2
        for q in requests[self.first:self.first + self.count]:
            q.traced = True
        end = self.first + 2 * self.count
        if len(requests) >= end and self.untraced_s is None:
            self.untraced_s = sum(q.seconds for q in requests[self.first + self.count:end])
        return len(requests) >= end

    def result(self):
        if self.prof.active:  # a window that ended inside the span
            self.prof.stop()
        span = self.prof.span
        return None if span is None else span._replace(untraced_s=self.untraced_s)


def per_bounce(span: Span, value: float):
    return value / span.bounces if span is not None and span.bounces > 0 else None


def summary(span: Span) -> Dict[str, object]:
    """The device record and breakdown of a traced run."""
    return {"busy_s": span.busy_s(), "window_s": span.seconds,
            "breakdown": {"device_ops": span.top_ops(), "idle_gaps": span.idle_gaps()}}
