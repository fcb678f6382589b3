"""The port's spans and counters (``utils/profiling``) on the CPU.

* A path-traced ``render()`` records one ``render``, one ``device_sums`` and
  one ``finish``, one ``chunk`` per chunk call and one ``drive`` per drive;
  per drive one more ``block.wait`` than ``block.host`` (the last check finds
  no lane left), one ``block.eager`` per block on the CPU, and
  ``0 < lanes.live <= lanes.slots``.
* ``render_done``'s seconds are the ``render`` span's.
* With no profiler, no profiler range is opened; under
  ``torch.profiler.profile`` the spans are ``ptrt.*`` host ranges (operator
  ranges, not user annotations, which the profiler would mirror onto the
  card's timeline) among the profiler's events, and the record's timed
  entries do not grow (its counters do).  A span that the profiler starts or
  stops inside, or that holds a span opened under it, adds nothing.
* A plan that ``graph_gate`` keeps eager on the card logs one
  ``graphs_declined`` with the reason.
* ``lanes.live`` counts the lanes unfinished before each bounce of each
  block, exactly: the eager loop's count.
* ``record()`` is a copy; ``add_record`` adds a worker's part under
  ``worker.<name>``.
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import path_tracing__ray_tracer_tpu_torch as pt
from path_tracing__ray_tracer_tpu_torch.models import path_tracer as tpath
from path_tracing__ray_tracer_tpu_torch.models import wavefront
from path_tracing__ray_tracer_tpu_torch.ops import texture as ttexture
from path_tracing__ray_tracer_tpu_torch.utils import profiling
from path_tracing__ray_tracer_tpu_torch.utils.profiling import add_record, record, span
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SETTINGS = pt.RenderSettings(width=32, height=24, samples_per_pixel=4, max_depth=3)
SMALL = pt.RenderSettings(width=32, height=24, samples_per_pixel=2, max_depth=2)
SPANS = ("render", "finish", "device_sums", "chunk", "drive", "block.wait", "block.host",
         "block.eager")


@pytest.fixture(scope="module")
def cornell():
    b = pt.CustomSceneBuilder()
    scene, cam = b.build_scene(), b.create_camera(4.0 / 3.0)
    r = pt.RendererFactory.create("cuda_path_raytracer", seed=5, sample_group=2, device="cpu")
    r.compiled(scene)
    return r, scene, cam


def delta(before, after):
    return {k: [n - before.get(k, (0, 0))[0], ns - before.get(k, (0, 0))[1]]
            for k, (n, ns) in after.items() if [n, ns] != list(before.get(k, (0, 0)))}


def calls(monkeypatch, owner, name):
    """Count the calls of ``owner.name`` from now on."""
    seen, fn = [0], getattr(owner, name)

    def counted(*a, **k):
        seen[0] += 1
        return fn(*a, **k)

    monkeypatch.setattr(owner, name, counted)
    return seen


def test_render_records_its_spans_and_lanes(cornell, monkeypatch):
    r, scene, cam = cornell
    drives = calls(monkeypatch, tpath.BounceBlocks, "drive")
    chunks = calls(monkeypatch, r, "_chunk")
    before = record()
    r.render(scene, cam, SETTINGS)
    d = delta(before, record())
    assert chunks[0] == 2 and drives[0] == 2  # one chunk of pixels, two sample groups
    assert [d[k][0] for k in ("render", "device_sums", "finish")] == [1, 1, 1]
    assert d["chunk"][0] == chunks[0] and d["drive"][0] == drives[0]
    assert d["block.wait"][0] == d["block.host"][0] + drives[0]
    assert d["block.eager"][0] == d["block.host"][0] > 0
    assert "block.replay" not in d and "graph.capture" not in d
    assert 0 < d["lanes.live"][0] <= d["lanes.slots"][0]
    assert d["lanes.slots"][1] == d["lanes.live"][1] == 0
    assert all(d[k][1] > 0 for k in SPANS)
    assert d["finish"][1] + d["device_sums"][1] <= d["render"][1]
    assert d["drive"][1] <= d["chunk"][1] and d["block.eager"][1] <= d["drive"][1]


def test_lanes_live_counts_the_unfinished_lanes_of_every_bounce(cornell, monkeypatch):
    _, scene, cam = cornell
    seen = [0, 0]  # lanes unfinished before a bounce, lanes the bounce ran over
    init = tpath.BounceBlocks.__init__

    def counting(self, step, k, n_samples, graphed, device):
        def counted(st):
            seen[0] += int((st["s"] < n_samples).sum())
            seen[1] += int(st["s"].shape[0])
            return step(st)

        init(self, counted, k, n_samples, graphed, device)

    monkeypatch.setattr(tpath.BounceBlocks, "__init__", counting)
    r = pt.RendererFactory.create("cuda_path_raytracer", seed=6, sample_group=2, device="cpu")
    before = record()
    r.render(scene, cam, SETTINGS)  # a renderer of its own: plans made with the counting step
    d = delta(before, record())
    assert d["lanes.live"][0] == seen[0] and d["lanes.slots"][0] == seen[1]
    assert 0 < seen[0] < seen[1]


def test_render_done_seconds_are_the_render_span(cornell, monkeypatch):
    r, scene, cam = cornell
    logged = []
    monkeypatch.setattr(wavefront, "log_event", lambda event, **f: logged.append((event, f)))
    before = record()
    r.render(scene, cam, SETTINGS)
    ns = delta(before, record())["render"][1]
    (fields,) = [f for e, f in logged if e == "render_done"]
    assert fields["seconds"] == round(ns / 1e9, 3)
    rays = SETTINGS.width * SETTINGS.height * SETTINGS.samples_per_pixel * SETTINGS.max_depth
    assert fields["mrays_per_sec"] == round(rays / (ns / 1e9) / 1e6, 2)


def test_no_profiler_opens_no_range(cornell, monkeypatch):
    r, scene, cam = cornell

    def refused(*a, **k):
        raise AssertionError("a profiler range opened with no profiler")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refused)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refused)
    before = record()
    r.render(scene, cam, SETTINGS)
    assert delta(before, record())["render"][0] == 1


def test_profiled_render_gives_ranges_and_no_record_time(cornell):
    r, scene, cam = cornell
    before = record()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.render(scene, cam, SMALL)
    d = delta(before, record())
    ranges = {e.name: e for e in prof.events() if e.name.startswith("ptrt.")}
    assert set(ranges) == {"ptrt." + k for k in SPANS}
    # operator ranges (scope 0), which the profiler keeps off the card's timeline
    assert all(e.device_type == torch.autograd.DeviceType.CPU and e.scope == 0
               for e in ranges.values())
    assert set(d) == {"lanes.slots", "lanes.live"}  # counters count either way
    assert 0 < d["lanes.live"][0] <= d["lanes.slots"][0]


@pytest.mark.parametrize("where", ["starts inside", "stops inside", "runs inside"])
def test_a_span_the_profiler_reaches_adds_nothing(where):
    name = f"test.outer.{where}"
    prof = profile(activities=[ProfilerActivity.CPU])
    if where == "stops inside":
        prof.__enter__()
    with span(name):
        if where != "stops inside":
            prof.__enter__()
        with span("test.inner"):
            pass
        if where != "starts inside":
            prof.__exit__(None, None, None)
    if where == "starts inside":
        prof.__exit__(None, None, None)
    assert name not in record() and "test.inner" not in record()
    with span(name):
        pass
    assert record()[name][0] == 1


def test_graphs_declined_is_logged_with_its_reason(cornell, monkeypatch):
    r, scene, _ = cornell
    cs = r.compiled(scene)
    logged = []
    monkeypatch.setattr(tpath, "log_event", lambda event, **f: logged.append((event, f)))
    card = torch.device("cuda", 0)  # asked of the gate alone: no card is touched
    assert tpath.graphed(card, cs) and not tpath.graphed(torch.device("cpu"), cs)
    assert logged == []
    monkeypatch.setattr(ttexture, "TEX_COMPACT", True)
    assert not tpath.graphed(card, cs)
    assert logged == [("graphs_declined", {"reason": tpath.graph_gate(cs), "device": "cuda:0"})]


def test_record_is_a_copy_and_add_record_adds(monkeypatch):
    monkeypatch.setattr(profiling, "_RECORD", {"drive": [2, 50]})
    got = record()
    got["drive"][0] = 99
    add_record({"drive": [3, 7], "lanes.live": [40, 0]})
    add_record({"drive": [1, 3]})
    assert record() == {"drive": [2, 50], "worker.drive": [4, 10], "worker.lanes.live": [40, 0]}
