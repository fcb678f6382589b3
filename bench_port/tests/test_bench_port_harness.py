"""The harness on the CPU: arguments, finding pieces by name, the metrics'
arithmetic, and a rehearsal of a whole run with the port's plain versions.

    python -m pytest bench_port/tests -q
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import types

import pytest

from tiny import ROOT, SEED, tiny

from bench_port import check, run, scenes, spec, traffic

CELLS = ("cornell-final", "icospheres-final", "cornell-frames")


def test_arguments():
    a = run.parse(["--workload", "cornell-final", "--seed", str(2**31 + 7), "--seconds", "40",
                   "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == ("cornell-final", 2**31 + 7, 40.0, 1)
    assert run.parse(["--workload", "x", "--seed", "1", "--seconds", "1"]).trace == 0
    with pytest.raises(SystemExit):
        run.parse(["--workload", "x", "--seed", "1", "--seconds", "1", "--trace", "2"])


@pytest.mark.parametrize("name", CELLS)
def test_cells_find_their_files(name):
    c = spec.cell(name)
    assert c.chips == 1 and c.config["frame"]["width"] > 0 and c.traffic["entry"]
    assert set(c.limits) >= {"failed_requests"}
    bench = spec.benchmark()
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    assert c.per_layer and all(name in m["workloads"] for m in c.per_layer)
    shape = traffic.shape(c.config, c.traffic)
    assert shape.spp % shape.samples == 0 and check.probe_pixels(c.config, shape) >= 64
    assert c.config["bounce_wrapper"] in ("bounce.path_bounce", "bounce_bvh.path_bounce_bvh")
    sd = scenes.describe(c.config["scene"])
    assert len(sd.tri_v) == len(sd.tri_mat) and len(sd.lights) == 16


def test_unknown_cell_and_metric():
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric")


def test_new_pieces_are_files_alone(tmp_path):
    """A configuration, a mix, a metric and a cell added as new files and
    entries; nothing that exists is edited."""
    here = tmp_path / "bench_port"
    shutil.copytree(ROOT / "bench_port", here, ignore=shutil.ignore_patterns("__pycache__"))
    (here / "metrics" / "throwaway_share.py").write_text(
        "def read(run):\n    return 100.0 * len(run.requests) / (len(run.requests) + 1)\n")
    (here / "configs" / "cornell_small.json").write_text(
        (here / "configs" / "cornell_box.json").read_text())
    (here / "traffic" / "two_frames.json").write_text(json.dumps({"entry": "render", "spp": 2}))
    (here / "cells" / "cornell-two.json").write_text(json.dumps(
        {"limits": {"pixels_off_share": 0.01, "failed_requests": 0}}))
    bench = spec.benchmark()
    bench["configs"].append(dict(bench["configs"][0], name="cornell_small"))
    bench["workloads"].append({"name": "cornell-two", "config": "cornell_small",
                               "traffic": "two_frames", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "throwaway_share", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "renderer",
                               "moves": "frame_p95_ms", "workloads": ["cornell-two"]})
    bench["end_to_end"][1]["workloads"].append("cornell-two")
    c = spec.cell("cornell-two", bench, here)
    assert [m["name"] for m in c.per_layer] == ["throwaway_share"]
    assert {m["name"] for m in c.end_to_end} == {"frame_p95_ms", "setup_s"}
    assert traffic.shape(c.config, c.traffic).spp == 2
    fake = types.SimpleNamespace(requests=[1, 2, 3])
    assert spec.reader("throwaway_share", here)(fake) == 75.0


def _requests(seconds, ok=None):
    reqs, t = [], 10.0
    for i, s in enumerate(seconds):
        r = traffic.Request(i, 0, 0, 4, rays=1_000_000)
        r.t0, r.t1, r.ok = t, t + s, True if ok is None else ok[i]
        t += s
        reqs.append(r)
    return reqs


def test_rate_and_tail_see_one_stall():
    rate, p95, p50 = (spec.reader(n) for n in ("mrays_per_s", "frame_p95_ms", "frame_p50_ms"))
    groups = traffic.Shape("render_sums", 8, 8, 8, 4, 4)
    frames = traffic.Shape("render", 8, 8, 4, 4, 4)
    steady = [0.1] * 200
    stalled = [0.1] * 199 + [2.0]
    base = types.SimpleNamespace(window_start=10.0, shape=groups, requests=_requests(steady))
    slow = types.SimpleNamespace(window_start=10.0, shape=groups, requests=_requests(stalled))
    assert rate(base) == pytest.approx(200 * 1.0 / 20.0)
    assert rate(slow) == pytest.approx(200 * 1.0 / 21.9)
    # the tail: 10 slow frames of 200 move the 95th percentile, not the median
    tail = [0.1] * 190 + [0.5] * 10
    run_t = types.SimpleNamespace(window_start=10.0, shape=frames, requests=_requests(tail))
    run_s = types.SimpleNamespace(window_start=10.0, shape=frames, requests=_requests(steady))
    assert p95(run_s) == pytest.approx(100.0) and p95(run_t) == pytest.approx(100.0)
    tail11 = [0.1] * 189 + [0.5] * 11
    run_11 = types.SimpleNamespace(window_start=10.0, shape=frames, requests=_requests(tail11))
    assert p95(run_11) == pytest.approx(500.0) and p50(run_11) == pytest.approx(100.0)
    # a failed frame counts as missing every limit
    failed = _requests(steady, ok=[True] * 189 + [False] * 11)
    assert math.isinf(p95(types.SimpleNamespace(window_start=10.0, shape=frames,
                                                requests=failed)))
    # a rate is no metric of a frame cell, nor a tail of a group cell
    assert rate(run_s) is None and p95(base) is None


def test_traced_span_arithmetic():
    from bench_port import tracing

    ops = [("void ptrt::path_bounce_persistent<1>(Args)", 0.0, 10.0),
           ("elementwise_kernel", 5.0, 20.0), ("elementwise_kernel", 40.0, 50.0)]
    host = [("cudaGraphLaunch", 0.0, 60.0), ("cudaStreamSynchronize", 21.0, 39.0)]
    s = tracing.Span(seconds=100e-6, bounces=2, ops=ops, host=host, launch_calls=3,
                     untraced_s=60e-6)
    assert s.busy_s() == pytest.approx(30e-6)
    assert s.device_ms(port=True) == pytest.approx(0.01)
    assert s.device_ms(port=False) == pytest.approx(0.025)
    assert s.idle_gaps() == [["cudaStreamSynchronize", pytest.approx(20e-6)]]
    run_ = types.SimpleNamespace(span=s)
    # idle over the untraced time of the same calls, not the traced span's
    assert spec.reader("device_idle_pct.final")(run_) == pytest.approx(50.0)
    assert spec.reader("device_idle_pct.frames")(
        types.SimpleNamespace(span=s._replace(untraced_s=None))) is None
    assert spec.reader("device_ops_per_bounce")(run_) == pytest.approx(1.5)
    assert spec.reader("host_launches_per_bounce.frames")(run_) == pytest.approx(1.5)
    assert spec.reader("kernel_ms_per_bounce")(run_) == pytest.approx(0.005)
    assert spec.reader("glue_ms_per_bounce")(types.SimpleNamespace(span=None)) is None


REHEARSAL = """
import json, sys
sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(2)
from tiny import tiny, SEED
from bench_port import run
out = run.execute(tiny({name!r}), SEED, 0.5, False, "cpu")
print(json.dumps({{"result": out, "foreign": run.foreign_modules(),
                  "port": "path_tracing__ray_tracer_tpu_torch" in sys.modules}}))
"""


@pytest.mark.parametrize("name", ["cornell-final", "cornell-frames"])
def test_rehearsal_of_a_run_on_the_cpu(name):
    """A whole run with the port's plain versions: the result line's keys,
    a correct check, and no JAX or JAX package module in the process."""
    code = REHEARSAL.format(tests=str(ROOT / "bench_port" / "tests"), name=name)
    env = dict(os.environ, PTRT_LOG_LEVEL="WARNING")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                       timeout=600, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    out = got["result"]
    assert got["foreign"] == [] and got["port"]
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "check"
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert "setup_s" in out["metrics"]
    assert all(v["value"] <= v["limit"] for v in out["check"].values())


def test_run_without_a_card_prints_nothing(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "cornell-final", "--seed", str(SEED), "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_tiny_cells_keep_their_shape():
    c = tiny("icospheres-final")
    assert c.config["renderer"]["args"]["compile_overrides"] == {"use_bvh": True}
    assert traffic.shape(c.config, c.traffic).samples == 4


def test_spans_end_after_the_span_and_its_twin():
    from bench_port import tracing

    class Prof:
        span, active = None, False

        def start(self):
            self.active = True

        def stop(self):
            self.active, self.span = False, tracing.Span(1.0, 10, [("k", 0.0, 5e5)], [], 4)

    prof = Prof()
    spans = tracing.Spans(None, {"requests": [1, 2]}, prof)
    reqs = _requests([0.1, 0.2, 0.3, 0.4, 0.5, 0.6])
    for i in range(6):
        spans.on_request(i)
        assert spans.done(reqs[:i + 1]) is (i >= 4)
    assert prof.span is not None and spans.untraced_s == pytest.approx(0.9)
    assert spans.result().untraced_s == pytest.approx(0.9)
    with pytest.raises(ValueError):
        tracing.Spans(None, {"frames": [1, 2]}, prof)
