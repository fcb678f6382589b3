"""The readers of the program's own spans and counters (``record.py``):
each on a synthetic record, on a program that keeps no record, and on the
port's record after a tiny frame on the CPU.

    python -m pytest bench_port/tests -q
"""
from __future__ import annotations

import sys
import types

import pytest

from tiny import SEED, tiny

from bench_port import program, record, scenes, spec, traffic

US, MS = 1_000, 1_000_000  # nanoseconds
SYNTHETIC = {
    "block.host": [4, 4 * 150 * US], "finish": [3, 3 * 8 * MS],
    "lanes.slots": [1000, 0], "lanes.live": [870, 0],
}
WANT = {"lane_occupancy_pct": 87.0}


@pytest.mark.parametrize("name", sorted(WANT))
def test_readers_on_a_synthetic_record(name):
    run = types.SimpleNamespace(record=SYNTHETIC)
    for twin in ("final", "frames"):
        assert spec.reader(f"{name}.{twin}")(run) == pytest.approx(WANT[name])
        assert spec.reader(f"{name}.{twin}")(types.SimpleNamespace(record={})) is None


def test_finish_ms_on_a_synthetic_record():
    assert spec.reader("finish_ms")(types.SimpleNamespace(record=SYNTHETIC)) == pytest.approx(8.0)
    assert spec.reader("finish_ms")(types.SimpleNamespace(record={})) is None


def test_a_program_without_the_record_gives_nothing(monkeypatch):
    old = types.ModuleType("path_tracing__ray_tracer_tpu_torch.utils.profiling")
    monkeypatch.setitem(sys.modules, old.__name__, old)
    run = types.SimpleNamespace()
    assert record.of(run) == {}
    for name in [*(f"{n}.{t}" for n in WANT for t in ("final", "frames")), "finish_ms"]:
        assert spec.reader(name)(run) is None


def test_readers_on_the_ports_record_after_a_frame():
    """A tiny preview frame on the CPU: every reader finds its spans and
    counters."""
    import torch

    torch.set_num_threads(2)
    c = tiny("cornell-frames")
    shape = traffic.shape(c.config, c.traffic)
    sysm = program.make(scenes.describe(c.config["scene"]), c.config["renderer"], shape.width,
                        shape.height, shape.spp, shape.depth, seed=SEED & traffic.SEED_MASK,
                        device="cpu", **c.traffic.get("renderer_args", {}))
    sysm.renderer.render(sysm.scene, sysm.camera, sysm.settings)
    run = types.SimpleNamespace()
    got = {n: spec.reader(n)(run) for n in ("lane_occupancy_pct.final",
                                            "lane_occupancy_pct.frames", "finish_ms")}
    assert all(v is not None and v > 0 for v in got.values()), got
    assert got["lane_occupancy_pct.frames"] <= 100.0
