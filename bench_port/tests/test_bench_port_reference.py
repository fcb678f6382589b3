"""The plain reference against the port on the CPU, at tiny frames: the
port runs its plain torch versions there.  And the reference's imports:
nothing of the program, nothing of JAX.

    python -m pytest bench_port/tests -q
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tiny import ROOT, SEED, tiny

from bench_port import program, scenes, traffic
from bench_port.reference import pathtrace, tables


def _both(name, width, height, depth, samples, sample0=256):
    import torch

    torch.set_num_threads(2)
    c = tiny(name, width, height, depth)
    sd = scenes.describe(c.config["scene"])
    s = program.make(sd, c.config["renderer"], width, height, samples, depth, seed=SEED & 0xFFFFFFFF,
                     device="cpu")
    s.renderer.sample_group = samples
    port = s.renderer.render_sums(s.scene, s.camera, s.settings, sample_offset=sample0,
                                  n_samples=samples)
    ref = pathtrace.render_pixels(tables.build(sd, "cpu"), scenes.camera12(sd.camera, width / height),
                                  np.arange(width * height), SEED & 0xFFFFFFFF, sample0, samples,
                                  width=width, height=height, max_depth=depth,
                                  shadow_light=c.config["shadow_tmax"] == "light")
    return port.astype(np.float64), ref


def test_reference_agrees_with_the_port_on_the_cornell_box():
    port, ref = _both("cornell-final", 24, 16, 8, 4)
    gap = np.abs(port - ref)
    # the port merges the cubes' and canvas's triangle pairs into quads, the
    # reference keeps triangles: a few ulps on the paths that meet them
    assert (gap == 0).mean() > 0.8
    assert (gap <= 1e-3 + 1e-3 * np.abs(ref)).all()
    assert ref.mean() > 0.5


def test_reference_agrees_with_the_port_on_the_icosphere_grid():
    port, ref = _both("icospheres-final", 16, 9, 6, 2)
    assert np.abs(port - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())


def test_displayed_image_rows_run_top_down():
    rows, cols = np.array([0, 15]), np.array([3, 3])
    assert list(pathtrace.image_pixels(rows, cols, 24, 16)) == [15 * 24 + 3, 3]
    assert pathtrace.tonemap_u8(np.array([[0.0, 4.0, 400.0]]), 4).tolist() == [[0, 204, 255]]


def test_reference_sums_add_samples_in_order():
    sd = scenes.describe(tiny("cornell-final").config["scene"])
    tb = tables.build(sd, "cpu")
    cam = scenes.camera12(sd.camera, 1.5)
    kw = dict(width=24, height=16, max_depth=6, shadow_light=False)
    whole = pathtrace.render_pixels(tb, cam, [5, 77], 9, 0, 4, **kw)
    parts = sum(pathtrace.render_pixels(tb, cam, [5, 77], 9, s, 1, **kw) for s in range(4))
    np.testing.assert_allclose(whole, parts, rtol=1e-6)
    assert not np.array_equal(whole, pathtrace.render_pixels(tb, cam, [5, 77], 10, 0, 4, **kw))


def test_textures_are_pinned():
    c = tiny("cornell-final").config["scene"]
    bad = json.loads(json.dumps(c))
    bad["textures"]["red"]["sha256"] = "0" * 64
    with pytest.raises(ValueError):
        scenes.describe(bad)


def test_the_reference_imports_nothing_of_the_program_or_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import bench_port.reference.pathtrace, bench_port.reference.tables, bench_port.check\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))") % str(ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       env=dict(os.environ))
    assert p.returncode == 0, p.stderr
    top = set(json.loads(p.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert not top & {"jax", "jaxlib", "flax", "path_tracing__ray_tracer_tpu",
                      "path_tracing__ray_tracer_tpu_torch"}


def test_request_seeds_follow_the_mix():
    c = tiny("cornell-final")

    class Stub:
        renderer = None

    loop = traffic.Loop(Stub(), c.config, c.traffic, SEED)
    reqs = [loop._next(i) for i in range(5)]
    assert [(r.seed - SEED) & 0xFFFFFFFF for r in reqs] == [0, 0, 1, 1, 2]
    assert [r.sample0 for r in reqs] == [0, 4, 0, 4, 0]
