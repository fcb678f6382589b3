"""The port's CPU-parity oracle (``models/whitted_oracle.py``, ``cpu_raytracer``)
against the JAX package's.

* ``_shade_local`` and the fork recursion ``_trace`` against the JAX
  functions of the same names (XLA, CPU) on identical scene tables in host
  conventions and numpy-seeded rays: within ``atol = rtol = 1e-4``.  The JAX
  ``_trace`` walks a heap of constant-width segments; the port walks the
  levels that lanes reach.  Results must match, mechanisms need not.
* ``render`` against ``tests/goldens/oracle.npy`` (the JAX package's CPU
  render, config of ``tests/test_golden.py``) within the golden tolerance.
* On a BVH scene, ``render`` against ``tests/goldens/torch_mesh_oracle.npy``,
  made once by the JAX oracle on the CPU::

    JAX_PLATFORMS=cpu python -c "
    import numpy as np, path_tracing__ray_tracer_tpu as jp
    from path_tracing__ray_tracer_tpu.scene_builders.mesh_scene_builder import MeshSceneBuilder
    b = MeshSceneBuilder(grid=2, subdivisions=1)
    r = jp.RendererFactory.create('cpu_raytracer', seed=42)
    np.save('tests/goldens/torch_mesh_oracle.npy', np.asarray(r.render(
        b.build_scene(), b.create_camera(4 / 3), jp.RenderSettings(40, 30, 1, 3))))"

  with the one-level BVH and with paging forced.
* The depth clamp: depth 14 renders as depth 12, with a ``depth_clamped``
  event; the factory name, conventions and defaults; and the launch
  counters (0: CPU tensors take the plain intersection).
"""
import json
import logging
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import path_tracing__ray_tracer_tpu as jp
import path_tracing__ray_tracer_tpu_torch as pt
from path_tracing__ray_tracer_tpu.models import whitted_oracle as jo
from path_tracing__ray_tracer_tpu.ops import intersect as jint
from path_tracing__ray_tracer_tpu.ops import texture as jtex
from path_tracing__ray_tracer_tpu.ops.v3 import V3 as JV3
from path_tracing__ray_tracer_tpu_torch.models import whitted_oracle as to
from path_tracing__ray_tracer_tpu_torch.ops import bvh as tbvh
from path_tracing__ray_tracer_tpu_torch.ops.cuda import intersect as tint
from path_tracing__ray_tracer_tpu_torch.ops.cuda.bounce import pack_scene_blob
from path_tracing__ray_tracer_tpu_torch.ops.intersect import resolve_material, scene_hit
from path_tracing__ray_tracer_tpu_torch.ops.texture import resolve_base_color
from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-4
GOLDEN = Path(__file__).parent / "goldens" / "oracle.npy"


@pytest.fixture(scope="module")
def scenes():
    jcs = jp.compile_scene(jp.CustomSceneBuilder().build_scene(), convention="cpu",
                           gpu_parity=False)
    tcs = pt.compiled_scene_from_numpy(jax.tree.map(np.asarray, jcs), device="cpu")
    return jcs, tcs


@pytest.fixture(scope="module")
def cornell():
    b = pt.CustomSceneBuilder()
    return b.build_scene(), b.create_camera(4.0 / 3.0)


def _rays(n, seed):
    """Camera-like rays into the box; a quarter start inside it."""
    g = np.random.default_rng(seed)
    ro = np.tile(np.float32([0, 0, 50]), (n, 1))
    ro[: n // 4] = g.uniform(-12, 12, (n // 4, 3))
    rd = np.stack([g.uniform(-0.3, 0.3, n), g.uniform(-0.3, 0.3, n), -np.ones(n)], -1)
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    return ro.astype(np.float32), rd


def _np(v):
    return np.stack([np.asarray(c) for c in v], -1)


def test_shade_local_matches_jax(scenes):
    jcs, tcs = scenes
    ro, rd = _rays(256, 31)
    jo_, jd = JV3.from_array(ro), JV3.from_array(rd)
    hit = jint.scene_hit(jcs, jo_, jd, 1e-3, 1e30)
    mats = jint.resolve_material(jcs, hit.prim)
    base = jtex.resolve_base_color(jcs, mats[0], mats[6], mats[7], hit.u, hit.v)
    want = jo._shade_local(jcs, hit, base, mats, jo_)

    to_, td = V3.from_array(torch.from_numpy(ro)), V3.from_array(torch.from_numpy(rd))
    th = scene_hit(tcs, to_, td, 1e-3, 1e30)
    tm = resolve_material(tcs, th.prim)
    tbase = resolve_base_color(tcs, tm[0], tm[6], tm[7], th.u, th.v)
    got = to._shade_local(tcs, pack_scene_blob(tcs), th.point, th.normal, tbase, tm[1], tm[2],
                          to_)
    h = np.asarray(hit.hit)
    np.testing.assert_array_equal(th.hit.numpy(), h)
    np.testing.assert_allclose(_np(got)[h], _np(want)[h], rtol=TOL, atol=TOL)
    assert _np(want)[h].mean() > 0.1


@pytest.mark.parametrize("depth", [1, 3])
def test_trace_matches_jax_heap(scenes, depth):
    jcs, tcs = scenes
    ro, rd = _rays(256, 32 + depth)
    want = jo._trace(jcs, JV3.from_array(ro), JV3.from_array(rd), 0, depth,
                     np.ones(256, dtype=bool))
    got = to._trace(tcs, pack_scene_blob(tcs), V3.from_array(torch.from_numpy(ro)),
                    V3.from_array(torch.from_numpy(rd)), depth)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)
    assert _np(want).mean() > 0.05
    assert tint.closest_hit.launches == tint.any_hit.launches == 0


def test_render_matches_golden(cornell):
    scene, cam = cornell
    img = np.asarray(pt.RendererFactory.create("cpu_raytracer", seed=42, device="cpu")
                     .render(scene, cam, pt.RenderSettings(48, 36, 1, 3)))
    golden = np.load(GOLDEN)
    assert img.shape == golden.shape and img.dtype == np.uint8
    diff = np.abs(img.astype(np.int32) - golden.astype(np.int32))
    assert float((diff > 2).mean()) < 0.01, (float((diff > 2).mean()), int(diff.max()))


@pytest.mark.parametrize("paged", [False, True])
def test_mesh_render_matches_golden(monkeypatch, paged):
    """The oracle on a BVH scene: its queries take the scene walks (the
    paged ones when paging is forced), as the JAX oracle's do."""
    if paged:
        monkeypatch.setattr(tbvh, "ONE_LEVEL_LIMIT", 2600)
        monkeypatch.setattr(tbvh, "PAGE_BUDGET_FLOATS", 800)
    b = pt.MeshSceneBuilder(grid=2, subdivisions=1)
    scene = b.build_scene()
    r = pt.RendererFactory.create("cpu_raytracer", seed=42, device="cpu")
    assert "bvh_acceleration" in r.get_capabilities()
    bvh = r.compiled(scene).bvh
    assert bvh is not None and (bvh.paged is not None) == paged
    img = np.asarray(r.render(scene, b.create_camera(4.0 / 3.0), pt.RenderSettings(40, 30, 1, 3)))
    golden = np.load(GOLDEN.parent / "torch_mesh_oracle.npy")
    assert img.shape == golden.shape and img.dtype == np.uint8
    diff = np.abs(img.astype(np.int32) - golden.astype(np.int32))
    assert float((diff > 2).mean()) < 0.01, (float((diff > 2).mean()), int(diff.max()))
    assert img.mean() > 20


class _Events(logging.Handler):
    def __init__(self):
        super().__init__()
        self.events = []

    def emit(self, record):
        self.events.append(json.loads(record.getMessage()))


def test_depth_clamp(cornell):
    """Depth 14 runs as ORACLE_MAX_DEPTH = 12, and says so."""
    scene, cam = cornell
    r = pt.RendererFactory.create("cpu_raytracer", seed=7, device="cpu")
    log = logging.getLogger("ptrt")
    handler, level = _Events(), log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        deep = r.render_sums(scene, cam, pt.RenderSettings(10, 8, 1, 14))
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    clamped = [e for e in handler.events if e["event"] == "depth_clamped"]
    assert clamped and clamped[0]["requested"] == 14 and clamped[0]["effective"] == 12
    np.testing.assert_array_equal(deep, r.render_sums(scene, cam, pt.RenderSettings(10, 8, 1, 12)))
    assert not np.array_equal(deep, r.render_sums(scene, cam, pt.RenderSettings(10, 8, 1, 2)))
    assert to.ORACLE_MAX_DEPTH == jo.ORACLE_MAX_DEPTH == 12


def test_factory_conventions_and_plan():
    r = pt.RendererFactory.create("cpu_raytracer")
    assert isinstance(r, to.CPUParityRayTracer) and r.get_name() == "cpu_raytracer"
    assert r.device.type == "cuda" and r.jitter == "independent"
    assert (r.convention, r.gpu_parity) == ("cpu", False)
    # the lane budget shrinks the pixel chunk with depth, as in the JAX package
    jr = jp.RendererFactory.create("cpu_raytracer")
    for depth in (3, 8, 12, 14):
        assert r._plan(2000, 1500, 4, depth) == jr._plan(2000, 1500, 4, depth)[1:]
