"""The mesh slice end to end: the port's bounces and renderers on a BVH scene
against the JAX package's.

The scene is ``MeshSceneBuilder(grid=2, subdivisions=1)``: 320 triangles
(over ``BVH_THRESHOLD``, so the port builds the flat BVH), five walls, 16
light samples, glass, mirror and diffuse spheres.  The port's side walks
the BVH; the JAX side is its XLA formulation on the CPU, under ``jax.jit``,
on the same scene compiled without a BVH (its broadcast sweep: XLA compiles
that in a fraction of the time its skip-link walks take, and
``tests/test_torch_bvh.py`` holds the port's walks against JAX's).

* ``path_bounce_plain`` (the plain version of K5) against ``_bounce_xla``,
  both shadow bounds, per-lane depths 0-5: ``hit`` and the winning
  primitive on ≥ 99.99% of lanes, ``killed`` on ≥ 99.9%, float fields
  within ``atol = rtol = 1e-4`` on the lanes where both agree and hit.
* ``whitted_bounce_plain`` (which the Whitted renderers take on a BVH scene)
  against the JAX XLA building blocks, both variants, the same bars.
* Renders against goldens made once by the JAX package on the CPU, within
  the golden tolerance (< 1% of channels off by > 2/255)::

    JAX_PLATFORMS=cpu python -c "
    import numpy as np, path_tracing__ray_tracer_tpu as jp
    from path_tracing__ray_tracer_tpu.scene_builders.mesh_scene_builder import MeshSceneBuilder
    b = MeshSceneBuilder(grid=2, subdivisions=1)
    r = jp.RendererFactory.create('tpu_path_raytracer', seed=42, shadow_tmax='light',
                                  compile_overrides={'use_bvh': True})
    np.save('tests/goldens/torch_mesh_path.npy', np.asarray(r.render(
        b.build_scene(), b.create_camera(4 / 3), jp.RenderSettings(40, 30, 4, 6))))
    r = jp.RendererFactory.create('tpu_texture_raytracer', seed=42,
                                  compile_overrides={'use_bvh': True})
    np.save('tests/goldens/torch_mesh_whitted.npy', np.asarray(r.render(
        b.build_scene(), b.create_camera(4 / 3), jp.RenderSettings(48, 36, 4, 4))))"

* The bounce dispatch (K1 / K5 / plain by scene), ``compile_overrides``,
  and the config-5 mesh (11,520 triangles) compiling on the CPU.
"""
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import path_tracing__ray_tracer_tpu as jp
import path_tracing__ray_tracer_tpu_torch as pt
from path_tracing__ray_tracer_tpu.models.path_tracer import _bounce_xla
from path_tracing__ray_tracer_tpu.ops import intersect as jint
from path_tracing__ray_tracer_tpu.ops.v3 import V3 as JV3
from path_tracing__ray_tracer_tpu.scene_builders.mesh_scene_builder import MeshSceneBuilder
from path_tracing__ray_tracer_tpu_torch.models.path_tracer import bounce_fn
from path_tracing__ray_tracer_tpu_torch.ops.cuda import bounce, bounce_bvh, bvh, whitted
from path_tracing__ray_tracer_tpu_torch.ops.cuda.bvh import MAX_DEPTH4
from path_tracing__ray_tracer_tpu_torch.ops.texture import resolve_base_color
from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3
from test_torch_whitted import VARIANTS, _jax_bounce, _np
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-4
GOLDENS = Path(__file__).parent / "goldens"
FLOATS = ("w_nee", "rr_scale", "s_thr", "t_thr", "new_org", "new_dir", "u", "v", "tex_id",
          "mat_color")


@pytest.fixture(scope="module")
def mesh():
    """The JAX package's mesh scene without a BVH, and the port's with one
    (the same tables otherwise: ``tests/test_torch_bvh.py``)."""
    jcs = jp.compile_scene(MeshSceneBuilder(grid=2, subdivisions=1).build_scene(), use_bvh=False)
    tcs = pt.compile_scene(pt.MeshSceneBuilder(grid=2, subdivisions=1).build_scene(), device="cpu")
    assert jcs.bvh is None and tcs.bvh is not None
    return jcs, tcs


@pytest.fixture(scope="module")
def bounce_refs(mesh):
    """``_inputs(768, 1)``, and JAX's ``_bounce_xla`` records on them for
    both shadow bounds with the winning primitive, in one compile."""
    jcs, _ = mesh
    inputs = _inputs(768, 1)

    @jax.jit
    def refs(ro, rd, thr, key, depth):
        jro, jrd = JV3.from_array(ro), JV3.from_array(rd)
        return {mode: _bounce_xla(jcs, jro, jrd, JV3.from_array(thr), key, depth,
                                  shadow_tmax=mode) for mode in ("reference", "light")}, \
            jint.scene_hit(jcs, jro, jrd, 1e-3, 1e6).prim

    out, prim = refs(*inputs)
    return inputs, out, np.asarray(prim)


@pytest.fixture(scope="module")
def mesh_scene():
    b = pt.MeshSceneBuilder(grid=2, subdivisions=1)
    return b.build_scene(), b.create_camera(4.0 / 3.0)


def _inputs(n, seed):
    """Half camera rays, half rays from inside the box; random throughput,
    keys on both sides of the int32 sign bit, depths 0-5."""
    g = np.random.default_rng(seed)
    ro = g.uniform(-14, 14, (n, 3)).astype(np.float32)
    rd = g.normal(size=(n, 3)).astype(np.float32)
    ro[: n // 2] = [0, 0, 50]
    rd[: n // 2] = np.stack([g.uniform(-0.4, 0.4, n // 2), g.uniform(-0.4, 0.4, n // 2),
                             -np.ones(n // 2)], -1)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    thr = g.uniform(0.02, 1.5, (n, 3)).astype(np.float32)
    key = g.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    return ro, rd, thr, key, (np.arange(n) % 6).astype(np.int32)


@pytest.mark.parametrize("mode", ["reference", "light"])
def test_plain_bounce_matches_bounce_xla_on_mesh(mesh, bounce_refs, mode):
    _, tcs = mesh
    (ro, rd, thr, key, depth), refs, prim = bounce_refs
    tables = bounce_bvh.pack_bvh_tables(tcs)
    got = bounce_bvh.path_bounce_bvh(
        tcs, tables, *(V3.from_array(torch.from_numpy(a)) for a in (ro, rd, thr)),
        torch.from_numpy(key.view(np.int32)), torch.from_numpy(depth),
        shadow_light=mode == "light")
    want = refs[mode]
    hit = _np(want.hit)
    same = (_np(got.hit) == hit) & (_np(got.prim) == np.where(hit, prim, -1))
    killed_same = _np(got.killed) == _np(want.killed)
    assert same.mean() >= 0.9999 and killed_same.mean() >= 0.999
    lanes = same & hit & killed_same
    for f in FLOATS:
        np.testing.assert_allclose(_np(getattr(got, f))[lanes], _np(getattr(want, f))[lanes],
                                   rtol=TOL, atol=TOL, err_msg=f)
    np.testing.assert_array_equal(_np(got.w_sky)[same], _np(want.w_sky)[same])
    assert 0.3 < hit.mean() < 1.0 and _np(got.killed).any() and (_np(got.w_nee)[lanes] > 0).any()
    assert bounce_bvh.path_bounce_bvh.launches == bvh.scene_any.launches == 0


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_whitted_plain_bounce_on_mesh_matches_xla_blocks(mesh, variant):
    jcs, tcs = mesh
    jvar, tvar = VARIANTS[variant]
    ro, rd, *_ = _inputs(384, 2)
    want = jax.jit(lambda o, d: _jax_bounce(jcs, o, d, jvar))(ro, rd)
    got = whitted.whitted_bounce_plain(tcs, V3.from_array(torch.from_numpy(ro)),
                                       V3.from_array(torch.from_numpy(rd)), tvar)
    hit = _np(want["hit"])
    same = (_np(got.hit) == hit) & (_np(got.prim) == np.where(hit, _np(want["prim"]), -1))
    assert same.mean() >= 0.9999 and hit.mean() > 0.3 and _np(got.cont).any()
    lanes = same & hit
    np.testing.assert_array_equal(_np(got.cont)[lanes], _np(want["cont"])[lanes])
    base = resolve_base_color(tcs, got.mat_color, (got.tex_id >= 0).float(), got.tex_id.int(),
                              got.u, got.v)
    color = base * got.a + V3(got.w, got.w, got.w)
    for f, a, b in (("base*a + w", color, want["color"]), ("mult", got.mult, want["mult"]),
                    ("new_org", got.new_org, want["new_org"]),
                    ("new_dir", got.new_dir, want["new_dir"])):
        np.testing.assert_allclose(_np(a)[lanes], _np(b)[lanes], rtol=TOL, atol=TOL, err_msg=f)


@pytest.mark.parametrize("name,renderer,kw,cfg", [
    ("torch_mesh_path", "cuda_path_raytracer", dict(shadow_tmax="light"), (40, 30, 4, 6)),
    ("torch_mesh_whitted", "cuda_texture_raytracer", {}, (48, 36, 4, 4)),
])
def test_mesh_render_matches_golden(mesh_scene, name, renderer, kw, cfg):
    scene, cam = mesh_scene
    r = pt.RendererFactory.create(renderer, seed=42, device="cpu",
                                  compile_overrides={"use_bvh": True}, **kw)
    img = np.asarray(r.render(scene, cam, pt.RenderSettings(*cfg)))
    golden = np.load(GOLDENS / f"{name}.npy")
    assert img.shape == golden.shape and img.dtype == np.uint8
    diff = np.abs(img.astype(np.int32) - golden.astype(np.int32))
    assert float((diff > 2).mean()) < 0.01, (float((diff > 2).mean()), int(diff.max()))
    assert img.mean() > 20


def test_bounce_dispatch_by_scene(mesh_scene):
    scene, _ = mesh_scene
    r = pt.RendererFactory.create("cuda_path_raytracer", device="cpu",
                                  compile_overrides={"use_bvh": False})
    assert r.compiled(scene).bvh is None  # the override reaches compile_scene
    r.compile_overrides = {}
    cs = r.compiled(scene)  # a new cache key: the default compile
    assert cs.bvh is not None and bounce_bvh.bounce_bvh_ok(cs)
    assert isinstance(r.blobs(cs), bounce_bvh.BvhTables)
    assert not bounce_bvh.bounce_bvh_ok(cs._replace(bvh=None))  # K1 takes it
    # a textured triangle needs its UVs, which K5 does not carry: the plain bounce
    textured = cs._replace(tri_uv_used=torch.zeros((1,), dtype=torch.int8))
    assert not bounce_bvh.bounce_bvh_ok(textured) and r.blobs(textured) is None
    n = 64
    o, d, thr = (V3(*(torch.full((n,), c) for c in v)) for v in ((0., 0., 50.), (0., 0., -1.),
                                                                   (1., 1., 1.)))
    key, depth = torch.arange(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32)
    for scene_cs, blobs in ((cs, r.blobs(cs)), (textured, None)):
        out = bounce_fn(scene_cs, blobs)(o, d, thr, key, depth, False)
        assert out.hit.all() and bounce.path_bounce.launches == 0


def test_config5_mesh_compiles_on_cpu():
    """BASELINE config 5's scene: 9 icospheres of 1,280 triangles."""
    cs = pt.compile_scene(pt.MeshSceneBuilder(grid=3, subdivisions=3).build_scene(), device="cpu")
    assert cs.n_triangles == 11520 and (cs.n_planes, cs.n_lights) == (5, 16)
    assert bounce_bvh.bounce_bvh_ok(cs) and 1 < cs.bvh.depth4 <= MAX_DEPTH4
    assert cs.bvh.paged is None  # one-level: K5, K4a and K4b take it, as in the JAX package
    assert cs.bvh.slot_rec.shape[0] % (16 * 13) == 0 and cs.bvh.ps_blob.shape[0] == 92
