"""The port's Whitted renderers (``models/whitted.py``, ``ops/cuda/whitted.py``)
against the JAX package's.

* The plain bounce record against the JAX XLA building blocks (``scene_hit``,
  ``resolve_material``, ``resolve_base_color``, ``_direct_lighting`` times the
  energy factor, and the continuation of the XLA ``whitted_radiance``), both
  variants, camera rays (depth 0) and the rays one bounce on (depth 1):
  ``hit`` and the winning primitive exact; ``base·a + w``, ``cont``, ``mult``
  and the new ray within ``atol = rtol = 1e-4`` on hit lanes.
* ``whitted_radiance`` against the JAX XLA ``whitted_radiance`` at depth 4,
  both variants, within 1e-4.
* Renders against ``tests/goldens/whitted_tex.npy`` / ``whitted_basic.npy``
  (the JAX package's own CPU renders, configs of ``tests/test_golden.py``)
  within the golden tolerance: < 1% of channels off by > 2/255.
* The grid-sampler quirk, the factory names and the launch counter (0: CPU
  tensors take the plain bounce).

The kernel itself runs only on a GPU: ``tests/test_torch_cuda.py`` holds it
against the plain version there.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import path_tracing__ray_tracer_tpu as jp
import path_tracing__ray_tracer_tpu_torch as pt
from path_tracing__ray_tracer_tpu.models import whitted as jw
from path_tracing__ray_tracer_tpu.ops import intersect as jint
from path_tracing__ray_tracer_tpu.ops import texture as jtex
from path_tracing__ray_tracer_tpu.ops.v3 import V3 as JV3
from path_tracing__ray_tracer_tpu.ops.v3 import refract as jrefract
from path_tracing__ray_tracer_tpu_torch.models import whitted as tw
from path_tracing__ray_tracer_tpu_torch.ops.cuda import whitted as kw
from path_tracing__ray_tracer_tpu_torch.ops.cuda.bounce import (
    pack_light_blob,
    pack_mat_blob,
    pack_scene_blob,
)
from path_tracing__ray_tracer_tpu_torch.ops.texture import resolve_base_color
from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-4
GOLDENS = Path(__file__).parent / "goldens"
VARIANTS = {"basic": (jw.BASIC, kw.BASIC), "texture": (jw.TEXTURE, kw.TEXTURE)}


@pytest.fixture(scope="module")
def scenes():
    jcs = jp.compile_scene(jp.CustomSceneBuilder().build_scene())
    tcs = pt.compiled_scene_from_numpy(jax.tree.map(np.asarray, jcs), device="cpu")
    return jcs, tcs, (pack_scene_blob(tcs), pack_mat_blob(tcs), pack_light_blob(tcs))


@pytest.fixture(scope="module")
def cornell():
    b = pt.CustomSceneBuilder()
    return b.build_scene(), b.create_camera(4.0 / 3.0)


def _camera_rays(n, seed):
    """Rays from the Cornell camera's position into the box."""
    g = np.random.default_rng(seed)
    ro = np.tile(np.float32([0, 0, 50]), (n, 1))
    rd = np.stack([g.uniform(-0.3, 0.3, n), g.uniform(-0.3, 0.3, n), -np.ones(n)], -1)
    return ro, (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)


def _np(x):
    if isinstance(x, tuple):
        return np.stack([_np(c) for c in x], -1)
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_bounce(jcs, ro, rd, jvar):
    """One bounce of the JAX XLA ``whitted_radiance`` body, from its building
    blocks: the shaded colour ``local · energy``, the continuation and the
    winner."""
    o, d = JV3.from_array(ro), JV3.from_array(rd)
    hit = jint.scene_hit(jcs, o, d, 1e-3, 1e6)
    mats = jint.resolve_material(jcs, hit.prim)
    (mcolor, _diff, _spec, reflective, refractive, ior, has_tex, tex_id) = mats
    base = (jtex.resolve_base_color(jcs, mcolor, has_tex, tex_id, hit.u, hit.v)
            if jvar.textured else mcolor)
    local = jw._direct_lighting(jcs, hit, base, mats, -d, jvar)
    energy = (jnp.maximum(0.1, 1.0 - reflective - refractive) if jvar.base_floor
              else 1.0 - reflective)
    n = hit.normal
    refl_dir = d.reflect(n)
    refl_org = hit.point + n * 1e-3
    if jvar.refraction:
        want = (reflective > 0.01) | (refractive > 0.01)
        use_refr = (refractive > reflective) & (refractive > 0.1)
        inside = d.dot(n) > 0.0
        ok, refr_dir = jrefract(d, JV3.where(inside, -n, n), jnp.where(inside, ior, 1.0 / ior))
        refr_org = hit.point + JV3.where(inside, n, -n) * 1e-3
        take = use_refr & ok
        new_d = JV3.where(take, refr_dir, refl_dir)
        new_o = JV3.where(take, refr_org, refl_org)
        mult = jnp.where(take, refractive * 0.95, reflective)
    else:
        want, new_d, new_o, mult = reflective > 0.01, refl_dir, refl_org, reflective
    return dict(hit=hit.hit, prim=hit.prim, color=local * energy, cont=hit.hit & want,
                mult=mult, new_org=new_o, new_dir=new_d)


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_bounce_matches_xla_blocks(scenes, variant, depth):
    jcs, tcs, _ = scenes
    jvar, tvar = VARIANTS[variant]
    ro, rd = _camera_rays(512, 21)
    if depth == 1:  # the rays one bounce on, from every hit lane
        first = _jax_bounce(jcs, ro, rd, jvar)
        keep = _np(first["hit"])
        ro, rd = _np(first["new_org"])[keep], _np(first["new_dir"])[keep]
    want = _jax_bounce(jcs, ro, rd, jvar)
    got = kw.whitted_bounce(tcs, None, None, None, V3.from_array(torch.from_numpy(ro)),
                            V3.from_array(torch.from_numpy(rd)), tvar)
    hit = _np(want["hit"])
    np.testing.assert_array_equal(_np(got.hit), hit)
    np.testing.assert_array_equal(_np(got.prim)[hit], _np(want["prim"])[hit])
    np.testing.assert_array_equal(_np(got.cont), _np(want["cont"]))
    base = resolve_base_color(tcs, got.mat_color, (got.tex_id >= 0).float(), got.tex_id.int(),
                              got.u, got.v)
    color = base * got.a + V3(got.w, got.w, got.w)
    for f, a, b in (("base*a + w", color, want["color"]), ("mult", got.mult, want["mult"]),
                    ("new_org", got.new_org, want["new_org"]),
                    ("new_dir", got.new_dir, want["new_dir"])):
        np.testing.assert_allclose(_np(a)[hit], _np(b)[hit], rtol=TOL, atol=TOL, err_msg=f)
    assert 0.5 < hit.mean() and (_np(got.w)[hit] > 0).any()
    assert depth == 1 or _np(got.cont).any()  # camera rays reach the mirror and glass
    assert kw.whitted_bounce.launches == 0  # CPU tensors never reach the kernel


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_radiance_matches_jax_whitted_radiance(scenes, variant):
    jcs, tcs, blobs = scenes
    jvar, tvar = VARIANTS[variant]
    ro, rd = _camera_rays(256, 22)
    want = jw.whitted_radiance(jcs, JV3.from_array(ro), JV3.from_array(rd), 4, jvar)
    got = tw.whitted_radiance(tcs, blobs, V3.from_array(torch.from_numpy(ro)),
                              V3.from_array(torch.from_numpy(rd)), 4, tvar)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)
    assert _np(want).mean() > 0.1


@pytest.mark.parametrize("name,renderer,cfg", [
    ("whitted_tex", "cuda_texture_raytracer", (48, 36, 4, 4)),
    ("whitted_basic", "cuda_raytracer", (48, 36, 4, 3)),
])
def test_render_matches_golden(cornell, name, renderer, cfg):
    scene, cam = cornell
    img = np.asarray(pt.RendererFactory.create(renderer, seed=42, device="cpu")
                     .render(scene, cam, pt.RenderSettings(*cfg)))
    golden = np.load(GOLDENS / f"{name}.npy")
    assert img.shape == golden.shape and img.dtype == np.uint8
    diff = np.abs(img.astype(np.int32) - golden.astype(np.int32))
    assert float((diff > 2).mean()) < 0.01, (float((diff > 2).mean()), int(diff.max()))


def test_grid_spp_quirk(cornell):
    """spp 24 sums ⌊√24⌋² = 16 cells but divides by 24: 2/3 as bright as
    spp 16, whose cells are the same."""
    scene, cam = cornell
    r = pt.RendererFactory.create("cuda_texture_raytracer", seed=5, device="cpu")
    a16 = r.render_array(scene, cam, pt.RenderSettings(16, 12, 16, 3))
    a24 = r.render_array(scene, cam, pt.RenderSettings(16, 12, 24, 3))
    np.testing.assert_allclose(a24, a16 * (16 / 24), rtol=1e-5, atol=1e-7)
    assert a16.mean() > 0.1


def test_chunking_does_not_change_the_render(cornell):
    """Several small pixel chunks give the image of one big chunk."""
    scene, cam = cornell
    s = pt.RenderSettings(40, 30, 4, 4)
    big = pt.RendererFactory.create("cuda_texture_raytracer", seed=6, device="cpu")
    small = pt.RendererFactory.create("cuda_texture_raytracer", seed=6, chunk_rays=4096,
                                      device="cpu")
    assert big._plan(40, 30, 4, 4)[0] != small._plan(40, 30, 4, 4)[0]
    np.testing.assert_array_equal(big.render_array(scene, cam, s), small.render_array(scene, cam, s))


def test_factory_and_variants():
    for name, alias, cls, var in (("cuda_raytracer", "tpu_raytracer", tw.RayTracer, kw.BASIC),
                                  ("cuda_texture_raytracer", "tpu_texture_raytracer",
                                   tw.TextureRayTracer, kw.TEXTURE)):
        r = pt.RendererFactory.create(name)
        assert type(r) is type(pt.RendererFactory.create(alias, device="cpu")) is cls
        assert r.get_name() == name and r.device.type == "cuda" and r.variant == var
        assert r.jitter == "diagonal"
    assert tuple(kw.BASIC) == tuple(jw.BASIC) and tuple(kw.TEXTURE) == tuple(jw.TEXTURE)
