"""The port's leaf ops and intersection against the JAX package's, on CPU.

Inputs are made with numpy from a seed and fed to both.  Bars: exact for RNG
bits, texel indices, base colours and uint8 pixels; ``rtol`` 1e-6 for rays,
hemisphere directions and light picks; the pattern of ``test_intersect.py``
(hit and primitive exact, ``t`` to ``rtol`` 1e-5) for the scene queries.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import path_tracing__ray_tracer_tpu as jp
import path_tracing__ray_tracer_tpu_torch as pt
from path_tracing__ray_tracer_tpu.ops import camera as jcam
from path_tracing__ray_tracer_tpu.ops import intersect as jint
from path_tracing__ray_tracer_tpu.ops import rng as jrng
from path_tracing__ray_tracer_tpu.ops import sampling as jsamp
from path_tracing__ray_tracer_tpu.ops import texture as jtex
from path_tracing__ray_tracer_tpu.ops import tonemap as jtone
from path_tracing__ray_tracer_tpu.ops.v3 import V3 as JV3
from path_tracing__ray_tracer_tpu.ops.v3 import refract as jrefract
from path_tracing__ray_tracer_tpu_torch.ops import camera as tcam
from path_tracing__ray_tracer_tpu_torch.ops import intersect as tint
from path_tracing__ray_tracer_tpu_torch.ops import rng as trng
from path_tracing__ray_tracer_tpu_torch.ops import sampling as tsamp
from path_tracing__ray_tracer_tpu_torch.ops import texture as ttex
from path_tracing__ray_tracer_tpu_torch.ops import tonemap as ttone
from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3
from path_tracing__ray_tracer_tpu_torch.ops.v3 import refract as trefract
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def scenes():
    """The Cornell box as identical tables in both packages."""
    jcs = jp.compile_scene(jp.CustomSceneBuilder().build_scene())
    return jcs, pt.compiled_scene_from_numpy(jax.tree.map(np.asarray, jcs), device="cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _v3(a):
    return V3.from_array(_t(a)), JV3.from_array(jnp.asarray(a))


def _np(v):
    if isinstance(v, tuple):
        return np.stack([_np(c) for c in v], -1)
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


# ---- RNG: bit for bit ------------------------------------------------------------
def _key_grid(seed):
    g = np.random.default_rng(seed)
    keys = g.integers(0, 2**32, 2048, dtype=np.uint64).astype(np.uint32)
    keys[:4] = [0, 1, 2**31, 2**32 - 1]  # both sides of the int32 sign bit
    return keys


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 7, 2**32 - 1])
def test_ray_key_bits_exact(seed):
    g = np.random.default_rng(seed % 1000)
    pix = g.integers(0, 2**31 - 1, 4096).astype(np.int64)
    pix[:3] = [0, 1, 1024 * 1024 - 1]
    sample = g.integers(0, 100_000, 4096).astype(np.int64)
    want = np.asarray(jrng.ray_key(jnp.uint32(seed), jnp.asarray(pix, jnp.int32),
                                   jnp.asarray(sample, jnp.int32)))
    got = trng.ray_key(seed, _t(pix), _t(sample))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("depth,use", [(0, 0), (3, 1), (5, 4), (8, 0), (8, 1), (1000, 7)])
def test_bits_and_uniform_exact(depth, use):
    keys = _key_grid(depth * 10 + use)
    key_t = _t(keys.view(np.int32))
    want_bits = np.asarray(jrng.bits(jnp.asarray(keys), depth, use))
    np.testing.assert_array_equal(trng.bits(key_t, depth, use).numpy(), want_bits.astype(np.int64))
    want_u = np.asarray(jrng.uniform(jnp.asarray(keys), depth, use))
    got_u = trng.uniform(key_t, depth, use)
    assert got_u.dtype == torch.float32
    np.testing.assert_array_equal(got_u.numpy(), want_u)
    assert 0.0 <= float(got_u.min()) and float(got_u.max()) < 1.0


def test_uniform_per_lane_depth_exact():
    keys = _key_grid(99)
    depth = np.random.default_rng(3).integers(0, 9, keys.shape[0]).astype(np.int32)
    want = np.asarray(jrng.uniform(jnp.asarray(keys), jnp.asarray(depth), 2))
    got = trng.uniform(_t(keys.view(np.int32)), _t(depth), 2)
    np.testing.assert_array_equal(got.numpy(), want)


# ---- rays and sampling ------------------------------------------------------------
@pytest.mark.parametrize("aspect", [4.0 / 3.0, 1.0])
def test_generate_rays(aspect):
    cam = pt.pack_camera(pt.CustomSceneBuilder().create_camera(aspect), device="cpu")
    g = np.random.default_rng(5)
    u, v = (g.uniform(0, 1, 4096).astype(np.float32) for _ in range(2))
    o, d = tcam.generate_rays(cam, _t(u), _t(v))
    jo, jd = jcam.generate_rays(jnp.asarray(cam.numpy()), jnp.asarray(u), jnp.asarray(v))
    np.testing.assert_allclose(_np(o), _np(jo), rtol=1e-6)
    np.testing.assert_allclose(_np(d), _np(jd), rtol=1e-6, atol=1e-7)
    assert all(c.is_contiguous() for c in o)


def _unit(g, n):
    a = g.normal(size=(n, 3)).astype(np.float32)
    return a / np.linalg.norm(a, axis=1, keepdims=True)


def test_cosine_hemisphere():
    g = np.random.default_rng(6)
    n = _unit(g, 4096)
    n[:64] = [0, 0, 1]  # the steep tangent-frame branch, exactly
    r1, r2 = (g.uniform(0, 1, 4096).astype(np.float32) for _ in range(2))
    tn, jn = _v3(n)
    got = tsamp.cosine_hemisphere(tn, _t(r1), _t(r2))
    want = jsamp.cosine_hemisphere(jn, jnp.asarray(r1), jnp.asarray(r2))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


def test_pick_light(scenes):
    jcs, tcs = scenes
    g = np.random.default_rng(7)
    p = g.uniform(-14, 14, (4096, 3)).astype(np.float32)
    r = g.uniform(0, 1, 4096).astype(np.float32)
    r[:2] = [0.0, np.nextafter(np.float32(1), np.float32(0))]
    tp, jpnt = _v3(p)
    ldir, dist, pdf = tsamp.pick_light(tcs, tp, _t(r))
    jdir, jdist, jpdf = jsamp.pick_light(jcs, jpnt, jnp.asarray(r))
    np.testing.assert_allclose(_np(ldir), _np(jdir), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_np(dist), _np(jdist), rtol=1e-6)
    assert pdf == pytest.approx(float(jpdf))


def test_refract():
    g = np.random.default_rng(8)
    d, n = _unit(g, 2048), _unit(g, 2048)
    eta = g.uniform(0.5, 1.6, 2048).astype(np.float32)
    (td, jd), (tn, jn) = _v3(d), _v3(n)
    ok, out = trefract(td, tn, _t(eta))
    jok, jout = jrefract(jd, jn, jnp.asarray(eta))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(_np(out), _np(jout), rtol=1e-6, atol=1e-6)


# ---- textures: exact -----------------------------------------------------------------
def _tex_inputs(n_tex, seed=9, n=8192):
    g = np.random.default_rng(seed)
    tex = g.integers(-2, n_tex + 1, n).astype(np.int32)
    u = g.uniform(-0.2, 1.2, n).astype(np.float32)
    v = g.uniform(-0.2, 1.2, n).astype(np.float32)
    u[:4], v[:4] = [0, 1, 0.5, 1], [0, 1, 1, 0.5]
    return tex, u, v


def test_texel_index_exact(scenes):
    jcs, tcs = scenes
    tex, u, v = _tex_inputs(tcs.n_textures)
    got = ttex._nearest_index(_t(tex), _t(u), _t(v), tcs.tex_width, tcs.tex_height,
                              tcs.tex_offset, tcs.n_textures)
    want = jtex._nearest_index(jnp.asarray(tex), jnp.asarray(u), jnp.asarray(v), jcs.tex_width,
                               jcs.tex_height, jcs.tex_offset, jcs.n_textures)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_resolve_base_color_exact(scenes):
    jcs, tcs = scenes
    tex, u, v = _tex_inputs(tcs.n_textures, seed=10)
    g = np.random.default_rng(11)
    has = (g.uniform(size=tex.shape) < 0.7).astype(np.float32)
    col = g.uniform(0, 1, (tex.shape[0], 3)).astype(np.float32)
    tc, jc = _v3(col)
    got = ttex.resolve_base_color(tcs, tc, _t(has), _t(tex), _t(u), _t(v))
    want = jtex.resolve_base_color(jcs, jc, jnp.asarray(has), jnp.asarray(tex),
                                   jnp.asarray(u), jnp.asarray(v))
    np.testing.assert_array_equal(_np(got), _np(want))


# ---- tonemap + quantize: exact ----------------------------------------------------------
def test_aces_quantize_exact():
    g = np.random.default_rng(12)
    x = np.concatenate([g.uniform(0, 1, 20000), g.exponential(3.0, 20000),
                        [0.0, 1e-8, 0.5, 1.0, 10.0, 1e4]]).astype(np.float32)
    got = ttone.aces(_t(x))
    want = jtone.aces(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    c = g.uniform(-0.1, 1.1, (4096, 3)).astype(np.float32)
    tc, jc = _v3(c)
    np.testing.assert_array_equal(_np(ttone.quantize_u8(tc)), _np(jtone.quantize_u8(jc)))


# ---- intersection (the plain bounce's building blocks) ------------------------------
def _rays(n, seed):
    g = np.random.default_rng(seed)
    ro = g.uniform(-14, 14, (n, 3)).astype(np.float32)
    ro[: n // 4] = [0, 0, 50]  # camera position, outside the box
    return ro, _unit(g, n)


def test_scene_hit_matches_jax(scenes):
    jcs, tcs = scenes
    ro, rd = _rays(2048, 13)
    (tro, jro), (trd, jrd) = _v3(ro), _v3(rd)
    got = tint.scene_hit(tcs, tro, trd, 1e-3, 1e6)
    want = jint.scene_hit(jcs, jro, jrd, 1e-3, 1e6)
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(want.prim))
    assert got.prim.dtype == torch.int32
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-5)
    np.testing.assert_allclose(_np(got.normal), _np(want.normal), atol=1e-5)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), atol=1e-5)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=1e-5)
    assert 0.3 < float(got.hit.float().mean()) < 1.0


def test_scene_hit_any_matches_jax(scenes):
    jcs, tcs = scenes
    ro, rd = _rays(2048, 14)
    tmax = np.random.default_rng(15).uniform(-1, 40, 2048).astype(np.float32)
    (tro, jro), (trd, jrd) = _v3(ro), _v3(rd)
    got = tint.scene_hit_any(tcs, tro, trd, 1e-3, _t(tmax))
    want = jint.scene_hit_any(jcs, jro, jrd, 1e-3, jnp.asarray(tmax))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0.1 < float(got.float().mean()) < 0.9


def test_resolve_material_exact(scenes):
    jcs, tcs = scenes
    prim = np.random.default_rng(16).integers(-1, tcs.materials.diffuse.shape[0], 4096)
    prim = prim.astype(np.int32)
    got = tint.resolve_material(tcs, _t(prim))
    want = jint.resolve_material(jcs, jnp.asarray(prim))
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(_np(g_), _np(w_))
