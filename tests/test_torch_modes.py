"""The path tracer's scheduler modes in the port, against the JAX package.

* The mip atlas of ``compile_scene(mip_budget=...)``, field for field, and
  its carry through ``compiled_scene_from_numpy``: exact.
* ``resolve_base_color_lod``, the ``TEX_COMPACT`` prefix gather and the
  texel indices of ``ops/cuda/texture``: exact.
* ``path_step_plain`` (K7's plain version) against the JAX
  ``path_step_pallas`` under the Pallas interpreter, one call on
  ``tiny_scene`` at 256 lanes from a seeded lane state: integer and 0/1
  fields exact, floats within ``atol = rtol = 1e-4`` (the next record's
  on its hit lanes, as ``test_torch_bounce.py`` compares K1's record).
* Deferred-texture and texture-LOD chunk sums against the JAX
  ``_path_chunk`` (its ``_regen_chunk`` under ``jit``) on Cornell, 16×16,
  2 spp, depth 3, 256 lanes, held to the bar of ``tests/test_pipe_regen.py``:
  under 1% of values off by more than 1e-3 and a mean difference under
  1e-3 (float flips in rounding move a rare Russian-roulette or cutoff
  decision).  The pipe's chunk sums are held against JAX in
  ``tests/test_torch_path_tracer.py``, which shares that file's compiled
  JAX chunk.
* With the mip equal to the atlas, on a chunk overhanging the frame
  (``pix0 = 176``, ``sample_base = 6``, diagonal jitter), LOD and the pipe
  render the default sums bit for bit; deferred texture agrees at
  ``tests/test_defer_texture.py``'s bar (its ``A + base₀·B`` rounds
  differently from the default fold).
* ``PathTracer``'s ``mip_budget`` / ``texture_lod`` options.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import path_tracing__ray_tracer_tpu as jp
import path_tracing__ray_tracer_tpu_torch as pt
from path_tracing__ray_tracer_tpu.models.path_tracer import _path_chunk
from path_tracing__ray_tracer_tpu_torch.models import path_tracer as tpath
from path_tracing__ray_tracer_tpu_torch.ops import texture as ttex
from path_tracing__ray_tracer_tpu_torch.ops.cuda import bounce
from path_tracing__ray_tracer_tpu_torch.ops.cuda import step as tstep
from path_tracing__ray_tracer_tpu_torch.ops.cuda import texture as tcuda_tex
from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CHUNK = dict(n_pix=256, width=16, height=16, n_samples=2, max_depth=3)


def _carry(jcs):
    return pt.compiled_scene_from_numpy(jax.tree.map(np.asarray, jcs), device="cpu")


@pytest.fixture(scope="module")
def cornell_mip():
    """Cornell at texture budget 64: exact, with a 16-texel mip, and with
    the mip equal to the atlas (budget 64), from both packages."""
    scene = jp.CustomSceneBuilder().build_scene()
    jcam = jp.pack_camera(jp.CustomSceneBuilder().create_camera(4.0 / 3.0))
    out = {"cam": jcam, "tcam": torch.from_numpy(np.array(jcam))}
    for name, mip in (("exact", 0), ("mip16", 16), ("mip64", 64)):
        jcs = jp.compile_scene(scene, texture_budget=64, mip_budget=mip)
        out[name] = (jcs, _carry(jcs))
    return out


def test_mip_fields_match_jax(cornell_mip):
    jcs, _ = cornell_mip["mip16"]
    tcs = pt.compile_scene(pt.CustomSceneBuilder().build_scene(), texture_budget=64,
                           mip_budget=16, device="cpu")
    for f in ("atlas", "tex_offset", "tex_width", "tex_height", "mip_atlas", "mip_offset",
              "mip_width", "mip_height"):
        np.testing.assert_array_equal(getattr(tcs, f).numpy(), np.asarray(getattr(jcs, f)), f)
    assert tcs.mip_atlas.shape[0] < tcs.atlas.shape[0]
    assert pt.compile_scene(pt.CustomSceneBuilder().build_scene(), device="cpu").mip_atlas is None


def test_from_numpy_carries_the_mip(cornell_mip):
    jcs, tcs = cornell_mip["mip16"]
    for f in ("mip_atlas", "mip_offset", "mip_width", "mip_height"):
        np.testing.assert_array_equal(getattr(tcs, f).numpy(), np.asarray(getattr(jcs, f)), f)
    assert cornell_mip["exact"][1].mip_atlas is None


def _surface_lanes(n, seed, n_textures):
    g = np.random.default_rng(seed)
    tex = np.where(g.random(n) < 0.6, g.integers(0, n_textures, n), -1).astype(np.float32)
    u, v = (g.uniform(-0.2, 1.2, n).astype(np.float32) for _ in range(2))
    mc = g.uniform(0, 1, (3, n)).astype(np.float32)
    return tex, u, v, mc


def test_lod_resolve_and_texel_indices_match_jax(cornell_mip):
    from path_tracing__ray_tracer_tpu.ops import texture as jtex
    from path_tracing__ray_tracer_tpu.ops.pallas import texture_pallas as jtp
    from path_tracing__ray_tracer_tpu.ops.v3 import V3 as JV3

    jcs, tcs = cornell_mip["mip16"]
    tex, u, v, mc = _surface_lanes(1024, 3, tcs.n_textures)
    exact = np.random.default_rng(4).random(1024) < 0.5
    want = jtex.resolve_base_color_lod(jcs, JV3(*map(jnp.asarray, mc)), jnp.asarray(tex),
                                       jnp.asarray(u), jnp.asarray(v), jnp.asarray(exact))
    t = torch.from_numpy
    got = ttex.resolve_base_color_lod(tcs, V3(*map(t, mc)), t(tex), t(u), t(v), t(exact))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for port_fn, jax_fn in ((tcuda_tex.texel_index, jtp.texel_index),
                            (tcuda_tex.mip_texel_index, jtp.mip_texel_index)):
        np.testing.assert_array_equal(
            port_fn(tcs, t(tex), t(u), t(v)).numpy(),
            np.asarray(jax_fn(jcs, jnp.asarray(tex), jnp.asarray(u), jnp.asarray(v))))


@pytest.mark.parametrize("textured_share", [0.1, 0.6])  # the prefix, and the full-gather fallback
def test_compact_gather_matches_jax(cornell_mip, monkeypatch, textured_share):
    from path_tracing__ray_tracer_tpu.ops import texture as jtex

    jcs, tcs = cornell_mip["exact"]
    n = ttex._COMPACT_MIN_LANES
    g = np.random.default_rng(5)
    textured = g.random(n) < textured_share
    idx = np.where(textured, g.integers(0, tcs.atlas.shape[0], n), 0).astype(np.int32)
    want = np.asarray(jtex._gather_texels_compact(jcs, jnp.asarray(textured), jnp.asarray(idx)))
    got = ttex._gather_texels_compact(tcs, torch.from_numpy(textured), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    # the gated branch of resolve_base_color gives the plain resolve's colours
    tex, u, v, mc = _surface_lanes(n, 6, tcs.n_textures)
    args = (tcs, V3(*map(torch.from_numpy, mc)),
            torch.from_numpy((tex >= 0).astype(np.float32)),
            torch.from_numpy(tex.astype(np.int32)), torch.from_numpy(u), torch.from_numpy(v))
    plain = ttex.resolve_base_color(*args)
    monkeypatch.setattr(ttex, "TEX_COMPACT", True)
    for a, b in zip(ttex.resolve_base_color(*args), plain):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _lane_state(n, seed, st):
    """A seeded previous record and lane state: retired, finishing and live
    lanes, textured and untextured records, depths -1 to max_depth - 1."""
    g = np.random.default_rng(seed)
    f32 = np.float32
    nd = g.normal(size=(3, n)).astype(f32)
    nd /= np.linalg.norm(nd, axis=0, keepdims=True)
    ploc = g.integers(0, st.n_pix, n).astype(np.int32)
    return dict(
        idx=np.where(g.random(n) < 0.4, g.integers(0, 500, n), -1).astype(np.int32),
        texel=g.integers(0, 1 << 24, n).astype(np.int32),
        hit=(g.random(n) < 0.8).astype(f32), kill=(g.random(n) < 0.1).astype(f32),
        wnee=g.uniform(0, 3, n).astype(f32), rrs=g.uniform(1, 3, n).astype(f32),
        sthr=np.where(g.random(n) < 0.2, 1.4, 0.0).astype(f32),
        tthr=g.uniform(0, 1, n).astype(f32),
        no=g.uniform(-1.5, 1.5, (3, n)).astype(f32) + np.array([[0], [0], [-4]], f32), nd=nd,
        mc=g.uniform(0, 1, (3, n)).astype(f32),
        thr=g.uniform(0.0005, 1.2, (3, n)).astype(f32), psum=g.uniform(0, 2, (3, n)).astype(f32),
        key=g.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32).view(np.int32),
        depth=g.integers(-1, st.max_depth, n).astype(np.int32),
        s=g.integers(0, st.ns + 1, n).astype(np.int32), ploc=ploc,
        ux=((176 + ploc) % st.width).astype(np.int32),
        uy=((176 + ploc) // st.width).astype(np.int32))


def test_path_step_plain_matches_jax_interpret(tiny_scene):
    from jax.experimental.pallas import tpu as pltpu

    from path_tracing__ray_tracer_tpu.ops.pallas import bounce_pallas as jbp
    from path_tracing__ray_tracer_tpu.ops.pallas.intersect_pallas import (
        blob_layout, pack_scene_blob)
    from path_tracing__ray_tracer_tpu.ops.v3 import V3 as JV3

    jcs = jp.compile_scene(tiny_scene)
    tcs = _carry(jcs)
    jcam = jp.pack_camera(jp.CustomSceneBuilder().create_camera(4.0 / 3.0))
    n, pix0, seed, sbase = 256, 176, 9, 6
    st = tstep.StepStatics(n_tex=tcs.n_textures, tex_on=False, t_min=1e-3, t_max=1e6,
                           shadow_light=False, jitter="independent", width=20, height=15,
                           total=300, stride=tpath.item_stride(256, 3), n_pix=256, ns=3,
                           max_depth=4)
    a = _lane_state(n, 12, st)
    jst = jbp.StepStatics(layout=blob_layout(jcs), n_mats=int(jcs.materials.diffuse.shape[0]),
                          n_lights=jcs.n_lights, n_tex=st.n_tex, tex_on=False, t_min=1e-3,
                          t_max=1e6, shadow_light=False, jitter=st.jitter, width=st.width,
                          height=st.height, total=st.total, stride=st.stride, n_pix=st.n_pix,
                          ns=st.ns, max_depth=st.max_depth)
    jv3 = lambda x: JV3(*map(jnp.asarray, x))  # noqa: E731
    jrec = jbp.StepRec(idx=jnp.asarray(a["idx"]), hit=jnp.asarray(a["hit"]),
                       kill=jnp.asarray(a["kill"]), wnee=jnp.asarray(a["wnee"]),
                       rrs=jnp.asarray(a["rrs"]), sthr=jnp.asarray(a["sthr"]),
                       tthr=jnp.asarray(a["tthr"]), no=jv3(a["no"]), nd=jv3(a["nd"]),
                       mc=jv3(a["mc"]))
    scal = jnp.asarray([[pix0, seed, sbase]], jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        want = jbp.path_step_pallas(
            jst, pack_scene_blob(jcs), jbp.pack_mat_blob(jcs), jbp.pack_light_blob(jcs),
            jbp.pack_tex_blob(jcs), jnp.asarray(jcam, jnp.float32).reshape(1, 12), scal, jrec,
            jnp.asarray(a["texel"]), jv3(a["thr"]), jv3(a["psum"]),
            jnp.asarray(a["key"].view(np.uint32)),
            *(jnp.asarray(a[k]) for k in ("depth", "s", "ploc", "ux", "uy")))

    t = torch.from_numpy
    tv3 = lambda x: V3(*map(t, x))  # noqa: E731
    rec = tstep.StepRec(idx=t(a["idx"]), hit=t(a["hit"]), kill=t(a["kill"]), wnee=t(a["wnee"]),
                        rrs=t(a["rrs"]), sthr=t(a["sthr"]), tthr=t(a["tthr"]), no=tv3(a["no"]),
                        nd=tv3(a["nd"]), mc=tv3(a["mc"]))
    before = tstep.path_step.launches
    got = tstep.path_step(tcs, st, None, t(np.array(jcam)), (pix0, seed, sbase), rec,
                          t(a["texel"]), tv3(a["thr"]), tv3(a["psum"]),
                          *(t(a[k]) for k in ("key", "depth", "s", "ploc", "ux", "uy")))
    assert tstep.path_step.launches == before  # a CPU tensor takes the plain version

    def leaves(out):
        for x in out:
            yield from (leaves(x) if isinstance(x, tuple) else (x,))

    got_l = [np.asarray(x) for x in leaves(got)]
    want_l = [np.asarray(x) for x in leaves(want)]
    assert len(got_l) == len(want_l) == 38
    hit = want_l[1] > 0.5  # the next record's geometry is read on its hit lanes only
    for k, (g_, w_) in enumerate(zip(got_l, want_l)):
        if w_.dtype.kind in "iu" or k in (1, 2):  # integers, hit and kill
            np.testing.assert_array_equal(g_.view(np.int32) if g_.dtype.kind in "iu" else g_,
                                          w_.view(np.int32) if w_.dtype.kind in "iu" else w_,
                                          err_msg=f"output {k}")
        else:
            lanes = hit if 3 <= k <= 15 else slice(None)
            np.testing.assert_allclose(g_[lanes], w_[lanes], rtol=1e-4, atol=1e-4,
                                       err_msg=f"output {k}")
    assert 0.2 < hit.mean() < 1.0
    s2, item = got_l[30], got_l[34]
    assert (item < st.ns).any() and (s2 == st.ns).any() and (a["s"] == st.ns).any()


def _agree(got, want):
    diff = np.abs(got - want)
    assert float(np.mean(diff > 1e-3)) < 0.01, ((diff > 1e-3).mean(), diff.max())
    assert float(diff.mean()) < 1e-3, diff.mean()


def _port_sums(tcs, tcam, pix0, seed, sbase, **kw):
    blobs = (bounce.pack_scene_blob(tcs), bounce.pack_mat_blob(tcs), bounce.pack_light_blob(tcs))
    sums = torch.zeros((3, pix0 + CHUNK["n_pix"]), dtype=torch.float32)
    tpath._regen_chunk(tcs, blobs, tcam, sums, pix0, seed, sbase, **CHUNK, **kw)
    return sums[:, pix0:].T.numpy()


@pytest.mark.parametrize("mode", ["lod", "defer"])
def test_mode_chunk_sums_match_jax(cornell_mip, mode):
    jcs, tcs = cornell_mip["mip16"]
    kw = dict(lod_depth=2) if mode == "lod" else {}
    want = _path_chunk(jcs, cornell_mip["cam"], jnp.int32(0), jnp.uint32(7), jnp.int32(0),
                       jitter="independent", **CHUNK, **kw)
    want = np.stack([np.asarray(c) for c in want], -1)
    got = _port_sums(tcs, cornell_mip["tcam"], 0, 7, 0, jitter="independent", **kw)
    _agree(got, want)
    assert float(want.mean()) > 0.05  # a lit chunk, not a trivially equal one


def test_modes_equal_default_when_mip_is_atlas(cornell_mip, monkeypatch):
    _, exact = cornell_mip["exact"]
    _, mip = cornell_mip["mip64"]
    np.testing.assert_array_equal(mip.mip_atlas.numpy(), mip.atlas.numpy())
    args = (cornell_mip["tcam"], 176, 9, 6)
    want = _port_sums(exact, *args, jitter="diagonal")
    np.testing.assert_array_equal(_port_sums(mip, *args, jitter="diagonal", lod_depth=2), want)
    _agree(_port_sums(mip, *args, jitter="diagonal"), want)  # deferred texture
    monkeypatch.setattr(tpath, "_PIPE_REGEN", True)
    np.testing.assert_array_equal(_port_sums(exact, *args, jitter="diagonal"), want)


def test_path_tracer_mode_options(cornell_mip):
    with pytest.raises(ValueError, match="mutually exclusive"):
        pt.RendererFactory.create("cuda_path_raytracer", mip_budget=32, texture_lod=32,
                                  device="cpu")
    lod = pt.RendererFactory.create("tpu_path_raytracer", texture_lod=64, texture_budget=64,
                                    seed=9, device="cpu",
                                    compile_overrides={"use_bvh": False})
    assert lod.name == "cuda_path_raytracer" and lod.lod_depth == 2
    assert lod.compile_overrides == {"use_bvh": False, "mip_budget": 64}
    defer = pt.RendererFactory.create("cuda_path_raytracer", mip_budget=16, device="cpu")
    assert defer.lod_depth == 0 and defer.compile_overrides == {"mip_budget": 16}
    plain = pt.RendererFactory.create("cuda_path_raytracer", texture_budget=64, seed=9,
                                      device="cpu")
    assert plain.lod_depth == 0 and plain.compile_overrides == {}
    b = pt.CustomSceneBuilder()
    scene, cam = b.build_scene(), b.create_camera(4.0 / 3.0)
    s = pt.RenderSettings(width=24, height=16, samples_per_pixel=2, max_depth=3)
    img = np.asarray(lod.render(scene, cam, s))
    assert lod.compiled(scene).mip_atlas is not None
    np.testing.assert_array_equal(img, np.asarray(plain.render(scene, cam, s)))
