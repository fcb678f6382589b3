"""The port's bounce (``ops/cuda/bounce.py``) against the JAX package's.

On the CPU the wrapper takes the plain version, which is held against two
references on identical scene tables and numpy-seeded rays, at per-lane
depths 0-5 and both shadow bounds:

* ``models/path_tracer._bounce_xla``, the XLA formulation (1024 rays);
* ``ops/pallas/bounce_pallas.path_bounce_pallas``, the TPU kernel this port's
  CUDA kernel replaces, run in Pallas interpret mode as
  ``test_pallas_interpret.py`` runs it (256 rays), on ``conftest.py``'s
  ``tiny_scene`` (a plane, a mirror and a glass sphere, a triangle, two
  lights): interpret mode unrolls the kernel over the scene's primitives,
  and on the 22-primitive Cornell box it took several times as long.

Bars: ``hit`` and the winning primitive exact, ``killed`` equal on ≥ 99.9% of
lanes, float fields within ``atol = rtol = 1e-4`` on hit lanes; on miss lanes
only ``hit``, ``killed`` and ``w_sky`` are compared (the scheduler reads no other
field there).  The kernel itself runs only on a GPU:
``tests/test_torch_cuda.py`` holds it against the plain version there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import path_tracing__ray_tracer_tpu as jp
import path_tracing__ray_tracer_tpu_torch as pt
from path_tracing__ray_tracer_tpu.models.path_tracer import _bounce_xla
from path_tracing__ray_tracer_tpu.ops import intersect as jint
from path_tracing__ray_tracer_tpu.ops.pallas import bounce_pallas as jbp
from path_tracing__ray_tracer_tpu.ops.pallas.intersect_pallas import blob_layout as jlayout
from path_tracing__ray_tracer_tpu.ops.pallas.intersect_pallas import pack_scene_blob as jblob
from path_tracing__ray_tracer_tpu.ops.v3 import V3 as JV3
from path_tracing__ray_tracer_tpu_torch.ops.cuda import bounce
from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3
from test_torch_compiler import _tiny
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-4
FLOATS = ("w_nee", "rr_scale", "s_thr", "t_thr", "new_org", "new_dir", "u", "v", "tex_id",
          "mat_color")
MODES = {"reference": False, "light": True}


def _carried(jcs):
    return jcs, pt.compiled_scene_from_numpy(jax.tree.map(np.asarray, jcs), device="cpu")


@pytest.fixture(scope="module")
def scenes():
    return _carried(jp.compile_scene(jp.CustomSceneBuilder().build_scene()))


@pytest.fixture(scope="module")
def tiny_scenes():
    return _carried(jp.compile_scene(_tiny(jp)))


def _inputs(n, seed):
    """Half camera rays, half rays from inside the box; random throughput,
    keys on both sides of the int32 sign bit, depths 0-5."""
    g = np.random.default_rng(seed)
    ro = g.uniform(-14, 14, (n, 3)).astype(np.float32)
    rd = g.normal(size=(n, 3)).astype(np.float32)
    ro[: n // 2] = [0, 0, 50]
    rd[: n // 2] = np.stack([g.uniform(-0.45, 0.45, n // 2), g.uniform(-0.45, 0.45, n // 2),
                             -np.ones(n // 2)], -1)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    thr = g.uniform(0.02, 1.5, (n, 3)).astype(np.float32)
    key = g.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    depth = (np.arange(n) % 6).astype(np.int32)
    return ro, rd, thr, key, depth


def _tiny_inputs(n, seed):
    """``_inputs``' throughput, keys and depths with rays for the tiny scene:
    three in four from above it toward its floor and spheres, the rest in
    random directions."""
    ro, rd, thr, key, depth = _inputs(n, seed)
    g = np.random.default_rng(seed + 1)
    k = 3 * n // 4
    ro[:k] = g.uniform([-3, 0, -1], [3, 3, 6], (k, 3))
    aim = g.uniform([-4, -2, -8], [4, 0.5, -2], (k, 3)) - ro[:k]
    rd[:k] = aim / np.linalg.norm(aim, axis=1, keepdims=True)
    return ro, rd, thr, key, depth


def _port(tcs, ro, rd, thr, key, depth, shadow_light):
    def v3(a):
        return V3.from_array(torch.from_numpy(a))

    return bounce.path_bounce(
        tcs, *(f(tcs) for f in (bounce.pack_scene_blob, bounce.pack_mat_blob,
                                 bounce.pack_light_blob)),
        v3(ro), v3(rd), v3(thr), torch.from_numpy(key.view(np.int32)),
        torch.from_numpy(depth), shadow_light=shadow_light)


def _np(x):
    if isinstance(x, tuple):
        return np.stack([_np(c) for c in x], -1)
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_records_agree(got, want, want_prim):
    hit = _np(want.hit)
    np.testing.assert_array_equal(_np(got.hit), hit)
    np.testing.assert_array_equal(_np(got.prim)[hit], np.asarray(want_prim)[hit])
    assert (_np(got.killed) == _np(want.killed)).mean() >= 0.999
    np.testing.assert_array_equal(_np(got.w_sky), _np(want.w_sky))
    lanes = hit & (_np(got.killed) == _np(want.killed))
    for f in FLOATS:
        np.testing.assert_allclose(_np(getattr(got, f))[lanes], _np(getattr(want, f))[lanes],
                                   rtol=TOL, atol=TOL, err_msg=f)
    assert 0.2 < hit.mean() < 1.0 and _np(got.killed).any()


@pytest.mark.parametrize("mode", list(MODES))
def test_plain_bounce_matches_bounce_xla(scenes, mode):
    jcs, tcs = scenes
    ro, rd, thr, key, depth = _inputs(1024, 1)
    got = _port(tcs, ro, rd, thr, key, depth, MODES[mode])
    jro, jrd = JV3.from_array(ro), JV3.from_array(rd)
    want = _bounce_xla(jcs, jro, jrd, JV3.from_array(thr), jnp.asarray(key),
                       jnp.asarray(depth), shadow_tmax=mode)
    prim = jint.scene_hit(jcs, jro, jrd, 1e-3, 1e6).prim
    _assert_records_agree(got, want, prim)
    assert bounce.path_bounce.launches == 0  # CPU tensors never reach the kernel


@pytest.fixture
def interpreted_pallas(monkeypatch):
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(jint, "USE_PALLAS", True)
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("mode", list(MODES))
def test_plain_bounce_matches_pallas_kernel(tiny_scenes, mode, interpreted_pallas):
    jcs, tcs = tiny_scenes
    ro, rd, thr, key, depth = _tiny_inputs(256, 2)
    got = _port(tcs, ro, rd, thr, key, depth, MODES[mode])
    jro, jrd = JV3.from_array(ro), JV3.from_array(rd)
    want = jbp.path_bounce_pallas(
        jcs, jblob(jcs), jbp.pack_mat_blob(jcs), jbp.pack_light_blob(jcs), jro, jrd,
        JV3.from_array(thr), jnp.asarray(key), jnp.asarray(depth), shadow_light=MODES[mode])
    jint.USE_PALLAS = False
    prim = jint.scene_hit(jcs, jro, jrd, 1e-3, 1e6).prim
    _assert_records_agree(got, want, prim)
    # the TPU kernel's miss-lane convention is the port's: zero material,
    # untextured — so these agree on every lane
    np.testing.assert_array_equal(_np(got.tex_id)[~_np(want.hit)], -1.0)
    np.testing.assert_array_equal(_np(got.mat_color), _np(want.mat_color))


def test_packers_match_jax(scenes):
    jcs, tcs = scenes
    for port_fn, jax_fn in ((bounce.pack_scene_blob, jblob),
                            (bounce.pack_mat_blob, jbp.pack_mat_blob),
                            (bounce.pack_light_blob, jbp.pack_light_blob)):
        got, want = port_fn(tcs), np.asarray(jax_fn(jcs))
        assert want.shape == (1, got.shape[0])
        np.testing.assert_array_equal(got.numpy(), want[0])
    layout = bounce.blob_layout(tcs)
    assert layout.size == 334 and bounce.pack_scene_blob(tcs).shape == (334,)
    assert tuple(layout) == tuple(jlayout(jcs))


def test_scalar_depth_broadcasts(scenes):
    _, tcs = scenes
    ro, rd, thr, key, _ = _inputs(256, 3)
    a = _port(tcs, ro, rd, thr, key, np.full(256, 4, np.int32), False)
    b = bounce.path_bounce_plain(
        tcs, V3.from_array(torch.from_numpy(ro)), V3.from_array(torch.from_numpy(rd)),
        V3.from_array(torch.from_numpy(thr)), torch.from_numpy(key.view(np.int32)), 4)
    for f in ("hit", "killed", "w_nee", "rr_scale", "t_thr"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_wrapper_checks_reject_what_the_kernel_does_not_take():
    x = torch.zeros(8)
    bounce._check("ox", x, torch.float32, 8, x.device)
    for bad in (torch.zeros(8, 2)[:, 0], torch.zeros(8, dtype=torch.float64), torch.zeros(9),
                torch.zeros(16)[::2]):
        with pytest.raises(ValueError):
            bounce._check("ox", bad, torch.float32, 8, x.device)
    with pytest.raises(TypeError):
        bounce._check("ox", np.zeros(8, np.float32), torch.float32, 8, x.device)
