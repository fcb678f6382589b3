"""The port's standalone intersection (``ops/cuda/intersect.py``) against the
JAX package's TPU kernels it replaces.

On the CPU the wrappers take their plain versions, which are held against
``ops/pallas/intersect_pallas.closest_hit_pallas`` (K3a) and
``any_hit_pallas`` (K3b) run in Pallas interpret mode, as
``test_pallas_interpret.py`` runs them, on identical scene tables (carried
across with ``compiled_scene_from_numpy``) and numpy-seeded rays: the
Cornell box in both conventions and the one-of-each ``tiny_scene`` (whose
triangle has UVs to interpolate).

Bars: ``prim`` and occlusion exact; ``t``, the normal, ``u`` and ``v``
within ``atol = rtol = 1e-4`` on every lane (misses included: both give the
bound, a zero normal and zero UVs there).  The kernels themselves run only
on a GPU: ``tests/test_torch_cuda.py`` holds them against these plain
versions there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import path_tracing__ray_tracer_tpu as jp
import path_tracing__ray_tracer_tpu_torch as pt
from path_tracing__ray_tracer_tpu.ops.pallas import intersect_pallas as jip
from path_tracing__ray_tracer_tpu.ops.v3 import V3 as JV3
from path_tracing__ray_tracer_tpu_torch.ops.cuda import intersect as tint
from path_tracing__ray_tracer_tpu_torch.ops.cuda.bounce import pack_scene_blob
from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-4
N = 512
SCENES = ["cornell-gpu", "cornell-cpu", "tiny-cpu"]


@pytest.fixture(scope="module")
def scene_pairs(tiny_scene):
    cornell = jp.CustomSceneBuilder().build_scene()
    out = {}
    for name, scene, conv, parity in (("cornell-gpu", cornell, "gpu", True),
                                      ("cornell-cpu", cornell, "cpu", False),
                                      ("tiny-cpu", tiny_scene, "cpu", False)):
        jcs = jp.compile_scene(scene, convention=conv, gpu_parity=parity)
        out[name] = jcs, pt.compiled_scene_from_numpy(jax.tree.map(np.asarray, jcs), device="cpu")
    return out


@pytest.fixture
def interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _rays(n, seed, scale):
    """Half the rays from in front of the scene towards it, half from random
    points inside it in random directions."""
    g = np.random.default_rng(seed)
    ro = g.uniform(-scale, scale, (n, 3)).astype(np.float32)
    rd = g.normal(size=(n, 3)).astype(np.float32)
    ro[: n // 2] = [0, 0, 4 * scale]
    rd[: n // 2] = np.stack([g.uniform(-0.4, 0.4, n // 2), g.uniform(-0.4, 0.4, n // 2),
                             -np.ones(n // 2)], -1)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


def _both(ro, rd):
    tv = (V3.from_array(torch.from_numpy(a)) for a in (ro, rd))
    jv = (JV3.from_array(a) for a in (ro, rd))
    return tuple(tv), tuple(jv)


def _scale(name):
    return 4.0 if name.startswith("tiny") else 14.0


@pytest.mark.parametrize("name", SCENES)
def test_closest_plain_matches_pallas_kernel(scene_pairs, name, interpret):
    jcs, tcs = scene_pairs[name]
    (tro, trd), (jro, jrd) = _both(*_rays(N, 11, _scale(name)))
    got = tint.closest_hit(tcs, pack_scene_blob(tcs), tro, trd, 1e-3, 1e6)
    t, idx, nx, ny, nz, u, v = (np.asarray(a) for a in jip.closest_hit_pallas(
        jcs, jip.pack_scene_blob(jcs), jro, jrd, 1e-3, 1e6))
    np.testing.assert_array_equal(got.prim.numpy(), idx)
    np.testing.assert_array_equal(got.hit.numpy(), idx >= 0)
    for f, a, b in (("t", got.t, t), ("nx", got.normal.x, nx), ("ny", got.normal.y, ny),
                    ("nz", got.normal.z, nz), ("u", got.u, u), ("v", got.v, v)):
        np.testing.assert_allclose(a.numpy(), b, rtol=TOL, atol=TOL, err_msg=f)
    assert 0.3 < (idx >= 0).mean() < 1.0  # hits and misses both exercised
    if name.startswith("tiny"):  # triangle UVs interpolated on triangle hits
        tri = idx >= tcs.n_planes + tcs.n_spheres + tcs.n_quads
        assert tri.any() and np.abs(u[tri]).max() > 0
    assert tint.closest_hit.launches == 0  # CPU tensors never reach the kernel


@pytest.mark.parametrize("name", SCENES)
def test_any_plain_matches_pallas_kernel(scene_pairs, name, interpret):
    jcs, tcs = scene_pairs[name]
    ro, rd = _rays(N, 12, _scale(name))
    # per-ray bounds from 0 to past the far wall, so both outcomes occur
    t_max = np.random.default_rng(13).uniform(0.0, 6 * _scale(name), N).astype(np.float32)
    (tro, trd), (jro, jrd) = _both(ro, rd)
    got = tint.any_hit(tcs, pack_scene_blob(tcs), tro, trd, 1e-3, torch.from_numpy(t_max))
    want = np.asarray(jip.any_hit_pallas(jcs, jip.pack_scene_blob(jcs), jro, jrd, 1e-3,
                                         jnp.asarray(t_max)))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.2 < want.mean() < 0.8
    assert tint.any_hit.launches == 0


def test_scalar_bound_and_record_consistency(scene_pairs):
    """A scalar ``t_max`` broadcasts; occlusion within the closest hit's own
    distance agrees with the closest-hit record."""
    _, tcs = scene_pairs["cornell-gpu"]
    ro, rd = _rays(N, 14, 14.0)
    (tro, trd), _ = _both(ro, rd)
    blob = pack_scene_blob(tcs)
    rec = tint.closest_hit(tcs, blob, tro, trd, 1e-3, 25.0)
    scalar = tint.any_hit(tcs, blob, tro, trd, 1e-3, 25.0)
    per_ray = tint.any_hit(tcs, blob, tro, trd, 1e-3, torch.full((N,), 25.0))
    assert torch.equal(scalar, per_ray) and torch.equal(scalar, rec.hit)
    assert torch.equal(rec.t[~rec.hit], torch.full_like(rec.t[~rec.hit], 25.0))
    nudged = tint.any_hit(tcs, blob, tro, trd, 1e-3, torch.where(rec.hit, rec.t * 0.999, 25.0))
    assert not nudged[rec.hit].all()  # the winner itself lies past 0.999·t


def test_wrappers_reject_other_devices(scene_pairs):
    _, tcs = scene_pairs["cornell-gpu"]
    ro, rd = _rays(8, 15, 14.0)
    (tro, trd), _ = _both(ro, rd)
    meta = V3(*(x.to("meta") for x in tro))
    with pytest.raises(ValueError, match="no kernel"):
        tint.closest_hit(tcs, None, meta, trd, 1e-3, 1e6)
    with pytest.raises(ValueError, match="no kernel"):
        tint.any_hit(tcs, None, meta, trd, 1e-3, 1e6)
