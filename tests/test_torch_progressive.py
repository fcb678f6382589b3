"""The port's progressive rendering (``parallel/progressive.py``) and the
per-render reseed of ``models/wavefront.WavefrontRenderer``, on the CPU.

* The twins of ``tests/test_renderers.py``'s
  ``test_progressive_matches_oneshot`` and ``test_progressive_resume_partial``
  on the port's path tracer (32x24, 8 spp, depth 2, ``sample_group=4``,
  batches of 4), held to the same bar: the uint8 image equal to the one-shot
  render's; the resumed render also equal to the uninterrupted progressive
  one.
* A checkpoint written by the JAX package's ``save_state`` loads in the
  port, and one written by the port in the JAX package: the same keys,
  dtypes, sums and sample count, equal fingerprints.
* The twin of ``test_reseed_per_render_quirk``, and ``_run_seed`` equal to
  the JAX package's for a few seeds and frame counts.

No test here compiles a JAX renderer: the JAX package's renderers are only
constructed (``_run_seed``) and its progressive module only saves and loads.
"""
import numpy as np
import pytest

import path_tracing__ray_tracer_tpu as jp
import path_tracing__ray_tracer_tpu_torch as pt
from path_tracing__ray_tracer_tpu.parallel import progressive as jprog
from path_tracing__ray_tracer_tpu_torch.parallel import progressive as tprog
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SETTINGS = dict(width=32, height=24, samples_per_pixel=8, max_depth=2)


@pytest.fixture(scope="module")
def cornell_t():
    b = pt.CustomSceneBuilder()
    return b.build_scene(), b.create_camera(4.0 / 3.0)


def _renderer(**kw):
    return pt.RendererFactory.create("cuda_path_raytracer", seed=3, sample_group=4,
                                     device="cpu", **kw)


@pytest.fixture(scope="module")
def oneshot(cornell_t):
    scene, cam = cornell_t
    return np.asarray(_renderer().render(scene, cam, pt.RenderSettings(**SETTINGS)))


@pytest.fixture(scope="module")
def progressive(cornell_t, tmp_path_factory):
    scene, cam = cornell_t
    ckpt = str(tmp_path_factory.mktemp("prog") / "acc.npz")
    img = tprog.render_progressive(_renderer(), scene, cam, pt.RenderSettings(**SETTINGS),
                                   batch_spp=4, checkpoint_path=ckpt)
    return np.asarray(img), ckpt


def test_progressive_matches_oneshot(oneshot, progressive):
    img, ckpt = progressive
    np.testing.assert_array_equal(oneshot, img)
    fp = tprog._fingerprint(pt.RenderSettings(**SETTINGS), 3)
    sums, done = tprog.load_state(ckpt, fp)
    assert done == 8 and sums is not None and sums.shape == (32 * 24, 3)
    # another fingerprint (seed) does not load
    assert tprog.load_state(ckpt, tprog._fingerprint(pt.RenderSettings(**SETTINGS), 4)) == (
        None, 0)


def test_progressive_resume_partial(cornell_t, tmp_path, oneshot, progressive):
    scene, cam = cornell_t
    s = pt.RenderSettings(**SETTINGS)
    r = _renderer()
    ckpt = str(tmp_path / "acc.npz")
    # an interrupted run: 4 of 8 spp done, checkpointed
    sums = r.render_sums(scene, cam, s, sample_offset=0, n_samples=4)
    tprog.save_state(ckpt, sums, 4, tprog._fingerprint(s, 3))
    resumed = np.asarray(tprog.render_progressive(r, scene, cam, s, batch_spp=4,
                                                  checkpoint_path=ckpt))
    np.testing.assert_array_equal(resumed, oneshot)
    np.testing.assert_array_equal(resumed, progressive[0])  # the same batches, same order


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_load_in_either_package(tmp_path, writer):
    rng = np.random.default_rng(7)
    sums = rng.random((32 * 24, 3), dtype=np.float32) * 5
    fp_j = jprog._fingerprint(jp.RenderSettings(**SETTINGS), 3)
    fp_t = tprog._fingerprint(pt.RenderSettings(**SETTINGS), 3)
    np.testing.assert_array_equal(fp_j, fp_t)
    assert fp_j.dtype == fp_t.dtype == np.int64
    path = str(tmp_path / "acc.npz")
    save, load = ((jprog.save_state, tprog.load_state) if writer == "jax"
                  else (tprog.save_state, jprog.load_state))
    save(path, sums, 4, fp_j if writer == "jax" else fp_t)
    with np.load(path) as data:
        assert sorted(data.files) == ["fingerprint", "samples_done", "sums"]
        assert (data["sums"].dtype, data["samples_done"].dtype) == (np.float32, np.int64)
    got, done = load(path, fp_t if writer == "jax" else fp_j)
    assert done == 4
    np.testing.assert_array_equal(got, sums)


def test_reseed_per_render_quirk(cornell_t):
    """Opt-in parity with the reference's per-render RNG advance: each
    ``render()`` reseeds, so back-to-back renders differ, and the first one
    equals the default renderer's."""
    scene, cam = cornell_t
    s = pt.RenderSettings(width=32, height=24, samples_per_pixel=4, max_depth=2)
    r = pt.RendererFactory.create("cuda_path_raytracer", reseed_per_render=True, device="cpu")
    a = np.asarray(r.render(scene, cam, s))
    b = np.asarray(r.render(scene, cam, s))
    assert r.frame_count == 2
    assert (a != b).any(), "reseed_per_render renders should differ"
    c = np.asarray(pt.RendererFactory.create("cuda_path_raytracer", device="cpu")
                   .render(scene, cam, s))
    np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("seed,frames", [(0, 0), (0, 3), (5, 1), (0xFFFFFFFF, 2),
                                         (123456789, 1000)])
@pytest.mark.parametrize("reseed", [True, False])
def test_run_seed_matches_jax(seed, frames, reseed):
    j = jp.RendererFactory.create("tpu_path_raytracer", seed=seed, reseed_per_render=reseed)
    t = pt.RendererFactory.create("cuda_path_raytracer", seed=seed, reseed_per_render=reseed,
                                  device="cpu")
    j.frame_count = t.frame_count = frames
    assert t._run_seed() == j._run_seed()
