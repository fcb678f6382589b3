"""The port's path tracer end to end, against the JAX package and itself.

* Chunk sums against JAX ``_path_chunk`` at ``__graft_entry__.entry()``'s
  shape (64×64, 4 spp, depth 4, seed 0; each jitter mode) on identical
  scene tables: ≥ 99.5% of pixels within ``atol = rtol = 1e-3``.  The rest
  is the ulp-flip regime of ``test_regen.py``: XLA-CPU and torch-CPU round
  ``cos``/``sin`` differently, which can flip one Russian-roulette or edge
  decision and move that one path.
* ``render`` against ``tests/goldens/path.npy`` at the golden tolerance.
* The fused-step scheduler's chunk sums (``_PIPE_REGEN``) against the same
  JAX chunk, also on a chunk that overhangs the frame.
* Chunk-size and sample-group invariance, bit for bit within the port.
* The factory names, the import without JAX, and the kernel's launch count
  (0: CPU tensors take the plain bounce).
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import path_tracing__ray_tracer_tpu as jp
import path_tracing__ray_tracer_tpu_torch as pt
from path_tracing__ray_tracer_tpu.models.path_tracer import _path_chunk
from path_tracing__ray_tracer_tpu_torch.models import path_tracer as tpath
from path_tracing__ray_tracer_tpu_torch.models.path_tracer import PathTracer, _regen_chunk
from path_tracing__ray_tracer_tpu_torch.ops.cuda import bounce, step
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

GOLDEN = Path(__file__).parent / "goldens" / "path.npy"


@pytest.fixture(scope="module")
def cornell():
    b = pt.CustomSceneBuilder()
    return b.build_scene(), b.create_camera(4.0 / 3.0)


def _port_chunk(tcs, cam12, n_pix, w, h, ns, depth, seed, jitter):
    sums = torch.zeros((3, n_pix), dtype=torch.float32)
    blobs = (bounce.pack_scene_blob(tcs), bounce.pack_mat_blob(tcs), bounce.pack_light_blob(tcs))
    _regen_chunk(tcs, blobs, cam12, sums, 0, seed, 0, n_pix=n_pix, width=w, height=h,
                 n_samples=ns, max_depth=depth, jitter=jitter)
    return sums.T.numpy()


@pytest.mark.parametrize("jitter", ["independent", "diagonal", "center"])
def test_chunk_sums_match_jax_path_chunk(jitter):
    b = jp.CustomSceneBuilder()
    jcs = jp.compile_scene(b.build_scene())
    jcam = jp.pack_camera(b.create_camera(1.0))
    want = _path_chunk(jcs, jcam, jnp.int32(0), jnp.uint32(0), jnp.int32(0), n_pix=4096,
                       width=64, height=64, n_samples=4, max_depth=4, jitter=jitter)
    want = np.stack([np.asarray(c) for c in want], -1)
    tcs = pt.compiled_scene_from_numpy(jax.tree.map(np.asarray, jcs), device="cpu")
    got = _port_chunk(tcs, torch.from_numpy(np.array(jcam)), 4096, 64, 64, 4, 4, 0, jitter)
    close = np.abs(got - want) <= 1e-3 + 1e-3 * np.abs(want)
    assert close.all(axis=1).mean() >= 0.995, (close.all(axis=1).mean(), np.abs(got - want).max())
    assert float(want.mean()) > 0.1  # a lit frame, not a trivially equal one


def test_render_matches_golden(cornell):
    scene, cam = cornell
    r = pt.RendererFactory.create("cuda_path_raytracer", seed=42, device="cpu")
    img = np.asarray(r.render(scene, cam, pt.RenderSettings(48, 36, 8, 4)))
    golden = np.load(GOLDEN)
    assert img.shape == golden.shape and img.dtype == np.uint8
    diff = np.abs(img.astype(np.int32) - golden.astype(np.int32))
    assert float((diff > 2).mean()) < 0.01, (float((diff > 2).mean()), int(diff.max()))


def test_chunk_size_invariance(cornell):
    """Many small chunks (several compactions each) equal one big chunk."""
    scene, cam = cornell
    s = pt.RenderSettings(width=40, height=30, samples_per_pixel=4, max_depth=5)
    big = pt.RendererFactory.create("cuda_path_raytracer", seed=2, chunk_rays=1 << 20, device="cpu")
    small = pt.RendererFactory.create("cuda_path_raytracer", seed=2, chunk_rays=1 << 12,
                                      device="cpu")
    assert big._plan(40, 30, 4, 5)[0] != small._plan(40, 30, 4, 5)[0]
    np.testing.assert_array_equal(big.render_array(scene, cam, s), small.render_array(scene, cam, s))


@pytest.mark.parametrize("group,used", [(1, 1), (2, 2), (4, 3)])
def test_sample_group_invariance(cornell, group, used):
    """Pixels fold their samples in ascending order whatever the grouping;
    groups that do not divide spp fall back to the largest divisor."""
    scene, cam = cornell
    s = pt.RenderSettings(width=32, height=24, samples_per_pixel=6, max_depth=4)
    whole = pt.RendererFactory.create("cuda_path_raytracer", seed=3, sample_group=6, device="cpu")
    split = pt.RendererFactory.create("cuda_path_raytracer", seed=3, sample_group=group,
                                      device="cpu")
    np.testing.assert_array_equal(whole.render_sums(scene, cam, s), split.render_sums(scene, cam, s))
    assert split.sample_group == used


def test_sample_offset_continues_the_stream(cornell):
    """Sums over samples [0, 4) equal those over [0, 2) + [2, 4) in value and
    match a 4-sample render up to the fold order."""
    scene, cam = cornell
    s = pt.RenderSettings(width=16, height=16, samples_per_pixel=4, max_depth=3)
    r = pt.RendererFactory.create("cuda_path_raytracer", seed=4, device="cpu")
    a = r.render_sums(scene, cam, s, sample_offset=0, n_samples=2)
    b = r.render_sums(scene, cam, s, sample_offset=2, n_samples=2)
    whole = r.render_sums(scene, cam, s)
    np.testing.assert_allclose(a + b, whole, rtol=1e-6, atol=1e-6)
    assert not np.array_equal(a, b)


def test_render_is_deterministic(cornell):
    scene, cam = cornell
    s = pt.RenderSettings(width=24, height=16, samples_per_pixel=2, max_depth=4)
    imgs = [np.asarray(pt.RendererFactory.create("cuda_path_raytracer", seed=9, device="cpu")
                       .render(scene, cam, s)) for _ in range(2)]
    np.testing.assert_array_equal(*imgs)


def test_factory_names_and_pending_renderers():
    r = pt.RendererFactory.create("cuda_path_raytracer", device="cpu")
    alias = pt.RendererFactory.create("tpu_path_raytracer", device="cpu")
    assert type(r) is type(alias) is PathTracer
    assert r.get_name() == alias.get_name() == "cuda_path_raytracer"
    assert pt.RendererFactory.create("cuda_path_raytracer").device.type == "cuda"
    # every renderer of the JAX package is ported: none is pending
    assert sorted(pt.RendererFactory.list_available()) == sorted(
        jp.RendererFactory.list_available())
    for name in ("cuda_raytracer", "cuda_texture_raytracer", "cpu_raytracer", "tpu_raytracer",
                 "tpu_texture_raytracer"):
        made = pt.RendererFactory.create(name)
        assert made.device.type == "cuda"
        assert made.get_name() == pt.RendererFactory.resolve(name)
    with pytest.raises(ValueError):
        pt.RendererFactory.create("no_such_renderer")


def test_package_imports_without_jax():
    code = ("import sys, path_tracing__ray_tracer_tpu_torch as pt; "
            "import path_tracing__ray_tracer_tpu_torch.ops.cuda.bounce; "
            "import path_tracing__ray_tracer_tpu_torch.ops.cuda.intersect; "
            "import path_tracing__ray_tracer_tpu_torch.ops.cuda.whitted; "
            "import path_tracing__ray_tracer_tpu_torch.models.whitted_oracle; "
            "import path_tracing__ray_tracer_tpu_torch.ops.cuda.bvh; "
            "import path_tracing__ray_tracer_tpu_torch.ops.cuda.bounce_bvh; "
            "import path_tracing__ray_tracer_tpu_torch.ops.cuda.bvh_paged; "
            "import path_tracing__ray_tracer_tpu_torch.ops.bvh; "
            "import path_tracing__ray_tracer_tpu_torch.ops.cuda.step; "
            "import path_tracing__ray_tracer_tpu_torch.ops.cuda.texture; "
            "import path_tracing__ray_tracer_tpu_torch.models.experimental; "
            "import path_tracing__ray_tracer_tpu_torch.native; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'triton')]; "
            "assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=Path(__file__).resolve().parents[1], timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_launch_counter_stays_zero_on_cpu(cornell):
    scene, cam = cornell
    before = bounce.path_bounce.launches
    pt.RendererFactory.create("cuda_path_raytracer", device="cpu").render_sums(
        scene, cam, pt.RenderSettings(width=16, height=8, samples_per_pixel=1, max_depth=2))
    assert bounce.path_bounce.launches == before == 0


@pytest.mark.parametrize("pix0,sample_base", [(0, 0), (1000, 6)])  # the second overhangs
def test_pipe_chunk_sums_match_jax_path_chunk(monkeypatch, pix0, sample_base):
    """The fused-step scheduler (``_PIPE_REGEN``; on the CPU K7's plain
    version) against JAX ``_path_chunk`` at the diagonal case's shape above,
    whose compiled chunk it shares; the JAX pipe needs a TPU, so on the CPU
    the JAX chunk takes its XLA route.  Held to the bar of
    ``tests/test_pipe_regen.py``: under 1% of values off by more than 1e-3
    and a mean difference under 1e-3.  The second chunk starts at pixel
    1000 of the 4096-pixel frame with ``sample_base = 6``: the item advance
    wraps and the lanes past the frame clamp."""
    b = jp.CustomSceneBuilder()
    jcs = jp.compile_scene(b.build_scene())
    jcam = jp.pack_camera(b.create_camera(1.0))
    kw = dict(n_pix=4096, width=64, height=64, n_samples=4, max_depth=4, jitter="diagonal")
    want = _path_chunk(jcs, jcam, jnp.int32(pix0), jnp.uint32(0), jnp.int32(sample_base), **kw)
    want = np.stack([np.asarray(c) for c in want], -1)
    tcs = pt.compiled_scene_from_numpy(jax.tree.map(np.asarray, jcs), device="cpu")
    blobs = (bounce.pack_scene_blob(tcs), bounce.pack_mat_blob(tcs), bounce.pack_light_blob(tcs))
    sums = torch.zeros((3, pix0 + 4096), dtype=torch.float32)
    monkeypatch.setattr(tpath, "_PIPE_REGEN", True)
    before = step.path_step.launches
    _regen_chunk(tcs, blobs, torch.from_numpy(np.array(jcam)), sums, pix0, 0, sample_base, **kw)
    assert step.path_step.launches == before  # CPU tensors: the plain step
    diff = np.abs(sums[:, pix0:].T.numpy() - want)
    assert float(np.mean(diff > 1e-3)) < 0.01, ((diff > 1e-3).mean(), diff.max())
    assert float(diff.mean()) < 1e-3, diff.mean()
    assert float(want.mean()) > 0.1  # a lit frame, not a trivially equal one
