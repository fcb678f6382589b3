"""The (tile × sample) split of the port (``parallel/mesh.py``,
``parallel/sharding.py``, the renderers' ``mesh=``, the CLI's
``--devices``) on a mesh of 8 CPU entries, the twin of conftest's 8 CPU
devices.

* The mesh: shapes, errors, repeated entries, no card without ``devices``.
* Sharded renders equal single-device renders (``atol=1e-5``, the JAX
  ``tests/test_sharding.py`` bar): the path tracer with ``sample_parallel``
  1 and 2, bit for bit on the tile-only split and whenever each sample
  entry renders one sample; spp 3 on (4, 2), whose second sample entry
  gets one sample of the group, not two (each (pixel, sample) rendered
  once); Whitted and the oracle at spp 9 on (4, 2), 9 grid cells split
  5 + 4; the BVH mesh scene and a paged scene.
* A sharded progressive render resumed from its first checkpoint, bit-equal
  to the uninterrupted one and within ``atol=1e-5`` of one device.
* ``main(["--devices", "4", ...], device="cpu")`` bit-equal to
  ``--devices 0``.
* The slice against the JAX package: the port's (4, 2) path and Whitted
  renders against the JAX sharded renders on conftest's 8-device mesh, with
  ``sample_group=2`` (no overshoot in the JAX render).  The path tracer at
  the bar of ``tests/test_torch_path_tracer.py`` (≥ 99.5% of pixels within
  ``atol = rtol = 1e-3``); the Whitted renderer at the bar its goldens are
  held to, the golden frame (48×36) and tolerance (< 1% of channels off by
  > 2/255), and its pixels off the JAX render those of the single-device
  port render.  The port's and the JAX Whitted renders differ on ~1% of
  pixels whatever the split (0.7% at 48×36; 9 of 768 pixels, 1.13% of
  channels, at ``tests/test_sharding.py``'s 32×24): cell rays at a wall
  corner that take the other wall.  With the same scene tables and the same
  rays both packages give the same radiance there; the JAX chunk's rays
  come out of ``jit``, rounded otherwise.
"""
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

import path_tracing__ray_tracer_tpu as jp
import path_tracing__ray_tracer_tpu_torch as pt
from path_tracing__ray_tracer_tpu.parallel.mesh import make_mesh as jax_mesh
from path_tracing__ray_tracer_tpu_torch import main as tcli
from path_tracing__ray_tracer_tpu_torch.ops import bvh as tbvh
from path_tracing__ray_tracer_tpu_torch.parallel import progressive
from path_tracing__ray_tracer_tpu_torch.parallel.mesh import DeviceMesh, make_mesh, mesh_shape
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")


def cpu_mesh(n=8, sample_parallel=2):
    return make_mesh(n, sample_parallel=sample_parallel, devices=[CPU] * 8)


@pytest.fixture(scope="module")
def cornell():
    b = pt.CustomSceneBuilder()
    return b.build_scene(), b.create_camera(4.0 / 3.0)


def _pair(name, scene, cam, settings, mesh, **kw):
    """``render_sums`` of one device and of ``mesh``."""
    single = pt.RendererFactory.create(name, device="cpu", **kw)
    sharded = pt.RendererFactory.create(name, mesh=mesh, **kw)
    return (single.render_sums(scene, cam, settings),
            sharded.render_sums(scene, cam, settings), sharded)


def test_make_mesh_shapes(monkeypatch):
    mesh = cpu_mesh()
    assert mesh_shape(mesh) == (4, 2) and mesh.shape == {"tile": 4, "sample": 2}
    assert mesh.devices() == [CPU]  # repeated entries, one device
    assert [(ti, si) for ti, si, _ in mesh.entries()] == [
        (ti, si) for ti in range(4) for si in range(2)]
    assert mesh_shape(make_mesh(devices=[CPU] * 3)) == (3, 1)
    for bad in (dict(n_devices=8, sample_parallel=3), dict(n_devices=1000),
                dict(n_devices=0)):
        with pytest.raises(ValueError):
            make_mesh(devices=[CPU] * 8, **bad)
    with pytest.raises(ValueError):
        DeviceMesh([[CPU, CPU], [CPU]])
    # no card and no devices: no fallback to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_renderer_device_is_the_mesh_first_entry():
    mesh = cpu_mesh()
    r = pt.RendererFactory.create("cuda_path_raytracer", mesh=mesh)
    assert r.device == CPU and r.mesh is mesh
    assert pt.RendererFactory.create("cuda_raytracer", mesh=mesh, device="cpu").device == CPU
    with pytest.raises(ValueError, match="conflicts"):
        pt.RendererFactory.create("cuda_path_raytracer", mesh=mesh, device="cuda")
    # the mesh rounds the pixel chunk up to whole 1024-pixel blocks per tile entry
    assert r._plan(32, 24, 4, 2) == (4096, 4)
    assert pt.RendererFactory.create("cuda_path_raytracer", device="cpu")._plan(
        32, 24, 4, 2) == (1024, 4)


@pytest.mark.parametrize("n,sample_parallel,group,size", [
    (8, 1, 2, (32, 24)),  # tile only
    (8, 2, 2, (32, 24)),  # one sample per sample entry
    (8, 2, 4, (32, 24)),  # two: the partials fold apart, then add
    (4, 2, 2, (64, 48)),  # (2, 2): two chunks of 2048 pixels, the last past the frame
])
def test_path_sharded_equals_single(cornell, n, sample_parallel, group, size):
    scene, cam = cornell
    s = pt.RenderSettings(width=size[0], height=size[1], samples_per_pixel=4, max_depth=2)
    a, b, _ = _pair("cuda_path_raytracer", scene, cam, s, cpu_mesh(n, sample_parallel), seed=7,
                    sample_group=group, chunk_rays=1 << 12)
    np.testing.assert_allclose(b, a, atol=1e-5)
    if sample_parallel == 1 or group == sample_parallel:
        np.testing.assert_array_equal(b, a)  # each pixel folds its samples as one device does


def test_path_overshoot_is_rendered_once(cornell):
    """spp 3 on (4, 2): the group of 3 gives each sample entry ceil(3/2) = 2
    samples' room; the second renders sample 2 only.  The JAX sharded render
    renders sample 3 too and counts it (4/3 of the single-device sums on this
    frame, seed 7, depth 2)."""
    scene, cam = cornell
    s = pt.RenderSettings(width=32, height=24, samples_per_pixel=3, max_depth=2)
    a, b, _ = _pair("cuda_path_raytracer", scene, cam, s, cpu_mesh(), seed=7)
    np.testing.assert_allclose(b, a, atol=1e-5)
    four = pt.RendererFactory.create("cuda_path_raytracer", seed=7, device="cpu").render_sums(
        scene, cam, pt.RenderSettings(width=32, height=24, samples_per_pixel=4, max_depth=2))
    assert abs(float(b.sum()) / float(four.sum()) - 0.75) < 0.05


@pytest.mark.parametrize("name", ["cuda_texture_raytracer", "cpu_raytracer"])
def test_grid_sampler_sharded_equals_single(cornell, name):
    """spp 9: 9 grid cells split 5 + 4 over the sample axis, the grid the
    frame's (3×3) in both entries."""
    scene, cam = cornell
    s = pt.RenderSettings(width=32, height=24, samples_per_pixel=9, max_depth=2)
    a, b, _ = _pair(name, scene, cam, s, cpu_mesh(), seed=1)
    np.testing.assert_allclose(b, a, atol=1e-5)


@pytest.mark.parametrize("paged", [False, True])
def test_bvh_scene_sharded_equals_single(monkeypatch, paged):
    if paged:
        monkeypatch.setattr(tbvh, "ONE_LEVEL_LIMIT", 2000)
        monkeypatch.setattr(tbvh, "PAGE_BUDGET_FLOATS", 800)
    b = pt.MeshSceneBuilder(grid=2 if paged else 1, subdivisions=1)
    scene, cam = b.build_scene(), b.create_camera(4 / 3)
    s = pt.RenderSettings(width=32, height=24, samples_per_pixel=2, max_depth=2)
    a, c, r = _pair("cuda_path_raytracer", scene, cam, s, cpu_mesh(), seed=3, sample_group=2,
                    shadow_tmax="light", compile_overrides={"use_bvh": True})
    np.testing.assert_allclose(c, a, atol=1e-5)
    bvh = r.compiled(scene).bvh
    assert bvh is not None and (bvh.paged is not None and bvh.paged.n_pages >= 2) == paged


def test_sharded_progressive_resumes_bit_equal(cornell, tmp_path, monkeypatch):
    """A (4, 2) progressive render of 4 spp in batches of 2, resumed from a
    copy of its first checkpoint, is the uninterrupted render bit for bit;
    its sums are within ``atol=1e-5`` of one device's progressive sums."""
    scene, cam = cornell
    s = pt.RenderSettings(width=32, height=24, samples_per_pixel=4, max_depth=2)
    first = tmp_path / "first.npz"
    save = progressive.save_state

    def keep_first(path, sums, done, fp):
        save(path, sums, done, fp)
        if done == 2:
            shutil.copy(path, first)

    monkeypatch.setattr(progressive, "save_state", keep_first)

    def run(path, **kw):
        r = pt.RendererFactory.create("cuda_path_raytracer", seed=7, sample_group=4, **kw)
        img = progressive.render_progressive(r, scene, cam, s, batch_spp=2,
                                             checkpoint_path=str(path))
        return np.asarray(img), np.load(path)["sums"]

    img, sums = run(tmp_path / "acc.npz", mesh=cpu_mesh())
    assert first.exists()
    resumed, resumed_sums = run(first, mesh=cpu_mesh())
    np.testing.assert_array_equal(resumed, img)
    np.testing.assert_array_equal(resumed_sums, sums)
    _, one = run(tmp_path / "one.npz", device="cpu")
    np.testing.assert_allclose(sums, one, atol=1e-5)


def test_cli_devices_4_is_devices_0(tmp_path):
    argv = ["-r", "tpu_path_raytracer", "-w", "16", "--height", "12", "--path-samples", "4",
            "-d", "2", "--no-show"]
    assert tcli.main(argv + ["--devices", "0", "-o", str(tmp_path / "a.png")], device="cpu") == 0
    assert tcli.main(argv + ["--devices", "4", "-o", str(tmp_path / "b.png")], device="cpu") == 0
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "b.png")),
                                  np.asarray(Image.open(tmp_path / "a.png")))


def test_path_sharded_matches_jax_sharded():
    """The port's (4, 2) path tracer against the JAX sharded render on
    conftest's 8-device mesh (``tests/test_sharding.py``'s config)."""
    jb, tb = jp.CustomSceneBuilder(), pt.CustomSceneBuilder()
    want = np.asarray(jp.RendererFactory.create(
        "tpu_path_raytracer", seed=7, sample_group=2, mesh=jax_mesh(8, sample_parallel=2)
    ).render_sums(jb.build_scene(), jb.create_camera(4 / 3), jp.RenderSettings(32, 24, 4, 2)))
    got = pt.RendererFactory.create(
        "tpu_path_raytracer", seed=7, sample_group=2, mesh=cpu_mesh()
    ).render_sums(tb.build_scene(), tb.create_camera(4 / 3), pt.RenderSettings(32, 24, 4, 2))
    close = np.abs(got - want) <= 1e-3 + 1e-3 * np.abs(want)
    assert close.all(axis=1).mean() >= 0.995, (close.all(axis=1).mean(), np.abs(got - want).max())
    assert float(want.mean()) > 0.1


def test_whitted_sharded_matches_jax_sharded():
    """The port's (4, 2) Whitted texture render at spp 9 against the JAX
    sharded render, at the golden frame (48×36) and the golden tolerance;
    the split moves no pixel: the pixels off the JAX render are the
    single-device port render's."""
    s = (48, 36, 9, 2)
    jb, tb = jp.CustomSceneBuilder(), pt.CustomSceneBuilder()
    want = np.asarray(jp.RendererFactory.create(
        "tpu_texture_raytracer", seed=1, mesh=jax_mesh(8, sample_parallel=2)
    ).render(jb.build_scene(), jb.create_camera(4 / 3), jp.RenderSettings(*s))).astype(np.int32)
    scene, cam = tb.build_scene(), tb.create_camera(4 / 3)
    got, one = (np.asarray(pt.RendererFactory.create("tpu_texture_raytracer", seed=1, **kw).render(
        scene, cam, pt.RenderSettings(*s))).astype(np.int32)
        for kw in (dict(mesh=cpu_mesh()), dict(device="cpu")))
    diff = np.abs(got - want)
    assert got.shape == want.shape and float((diff > 2).mean()) < 0.01, (
        float((diff > 2).mean()), int(diff.max()))
    np.testing.assert_array_equal(diff > 2, np.abs(one - want) > 2)
    assert float(want.mean()) > 10
