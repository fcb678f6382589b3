"""The port's scene compiler against the JAX package's, table for table.

Each scene is built twice, once from each package's own classes, and
compiled by each package's ``compile_scene``; every field of the two
``CompiledScene`` records (padding sentinels, quads, packed atlas, material
tables, flags) must be exactly equal.
"""
import jax
import numpy as np
import pytest
import torch

import path_tracing__ray_tracer_tpu as jp
import path_tracing__ray_tracer_tpu_torch as pt
from path_tracing__ray_tracer_tpu.compiler import compile_scene as jax_compile
from path_tracing__ray_tracer_tpu_torch.compiler import (
    BVH_THRESHOLD,
    compile_scene,
    compiled_scene_from_numpy,
    pack_camera,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _tiny(pkg):
    """The ``tiny_scene`` fixture of ``conftest.py``, from either package."""
    V, M = pkg.Vec3, pkg.Material
    scene = pkg.Scene()
    scene.add_object(pkg.Plane(V(-10, -2, 10), V(0, 1, 0), V(20, 0, 0), V(0, 0, -20), 20.0, 20.0,
                               M(V(0.2, 0.9, 0.3), diffuse=0.8, specular=0.1)))
    scene.add_object(pkg.Sphere(V(0, 0, -5), 1.0, M(V(0.9, 0.1, 0.1), diffuse=0.7,
                                                    specular=0.4, reflective=0.2)))
    scene.add_object(pkg.Sphere(V(2.5, 0, -5), 1.0, M(V(0.95, 0.95, 0.95), diffuse=0.1,
                                                      specular=0.9, reflective=0.1,
                                                      refractive=0.85, ior=1.5)))
    scene.add_object(pkg.Triangle(V(-2, -1, -3), V(-0.5, -1, -3), V(-1.2, 0.5, -3.5),
                                  material=M(V(0.1, 0.2, 0.9), diffuse=0.9)))
    scene.add_light_sample(V(0, 8, 0))
    scene.add_light_sample(V(1, 8, 1))
    return scene


def _cornell(pkg):
    return pkg.CustomSceneBuilder().build_scene()


def _leaves(obj, prefix="cs"):
    """(path, leaf) pairs of a NamedTuple tree, by field name."""
    if obj is None:
        yield prefix, None
    elif hasattr(obj, "_fields"):
        for f in obj._fields:
            yield from _leaves(getattr(obj, f), f"{prefix}.{f}")
    elif isinstance(obj, tuple):
        for i, o in enumerate(obj):
            yield from _leaves(o, f"{prefix}[{i}]")
    else:
        yield prefix, obj


def _assert_tables_equal(port_cs, jax_cs):
    port = dict(_leaves(port_cs))
    port.pop("cs.device")
    want = dict(_leaves(jax_cs))
    assert port.keys() == want.keys()
    for path, w in want.items():
        g = port[path]
        if w is None:
            assert g is None, path
            continue
        g, w = g.cpu().numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=path)


SCENES = {"cornell": _cornell, "tiny": _tiny}
MODES = {"gpu_parity": {}, "cpu_convention": dict(gpu_parity=False, convention="cpu")}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("scene", list(SCENES))
def test_compile_scene_matches_jax(scene, mode):
    kw = MODES[mode]
    port_cs = compile_scene(SCENES[scene](pt), device="cpu", **kw)
    jax_cs = jax_compile(SCENES[scene](jp), **kw)
    _assert_tables_equal(port_cs, jax_cs)
    assert port_cs.device.type == "cpu"
    assert (port_cs.n_planes, port_cs.n_spheres, port_cs.n_quads, port_cs.n_triangles,
            port_cs.n_lights, port_cs.n_textures) == (
        jax_cs.n_planes, jax_cs.n_spheres, jax_cs.n_quads, jax_cs.n_triangles,
        jax_cs.n_lights, jax_cs.n_textures)


def test_cornell_counts():
    cs = compile_scene(_cornell(pt), device="cpu")
    assert (cs.n_planes, cs.n_spheres, cs.n_quads, cs.n_triangles) == (5, 3, 13, 1)
    assert (cs.n_lights, cs.n_textures) == (16, 7)
    assert cs.materials.diffuse.shape[0] == 22 and cs.mat_table.diffuse.shape[0] == 13
    assert cs.atlas.shape[0] == 17_356_986 and cs.bvh is None


@pytest.mark.parametrize("aspect", [4.0 / 3.0, 1.0])
def test_pack_camera_matches_jax(aspect):
    port = pack_camera(pt.CustomSceneBuilder().create_camera(aspect), device="cpu")
    want = np.asarray(jp.pack_camera(jp.CustomSceneBuilder().create_camera(aspect)))
    assert port.dtype == torch.float32
    np.testing.assert_array_equal(port.numpy(), want)


@pytest.mark.parametrize("scene", list(SCENES))
def test_compiled_scene_from_numpy_equals_port_compile(scene):
    jax_cs = jax_compile(SCENES[scene](jp))
    carried = compiled_scene_from_numpy(jax.tree.map(np.asarray, jax_cs), device="cpu")
    own = compile_scene(SCENES[scene](pt), device="cpu")
    assert type(carried) is type(own)
    assert carried.device == own.device
    _assert_tables_equal(carried, jax_cs)
    for (path, a), (_, b) in zip(_leaves(carried), _leaves(own)):
        if path != "cs.device" and a is not None:
            assert a.equal(b), path


def test_bvh_scene_raises_naming_roadmap():
    """A scene over ``BVH_THRESHOLD`` triangles compiles with a BVH.  The
    oracle, which once raised on it naming the ROADMAP item, now renders it
    through the BVH scene walks, as the brute-force sweep renders the scene
    compiled without a BVH."""
    V = pt.Vec3
    scene = pt.Scene()
    mat = pt.Material(V(0.5, 0.5, 0.5), diffuse=1.0)
    for i in range(BVH_THRESHOLD + 1):  # disjoint triangles: no quad merges
        x = 3.0 * i
        scene.add_object(pt.Triangle(V(x, 0, 0), V(x + 1, 0, 0), V(x, 1, 0), material=mat))
    cs = compile_scene(scene, device="cpu")
    assert cs.bvh is not None and cs.n_triangles == BVH_THRESHOLD + 1
    assert compile_scene(scene, device="cpu", use_bvh=False).bvh is None
    cam = pt.Camera(V(400, 0.5, 10), V(400, 0.5, 0), V(0, 1, 0), 40.0, 1.0)
    scene.add_light_sample(V(400, 20, 20))
    imgs = [np.asarray(pt.RendererFactory.create(
        "cpu_raytracer", device="cpu", compile_overrides={"use_bvh": use_bvh}).render(
            scene, cam, pt.RenderSettings(32, 32, 1, 1))) for use_bvh in (True, False)]
    np.testing.assert_array_equal(imgs[0], imgs[1])
    assert imgs[0].max() > 0
