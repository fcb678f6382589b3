"""The system under test, as the benchmark drives it: the PyTorch and CUDA
port ``path_tracing__ray_tracer_tpu_torch``, imported only inside these
functions.  From the program the benchmark takes its scene and renderer
API, its launch counters (``ops.cuda.launch_counts``) and its graph-capture
record (``ops.cuda.CAPTURES``); nothing else."""
from __future__ import annotations

from typing import Dict, NamedTuple

from .scenes import SceneData


class System(NamedTuple):
    renderer: object
    scene: object
    camera: object
    settings: object  # RenderSettings of the frame the traffic asks for


def build_scene(sd: SceneData, aspect: float):
    """The program's ``Scene`` and ``Camera`` built from ``sd``: one
    ``Material`` object per named material and one ``Texture`` per file, the
    objects in the description's order (planes, spheres, triangles, then the
    generated meshes' triangles)."""
    import path_tracing__ray_tracer_tpu_torch as pt

    def vec(a):
        return pt.Vec3(float(a[0]), float(a[1]), float(a[2]))

    textures = {n: pt.Texture(str(p)) for n, p in sd.textures.items()}
    mats = {n: pt.Material(color=vec(m.color), diffuse=m.diffuse, specular=m.specular,
                           reflective=m.reflective, refractive=m.refractive, ior=m.ior,
                           texture=None if m.texture is None else textures[m.texture])
            for n, m in sd.materials.items()}
    scene = pt.Scene()
    for p in sd.planes:
        scene.add_object(pt.Plane(vec(p["anchor"]), vec(p["normal"]), vec(p["u_dir"]),
                                  vec(p["v_dir"]), p["u_len"], p["v_len"], mats[p["material"]]))
    for s in sd.spheres:
        scene.add_object(pt.Sphere(vec(s["center"]), s["radius"], mats[s["material"]]))
    for v, uv, given, m in zip(sd.tri_v, sd.tri_uv, sd.tri_has_uv, sd.tri_mat):
        uvs = tuple(uv) if given else (None, None, None)
        scene.add_object(pt.Triangle(vec(v[0]), vec(v[1]), vec(v[2]), *uvs, material=mats[m]))
    for p in sd.lights:
        scene.add_light_sample(vec(p))
    c = sd.camera
    camera = pt.Camera(lookfrom=vec(c["lookfrom"]), lookat=vec(c["lookat"]), vup=vec(c["vup"]),
                       vfov=float(c["vfov"]), aspect=aspect)
    return scene, camera


def make(sd: SceneData, renderer: dict, width: int, height: int, spp: int, depth: int,
         seed: int, device, **extra) -> System:
    """The renderer named in the configuration with its arguments (and
    ``extra`` ones, e.g. ``reseed_per_render``), on ``device``, its first
    seed ``seed``, and the frame's settings."""
    import path_tracing__ray_tracer_tpu_torch as pt

    scene, camera = build_scene(sd, width / height)
    r = pt.RendererFactory.create(renderer["name"], device=device, seed=seed,
                                  **renderer.get("args", {}), **extra)
    return System(r, scene, camera, pt.RenderSettings(width, height, spp, depth))


def launch_counts() -> Dict[str, int]:
    """Each kernel wrapper's launch count (``module.name`` keys)."""
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import launch_counts as counts

    return counts()


def captures() -> dict:
    """The graph captures of this process: ``count`` and host ``seconds``."""
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import CAPTURES

    return dict(CAPTURES)
