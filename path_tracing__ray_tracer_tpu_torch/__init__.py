"""PyTorch + CUDA port of the renderers in ``path_tracing__ray_tracer_tpu``.

The same scene, camera, material and geometry API and the same scene
compiler, as torch tensors on one device (or split over a mesh of devices,
``parallel/mesh.py``), and the same four renderers: the
path tracer (``cuda_path_raytracer``), the two Whitted ray tracers
(``cuda_raytracer``, ``cuda_texture_raytracer``) and the CPU-parity oracle
(``cpu_raytracer``).  Scenes above 256 triangles (``MeshSceneBuilder``) get
a flat BVH.  The kernels are hand-written CUDA (``csrc/path_bounce.cu``,
``csrc/whitted_bounce.cu``, ``csrc/intersect.cu``, and for BVH scenes
``csrc/bvh_scene.cu`` and ``csrc/path_bounce_bvh.cu``) on an NVIDIA GPU, and
plain torch versions on the CPU.  Imports neither JAX nor Triton, and builds
no kernel until one is first launched.

Quick start::

    import path_tracing__ray_tracer_tpu_torch as pt
    b = pt.CustomSceneBuilder()
    scene, cam = b.build_scene(), b.create_camera(4 / 3)
    renderer = pt.RendererFactory.create("cuda_path_raytracer")  # device="cuda"
    img = renderer.render(scene, cam, pt.RenderSettings(512, 384, 64, 8))
"""

from .core import (  # noqa: F401
    AABB,
    Camera,
    CameraParams,
    HitRecord,
    Hittable,
    Material,
    Plane,
    Ray,
    RenderSettings,
    Scene,
    Sphere,
    Texture,
    Triangle,
    Vec3,
    create_area_light,
)
from .compiler import (  # noqa: F401
    CompiledScene,
    compile_scene,
    compiled_scene_from_numpy,
    pack_camera,
)
from .models.base import BaseRenderer, RendererFactory  # noqa: F401

# importing a renderer module registers it with the factory
from .models import path_tracer as _path_tracer  # noqa: F401,E402
from .models import whitted as _whitted  # noqa: F401,E402
from .models import whitted_oracle as _whitted_oracle  # noqa: F401,E402
from .scene_builders.custom_scene_builder import CustomSceneBuilder  # noqa: F401,E402
from .scene_builders.mesh_scene_builder import MeshSceneBuilder  # noqa: F401,E402

__version__ = "0.1.0"
