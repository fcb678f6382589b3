"""Entry points: the flagship chunk on one device, and a dry run of the
(tile × sample) split (port of the JAX package's ``__graft_entry__.py``).

``entry()`` returns the path tracer's chunk function with concrete example
arguments.  ``dryrun_multichip(n)`` builds an n-entry ``(tile, sample)``
mesh and holds four sharded renders against their single-device renders.
The entries may all be one device (``devices=[torch.device("cpu")] * 8``,
or four entries of one card): each still renders its own part.

    python -m path_tracing__ray_tracer_tpu_torch.graft_entry        # entry() on the card
    python -m path_tracing__ray_tracer_tpu_torch.graft_entry 4      # dryrun_multichip(4)
"""
from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from .compiler import compile_scene, pack_camera
from .core.scene import RenderSettings
from .models.base import RendererFactory
from .models.path_tracer import _regen_chunk
from .ops import bvh
from .ops.cuda.bounce import pack_light_blob, pack_mat_blob, pack_scene_blob
from .parallel.mesh import DeviceMesh, make_mesh
from .scene_builders.custom_scene_builder import CustomSceneBuilder
from .scene_builders.mesh_scene_builder import MeshSceneBuilder

ENTRY_WIDTH = ENTRY_HEIGHT = 64
ENTRY_SPP = ENTRY_DEPTH = 4
# ops/bvh's ONE_LEVEL_LIMIT and PAGE_BUDGET_FLOATS in sub-check 4: small
# enough that MeshSceneBuilder(2, 1) pages
PAGED_LIMITS = (2000, 800)


def _example_scene():
    builder = CustomSceneBuilder()
    return builder.build_scene(), builder.create_camera(1.0)


def entry(device="cuda"):
    """The flagship model's chunk step (the path tracer's, K1 on the card).

    Returns ``(fn, example_args)`` where ``fn(cs, cam12, pix0, seed,
    sample_base)`` gives the ``(3, 4096)`` float32 radiance sums of the
    4096 pixels from ``pix0`` on of a 64×64 Cornell frame at 4 spp, depth 4,
    ``jitter="independent"``.
    """
    scene, camera = _example_scene()
    cs = compile_scene(scene, device=device)
    cam12 = pack_camera(camera, device)
    n_pix = ENTRY_WIDTH * ENTRY_HEIGHT

    def fn(cs, cam12, pix0, seed, sample_base):
        sums = torch.zeros((3, n_pix), dtype=torch.float32, device=cam12.device)
        blobs = (pack_scene_blob(cs), pack_mat_blob(cs), pack_light_blob(cs))
        _regen_chunk(cs, blobs, cam12, sums, int(pix0), int(seed), int(sample_base), col0=0,
                     n_pix=n_pix, width=ENTRY_WIDTH, height=ENTRY_HEIGHT, n_samples=ENTRY_SPP,
                     max_depth=ENTRY_DEPTH, jitter="independent")
        return sums

    return fn, (cs, cam12, 0, 0, 0)


def sub_checks(mesh: DeviceMesh) -> Iterator[str]:
    """The dry run's four sub-checks on ``mesh``, each a sharded render held
    finite and within ``atol=1e-5`` of the single-device render of the same
    (seed, settings) on the mesh's first entry; yields each label once its
    check passed:

    1. ``path/cornell``: the path tracer on the Cornell scene;
    2. ``path/bvh-mesh``: the path tracer on a BVH-compiled mesh scene
       (``use_bvh``, the bounded ``shadow_tmax="light"`` occlusion);
    3. ``whitted/cornell``: the Whitted texture renderer (grid sampler,
       9 cells split unevenly over the sample axis);
    4. ``path/paged-mesh``: the path tracer on a paged scene (the paging
       knobs of ``ops/bvh`` shrunk so a small mesh pages, then restored).
    """

    def check(label, name, scene, camera, settings, **kw):
        sharded = RendererFactory.create(name, mesh=mesh, **kw)
        img = sharded.render_array(scene, camera, settings)
        if not np.isfinite(img).all():
            raise FloatingPointError(f"dryrun_multichip {label}: non-finite pixels")
        single = RendererFactory.create(name, device=mesh.rows[0][0], **kw)
        ref = single.render_array(scene, camera, settings)
        np.testing.assert_allclose(img, ref, atol=1e-5,
                                   err_msg=f"{label}: sharded render != single-device render")
        print(f"dryrun_multichip {label} OK: mean={float(np.mean(img)):.4f}")
        return sharded

    scene, camera = _example_scene()
    check("path/cornell", "cuda_path_raytracer", scene, camera,
          RenderSettings(width=32, height=32, samples_per_pixel=4, max_depth=3),
          sample_group=2, chunk_rays=1 << 12, seed=5)
    yield "path/cornell"

    mb = MeshSceneBuilder(grid=1, subdivisions=1)
    mscene = mb.build_scene()
    r = check("path/bvh-mesh", "cuda_path_raytracer", mscene, mb.create_camera(4 / 3),
              RenderSettings(width=32, height=24, samples_per_pixel=2, max_depth=2),
              sample_group=2, seed=3, shadow_tmax="light", compile_overrides={"use_bvh": True})
    if r.compiled(mscene).bvh is None:
        raise RuntimeError("dryrun_multichip path/bvh-mesh: the scene compiled without a BVH")
    yield "path/bvh-mesh"

    check("whitted/cornell", "cuda_texture_raytracer", scene, camera,
          RenderSettings(width=32, height=24, samples_per_pixel=9, max_depth=2), seed=1)
    yield "whitted/cornell"

    saved = (bvh.ONE_LEVEL_LIMIT, bvh.PAGE_BUDGET_FLOATS)
    bvh.ONE_LEVEL_LIMIT, bvh.PAGE_BUDGET_FLOATS = PAGED_LIMITS
    try:
        pb = MeshSceneBuilder(grid=2, subdivisions=1)
        pscene = pb.build_scene()
        r = check("path/paged-mesh", "cuda_path_raytracer", pscene, pb.create_camera(4 / 3),
                  RenderSettings(width=32, height=24, samples_per_pixel=2, max_depth=2),
                  sample_group=2, seed=7, shadow_tmax="light",
                  compile_overrides={"use_bvh": True})
        pg = r.compiled(pscene).bvh.paged
        if pg is None or pg.n_pages < 2:
            raise RuntimeError("dryrun_multichip path/paged-mesh: the scene did not page")
    finally:
        bvh.ONE_LEVEL_LIMIT, bvh.PAGE_BUDGET_FLOATS = saved
    yield "path/paged-mesh"


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> None:
    """Run the four sub-checks (:func:`sub_checks`) on an ``n_devices``-entry
    mesh of ``devices`` (default: the cards): ``(n/2, 2)`` for an even
    ``n``, else ``(n, 1)``.  Raises on the first that fails."""
    sample_parallel = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_devices, sample_parallel=sample_parallel, devices=devices)
    done = list(sub_checks(mesh))
    print(f"dryrun_multichip OK: mesh={mesh.shape} ({len(done)}/4 sub-checks)")


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1:
        dryrun_multichip(int(sys.argv[1]))
    else:
        fn, args = entry()
        out = fn(*args)
        print("entry OK:", tuple(out.shape))
