"""The port's CLI: the JAX package's ``main.py`` flag for flag, on the card.

    python -m path_tracing__ray_tracer_tpu_torch [flags]

Same flags, defaults and printed lines as the JAX package's ``main.py``
(itself flag-compatible with the reference's ``main.py:24-46``): the
path-sample override, the capability listing, the time estimate, the
Mrays/sec report.  The renderer default is the reference's
``cuda_texture_raytracer``; the JAX package's ``tpu_*`` names work as
aliases.  Renders run on the card; :func:`main`'s ``device`` keyword
(``"cpu"``, which no flag sets) renders through the kernels' plain versions
on the CPU instead.  ``--devices N`` splits each chunk over a mesh of the
first N cards (``parallel/mesh.make_mesh``; N CPU entries under
``device="cpu"``), and fails when there are fewer cards.
"""
from __future__ import annotations

import argparse
import sys
import time

from .core.scene import RenderSettings
from .models.base import RendererFactory
from .scene_builders.custom_scene_builder import CustomSceneBuilder
from .utils.logging import log_event
from .utils.profiling import maybe_trace

# The time estimate's rates, from chip_smoke.py on an NVIDIA H100 80GB HBM3 at
# a 700 W power limit (PERF.md §5): the path tracer's main path ran 47-51
# Mrays/s and the Whitted CLI frame (2000x1500, 25 spp, depth 16: 1.2e9 rays
# by the W·H·spp·depth formula) 0.302-0.356 s.
_PATH_RAYS_PER_S = 50e6
_WHITTED_RAYS_PER_S = 3.4e9


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="PyTorch + CUDA modular ray tracer with path tracing"
    )
    parser.add_argument(
        "--renderer",
        "-r",
        choices=RendererFactory.list_available(),
        default="cuda_texture_raytracer",
        help="renderer to use (the JAX package's tpu_* names are aliases)",
    )
    parser.add_argument(
        "--scene",
        choices=["original", "custom", "mesh", "mesh_big"],
        default="custom",
        help=(
            "scene selection ('original' is accepted-but-ignored for flag "
            "parity with the reference; 'mesh' is the 11.5K-triangle "
            "BVH-stress icosphere scene, 'mesh_big' the 128K-triangle "
            "paged-traversal stress)"
        ),
    )
    parser.add_argument("--width", "-w", type=int, default=2000, help="image width")
    parser.add_argument("--height", type=int, default=1500, help="image height")
    parser.add_argument("--samples", "-s", type=int, default=25, help="samples per pixel")
    parser.add_argument("--depth", "-d", type=int, default=16, help="max bounce depth")
    parser.add_argument("--output", "-o", default="output.png", help="output file")
    parser.add_argument(
        "--path-samples",
        type=int,
        default=1024,
        help="samples per pixel for the path tracer",
    )
    # ---- the JAX package's additions ---------------------------------------
    parser.add_argument("--seed", type=int, default=0, help="RNG seed")
    parser.add_argument(
        "--jitter",
        choices=["diagonal", "independent", "center"],
        default=None,
        help=(
            "pixel-jitter mode: 'diagonal' reproduces the reference's du==dv "
            "quirk (Whitted default), 'independent' is proper jitter (path "
            "default), 'center' pins samples for debugging"
        ),
    )
    parser.add_argument(
        "--debug-nans", action="store_true",
        help="check each chunk's radiance sums for NaN/Inf (slow)",
    )
    parser.add_argument(
        "--shadow-tmax",
        choices=["reference", "light"],
        default="reference",
        help=(
            "path-tracer NEE occlusion bound: 'reference' reproduces the "
            "1e6 quirk (occluders beyond the light still shadow), 'light' "
            "bounds at the sampled light point (physically correct, faster "
            "for BVH scenes)"
        ),
    )
    parser.add_argument(
        "--texture-budget",
        type=int,
        default=0,
        help=(
            "cap texture max dimension (box-filtered atlas downsample); "
            "0 = reference-exact full resolution"
        ),
    )
    parser.add_argument(
        "--chunk-rays",
        type=int,
        default=None,
        help=(
            "ray-batch budget per chunk (default: 1<<24 for the path "
            "tracer, 1<<21 otherwise)"
        ),
    )
    parser.add_argument(
        "--progressive",
        type=int,
        default=0,
        metavar="BATCH_SPP",
        help="render in progressive batches of this many spp (0 = one shot)",
    )
    parser.add_argument(
        "--checkpoint",
        default=None,
        help="accumulation checkpoint path for progressive renders (.npz)",
    )
    parser.add_argument(
        "--devices",
        type=int,
        default=0,
        help="shard the render across this many devices (0 = single device)",
    )
    parser.add_argument("--trace-dir", default=None, help="torch.profiler trace output dir")
    parser.add_argument("--no-show", action="store_true", help="do not open a viewer")
    return parser


def main(argv=None, device="cuda") -> int:
    """Run the CLI on ``argv`` (``sys.argv[1:]`` when None); renders on
    ``device``, the card unless the caller asks for ``"cpu"``."""
    args = build_parser().parse_args(argv)

    resolved = RendererFactory.resolve(args.renderer)
    if resolved == "cuda_path_raytracer":
        effective_samples = args.path_samples
        print(f"Path tracer mode: {effective_samples} spp")
    else:
        effective_samples = args.samples
        print(f"Ray tracer mode: {effective_samples} spp")

    settings = RenderSettings(
        width=args.width,
        height=args.height,
        samples_per_pixel=effective_samples,
        max_depth=args.depth,
    )

    from .utils.backend import probe_backend

    platform = probe_backend(device)
    print(f"Backend: {platform}")

    print(f"Building scene: {args.scene}")
    if args.scene in ("mesh", "mesh_big"):
        from .scene_builders.mesh_scene_builder import MeshSceneBuilder

        builder = (MeshSceneBuilder(grid=5, subdivisions=4)
                   if args.scene == "mesh_big" else MeshSceneBuilder())
    else:
        builder = CustomSceneBuilder()
    scene = builder.build_scene()
    camera = builder.create_camera(args.width / args.height)

    print(f"Creating renderer: {args.renderer}")
    chunk_rays = args.chunk_rays
    if chunk_rays is None:
        # the path tracer's 1<<24 budget over its 128-sample groups gives the
        # 131,072-lane chunks of the main path; the Whitted renderers keep the
        # smaller budget (their chunks hold every grid cell of their pixels)
        chunk_rays = 1 << 24 if resolved == "cuda_path_raytracer" else 1 << 21
    kwargs = {
        "chunk_rays": chunk_rays,
        "seed": args.seed,
        "texture_budget": args.texture_budget,
        "device": device,
    }
    if args.jitter:
        kwargs["jitter"] = args.jitter
    if args.shadow_tmax != "reference":
        if resolved == "cuda_path_raytracer":
            kwargs["shadow_tmax"] = args.shadow_tmax
        else:
            print(
                f"Warning: --shadow-tmax {args.shadow_tmax} only applies to "
                "the path tracer; ignored for this renderer"
            )
    if args.devices:
        import torch

        from .parallel.mesh import make_mesh

        dev = torch.device(device)
        kwargs["mesh"] = make_mesh(
            args.devices, devices=None if dev.type == "cuda" else [dev] * args.devices)
    renderer = RendererFactory.create(args.renderer, **kwargs)
    print(f"Capabilities: {', '.join(renderer.get_capabilities())}")

    # ETA heuristic (reference main.py:80-86 prints one per renderer class),
    # at the card's rates above; none for a render on the CPU
    px = args.width * args.height
    if platform != "cuda" and resolved != "cpu_raytracer":
        print("Estimated render time: not estimated on the CPU")
    elif resolved == "cuda_path_raytracer":
        eta = px * effective_samples * args.depth / _PATH_RAYS_PER_S + 10
        print(f"Estimated render time: ~{eta:.0f}s (Global Illumination)")
    elif resolved == "cpu_raytracer":
        print("Estimated render time: 30-60s+ (CPU-parity oracle)")
        from .models.whitted_oracle import ORACLE_MAX_DEPTH

        if args.depth > ORACLE_MAX_DEPTH:
            print(
                f"Note: cpu_raytracer clamps depth to {ORACLE_MAX_DEPTH} "
                f"(requested {args.depth}); fork chains beyond carry "
                "<0.85^12 of a glass path's energy (QUIRKS.md)"
            )
    else:
        eta = max(3.0, px * effective_samples * args.depth / _WHITTED_RAYS_PER_S + 3)
        print(f"Estimated render time: ~{eta:.0f}s (CUDA accelerated)")

    from .utils.debug import debug_nans

    start = time.time()
    with maybe_trace(args.trace_dir), debug_nans(args.debug_nans):
        if args.progressive:
            from .parallel.progressive import render_progressive

            image = render_progressive(
                renderer,
                scene,
                camera,
                settings,
                batch_spp=args.progressive,
                checkpoint_path=args.checkpoint,
            )
        else:
            image = renderer.render(scene, camera, settings)
    elapsed = time.time() - start

    image.save(args.output)
    print(f"Saved: {args.output}")
    minutes, seconds = int(elapsed // 60), elapsed % 60
    print(f"Total time: {minutes}m {seconds:.2f}s")

    if resolved == "cuda_path_raytracer":
        total_rays = args.width * args.height * effective_samples * args.depth
        print(
            f"Throughput: {total_rays / elapsed / 1e6:.2f}M rays/sec "
            f"({total_rays / 1e6:.1f}M rays total)"
        )

    # quality-tier summary (reference main.py:111-118)
    if resolved == "cuda_path_raytracer":
        print("Render quality: Global Illumination (highest)")
    elif resolved == "cuda_texture_raytracer":
        print("Render quality: Whitted ray tracing + textures (high)")
    elif resolved == "cuda_raytracer":
        print("Render quality: accelerated ray tracing (medium)")
    else:
        print("Render quality: CPU ray tracing (basic)")
    log_event(
        "cli_done",
        renderer=args.renderer,
        output=args.output,
        seconds=round(elapsed, 3),
    )

    if not args.no_show:
        try:
            image.show()
        except Exception:
            print("Viewer unavailable")
    return 0


if __name__ == "__main__":
    sys.exit(main())
