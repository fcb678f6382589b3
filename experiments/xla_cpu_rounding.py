"""Where the PyTorch port and the JAX package part on the Whitted goldens.

    JAX_PLATFORMS=cpu python experiments/xla_cpu_rounding.py

The port's Whitted and oracle renders differ from the JAX package's CPU
goldens (``tests/goldens/whitted_tex.npy`` and friends) in a few edge pixels.
The intersection candidates are written alike in both packages, op for op;
this script shows what differs instead, on the CPU:

1. how XLA-CPU rounds three basic patterns against torch (IEEE, one rounding
   per op): ``sqrt``; division by a constant under ``jax.jit`` (rewritten to
   a multiplication by the reciprocal); ``x * y + z`` under ``jax.jit``
   (contracted to one fused multiply-add);
2. the camera rays of the ``whitted_tex`` golden (48×36, 4 spp, depth 4,
   seed 42): the JAX package's jitted sampler against the port's;
3. per-ray radiance of those rays (the port's rays fed to both): JAX's
   jitted ``whitted_radiance`` against the port's ``whitted_radiance``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

import path_tracing__ray_tracer_tpu as jp
import path_tracing__ray_tracer_tpu_torch as pt
from path_tracing__ray_tracer_tpu.models import whitted as jw
from path_tracing__ray_tracer_tpu.ops import rng as jrng
from path_tracing__ray_tracer_tpu.ops.camera import generate_rays as jgen
from path_tracing__ray_tracer_tpu.ops.v3 import V3 as JV3
from path_tracing__ray_tracer_tpu_torch.compiler import pack_camera
from path_tracing__ray_tracer_tpu_torch.models import whitted as tw
from path_tracing__ray_tracer_tpu_torch.ops.cuda import whitted as kw
from path_tracing__ray_tracer_tpu_torch.ops.cuda.bounce import (
    pack_light_blob,
    pack_mat_blob,
    pack_scene_blob,
)
from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3

W, H, SPP, DEPTH, SEED = 48, 36, 4, 4, 42


def op_probes(n=100_000):
    g = np.random.default_rng(0)
    a, b = (g.uniform(0.1, 100, n).astype(np.float32) for _ in range(2))
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), torch.from_numpy(a), torch.from_numpy(b)
    probes = {
        "sqrt": (jnp.sqrt(ja), torch.sqrt(ta)),
        "jit x / 48": (jax.jit(lambda x: x / 48)(ja), ta / 48),
        "jit x * y + y": (jax.jit(lambda x, y: x * y + y)(ja, jb), ta * tb + tb),
        "x / y (control)": (ja / jb, ta / tb),
    }
    for name, (j, t) in probes.items():
        print(f"{name:16s}: {int((np.asarray(j) != t.numpy()).sum())} of {n} values differ")


def golden_rays():
    b = jp.CustomSceneBuilder()
    cam12 = pack_camera(b.create_camera(4 / 3), "cpu")
    grid, n = math.isqrt(SPP), W * H
    o, d = tw.grid_camera_rays(cam12, 0, n, W, H, SEED, 0, SPP, grid, DEPTH, "diagonal")

    @jax.jit
    def jax_dirs(cam):  # the sampler of the JAX package's _whitted_chunk
        idx = jnp.arange(n)
        x, y = (idx % W).astype(jnp.float32), (idx // W).astype(jnp.float32)
        out = []
        for cell in range(SPP):
            r1 = jrng.uniform(jrng.ray_key(SEED, idx, cell), DEPTH, 0)
            u = (x + (cell // grid + r1) / grid) / W
            v = (y + (cell % grid + r1) / grid) / H
            out.append(jgen(cam, u, v)[1].to_array())
        return jnp.concatenate(out)

    port = torch.stack(tuple(d), -1).numpy()
    differ = (np.asarray(jax_dirs(jnp.asarray(cam12.numpy()))) != port).any(1)
    print(f"golden camera rays: {int(differ.sum())} of {len(port)} directions differ in some bit")
    return torch.stack(tuple(o), -1).numpy(), port


def radiance(ro, rd):
    jcs = jp.compile_scene(jp.CustomSceneBuilder().build_scene())
    tcs = pt.compiled_scene_from_numpy(jax.tree.map(np.asarray, jcs), device="cpu")
    blobs = (pack_scene_blob(tcs), pack_mat_blob(tcs), pack_light_blob(tcs))
    want = np.asarray(jax.jit(lambda o, d: jw.whitted_radiance(
        jcs, JV3.from_array(o), JV3.from_array(d), DEPTH, jw.TEXTURE).to_array())(ro, rd))
    got = tw.whitted_radiance(tcs, blobs, V3.from_array(torch.from_numpy(ro)),
                              V3.from_array(torch.from_numpy(rd)), DEPTH, kw.TEXTURE)
    diff = np.abs(torch.stack(tuple(got), -1).numpy() - want).max(1)
    print(f"radiance of the same rays: {int((diff > 1e-3).sum())} of {len(diff)} rays differ by "
          f"more than 1e-3 (max {diff.max():.4f})")


if __name__ == "__main__":
    op_probes()
    radiance(*golden_rays())
