"""The path tracer's bounce blocks (``models/path_tracer.BounceBlocks``): the
scheduler whose lane state lives in fixed bucket buffers, run eagerly on the
CPU as the card's CUDA graphs run it.

* With the bucket floor forced small (``_BUCKET_MIN = 16``), so that the
  pool is gathered into padded buckets, the sums equal bit for bit those of
  the exact compaction to the unfinished lanes (``bucket_width`` returning
  ``n_left``) and of no compaction at all, for the default loop, the pipe,
  deferred texture and texture LOD.
* The padded loop against the JAX ``_regen_chunk`` (``_path_chunk``, its
  jitted entry) on the Cornell box, 32×24, 4 spp, depth 4, seed 7: the sums
  within ``rtol = atol = 1e-4`` and the uint8 image within the golden
  tolerance (< 1% of channels off by > 2/255); the same for the pipe (the
  JAX chunk takes its XLA route on the CPU) and for deferred texture.
* ``rng.ray_key`` and ``camera_rays`` with 0-d int64 tensor scalars, as the
  captured blocks read them, equal bit for bit to the Python-int calls over
  seeds ``{0, 7, 2^31 - 1, 2^32 - 1}`` and pixel indices past 2^31 (and
  ``ray_key`` to the JAX package's).
* ``path_radiance`` against the JAX package's at 16 rays, depth 3, both
  ``shadow_tmax`` values, ``rtol = atol = 1e-4``.
* ``_GRAPH_BLOCKS`` and the bucket floor change nothing on the CPU, where no
  block is captured, and a renderer keeps one plan per chunk shape.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import path_tracing__ray_tracer_tpu as jp
import path_tracing__ray_tracer_tpu_torch as pt
from path_tracing__ray_tracer_tpu.models.path_tracer import _path_chunk
from path_tracing__ray_tracer_tpu.models.path_tracer import path_radiance as jax_path_radiance
from path_tracing__ray_tracer_tpu.ops import rng as jrng
from path_tracing__ray_tracer_tpu.ops.v3 import V3 as JV3
from path_tracing__ray_tracer_tpu_torch.models import path_tracer as tpath
from path_tracing__ray_tracer_tpu_torch.models.wavefront import scene_blobs
from path_tracing__ray_tracer_tpu_torch.ops import rng
from path_tracing__ray_tracer_tpu_torch.ops.camera import generate_rays
from path_tracing__ray_tracer_tpu_torch.ops.tonemap import aces, quantize_u8
from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

W, H, NS, DEPTH, SEED = 32, 24, 4, 4, 7
CHUNK = dict(n_pix=W * H, width=W, height=H, n_samples=NS, max_depth=DEPTH, jitter="independent")
SEEDS = (0, 7, 2**31 - 1, 2**32 - 1)


@pytest.fixture(scope="module")
def cornell():
    """The Cornell box from the JAX package (exact and with a 16-texel mip at
    texture budget 64) and its port, the camera of both."""
    b = jp.CustomSceneBuilder()
    scene = b.build_scene()
    jcam = jp.pack_camera(b.create_camera(W / H))
    out = {"jcam": jcam, "tcam": torch.from_numpy(np.array(jcam))}
    for name, kw in (("exact", {}), ("mip16", dict(texture_budget=64, mip_budget=16))):
        jcs = jp.compile_scene(scene, **kw)
        out[name] = (jcs, pt.compiled_scene_from_numpy(jax.tree.map(np.asarray, jcs),
                                                       device="cpu"))
    return out


def _sums(tcs, tcam, pix0=0, sample_base=0, graphs=None, blobs=None, **kw):
    sums = torch.zeros((3, pix0 + CHUNK["n_pix"]), dtype=torch.float32)
    tpath._regen_chunk(tcs, scene_blobs(tcs) if blobs is None else blobs, tcam, sums, pix0,
                       SEED, sample_base, graphs=graphs, **{**CHUNK, **kw})
    return sums[:, pix0:].T.numpy()


def _mode(cornell, monkeypatch, mode):
    """The port's scene and chunk arguments of ``mode``."""
    if mode == "pipe":
        monkeypatch.setattr(tpath, "_PIPE_REGEN", True)
    scene = "mip16" if mode in ("defer", "lod") else "exact"
    return cornell[scene][1], dict(lod_depth=2) if mode == "lod" else {}


def _image(sums):
    img = aces(torch.from_numpy(sums).T / float(NS))
    return quantize_u8(V3(img[0], img[1], img[2])).to_array().numpy()


@pytest.mark.parametrize("mode", ["default", "pipe", "defer", "lod"])
def test_padded_buckets_equal_exact_compaction(cornell, monkeypatch, mode):
    """The chunk overhangs the frame (``pix0 = 100``, ``sample_base = 6``)."""
    tcs, kw = _mode(cornell, monkeypatch, mode)
    args = (tcs, cornell["tcam"], 100, 6)
    monkeypatch.setattr(tpath, "_BUCKET_MIN", 16)
    widths = []
    bucket = tpath.bucket_width
    monkeypatch.setattr(tpath, "bucket_width",
                        lambda n_left, n_pix: widths.append(bucket(n_left, n_pix)) or widths[-1])
    padded = _sums(*args, **kw)
    assert any(w < CHUNK["n_pix"] for w in widths)  # the pool was gathered into buckets
    monkeypatch.setattr(tpath, "bucket_width", lambda n_left, n_pix: n_left)  # exact compaction
    np.testing.assert_array_equal(padded, _sums(*args, **kw))
    monkeypatch.setattr(tpath, "_COMPACT_BELOW", 0.0)  # the whole pool to the end
    np.testing.assert_array_equal(padded, _sums(*args, **kw))
    assert float(padded.mean()) > 0.05


def test_bucket_widths():
    assert [tpath.bucket_width(n, 131072) for n in (1, 1024, 1025, 5000, 70000, 131072)] == [
        1024, 1024, 2048, 8192, 131072, 131072]
    assert tpath.bucket_width(700, 768) == 768  # capped at the chunk


@pytest.fixture(scope="module")
def jax_sums(cornell):
    """The JAX chunk sums (4 spp, seed 7) of the exact scene and of the
    scene with a mip (deferred texture there)."""
    out = {}
    for name in ("exact", "mip16"):
        jcs = cornell[name][0]
        want = _path_chunk(jcs, cornell["jcam"], jnp.int32(0), jnp.uint32(SEED), jnp.int32(0),
                           **CHUNK)
        out[name] = np.stack([np.asarray(c) for c in want], -1)
    return out


@pytest.mark.parametrize("mode", ["default", "pipe", "defer"])
def test_padded_loop_matches_jax_regen_chunk(cornell, jax_sums, monkeypatch, mode):
    tcs, kw = _mode(cornell, monkeypatch, mode)
    monkeypatch.setattr(tpath, "_BUCKET_MIN", 16)
    got = _sums(tcs, cornell["tcam"], **kw)
    want = jax_sums["mip16" if mode == "defer" else "exact"]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    diff = np.abs(_image(got).astype(np.int32) - _image(want).astype(np.int32))
    assert float((diff > 2).mean()) < 0.01, (float((diff > 2).mean()), int(diff.max()))
    assert float(want.mean()) > 0.05  # a lit chunk, not a trivially equal one


def test_graph_knob_and_plan_cache_on_the_cpu(cornell, monkeypatch):
    """No block is captured on the CPU, so ``_GRAPH_BLOCKS`` changes
    nothing; a cache keeps one plan per chunk shape and knob set, reused by
    every chunk and sample group of the shape."""
    tcs = cornell["exact"][1]
    kw = dict(graphs={}, blobs=scene_blobs(tcs))
    graphs = kw["graphs"]
    first = _sums(tcs, cornell["tcam"], **kw)
    assert len(graphs) == 1
    (plan,) = graphs.values()
    assert not plan.blocks.graphed and not plan.blocks.graphs
    np.testing.assert_array_equal(_sums(tcs, cornell["tcam"], **kw), first)
    other_group = _sums(tcs, cornell["tcam"], sample_base=NS, **kw)
    assert len(graphs) == 1 and not np.array_equal(other_group, first)
    np.testing.assert_array_equal(_sums(tcs, cornell["tcam"], sample_base=NS), other_group)
    monkeypatch.setattr(tpath, "_GRAPH_BLOCKS", False)
    np.testing.assert_array_equal(_sums(tcs, cornell["tcam"], **kw), first)
    assert len(graphs) == 2  # the knob is part of the key


@pytest.mark.parametrize("seed", SEEDS)
def test_tensor_scalars_give_the_same_keys_and_rays(cornell, seed):
    pix = torch.tensor([0, 5, 2**31 - 1, 2**31, 2**31 + 12345, 2**32 - 1, 2**32 + 7],
                       dtype=torch.int64)
    t = lambda x: torch.tensor(x, dtype=torch.int64)  # noqa: E731
    for sample in (0, 6, 2**31 + 3):
        want = rng.ray_key(seed, pix, sample)
        assert torch.equal(rng.ray_key(t(seed), pix, t(sample)), want)
        jwant = jrng.ray_key(jnp.uint32(seed), jnp.asarray(pix.numpy().astype(np.uint32)),
                             jnp.uint32(sample & 0xFFFFFFFF))
        np.testing.assert_array_equal(want.numpy().view(np.uint32), np.asarray(jwant))
    lane = torch.arange(96, dtype=torch.int64)
    s = torch.arange(96, dtype=torch.int64) % 3
    for pix0 in (0, 2**31 - 50, 2**31 + 9, 2**32 - 40):
        common = dict(n_pix=96, stride=tpath.item_stride(96, 3), width=W, height=H,
                      max_depth=DEPTH, jitter="independent")
        want = tpath.camera_rays(cornell["tcam"], lane, s, pix0=pix0, seed=seed, sample_base=6,
                                 **common)
        got = tpath.camera_rays(cornell["tcam"], lane, s, pix0=t(pix0), seed=t(seed),
                                sample_base=t(6), **common)
        for g, w in zip(got, want):
            for a, b in zip(g if isinstance(g, V3) else (g,), w if isinstance(w, V3) else (w,)):
                assert torch.equal(a, b)


@pytest.mark.parametrize("shadow_tmax", ["reference", "light"])
def test_path_radiance_matches_jax(cornell, shadow_tmax):
    jcs, tcs = cornell["exact"]
    gen = np.random.default_rng(21)
    u, v = (torch.from_numpy(gen.random(16).astype(np.float32)) for _ in range(2))
    o, d = generate_rays(cornell["tcam"], u, v)
    key = gen.integers(0, 2**32, 16, dtype=np.uint64).astype(np.uint32)
    got = tpath.path_radiance(tcs, o, d, torch.from_numpy(key.view(np.int32)), 3, shadow_tmax)
    want = jax_path_radiance(jcs, JV3(*(jnp.asarray(c.numpy()) for c in o)),
                             JV3(*(jnp.asarray(c.numpy()) for c in d)), jnp.asarray(key), 3,
                             shadow_tmax)
    got = np.stack([c.numpy() for c in got], -1)
    want = np.stack([np.asarray(c) for c in want], -1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert float(want.max()) > 0.05  # some ray found light
