"""The texture gathers of the port (``ops/cuda/texture.py``) against the JAX
package's TPU kernels, and the atlas route of the path tracer's resolve.

* ``gather_plain`` (the plain version of K8 and K9), through the CPU
  routes of ``atlas_gather`` and ``mip_gather``, against ``mxu_gather_rgb``
  under the Pallas interpreter, with the JAX ``ENABLED`` gate switched on
  by ``monkeypatch`` for the test: 1,024 indices on a budget-16 atlas,
  some below 0 and some past the atlas (the clamp and the zero padding of
  the TPU planes).  Exact.
* the same against ``mip_gather_rgb`` with ``MIP_FORCE_KERNEL``: 512
  indices, the shape of ``tests/test_defer_texture.py``'s check.  Exact.
* With the port's ``ENABLED`` switched on, a chunk's resolve takes
  ``atlas_gather`` (a CPU tensor: its plain version) and the chunk sums
  equal the default ones bit for bit; an atlas over ``MAX_ROWS`` rows
  declines the route.
* The multi-lane gather that ``experiments/
  torch_gather_and_skiplink_any_first_design.py`` builds beside the kernel
  (measured no faster on an H100, so not kept), emulated thread by thread
  (``_lanes_model``): a scalar head up to the first index at a
  ``4·lanes``-byte boundary, groups of ``lanes`` lanes read and written as
  rows, a scalar tail; at 2 and 4 lanes a thread, for n of 1, 3, 4, 5 and
  131 and for an index view one element in, every lane written once and the
  rows bit-equal to ``gather_plain``, with indices below 0, past the texels
  and past ``128·R``.  No JAX here.

The kernels themselves run only on a GPU (``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import path_tracing__ray_tracer_tpu as jp
import path_tracing__ray_tracer_tpu_torch as pt
from path_tracing__ray_tracer_tpu.ops.pallas import texture_pallas as jtp
from path_tracing__ray_tracer_tpu_torch.models import path_tracer as tpath
from path_tracing__ray_tracer_tpu_torch.ops.cuda import bounce
from path_tracing__ray_tracer_tpu_torch.ops.cuda import texture as ttex
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def budget16():
    jcs = jp.compile_scene(jp.CustomSceneBuilder().build_scene(), texture_budget=16,
                           mip_budget=16)
    return jcs, pt.compiled_scene_from_numpy(jax.tree.map(np.asarray, jcs), device="cpu")


def _indices(n, n_texels, seed):
    """Indices over the atlas, plus a few below 0 and in the padding past it."""
    g = np.random.default_rng(seed)
    idx = g.integers(0, n_texels, n)
    idx[:8] = [-5, -1, n_texels - 1, n_texels, n_texels + 3, 10**6, 0, 1]
    return idx.astype(np.int32)


def _assert_rgb_equal(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_atlas_gather_plain_matches_mxu_kernel(budget16, monkeypatch):
    from jax.experimental.pallas import tpu as pltpu

    jcs, tcs = budget16
    monkeypatch.setattr(jtp, "ENABLED", True)
    assert jtp.fits_mxu_atlas(jcs)
    idx = _indices(1024, int(tcs.atlas.shape[0]), 7)
    with pltpu.force_tpu_interpret_mode():
        want = jtp.mxu_gather_rgb(jtp.pack_mxu_atlas(jcs), jnp.asarray(idx))
    before = ttex.atlas_gather.launches
    _assert_rgb_equal(ttex.atlas_gather(tcs.atlas, torch.from_numpy(idx)), want)
    assert ttex.atlas_gather.launches == before  # a CPU tensor takes the plain version


def test_mip_gather_plain_matches_mip_kernel(budget16, monkeypatch):
    from jax.experimental.pallas import tpu as pltpu

    jcs, tcs = budget16
    idx = _indices(512, int(tcs.mip_atlas.shape[0]), 11)
    monkeypatch.setattr(jtp, "MIP_FORCE_KERNEL", True)
    with pltpu.force_tpu_interpret_mode():
        want = jtp.mip_gather_rgb(jcs, jtp.pack_mip_table(jcs), jnp.asarray(idx))
    assert jtp.fits_mip(jcs) and ttex.fits_mip(tcs)
    _assert_rgb_equal(ttex.mip_gather(tcs.mip_atlas, torch.from_numpy(idx)), want)


def test_atlas_route_of_the_resolve(budget16, monkeypatch):
    _, tcs = budget16
    tcs = tcs._replace(mip_atlas=None)  # the default scheduler, not a texture mode
    cam12 = torch.from_numpy(np.array(jp.pack_camera(
        jp.CustomSceneBuilder().create_camera(1.0))))
    blobs = (bounce.pack_scene_blob(tcs), bounce.pack_mat_blob(tcs), bounce.pack_light_blob(tcs))

    def sums():
        out = torch.zeros((3, 1024), dtype=torch.float32)
        tpath._regen_chunk(tcs, blobs, cam12, out, 0, 5, 0, n_pix=1024, width=32, height=32,
                           n_samples=2, max_depth=3, jitter="independent")
        return out.numpy()

    want = sums()
    calls = []
    plain = ttex.gather_plain
    monkeypatch.setattr(ttex, "gather_plain", lambda *a: calls.append(1) or plain(*a))
    monkeypatch.setattr(ttex, "ENABLED", True)
    assert ttex.fits_mxu_atlas(tcs)
    np.testing.assert_array_equal(sums(), want)
    assert calls  # the route ran through atlas_gather
    monkeypatch.setattr(ttex, "MAX_ROWS", ttex.atlas_rows(tcs) - 1)
    assert not ttex.fits_mxu_atlas(tcs)


def _lanes_model(table: torch.Tensor, idx: torch.Tensor, w: int):
    """The multi-lane gather's threads over ``idx`` (int32, its address's
    phase the kernel's), ``w`` lanes a thread: the rows it writes, each
    lane's arithmetic as the kernel does it, and how many times each lane
    was written."""
    n = idx.numel()
    phase = idx.data_ptr() // 4 % w
    head = min(n, (w - phase) % w)
    groups = (n - head) // w
    n_texels = int(table.shape[0])
    last = -(-n_texels // 128) * 128 - 1
    out, written = torch.zeros((3, n), dtype=torch.float32), torch.zeros(n, dtype=torch.int32)

    def write(lanes):
        k = torch.clamp(idx[lanes], 0, last).long()
        texel = torch.where(k < n_texels, table[torch.clamp(k, max=n_texels - 1)], 0)
        for c in range(3):
            out[c, lanes] = ((texel >> (8 * c)) & 0xFF).to(torch.float32) * np.float32(1 / 255)
        written[lanes] += 1

    for t in range(groups):  # one index load of w lanes, one store of w lanes a row
        write(torch.arange(head + t * w, head + (t + 1) * w))
    for s in range(n - groups * w):  # the head's lanes, then the tail's, one a thread
        write(torch.tensor([s if s < head else head + groups * w + (s - head)]))
    return out, written


@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 131])
def test_gather_lanes_model_is_the_plain_gather(n, offset, lanes):
    table = torch.from_numpy(np.random.default_rng(n).integers(0, 1 << 24, 300).astype(np.int32))
    base = torch.from_numpy(_indices(n + 8, 300, n)).clone()
    # below 0, past the 300 texels, past 128·R = 384, first
    base[:6] = torch.tensor([-5, 300, 10**6, 391, -1, 303], dtype=torch.int32)
    idx = base[offset:offset + n]
    assert base.data_ptr() % 16 == 0 and idx.data_ptr() // 4 % 4 == offset
    got, written = _lanes_model(table, idx, lanes)
    assert torch.equal(written, torch.ones(n, dtype=torch.int32))
    for a, b in zip(got, ttex.gather_plain(table, idx)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
