"""The (tile × sample) split of one chunk call over a device mesh (port of
the JAX package's ``parallel/sharding.py``).

The JAX package wraps a chunk function in ``shard_map``: every device
derives its pixel base (``tile`` axis) and sample base (``sample`` axis)
from its mesh coordinates, renders its part with the same compiled kernel
one chip runs, the partial sums are ``psum``-reduced over ``sample`` and
the tiles are gathered.  The port has one controller: this process drives
every entry in turn, each on its own device with its own compiled scene,
adds the partial sums over ``sample`` in ascending order (the ``psum``) and
places each tile's block into the output sums (the gather).

Entry ``(ti, si)`` renders pixels ``[pix0 + ti·local_pix, +local_pix)`` and
samples ``[sample_base + si·local_samples, +local_samples)`` clipped to the
group's end, so each (pixel, sample) is rendered exactly once whatever the
split.  (The JAX package's path tracer renders the overshoot past the group
and counts it again; the port does not copy that.)  Entry ``(ti, 0)``
continues the fold of the tile's block; entries ``(ti, si > 0)`` fold onto
zeros and their partials are added onto the block.  So with one sample entry
or one sample each, every pixel adds its samples in the order one device
does, and the split's sums are the single-device sums bit for bit.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch

from .mesh import DeviceMesh


def device_scope(device: torch.device):
    """Make ``device`` the CUDA runtime's current device within the scope
    (nothing for the CPU).  The kernel wrappers launch on the stream of the
    tensors' device, but the launch, ``cudaFuncSetAttribute`` and the
    occupancy queries act on the runtime's current device."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def shard_chunk_fn(inner_chunk_fn: Callable, mesh: DeviceMesh, local_pix: int,
                   local_samples: int) -> Callable:
    """Wrap ``inner_chunk_fn(device, out, col0, pix0, sample_base,
    n_samples)``, which adds ``n_samples`` samples from ``sample_base`` on
    for the pixels ``[pix0, pix0 + local_pix)`` into ``out[:, col0:col0 +
    local_pix]`` on ``device``, into ``run(sums, pix0, sample_base,
    n_samples)``: the same for the ``local_pix · tile`` pixels from ``pix0``
    on, into ``sums[:, pix0:]``, split over the mesh."""

    def run(sums: torch.Tensor, pix0: int, sample_base: int, n_samples: int) -> None:
        end = sample_base + n_samples
        for ti, si, dev in mesh.entries():
            s0 = sample_base + si * local_samples
            n = min(local_samples, end - s0)
            if n <= 0:  # a group smaller than the sample axis: nothing left here
                continue
            p0 = pix0 + ti * local_pix
            block = sums[:, p0:p0 + local_pix]
            with device_scope(dev):
                if si == 0 and dev == sums.device:
                    inner_chunk_fn(dev, sums, p0, p0, s0, n)
                    continue
                if si == 0:
                    part = block.to(dev, copy=True)
                else:
                    part = torch.zeros((3, local_pix), dtype=sums.dtype, device=dev)
                inner_chunk_fn(dev, part, 0, p0, s0, n)
            if si == 0:
                block.copy_(part)
            else:
                block += part.to(sums.device)

    return run
