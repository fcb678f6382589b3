"""The (tile × sample) split of one chunk call over a device mesh (port of
the JAX package's ``parallel/sharding.py``).

The JAX package wraps a chunk function in ``shard_map``: every device
derives its pixel base (``tile`` axis) and sample base (``sample`` axis)
from its mesh coordinates, renders its part with the same compiled kernel
one chip runs, the partial sums are ``psum``-reduced over ``sample`` and
the tiles are gathered.  Here each entry's part renders in the entry's
worker process (``parallel/workers.py``), all at once; after every entry of
the call has returned, the partial sums are added over ``sample`` in
ascending order (the ``psum``) and each tile's block is placed into the
output sums (the gather).

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
from typing import Callable, List, NamedTuple

import torch

from .mesh import DeviceMesh


class Part(NamedTuple):
    """One entry's part of a chunk call."""

    entry: int  # the entry's index, tile-major (``DeviceMesh.entries``' order)
    si: int
    device: torch.device
    pix0: int
    sample_base: int
    n_samples: int


def device_scope(device: torch.device):
    """Make ``device`` the CUDA runtime's current device within the scope
    (nothing for the CPU).  The kernel wrappers launch on the stream of the
    tensors' device, but the launch, ``cudaFuncSetAttribute`` and the
    occupancy queries act on the runtime's current device."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def chunk_parts(mesh: DeviceMesh, pix0: int, sample_base: int, n_samples: int, local_pix: int,
                local_samples: int) -> List[Part]:
    """The parts of the call that adds ``n_samples`` samples from
    ``sample_base`` on for the ``local_pix · tile`` pixels from ``pix0`` on,
    tile-major; an entry past the group's end has none."""
    end = sample_base + n_samples
    parts = []
    for i, (ti, si, dev) in enumerate(mesh.entries()):
        s0 = sample_base + si * local_samples
        n = min(local_samples, end - s0)
        if n > 0:  # a group smaller than the sample axis leaves nothing here
            parts.append(Part(i, si, dev, pix0 + ti * local_pix, s0, n))
    return parts


def shard_chunk_fn(render_parts: Callable, mesh: DeviceMesh, local_pix: int,
                   local_samples: int) -> Callable:
    """Wrap ``render_parts(parts, sums)``, which renders every :class:`Part`
    of a call and returns each one's ``(3, local_pix)`` block on
    ``sums.device`` (entry ``(ti, 0)``'s continuing the fold of its tile
    block of ``sums``, the others from zeros), into ``run(sums, pix0,
    sample_base, n_samples)``: the chunk call, its result composed into
    ``sums[:, pix0:]``."""

    def run(sums: torch.Tensor, pix0: int, sample_base: int, n_samples: int) -> None:
        parts = chunk_parts(mesh, pix0, sample_base, n_samples, local_pix, local_samples)
        for part, block in zip(parts, render_parts(parts, sums)):
            tile = sums[:, part.pix0:part.pix0 + local_pix]
            if part.si == 0:  # each tile's (ti, 0) comes before its partials
                tile.copy_(block)
            else:
                tile += block

    return run
