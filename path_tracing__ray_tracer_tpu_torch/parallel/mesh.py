"""Device meshes for sharded rendering (port of the JAX package's
``parallel/mesh.py``).

A mesh is a 2-D ``(tile, sample)`` grid of devices: the ``tile`` axis splits
each pixel chunk (data parallel over rays, no communication), the ``sample``
axis splits each sample group (partial sums added over it, the JAX
package's ``psum``).  The JAX package's mesh is one ``shard_map`` program;
the port's is a list of ``torch.device`` entries that one process drives in
turn (``parallel/sharding.py``).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch


class DeviceMesh:
    """A ``(tile, sample)`` grid of devices; ``rows[ti][si]`` is entry
    ``(ti, si)``.  An entry may repeat another's device (several entries of
    one card, or of the CPU): each still renders its own part, so the split's
    code runs on one device as it would on many."""

    def __init__(self, rows: Sequence[Sequence]):
        self.rows: Tuple[Tuple[torch.device, ...], ...] = tuple(
            tuple(torch.device(d) for d in row) for row in rows)
        if not self.rows or len({len(r) for r in self.rows}) != 1 or not self.rows[0]:
            raise ValueError("DeviceMesh: rows must be non-empty and of one length")

    @property
    def shape(self) -> Dict[str, int]:
        return {"tile": len(self.rows), "sample": len(self.rows[0])}

    def devices(self) -> List[torch.device]:
        """The distinct devices of the mesh, in entry order."""
        return list(dict.fromkeys(d for row in self.rows for d in row))

    def entries(self) -> Iterator[Tuple[int, int, torch.device]]:
        """``(ti, si, device)`` of each entry, tile-major."""
        for ti, row in enumerate(self.rows):
            for si, dev in enumerate(row):
                yield ti, si, dev

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, {[[str(d) for d in r] for r in self.rows]})"


def make_mesh(
    n_devices: Optional[int] = None,
    sample_parallel: int = 1,
    devices: Optional[Sequence] = None,
) -> DeviceMesh:
    """Build a ``(tile, sample)`` mesh over the first ``n_devices`` of
    ``devices`` (default: every CUDA device, ``cuda:0``, ``cuda:1``, ...).

    ``sample_parallel`` entries cooperate on the same pixels (their partial
    sample sums are added); the rest split the pixel space.  Raises
    ``RuntimeError`` when no ``devices`` are given and torch sees no card
    (there is no fallback to the CPU: pass ``devices=[torch.device("cpu")]
    * n`` for a mesh on the CPU), and ``ValueError`` on more devices than
    there are or ``n_devices`` not a multiple of ``sample_parallel``.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: torch sees no CUDA device (pass devices= for a "
                               "mesh of other devices, such as the CPU)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = list(devices)
    if n_devices is None:
        n_devices = len(devs)
    if n_devices < 1:
        raise ValueError(f"make_mesh: n_devices must be at least 1, not {n_devices}")
    if n_devices > len(devs):
        raise ValueError(f"make_mesh: requested {n_devices} devices, have {len(devs)}")
    if sample_parallel < 1 or n_devices % sample_parallel != 0:
        raise ValueError("make_mesh: n_devices must be divisible by sample_parallel")
    return DeviceMesh([devs[i:i + sample_parallel]
                       for i in range(0, n_devices, sample_parallel)])


def mesh_shape(mesh: DeviceMesh) -> Tuple[int, int]:
    return mesh.shape["tile"], mesh.shape["sample"]
