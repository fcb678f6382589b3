#!/usr/bin/env python3
"""The ``[mesh]`` phase of ``chip_smoke.py`` alone, on one NVIDIA GPU: the
(tile × sample) split of the path tracer's main path over a (2, 2) mesh of
four entries of the one card, beside the one-device group it is held to.

Runs ``chip_smoke.py``'s ``phase_environment``, ``phase_build``,
``phase_main_path`` (a warm-up 128-sample group, then the timed one at
1024², depth 8) and ``phase_mesh`` (the dry run's four sub-checks, the main
path through the split, the CLI's ``--devices``, ``entry()``) in one process,
then prints the card's name and power limit.  With a directory argument it
runs that checkout's ``chip_smoke.py`` and package instead (a ``git archive``
of another commit, unpacked into a directory that ``.gitignore`` lists), so
two commits compare in one call, in turns:

    git archive <commit> | (mkdir -p .scratch/parent && tar -x -C .scratch/parent)
    python3 experiments/torch_mesh_workers.py .scratch/parent
    python3 experiments/torch_mesh_workers.py
"""
import sys
import time
from pathlib import Path


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parents[1])
    sys.path.insert(0, str(root.resolve()))
    import chip_smoke as cs
    import torch

    print(f"[workers] checkout {root.resolve()}")
    t0 = time.perf_counter()
    cs.phase_environment()
    cs.phase_build()
    device = torch.device("cuda", 0)
    _launches, secs, _mrays, _img, _first_img, first_group = cs.phase_main_path(device)
    mesh_secs, share = cs.phase_mesh(device, first_group, secs)
    print(f"[workers] the split main path {mesh_secs:.3f} s, {mesh_secs / secs:.3f}x the "
          f"one-device group's {secs:.3f} s ({share:.6f} of channels by >2/255 off it); "
          f"{time.perf_counter() - t0:.1f} s in all, on:")
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
