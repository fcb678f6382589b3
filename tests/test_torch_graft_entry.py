"""The port's entry points (``path_tracing__ray_tracer_tpu_torch/graft_entry.py``)
against the JAX package's ``__graft_entry__.py``, on the CPU.

* ``entry(device="cpu")``: finite ``(3, 4096)`` sums of the 64×64 Cornell
  chunk at 4 spp, depth 4, against the JAX ``entry()`` output at the bar of
  ``tests/test_torch_path_tracer.py`` (≥ 99.5% of pixels within
  ``atol = rtol = 1e-3``).
* ``dryrun_multichip(8, devices=[cpu] * 8)``: a (4, 2) mesh, its four
  sub-checks pass and are printed, and the paging knobs it shrinks are
  restored.
"""
import numpy as np
import torch

import __graft_entry__ as jge
from path_tracing__ray_tracer_tpu_torch import graft_entry as tge
from path_tracing__ray_tracer_tpu_torch.ops import bvh as tbvh
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def test_entry_matches_jax_entry():
    fn, args = tge.entry(device="cpu")
    out = fn(*args)
    assert tuple(out.shape) == (3, 4096) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    jfn, jargs = jge.entry()
    want = np.stack([np.asarray(c) for c in jfn(*jargs)], -1)
    got = out.T.numpy()
    close = np.abs(got - want) <= 1e-3 + 1e-3 * np.abs(want)
    assert close.all(axis=1).mean() >= 0.995, (close.all(axis=1).mean(), np.abs(got - want).max())
    assert float(want.mean()) > 0.1


def test_dryrun_multichip_on_8_cpu_entries(capsys):
    knobs = (tbvh.ONE_LEVEL_LIMIT, tbvh.PAGE_BUDGET_FLOATS)
    tge.dryrun_multichip(8, devices=[torch.device("cpu")] * 8)
    out = capsys.readouterr().out
    for label in ("path/cornell", "path/bvh-mesh", "whitted/cornell", "path/paged-mesh"):
        assert f"dryrun_multichip {label} OK" in out
    assert "dryrun_multichip OK: mesh={'tile': 4, 'sample': 2} (4/4 sub-checks)" in out
    assert (tbvh.ONE_LEVEL_LIMIT, tbvh.PAGE_BUDGET_FLOATS) == knobs
