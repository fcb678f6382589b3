"""The check that decides ``correct`` is shown to fail: its control (the
reference in bfloat16 put in the program's place) and each fault a cell
can have, planted in the port underneath a whole run on the CPU.

Faults (a cell on one card has no exchange between chips):

* a step that returns its state unchanged: the bounce block leaves the
  lanes as they were (the scheduler then gives up on the request);
* half of the batch left out, the mean taken over the rest: each chunk
  renders half its samples and counts them twice;
* an answer altered where it is produced: a group's sums miss their last
  sample (``rebin``), a frame's image keeps its rows bottom-up.

    python -m pytest bench_port/tests -q
"""
from __future__ import annotations

import pytest
import torch

from tiny import SEED, tiny

from bench_port import control, run


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["cornell-final", "cornell-frames"])
def test_control_fails_the_check(name):
    c = tiny(name)
    numbers, details = control.control_numbers(c, SEED, 4, "cpu")
    assert details["requests_checked"] >= 1
    assert any(numbers[k] > c.limits[k] for k in c.limits), numbers


def _unchanged(monkeypatch):
    from path_tracing__ray_tracer_tpu_torch.models import path_tracer

    monkeypatch.setattr(path_tracer.BounceBlocks, "_block", lambda self, state: None)


def _half(monkeypatch):
    from path_tracing__ray_tracer_tpu_torch.models import path_tracer

    loop = path_tracer._regen_loop

    def half(cs, blobs, cam12, sums, pix0, seed, sample_base, *, n_samples, **kw):
        part = torch.zeros_like(sums)
        loop(cs, blobs, cam12, part, pix0, seed, sample_base, n_samples=n_samples // 2, **kw)
        sums += 2.0 * part

    monkeypatch.setattr(path_tracer, "_regen_loop", half)


def _altered(monkeypatch):
    import numpy as np

    from path_tracing__ray_tracer_tpu_torch.models import path_tracer, wavefront

    rebin = path_tracer.rebin
    monkeypatch.setattr(path_tracer, "rebin", lambda sums, acc, col0, n_pix, n:
                        rebin(sums, acc, col0, n_pix, n - 1))

    def unflipped(rgb_u8, width, height):
        from PIL import Image

        return Image.fromarray(np.asarray(rgb_u8, np.uint8).reshape(height, width, 3), "RGB")

    monkeypatch.setattr(wavefront, "assemble_image", unflipped)


@pytest.mark.parametrize("fault", [None, _unchanged, _half, _altered],
                         ids=["sound", "unchanged", "half", "altered"])
@pytest.mark.parametrize("name", ["cornell-final", "cornell-frames"])
def test_a_fault_underneath_turns_correct_false(monkeypatch, name, fault):
    if fault is not None:
        fault(monkeypatch)
    out = run.execute(tiny(name), SEED, 0.3, False, "cpu")
    assert out["correct"] is (fault is None), out["check"]
