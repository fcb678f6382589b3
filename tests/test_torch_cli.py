"""The port's CLI (``path_tracing__ray_tracer_tpu_torch/main.py``) and its
helpers (``utils/debug.py``, ``utils/backend.py``,
``utils/profiling.maybe_trace``), on the CPU.

* Every action of the JAX package's ``main.build_parser()`` exists in the
  port's parser with the same flags, type and default, and no other; the
  renderer default is the reference's ``cuda_texture_raytracer``, which the
  JAX default ``tpu_texture_raytracer`` names in the port, and every
  renderer name of the JAX CLI is accepted.  The short flags parse.
* Tiny end-to-end runs through ``main(argv, device="cpu")``, path and
  Whitted: the saved PNG is bit-equal to ``renderer.render()`` of the same
  settings, with the reference's printed lines; ``--progressive`` with a
  checkpoint, bit-equal to ``render_progressive``; ``--trace-dir`` writes a
  Chrome trace.
* ``--devices N`` raises with fewer than N cards, also through ``python
  -m``; ``probe_backend`` raises without a card unless the CPU is asked for.
* ``assert_finite_image`` and ``debug_nans`` raise on an injected NaN, the
  latter naming the chunk.

No test here renders with the JAX package: its parser is only built.
"""
import json
import runpy
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import main as jcli
import path_tracing__ray_tracer_tpu_torch as pt
from path_tracing__ray_tracer_tpu_torch import main as tcli
from path_tracing__ray_tracer_tpu_torch.parallel.progressive import load_state, render_progressive
from path_tracing__ray_tracer_tpu_torch.utils import backend, debug
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parser_has_every_jax_action_with_its_default():
    jax_actions, port_actions = _actions(jcli.build_parser()), _actions(tcli.build_parser())
    assert set(port_actions) == set(jax_actions)
    resolve = pt.RendererFactory.resolve
    for dest, ja in jax_actions.items():
        ta = port_actions[dest]
        assert ta.option_strings == ja.option_strings, dest
        assert (ta.type, ta.nargs, ta.metavar, ta.const) == (ja.type, ja.nargs, ja.metavar,
                                                             ja.const), dest
        if dest == "renderer":
            assert (ta.default, resolve(ja.default)) == ("cuda_texture_raytracer",) * 2
            assert set(ta.choices) == set(ja.choices)
        else:
            assert ta.default == ja.default, dest
            assert ta.choices == ja.choices, dest


def test_short_flags():
    args = tcli.build_parser().parse_args(
        ["-r", "tpu_path_raytracer", "-w", "64", "-s", "4", "-d", "2", "-o", "x.png"])
    assert (args.renderer, args.width, args.samples, args.depth, args.output) == (
        "tpu_path_raytracer", 64, 4, 2, "x.png")


def _render(name, settings, **kw):
    r = pt.RendererFactory.create(name, seed=0, texture_budget=0, device="cpu", **kw)
    b = pt.CustomSceneBuilder()
    return r, b.build_scene(), b.create_camera(settings.width / settings.height)


def test_cli_path_tracer_png_is_the_render(tmp_path, capsys):
    out = tmp_path / "pt.png"
    rc = tcli.main(["-r", "tpu_path_raytracer", "-w", "16", "--height", "12",
                    "--path-samples", "2", "-d", "2", "-o", str(out), "--no-show"], device="cpu")
    assert rc == 0
    s = pt.RenderSettings(16, 12, 2, 2)
    r, scene, cam = _render("cuda_path_raytracer", s, chunk_rays=1 << 24)
    np.testing.assert_array_equal(np.asarray(Image.open(out)),
                                  np.asarray(r.render(scene, cam, s)))
    text = capsys.readouterr().out
    for line in ("Path tracer mode: 2 spp", "Backend: cpu", f"Saved: {out}", "Total time:",
                 "rays/sec", "Render quality: Global Illumination (highest)"):
        assert line in text


def test_cli_whitted_default_png_is_the_render(tmp_path, capsys):
    out = tmp_path / "wh.png"
    rc = tcli.main(["-w", "16", "--height", "12", "-s", "1", "-d", "2", "--shadow-tmax", "light",
                    "-o", str(out), "--no-show"], device="cpu")
    assert rc == 0
    s = pt.RenderSettings(16, 12, 1, 2)
    r, scene, cam = _render("cuda_texture_raytracer", s, chunk_rays=1 << 21)
    np.testing.assert_array_equal(np.asarray(Image.open(out)),
                                  np.asarray(r.render(scene, cam, s)))
    text = capsys.readouterr().out
    assert "Ray tracer mode: 1 spp" in text
    assert "Warning: --shadow-tmax light only applies to the path tracer" in text
    assert "Render quality: Whitted ray tracing + textures (high)" in text


def test_cli_progressive_with_checkpoint(tmp_path, capsys):
    out, ckpt = tmp_path / "pp.png", str(tmp_path / "acc.npz")
    argv = ["-r", "cuda_path_raytracer", "-w", "16", "--height", "12", "--path-samples", "4",
            "-d", "2", "--progressive", "2", "--checkpoint", ckpt, "-o", str(out), "--no-show"]
    assert tcli.main(argv, device="cpu") == 0
    s = pt.RenderSettings(16, 12, 4, 2)
    r, scene, cam = _render("cuda_path_raytracer", s, chunk_rays=1 << 24)
    want = np.asarray(render_progressive(r, scene, cam, s, batch_spp=2))
    np.testing.assert_array_equal(np.asarray(Image.open(out)), want)
    from path_tracing__ray_tracer_tpu_torch.parallel.progressive import _fingerprint

    sums, done = load_state(ckpt, _fingerprint(s, 0))
    assert done == 4 and sums.shape == (16 * 12, 3)


def test_cli_trace_dir_writes_a_chrome_trace(tmp_path):
    trace = tmp_path / "trace"
    assert tcli.main(["-r", "cuda_raytracer", "-w", "16", "--height", "12", "-s", "1", "-d", "1",
                      "-o", str(tmp_path / "t.png"), "--no-show", "--trace-dir", str(trace)],
                     device="cpu") == 0
    (path,) = trace.glob("trace_*.json")
    assert json.loads(path.read_text())["traceEvents"]


def test_devices_above_one_raise(monkeypatch):
    """``--devices N`` on the card takes a mesh of N cards: with fewer (none
    here) it raises, also through ``python -m``, and renders nothing on the
    CPU instead.  ``tests/test_torch_sharding.py`` renders a CPU mesh."""
    too_many = torch.cuda.device_count() + 1
    with pytest.raises((RuntimeError, ValueError), match="CUDA device|devices, have"):
        tcli.main(["--devices", str(too_many)])
    monkeypatch.setattr(sys, "argv", ["python -m", "--devices", str(too_many + 2)])
    with pytest.raises((RuntimeError, ValueError), match="CUDA device|devices, have"):
        runpy.run_module("path_tracing__ray_tracer_tpu_torch", run_name="__main__")


def test_probe_backend_needs_a_card_unless_asked_for_the_cpu():
    assert backend.probe_backend("cpu") == "cpu"
    if torch.cuda.is_available():
        assert backend.probe_backend("cuda") == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            backend.probe_backend("cuda")


def test_debug_helpers_raise_on_an_injected_nan(monkeypatch):
    img = np.ones((4, 4, 3), np.float32)
    assert debug.assert_finite_image(img) is not None
    img[2, 1, 0] = np.nan
    with pytest.raises(FloatingPointError, match="1 non-finite"):
        debug.assert_finite_image(img, "frame")

    b = pt.CustomSceneBuilder()
    scene, cam = b.build_scene(), b.create_camera(1.0)
    s = pt.RenderSettings(48, 48, 1, 1)  # 3 chunks of 1,024 pixels
    r = pt.RendererFactory.create("cuda_raytracer", chunk_rays=1024, device="cpu")
    real = type(r)._chunk

    def poisoned(self, cs, cam12, sums, pix0, *a, **kw):
        real(self, cs, cam12, sums, pix0, *a, **kw)
        if pix0 == 1024:
            sums[1, pix0 + 5] = float("nan")

    monkeypatch.setattr(type(r), "_chunk", poisoned)
    assert not np.isfinite(r.render_sums(scene, cam, s)).all()  # unchecked outside the scope
    with debug.debug_nans(), pytest.raises(FloatingPointError, match=r"chunk 1 \(pixels 1024-"):
        r.render_sums(scene, cam, s)
    assert not debug.nans_checked()
    with debug.debug_nans(False):
        r.render_sums(scene, cam, s)
