"""The worker processes of the port's (tile × sample) split
(``parallel/workers.py``) on meshes of CPU entries.

* (2, 2) and (4, 2) meshes render each entry in a live process of its own:
  distinct pids, none the test's, each process importing neither JAX nor a
  test module and taking the caller's one intra-op thread; the workers serve
  every later call and renderer of the mesh.
* The sums equal, bit for bit, the serial composition that this file builds
  from the renderer's own ``_chunk`` calls in the split's order (the entries
  in turn; entry ``(ti, 0)`` continuing its tile's block in place, entries
  ``si > 0`` folding onto zeros, their partials added in ascending ``si``):
  the path tracer (two samples an entry; a clipped group of 3) and the
  Whitted texture renderer (9 cells split 5 + 4).
* A worker's exception is raised in the caller with the worker's traceback
  as its cause, and the worker serves the next call; a knob the parent set
  (``_CHECK_EVERY``) reaches the worker, and so do the BVH route globals
  (``_MP_MIN_DEPTH4`` with them) and ``_GRAPH_BLOCKS``.  A killed worker raises
  ``WorkerError``, and the mesh's other workers are stopped.
* After ``close()`` no worker is alive.  ``mesh=None`` and a one-entry mesh
  start no process.
* The workers see the parent's kernel wrappers, whose launch counts they send
  back (``ops/cuda.launch_counts`` / ``add_launches``), and their spans and
  counters come back onto the parent's record (``utils/profiling.record``)
  as ``worker.<name>``: one ``worker.drive`` an entry of a chunk call, its
  blocks' ``worker.block.wait`` and ``worker.block.host``, none under the
  parent's own names.
"""
import multiprocessing
import os
import signal

import numpy as np
import pytest
import torch

import path_tracing__ray_tracer_tpu_torch as pt
from path_tracing__ray_tracer_tpu_torch.compiler import pack_camera
from path_tracing__ray_tracer_tpu_torch.models import path_tracer as tpath
from path_tracing__ray_tracer_tpu_torch.ops.cuda import add_launches, launch_counts
from path_tracing__ray_tracer_tpu_torch.parallel.mesh import make_mesh, mesh_shape
from path_tracing__ray_tracer_tpu_torch.ops.cuda import bvh as tbvh
from path_tracing__ray_tracer_tpu_torch.parallel.workers import (
    KNOBS, WorkerError, WorkerTraceback, knob_values)
from path_tracing__ray_tracer_tpu_torch.utils.profiling import record
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")


def cpu_mesh(n, sample_parallel):
    return make_mesh(n, sample_parallel=sample_parallel, devices=[CPU] * n)


@pytest.fixture(scope="module")
def cornell():
    b = pt.CustomSceneBuilder()
    return b.build_scene(), b.create_camera(4.0 / 3.0)


@pytest.fixture(scope="module")
def mesh22(one_torch_thread):
    mesh = cpu_mesh(4, 2)
    yield mesh
    mesh.close()


@pytest.fixture(scope="module")
def mesh42(one_torch_thread):
    mesh = cpu_mesh(8, 2)
    yield mesh
    mesh.close()


def serial_sums(r, scene, cam, settings, n_samples):
    """The split's sums with every entry's ``_chunk`` called in turn here:
    ``n_samples`` samples from 0 on, ``r``'s chunk plan over its mesh."""
    w, h, spp = settings.width, settings.height, settings.samples_per_pixel
    n_pix, group = r._plan(w, h, spp, settings.max_depth)
    tile, samp = mesh_shape(r.mesh)
    local_pix, local_samples = n_pix // tile, -(-group // samp)
    cs, cam12, seed = r.compiled(scene), pack_camera(cam, CPU), r._run_seed()
    kw = dict(n_pix=local_pix, width=w, height=h, max_depth=settings.max_depth, spp=spp)
    sums = torch.zeros((3, -(-w * h // n_pix) * n_pix), dtype=torch.float32)
    for pix0 in range(0, w * h, n_pix):
        for base in range(0, n_samples, group):
            end = base + min(group, n_samples - base)
            for ti, si, _ in r.mesh.entries():
                s0 = base + si * local_samples
                n = min(local_samples, end - s0)
                if n <= 0:
                    continue
                p0 = pix0 + ti * local_pix
                if si == 0:
                    r._chunk(cs, cam12, sums, p0, seed, s0, n_samples=n, col0=p0, **kw)
                else:
                    part = torch.zeros((3, local_pix), dtype=torch.float32)
                    r._chunk(cs, cam12, part, p0, seed, s0, n_samples=n, col0=0, **kw)
                    sums[:, p0:p0 + local_pix] += part
    return sums[:, :w * h].T.numpy()


def alive_pids(mesh):
    """The pids the workers reported with their blocks, checked against the
    live processes of the mesh."""
    ws = mesh.workers()
    procs = ws.processes
    assert len(procs) == len(ws.devices) and all(p.is_alive() for p in procs)
    assert ws.stats["pids"] == [p.pid for p in procs]
    return ws.stats["pids"]


@pytest.mark.parametrize("which", ["mesh22", "mesh42"])
def test_each_entry_renders_in_a_live_process_of_its_own(cornell, which, request):
    mesh = request.getfixturevalue(which)
    scene, cam = cornell
    s = pt.RenderSettings(width=32, height=24, samples_per_pixel=2, max_depth=2)
    r = pt.RendererFactory.create("cuda_path_raytracer", mesh=mesh, seed=3, sample_group=2)
    before = record()
    r.render_sums(scene, cam, s)
    after = record()
    d = {k: after.get(k, (0, 0))[0] - before.get(k, (0, 0))[0]
         for k in ("chunk", "drive", "worker.drive", "worker.block.wait", "worker.block.host",
                   "worker.lanes.live", "worker.lanes.slots")}
    n = len(list(mesh.entries()))  # one drive an entry, added onto this process's record
    # the entries' drives ran at once inside the parent's chunk: kept apart from its own spans
    assert d["chunk"] == 1 and d["drive"] == 0 and d["worker.drive"] == n
    assert d["worker.block.wait"] == d["worker.block.host"] + n and d["worker.block.host"] > 0
    assert 0 < d["worker.lanes.live"] <= d["worker.lanes.slots"]
    pids = alive_pids(mesh)
    assert len(set(pids)) == len(list(mesh.entries())) and os.getpid() not in pids
    # a second renderer on the mesh: the same processes serve it
    pt.RendererFactory.create("cuda_raytracer", mesh=mesh, seed=1).render_sums(
        scene, cam, pt.RenderSettings(width=32, height=24, samples_per_pixel=4, max_depth=2))
    assert alive_pids(mesh) == pids
    for st in mesh.workers().status():
        assert st["pid"] in pids and st["device"] == "cpu" and st["threads"] == 1
        foreign = [m for m in st["modules"] if m.split(".")[0] in (
            "jax", "jaxlib", "path_tracing__ray_tracer_tpu", "conftest", "torch_threads")
            or m.startswith("test_")]
        assert foreign == []


@pytest.mark.parametrize("name,spp,group", [
    ("cuda_path_raytracer", 4, 4),  # two samples an entry: the partials fold apart, then add
    ("cuda_path_raytracer", 3, 3),  # the second sample entry gets one sample of the group
    ("cuda_texture_raytracer", 9, None),  # 9 grid cells, 5 + 4
])
def test_sums_are_the_serial_composition_bit_for_bit(cornell, mesh22, mesh42, name, spp, group):
    scene, cam = cornell
    s = pt.RenderSettings(width=48, height=36, samples_per_pixel=spp, max_depth=2)
    kw = dict(seed=7, chunk_rays=1 << 12)
    if group:
        kw["sample_group"] = group
    for mesh in (mesh22, mesh42):
        r = pt.RendererFactory.create(name, mesh=mesh, **kw)
        got = r.render_sums(scene, cam, s)
        n_samples = spp if group else 9
        np.testing.assert_array_equal(got, serial_sums(r, scene, cam, s, n_samples))
        assert float(got.mean()) > 0.01


def test_worker_exception_is_raised_in_the_caller(cornell, mesh22, monkeypatch):
    """``_CHECK_EVERY = 0`` reaches the workers with the job, whose
    scheduler divides by it; the caller gets the ``ZeroDivisionError`` with
    the worker's traceback, and the workers serve the next call."""
    scene, cam = cornell
    s = pt.RenderSettings(width=32, height=24, samples_per_pixel=2, max_depth=2)
    r = pt.RendererFactory.create("cuda_path_raytracer", mesh=mesh22, seed=5, sample_group=2)
    first = r.render_sums(scene, cam, s)
    pids = alive_pids(mesh22)
    monkeypatch.setattr(tpath, "_CHECK_EVERY", 0)
    with pytest.raises(ZeroDivisionError) as info:
        r.render_sums(scene, cam, s)
    cause = info.value.__cause__
    assert isinstance(cause, WorkerTraceback)
    assert "mesh entry 0 on cpu" in str(cause) and "_regen_loop" in str(cause)
    monkeypatch.undo()
    np.testing.assert_array_equal(r.render_sums(scene, cam, s), first)
    assert alive_pids(mesh22) == pids
    one = pt.RendererFactory.create("cuda_path_raytracer", device="cpu", seed=5,
                                    sample_group=2).render_sums(scene, cam, s)
    np.testing.assert_array_equal(first, one)  # one sample an entry: one device's bits


def test_workers_read_the_callers_route_knobs(cornell, mesh22, monkeypatch):
    """The route globals of ``ops/cuda/bvh`` (``_MP_MIN_DEPTH4`` among them)
    and ``_GRAPH_BLOCKS``, each set by the caller to another value than its
    default, reach every worker with a chunk: each reports the caller's
    values, and the defaults again after the next chunk."""
    values = dict(BVH_QUAD=False, BVH_ORDERED=False, BVH_ATTRS=False, BVH_MULTIPASS=True,
                  _MP_MIN_DEPTH4=2, BVH_MXU_LEAF=True)
    scene, cam = cornell
    s = pt.RenderSettings(width=16, height=12, samples_per_pixel=2, max_depth=2)
    r = pt.RendererFactory.create("cuda_path_raytracer", mesh=mesh22, seed=5, sample_group=2)
    defaults = knob_values()
    for name, value in values.items():
        assert getattr(tbvh, name) != value
        monkeypatch.setattr(tbvh, name, value)
    assert tpath._GRAPH_BLOCKS
    monkeypatch.setattr(tpath, "_GRAPH_BLOCKS", False)
    r.render_sums(scene, cam, s)
    mine = knob_values()
    assert mine["ops.cuda.bvh"] != defaults["ops.cuda.bvh"]
    for st in mesh22.workers().status():
        assert st["knobs"] == mine
        got = dict(zip(KNOBS["ops.cuda.bvh"], st["knobs"]["ops.cuda.bvh"]))
        assert {k: got[k] for k in values} == values
        assert dict(zip(KNOBS["models.path_tracer"],
                        st["knobs"]["models.path_tracer"]))["_GRAPH_BLOCKS"] is False
    monkeypatch.undo()
    r.render_sums(scene, cam, s)
    assert all(st["knobs"] == defaults for st in mesh22.workers().status())


def test_dead_worker_raises_and_stops_the_others(cornell):
    scene, cam = cornell
    s = pt.RenderSettings(width=32, height=24, samples_per_pixel=2, max_depth=2)
    mesh = cpu_mesh(2, 1)
    r = pt.RendererFactory.create("cuda_path_raytracer", mesh=mesh, seed=5, sample_group=2)
    first = r.render_sums(scene, cam, s)
    procs = mesh.workers().processes
    os.kill(procs[1].pid, signal.SIGKILL)
    procs[1].join(10)
    with pytest.raises(WorkerError, match="mesh entry 1 on cpu .* died"):
        r.render_sums(scene, cam, s)
    for p in procs:
        p.join(20)
        assert not p.is_alive()
    assert mesh.workers().processes == []
    # a later render starts new workers
    np.testing.assert_array_equal(r.render_sums(scene, cam, s), first)
    mesh.close()


def test_close_stops_every_worker(cornell):
    scene, cam = cornell
    mesh = cpu_mesh(2, 2)
    pt.RendererFactory.create("cuda_path_raytracer", mesh=mesh, sample_group=2).render_sums(
        scene, cam, pt.RenderSettings(width=16, height=12, samples_per_pixel=2, max_depth=2))
    procs = mesh.workers().processes
    assert len(procs) == 2 and all(p.is_alive() for p in procs)
    mesh.close()
    assert all(not p.is_alive() and p.exitcode is not None for p in procs)
    assert mesh.workers().processes == []
    assert not set(p.pid for p in procs) & set(p.pid for p in multiprocessing.active_children())


@pytest.mark.parametrize("mesh", [None, "one"])
def test_nothing_to_split_starts_no_process(cornell, mesh):
    scene, cam = cornell
    s = pt.RenderSettings(width=32, height=24, samples_per_pixel=2, max_depth=2)
    kw = dict(mesh=cpu_mesh(1, 1)) if mesh else dict(device="cpu")
    before = {p.pid for p in multiprocessing.active_children()}
    r = pt.RendererFactory.create("cuda_path_raytracer", seed=2, sample_group=2, **kw)
    got = r.render_sums(scene, cam, s)
    assert {p.pid for p in multiprocessing.active_children()} <= before
    if mesh:
        assert r.mesh.workers().processes == []
    one = pt.RendererFactory.create("cuda_path_raytracer", device="cpu", seed=2,
                                    sample_group=2).render_sums(scene, cam, s)
    np.testing.assert_array_equal(got, one)


def test_workers_count_the_parent_wrappers(mesh22):
    want = sorted(launch_counts())
    assert len(want) == 23 and "bounce.path_bounce" in want
    for st in mesh22.workers().status():
        assert st["wrappers"] == want
    from path_tracing__ray_tracer_tpu_torch.ops.cuda import bounce

    before = bounce.path_bounce.launches
    add_launches({"bounce.path_bounce": 3})
    assert bounce.path_bounce.launches == before + 3
    add_launches({"bounce.path_bounce": -3})
    assert launch_counts()["bounce.path_bounce"] == before
