"""One spawned worker process per entry of a device mesh: the entries of a
chunk call render at once, as the JAX package's ``shard_map`` runs one
program on every device at once.

The renderers' host work is a long run of small torch ops (the paths are
host-bound), so entries driven in turn from one thread do not overlap, and
threads of one process convoy on the interpreter lock.  Each entry of a mesh
of more than one therefore renders in a process of its own:

* **Lifetime.**  ``DeviceMesh.workers()`` gives the mesh's
  :class:`MeshWorkers`.  Its processes start at the first chunk call, from a
  ``spawn`` context, one per entry (also where entries repeat a device), and
  serve every later call on the mesh: each ``device_sums``, progressive
  batch and renderer that uses it.  ``DeviceMesh.close()`` stops them (a
  later call starts new ones), and so does the mesh's collection or the
  interpreter's exit (``weakref.finalize``).  A worker whose parent is gone
  reads end-of-file on its pipe and exits.  A worker for a CUDA entry makes
  that card current before anything else; every worker takes the parent's
  intra-op thread count.
* **What crosses.**  Once per compiled scene and worker, the
  ``CompiledScene``: CUDA tensors by ``torch.multiprocessing``'s IPC handles,
  CPU tensors by shared memory (the parent keeps each scene it sent alive
  until the workers stop).  With each chunk: the renderer's settings
  (``WavefrontRenderer.settings``), the knobs of :data:`KNOBS`, the packed
  camera, the chunk's arguments and, for entry ``(ti, 0)``, a host copy of
  its tile block.  Back: the entry's ``(3, n_pix)`` block (a host copy), its
  kernels' launch counts (added onto the parent's wrappers), its CUDA graph
  captures and their seconds (``ops/cuda.CAPTURES``; a worker
  captures and keeps its own graphs, one cache per scene), its pid and its
  busy seconds.
* **Failure.**  A worker's exception is raised in the parent with the
  worker's traceback as its cause (:class:`WorkerTraceback`); a worker that
  dies raises :class:`WorkerError`, since every wait also watches the
  process, and the mesh's other workers are stopped.  Nothing is retried.

The parent compiles each device's scene (under its own module knobs) before
any worker starts its chunk, and builds the kernels before it starts the
workers of a CUDA mesh, so the workers only load them.
"""
from __future__ import annotations

import importlib
import os
import pickle
import sys
import time
import traceback
from multiprocessing.connection import wait
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.multiprocessing as mp  # registers the tensor reductions the pipes use

from ..ops.cuda import CAPTURES, add_launches, launch_counts

_PKG = __name__.rsplit(".", 2)[0]

# Module settings that the chunk code reads at each call: the path tracer's
# scheduling and pipe switches, the texture compaction, the BVH routes and
# tree staging, the atlas route.  A worker imports its modules afresh and does
# not see the parent's assignments, so the parent's values go with every
# chunk.  The compile knobs (``ops/bvh``'s paging limits, ``compiler``'s BVH
# and table thresholds) are read where the scene compiles: in the parent.
KNOBS = {
    "models.path_tracer": ("_CHECK_EVERY", "_COMPACT_BELOW", "_BUCKET_MIN", "_PIPE_REGEN",
                           "_GRAPH_BLOCKS"),
    "ops.texture": ("TEX_COMPACT", "TEX_COMPACT_DIV"),
    "ops.cuda.bvh": ("BVH_QUAD", "BVH_ORDERED", "BVH_ATTRS", "BVH_MULTIPASS", "_MP_MIN_DEPTH4",
                     "BVH_MXU_LEAF", "SMEM_TREE_BYTES"),
    "ops.cuda.texture": ("ENABLED", "MAX_ROWS", "MIP_MAX_ROWS"),
}

_STOP_SECONDS = 10.0  # a stopping worker's grace before it is terminated


def knob_values() -> Dict[str, tuple]:
    """The current value of every knob of :data:`KNOBS`, by module."""
    return {mod: tuple(getattr(importlib.import_module(f"{_PKG}.{mod}"), n) for n in names)
            for mod, names in KNOBS.items()}


def _set_knobs(values: Dict[str, tuple]) -> None:
    for mod, vals in values.items():
        m = importlib.import_module(f"{_PKG}.{mod}")
        for name, value in zip(KNOBS[mod], vals):
            setattr(m, name, value)


class WorkerError(RuntimeError):
    """A mesh worker died, or its exception could not be rebuilt here."""


class WorkerTraceback(Exception):
    """The traceback text of an exception raised in a mesh worker: the cause
    of the exception raised again in the parent."""


class Job(NamedTuple):
    """One entry's part of a chunk call (``WavefrontRenderer._chunk``'s
    arguments, ``col0 = 0``)."""

    scene: int  # token of the compiled scene
    cs: object  # the CompiledScene the first time the worker gets ``scene``, else None
    renderer_cls: type
    settings: dict  # ``WavefrontRenderer.settings()``
    knobs: Dict[str, tuple]  # knob_values()
    cam12: np.ndarray
    pix0: int
    sample_base: int
    seed: int
    kw: dict  # n_pix, width, height, n_samples, max_depth, spp
    block: Optional[np.ndarray]  # the tile block's sums to continue (entry (ti, 0)); None: zeros


class Result(NamedTuple):
    block: np.ndarray  # (3, n_pix) float32
    launches: Dict[str, int]  # kernel launches of this chunk, by wrapper
    captures: tuple  # graph captures of this chunk and their host seconds
    pid: int
    busy: float  # seconds from the job's arrival to its block on the host


class _Served:
    """A worker's state: its device and the compiled scenes it was sent (with
    the kernels' tables and the path tracer's graph cache of each, made
    once)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.scenes: Dict[int, object] = {}
        self.blobs: Dict[int, dict] = {}
        self.graphs: Dict[int, dict] = {}

    def chunk(self, job: Job) -> Result:
        t0 = time.perf_counter()
        if job.cs is not None:
            self.scenes[job.scene] = job.cs
        dev = self.device
        _set_knobs(job.knobs)
        r = job.renderer_cls.twin(job.settings, dev, self.blobs.setdefault(job.scene, {}),
                                  self.graphs.setdefault(job.scene, {}))
        if job.block is None:
            out = torch.zeros((3, job.kw["n_pix"]), dtype=torch.float32, device=dev)
        else:
            out = torch.from_numpy(job.block).to(dev)
        before, captured = launch_counts(), dict(CAPTURES)
        r._chunk(self.scenes[job.scene], torch.from_numpy(job.cam12).to(dev), out, job.pix0,
                 job.seed, job.sample_base, col0=0, **job.kw)
        block = out.cpu().numpy()  # waits for the device
        launches = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
        captures = (CAPTURES["count"] - captured["count"], CAPTURES["seconds"] - captured["seconds"])
        return Result(block, launches, captures, os.getpid(), time.perf_counter() - t0)

    def echo(self, block: np.ndarray) -> np.ndarray:
        """``block`` to the device and back: the transport of a chunk's block."""
        return torch.from_numpy(block).to(self.device).cpu().numpy()

    def status(self, _=None) -> dict:
        return {"pid": os.getpid(), "device": str(self.device),
                "threads": torch.get_num_threads(), "modules": sorted(sys.modules),
                "wrappers": sorted(launch_counts()), "knobs": knob_values()}


def _failure():
    """The reply to an exception: the exception pickled (None when it does
    not pickle) and its traceback text."""
    exc = sys.exc_info()[1]
    try:
        data = pickle.dumps(exc)
    except Exception:
        data = None
    return "err", (data, f"{type(exc).__name__}: {exc}", traceback.format_exc())


def _serve(conn, device: str, threads: int) -> None:
    """A worker's loop: one reply for each ``(op, argument)`` message, until
    ``None`` or the parent's end of the pipe closes."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.set_num_threads(threads)
    served = _Served(dev)
    while True:
        try:
            msg = conn.recv()
        except EOFError:  # the parent is gone
            return
        except Exception:  # a message that does not unpickle here
            reply = _failure()
        else:
            if msg is None:
                return
            op, arg = msg
            try:
                reply = "ok", getattr(served, op)(arg)
            except Exception:  # raised again in the parent
                reply = _failure()
        try:
            conn.send(reply)
        except OSError:  # the parent is gone
            return


class _Worker:
    """One entry's process and the parent's end of its pipe."""

    def __init__(self, ctx, index: int, device: torch.device, threads: int):
        self.label = f"mesh entry {index} on {device}"
        self.conn, child = ctx.Pipe()
        self.process = ctx.Process(target=_serve, args=(child, str(device), threads),
                                   name=f"ptrt-mesh-entry-{index}", daemon=True)
        self.process.start()
        child.close()
        self.scenes = set()  # tokens of the scenes this worker holds

    def _gone(self) -> WorkerError:
        self.process.join(1.0)
        return WorkerError(f"{self.label} (pid {self.process.pid}) died: exit code "
                           f"{self.process.exitcode}")

    def send(self, msg) -> None:
        try:
            self.conn.send(msg)
        except OSError as e:  # a broken pipe: the process is gone
            raise self._gone() from e

    def recv(self):
        wait([self.conn, self.process.sentinel])  # a reply, or the process's end
        try:
            return self.conn.recv()  # a reply sent before an exit is still read
        except (EOFError, OSError) as e:
            raise self._gone() from e

    def stop(self) -> None:
        try:
            self.conn.send(None)
        except OSError:
            pass

    def join(self) -> None:
        self.process.join(_STOP_SECONDS)
        if self.process.is_alive():
            self.process.terminate()
            self.process.join(_STOP_SECONDS)
        self.conn.close()


class MeshWorkers:
    """The worker processes of a mesh, one per entry (tile-major, the order of
    ``DeviceMesh.entries``), started at the first call and stopped by
    :meth:`close`.  ``stats`` sums, since :meth:`reset_stats`, the calls, their
    wall seconds in the parent, each entry's busy seconds and pid, and the
    entries' graph captures and their seconds."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = [torch.device(d) for d in devices]
        self._workers: Optional[List[_Worker]] = None
        self._scenes: Dict[int, tuple] = {}  # id(cs) -> (token, cs): each sent scene kept alive
        self.reset_stats()

    def reset_stats(self) -> None:
        n = len(self.devices)
        self.stats = {"calls": 0, "wall": 0.0, "busy": [0.0] * n, "pids": [None] * n,
                      "captures": 0, "capture_s": 0.0}

    @property
    def processes(self) -> list:
        """The live workers' processes (none before the first call or after
        :meth:`close`)."""
        return [w.process for w in self._workers or ()]

    def _start(self) -> List[_Worker]:
        if self._workers is None:
            if any(d.type == "cuda" for d in self.devices):
                from ..ops.cuda import build

                build.load_all()  # one nvcc per library here; the workers only load
            ctx = mp.get_context("spawn")
            threads = torch.get_num_threads()
            self._workers = [_Worker(ctx, i, d, threads) for i, d in enumerate(self.devices)]
        return self._workers

    def close(self) -> None:
        """Stop every worker (each gets ``None``, then at most
        ``_STOP_SECONDS`` before it is terminated) and release the scenes
        sent to them."""
        workers, self._workers = self._workers, None
        self._scenes = {}
        for w in workers or ():
            w.stop()
        for w in workers or ():
            w.join()

    def _call(self, msgs: Dict[int, tuple]) -> Dict[int, object]:
        """Send each entry ``i`` its message ``msgs[i]``, then wait for every
        reply; raise the first entry's exception, in entry order."""
        workers = self._start()
        try:
            for i, msg in msgs.items():
                workers[i].send(msg)
            replies = {i: workers[i].recv() for i in msgs}
        except BaseException:  # a worker died, or the wait was cut: the pipes are out of step
            self.close()
            raise
        for i, (status, value) in replies.items():
            if status == "err":
                data, line, tb = value
                try:
                    exc = pickle.loads(data)
                except Exception:  # not rebuilt here: keep its type's name and message
                    exc = WorkerError(line)
                raise exc from WorkerTraceback(f"{workers[i].label} (pid "
                                               f"{workers[i].process.pid}):\n{tb}")
        return {i: value for i, (_, value) in replies.items()}

    def _token(self, cs) -> int:
        if id(cs) not in self._scenes:
            self._scenes[id(cs)] = (len(self._scenes), cs)
        return self._scenes[id(cs)][0]

    def render(self, renderer, scenes: dict, cams: dict, seed: int, kw: dict, parts,
               sums: torch.Tensor) -> List[torch.Tensor]:
        """Render every part (``parallel/sharding.Part``) at once, each in
        its entry's worker with the renderer's ``_chunk`` on ``scenes[device]``
        and ``cams[device]``; return each part's ``(3, kw["n_pix"])`` block on
        ``sums.device``: entry ``(ti, 0)``'s continues the fold of its tile
        block of ``sums``, the others start from zeros."""
        t0 = time.perf_counter()
        workers = self._start()
        n_pix = kw["n_pix"]
        knobs, settings = knob_values(), renderer.settings()
        cams = {dev: cam.cpu().numpy() for dev, cam in cams.items()}
        msgs = {}
        for p in parts:
            token = self._token(scenes[p.device])
            block = sums[:, p.pix0:p.pix0 + n_pix].cpu().numpy() if p.si == 0 else None
            msgs[p.entry] = ("chunk", Job(
                token, None if token in workers[p.entry].scenes else scenes[p.device],
                type(renderer), settings, knobs, cams[p.device], p.pix0, p.sample_base, seed,
                dict(kw, n_samples=p.n_samples), block))
        results = self._call(msgs)
        out = []
        for p in parts:
            res = results[p.entry]
            workers[p.entry].scenes.add(msgs[p.entry][1].scene)
            add_launches(res.launches)
            self.stats["captures"] += res.captures[0]
            self.stats["capture_s"] += res.captures[1]
            self.stats["busy"][p.entry] += res.busy
            self.stats["pids"][p.entry] = res.pid
            out.append(torch.from_numpy(res.block).to(sums.device))
        self.stats["calls"] += 1
        self.stats["wall"] += time.perf_counter() - t0
        return out

    def status(self) -> List[dict]:
        """Each worker's pid, device, thread count, imported modules, the
        wrapper counters it sees and its knob values (the last chunk's)."""
        replies = self._call({i: ("status", None) for i in range(len(self.devices))})
        return [replies[i] for i in range(len(self.devices))]

    def echo(self, block: np.ndarray) -> float:
        """Seconds of one call that sends ``block`` to every worker, which
        moves it to its device and back and returns it: the transport cost of
        a chunk call's blocks."""
        self._start()
        t0 = time.perf_counter()
        replies = self._call({i: ("echo", block) for i in range(len(self.devices))})
        secs = time.perf_counter() - t0
        if not all(np.array_equal(r, block) for r in replies.values()):
            raise WorkerError("echo: a block came back changed")
        return secs
