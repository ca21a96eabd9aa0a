"""Device meshes, and a small SPMD launcher for the mesh engine.

The port of :mod:`repro.launch.mesh`.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dimensions over the
ranks of a ``torch.distributed`` world; building one is a collective, so
every rank calls the same constructor.

* :func:`make_production_mesh` — the reference's production shapes,
  ``(data, model) = (16, 16)`` or ``(pod, data, model) = (2, 16, 16)``
  (:data:`PRODUCTION_MESHES`), in a world of that many ranks.
* :func:`make_local_mesh` — a small ``(data, model)`` mesh over the
  current world (tests, examples, the smoke run).
* :func:`spawn` — start ``nprocs`` ranks of a new world on this host, run a
  function on each and return what each returned.  The rendezvous is a
  ``FileStore`` in a fresh temporary directory (no TCP port, so launches in
  parallel processes cannot collide), and the world's backend follows from
  its layout (:func:`world_backend`), fixed when the world starts.

    from repro_torch.launch import mesh as M

    def job(rank):
        m = M.make_local_mesh(model=4)
        ...                                # every rank runs the same code
        return result                      # picklable: numbers, NumPy

    results = M.spawn(job, 4, device_type="cpu")   # results[rank]
"""
from __future__ import annotations

import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

__all__ = ["PRODUCTION_MESHES", "make_production_mesh", "make_local_mesh",
           "world_backend", "spawn"]

#: The reference's production meshes: (shape, dimension names).
PRODUCTION_MESHES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}

def world_backend(device_type: str, nprocs: int) -> str:
    """The process-group backend of a world of ``nprocs`` ranks on this
    host: NCCL where every rank has a GPU of its own, gloo on the CPU and
    where ranks share a GPU (NCCL refuses two ranks on one device; the mesh
    engine then stages its collectives through host tensors,
    :func:`repro_torch.core.distributed.transport`)."""
    if device_type == "cpu":
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"device_type must be 'cpu' or 'cuda', got "
                         f"{device_type!r}")
    return "nccl" if nprocs <= torch.cuda.device_count() else "gloo"


def _device_type(device_type: Optional[str]) -> str:
    if device_type is not None:
        return device_type
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """The reference's production mesh (:data:`PRODUCTION_MESHES`) over a
    world of 256 (512) ranks; ``device_type`` defaults to the GPU where
    there is one."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = PRODUCTION_MESHES[multi_pod]
    return init_device_mesh(_device_type(device_type), shape,
                            mesh_dim_names=names)


def make_local_mesh(model: int = 1, data: Optional[int] = None, *,
                    device_type: Optional[str] = None):
    """A ``(data, model)`` mesh over the current world; ``data`` defaults to
    the world size over ``model``, ``device_type`` to the GPU where there
    is one."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    data = data or max(1, n // model)
    return init_device_mesh(_device_type(device_type), (data, model),
                            mesh_dim_names=("data", "model"))


def _worker(fn, rank: int, world: int, store_path: str, device_type: str,
            backend: str, args: Sequence[Any], out, threads: Optional[int]):
    import torch.distributed as dist

    try:
        if threads:
            torch.set_num_threads(threads)
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world)
        result = fn(rank, *args)
        out.put((rank, True, result))
    except Exception:                      # reported to the launcher
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable[..., Any], nprocs: int, args: Sequence[Any] = (), *,
          device_type: str = "cpu", timeout: float = 600.0,
          threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(rank, *args)`` on ``nprocs`` new processes, the ranks of one
    world, and return their results in rank order.

    ``fn`` must be importable by name (a module-level function) and return
    a picklable value.  ``device_type`` ``"cuda"`` puts rank r on GPU
    ``r % device_count``; the backend is :func:`world_backend`'s.
    ``threads`` sets each rank's intra-op threads.  A rank that raises, or
    a world that outlives ``timeout`` seconds, stops every rank and raises
    ``RuntimeError`` with the first traceback; every process the call
    started has ended when it returns.
    """
    if nprocs < 1:
        raise ValueError(f"nprocs must be >= 1, got {nprocs}")
    backend = world_backend(device_type, nprocs)
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_world_")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_worker,
                         args=(fn, r, nprocs, store, device_type, backend,
                               tuple(args), out, threads), daemon=True)
             for r in range(nprocs)]
    results: dict = {}
    failure: Optional[Tuple[int, str]] = None
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(results) < nprocs and failure is None:
            try:
                rank, ok, value = out.get(
                    timeout=max(0.1, min(5.0, deadline - time.monotonic())))
            except queue.Empty:
                if time.monotonic() > deadline:
                    failure = (-1, f"the world of {nprocs} ranks did not "
                                   f"finish within {timeout} s")
                elif any(p.exitcode not in (None, 0) for p in procs):
                    failure = (-1, "a rank exited without a result: exit "
                                   "codes " + str([p.exitcode for p in procs]))
                continue
            if ok:
                results[rank] = value
            else:
                failure = (rank, value)
        if failure is None:
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.pid is None:            # never started
                continue
            if p.is_alive():
                p.kill()
            p.join()
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(f"rank {failure[0]} of {nprocs} failed:\n"
                           f"{failure[1]}")
    return [results[r] for r in range(nprocs)]
