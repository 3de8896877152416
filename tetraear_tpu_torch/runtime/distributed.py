"""Multi-process initialization and the host mesh
(tetraear_tpu/runtime/distributed.py).

One process with several cards needs nothing from this module: a mesh
names each card (runtime.sharding.make_mesh), and the shards of one
process exchange their halos as tensor copies.  Several processes (one a
host, or one a card) additionally need a ``torch.distributed`` process
group, so that halos travel by send / receive and the statistics by
all-reduce; this module starts it and lays the mesh out over it.

How the mesh maps onto hosts: the ``carrier`` axis is communication-free,
so it runs across processes (no traffic in steady state); the ``time``
axis exchanges one halo per segment with the left neighbour, so it stays
inside a process, where the halo is a copy between its cards.
``make_host_mesh`` builds exactly this layout.  The only collective left
across processes is the sum of the sync statistics (and the gather of the
results, so that every process returns the whole output).

Environment contract: ``TETRAEAR_COORDINATOR`` (host:port of process 0),
``TETRAEAR_NUM_PROCESSES`` and ``TETRAEAR_PROCESS_ID``.  The backend is
NCCL when the process's device is a card, gloo on the CPU.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from tetraear_tpu_torch.device import resolve
from tetraear_tpu_torch.runtime.sharding import Mesh, visible_devices

logger = logging.getLogger(__name__)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device=None) -> bool:
    """Start the ``torch.distributed`` process group for multi-process
    meshes.

    Arguments default to the TETRAEAR_* environment variables; with
    neither a coordinator nor a process count given, this is a no-op and
    the process stays alone (False).  The JAX package also joins a Cloud
    TPU pod from its metadata with no variable set; there is no such
    metadata for GPU hosts, so nothing here reads any.  ``device`` (None:
    the card) picks the backend: NCCL for a card, gloo for the CPU; a
    card named with an index becomes the process's current device.
    Returns True when the group is (already or newly) up; a second call
    is a no-op."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    coordinator = coordinator or os.environ.get("TETRAEAR_COORDINATOR")
    num_processes = num_processes if num_processes is not None else \
        _int_env("TETRAEAR_NUM_PROCESSES")
    process_id = process_id if process_id is not None else \
        _int_env("TETRAEAR_PROCESS_ID")
    if coordinator is None and num_processes is None:
        return False
    if coordinator is None:
        raise ValueError("TETRAEAR_COORDINATOR (host:port of process 0) "
                         "is needed with TETRAEAR_NUM_PROCESSES")
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=1 if num_processes is None else num_processes,
        rank=0 if process_id is None else process_id)
    logger.info("torch.distributed initialized (%s): process %d/%d via %s",
                backend, dist.get_rank(), dist.get_world_size(), coordinator)
    return True


def _int_env(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v else None


def _process_count() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_host_mesh(carriers_per_host: int = 1, devices=None,
                   n_processes: int | None = None) -> Mesh:
    """Mesh laid out so that the time axis stays inside one process (see
    the module docstring).

    ``devices`` are this process's own (default: every visible card);
    every process of the group (``n_processes``, default its size) is
    taken to hold as many.  The global device order is process-major;
    it is reshaped to (n_processes * carriers_per_host, n_local //
    carriers_per_host), so each time row lies inside one process and the
    carrier rows go across processes.  Works identically in one process
    (a virtual mesh when ``devices`` repeats one)."""
    local = visible_devices() if devices is None else [
        resolve(d) for d in devices]
    n_proc = _process_count() if n_processes is None else int(n_processes)
    n_local = len(local)
    t_local = max(1, n_local // max(1, carriers_per_host))
    rows_per_proc = n_local // t_local
    n_c = n_proc * rows_per_proc
    dev = np.empty((n_c, t_local), dtype=object)
    ranks = np.zeros((n_c, t_local), np.int64)
    for r in range(n_proc):
        for j in range(rows_per_proc):
            for t in range(t_local):
                dev[r * rows_per_proc + j, t] = local[j * t_local + t]
                ranks[r * rows_per_proc + j, t] = r
    return Mesh(dev, ("carrier", "time"), ranks)
