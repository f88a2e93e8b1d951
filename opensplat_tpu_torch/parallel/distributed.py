"""Multi-process bootstrap: torch.distributed from the JAX package's
environment variables, the rank's device, and a mesh over every rank.

Counterpart of opensplat_tpu/parallel/distributed.py. Every rank runs
THE SAME program with the same seeds (one process per rank), so all
agree on each step's camera batch, and each renders only its own rows
(`process_camera_slice`). Launch recipe (2 hosts, one card a rank):

    # host 0
    OPENSPLAT_COORDINATOR=10.0.0.1:9876 OPENSPLAT_NUM_PROCESSES=2 \\
    OPENSPLAT_PROCESS_ID=0 python -m opensplat_tpu_torch.cli ... --distributed
    # host 1
    OPENSPLAT_COORDINATOR=10.0.0.1:9876 OPENSPLAT_NUM_PROCESSES=2 \\
    OPENSPLAT_PROCESS_ID=1 python -m opensplat_tpu_torch.cli ... --distributed

On one host, `python -m opensplat_tpu_torch.parallel.launch -n N -- ...`
sets the variables for N processes (parallel/launch.py). The coordinator
is host:port (a TCP store served by rank 0) or any torch init URL such
as file:///tmp/store. The backend is NCCL on a card, with one card a
rank; ranks that share one card must use gloo (NCCL refuses two ranks on
one GPU): pass backend="gloo" or set OPENSPLAT_BACKEND=gloo. A failing
NCCL initialisation is an error; nothing falls back to gloo or the CPU.
"""
from __future__ import annotations

import atexit
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from .._device import resolve_device
from .mesh import Mesh, make_mesh


def rank_device(device="cuda") -> torch.device:
    """This rank's device: the CPU, or card (rank mod the host's card
    count); ranks are laid out host-major, one card each where the host
    has as many."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def initialize_from_env(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
    timeout_s: float = 1800.0,
) -> bool:
    """Join this process to the training fleet.

    Arguments default to OPENSPLAT_COORDINATOR / OPENSPLAT_NUM_PROCESSES
    / OPENSPLAT_PROCESS_ID / OPENSPLAT_BACKEND; the backend defaults to
    NCCL when `device` is a card and gloo on the CPU. Without a
    coordinator there is no cluster: returns False and starts nothing
    (a single-process run). Returns True when more than one process
    joined. On a card the rank's device (`rank_device`) becomes current.
    The group is destroyed when the process exits, if the caller has not
    destroyed it: a process that exits with a live gloo group can abort
    in the group's threads at interpreter shutdown."""
    coordinator = coordinator or os.environ.get("OPENSPLAT_COORDINATOR")
    if not coordinator:
        return False
    if num_processes is None:
        num_processes = int(os.environ.get("OPENSPLAT_NUM_PROCESSES", 0))
    if process_id is None:
        process_id = int(os.environ.get("OPENSPLAT_PROCESS_ID", -1))
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(
            f"initialize_from_env: coordinator {coordinator!r} needs "
            f"OPENSPLAT_NUM_PROCESSES >= 1 and 0 <= OPENSPLAT_PROCESS_ID < "
            f"it (got {num_processes}, {process_id})")
    dev = resolve_device(device)
    backend = (backend or os.environ.get("OPENSPLAT_BACKEND")
               or ("nccl" if dev.type == "cuda" else "gloo"))
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"initialize_from_env: backend {backend!r} "
                         "(nccl or gloo)")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("initialize_from_env: NCCL needs a card")
    if dev.type == "cuda":
        torch.cuda.set_device(torch.device(
            "cuda", process_id % torch.cuda.device_count()))
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(
        backend, init_method=init, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    atexit.register(_destroy_at_exit)
    return num_processes > 1


def _destroy_at_exit():
    if dist.is_initialized():
        dist.destroy_process_group()


def global_dp_mesh(n_model: int = 1) -> Mesh:
    """A (data, model) mesh over every rank, host-major, so a data row's
    ranks are neighbours (make_mesh)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % n_model:
        raise ValueError(f"global_dp_mesh: {world} ranks, n_model {n_model}")
    return make_mesh(world // n_model, n_model)


def process_camera_slice(n_cameras_per_step: int, mesh: Mesh):
    """(start, count) of the camera batch rows this rank renders: rows
    are dealt to the data axis in contiguous blocks, in data order."""
    per = n_cameras_per_step // mesh.shape["data"]
    return mesh.index["data"] * per, per
