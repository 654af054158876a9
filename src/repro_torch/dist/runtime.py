"""Multi-process runtime over ``torch.distributed`` (the reference's
``repro.dist.runtime``): bring-up, the all-reduce barrier, introspection.

One process per device, PyTorch's idiom: rank r computes on
``cuda:{local rank % torch.cuda.device_count()}`` (``local_device``), or on
the CPU when the caller asks for it. The rest of ``repro_torch.dist`` runs
over whatever process group is initialised, by ``initialize`` or by the
caller; with none, the world is one process and every collective is the
identity over it.

  - ``initialize()`` — env/flag driven ``init_process_group``: NCCL for a
                       CUDA device, gloo for the CPU (``backend=`` overrides,
                       e.g. gloo for two ranks sharing one card, which NCCL
                       refuses). A call with no coordinator configured, or a
                       world of one, is a no-op, so every single-process
                       entry point keeps working untouched.
  - ``barrier()``    — an all-reduce of ones: every rank checks the total
                       equals the world size. A wrong total means a peer ran
                       a DIFFERENT collective (divergent programs), which
                       fails loudly instead of deadlocking later.
  - introspection    — ``process_index`` / ``process_count`` /
                       ``device_summary()`` with the reference's keys.

Env vars (flags win over env, env wins over nothing):
    REPRO_COORDINATOR   — "host:port" of rank 0 (also accepts
                          JAX_COORDINATOR_ADDRESS), or a full init method
                          ("tcp://...", "file://...")
    REPRO_NUM_PROCESSES — world size
    REPRO_PROCESS_ID    — this process's rank
    LOCAL_RANK          — this process's index on its host (default: rank)
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.device import resolve_device

__all__ = ["initialize", "is_distributed", "process_index", "process_count",
           "local_device_count", "global_device_count", "device_summary",
           "barrier", "local_device", "collective_device", "group_size",
           "group_rank"]

_state = {"device": None}


def _env(name: str, alt: Optional[str] = None) -> Optional[str]:
    v = os.environ.get(name)
    if v is None and alt is not None:
        v = os.environ.get(alt)
    return v


def _init_method(coordinator: str) -> str:
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device="cuda",
               backend: Optional[str] = None) -> bool:
    """Bring up the default process group (idempotent). Returns True iff a
    multi-process group is (now) alive.

    Resolution order per field: explicit argument, then env var. With no
    coordinator configured anywhere this is a no-op (rank 0 of 1). A
    coordinator with no world size, or a nonzero ``process_id`` with no
    coordinator, raises: a silently single-process rank would split-brain
    the fleet. ``device`` picks the backend (NCCL for CUDA, gloo for the
    CPU) unless ``backend`` names one, and is the device ``local_device``
    and ``device_summary`` report."""
    coordinator = coordinator or _env("REPRO_COORDINATOR",
                                      "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and _env("REPRO_NUM_PROCESSES"):
        num_processes = int(_env("REPRO_NUM_PROCESSES"))
    if process_id is None and _env("REPRO_PROCESS_ID"):
        process_id = int(_env("REPRO_PROCESS_ID"))
    dev = resolve_device(device)
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator is None:
        if process_id not in (None, 0):
            raise ValueError(
                f"process_id={process_id} configured but no coordinator "
                f"address — set REPRO_COORDINATOR (a silently single-process "
                f"rank would split-brain the fleet)")
        _state["device"] = dev
        return False
    if num_processes is None or num_processes < 1:
        raise ValueError(
            f"coordinator {coordinator!r} configured but num_processes is "
            f"{num_processes!r} — set REPRO_NUM_PROCESSES")
    _state["device"] = dev
    if num_processes == 1:
        return False  # explicit world of one: valid single-process run
    rank = int(process_id or 0)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(_local_cuda(rank))
    dist.init_process_group(backend, init_method=_init_method(coordinator),
                            world_size=num_processes, rank=rank)
    return True


def _local_cuda(rank: int) -> torch.device:
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def group_size(group=None) -> int:
    """World size of ``group`` (the default group when None); 1 with no
    process group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def group_rank(group=None) -> int:
    """This process's rank within ``group``; 0 with no process group."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def local_device(device=None) -> torch.device:
    """The device this rank computes on: ``cuda:{local rank % card count}``
    for CUDA, the CPU when asked for. ``device=None`` takes the one
    ``initialize`` was given (CUDA before any call)."""
    if device is None:
        device = _state["device"] or "cuda"
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    return _local_cuda(process_index())


def collective_device(group=None) -> torch.device:
    """Where a scalar made on the host goes before a collective: the
    current card under NCCL (it moves only CUDA tensors), the CPU
    otherwise."""
    if dist.is_initialized() and dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def local_device_count() -> int:
    """Devices this process computes on: one (one process per device)."""
    return 1


def global_device_count() -> int:
    """Devices of the whole program: one a process."""
    return process_count()


def device_summary() -> dict:
    """This process's view of the topology (the reference's keys; the CI
    lane prints it from every process as the bring-up receipt)."""
    dev = local_device()
    return {
        "process_index": process_index(),
        "process_count": process_count(),
        "local_devices": [dev.index or 0],
        "local_device_count": local_device_count(),
        "global_device_count": global_device_count(),
        "platform": "gpu" if dev.type == "cuda" else dev.type,
    }


def barrier(tag: str = "", group=None) -> None:
    """Block until every rank of ``group`` reaches this point.

    An all-reduce (SUM) of a one from every rank; each checks the total is
    the group's size. A wrong total means a peer ran a different collective
    (program divergence) and raises. With no process group the total is
    the local one, and the check still runs."""
    with obs.trace_span("dist.barrier", tag=tag,
                        hist=obs.histogram("dist_barrier_seconds",
                                           "Barrier wait latency")):
        one = torch.ones((1,), dtype=torch.float32,
                         device=collective_device(group))
        if dist.is_initialized():
            dist.all_reduce(one, op=dist.ReduceOp.SUM, group=group)
        total = int(one.item())
    n = group_size(group)
    if total != n:
        raise RuntimeError(
            f"barrier({tag!r}) all-reduce mismatch: got {total}, want {n} — "
            f"processes are running divergent programs")
