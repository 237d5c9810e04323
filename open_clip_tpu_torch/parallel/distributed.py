"""Process groups (counterpart of ``open_clip_tpu/parallel/distributed.py``).

``init_distributed`` finds the world in the flags or the environment and calls
``torch.distributed.init_process_group``: NCCL where the processes train on CUDA
cards (each on ``cuda:local_rank``), gloo on the CPU. One process per device, as
torchrun starts them; the JAX package's one process per host with several devices
has no counterpart here.

The host helpers (``host_psum``, ``host_gather_by_index``, ``host_gather_stride``,
``broadcast_scalar_from_primary``) take numpy arrays and give numpy arrays. They move
host bytes, so they run on a gloo group of their own beside the NCCL one (under gloo,
the default group itself): no array takes a trip through the card.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

_HOST_GROUP = None  # the gloo group of the host helpers, made once per process group


def world_info_from_env() -> Tuple[Optional[str], Optional[int], Optional[int]]:
    """(coordinator, num_processes, process_id) from the environment, as the JAX
    function reads it: the explicit OCT_* names first, then torchrun's RANK and
    WORLD_SIZE, then SLURM's; the coordinator is OCT_COORDINATOR or MASTER_ADDR,
    with MASTER_PORT appended when it has no port."""
    coord = os.environ.get("OCT_COORDINATOR") or os.environ.get("MASTER_ADDR")
    if coord and ":" not in coord and os.environ.get("MASTER_PORT"):
        coord = f"{coord}:{os.environ['MASTER_PORT']}"
    for size_var, rank_var in (
        ("OCT_NUM_PROCESSES", "OCT_PROCESS_ID"),
        ("WORLD_SIZE", "RANK"),
        ("SLURM_NTASKS", "SLURM_PROCID"),
    ):
        if size_var in os.environ and rank_var in os.environ:
            return coord, int(os.environ[size_var]), int(os.environ[rank_var])
    return coord, None, None


def local_rank_from_env() -> int:
    """This process's device on its host: LOCAL_RANK (torchrun), else SLURM_LOCALID, else 0."""
    for var in ("LOCAL_RANK", "SLURM_LOCALID"):
        if var in os.environ:
            return int(os.environ[var])
    return 0


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *, device: str = "cuda") -> Tuple[int, int]:
    """Join the process group the flags or the environment describe; returns
    (rank, world size).

    Explicit arguments win over the environment (``world_info_from_env``, which holds
    what a launcher sets: torchrun's or SLURM's variables, so the JAX function's
    ``auto`` has nothing left to find). A world needs a coordinator ("host:port") and a
    size; a size above 1 also needs a process id, else this raises, as the JAX
    function does. Nothing configured: no group, (0, 1). The
    backend follows ``device``: NCCL for "cuda", after ``torch.cuda.set_device`` to
    the local rank; gloo for "cpu". A world that asked for more than one process and
    cannot be joined raises; nothing here goes on as one process. Called again once
    the group exists, it returns the group's rank and size."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env_coord, env_n, env_id = world_info_from_env()
    coordinator = coordinator or env_coord
    num_processes = num_processes if num_processes is not None else env_n
    process_id = process_id if process_id is not None else env_id
    # a world of one with no coordinator (a one-task SLURM job) is one process, no group
    if num_processes is None or (num_processes == 1 and not coordinator):
        return 0, 1
    if num_processes > 1 and process_id is None:
        raise ValueError("multi-process init needs a process id: pass --dist-process-id or set "
                         "one of OCT_PROCESS_ID / RANK / SLURM_PROCID")
    if not coordinator:
        raise ValueError(f"a world of {num_processes} processes needs a coordinator host:port: "
                         "pass --dist-coordinator or set OCT_COORDINATOR / MASTER_ADDR")
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no process-group backend for device {device!r}")
    kw = {}
    if kind == "cuda":
        local = torch.device("cuda", local_rank_from_env())
        torch.cuda.set_device(local)
        kw["device_id"] = local
    backend = "nccl" if kind == "cuda" else "gloo"
    logger.info("init_process_group(%s, tcp://%s, world %d, rank %d)", backend, coordinator,
                num_processes, process_id or 0)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id or 0, **kw)
    _host_group()
    return dist.get_rank(), dist.get_world_size()


def world() -> Tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_primary() -> bool:
    """Rank 0 (or no group): the process that logs and writes files."""
    return world()[0] == 0


def _host_group():
    """The gloo group of the host helpers: the default group where it is gloo, else
    one made beside it (every rank makes it at the same point, in init_distributed or
    at the first helper call)."""
    global _HOST_GROUP
    default = dist.group.WORLD
    if dist.get_backend() == "gloo":
        return default
    if _HOST_GROUP is None or _HOST_GROUP[0] is not default:
        _HOST_GROUP = (default, dist.new_group(backend="gloo"))
    return _HOST_GROUP[1]


def barrier() -> None:
    """Wait until every process gets here (no-op without a group)."""
    if world()[1] > 1:
        dist.barrier(group=_host_group())


def _allgather_host(arr: np.ndarray) -> np.ndarray:
    """(W, *arr.shape): every process's ``arr`` (same shape and dtype on all), in rank order."""
    arr = np.ascontiguousarray(arr)
    raw = torch.from_numpy(arr.reshape(-1).view(np.uint8).copy())
    parts = [torch.empty_like(raw) for _ in range(world()[1])]
    dist.all_gather(parts, raw, group=_host_group())
    return np.stack([p.numpy().view(arr.dtype).reshape(arr.shape) for p in parts])


def host_psum(values) -> np.ndarray:
    """The sum over processes of a small host vector (eval counts, loss sums), in
    float64, summed in rank order so that every process gets the same bits. One
    process: the values."""
    vals = np.asarray(values, np.float64)
    if world()[1] == 1:
        return vals
    return _allgather_host(vals).sum(axis=0)


def _allgather_blocks(arr: np.ndarray) -> list:
    """Every process's rows, one block a process in rank order; the row counts may
    differ (each block is padded to the longest for the gather)."""
    counts = _allgather_host(np.asarray([arr.shape[0]], np.int64)).reshape(-1)
    m = int(counts.max())
    if arr.shape[0] < m:
        arr = np.concatenate([arr, np.zeros((m - arr.shape[0],) + arr.shape[1:], arr.dtype)])
    stacked = _allgather_host(arr)
    return [stacked[r, :int(c)] for r, c in enumerate(counts)]


def host_gather_by_index(arr, index) -> np.ndarray:
    """Every process's rows on every process, each at its global position: ``index``
    gives each local row's global row id (rank-split evaluation reassembling the
    feature matrix). One process: ``arr`` ordered by ``index``."""
    arr = np.asarray(arr)
    idx = np.asarray(index, np.int64).reshape(-1)
    if world()[1] > 1:
        arr = np.concatenate(_allgather_blocks(arr))
        idx = np.concatenate(_allgather_blocks(idx))
    out = np.zeros_like(arr)
    out[idx] = arr
    return out


def host_gather_stride(arr) -> np.ndarray:
    """Every process's rows on every process in the global order of a stride split
    (process r holds global rows r, r + W, ...). One process: ``arr``."""
    arr = np.asarray(arr)
    n_proc = world()[1]
    if n_proc == 1:
        return arr
    blocks = _allgather_blocks(arr)
    out = np.zeros((sum(len(b) for b in blocks),) + arr.shape[1:], arr.dtype)
    for r, block in enumerate(blocks):
        out[r::n_proc] = block
    return out


def broadcast_object_from_primary(obj):
    """Rank 0's picklable ``obj`` on every process (a run's name taken from the clock)."""
    if world()[1] == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=_host_group())
    return box[0]


def broadcast_scalar_from_primary(value: float) -> float:
    """Rank 0's ``value`` on every process (the resume epoch, early-stop flags)."""
    if world()[1] == 1:
        return value
    t = torch.tensor([float(value)], dtype=torch.float64)
    dist.broadcast(t, src=0, group=_host_group())
    return float(t.item())
