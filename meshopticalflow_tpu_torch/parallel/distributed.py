"""Multi-process initialization on torch.distributed.

Port of meshopticalflow_tpu/parallel/distributed.py. The reference has one
process drive every device through a ``jax.sharding.Mesh``; PyTorch's idiom
is one process per GPU, so the port's counterpart of the mesh is a
:class:`DeviceGroup`: the process group, this process's rank, the world
size and its device (``cuda:LOCAL_RANK``, or the CPU). It is passed where
the reference passes ``device_mesh=``. Every rank runs the same host init;
only rank 0 writes output files.

Configuration follows the reference's environment contract, or torchrun's:

    MESHFLOW_COORDINATOR=host:port   (or MASTER_ADDR and MASTER_PORT)
    MESHFLOW_NUM_PROCESSES=N         (or WORLD_SIZE)
    MESHFLOW_PROCESS_ID=i            (or RANK)
    LOCAL_RANK=j                     (the process's GPU; default i modulo
                                      the GPUs of the host)

With none of these present :func:`maybe_init_distributed` is a no-op, and
:func:`global_device_group` gives a group of world size 1 that needs no
process group: the halo path then runs the same code with the neighbour
pairs (0 -> 0), its halo exchange a copy on the device. The backend is NCCL
for a CUDA device and gloo on the CPU; nothing falls back from one to the
other.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0
_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _env(*names: str) -> Optional[str]:
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return None


def _coordinator() -> Optional[str]:
    coord = _env("MESHFLOW_COORDINATOR")
    if coord:
        return coord
    addr, port = _env("MASTER_ADDR"), _env("MASTER_PORT")
    return f"{addr}:{port}" if addr and port else None


def _local_rank(rank: int) -> int:
    local = _env("LOCAL_RANK")
    if local is not None:
        return int(local)
    count = torch.cuda.device_count()
    return rank % count if count else 0


def _device(device, rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but "
                               "torch.cuda.is_available() is False")
        return torch.device("cuda", _local_rank(rank) if dev.index is None else dev.index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (use cpu or cuda)")
    return dev


def maybe_init_distributed(device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Initialize the default process group when a coordinator is configured:
    NCCL when ``device`` is CUDA (each process on ``cuda:LOCAL_RANK``), gloo
    on the CPU, with a ``timeout_s`` timeout on every collective.

    Returns True iff running distributed (after this call). Idempotent; a
    no-op without coordinator configuration."""
    if dist.is_initialized():
        return True
    coord = _coordinator()
    if not coord:
        return False
    nproc = int(_env("MESHFLOW_NUM_PROCESSES", "WORLD_SIZE") or "1")
    pid = int(_env("MESHFLOW_PROCESS_ID", "RANK") or "0")
    dev = _device(device, pid)
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{coord}", world_size=nproc, rank=pid,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return True


@dataclasses.dataclass(frozen=True)
class DeviceGroup:
    """The ranks a sharded problem runs on: ``group`` (None at world size 1
    without a process group), this process's ``rank``, the ``world_size`` and
    the process's ``device``."""

    group: Optional[dist.ProcessGroup]
    rank: int
    world_size: int
    device: torch.device

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the ranks in place by ``op`` ("sum" or "max");
        every rank gets the same result. The identity at world size 1."""
        if op not in _REDUCE_OPS:
            raise ValueError(f"unsupported reduction {op!r} (use sum or max)")
        if self.world_size > 1:
            dist.all_reduce(t, op=_REDUCE_OPS[op], group=self.group)
        return t

    def all_gather_rows(self, local: torch.Tensor) -> torch.Tensor:
        """The ranks' equal row blocks stacked in rank order."""
        if self.world_size == 1:
            return local
        local = local.contiguous()
        out = torch.empty((self.world_size * local.shape[0],) + tuple(local.shape[1:]),
                          dtype=local.dtype, device=local.device)
        dist.all_gather_into_tensor(out, local, group=self.group)
        return out


def global_device_group(device="cuda") -> DeviceGroup:
    """The group of every process (the default process group after
    :func:`maybe_init_distributed`), or world size 1 without one. ``device``
    names the device type; under CUDA each rank takes ``cuda:LOCAL_RANK``."""
    if dist.is_initialized():
        rank = dist.get_rank()
        return DeviceGroup(dist.group.WORLD, rank, dist.get_world_size(), _device(device, rank))
    return DeviceGroup(None, 0, 1, _device(device, 0))
