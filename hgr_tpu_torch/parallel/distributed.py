"""Ranks as processes over torch.distributed (port of
hgr_tpu/parallel/distributed.py).

The JAX package connects one process per host to a coordination service
and lets one process drive all of its local devices. In PyTorch every
rank is a process: ``initialize`` joins this process to the group at
``tcp://HOST:PORT`` with its world size and rank, and the helpers below
answer what the JAX module answers (process count and index, the
coordinator, its decision, a barrier).

The backend follows a rule, not a fallback (``backend_for``):

- gloo for ranks on the CPU (the JAX module sets gloo for the CPU
  backend's collectives, :66-71);
- gloo for ranks that share a card (``--host_device_count`` on CUDA):
  NCCL refuses two ranks on one device, and gloo's ``all_reduce`` and
  ``broadcast`` take CUDA tensors through the host;
- nccl when every rank has a card of its own.

No flag names a backend, so nccl never runs ranks that share a card.
"""

from __future__ import annotations

import datetime
import socket
from typing import Optional, Tuple

import torch
import torch.distributed as dist

# the collectives of one training step wait at most this long
TIMEOUT = datetime.timedelta(minutes=10)


def parse_spec(spec: str) -> Tuple[str, int, int]:
    """Parse ``'host:port,num_processes,process_id'`` (the ``cli.train
    --distributed`` flag format)."""
    parts = spec.split(",")
    if len(parts) != 3:
        raise ValueError(
            "--distributed expects 'host:port,num_processes,process_id'"
            f", got {spec!r}")
    addr, nproc, pid = parts[0], int(parts[1]), int(parts[2])
    if not (0 <= pid < nproc):
        raise ValueError(f"process_id {pid} out of range for "
                         f"num_processes {nproc}")
    return addr, nproc, pid


def backend_for(device_type: str, shared_card: bool = False) -> str:
    """The backend of ranks on ``device_type`` ('cpu' | 'cuda'):
    gloo on the CPU and on a card the ranks share, nccl when each rank
    has a card of its own."""
    return "nccl" if device_type == "cuda" and not shared_card else "gloo"


def free_port() -> int:
    """A TCP port on this host that no socket holds now, for the group's
    rank 0 to listen at."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, backend: str = "gloo") -> None:
    """Join this process, rank ``process_id`` of ``num_processes``, to the
    group whose rank 0 listens at ``coordinator_address`` (HOST:PORT)."""
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def backend() -> Optional[str]:
    """The group's backend, or None for a single process."""
    return dist.get_backend() if dist.is_initialized() else None


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    """Rank 0 owns the side effects every rank must not duplicate: metric
    logs, checkpoint writes, stdout."""
    return process_index() == 0


def _flag(value: float) -> torch.Tensor:
    device = ("cuda" if backend() == "nccl" else "cpu")
    return torch.tensor([value], dtype=torch.float64, device=device)


def coordinator_value(value: float) -> float:
    """Rank 0's number, on every rank (a broadcast); single process:
    ``value``."""
    if process_count() == 1:
        return value
    t = _flag(float(value))
    dist.broadcast(t, src=0)
    return float(t.item())


def coordinator_decision(value: bool) -> bool:
    """Adopt the coordinator's boolean on every rank: a branch that leads
    into a collective must be taken alike everywhere, and a condition read
    from shared storage (``CheckpointManager.has``) may differ between
    ranks. Single process: ``value``."""
    return bool(coordinator_value(float(bool(value))))


def barrier() -> None:
    """Block until every rank reaches this point; orders the
    coordinator's checkpoint write before any rank reads it."""
    if process_count() > 1:
        dist.barrier()
