"""Joining the process world (counterpart of ``parallel/distributed.py``).

The JAX package joins ``jax.distributed``; the port joins a
``torch.distributed`` process group, one process per rank. Nothing on a
machine tells a program of its cluster, so :func:`initialize` takes the
address (``tcp://host:port``), the world size and the rank from its
caller, or from ``MMLSPARK_TPU_COORDINATOR`` / ``MMLSPARK_TPU_NUM_PROCESSES``
/ ``MMLSPARK_TPU_PROCESS_ID``; with neither it forms a world of one on a
free localhost port, so a single process still has a group to run its
collectives on.

The backend: NCCL when the ranks run on CUDA cards and every rank has a
card of its own; gloo on the CPU, and when ranks share a card (NCCL
refuses two ranks on one device, while gloo all-reduces CUDA tensors
through the host).

The reference's TCP rendezvous helper (``coordinator_rendezvous``) is not
ported: a launcher here hands every rank the address itself
(:mod:`mmlspark_tpu_torch.parallel.launch`).
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["initialize", "is_initialized", "world_info", "find_open_port",
           "choose_backend", "rank_device", "shutdown"]


def find_open_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_device(rank: int, device: str = "cuda") -> torch.device:
    """The device rank ``rank`` runs on: ``cuda:(rank % cards)`` for
    ``device="cuda"``, the CPU for ``device="cpu"``."""
    if device == "cpu":
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"device {device!r} (choose 'cuda' or 'cpu')")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "ranks on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def choose_backend(world_size: int, device: str = "cuda") -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    if device == "cuda" and torch.cuda.is_available() and \
            world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


#: how long a rank waits for the others to join, or in a collective
_TIMEOUT = datetime.timedelta(seconds=300)


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None, *, device: str = "cuda") -> None:
    """Join the process world (idempotent).

    Resolution order: explicit arguments → the ``MMLSPARK_TPU_*`` env
    variables → a world of one on a free localhost port. The backend is
    :func:`choose_backend`'s. On CUDA the rank's card (``rank % cards``)
    becomes the current device before the group forms."""
    if dist.is_initialized():
        return
    env_addr = os.environ.get("MMLSPARK_TPU_COORDINATOR")
    if init_method is None and env_addr:
        init_method = (env_addr if "://" in env_addr
                       else f"tcp://{env_addr}")
    if world_size is None:
        world_size = int(os.environ.get("MMLSPARK_TPU_NUM_PROCESSES", "1"))
    if rank is None:
        rank = int(os.environ.get("MMLSPARK_TPU_PROCESS_ID", "0"))
    if init_method is None:
        if world_size != 1:
            raise ValueError(f"a world of {world_size} ranks needs an "
                             f"address (init_method or "
                             f"MMLSPARK_TPU_COORDINATOR)")
        init_method = f"tcp://localhost:{find_open_port()}"
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    if device == "cuda":
        torch.cuda.set_device(rank_device(rank, device))
    dist.init_process_group(backend=choose_backend(world_size, device),
                            init_method=init_method, world_size=world_size,
                            rank=rank, timeout=_TIMEOUT)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_info() -> dict:
    """This process's place in the world, as the reference reports it."""
    if not is_initialized():
        return {"process_index": 0, "process_count": 1, "backend": None,
                "local_devices": torch.cuda.device_count()}
    return {"process_index": dist.get_rank(),
            "process_count": dist.get_world_size(),
            "backend": dist.get_backend(),
            "local_devices": torch.cuda.device_count()}


def shutdown() -> None:
    """Leave the world (a no-op outside one)."""
    if is_initialized():
        dist.destroy_process_group()
