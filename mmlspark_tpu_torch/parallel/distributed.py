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

:func:`coordinator_rendezvous` is the control-plane bootstrap for ranks
that are not started by one launcher: a driver hands every connecting
worker the coordinator's ``host:port`` (``tcp://`` + it is the
``init_method`` :func:`initialize` takes). No data crosses its sockets.
:mod:`mmlspark_tpu_torch.parallel.launch` hands its ranks the address
itself and needs none of it.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import threading
import time
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["initialize", "is_initialized", "world_info", "find_open_port",
           "choose_backend", "rank_device", "shutdown",
           "broadcast_object", "coordinator_rendezvous"]


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


def broadcast_object(obj):
    """Rank 0's picklable host object on every rank of the world; the
    other ranks' ``obj`` is ignored. A world of one returns ``obj``. Only
    objects this program pickled are unpickled: the ranks of one
    world's. Over NCCL the object crosses through the calling thread's
    current card."""
    if not is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def coordinator_rendezvous(role: str, driver_host: str, driver_port: int,
                           num_workers: int, timeout_s: float = 120.0) -> str:
    """Control-plane rendezvous: workers learn the coordinator address.

    ``role='driver'`` hosts a listener that hands every connecting worker the
    coordinator address (its own host + a fresh port) and returns it;
    ``role='worker'`` connects and reads it. The reference's text protocol
    of host:port exchange, used only to bootstrap the process group.
    """
    if role == "driver":
        coord_port = find_open_port()
        payload = json.dumps({"coordinator": f"{driver_host}:{coord_port}",
                              "num_workers": num_workers}).encode()
        # bind in the caller so an EADDRINUSE (port raced away between the
        # probe and here) surfaces to the driver instead of being swallowed
        # in a daemon thread while workers spin to timeout
        srv = socket.socket()
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((driver_host, driver_port))
        srv.listen(num_workers)
        srv.settimeout(timeout_s)

        def serve():
            served = 0
            try:
                while served < num_workers:
                    conn, _ = srv.accept()
                    with conn:
                        conn.sendall(payload)
                    served += 1
            except OSError:
                pass  # timeout or close; workers report their own timeout
            finally:
                srv.close()

        # run-once bootstrap: serves exactly num_workers payloads, then
        # exits (a supervised restart would re-listen on a closed socket)
        threading.Thread(target=serve, daemon=True).start()
        return f"{driver_host}:{coord_port}"
    # worker
    deadline = time.monotonic() + timeout_s
    last_err: Optional[Exception] = None
    while time.monotonic() < deadline:
        try:
            with socket.create_connection((driver_host, driver_port),
                                          timeout=5) as s:
                data = s.recv(4096)
            return json.loads(data.decode())["coordinator"]
        except OSError as e:
            last_err = e
            time.sleep(0.25)
    raise TimeoutError(f"rendezvous with {driver_host}:{driver_port} timed "
                       f"out after {timeout_s}s") from last_err
