"""Run a function on every rank of a fresh process world (no JAX
counterpart: JAX drives every device from one controller).

:func:`run_ranks` spawns one process per rank, each joins a
``torch.distributed`` world on a free localhost port, builds the mesh
and calls ``fn(mesh, *args)``; the ranks' return values come back in
rank order. Tensors in a result come back as numpy arrays.

A spawned child re-imports the module that defines ``fn``, so ``fn``
must be a top-level function of a module whose import loads no JAX (a
test module that imports JAX cannot hold it). Every process started
here is stopped before :func:`run_ranks` returns or raises.
"""

from __future__ import annotations

import queue as _queue
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.multiprocessing as mp

from .distributed import find_open_port, initialize, shutdown
from .mesh import make_mesh

__all__ = ["run_ranks"]


def _to_host(x):
    """Tensors (nested in lists, tuples and dicts) → numpy arrays."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16 or (hasattr(torch, "float8_e4m3fn")
                                         and t.dtype == torch.float8_e4m3fn):
            # numpy has neither type: ship the raw bits
            t = t.view(torch.int16 if t.element_size() == 2 else torch.uint8)
        return t.numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank_main(rank, fn, world, device, port, axes, threads, args,
               results):
    try:
        if threads:
            torch.set_num_threads(threads)
        initialize(f"tcp://localhost:{port}", world, rank, device=device)
        mesh = make_mesh(axes or {"tp": world}, device)
        out = _to_host(fn(mesh, *args))
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        shutdown()


def run_ranks(fn: Callable, world: int, *, args: Sequence[Any] = (),
              device: str = "cuda", axes: Optional[dict] = None,
              timeout: float = 600.0,
              threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``world`` spawned ranks and return
    their results, rank 0 first.

    ``device`` ("cuda" or "cpu") is where the ranks run, over
    :func:`~.distributed.choose_backend`'s backend (NCCL when every rank
    has a card of its own, else gloo); ``axes`` is the mesh (default
    ``{"tp": world}``); ``threads`` caps each rank's intra-op threads.
    A rank that raises, or a world still running after ``timeout``
    seconds, raises here with the rank's traceback; every rank process
    is stopped either way."""
    if world < 1:
        raise ValueError("world must be >= 1")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = find_open_port()
    procs = []
    try:
        for rank in range(world):
            p = ctx.Process(target=_rank_main,
                            args=(rank, fn, world, device, port, axes,
                                  threads, tuple(args), results),
                            name=f"rank{rank}", daemon=True)
            p.start()
            procs.append(p)
        got = {}
        deadline = time.monotonic() + timeout
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                late = sorted(set(range(world)) - set(got))
                raise TimeoutError(f"ranks {late} still running after "
                                   f"{timeout} s")
            try:
                rank, ok, out = results.get(timeout=min(1.0, left))
            except _queue.Empty:
                dead = [p for i, p in enumerate(procs)
                        if i not in got and p.exitcode is not None]
                if dead:
                    # a rank died without reporting (killed, or a crash
                    # below Python)
                    raise RuntimeError(f"{dead[0].name} exited with code "
                                       f"{dead[0].exitcode} before "
                                       f"reporting")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [got[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=5)
        results.close()
        results.join_thread()
