"""Device placement and meshes over the process world (counterpart of
``parallel/mesh.py``: ``local_devices``, ``device_for_partition`` and
``feed_placement`` at :27-98 for one process, ``make_mesh`` and the axis
helpers at :108-149).

A graph runner pins each DataFrame partition to a local card,
round-robin (the reference's ``ONNXModel.selectGpuDevice``,
``ONNXModel.scala:293-303``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dims, one rank per mesh point, over the group that
:func:`~mmlspark_tpu_torch.parallel.distributed.initialize` formed. The
serving path names ``("tp",)`` or ``("dp", "tp")``; the helpers below
read an axis's size, this rank's index on it and its process group, and
treat an axis the mesh does not name as size 1.

:func:`gather_rows_many` is the dp exchange: slots shard over ``dp`` while
the page pool replicates over it, so every replica needs every shard's
fresh rows (GSPMD inserts that all-gather in the JAX package).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["local_devices", "device_for_partition", "feed_placement",
           "Placement", "make_mesh", "mesh_shape", "axis_size",
           "axis_rank", "axis_group", "gather_rows", "gather_rows_many"]


def local_devices() -> List[torch.device]:
    """This process's CUDA cards, in index order ([] when there is none:
    the CPU is never a local device here, since no path falls back to
    it)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_for_partition(partition_index: int) -> torch.device:
    """Pin a data partition to a local card, round-robin; raises when no
    card is present."""
    devs = local_devices()
    if not devs:
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "explicitly to run the plain PyTorch path")
    return devs[partition_index % len(devs)]


class Placement(NamedTuple):
    """Where one partition's feeds go. ``shards`` is the multiple the
    batch's leading dim pads to (1 on one device); ``key`` identifies the
    placement for the per-device params cache and warm-up bookkeeping."""

    device: torch.device
    shards: int
    key: tuple


def feed_placement(use_mesh: bool, partition_index: int,
                   device: Optional[torch.device] = None) -> Placement:
    """Resolve where a graph runner's batches go: ``device`` when the
    caller named one with an index (or the CPU), else a local card picked
    round-robin by partition. A sharded placement over a mesh is not
    ported (ROADMAP slice 6)."""
    if use_mesh:
        raise NotImplementedError(
            "mesh_sharded placement (one batch sharded over a device "
            "mesh) is not ported yet: ROADMAP slice 6")
    if device is None or (device.type == "cuda" and device.index is None):
        device = device_for_partition(partition_index)
    return Placement(device, 1, ("device", str(device)))


def make_mesh(axis_shapes: Optional[dict] = None, device: str = "cuda"):
    """A ``DeviceMesh`` from ``{axis_name: size}`` over the ranks of the
    process world; -1 means "all remaining ranks". Default: a 1-D
    ``"data"`` mesh over every rank. The world must be formed first
    (:func:`~mmlspark_tpu_torch.parallel.distributed.initialize`)."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.distributed.initialize first")
    n = dist.get_world_size()
    if not axis_shapes:
        axis_shapes = {"data": n}
    names, sizes = list(axis_shapes), list(axis_shapes.values())
    known = int(np.prod([s for s in sizes if s != -1]))
    sizes = [s if s != -1 else max(1, n // known) for s in sizes]
    total = int(np.prod(sizes))
    if total != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} "
                         f"ranks, the world has {n}")
    ranks = torch.arange(total, dtype=torch.int).reshape(sizes)
    return DeviceMesh(device, ranks, mesh_dim_names=tuple(names))


def _dim(mesh, name: str) -> Optional[int]:
    names = mesh.mesh_dim_names or ()
    return names.index(name) if name in names else None


def axis_size(mesh, name: str) -> int:
    """Ranks along ``name`` (1 when ``mesh`` is None or lacks the axis)."""
    if mesh is None:
        return 1
    d = _dim(mesh, name)
    return 1 if d is None else int(mesh.size(d))


def axis_rank(mesh, name: str) -> int:
    """This rank's index along ``name`` (0 when absent)."""
    if mesh is None or _dim(mesh, name) is None:
        return 0
    return int(mesh.get_local_rank(name))


def axis_group(mesh, name: str):
    """The process group along ``name``."""
    if _dim(mesh, name) is None:
        raise ValueError(f"mesh {mesh_shape(mesh)} has no axis {name!r}")
    return mesh.get_group(name)


def mesh_shape(mesh) -> str:
    """Canonical string for a mesh's axis layout, e.g. ``"dp1xtp2"``;
    ``"single"`` when ``mesh`` is None."""
    if mesh is None:
        return "single"
    return "x".join(f"{name}{int(mesh.size(i))}"
                    for i, name in enumerate(mesh.mesh_dim_names))


def gather_rows(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """All-gather ``t`` along dim 0 over ``axis``'s group: the result holds
    every rank's rows in axis order (rank ``i``'s at ``[i * n, (i + 1) *
    n)``), bytes identical to the senders' bytes, on every rank of the
    group. :func:`gather_rows_many` of one tensor."""
    return gather_rows_many([t], mesh, axis)[0]


def gather_rows_many(tensors, mesh, axis: str) -> List[torch.Tensor]:
    """:func:`gather_rows` of several tensors that share their leading dim
    (one device), in ONE collective. An axis of size 1 returns the
    tensors themselves.

    Each rank's rows travel as raw bytes, the tensors packed side by
    side, so any dtype crosses bit for bit. One code path per backend:

    * NCCL (every rank on a card of its own):
      ``all_gather_into_tensor``;
    * gloo (the CPU, or ranks that share a card): gloo takes CUDA tensors
      in ``broadcast`` and ``all_reduce`` only, so each rank writes its
      rows into a zero-filled buffer and the buffer is all-reduced under
      an integer view of its bytes. ``x + 0`` is ``x`` in integer
      arithmetic, so -0.0 and NaN payloads survive the sum exactly.

    Each call counts one in ``gather_rows_many.calls``."""
    n = axis_size(mesh, axis)
    if n == 1:
        return list(tensors)
    if any(t.dim() < 1 for t in tensors):
        raise ValueError("gather_rows needs tensors with a leading dim")
    group = axis_group(mesh, axis)
    m = tensors[0].shape[0]
    parts = [t.contiguous().reshape(-1).view(torch.uint8).reshape(m, -1)
             for t in tensors]
    rows = torch.cat(parts, dim=1)
    if rows.shape[1] % 4 == 0:
        rows = rows.view(torch.int32)
    backend = dist.get_backend(group)
    if backend == "nccl":
        out = torch.empty((n * m, rows.shape[1]), dtype=rows.dtype,
                          device=rows.device)
        dist.all_gather_into_tensor(out, rows, group=group)
    elif backend == "gloo":
        out = torch.zeros((n * m, rows.shape[1]), dtype=rows.dtype,
                          device=rows.device)
        r = axis_rank(mesh, axis)
        out[r * m:(r + 1) * m] = rows
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    else:
        raise ValueError(f"gather_rows has no path for backend {backend!r}")
    gather_rows_many.calls += 1
    out = out.view(torch.uint8)
    got, off = [], 0
    for t, p in zip(tensors, parts):
        w = p.shape[1]
        got.append(out[:, off:off + w].contiguous().view(t.dtype).reshape(
            (n * m,) + tuple(t.shape[1:])))
        off += w
    return got


#: calls since the last reset
gather_rows_many.calls = 0
