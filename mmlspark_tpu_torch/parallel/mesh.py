"""Device meshes over the process world (counterpart of
``parallel/mesh.py:108-149``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dims, one rank per mesh point, over the group that
:func:`~mmlspark_tpu_torch.parallel.distributed.initialize` formed. The
serving path names ``("tp",)`` or ``("dp", "tp")``; the helpers below
read an axis's size, this rank's index on it and its process group, and
treat an axis the mesh does not name as size 1.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["make_mesh", "mesh_shape", "axis_size", "axis_rank",
           "axis_group"]


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
