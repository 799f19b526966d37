"""What each rank of the port's CPU mesh tests runs.

``parallel.launch.run_ranks`` spawns the ranks, and a spawned child
re-imports the module of the function it runs: so these functions live
here, in a module that imports torch and the port only, never JAX (the
test modules that call them import JAX). Arrays cross the process
boundary as numpy; bf16 and fp8 tensors travel as their raw bits
(int16 / uint8) beside a dtype name. The module holds no test itself.
"""

import numpy as np
import torch
import torch.distributed as dist

from mmlspark_tpu_torch.models.zoo import transformer as tf
from mmlspark_tpu_torch.ops import paged_attention as pa
from mmlspark_tpu_torch.parallel.mesh import (axis_group, axis_rank,
                                              axis_size, mesh_shape)
from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder

#: the tiny f32 decoder of ``tests/test_mesh_parity.py:44-46``
CFG = tf.TransformerConfig(vocab=128, layers=2, d_model=64, heads=4,
                           d_ff=128, max_len=96, causal=True,
                           norm="rmsnorm", position="rope",
                           dtype=torch.float32)

_VIEWS = {"bfloat16": (torch.int16, torch.bfloat16),
          "float8_e4m3fn": (torch.uint8, getattr(torch, "float8_e4m3fn",
                                                 None))}


class StubMesh:
    """A mesh's axis names and sizes only (no process group): what the
    mesh checks read before they touch a group."""

    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self._sizes = tuple(axes.values())

    def size(self, dim):
        return self._sizes[dim]


def to_torch(a, dtype_name=None):
    """numpy (raw bits for bf16 / fp8) → torch in ``dtype_name``."""
    t = torch.from_numpy(np.ascontiguousarray(a).copy())
    if dtype_name in _VIEWS:
        bits, dt = _VIEWS[dtype_name]
        return t.view(bits).view(dt)
    return t


def _heads(t, rank, tp):
    """This rank's heads (axis 1) of a (B, H, ...) or (N, H, ...) array."""
    h = t.shape[1] // tp
    return t[:, rank * h:(rank + 1) * h].contiguous()


def _gather_heads(t, group, tp):
    """All ranks' head shards of ``t`` (axis 1), concatenated in rank
    order on every rank."""
    parts = [torch.empty_like(t) for _ in range(tp)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def mount_cases(mesh, cases):
    """Each case's window mount (``paged_attention_window(mesh=)``) and
    read mount (``paged_attention(mesh=)``) on this rank's head shard.
    Returns per case: both contexts all-gathered over heads, and this
    rank's pools after the window write."""
    tp, rank = axis_size(mesh, "tp"), axis_rank(mesh, "tp")
    group = axis_group(mesh, "tp")
    out = []
    for c in cases:
        dts = c["dtypes"]
        act = {k: _heads(to_torch(c[k], dts.get(k)), rank, tp)
               for k in ("q", "kn", "vn")}
        pools = [_heads(to_torch(c[k], dts.get(k)), rank, tp)
                 for k in c["pools"]]
        bt, pos = to_torch(c["bt"]), to_torch(c["pos"])
        active = to_torch(c["active"])
        scales = ({"k_scale": pools[2], "v_scale": pools[3]}
                  if len(pools) == 4 else {})
        read = pa.paged_attention(act["q"], pools[0], pools[1], bt,
                                  to_torch(c["lengths"]), mesh=mesh,
                                  head_axis="tp", **scales)
        got = pa.paged_attention_window(act["q"], act["kn"], act["vn"],
                                        pools[0], pools[1], bt, pos,
                                        active=active, mesh=mesh,
                                        head_axis="tp", **scales)
        assert all(g is p for g, p in zip(got[1:], pools))
        out.append({"ctx": _gather_heads(got[0], group, tp),
                    "read": _gather_heads(read, group, tp),
                    "pools": pools})
    return out


def _drain(eng, reqs, limit=400):
    for _ in range(limit):
        if all(r.done for r in reqs):
            return
        eng.step()
    raise AssertionError("requests did not finish")


def _decode(params, prompts, max_new, mesh, **kw):
    eng = ContinuousDecoder(params, CFG, device="cpu", mesh=mesh,
                            max_slots=4, max_len=64, **kw)
    reqs = [eng.submit(p, max_new) for p in prompts]
    _drain(eng, reqs)
    return eng, [eng.result(r) for r in reqs]


def engine_cases(mesh, params, prompts, survivor):
    """The meshed engine runs the CPU tests compare with the JAX mesh
    engine: f32 kernel and gather engines (10 tokens), an int8 kernel
    engine (4 tokens), a mid-stream ``compact()``, and a config whose
    heads the mesh does not divide."""
    res = {"mesh_shape": mesh_shape(mesh), "rank": axis_rank(mesh, "tp")}
    for impl in ("kernel", "gather"):
        eng, toks = _decode(params, prompts, 10, mesh, paged_attn=impl)
        res[impl] = {"tokens": toks, "stats": dict(eng._kv.stats),
                     "layer0": dict(eng._kv.buffers[0]),
                     "pool_heads": eng._kv.heads,
                     "bytes_per_position": eng._kv.bytes_per_position(),
                     "bytes_per_position_global":
                         eng._kv.bytes_per_position_global(),
                     "device_bytes": eng._kv.device_bytes(),
                     "device_bytes_global": eng._kv.device_bytes_global(),
                     "engine_mesh_shape": eng._mesh_shape}
    eng, toks = _decode(params, prompts[:4], 4, mesh, paged_attn="kernel",
                        kv_dtype="int8")
    res["int8"] = {"tokens": toks, "stats": dict(eng._kv.stats),
                   "layer0": dict(eng._kv.buffers[0])}
    # defrag_threshold=1: the short request's retirement compacts the
    # pool while the long one decodes
    eng = ContinuousDecoder(params, CFG, device="cpu", mesh=mesh,
                            max_slots=4, max_len=64, page_size=4,
                            defrag_threshold=1)
    rs = eng.submit(survivor[0], 3)
    rl = eng.submit(survivor[1], 24)
    _drain(eng, [rs, rl])
    res["compact"] = {"tokens": eng.result(rl),
                      "defrag_moves": eng._kv.stats["defrag_moves"],
                      "pages_in_use": eng._kv.pages_in_use}
    bad = CFG._replace(d_model=48, heads=3)
    try:
        ContinuousDecoder(tf.init_transformer(bad), bad, device="cpu",
                          mesh=mesh)
        res["indivisible"] = None
    except ValueError as e:
        res["indivisible"] = str(e)
    return res


def single_rank_engine(mesh, params, prompts):
    """A one-rank ``tp`` mesh against the single-device engine on the same
    rank: the collective runs (a group of one) and changes no bit."""
    out = {"mesh_shape": mesh_shape(mesh)}
    for key, m in (("mesh", mesh), ("single", None)):
        eng, toks = _decode(params, prompts, 10, m, paged_attn="kernel")
        out[key] = {"tokens": toks, "layer0": dict(eng._kv.buffers[0])}
    return out


def fails(mesh):
    """A rank that raises (the launcher must report it)."""
    raise RuntimeError(f"rank {axis_rank(mesh, 'tp')} failed on purpose")
