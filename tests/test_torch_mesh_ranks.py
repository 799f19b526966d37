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

import json
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

from mmlspark_tpu_torch.models.zoo import transformer as tf
from mmlspark_tpu_torch.ops import paged_attention as pa
from mmlspark_tpu_torch.parallel.mesh import (axis_group, axis_rank,
                                              axis_size, gather_rows,
                                              gather_rows_many, mesh_shape)
from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder
from mmlspark_tpu_torch.serving.generation import GenerationEngine

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

#: the tiny f32 decoder of ``tests/test_mesh_parity.py:44-46``
CFG = tf.TransformerConfig(vocab=128, layers=2, d_model=64, heads=4,
                           d_ff=128, max_len=96, causal=True,
                           norm="rmsnorm", position="rope",
                           dtype=torch.float32)

#: its draft (``tests/test_mesh_parity.py:47``)
D_CFG = CFG._replace(layers=1, d_model=32, heads=2, d_ff=64)

_VIEWS = {"bfloat16": (torch.int16, torch.bfloat16),
          "float8_e4m3fn": (torch.uint8, getattr(torch, "float8_e4m3fn",
                                                 None))}


class StubMesh:
    """A mesh's axis names and sizes only (no process group), as rank 0
    sees them: what the mesh checks and an engine's construction read
    before anything touches a group."""

    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self._sizes = tuple(axes.values())

    def size(self, dim):
        return self._sizes[dim]

    def get_local_rank(self, name):
        return 0


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


def _rows(t, rank, dp):
    """This rank's rows (axis 0) of a (B, ...) array."""
    n = t.shape[0] // dp
    return t[rank * n:(rank + 1) * n].contiguous()


def mount_dp_cases(mesh, cases):
    """Each case's window mount and read mount with rows over ``dp`` and
    heads over ``tp``: this rank's rows and heads of q / k_new / v_new,
    its rows of the block table, ``pos``, ``active`` and ``lengths``, its
    head shard of the pools. Returns per case this rank's ctx and read
    blocks and its pools after the window write (every dp shard's rows
    written)."""
    dp, tp = axis_size(mesh, "dp"), axis_size(mesh, "tp")
    dr, tr = axis_rank(mesh, "dp"), axis_rank(mesh, "tp")
    out = []
    for c in cases:
        dts = c["dtypes"]
        act = {k: _rows(_heads(to_torch(c[k], dts.get(k)), tr, tp), dr, dp)
               for k in ("q", "kn", "vn")}
        pools = [_heads(to_torch(c[k], dts.get(k)), tr, tp)
                 for k in c["pools"]]
        bt, pos, active, lengths = (_rows(to_torch(c[k]), dr, dp) for k in
                                    ("bt", "pos", "active", "lengths"))
        scales = ({"k_scale": pools[2], "v_scale": pools[3]}
                  if len(pools) == 4 else {})
        kw = {"mesh": mesh, "slot_axis": "dp", "head_axis": "tp", **scales}
        read = pa.paged_attention(act["q"], pools[0], pools[1], bt, lengths,
                                  **kw)
        got = pa.paged_attention_window(act["q"], act["kn"], act["vn"],
                                        pools[0], pools[1], bt, pos,
                                        active=active, **kw)
        out.append({"ctx": got[0], "read": read, "pools": pools})
    return out


def _layers(eng):
    """Every layer's pool buffers (this rank's head shard)."""
    return [dict(c) for c in eng._kv.buffers]


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _session_case(mesh, params, survivor):
    """A session exported from the meshed pool mid-stream, then the same
    engine run to the end (the uninterrupted tokens), and the blob adopted
    warm by a second meshed engine (its remainder)."""
    eng = ContinuousDecoder(params, CFG, device="cpu", mesh=mesh,
                            max_slots=4, max_len=64)
    other = eng.submit(survivor[0], 12)
    req = eng.submit(survivor[1], 24)
    while len(req.tokens) < 6:
        eng.step()
    ck = eng.checkpoint_session(req)
    slot = eng._slot_of(req)
    n = ck["kv"]["n_pages"]
    idx = torch.as_tensor(eng._slot_pages[slot][:n])
    shard = [{k: b[idx] for k, b in c.items()} for c in eng._kv.buffers]
    _drain(eng, [req, other])
    eng2 = ContinuousDecoder(params, CFG, device="cpu", mesh=mesh,
                             max_slots=4, max_len=64)
    got = eng2.restore_session(ck["session"], ck["kv"])
    _drain(eng2, [got])
    return {"checkpoint": ck, "shard": shard,
            "uninterrupted": eng.session_result(req),
            "adopted_mesh": eng2.session_result(got),
            "adopted_prefills": eng2.stats["prefills"]}


def _http_case(mesh, params, payloads):
    """``GenerationEngine(mesh=)``: rank 0 serves ``payloads`` over HTTP
    (four at a time) while the other ranks follow; then a token id past
    int32 and ``payloads[0]`` again, one after the other; rank 0's
    replies."""
    eng = GenerationEngine(params, CFG, device="cpu", mesh=mesh, max_slots=4,
                           max_len=64)
    eng.start()
    replies = after = None
    try:
        if eng.leader:
            with ThreadPoolExecutor(4) as ex:
                replies = list(ex.map(lambda p: _post(eng.address, p),
                                      payloads))
            bad = dict(payloads[0], tokens=[1, 2 ** 40, 3])
            after = [_post(eng.address, bad),
                     _post(eng.address, payloads[0])]
    finally:
        eng.stop()
    return {"leader": eng.leader, "address": eng.address,
            "replies": replies, "after": after}


def dp_world(mesh, params, d_params, prompts, survivor, payloads,
             mount_cases):
    """Everything the dp x tp CPU tests compare, in one world: the mounts
    with rows over dp; f32 kernel and gather engines (10 tokens) with
    their pools; an int8 engine (4 tokens); a draft at gamma 4; a
    mid-stream ``compact()``; a session exported at tp > 1; the HTTP front
    over the meshed engine; and a ``gather_rows`` of -0.0 and NaN
    payloads."""
    res = {"mesh_shape": mesh_shape(mesh), "dp": axis_rank(mesh, "dp"),
           "tp": axis_rank(mesh, "tp"),
           "mount": mount_dp_cases(mesh, mount_cases)}
    for impl in ("kernel", "gather"):
        eng, toks = _decode(params, prompts, 10, mesh, paged_attn=impl)
        res[impl] = {"tokens": toks, "stats": dict(eng._kv.stats),
                     "layers": _layers(eng), "slot_axis": eng._slot_axis,
                     "rows": [eng._rows.start, eng._rows.stop],
                     "engine_mesh_shape": eng._mesh_shape}
    eng, toks = _decode(params, prompts[:4], 4, mesh, paged_attn="kernel",
                        kv_dtype="int8")
    res["int8"] = {"tokens": toks, "stats": dict(eng._kv.stats),
                   "layers": _layers(eng)}
    eng, toks = _decode(params, prompts[:4], 10, mesh, paged_attn="kernel",
                        draft_params=d_params, draft_cfg=D_CFG, gamma=4)
    res["spec"] = {"tokens": toks, "stats": dict(eng.stats),
                   "pool": dict(eng._kv.stats)}
    eng = ContinuousDecoder(params, CFG, device="cpu", mesh=mesh,
                            max_slots=4, max_len=64, page_size=4,
                            defrag_threshold=1)
    rs = eng.submit(survivor[0], 3)
    rl = eng.submit(survivor[1], 24)
    _drain(eng, [rs, rl])
    res["compact"] = {"tokens": eng.result(rl),
                      "defrag_moves": eng._kv.stats["defrag_moves"],
                      "pages_in_use": eng._kv.pages_in_use}
    res["session"] = _session_case(mesh, params, survivor)
    res["http"] = _http_case(mesh, params, payloads)
    odd = torch.tensor([[-0.0, float("nan"), 1.5]]) * (1 + axis_rank(
        mesh, "dp"))
    res["gathered"] = gather_rows(odd, mesh, "dp")
    res["gathered_many"] = gather_rows_many(
        [odd, torch.tensor([[True]]), torch.tensor([7], dtype=torch.int16)],
        mesh, "dp")
    return res


def follower_tick_fails(mesh, params):
    """``GenerationEngine(mesh=)`` where a follower's decoder step raises
    (an injected fault on that rank only): whether each rank's engine
    thread ended on its own, and what each rank's ``stop()`` raised."""
    from mmlspark_tpu_torch.reliability import get_injector
    eng = GenerationEngine(params, CFG, device="cpu", mesh=mesh, max_slots=2,
                           max_len=32)
    if not eng.leader:
        get_injector().add("device_run", "error", times=1)
    eng.start()
    eng._thread.join(timeout=120)
    ended = not eng._thread.is_alive()
    try:
        eng.stop()
        raised = None
    except RuntimeError as e:
        raised = f"{e} <- {type(e.__cause__).__name__}"
    return {"leader": eng.leader, "ended": ended, "raised": raised}


def dp_only_engine(mesh, params, prompts):
    """A ("dp",) = (2,) mesh (no head axis: replicated weights and heads)
    against the single-device engine on the same rank: tokens, and each
    replica's pools; then three slots, which dp = 2 does not divide (the
    rows replicate)."""
    out = {"mesh_shape": mesh_shape(mesh), "dp": axis_rank(mesh, "dp")}
    for key, m in (("mesh", mesh), ("single", None)):
        eng, toks = _decode(params, prompts, 10, m, paged_attn="kernel")
        out[key] = {"tokens": toks, "layers": _layers(eng),
                    "slot_axis": eng._slot_axis}
    eng = ContinuousDecoder(params, CFG, device="cpu", mesh=mesh,
                            max_slots=3, max_len=64)
    reqs = [eng.submit(p, 10) for p in prompts]
    _drain(eng, reqs)
    out["odd"] = {"tokens": [eng.result(r) for r in reqs],
                  "slot_axis": eng._slot_axis,
                  "rows": [eng._rows.start, eng._rows.stop]}
    return out


def spec_dp_engine(mesh, params, d_params, prompts):
    """A draft at gamma 2 on a ("dp",) = (2,) mesh: tokens and the verify
    windows it ran."""
    eng, toks = _decode(params, prompts, 8, mesh, draft_params=d_params,
                        draft_cfg=D_CFG, gamma=2)
    return {"tokens": toks, "windows": eng.stats["spec_verify_windows"],
            "slot_axis": eng._slot_axis, "rows": [eng._rows.start,
                                                  eng._rows.stop]}


def fails(mesh):
    """A rank that raises (the launcher must report it)."""
    raise RuntimeError(f"rank {axis_rank(mesh, 'tp')} failed on purpose")
