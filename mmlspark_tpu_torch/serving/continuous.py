"""Continuous batching for autoregressive decoding (counterpart of
``serving/continuous.py:110-2180``, no speculation).

* a **static slot pool** — every occupied slot advances at its own
  position in the same decode step, so requests join mid-flight;
* **batched bucketed prefill** — same-bucket prompts admitted in one tick
  prefill as one dense causal forward, then drop into their slots;
* a **paged KV cache** (``serving/kv_pool.py``) with copy-on-write prefix
  sharing and defrag on retire, in the model dtype or quantized
  (``kv_dtype="int8"|"fp8"``: codes plus per-(page, head, position) bf16
  scales, dequantized inside the paged kernel);
* **chunked prefill** — prompts longer than ``prefill_chunk`` prefill in
  budget-bounded windows through the extend path, one per engine tick,
  interleaved with decode;
* **k steps per dispatch** with retirement (remaining budget, eos) inside
  the step loop on the device, and **pipelined dispatch**: up to
  ``pipeline_depth`` token blocks stay in flight before the oldest is
  copied to the host, with an eager drain when the pool is saturated.

PyTorch runs eagerly, so the reference's ``lru_cache``/``jax.jit``
program factories are plain methods here; the device work is ordered on
one CUDA stream and the host only waits at a drain (one device→host copy
per drained block) or when it uploads host state.

**Tensor-parallel serving** (``mesh=``, a ``DeviceMesh`` naming ``"tp"``,
or ``("dp", "tp")`` with dp = 1): one process per rank, every rank
running this same engine with the same ``submit``/``step`` calls in the
same order. The host scheduler is deterministic, so every rank keeps the
same block tables; each rank holds its ``shard_params`` slice of the
weights and its ``heads / tp`` shard of the pool, and the layer loop
all-reduces over the ``tp`` group after each row-parallel projection, so
every rank computes the same logits and tokens. Slot sharding over
``dp > 1`` is not ported.

Greedy decoding is the parity-tested mode: each request's tokens equal
the reference's ``generate_cached`` on its prompt alone. Sampled decoding
draws from a per-request ``torch.Generator`` seeded by the request's
``seed``: draw n feeds emitted token n, so a request's samples do not
depend on what else shares the pool (they differ from the reference's
threefry draws).
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.zoo.transformer import (TransformerConfig, _warp_scaled_rows,
                                      decode_step_paged, decode_window_paged,
                                      paged_scatter_rows, params_from_numpy,
                                      prefill_cache, shard_params)
from ..ops.kv_quant import (dequantize_kv, kv_store_dtype, quantize_kv,
                            resolve_kv_dtype)
from ..ops.padding import bucket_size
from ..ops.paged_attention import _bits
from ..parallel.mesh import axis_rank, axis_size, mesh_shape
from ..utils.device import resolve_device
from .kv_pool import PagedKVPool, PoolExhausted, prefix_hash as _prefix_hash

__all__ = ["ContinuousDecoder"]

_log = logging.getLogger("mmlspark_tpu_torch.serving")

_ROADMAP = "ROADMAP.md, 'Modules to port', slice 1 leftovers"


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to mmlspark_tpu_torch yet (queued in "
        f"{_ROADMAP})")


class _Request:
    __slots__ = ("rid", "prompt", "max_new", "tokens", "done", "event",
                 "submitted_at", "first_token_at", "finished_at",
                 "temperature", "top_k", "top_p", "seed",
                 "prefix_key", "prefix_len", "error")

    def __init__(self, rid, prompt, max_new, temperature=0.0, top_k=0,
                 top_p=1.0, seed=0):
        self.rid = rid
        self.prompt = prompt
        self.max_new = max_new
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)
        self.prefix_key: Optional[str] = None
        self.prefix_len: Optional[int] = None
        self.error: Optional[Exception] = None
        self.tokens: List[int] = []
        self.done = False
        self.event = threading.Event()
        self.submitted_at = time.perf_counter()
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None


def _sample_rows(logits, temp, top_k, top_p, uniform):
    """Per-row greedy or filtered sampling on (S, V) f32 logits: rows with
    ``temp <= 0`` take the argmax; the others warp (top-k, then top-p)
    and sample by the Gumbel-max rule from ``uniform`` (S, V) draws."""
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp(temp, min=1e-6)[:, None]
    filtered = _warp_scaled_rows(scaled, top_k, top_p)
    gumbel = -torch.log(-torch.log(uniform.clamp(min=1e-20)))
    sampled = torch.argmax(filtered + gumbel, dim=-1)
    return torch.where(temp <= 0.0, greedy, sampled).to(torch.int32)


def _quant_probe(rows: torch.Tensor, store_dtype):
    """Write-time quantization error: the relative RMS between the rows a
    quantized insert is about to scatter and their
    ``dequantize(quantize(.))`` round trip — the delta between what the
    quantized kernel reads back and what unquantized pages would hold."""
    x = rows.float()
    q, s = quantize_kv(x, store_dtype)
    d = dequantize_kv(q, s) - x
    err = torch.sqrt(torch.mean(d * d))
    ref = torch.sqrt(torch.mean(x * x))
    return float(err) / max(float(ref), 1e-12)


class ContinuousDecoder:
    """Slot-pool continuous-batching engine over the zoo decoder.

    ``submit()`` is thread-safe and returns a ticket; ``step()`` runs one
    engine tick (admit waiting prompts, one chunk of chunked prefill, one
    dispatch of k decode steps over every occupied slot, drain what the
    pipeline depth demands). Drive ``step()`` from a loop, or
    ``serve_forever()`` on a background thread (``start``/``stop``).

    ``params`` is a numpy param tree (``init_transformer``, or
    ``np.asarray`` of the reference's jax arrays), loaded once through
    ``params_from_numpy``; ``device=None`` means the CUDA card and raises
    without one.

    ``kv_dtype="int8"|"fp8"`` stores the pages quantized; every
    ``quant_probe``-th insert of prefill rows (0 = never) measures their
    round-trip error into the pool's ``quant_error_*`` stats (on a mesh,
    of this rank's heads).

    ``mesh`` (a ``DeviceMesh`` from ``parallel.mesh.make_mesh``, over a
    world from ``parallel.distributed.initialize``) serves tensor
    parallel: heads over ``"tp"``; every rank must run the same calls.
    A ``"dp"`` axis larger than 1 raises NotImplementedError."""

    def __init__(self, params: Dict, cfg: TransformerConfig, *,
                 device=None,
                 max_slots: int = 4, max_len: int = 256,
                 eos_id: Optional[int] = None,
                 prefix_cache_size: int = 8,
                 steps_per_dispatch: int = 1,
                 pipeline_depth: int = 2,
                 prefill_ahead: int = 0,
                 page_size: int = 16,
                 prefill_chunk: int = 256,
                 kv_pages: Optional[int] = None,
                 defrag_threshold: Optional[int] = None,
                 paged_attn: str = "kernel",
                 draft_params: Optional[Dict] = None,
                 kv_dtype: Optional[str] = None,
                 quant_probe: int = 64,
                 mesh=None, journal=None):
        if draft_params is not None:
            raise _not_ported("speculative decoding (draft_params)")
        if mesh is not None and axis_size(mesh, "dp") > 1:
            raise NotImplementedError(
                f"slot sharding over dp={axis_size(mesh, 'dp')} is not "
                f"ported to mmlspark_tpu_torch yet (queued in ROADMAP.md, "
                f"'Slice 6 leftovers')")
        if prefill_ahead:
            raise _not_ported("prefill-ahead staging (prefill_ahead > 0)")
        if journal is not None:
            raise _not_ported("durable sessions (journal)")
        if not cfg.causal:
            raise ValueError("ContinuousDecoder needs cfg.causal=True")
        if paged_attn not in ("kernel", "gather"):
            raise ValueError(f"unknown paged-attention impl {paged_attn!r} "
                             f"(choose 'kernel' or 'gather')")
        if cfg.position == "learned" and max_len > cfg.max_len:
            raise ValueError(
                f"max_len {max_len} exceeds the learned position table "
                f"cfg.max_len {cfg.max_len}")
        if steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        if pipeline_depth < 0:
            raise ValueError("pipeline_depth must be >= 0")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        if prefill_chunk < 8:
            raise ValueError("prefill_chunk must be >= 8")
        if quant_probe < 0:
            raise ValueError("quant_probe must be >= 0")
        #: "int8" / "fp8" quantized pages, or None
        self._kv_dtype = resolve_kv_dtype(kv_dtype)
        self._quant_probe = int(quant_probe) if self._kv_dtype else 0
        self._quant_inserts = 0
        self._dev = resolve_device(device)
        self._cfg = cfg
        self._S = int(max_slots)
        self._L = int(max_len)
        self._eos = eos_id
        self._k = int(steps_per_dispatch)
        self._depth = int(pipeline_depth)
        self._attn_impl = paged_attn
        #: the mesh, its head axis ("tp" when the mesh names one; no slot
        #: axis is sharded here), and its shape string ("tp2")
        self._mesh = mesh
        self._head_axis = ("tp" if mesh is not None
                           and "tp" in (mesh.mesh_dim_names or ())
                           else None)
        self._mesh_shape = mesh_shape(mesh)
        tp = axis_size(mesh, "tp")
        if self._head_axis is not None:
            params = shard_params(params, cfg, axis_rank(mesh, "tp"), tp)
        self._params = params_from_numpy(params, cfg, self._dev)
        #: (device token block (rows, cols), {col: (slot, request)} at
        #: dispatch time) per outstanding dispatch, oldest first
        self._pending: List[tuple] = []
        self._page = PagedKVPool.kernel_aligned_page_size(page_size)
        #: block-table width: logical pages per slot at full cache length
        self._P_max = -(-self._L // self._page)
        if kv_pages is None:
            kv_pages = (1 + self._S * self._P_max
                        + max(self._P_max, self._S))
        if kv_pages < 1 + self._P_max:
            raise ValueError(
                f"kv_pages {kv_pages} cannot hold one full-length slot "
                f"({self._P_max} pages + the trash page)")
        self._kv = PagedKVPool(cfg, num_pages=int(kv_pages),
                               page_size=self._page, kv_dtype=self._kv_dtype,
                               device=self._dev, tp=tp)
        self._chunk = int(prefill_chunk)
        self._defrag_thr = (max(1, self._kv.num_pages // 4)
                            if defrag_threshold is None
                            else max(1, int(defrag_threshold)))
        self._prefix_store_cap = int(prefix_cache_size)
        self.stats = {"prefills": 0, "prefix_hits": 0}
        #: host seconds of each step() that dispatched decode work
        self.tick_seconds: collections.deque = collections.deque(maxlen=4096)
        # per-call KV bytes of one sweep at worst-case length: what the
        # gather impl copies to materialize contiguous K/V (0 for the
        # kernel), over all shards, as one device counts it
        bpp = self._kv.bytes_per_position_global()
        self._gather_bytes_tick = self._S * self._L * bpp
        self._gather_bytes_extend = self._L * bpp
        self._slot_req: List[Optional[_Request]] = [None] * self._S
        self._waiting: List[_Request] = []
        self._lock = threading.Lock()          # guards _waiting/_next_rid
        self._engine_lock = threading.Lock()   # serializes step/cancel_all
        self._next_rid = 0
        self._stop = threading.Event()
        self._reset_device_state()

    # ---- device state ----
    def _h2d(self, arr, dtype=None) -> torch.Tensor:
        """Host array → device tensor without waiting for the stream (a
        pinned staging copy; the stream orders it after queued work)."""
        t = torch.from_numpy(np.array(arr, dtype=dtype, copy=True))
        if self._dev.type == "cpu":
            return t
        return t.pin_memory().to(self._dev, non_blocking=True)

    def _zeros(self, dtype, fill=0):
        return torch.full((self._S,), fill, dtype=dtype, device=self._dev)

    def _reset_device_state(self):
        """(Re)build the pool and every slot vector — at construction and
        in :meth:`cancel_all`."""
        self._kv.reset()
        self._bt_host = np.zeros((self._S, self._P_max), np.int32)
        self._bt = self._h2d(self._bt_host)
        self._slot_pages: List[Optional[List[int]]] = [None] * self._S
        #: slot → [request, prefill offset] for prompts mid-chunked-prefill
        self._chunking: Dict[int, list] = {}
        #: recent chunk sizes in tokens
        self._chunk_trace: List[int] = []
        self._prefix_store: Dict[str, tuple] = {}
        self._tok = self._zeros(torch.int32)
        self._pos = self._zeros(torch.int32)
        self._active = self._zeros(torch.bool, False)
        self._remaining = self._zeros(torch.int32)
        self._temp = self._zeros(torch.float32)
        self._topk = self._zeros(torch.int32)
        self._topp = self._zeros(torch.float32, 1.0)
        #: per-slot sampling generators (None for greedy requests)
        self._gens: List[Optional[torch.Generator]] = [None] * self._S

    # ---- client surface ----
    def submit(self, prompt_ids, max_new_tokens: int = 32, *,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, seed: int = 0,
               prefix_key: Optional[str] = None,
               prefix_len: Optional[int] = None) -> _Request:
        """Queue one request; returns its ticket. ``prefix_key`` turns on
        prefix caching: the first request with a key prefills normally and
        registers its first ``prefix_len`` positions (default: the whole
        prompt); later requests with the key — whose prompts must start
        with the stored tokens — share those pages and run one window
        forward over their suffix."""
        prompt = np.asarray(prompt_ids, dtype=np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if prompt.min() < 0 or prompt.max() >= self._cfg.vocab:
            raise ValueError(
                f"token ids must be in [0, {self._cfg.vocab}); got range "
                f"[{prompt.min()}, {prompt.max()}]")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (the prefill "
                             "itself emits the first token)")
        if prompt.size + max_new_tokens > self._L:
            raise ValueError(
                f"prompt {prompt.size} + max_new {max_new_tokens} exceeds "
                f"cache max_len {self._L}")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if top_k < 0 or temperature < 0.0:
            raise ValueError("top_k and temperature must be >= 0")
        if prefix_key is not None and not isinstance(prefix_key, str):
            raise ValueError(
                f"prefix_key must be a string, got {type(prefix_key).__name__}")
        if prefix_len is not None:
            if prefix_key is None:
                raise ValueError("prefix_len without prefix_key")
            if not 0 < prefix_len <= prompt.size:
                raise ValueError(
                    f"prefix_len {prefix_len} out of range for a "
                    f"{prompt.size}-token prompt")
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            req = _Request(rid, prompt, int(max_new_tokens),
                           temperature=temperature, top_k=top_k,
                           top_p=top_p, seed=seed)
            req.prefix_key = prefix_key
            req.prefix_len = prefix_len
            self._waiting.append(req)
        return req

    def result(self, req: _Request, timeout: Optional[float] = None):
        if not req.event.wait(timeout):
            raise TimeoutError(f"request {req.rid} not finished")
        if req.error is not None:
            raise req.error
        return list(req.tokens)

    def checkpoint_session(self, *args, **kwargs):
        raise _not_ported("session checkpoint (checkpoint_session)")

    def restore_session(self, *args, **kwargs):
        raise _not_ported("session restore (restore_session)")

    # ---- admission ----
    def _admit(self):
        """Move waiting requests into free slots. Plain requests admitted
        in one tick batch their prefill per pad bucket; prefix-cache
        requests take the per-request path; long prompts enter chunked
        prefill last."""
        while True:
            with self._lock:
                free = [i for i in range(self._S)
                        if self._slot_req[i] is None]
                batch = []
                while free and self._waiting:
                    slot = free.pop(0)
                    req = self._waiting.pop(0)
                    self._slot_req[slot] = req
                    batch.append((slot, req))
            if not batch:
                return
            plain, chunked, prefixed = [], [], []
            for s, r in batch:
                if r.prefix_key is not None:
                    prefixed.append((s, r))
                elif self._needs_chunk(r):
                    chunked.append((s, r))
                else:
                    plain.append((s, r))
            by_bucket: Dict[int, list] = {}
            for s, r in plain:
                by_bucket.setdefault(self._bucket(r.prompt.size),
                                     []).append((s, r))
            # on a failed insertion, the failed group and every assigned but
            # uninserted request go back to the queue together
            groups = list(by_bucket.values())
            for gi, group in enumerate(groups):
                logits, row_cache = self._prefill_group([r for _, r in group])
                if not self._insert_rows(group, logits, row_cache):
                    self._requeue([p for g in groups[gi:] for p in g]
                                  + prefixed + chunked)
                    return
            for pi, (slot, req) in enumerate(prefixed):
                try:
                    ok = self._admit_prefixed(slot, req)
                except ValueError as e:
                    # request-level validation fails alone
                    req.error = e
                    req.done = True
                    req.finished_at = time.perf_counter()
                    req.event.set()
                    self._release_locked(slot)
                    continue
                if not ok:
                    self._requeue(prefixed[pi:] + chunked)
                    return
            for i, (slot, req) in enumerate(chunked):
                if not self._begin_chunked(slot, req):
                    self._requeue(chunked[i:])
                    return

    def _prefill_group(self, reqs):
        """ONE batched prefill over same-bucket requests: zero-padded ids,
        power-of-two row pad, pad rows length 1. Returns (logits,
        row_cache); rows past ``len(reqs)`` are padding."""
        padded = self._bucket(max(r.prompt.size for r in reqs))
        k = 1 << (len(reqs) - 1).bit_length()
        ids = np.zeros((k, padded), np.int32)
        lengths = np.ones(k, np.int32)
        for i, r in enumerate(reqs):
            ids[i, :r.prompt.size] = r.prompt
            lengths[i] = r.prompt.size
        logits, row_cache = prefill_cache(self._params, self._h2d(ids),
                                          self._h2d(lengths), self._cfg,
                                          self._L, **self._tp_kw())
        self.stats["prefills"] += 1
        return logits, row_cache

    # ---- page bookkeeping ----
    def _need(self, prompt_len: int, max_new: int) -> int:
        """Cache positions a request must own: prompt + every emittable
        token."""
        return prompt_len + max_new

    def _upload_bt(self):
        self._bt = self._h2d(self._bt_host)

    def _set_bt_row(self, slot: int, pages, upload: bool = True):
        self._bt_host[slot, :] = 0
        self._bt_host[slot, :len(pages)] = pages
        if upload:
            self._upload_bt()

    def _alloc_with_pressure(self, n: int,
                             protect: Optional[str] = None) -> List[int]:
        """Allocate ``n`` pages, evicting cached prefixes oldest-first
        under pressure (``protect`` shields the key being admitted)."""
        while True:
            try:
                return self._kv.alloc(n, count_failure=False)
            except PoolExhausted:
                victim = next((k for k in self._prefix_store
                               if k != protect), None)
                if victim is None:
                    self._kv.note_alloc_failure()
                    raise
                _, phash, _ = self._prefix_store.pop(victim)
                self._kv.release_prefix(phash)

    def _ensure_pages(self, group):
        """Allocate pages + block-table rows for every slot in ``group``
        that has none yet; all-or-nothing."""
        fresh = []
        try:
            for slot, req in group:
                if self._slot_pages[slot] is not None:
                    continue
                n = self._kv.pages_per_slot(
                    self._need(req.prompt.size, req.max_new))
                fresh.append((slot, self._alloc_with_pressure(n)))
        except PoolExhausted:
            for _, pages in fresh:
                self._kv.free(pages)
            raise
        for slot, pages in fresh:
            self._slot_pages[slot] = pages
            self._set_bt_row(slot, pages, upload=False)
        if fresh:
            self._upload_bt()

    def _requeue(self, group):
        """Back out an admission the pool couldn't hold: slots freed,
        requests back at the FRONT of the queue, order intact."""
        with self._lock:
            self._waiting[:0] = [r for _, r in group]
            for slot, _ in group:
                self._slot_req[slot] = None

    def _insert_rows(self, group, logits, row_cache) -> bool:
        """Pages, slot insertion and first tokens for an admitted group;
        False (nothing inserted) when the pool cannot hold it."""
        try:
            self._ensure_pages(group)
        except PoolExhausted:
            return False
        g = len(group)
        self._insert_chunk_locked(
            group, logits[:g],
            [{kk: c[kk][:g] for kk in ("k", "v")} for c in row_cache])
        return True

    def _insert_chunk_locked(self, group, logits, rows_t):
        """Scatter prefill rows into the slots' pages (``rows_t`` empty for
        prefix hits and chunked prefills, whose K/V is already written),
        set the per-slot decode state, and queue the first tokens on the
        drain pipeline. Pages must already be assigned."""
        g = len(group)
        slots = [s for s, _ in group]
        reqs = [r for _, r in group]
        slots_v = self._h2d(slots, np.int64)
        lens_v = self._h2d([r.prompt.size for r in reqs], np.int32)
        rems_v = self._h2d([r.max_new - 1 for r in reqs], np.int32)
        temps_v = self._h2d([r.temperature for r in reqs], np.float32)
        topks_v = self._h2d([r.top_k for r in reqs], np.int32)
        topps_v = self._h2d([r.top_p for r in reqs], np.float32)
        for slot, r in group:
            self._gens[slot] = (
                torch.Generator(device=self._dev).manual_seed(r.seed)
                if r.temperature > 0.0 else None)
        firsts = self._pick(logits[:g].float(), temps_v, topks_v, topps_v,
                            [self._gens[s] for s in slots])
        if rows_t and self._quant_probe:
            # sampled write-time probe: every quant_probe'th insert of
            # prefill rows round-trips layer 0's keys (one host sync)
            self._quant_inserts += 1
            if self._quant_inserts % self._quant_probe == 0:
                self._kv.note_quant_error(_quant_probe(
                    rows_t[0]["k"], kv_store_dtype(self._kv_dtype)))
        if rows_t:
            n_pages = -(-rows_t[0]["k"].shape[2] // self._page)
            page_rows = self._h2d(self._bt_host[slots, :n_pages], np.int64)
            paged_scatter_rows(self._kv.buffers, rows_t, page_rows,
                               self._page)
        self._tok[slots_v] = firsts
        self._pos[slots_v] = lens_v
        self._active[slots_v] = True
        self._remaining[slots_v] = rems_v
        self._temp[slots_v] = temps_v
        self._topk[slots_v] = topks_v
        self._topp[slots_v] = topps_v
        # first tokens ride the drain pipeline as a (1, g) block, queued
        # before any later tick block so drain order is emission order
        self._pending.append((firsts.reshape(1, -1),
                              {i: (slot, req)
                               for i, (slot, req) in enumerate(group)}))
        if len(self._pending) == 1:
            self._drain_one()

    def _pick(self, logits, temp, topk, topp, gens):
        """Next tokens for (S, V) logits: argmax when no row samples, else
        :func:`_sample_rows` with one uniform draw per sampling row from
        its own generator."""
        if all(g is None for g in gens):
            return torch.argmax(logits, dim=-1).to(torch.int32)
        u = torch.full_like(logits, 0.5)
        for i, g in enumerate(gens):
            if g is not None:
                u[i] = torch.rand(logits.shape[1], generator=g,
                                  device=self._dev)
        return _sample_rows(logits, temp, topk, topp, u)

    def _bucket(self, n: int, cap: Optional[int] = None) -> int:
        """THE pad-bucket policy (batched admission, prefix suffix windows
        and chunk windows all share it)."""
        return min(cap if cap is not None else self._L,
                   max(8, bucket_size(n)))

    def _padded_ids(self, tokens: np.ndarray, cap: int) -> np.ndarray:
        ids = np.zeros((1, self._bucket(tokens.size, cap)), np.int32)
        ids[0, :tokens.size] = tokens
        return ids

    def _tp_kw(self) -> dict:
        """The mesh arguments of the model calls: heads only (a slot axis
        is never sharded here, and an extend's one row could not be)."""
        if self._mesh is None:
            return {}
        return {"mesh": self._mesh, "head_axis": self._head_axis}

    def _extend(self, ids: np.ndarray, start: int, slot: int):
        """Window forward over one slot's pages (prefix suffix or prefill
        chunk); returns the window logits (1, W, vocab)."""
        logits, _ = decode_window_paged(
            self._params, self._h2d(ids), self._h2d([start], np.int32),
            self._kv.buffers, self._bt[slot:slot + 1], self._cfg,
            page_size=self._page, length=self._L, active=None,
            impl=self._attn_impl, **self._tp_kw())
        self._kv.note_attn_tick(
            self._attn_impl,
            gather_bytes=(self._gather_bytes_extend
                          if self._attn_impl == "gather" else 0))
        return logits

    def _admit_prefixed(self, slot: int, req: _Request) -> bool:
        """Admit a ``prefix_key`` request into ``slot``. Hit: share the
        stored prefix's whole pages, copy the boundary page, extend over
        the suffix. Miss: full prefill, then register the prefix pages.
        Raises ValueError on a prefix mismatch; False when the pool
        cannot hold the request."""
        P = req.prompt.size
        hit = self._prefix_store.get(req.prefix_key)
        if hit is not None:
            stored_toks, phash, plen = hit
            if req.prefix_len is not None:
                plen = min(plen, req.prefix_len)
            if P < plen or not np.array_equal(req.prompt[:plen],
                                              stored_toks[:plen]):
                raise ValueError(
                    f"prefix_key {req.prefix_key!r}: prompt does not "
                    f"start with the stored {plen}-token prefix")
            # whole-prompt hits re-run the last prefix token for its logits
            start = plen if P > plen else plen - 1
            s0 = start // self._page
            n_total = self._kv.pages_per_slot(self._need(P, req.max_new))
            try:
                private = self._alloc_with_pressure(
                    n_total - s0, protect=req.prefix_key)
            except PoolExhausted:
                return False
            pages_stored, _ = self._kv.acquire_prefix(phash, s0)
            shared = list(pages_stored[:s0])
            n_copy = -(-plen // self._page) - s0
            if n_copy > 0:
                # every buffer of the layer: a quantized page is copied
                # with its scales
                src = self._h2d(pages_stored[s0:s0 + n_copy], np.int64)
                dst = self._h2d(private[:n_copy], np.int64)
                for c in self._kv.buffers:
                    for buf in c.values():
                        _bits(buf)[dst] = _bits(buf)[src]
            self._slot_pages[slot] = shared + private
            self._set_bt_row(slot, shared + private)
            self.stats["prefix_hits"] += 1
            self._prefix_store[req.prefix_key] = \
                self._prefix_store.pop(req.prefix_key)
            suffix = req.prompt[start:]
            w_logits = self._extend(self._padded_ids(suffix, self._L - start),
                                    start, slot)
            self._insert_chunk_locked([(slot, req)],
                                      w_logits[:, suffix.size - 1], [])
            return True
        try:
            self._ensure_pages([(slot, req)])
        except PoolExhausted:
            return False
        ids = self._padded_ids(req.prompt, self._L)
        logits, row_cache = prefill_cache(
            self._params, self._h2d(ids), self._h2d([P], np.int32),
            self._cfg, self._L, **self._tp_kw())
        self.stats["prefills"] += 1
        self._insert_chunk_locked([(slot, req)], logits, row_cache)
        if self._prefix_store_cap > 0:
            # register after the insert wrote the rows; the slot's later
            # writes land at positions >= P >= plen, outside the prefix
            plen = req.prefix_len if req.prefix_len is not None else P
            phash = _prefix_hash(req.prompt[:plen])
            self._kv.register_prefix(
                phash, self._slot_pages[slot][:-(-plen // self._page)],
                plen)
            if len(self._prefix_store) >= self._prefix_store_cap:
                _, old_hash, _ = self._prefix_store.pop(
                    next(iter(self._prefix_store)))
                self._kv.release_prefix(old_hash)
            self._prefix_store[req.prefix_key] = (
                req.prompt[:plen].copy(), phash, plen)
        return True

    # ---- chunked prefill ----
    def _needs_chunk(self, req: _Request) -> bool:
        return req.prefix_key is None and req.prompt.size > self._chunk

    def _begin_chunked(self, slot: int, req: _Request) -> bool:
        """Assign pages and park the request in the chunk scheduler: the
        slot is occupied but device-inactive until its last chunk."""
        try:
            self._ensure_pages([(slot, req)])
        except PoolExhausted:
            return False
        self._chunking[slot] = [req, 0]
        return True

    def _advance_chunks(self):
        """Run ONE prefill chunk for the oldest prefilling slot; the final
        chunk computes the first token and activates the slot."""
        if not self._chunking:
            return
        slot = next(iter(self._chunking))
        req, off = self._chunking[slot]
        P = req.prompt.size
        w = min(self._chunk, P - off)
        w_logits = self._extend(
            self._padded_ids(req.prompt[off:off + w], self._L - off),
            off, slot)
        self._kv.note_prefill_chunk(w)
        self._chunk_trace.append(w)
        off += w
        if off < P:
            self._chunking[slot][1] = off
            return
        del self._chunking[slot]
        self.stats["prefills"] += 1
        self._insert_chunk_locked([(slot, req)], w_logits[:, w - 1], [])

    # ---- retirement ----
    def _note_token(self, req: _Request, tok: int):
        now = time.perf_counter()
        if req.first_token_at is None:
            req.first_token_at = now
        req.tokens.append(tok)
        if ((self._eos is not None and tok == self._eos)
                or len(req.tokens) >= req.max_new):
            req.done = True
            req.finished_at = now
            req.event.set()

    def _release_locked(self, slot: int):
        self._slot_req[slot] = None
        self._active[slot] = False
        self._gens[slot] = None
        self._chunking.pop(slot, None)
        pages = self._slot_pages[slot]
        if pages:
            # the device block-table row stays stale on purpose: queued
            # ticks captured it, and later ticks see active=False, which
            # writes nothing
            self._kv.free(pages)
            self._slot_pages[slot] = None
            self._bt_host[slot, :] = 0
            self._maybe_compact()

    def _maybe_compact(self):
        """Defrag on retire: pack live pages dense with one gather per
        buffer (scale pools move with their pages) and remap every host
        page reference."""
        if not self._kv.should_compact(self._defrag_thr):
            return
        remap = self._kv.compact()
        if remap is None:
            return
        perm = np.empty_like(remap)
        perm[remap] = np.arange(remap.size)
        perm_d = self._h2d(perm, np.int64)
        for c in self._kv.buffers:
            for kk, buf in c.items():
                c[kk] = _bits(buf)[perm_d].view(buf.dtype)
        self._bt_host = remap[self._bt_host].astype(np.int32)
        self._slot_pages = [
            None if p is None else [int(remap[x]) for x in p]
            for p in self._slot_pages]
        self._upload_bt()

    # ---- the decode tick ----
    def _tick(self, decode_live: List[int]) -> torch.Tensor:
        """k paged decode steps over every slot; retirement (remaining,
        eos) runs on the device inside the loop, so a slot that finishes
        mid-dispatch stops advancing. Returns the (k, S) token block."""
        sample = any(self._slot_req[i].temperature > 0.0
                     for i in decode_live)
        gens = [self._gens[i] if i in decode_live else None
                for i in range(self._S)]
        tok, pos = self._tok, self._pos
        active, remaining = self._active, self._remaining
        toks = []
        for _ in range(self._k):
            logits, _ = decode_step_paged(
                self._params, tok, pos, self._kv.buffers, self._bt,
                self._cfg, page_size=self._page, length=self._L,
                active=active, impl=self._attn_impl, **self._tp_kw())
            if sample:
                nxt = self._pick(logits, self._temp, self._topk, self._topp,
                                 gens)
            else:
                nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            nxt = torch.where(active, nxt, tok)
            pos = torch.where(active, pos + 1, pos)
            remaining = torch.where(active, remaining - 1, remaining)
            fin = remaining <= 0
            if self._eos is not None:
                fin = fin | (nxt == self._eos)
            active = active & ~fin
            tok = nxt
            toks.append(nxt)
        self._tok, self._pos = tok, pos
        self._active, self._remaining = active, remaining
        return torch.stack(toks)

    def step(self) -> int:
        """One engine tick; returns the number of live slots stepped."""
        with self._engine_lock:
            return self._step_locked()

    def _step_locked(self) -> int:
        # eager drain under saturation: with requests queued and every slot
        # occupied, only a drained retirement frees a slot
        with self._lock:
            backlog = bool(self._waiting)
        if backlog:
            while (self._pending
                   and all(self._slot_req[i] is not None
                           for i in range(self._S))
                   and self._retirement_in_flight()):
                self._drain_one()
        self._admit()
        self._advance_chunks()
        live = [i for i in range(self._S) if self._slot_req[i] is not None]
        if not live:
            if self._pending:
                self._drain_one()
                return 1
            return 0
        # slots mid-chunked-prefill are occupied but device-inactive
        decode_live = [i for i in live if i not in self._chunking]
        if not decode_live:
            while len(self._pending) > self._depth:
                self._drain_one()
            return len(live)
        t0 = time.perf_counter()
        toks = self._tick(decode_live)
        self._kv.note_attn_tick(
            self._attn_impl, calls=self._k,
            gather_bytes=(self._k * self._gather_bytes_tick
                          if self._attn_impl == "gather" else 0))
        # snapshot slot → REQUEST: a slot may be re-admitted before this
        # block drains; tokens go to the request that held it at dispatch
        self._pending.append((toks, {i: (i, self._slot_req[i])
                                     for i in decode_live}))
        while len(self._pending) > self._depth:
            self._drain_one()
        self.tick_seconds.append(time.perf_counter() - t0)
        return len(live)

    def _retirement_in_flight(self) -> bool:
        """True iff some occupied slot could finish inside the outstanding
        blocks (always, with eos enabled)."""
        if self._eos is not None:
            return True
        horizon = self._k * len(self._pending)
        return any(req is not None
                   and req.max_new - len(req.tokens) <= horizon
                   for req in self._slot_req)

    def _drain_one(self):
        """Copy the oldest outstanding token block to the host (the decode
        path's one device→host sync) and replay it in emission order."""
        toks_dev, snapshot = self._pending.pop(0)
        toks = toks_dev.cpu().numpy()
        for s in range(toks.shape[0]):
            for col, (_, req) in snapshot.items():
                if req.done:
                    continue
                self._note_token(req, int(toks[s, col]))
        for _, (slot, req) in snapshot.items():
            if req.done and self._slot_req[slot] is req:
                self._release_locked(slot)

    def flush(self):
        """Drain every outstanding dispatch."""
        with self._engine_lock:
            while self._pending:
                self._drain_one()

    def cancel_all(self):
        """Fail every waiting and in-flight request and rebuild the device
        state (the owner's recovery when :meth:`step` keeps raising).
        Returns the cancelled requests; their ``tokens`` hold whatever was
        emitted before the cancel."""
        with self._engine_lock:
            with self._lock:
                waiting, self._waiting = self._waiting, []
            cancelled = list(waiting)
            self._pending.clear()
            for i in range(self._S):
                req = self._slot_req[i]
                if req is not None:
                    self._slot_req[i] = None
                    cancelled.append(req)
            self._reset_device_state()
        now = time.perf_counter()
        for req in cancelled:
            req.done = True
            req.finished_at = now
            req.event.set()
        return cancelled

    def serve_forever(self, idle_sleep: float = 0.002,
                      max_failures: int = 3,
                      failure_backoff: float = 0.05):
        """Engine loop with crash containment: a failing step() backs off
        exponentially; after ``max_failures`` in a row every in-flight
        request is cancelled and the loop keeps serving."""
        failures = 0
        while not self._stop.is_set():
            try:
                stepped = self.step()
            except Exception:
                failures += 1
                _log.exception("continuous step failed (%d in a row)",
                               failures)
                if failures >= max_failures:
                    try:
                        self.cancel_all()
                    except Exception:
                        _log.exception("continuous cancel_all failed")
                    failures = 0
                self._stop.wait(min(failure_backoff * (2 ** failures), 1.0))
                continue
            failures = 0
            if stepped == 0:
                self._stop.wait(idle_sleep)

    def start(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True,
                             name="continuous-decoder")
        t.start()
        return t

    def stop(self):
        self._stop.set()

