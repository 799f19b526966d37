"""Continuous batching for autoregressive decoding (counterpart of
``serving/continuous.py:110-2180``).

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
  copied to the host, with an eager drain when the pool is saturated;
* **speculative decoding** (``draft_params`` + ``draft_cfg``): each of the
  k rounds of a dispatch, the draft proposes ``gamma`` tokens per slot
  from a contiguous draft slot pool, the target verifies every slot's
  ``gamma + 1``-token window in one paged window forward (K1/K2 on the
  card), and each slot keeps its own accepted prefix plus one token;
* **the autotuner** (``autotune=True``, :class:`KVAutotuner`): gamma
  follows acceptance, the chunk budget and pipeline depth occupancy;
* **prefill-ahead** (``prefill_ahead=N``): while every slot is occupied,
  the leading run of waiting same-bucket prompts prefills right after a
  decode dispatch and parks its (logits, KV rows) on the device, at most
  N padded rows; retiring slots re-fill from the staged units with one
  insert, no prefill on the admission path;
* **durable sessions** (``journal=``, a :class:`ServingJournal`): every
  submit is journaled write-ahead (``sess``), each drain appends one
  ``tail`` record per session and retirement a ``sess_end``;
  :meth:`ContinuousDecoder.checkpoint_session` snapshots a live request
  (its canonical session and, when it holds written pages, their
  exported blob) and :meth:`ContinuousDecoder.restore_session` rebuilds
  it on another engine, cold (re-prefill of prompt + emitted tokens) or
  warm (adopting the pages: nothing re-prefilled);
* **the observability plane** — each request captures its cost class,
  trace id and span at submit (the engine's ticks run outside the
  caller's context), so its ``prefill_chunk`` / ``session_adopt`` events
  and the ``continuous.prefill_chunk`` span land in its trace, and the
  cost ledger bills ``device_seconds`` (host wall around each dispatch,
  shared by the requests that rode it) and ``kv_page_seconds`` to it.
  The drain, the decode path's one device→host sync, runs under the
  stall watchdog; a quantized pool's probe reaches the SLO tracker under
  ``slo_model``.

PyTorch runs eagerly, so the reference's ``lru_cache``/``jax.jit``
program factories are plain methods here; the device work is ordered on
one CUDA stream and the host only waits at a drain (one device→host copy
per drained block) or when it uploads host state.

**Serving on a mesh** (``mesh=``, a ``DeviceMesh`` naming ``"tp"``,
``"dp"`` or both, as the JAX engine's): one process per rank, every
rank running this same engine with the same ``submit``/``step`` calls
in the same order. Heads shard over ``tp``: each rank holds its
``shard_params`` slice of the weights and its ``heads / tp`` shard of
the pool, and the layer loop all-reduces over the ``tp`` group after
each row-parallel projection. Slots shard over ``dp`` when ``dp > 1``
divides ``max_slots`` (else the rows replicate): each rank computes the
device rows of its own ``max_slots / dp`` slots, while the page pool
replicates over ``dp`` (the mount writes every dp shard's fresh rows on
every replica, :func:`~mmlspark_tpu_torch.ops.paged_attention.paged_attention_window`).
Each dispatch ends with one all-gather of every dp shard's tokens and
slot state, so every rank holds the same slot table, waiting queue and
page allocation. Prefills and chunked-prefill extends (one B = 1 row)
replicate over ``dp``, as in the JAX engine. With a draft, the draft is
replicated (every rank holds its weights and runs it on its own rows)
and the verify windows run through the mount.

No host decision reads a rank's own clock: admission, chunking,
prefill-ahead staging, the drains, ``_maybe_compact`` and the
:class:`KVAutotuner` read the queue, the slot table, the pool and the
drained tokens, which are the same on every rank; the clocks feed only
the ledger, the metrics and ``tick_seconds``.

Greedy decoding is the parity-tested mode: each request's tokens equal
the reference's ``generate_cached`` on its prompt alone, with or without
a draft. Sampled decoding takes its uniforms from a counter-based hash of
(the request's ``seed``, the absolute position of the token drawn, the
draw's purpose, the vocabulary lane) — :func:`_uniforms`, computed on the
device for every row at once — so a request's samples do not depend on
what else shares the pool, and a session restored at emit position n
(cold or warm) continues the uninterrupted run's draws, as the
reference's ``fold_in(key, position)`` schedule does (the values differ
from the reference's threefry draws). With a draft, each round's draws
are keyed as the reference keys them (proposal i at ``pos + i + 1``,
acceptance j at ``pos + j + 1``, the resample at ``pos + k + 1``, each
under its own purpose), and the output is distributed as the target's
own sampling is (the speculative-sampling correction).
"""

from __future__ import annotations

import collections
import logging
import math
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.zoo.transformer import (TransformerConfig, _gumbel_argmax,
                                      _uniforms, _warp_scaled_rows,
                                      decode_step_paged,
                                      decode_step_ragged_inplace,
                                      decode_window_paged,
                                      paged_scatter_rows, params_from_numpy,
                                      prefill_cache, shard_params)
from ..observability import (charge as _ledger_charge,
                             counter as _metric_counter,
                             gauge as _metric_gauge,
                             get_ledger as _get_ledger,
                             histogram as _metric_histogram,
                             resolve_context as _resolve_cost_ctx,
                             watch as _watch)
from ..observability import tracing as _tracing
from ..observability.slo import get_tracker as _slo_tracker
from ..ops.kv_quant import (dequantize_kv, kv_store_dtype, quantize_kv,
                            resolve_kv_dtype)
from ..ops.padding import bucket_size
from ..ops.paged_attention import _bits
from ..parallel.mesh import (axis_rank, axis_size, gather_rows_many,
                             mesh_shape)
from ..reliability.faults import get_injector as _get_injector
from ..reliability.lock_sanitizer import new_lock
from ..utils.device import resolve_device
from ..utils.profiling import span as _prof_span
from .kv_pool import (KVAutotuner, PagedKVPool, PoolExhausted,
                      prefix_hash as _prefix_hash)

__all__ = ["ContinuousDecoder"]

_log = logging.getLogger("mmlspark_tpu_torch.serving")

_M_DRAIN_SECONDS = _metric_histogram(
    "mmlspark_continuous_drain_seconds",
    "Host fetch latency of one outstanding (k, S) token block — the only "
    "host<->device sync on the decode path")
_M_LIVE_SLOTS = _metric_gauge(
    "mmlspark_continuous_live_slots",
    "Occupied decode slots at the latest step (batch size on device)")
_M_PREFILLS = _metric_counter(
    "mmlspark_continuous_prefills_total",
    "Full prompt prefills executed (grouped prefills count once)")
_M_PREFIX_HITS = _metric_counter(
    "mmlspark_continuous_prefix_hits_total",
    "Prompts served from the prefix cache via a suffix window")


class _Request:
    __slots__ = ("rid", "prompt", "max_new", "tokens", "done", "event",
                 "submitted_at", "first_token_at", "finished_at",
                 "temperature", "top_k", "top_p", "seed",
                 "prefix_key", "prefix_len", "error",
                 "cost_cls", "cost_trace", "span",
                 "session_id", "pre_emitted", "journaled")

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
        # cost class, trace id and span, captured at submit (the engine's
        # ticks run outside the request's trace context)
        self.cost_cls, self.cost_trace = _resolve_cost_ctx()
        self.span = _tracing.current_span()
        #: durable-session identity (journal key; defaults to the rid)
        self.session_id: str = str(rid)
        #: tokens emitted by a previous incarnation of this session: a
        #: restored request generates only the remainder (the full
        #: completion is ``ContinuousDecoder.session_result``)
        self.pre_emitted: List[int] = []
        #: how many of ``tokens`` have reached the journal's tail records
        #: (-1 once the session is closed)
        self.journaled = 0


def _seed64(seed: int) -> int:
    """A request seed as the signed int64 the device keeps."""
    s = int(seed) % (1 << 64)
    return s - (1 << 64) if s >= (1 << 63) else s


def _sample_rows(logits, temp, top_k, top_p, uniform):
    """Per-row greedy or filtered sampling on (S, V) f32 logits: rows with
    ``temp <= 0`` take the argmax; the others warp (top-k, then top-p)
    and sample by the Gumbel-max rule from ``uniform`` (S, V) draws."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / torch.clamp(temp, min=1e-6)[:, None]
    sampled = _gumbel_argmax(_warp_scaled_rows(scaled, top_k, top_p),
                             uniform)
    return torch.where(temp <= 0.0, greedy, sampled)


def _spec_accept(greedy, drafts, temp=None, t_logp=None, d_logp=None,
                 u_acc=None, u_res=None):
    """One verify round's decision for every row → (accepted drafts k
    (S,) int32, the token that follows them (S,) int32).

    ``greedy`` (S, g+1) holds the target's argmax at each window position
    and ``drafts`` (S, g) the proposals. A greedy round (``t_logp`` None,
    and rows with ``temp <= 0``) accepts while the proposal is the
    target's argmax and ends on the target's argmax. A sampled row
    accepts proposal x with probability min(1, p_t(x) / p_d(x)) (``u_acc``
    (S, g) uniforms; ``t_logp`` (S, g+1, V) and ``d_logp`` (S, g, V) the
    warped log-probabilities) and ends on a draw (``u_res`` (S, V)
    uniforms, or a function of the accepted counts k that returns them)
    from the normalized residual max(p_t - p_d, 0) at its first
    rejection, or from p_t after it accepted all g — so its tokens are
    distributed as p_t's."""
    g = drafts.shape[1]
    accepts = greedy[:, :g] == drafts
    if t_logp is not None:
        d_idx = drafts.long()[..., None]
        lp_t = t_logp[:, :g].gather(-1, d_idx)[..., 0]
        lp_d = d_logp.gather(-1, d_idx)[..., 0]
        acc_s = torch.log(u_acc.clamp(min=1e-38)) < lp_t - lp_d
        accepts = torch.where(temp[:, None] > 0.0, acc_s, accepts)
    k = torch.cumprod(accepts.to(torch.int32), dim=-1).sum(
        dim=-1, dtype=torch.int32)
    final = greedy.gather(1, k.long()[:, None])[:, 0]
    if t_logp is not None:
        rows = torch.arange(k.shape[0], device=k.device)
        p_t_k = torch.exp(t_logp[rows, k.long()])
        d_pad = torch.cat([d_logp, torch.full_like(d_logp[:, :1],
                                                   -math.inf)], dim=1)
        resid = (p_t_k - torch.exp(d_pad[rows, k.long()])).clamp(min=0.0)
        tot = resid.sum(dim=-1, keepdim=True)
        resid = torch.where(tot > 1e-30, resid / tot, p_t_k)
        if callable(u_res):
            u_res = u_res(k)
        resampled = _gumbel_argmax(torch.log(resid.clamp(min=1e-38)), u_res)
        final = torch.where(temp > 0.0, resampled, final)
    return k, final


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
    world from ``parallel.distributed.initialize``) serves on a mesh:
    heads over ``"tp"``, slots over ``"dp"`` (see the module docstring);
    every rank must run the same calls.

    ``draft_params`` (a numpy param tree) with ``draft_cfg`` turns on
    speculative decoding at ``gamma`` draft tokens a round (the draft
    causal, dense, on the target's vocabulary; replicated on a mesh);
    ``autotune=True`` runs the :class:`KVAutotuner`, which walks gamma up
    to ``max(gamma, 8)`` (every slot's pages and the draft pool are sized
    for that ceiling), the chunk budget and the pipeline depth.

    ``prefill_ahead`` (rows, 0 = off) stages waiting prefills on the
    device while the pool is full; ``journal`` (a
    :class:`~mmlspark_tpu_torch.serving.journal.ServingJournal`) makes
    every session durable (see the module docstring)."""

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
                 draft_cfg: Optional[TransformerConfig] = None,
                 gamma: int = 4,
                 autotune: bool = False,
                 kv_dtype: Optional[str] = None,
                 quant_probe: int = 64,
                 slo_model: str = "default",
                 mesh=None, journal=None):
        #: speculative mode: the draft proposes gamma tokens a round per
        #: slot, the target verifies every slot's window in one forward
        self._spec = draft_params is not None
        if prefill_ahead < 0:
            raise ValueError("prefill_ahead must be >= 0")
        if not cfg.causal:
            raise ValueError("ContinuousDecoder needs cfg.causal=True")
        if self._spec:
            if draft_cfg is None:
                raise ValueError("draft_params without draft_cfg")
            if draft_cfg.vocab != cfg.vocab:
                raise ValueError("draft and target must share a vocabulary")
            if not draft_cfg.causal or draft_cfg.moe_experts:
                raise ValueError("draft must be causal and dense")
            if draft_cfg.position == "learned" and max_len > draft_cfg.max_len:
                # the draft's positions past its table would clamp: its
                # proposals, and so the acceptance, would silently degrade
                raise ValueError(
                    f"max_len {max_len} exceeds the draft's learned position "
                    f"table draft_cfg.max_len {draft_cfg.max_len}")
        if gamma < 1:
            # checked without a draft too, as the reference does
            raise ValueError("gamma must be >= 1")
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
        #: the SLO model label the quant probe reports under
        self._slo_model = str(slo_model)
        self._dev = resolve_device(device)
        if self._dev.type == "cuda" and self._dev.index is None:
            # the card this thread has now (a rank's, on a mesh), by
            # index: an engine thread started later starts on card 0
            self._dev = torch.device("cuda", torch.cuda.current_device())
        self._cfg = cfg
        self._S = int(max_slots)
        self._L = int(max_len)
        self._eos = eos_id
        self._k = int(steps_per_dispatch)
        self._depth = int(pipeline_depth)
        self._gamma = int(gamma)
        #: the autotuner walks gamma up to this ceiling; the headroom, the
        #: page counts and the retirement horizon are sized for it
        self._gamma_max = (max(self._gamma, 8) if (autotune and self._spec)
                           else self._gamma)
        self._d_cfg = draft_cfg
        #: cache positions a slot spans: a verify window writes all
        #: gamma + 1 positions even when fewer remain before max_new
        self._Lc = self._L + (self._gamma_max + 1 if self._spec else 0)
        self._attn_impl = paged_attn
        #: the mesh, its head axis ("tp" when the mesh names one), its
        #: slot axis ("dp" when dp > 1 divides the slots: the JAX rules,
        #: JAX continuous.py:683-697) and its shape string ("dp2xtp2")
        self._mesh = mesh
        self._head_axis = ("tp" if mesh is not None
                           and "tp" in (mesh.mesh_dim_names or ())
                           else None)
        dp = axis_size(mesh, "dp")
        self._slot_axis = "dp" if dp > 1 and self._S % dp == 0 else None
        self._mesh_shape = mesh_shape(mesh)
        #: the slots whose device rows this rank computes (all of them
        #: unless slots shard over dp)
        n_rows = self._S // dp if self._slot_axis else self._S
        lo = axis_rank(mesh, "dp") * n_rows if self._slot_axis else 0
        self._rows = slice(lo, lo + n_rows)
        tp = axis_size(mesh, "tp")
        if self._head_axis is not None:
            params = shard_params(params, cfg, axis_rank(mesh, "tp"), tp)
        self._params = params_from_numpy(params, cfg, self._dev)
        if self._spec:
            self._d_params = params_from_numpy(draft_params, draft_cfg,
                                               self._dev)
        #: (device token block (rows, cols), {col: (slot, request)} at
        #: dispatch time) per outstanding dispatch, oldest first
        self._pending: List[tuple] = []
        #: prefill-ahead budget in padded rows (0 = off) and the staged
        #: units: [requests, logits, target rows, draft rows, next offset]
        self._stage_cap = int(prefill_ahead)
        self._staged: List[list] = []
        #: the durable-session journal, or None
        self._journal = journal
        self._page = PagedKVPool.kernel_aligned_page_size(page_size)
        #: block-table width: logical pages per slot at full cache length
        self._P_max = -(-self._Lc // self._page)
        if kv_pages is None:
            kv_pages = (1 + self._S * self._P_max
                        + max(self._P_max, self._S))
        if kv_pages < 1 + self._P_max:
            raise ValueError(
                f"kv_pages {kv_pages} cannot hold one full-length slot "
                f"({self._P_max} pages + the trash page)")
        self._kv = PagedKVPool(cfg, num_pages=int(kv_pages),
                               page_size=self._page, kv_dtype=self._kv_dtype,
                               device=self._dev, mesh=mesh)
        self._chunk = int(prefill_chunk)
        self._tuner = (KVAutotuner(gamma=self._gamma,
                                   gamma_max=self._gamma_max,
                                   chunk=self._chunk,
                                   chunk_min=min(32, self._chunk),
                                   chunk_max=max(1024, self._chunk),
                                   depth=self._depth,
                                   depth_min=min(1, self._depth),
                                   depth_max=max(4, self._depth))
                       if autotune else None)
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
        self._gather_bytes_tick = self._S * self._Lc * bpp
        self._gather_bytes_extend = self._L * bpp
        #: most tokens one dispatch can emit per slot (the retirement
        #: horizon unit), at the autotuner's gamma ceiling
        self._max_per_dispatch = (self._k * (self._gamma_max + 1)
                                  if self._spec else self._k)
        self._slot_req: List[Optional[_Request]] = [None] * self._S
        self._waiting: List[_Request] = []
        self._lock = new_lock(                  # guards _waiting/_next_rid
            "serving.continuous.ContinuousDecoder._lock")
        self._engine_lock = new_lock(           # serializes step/cancel_all
            "serving.continuous.ContinuousDecoder._engine_lock")
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
        if self._spec:
            # the draft slot pool: per layer contiguous (S, H_d, Lc, hd_d)
            d = self._d_cfg
            shape = (self._S, d.heads, self._Lc, d.d_model // d.heads)
            self._d_cache = [{kk: torch.zeros(shape, dtype=d.dtype,
                                              device=self._dev)
                              for kk in ("k", "v")}
                             for _ in range(d.layers)]
        self._tok = self._zeros(torch.int32)
        self._pos = self._zeros(torch.int32)
        self._active = self._zeros(torch.bool, False)
        self._remaining = self._zeros(torch.int32)
        self._temp = self._zeros(torch.float32)
        self._topk = self._zeros(torch.int32)
        self._topp = self._zeros(torch.float32, 1.0)
        #: per-slot request seeds: the key of :func:`_uniforms`
        self._seed = self._zeros(torch.int64)

    # ---- client surface ----
    def submit(self, prompt_ids, max_new_tokens: int = 32, *,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, seed: int = 0,
               prefix_key: Optional[str] = None,
               prefix_len: Optional[int] = None,
               session_id: Optional[str] = None,
               _journal_record: bool = True) -> _Request:
        """Queue one request; returns its ticket. ``prefix_key`` turns on
        prefix caching: the first request with a key prefills normally and
        registers its first ``prefix_len`` positions (default: the whole
        prompt); later requests with the key — whose prompts must start
        with the stored tokens — share those pages and run one window
        forward over their suffix. ``session_id`` names the durable
        session (default: the rid); with a journal the session is recorded
        before the request becomes visible to the engine, and a failed
        append fails this submit."""
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
            if session_id is not None:
                req.session_id = str(session_id)
            if self._journal is not None and _journal_record:
                # write-ahead: journaled before the engine can see it
                # (restore_session journals the canonical session itself)
                self._journal.record_session(
                    req.session_id, prompt.tolist(), {
                        "max_new": int(max_new_tokens),
                        "temperature": float(temperature),
                        "top_k": int(top_k), "top_p": float(top_p),
                        "seed": int(seed), "prefix_key": prefix_key,
                        "prefix_len": prefix_len,
                    }, phash=_prefix_hash(prompt))
            self._waiting.append(req)
        return req

    def result(self, req: _Request, timeout: Optional[float] = None):
        if not req.event.wait(timeout):
            raise TimeoutError(f"request {req.rid} not finished")
        if req.error is not None:
            raise req.error
        return list(req.tokens)

    def session_result(self, req: _Request,
                       timeout: Optional[float] = None) -> List[int]:
        """The full session completion: tokens emitted by previous
        incarnations of a restored session, then this one's (equal to
        :meth:`result` for a request never restored)."""
        return list(req.pre_emitted) + self.result(req, timeout)

    # ---- session checkpoint / restore ----
    def _slot_of(self, req: _Request) -> Optional[int]:
        return next((i for i in range(self._S)
                     if self._slot_req[i] is req), None)

    def checkpoint_session(self, req: _Request, *,
                           export_kv: bool = True) -> dict:
        """Snapshot a live request as ``{"session": {...}, "kv": blob or
        None}`` in canonical form: the ORIGINAL prompt and sampling
        parameters and every token emitted across all incarnations, so a
        checkpoint of a restored session round-trips. ``kv`` is the
        exported page blob (:meth:`PagedKVPool.export_session`) when the
        request holds a decoding slot with written pages (None when it is
        waiting, staged, mid-chunked-prefill or done, on a speculative
        engine, or when ``export_kv`` is false: the receiver then restores
        cold).

        Every outstanding dispatch drains first, so the host's token view
        and the pages agree (each drain's device→host copy waits for its
        dispatch; the stream is then synchronized before any page is
        read). The page list is the slot's current one, after any
        ``compact()`` remap, in logical order."""
        with self._engine_lock:
            while self._pending:
                self._drain_one()
            if self._dev.type == "cuda":
                torch.cuda.current_stream(self._dev).synchronize()
            n_pre = len(req.pre_emitted)
            orig_prompt = req.prompt[:req.prompt.size - n_pre]
            sess = {
                "id": req.session_id,
                "prompt": [int(t) for t in orig_prompt],
                "params": {
                    "max_new": int(req.max_new) + n_pre,
                    "temperature": req.temperature, "top_k": req.top_k,
                    "top_p": req.top_p, "seed": req.seed,
                },
                "phash": _prefix_hash(orig_prompt),
                "emitted": list(req.pre_emitted) + list(req.tokens),
            }
            kv = None
            if export_kv and not req.done and not self._spec:
                slot = self._slot_of(req)
                if (slot is not None and slot not in self._chunking
                        and req.tokens and self._slot_pages[slot]):
                    # positions written: the (possibly forced) prompt and
                    # every emitted token but the last, which is the next
                    # tick's input and has no K/V yet
                    written = req.prompt.size + len(req.tokens) - 1
                    n_live = self._kv.pages_per_slot(written)
                    kv = self._kv.export_session(
                        self._slot_pages[slot][:n_live], length=written)
            return {"session": sess, "kv": kv}

    def restore_session(self, sess: dict,
                        kv_blob: Optional[dict] = None) -> _Request:
        """Rebuild a journaled or checkpointed session on this engine.

        Cold (``kv_blob`` None): the original prompt plus every emitted
        token re-prefill as a forced prompt through normal admission, and
        the remainder decodes. Greedy sessions continue token for token;
        sampled ones too, since every draw is keyed by (seed, absolute
        position). Warm: the blob's pages are adopted into this pool and
        the request takes a free slot directly — nothing re-prefills; the
        next tick feeds the last emitted token at its original position.

        The returned request generates only the remainder
        (:meth:`session_result` has the whole completion); a session whose
        budget is spent or that already emitted eos comes back done. With
        a journal, the canonical session (original prompt, merged tail)
        is journaled here before the request becomes visible, so a second
        failover replays from this engine without stacking forced
        prefixes."""
        prompt = np.asarray(sess.get("prompt", ()), np.int32).reshape(-1)
        params = dict(sess.get("params", {}))
        emitted = [int(t) for t in sess.get("emitted", ())]
        sid = sess.get("id")
        max_new = int(params.get("max_new", 32))
        temperature = float(params.get("temperature", 0.0))
        top_k = int(params.get("top_k", 0))
        top_p = float(params.get("top_p", 1.0))
        seed = int(params.get("seed", 0))
        remaining = max_new - len(emitted)
        if remaining <= 0 or (self._eos is not None and self._eos in emitted):
            with self._lock:
                rid = self._next_rid
                self._next_rid += 1
            req = _Request(rid, prompt, max(1, max_new),
                           temperature=temperature, top_k=top_k,
                           top_p=top_p, seed=seed)
            if sid is not None:
                req.session_id = str(sid)
            req.pre_emitted = emitted
            req.done = True
            req.journaled = -1
            req.finished_at = time.perf_counter()
            req.event.set()
            return req
        forced = (np.concatenate([prompt, np.asarray(emitted, np.int32)])
                  if emitted else prompt)
        if sid is None:
            with self._lock:
                sid = f"sess-{self._next_rid}"
        sid = str(sid)
        if self._journal is not None:
            self._journal.record_session(
                sid, prompt.tolist(), {
                    "max_new": max_new, "temperature": temperature,
                    "top_k": top_k, "top_p": top_p, "seed": seed,
                    "prefix_key": None, "prefix_len": None,
                }, phash=_prefix_hash(prompt))
            if emitted:
                self._journal.record_session_tokens(sid, emitted)
        if kv_blob is None:
            req = self.submit(forced, max_new_tokens=remaining,
                              temperature=temperature, top_k=top_k,
                              top_p=top_p, seed=seed, session_id=sid,
                              _journal_record=False)
            req.pre_emitted = emitted
            return req
        return self._adopt_warm(kv_blob, forced, remaining, temperature,
                                top_k, top_p, seed, sid, emitted)

    def _adopt_warm(self, kv_blob, forced, remaining, temperature, top_k,
                    top_p, seed, sid, emitted) -> _Request:
        """The warm path of :meth:`restore_session`: adopt the pages into
        a free slot and set its decode state."""
        if self._spec:
            raise ValueError("warm adopt is not supported on speculative "
                             "engines (the draft cache is not exported); "
                             "restore cold instead")
        if not emitted:
            raise ValueError("warm adopt needs >= 1 emitted token (the "
                             "next tick's input); restore cold instead")
        written = int(kv_blob.get("length", -1))
        if written != forced.size - 1:
            raise ValueError(
                f"kv blob holds {written} positions; session expects "
                f"{forced.size - 1} (prompt+emitted minus the pending "
                f"last token)")
        if forced.size + remaining > self._L:
            raise ValueError(
                f"session needs {forced.size + remaining} positions; "
                f"this engine's max_len is {self._L}")
        with self._engine_lock:
            slot = next((i for i in range(self._S)
                         if self._slot_req[i] is None
                         and i not in self._chunking), None)
            if slot is None:
                raise PoolExhausted("no free slot to adopt session into")
            adopted = self._kv.adopt_session(kv_blob)
            n_total = self._kv.pages_per_slot(
                self._need(forced.size, remaining))
            try:
                extra = (self._kv.alloc(n_total - len(adopted))
                         if n_total > len(adopted) else [])
            except PoolExhausted:
                self._kv.free(adopted)
                raise
            with self._lock:
                rid = self._next_rid
                self._next_rid += 1
            req = _Request(rid, forced, remaining, temperature=temperature,
                           top_k=top_k, top_p=top_p, seed=seed)
            req.session_id = sid
            req.pre_emitted = list(emitted)
            self._slot_req[slot] = req
            self._slot_pages[slot] = adopted + extra
            self._set_bt_row(slot, adopted + extra)
            # the last emitted token is the next input, at the position it
            # holds in the uninterrupted run; draws key on (seed, position)
            self._tok[slot] = int(forced[-1])
            self._pos[slot] = written
            self._active[slot] = True
            self._remaining[slot] = remaining
            self._temp[slot] = temperature
            self._topk[slot] = top_k
            self._topp[slot] = top_p
            self._seed[slot] = _seed64(seed)
            self.stats["sessions_adopted"] = \
                self.stats.get("sessions_adopted", 0) + 1
            _tracing.add_event("session_adopt", slot=slot,
                               pages=len(adopted), extra=len(extra),
                               written=written)
        return req

    # ---- admission ----
    def _admit(self):
        """Move staged units, then waiting requests, into free slots.
        Plain requests admitted in one tick batch their prefill per pad
        bucket; prefix-cache requests take the per-request path; long
        prompts enter chunked prefill last."""
        while True:
            # staged units first: their prefill already ran, so insertion
            # is one scatter and the first tokens ride the drain pipeline
            staged_any = False
            while self._staged:
                with self._lock:
                    free = [i for i in range(self._S)
                            if self._slot_req[i] is None]
                    if not free:
                        break
                    unit = self._staged[0]
                    reqs, logits, rows, d_rows, off = unit
                    m = min(len(free), len(reqs) - off)
                    group = [(free[i], reqs[off + i]) for i in range(m)]
                    for slot, req in group:
                        self._slot_req[slot] = req
                sl = slice(off, off + m)
                if not self._insert_rows(
                        group, logits[sl],
                        [{kk: c[kk][sl] for kk in ("k", "v")} for c in rows],
                        [{kk: c[kk][sl] for kk in ("k", "v")}
                         for c in d_rows]):
                    # pool exhausted: un-assign and keep the unit parked;
                    # pages free as slots retire and a later tick retries
                    with self._lock:
                        for slot, _ in group:
                            self._slot_req[slot] = None
                    return
                unit[4] += m
                if unit[4] >= len(unit[0]):
                    self._staged.pop(0)
                staged_any = True
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
                if staged_any:
                    continue    # insertions may have freed slots (max_new 1)
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
                logits, row_cache, d_rows = self._prefill_group(
                    [r for _, r in group])
                if not self._insert_rows(group, logits, row_cache, d_rows):
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
                    if self._journal is not None and req.journaled >= 0:
                        # not recoverable: retire its journaled session
                        self._journal.record_session_end(req.session_id)
                        req.journaled = -1
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
        row_cache, draft rows); rows past ``len(reqs)`` are padding, and
        the draft's rows (its prefill of the same ids) are empty without
        a draft."""
        padded = self._bucket(max(r.prompt.size for r in reqs))
        with _prof_span("continuous.prefill", requests=len(reqs),
                        bucket=padded):
            k = 1 << (len(reqs) - 1).bit_length()
            ids = np.zeros((k, padded), np.int32)
            lengths = np.ones(k, np.int32)
            for i, r in enumerate(reqs):
                ids[i, :r.prompt.size] = r.prompt
                lengths[i] = r.prompt.size
            ids, lengths = self._h2d(ids), self._h2d(lengths)
            logits, row_cache = prefill_cache(self._params, ids, lengths,
                                              self._cfg, self._L,
                                              **self._tp_kw())
            d_rows = (prefill_cache(self._d_params, ids, lengths,
                                    self._d_cfg, self._L)[1]
                      if self._spec else [])
        self.stats["prefills"] += 1
        _M_PREFILLS.inc()
        return logits, row_cache, d_rows

    @staticmethod
    def _padded_rows(n: int) -> int:
        """Device rows a staged n-request unit holds (the power-of-two row
        pad of :meth:`_prefill_group`): what ``prefill_ahead`` charges."""
        return 1 << (n - 1).bit_length()

    def _stage_prefills(self):
        """Prefill-ahead: prefill the leading run of waiting plain
        same-bucket prompts while the slots are busy and park (logits,
        target rows, draft rows) on the device for :meth:`_admit`.
        Prefix-cache and chunked prompts end the run (they keep their own
        paths), and so does a bucket change, so FIFO order holds across
        waves. A unit is charged its padded rows until it fully drains. A
        failed prefill puts its requests back at the front of the queue,
        order intact, before the error propagates."""
        with self._lock:
            budget = self._stage_cap - sum(
                self._padded_rows(len(u[0])) for u in self._staged)
            take, bucket = [], None
            while (self._waiting and self._waiting[0].prefix_key is None
                   and not self._needs_chunk(self._waiting[0])):
                b = self._bucket(self._waiting[0].prompt.size)
                if bucket is None:
                    bucket = b
                elif b != bucket:
                    break
                if self._padded_rows(len(take) + 1) > budget:
                    break
                take.append(self._waiting.pop(0))
        if not take:
            return
        try:
            logits, row_cache, d_rows = self._prefill_group(take)
        except BaseException:
            with self._lock:
                self._waiting[:0] = take
            raise
        self.stats["staged_prefills"] = (
            self.stats.get("staged_prefills", 0) + 1)
        self._staged.append([take, logits, row_cache, d_rows, 0])

    # ---- page bookkeeping ----
    def _need(self, prompt_len: int, max_new: int) -> int:
        """Cache positions a request must own: prompt + every emittable
        token + the speculative verify window's optimistic tail."""
        return (prompt_len + max_new
                + (self._gamma_max + 1 if self._spec else 0))

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

    def _insert_rows(self, group, logits, row_cache, d_rows) -> bool:
        """Pages, slot insertion and first tokens for an admitted group;
        False (nothing inserted) when the pool cannot hold it."""
        try:
            self._ensure_pages(group)
        except PoolExhausted:
            return False
        g = len(group)
        self._insert_chunk_locked(
            group, logits[:g],
            [{kk: c[kk][:g] for kk in ("k", "v")} for c in row_cache],
            [{kk: c[kk][:g] for kk in ("k", "v")} for c in d_rows])
        return True

    def _insert_chunk_locked(self, group, logits, rows_t, rows_d):
        """Scatter prefill rows into the slots' pages (``rows_t`` empty for
        prefix hits and chunked prefills, whose K/V is already written),
        write the draft's rows ``rows_d`` (empty without a draft) into the
        draft slot pool, set the per-slot decode state, and queue the
        first tokens on the drain pipeline. Pages must already be
        assigned."""
        g = len(group)
        slots = [s for s, _ in group]
        reqs = [r for _, r in group]
        slots_v = self._h2d(slots, np.int64)
        lens_v = self._h2d([r.prompt.size for r in reqs], np.int32)
        rems_v = self._h2d([r.max_new - 1 for r in reqs], np.int32)
        temps_v = self._h2d([r.temperature for r in reqs], np.float32)
        topks_v = self._h2d([r.top_k for r in reqs], np.int32)
        topps_v = self._h2d([r.top_p for r in reqs], np.float32)
        seeds_v = self._h2d([_seed64(r.seed) for r in reqs], np.int64)
        # the first token sits at position P (the prompt's length)
        firsts = self._pick(logits[:g].float(), temps_v, topks_v, topps_v,
                            seeds_v, lens_v,
                            any(r.temperature > 0.0 for r in reqs))
        if rows_t and self._quant_probe:
            # sampled write-time probe: every quant_probe'th insert of
            # prefill rows round-trips layer 0's keys (one host sync)
            self._quant_inserts += 1
            if self._quant_inserts % self._quant_probe == 0:
                rms = _quant_probe(rows_t[0]["k"],
                                   kv_store_dtype(self._kv_dtype))
                self._kv.note_quant_error(rms)
                _slo_tracker().note_kv_quant_error(self._slo_model, rms)
        if rows_t:
            n_pages = -(-rows_t[0]["k"].shape[2] // self._page)
            page_rows = self._h2d(self._bt_host[slots, :n_pages], np.int64)
            paged_scatter_rows(self._kv.buffers, rows_t, page_rows,
                               self._page)
        for c, rc in zip(self._d_cache if rows_d else (), rows_d):
            for kk in ("k", "v"):
                c[kk][slots_v, :, :rc[kk].shape[2]] = rc[kk]
        self._tok[slots_v] = firsts
        self._pos[slots_v] = lens_v
        self._active[slots_v] = True
        self._remaining[slots_v] = rems_v
        self._temp[slots_v] = temps_v
        self._topk[slots_v] = topks_v
        self._topp[slots_v] = topps_v
        self._seed[slots_v] = seeds_v
        # first tokens ride the drain pipeline as a (1, g) block, queued
        # before any later tick block so drain order is emission order
        self._pending.append((firsts.reshape(1, -1),
                              {i: (slot, req)
                               for i, (slot, req) in enumerate(group)}))
        if len(self._pending) == 1:
            self._drain_one()

    @staticmethod
    def _pick(logits, temp, topk, topp, seed, qpos, sample: bool):
        """Next tokens for (S, V) logits at absolute positions ``qpos``:
        the argmax when no row samples, else :func:`_sample_rows` over
        :func:`_uniforms` keyed by each row's seed and ``qpos``."""
        if not sample:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return _sample_rows(logits, temp, topk, topp,
                            _uniforms(seed, qpos, 0, logits.shape[1]))

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
        """The mesh arguments of the replicated model calls (prefills and
        extends): heads only (an extend's one row cannot split over
        dp)."""
        if self._mesh is None:
            return {}
        return {"mesh": self._mesh, "head_axis": self._head_axis}

    def _rows_kw(self) -> dict:
        """The mesh arguments of the decode and verify calls, which run
        on this rank's rows: heads, and slots when they shard over dp."""
        if self._mesh is None:
            return {}
        return {**self._tp_kw(), "slot_axis": self._slot_axis}

    def _join_rows(self, block, tok, pos, active, remaining):
        """End of a dispatch: this rank's (n_steps, rows) token block and
        its rows' decode state → every slot's, on every rank. With slots
        over dp one all-gather brings in every shard's rows (the tokens,
        ``tok``, ``pos``, ``active`` and ``remaining``); otherwise the rows
        are every slot's already. Stores the state; returns the (n_steps, S) block."""
        if self._slot_axis is not None:
            block_t, tok, pos, active, remaining = gather_rows_many(
                [block.T, tok, pos, active, remaining], self._mesh,
                self._slot_axis)
            block = block_t.T
        self._tok, self._pos = tok, pos
        self._active, self._remaining = active, remaining
        return block

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
            _M_PREFIX_HITS.inc()
            self._prefix_store[req.prefix_key] = \
                self._prefix_store.pop(req.prefix_key)
            suffix = req.prompt[start:]
            w_logits = self._extend(self._padded_ids(suffix, self._L - start),
                                    start, slot)
            self._insert_chunk_locked([(slot, req)],
                                      w_logits[:, suffix.size - 1], [],
                                      self._draft_prompt_rows(req))
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
        _M_PREFILLS.inc()
        self._insert_chunk_locked([(slot, req)], logits, row_cache,
                                  self._draft_prompt_rows(req))
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

    def _draft_prompt_rows(self, req: _Request):
        """The draft's prefill rows of the whole prompt (the draft always
        re-prefills it: a draft is cheap by construction) for an admission
        that runs no batched prefill; empty without a draft."""
        if not self._spec:
            return []
        ids = self._padded_ids(req.prompt, self._L)
        return prefill_cache(self._d_params, self._h2d(ids),
                             self._h2d([req.prompt.size], np.int32),
                             self._d_cfg, self._L)[1]

    # ---- chunked prefill ----
    def _chunk_budget(self) -> int:
        return self._tuner.chunk if self._tuner is not None else self._chunk

    def _needs_chunk(self, req: _Request) -> bool:
        return (req.prefix_key is None
                and req.prompt.size > self._chunk_budget())

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
        w = min(self._chunk_budget(), P - off)
        t0 = time.perf_counter()
        # under the request's own span: the chunk span and its event land
        # in its trace, not in whatever the engine thread carries
        with _tracing.activate(req.span):
            with _prof_span("continuous.prefill_chunk", slot=slot,
                            offset=off, tokens=w):
                w_logits = self._extend(
                    self._padded_ids(req.prompt[off:off + w],
                                     self._L - off), off, slot)
            _ledger_charge("device_seconds", time.perf_counter() - t0,
                           cls=req.cost_cls, trace_id=req.cost_trace)
            _tracing.add_event("prefill_chunk", slot=slot, offset=off,
                               tokens=w)
        self._kv.note_prefill_chunk(w)
        self._chunk_trace.append(w)
        off += w
        if off < P:
            self._chunking[slot][1] = off
            return
        del self._chunking[slot]
        self.stats["prefills"] += 1
        _M_PREFILLS.inc()
        self._insert_chunk_locked([(slot, req)], w_logits[:, w - 1], [],
                                  self._draft_prompt_rows(req))

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
        req = self._slot_req[slot]
        self._slot_req[slot] = None
        self._active[slot] = False
        self._chunking.pop(slot, None)
        pages = self._slot_pages[slot]
        if pages:
            # the device block-table row stays stale on purpose: queued
            # ticks captured it, and later ticks see active=False, which
            # writes nothing
            self._kv.free(pages,
                          cost_cls=None if req is None else req.cost_cls,
                          cost_trace=None if req is None else req.cost_trace)
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
        _tracing.add_event("kv_compact",
                           pages_in_use=self._kv.pages_in_use)

    # ---- the decode tick ----
    def _tick(self, decode_live: List[int]) -> torch.Tensor:
        """k paged decode steps over this rank's slots (every slot unless
        slots shard over dp); retirement (remaining, eos) runs on the
        device inside the loop, so a slot that finishes mid-dispatch stops
        advancing. Returns the (k, S) token block of every slot
        (:meth:`_join_rows`)."""
        sample = any(self._slot_req[i].temperature > 0.0
                     for i in decode_live)
        r = self._rows
        tok, pos = self._tok[r], self._pos[r]
        active, remaining = self._active[r], self._remaining[r]
        temp, topk, topp, seed = (self._temp[r], self._topk[r],
                                  self._topp[r], self._seed[r])
        bt = self._bt[r]
        toks = []
        for _ in range(self._k):
            logits, _ = decode_step_paged(
                self._params, tok, pos, self._kv.buffers, bt,
                self._cfg, page_size=self._page, length=self._Lc,
                active=active, impl=self._attn_impl, **self._rows_kw())
            # the emitted token sits at pos + 1
            nxt = self._pick(logits, temp, topk, topp, seed, pos + 1, sample)
            nxt = torch.where(active, nxt, tok)
            pos = torch.where(active, pos + 1, pos)
            remaining = torch.where(active, remaining - 1, remaining)
            fin = remaining <= 0
            if self._eos is not None:
                fin = fin | (nxt == self._eos)
            active = active & ~fin
            tok = nxt
            toks.append(nxt)
        return self._join_rows(torch.stack(toks), tok, pos, active,
                               remaining)

    # ---- the speculative tick ----
    def _warm_logp(self, lg: torch.Tensor, warp: bool) -> torch.Tensor:
        """Log-probabilities of this rank's (rows, V) or (rows, W, V)
        logits at each row's temperature, after the row's top-k/top-p warp
        when ``warp`` (the same warp for target and draft: the rejection
        test is exact only under a shared warp)."""
        r = self._rows
        t = self._temp[r].clamp(min=1e-6).reshape(
            (lg.shape[0],) + (1,) * (lg.dim() - 1))
        scaled = lg.float() / t
        topk, topp = self._topk[r], self._topp[r]
        if warp:
            if lg.dim() == 2:
                scaled = _warp_scaled_rows(scaled, topk, topp)
            else:
                s_, w_, v_ = scaled.shape
                scaled = _warp_scaled_rows(
                    scaled.reshape(s_ * w_, v_),
                    topk.repeat_interleave(w_),
                    topp.repeat_interleave(w_)).reshape(s_, w_, v_)
        return torch.log_softmax(scaled, dim=-1)

    def _spec_tick(self, gamma: int, mode: str) -> torch.Tensor:
        """k draft → verify rounds over every slot (the reference's
        ``_spec_tick_program``, eager). Each round the draft takes gamma +
        1 steps over its slot pool (the last writes the last proposal's
        K/V, so the pool has no hole under full acceptance), the target
        scores every slot's (pending + gamma drafts) window in ONE paged
        window forward, and each slot accepts its own longest valid prefix
        plus one token. Greedy rows (``mode="greedy"``, and temp <= 0 rows
        of a sampled pool): proposals are draft argmaxes, acceptance is a
        target-argmax match, the last token the target's argmax — the
        plain engine's tokens. Sampled rows (``"sampled"``; ``"warped"``
        when a live row warps): proposals are draft samples, a token is
        accepted with probability min(1, p_t/p_d) and a rejection
        resampled from the normalized residual max(p_t - p_d, 0); each
        draws from its slot's generator in a fixed order. Emission stops
        at eos, inclusive. Returns the (k (gamma + 1), S) block, -1 on
        lanes not emitted; rejected lanes' K/V is overwritten before any
        query reads it. On a mesh every round runs on this rank's slots:
        the draft (replicated) over their rows of the draft pool, the
        verify window through the mount, the acceptance on their rows;
        :meth:`_join_rows` then brings in every dp shard's emissions."""
        dev = self._dev
        sample = mode != "greedy"
        warp = mode == "warped"
        r = self._rows
        seed = self._seed[r]
        V = self._cfg.vocab
        idx = torch.arange(gamma + 1, device=dev)
        temp = self._temp[r]
        tok, pos = self._tok[r], self._pos[r]
        active, remaining = self._active[r], self._remaining[r]
        bt = self._bt[r]
        # views: the draft's in-place writes land in the whole pool
        d_cache = [{kk: c[kk][r] for kk in ("k", "v")} for c in self._d_cache]
        emits = []
        for _ in range(self._k):
            t, props, d_logps = tok, [], []
            for i in range(gamma + 1):
                lg = decode_step_ragged_inplace(self._d_params, t, pos + i,
                                                d_cache, self._d_cfg,
                                                active)
                if i == gamma:          # this step only wrote its K/V
                    break
                nxt = torch.argmax(lg, dim=-1).to(torch.int32)
                if sample:
                    logp = self._warm_logp(lg, warp)
                    nxt = torch.where(
                        temp > 0.0,
                        _gumbel_argmax(logp, _uniforms(seed, pos + i + 1,
                                                       1, V)), nxt)
                    d_logps.append(logp)
                props.append(nxt)
                t = torch.where(active, nxt, t)
            drafts = torch.stack(props, dim=1)                    # (S, g)
            w_logits, _ = decode_window_paged(
                self._params, torch.cat([tok[:, None], drafts], dim=1), pos,
                self._kv.buffers, bt, self._cfg, page_size=self._page,
                length=self._Lc, active=active, impl=self._attn_impl,
                **self._rows_kw())
            self.stats["spec_verify_windows"] = (
                self.stats.get("spec_verify_windows", 0) + 1)
            greedy = torch.argmax(w_logits, dim=-1).to(torch.int32)
            if sample:
                # acceptance j decides the token at pos + j + 1; the
                # resample, drawn for every row before k is known, is
                # keyed at pos + 1 + (the count the verify accepts)
                t_logp = self._warm_logp(w_logits, warp)
                d_logp = torch.stack(d_logps, dim=1)
                u_acc = _uniforms(seed, pos[:, None] + 1 + idx[None, :gamma],
                                  2, 1)[..., 0]
                k, final = _spec_accept(
                    greedy, drafts, temp, t_logp, d_logp, u_acc,
                    lambda k_: _uniforms(seed, pos + k_ + 1, 3, V))
            else:
                k, final = _spec_accept(greedy, drafts)
            pad_drafts = torch.cat([drafts, drafts[:, -1:]], dim=1)
            cand = torch.where(idx[None] < k[:, None], pad_drafts,
                               final[:, None])
            cnt = torch.minimum(k + 1, remaining)
            if self._eos is not None:
                # truncate at the first emitted eos, inclusive
                is_eos = (cand == self._eos) & (idx[None] < cnt[:, None])
                first = is_eos.to(torch.int32).argmax(dim=-1).to(torch.int32)
                cnt = torch.where(is_eos.any(dim=-1), first + 1, cnt)
            cnt = torch.where(active, cnt, torch.zeros_like(cnt))
            emit = torch.where(idx[None] < cnt[:, None], cand,
                               torch.full_like(cand, -1))
            pos = pos + cnt
            remaining = remaining - cnt
            fin = remaining <= 0
            if self._eos is not None:
                fin = fin | (emit == self._eos).any(dim=-1)
            active = active & ~fin
            last = cand.gather(1, (cnt - 1).clamp(min=0).long()[:, None])
            tok = torch.where(cnt > 0, last[:, 0], tok)
            emits.append(emit.T)
        return self._join_rows(torch.cat(emits, dim=0), tok, pos, active,
                               remaining)

    def step(self) -> int:
        """One engine tick; returns the number of live slots stepped."""
        with self._engine_lock:
            return self._step_locked()

    def _step_locked(self) -> int:
        injector = _get_injector()
        if injector.enabled:
            injector.fire("device_run")
        # eager drain under saturation: with requests queued (or staged)
        # and every slot occupied, only a drained retirement frees a slot
        with self._lock:
            backlog = bool(self._waiting or self._staged)
        if backlog:
            while (self._pending
                   and all(self._slot_req[i] is not None
                           for i in range(self._S))
                   and self._retirement_in_flight()):
                self._drain_one()
        self._admit()
        # one prefill chunk per tick, interleaved with the decode below
        with _watch("decoder_prefill"):
            self._advance_chunks()
        live = [i for i in range(self._S) if self._slot_req[i] is not None]
        _M_LIVE_SLOTS.set(len(live))
        if not live:
            if self._pending:
                self._drain_one()
                return 1
            return 0
        # slots mid-chunked-prefill are occupied but device-inactive
        decode_live = [i for i in live if i not in self._chunking]
        if self._tuner is not None:
            self._tuner.observe(
                len(live), self._S,
                self.stats.get("spec_emitted") if self._spec else None,
                self.stats.get("spec_round_slots") if self._spec else None)
        if not decode_live:
            while len(self._pending) > self._depth_now():
                self._drain_one()
            return len(live)
        t0 = time.perf_counter()
        if self._spec:
            reqs = [self._slot_req[i] for i in decode_live]
            mode = ("greedy" if all(r.temperature <= 0.0 for r in reqs)
                    else "warped" if any(r.temperature > 0.0
                                         and (r.top_k > 0 or r.top_p < 1.0)
                                         for r in reqs)
                    else "sampled")
            gamma = (self._tuner.gamma if self._tuner is not None
                     else self._gamma)
            with _watch("decoder_decode"):
                toks = self._spec_tick(gamma, mode)
        else:
            with _watch("decoder_decode"):
                toks = self._tick(decode_live)
        # one dispatch covers every live decode slot: its host wall time
        # is shared equally by the requests that rode it
        _get_ledger().charge_shares(
            "device_seconds", time.perf_counter() - t0,
            [(self._slot_req[i].cost_cls, self._slot_req[i].cost_trace, 1.0)
             for i in decode_live])
        self._kv.note_attn_tick(
            self._attn_impl, calls=self._k,
            gather_bytes=(self._k * self._gather_bytes_tick
                          if self._attn_impl == "gather" else 0))
        # snapshot slot → REQUEST: a slot may be re-admitted before this
        # block drains; tokens go to the request that held it at dispatch
        self._pending.append((toks, {i: (i, self._slot_req[i])
                                     for i in decode_live}))
        # prefill-ahead: with the decode block queued on the device,
        # prefill waiting prompts into the stage behind it
        if self._stage_cap:
            self._stage_prefills()
        while len(self._pending) > self._depth_now():
            self._drain_one()
        self.tick_seconds.append(time.perf_counter() - t0)
        return len(live)

    def _depth_now(self) -> int:
        """The live pipeline-depth bound: the autotuner's pick when it
        runs (it follows occupancy), else the constructor's."""
        if self._tuner is not None and self._tuner.depth is not None:
            return self._tuner.depth
        return self._depth

    def _retirement_in_flight(self) -> bool:
        """True iff some occupied slot could finish inside the outstanding
        blocks (always, with eos enabled)."""
        if self._eos is not None:
            return True
        horizon = self._max_per_dispatch * len(self._pending)
        return any(req is not None
                   and req.max_new - len(req.tokens) <= horizon
                   for req in self._slot_req)

    def _drain_one(self):
        """Copy the oldest outstanding token block to the host (the decode
        path's one device→host sync) and replay it in emission order."""
        toks_dev, snapshot = self._pending.pop(0)
        # the copy is the decode path's one device→host sync: the line a
        # wedged card parks on, so the watchdog covers it
        drain_t0 = time.perf_counter()
        with _M_DRAIN_SECONDS.time(), _prof_span("continuous.drain"), \
                _watch("decoder_drain"):
            toks = toks_dev.cpu().numpy()
        _get_ledger().charge_shares(
            "device_seconds", time.perf_counter() - drain_t0,
            [(req.cost_cls, req.cost_trace, 1.0)
             for _, (_, req) in snapshot.items()])
        if self._spec and toks.shape[0] > 1:
            # a spec block: k rounds of gamma + 1 lanes, -1 where nothing
            # was emitted. Both acceptance counters come from this block:
            # a (round, slot) pair counts iff the slot emitted in it (a
            # live round always emits at least one token)
            lanes = toks.shape[0] // self._k
            live_pairs = (toks.reshape(self._k, lanes, -1) >= 0).any(1)
            self.stats["spec_emitted"] = (self.stats.get("spec_emitted", 0)
                                          + int((toks >= 0).sum()))
            self.stats["spec_round_slots"] = (
                self.stats.get("spec_round_slots", 0)
                + int(live_pairs.sum()))
        for s in range(toks.shape[0]):
            for col, (_, req) in snapshot.items():
                if req.done:
                    continue
                tk = int(toks[s, col])
                if tk >= 0:         # a spec lane past the accepted count
                    self._note_token(req, tk)
        if self._journal is not None:
            # one tail record per session per drain; retirement closes the
            # session so compaction can drop it
            seen = set()
            for _, (_, req) in snapshot.items():
                if id(req) in seen or req.journaled < 0:
                    continue
                seen.add(id(req))
                new = req.tokens[req.journaled:]
                if new:
                    self._journal.record_session_tokens(req.session_id, new)
                    req.journaled = len(req.tokens)
                if req.done:
                    self._journal.record_session_end(req.session_id)
                    req.journaled = -1
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
            # staged requests left the queue but never reached a slot;
            # their parked rows go with the units
            for unit in self._staged:
                cancelled.extend(unit[0][unit[4]:])
            self._staged.clear()
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

    def bind_thread(self) -> None:
        """Make the engine's card the calling thread's current device (a
        thread starts on card 0; collectives over NCCL take the current
        device's)."""
        if self._dev.type == "cuda":
            torch.cuda.set_device(self._dev)

    def serve_forever(self, idle_sleep: float = 0.002,
                      max_failures: int = 3,
                      failure_backoff: float = 0.05):
        """Engine loop with crash containment: a failing step() backs off
        exponentially; after ``max_failures`` in a row every in-flight
        request is cancelled and the loop keeps serving."""
        self.bind_thread()
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
        # the decoder thread starts with an empty context: propagate()
        # carries the tracer and trace active at start() into it
        t = threading.Thread(target=_tracing.propagate(self.serve_forever),
                             daemon=True, name="continuous-decoder")
        t.start()
        return t

    def stop(self):
        self._stop.set()

