"""Versioned model registry: hot load/unload, canary rollout, shadow traffic.

The control plane of the multi-model traffic plane. Models are named,
versioned entries (``name@version``) with a per-version state machine::

    loading -> canary -> live -> draining -> retired

``load()`` stages the version's handle and runs its (ladder-aware)
``warm_up`` OFF the request path before the version becomes routable —
the first real request never eats an XLA compile stall. ``unload()`` /
``retire()`` drain in-flight work first, then release what the handle
holds: the ``_device_params`` a model (``models/onnx_model.py``) staged
on the card, whether the handle is the model or its bound ``transform``,
and any ``PagedKVPool`` (whose ``close()`` returns its ``ResidencyManager``
reservation).

Rollout: a candidate in ``canary`` receives a configured percentage of
the model's traffic (deterministic per-request split, so retries of one
request stay on one version). :meth:`check_canaries` compares the
candidate's rolling p99 / error rate against the incumbent's — both read
from the ``SloTracker``'s per-``{transport,route,model,tenant}`` windows,
where the model dimension carries ``name@version`` — and auto-rolls the
candidate back when it breaches the incumbent by the configured margins.
Shadow traffic mirrors a sampled fraction of incumbent requests to the
candidate; the shadow's reply is never sent to the caller, only joined
against the primary's and diffed (the trace ids of both land in the
event log, so the FlightRecorder holds the full pair).

Tenant config (the weights ``AdmissionQueue`` reads) also lives here —
one registry is THE control surface the ``/models`` admin route edits.

Process-global accessors follow the repo's singleton idiom:
``get_registry()`` / ``set_registry()`` / ``reset_registry()``.

The port's copy of ``mmlspark_tpu/serving/registry.py``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from ..observability import counter as _metric_counter
from ..observability import gauge as _metric_gauge
from ..observability import get_tracker as _get_tracker
from ..observability import log_event as _log_event
from ..observability import tracing as _tracing

__all__ = ["ModelRegistry", "ModelVersion", "Resolution", "VERSION_STATES",
           "WORKER_LIVENESS_STATES",
           "get_registry", "set_registry", "reset_registry"]

#: the per-version lifecycle, in order; transitions only move forward
#: except rollback (canary -> retired via draining)
VERSION_STATES = ("loading", "canary", "live", "draining", "retired")

#: the per-worker liveness lifecycle the driver's sweeper walks
#: (serving/distributed.py): heartbeats keep a worker ``alive``; a missed
#: beat past the liveness interval makes it ``suspect``; past
#: interval x sweep-multiplier the sweeper issues a ``dead`` verdict and
#: reassigns its journaled sessions. ``draining`` is the operator-initiated
#: graceful path (excluded from routing, sessions handed off warm).
WORKER_LIVENESS_STATES = ("alive", "suspect", "draining", "dead")

_M_VERSIONS = _metric_gauge(
    "mmlspark_registry_versions",
    "Registered model versions by lifecycle state", ("state",))
_M_LOADS = _metric_counter(
    "mmlspark_registry_loads_total",
    "Model version load attempts by outcome", ("outcome",))
_M_ROLLBACKS = _metric_counter(
    "mmlspark_registry_rollbacks_total",
    "Canary auto/manual rollbacks", ("reason",))
_M_CANARY = _metric_counter(
    "mmlspark_registry_canary_routed_total",
    "Model resolutions by rollout decision", ("decision",))
_M_SHADOW = _metric_counter(
    "mmlspark_registry_shadow_requests_total",
    "Requests mirrored to a shadow (candidate) version")
_M_SHADOW_DIFFS = _metric_counter(
    "mmlspark_registry_shadow_diffs_total",
    "Joined primary/shadow reply pairs by verdict", ("verdict",))


class ModelVersion:
    """One registered ``name@version``: its handle (the callable /
    transform / model object serving engines dispatch to), lifecycle
    state, rollout knobs, and in-flight accounting."""

    def __init__(self, name: str, version: str, handle=None,
                 canary_percent: float = 0.0, shadow_percent: float = 0.0,
                 unload_fn: Optional[Callable[[], None]] = None):
        self.name = str(name)
        self.version = str(version)
        self.handle = handle
        self.state = "loading"
        self.canary_percent = float(canary_percent)
        self.shadow_percent = float(shadow_percent)
        self.unload_fn = unload_fn
        self.error: Optional[str] = None
        self.created_at = time.time()
        self.warmed_seconds: Optional[float] = None
        self.in_flight = 0
        self.resolved_total = 0

    @property
    def label(self) -> str:
        return f"{self.name}@{self.version}"

    def snapshot(self) -> Dict[str, object]:
        return {"name": self.name, "version": self.version,
                "label": self.label, "state": self.state,
                "canary_percent": self.canary_percent,
                "shadow_percent": self.shadow_percent,
                "error": self.error,
                "warmed_seconds": self.warmed_seconds,
                "in_flight": self.in_flight,
                "resolved_total": self.resolved_total}


class Resolution:
    """Outcome of one model resolution: the version label to serve from,
    and optionally a shadow label to mirror (never answer from)."""

    __slots__ = ("label", "shadow", "decision")

    def __init__(self, label: str, shadow: Optional[str] = None,
                 decision: str = "passthrough"):
        self.label = label
        self.shadow = shadow
        self.decision = decision


def _bucket(request_id: Optional[str], salt: str) -> int:
    """Deterministic 0-99 split bucket for a request id — stable across
    retries of the same request, independent per salt."""
    import hashlib
    rid = request_id or _tracing.new_request_id()
    digest = hashlib.sha1(f"{salt}:{rid}".encode("utf-8")).digest()
    return digest[0] % 100


class ModelRegistry:
    """The versioned model catalog + rollout controller + tenant config.

    Canary auto-rollback margins: the candidate rolls back when, with at
    least ``min_requests`` observed in its rolling window, its window
    error rate exceeds the incumbent's by ``err_margin`` (absolute) OR
    its window p99 exceeds ``p99_margin`` times the incumbent's OR its
    window KV quantization error (``kv_quant_error`` — the relative RMS
    reported by a quantized engine's dequant oracle probe) exceeds the
    incumbent's by ``quant_margin`` (absolute). The quant breach is what
    lets a ``model@quant`` canary A/B against a ``model@bf16`` incumbent
    with automatic rollback when the quantized KV plane drifts.
    ``check_every`` bounds hot-path cost: the rollback check runs every
    N canary resolutions (and on every :meth:`check_canaries`, which
    heartbeats call off the request path).
    """

    def __init__(self, err_margin: float = 0.05, p99_margin: float = 1.5,
                 min_requests: int = 20, check_every: int = 16,
                 shadow_keep: int = 64, quant_margin: float = 0.05):
        self.err_margin = float(err_margin)
        self.p99_margin = float(p99_margin)
        self.quant_margin = float(quant_margin)
        self.min_requests = int(min_requests)
        self.check_every = max(1, int(check_every))
        self._lock = threading.Lock()
        #: name → {version: ModelVersion}
        self._models: Dict[str, Dict[str, ModelVersion]] = {}
        #: tenant → weight (AdmissionQueue reads via tenant_weight)
        self._tenants: Dict[str, float] = {}
        self._canary_resolves = 0
        #: rollback history (most recent last, bounded)
        self._rollbacks: deque = deque(maxlen=32)
        #: primary request id → pending shadow join record
        self._shadow_pending: Dict[str, Dict[str, object]] = {}
        #: completed shadow diffs (most recent last, bounded)
        self._shadow_diffs: deque = deque(maxlen=int(shadow_keep))

    # -- lifecycle -----------------------------------------------------------
    def _set_state(self, mv: ModelVersion, state: str) -> None:
        """Transition (caller holds no lock requirement) + gauge refresh +
        event — every state change leaves an audit trail."""
        mv.state = state
        self._refresh_state_gauge()
        _log_event("registry_state", model=mv.name, version=mv.version,
                   state=state)

    def _refresh_state_gauge(self) -> None:
        counts = {s: 0 for s in VERSION_STATES}
        with self._lock:
            for versions in self._models.values():
                for mv in versions.values():
                    counts[mv.state] = counts.get(mv.state, 0) + 1
        for state, n in counts.items():
            _M_VERSIONS.set(n, state=state)

    def load(self, name: str, version: str, handle=None,
             warm_up: Optional[Callable[[], object]] = None,
             canary_percent: float = 0.0, shadow_percent: float = 0.0,
             unload_fn: Optional[Callable[[], None]] = None,
             block: bool = True) -> ModelVersion:
        """Register ``name@version`` and make it routable.

        The version is held in ``loading`` while ``warm_up`` runs (NOT
        routable — resolve() skips it), then becomes ``live`` when the
        model has no live incumbent, else ``canary`` at
        ``canary_percent``. ``block=False`` runs warm-up on a background
        thread and returns immediately (state still ``loading``)."""
        mv = ModelVersion(name, version, handle=handle,
                          canary_percent=canary_percent,
                          shadow_percent=shadow_percent,
                          unload_fn=unload_fn)
        with self._lock:
            versions = self._models.setdefault(mv.name, {})
            if mv.version in versions \
                    and versions[mv.version].state != "retired":
                raise ValueError(f"{mv.label} is already registered "
                                 f"({versions[mv.version].state})")
            versions[mv.version] = mv
        self._set_state(mv, "loading")
        if block:
            self._warm_and_activate(mv, warm_up)
        else:
            t = threading.Thread(
                target=_tracing.propagate(self._warm_and_activate),
                args=(mv, warm_up), daemon=True,
                name=f"registry-warmup-{mv.label}")
            t.start()
        return mv

    def _warm_and_activate(self, mv: ModelVersion,
                           warm_up: Optional[Callable[[], object]]) -> None:
        t0 = time.perf_counter()
        if warm_up is not None:
            try:
                warm_up()
            except Exception as exc:
                mv.error = repr(exc)
                self._set_state(mv, "retired")
                _M_LOADS.inc(outcome="error")
                _log_event("registry_warmup_failed", model=mv.name,
                           version=mv.version, error=repr(exc))
                return
        mv.warmed_seconds = round(time.perf_counter() - t0, 6)
        with self._lock:
            has_live = any(v.state == "live"
                           for v in self._models[mv.name].values()
                           if v is not mv)
        self._set_state(mv, "canary" if has_live else "live")
        _M_LOADS.inc(outcome="ok")

    def promote(self, name: str, version: str,
                drain_timeout: float = 5.0) -> ModelVersion:
        """Canary → live; the previous incumbent drains and retires."""
        with self._lock:
            mv = self._get_locked(name, version)
            if mv.state not in ("canary", "loading"):
                raise ValueError(f"{mv.label} is {mv.state}, not canary")
            incumbents = [v for v in self._models[mv.name].values()
                          if v.state == "live"]
        self._set_state(mv, "live")
        for old in incumbents:
            self.retire(old.name, old.version, drain_timeout=drain_timeout)
        return mv

    def rollback(self, name: str, version: Optional[str] = None,
                 reason: str = "manual") -> Optional[ModelVersion]:
        """Pull a canary out of rotation (auto-rollback's shared path).
        ``version=None`` rolls back whatever canary the model has."""
        with self._lock:
            versions = self._models.get(str(name), {})
            if version is None:
                cands = [v for v in versions.values()
                         if v.state == "canary"]
                mv = cands[0] if cands else None
            else:
                mv = versions.get(str(version))
            if mv is None or mv.state not in ("canary", "loading"):
                return None
            self._rollbacks.append(
                {"t": time.time(), "model": mv.name,
                 "version": mv.version, "reason": reason})
        _M_ROLLBACKS.inc(reason="auto" if reason != "manual" else "manual")
        _log_event("registry_rollback", model=mv.name, version=mv.version,
                   reason=reason)
        self.retire(mv.name, mv.version)
        return mv

    def retire(self, name: str, version: str,
               drain_timeout: float = 5.0) -> Dict[str, object]:
        """Drain in-flight work, then release device state: clears the
        handle's staged ``_device_params`` and closes its ``pool``
        (returning the ``ResidencyManager`` reservation), then runs the
        version's ``unload_fn``. Safe to call from any state."""
        with self._lock:
            mv = self._get_locked(name, version)
        if mv.state == "retired":
            return {"label": mv.label, "drained": True}
        self._set_state(mv, "draining")
        deadline = time.monotonic() + max(0.0, float(drain_timeout))
        while mv.in_flight > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        drained = mv.in_flight == 0
        handle = mv.handle
        # release staged device params (models/onnx_model.py keeps them in
        # _device_params keyed by device and dtype); a bound transform
        # releases its model's
        owner = getattr(handle, "__self__", handle)
        if owner is not None and hasattr(owner, "_device_params"):
            owner._device_params = {}
        pool = getattr(handle, "pool", None)
        if pool is not None and hasattr(pool, "close"):
            try:
                pool.close()
            except Exception as exc:
                _log_event("registry_pool_close_failed", model=mv.name,
                           version=mv.version, error=repr(exc))
        if mv.unload_fn is not None:
            try:
                mv.unload_fn()
            except Exception as exc:
                _log_event("registry_unload_failed", model=mv.name,
                           version=mv.version, error=repr(exc))
        mv.handle = None
        self._set_state(mv, "retired")
        _log_event("registry_retired", model=mv.name, version=mv.version,
                   drained=drained)
        return {"label": mv.label, "drained": drained}

    def unload(self, name: str, version: str,
               drain_timeout: float = 5.0) -> Dict[str, object]:
        """Alias for :meth:`retire` — the admin-facing verb."""
        return self.retire(name, version, drain_timeout=drain_timeout)

    def _get_locked(self, name: str, version: str) -> ModelVersion:
        versions = self._models.get(str(name), {})
        mv = versions.get(str(version))
        if mv is None:
            raise KeyError(f"unknown model version {name}@{version}")
        return mv

    # -- resolution ----------------------------------------------------------
    def resolve(self, name: str,
                request_id: Optional[str] = None) -> Resolution:
        """Pick the version that serves this request. Unregistered names
        pass through unchanged (the single-model deployments that never
        touch the registry keep their ``model="default"`` SLO class).
        Canary split is deterministic per request id; shadow sampling is
        an independent split so shadow rate is not conditioned on the
        canary outcome."""
        with self._lock:
            versions = self._models.get(str(name))
            if not versions:
                return Resolution(str(name))
            live = [v for v in versions.values() if v.state == "live"]
            canary = [v for v in versions.values() if v.state == "canary"]
            incumbent = live[-1] if live else None
            candidate = canary[-1] if canary else None
            chosen = incumbent
            decision = "incumbent"
            if candidate is not None and incumbent is not None \
                    and candidate.canary_percent > 0 \
                    and _bucket(request_id, "canary") \
                    < candidate.canary_percent:
                chosen = candidate
                decision = "canary"
            elif incumbent is None and candidate is not None:
                # nothing live yet (first rollout): the canary serves
                chosen = candidate
                decision = "canary"
            if chosen is None:
                return Resolution(str(name))
            shadow = None
            if decision != "canary" and candidate is not None \
                    and candidate.shadow_percent > 0 \
                    and _bucket(request_id, "shadow") \
                    < candidate.shadow_percent:
                shadow = candidate.label
                candidate.in_flight += 1
            chosen.in_flight += 1
            chosen.resolved_total += 1
            if decision == "canary":
                self._canary_resolves += 1
                due = self._canary_resolves % self.check_every == 0
            else:
                due = False
        _M_CANARY.inc(decision=decision)
        if due:
            self.check_canaries()
        return Resolution(chosen.label, shadow=shadow, decision=decision)

    def note_done(self, label: str) -> None:
        """Reply landed for a request resolved to ``label`` — drop its
        in-flight count (the retire() drain barrier watches this)."""
        name, _, version = str(label).partition("@")
        with self._lock:
            mv = self._models.get(name, {}).get(version)
            if mv is not None and mv.in_flight > 0:
                mv.in_flight -= 1

    def handle_for(self, label: str):
        """The staged handle for ``name@version`` (None when unknown or
        unloaded) — serving engines dispatch per-version through this."""
        name, _, version = str(label).partition("@")
        with self._lock:
            mv = self._models.get(name, {}).get(version)
            return mv.handle if mv is not None else None

    # -- canary governance ---------------------------------------------------
    def _window_stats(self, label: str) -> Dict[str, object]:
        tracker = _get_tracker()
        win = tracker.model_window(label)
        return win

    def check_canaries(self) -> List[Dict[str, object]]:
        """Compare every canary's rolling window against its incumbent's
        and auto-roll back breaches. Returns one verdict per canary —
        heartbeats call this off the request path."""
        with self._lock:
            pairs = []
            for name, versions in self._models.items():
                live = [v for v in versions.values() if v.state == "live"]
                for mv in versions.values():
                    if mv.state == "canary" and live:
                        pairs.append((name, mv.label, live[-1].label))
        verdicts = []
        for name, cand_label, inc_label in pairs:
            cand = self._window_stats(cand_label)
            inc = self._window_stats(inc_label)
            verdict = {"model": name, "candidate": cand_label,
                       "incumbent": inc_label, "candidate_window": cand,
                       "incumbent_window": inc, "breach": None}
            if cand["count"] >= self.min_requests:
                if cand["error_rate"] > inc["error_rate"] + self.err_margin:
                    verdict["breach"] = (
                        f"error_rate {cand['error_rate']:.3f} > "
                        f"{inc['error_rate']:.3f} + {self.err_margin}")
                elif (cand.get("p99") is not None
                      and inc.get("p99") is not None
                      and cand["p99"] > inc["p99"] * self.p99_margin):
                    verdict["breach"] = (
                        f"p99 {cand['p99']:.4f}s > "
                        f"{inc['p99']:.4f}s x {self.p99_margin}")
                elif (cand.get("kv_quant_error") is not None
                      and cand["kv_quant_error"]
                      > (inc.get("kv_quant_error") or 0.0)
                      + self.quant_margin):
                    verdict["breach"] = (
                        f"kv_quant_error {cand['kv_quant_error']:.4f} > "
                        f"{inc.get('kv_quant_error') or 0.0:.4f} + "
                        f"{self.quant_margin}")
            if verdict["breach"]:
                _, _, v = cand_label.partition("@")
                self.rollback(name, v, reason=verdict["breach"])
            verdicts.append(verdict)
        return verdicts

    # -- shadow traffic ------------------------------------------------------
    def shadow_begin(self, primary_id: str, shadow_id: str,
                     label: str, trace_id: Optional[str] = None) -> None:
        """Record that ``primary_id`` is being mirrored to ``shadow_id``
        on version ``label`` — the join the replies complete."""
        with self._lock:
            # bound the pending table: an orphaned join (lost reply)
            # must not leak forever
            if len(self._shadow_pending) >= 256:
                self._shadow_pending.pop(next(iter(self._shadow_pending)))
            self._shadow_pending[str(primary_id)] = {
                "shadow_id": str(shadow_id), "label": str(label),
                "trace_id": trace_id, "primary": None, "shadow": None}
        _M_SHADOW.inc()

    def shadow_result(self, primary_id: str, body: Optional[bytes],
                      from_shadow: bool) -> None:
        """One side of a mirrored pair answered; when both sides are in,
        diff and record the verdict (the reply content itself stays in
        the FlightRecorder via the recorded trace ids)."""
        with self._lock:
            rec = self._shadow_pending.get(str(primary_id))
            if rec is None:
                return
            rec["shadow" if from_shadow else "primary"] = body or b""
            if rec["primary"] is None or rec["shadow"] is None:
                return
            self._shadow_pending.pop(str(primary_id))
            verdict = ("match" if rec["primary"] == rec["shadow"]
                       else "diff")
            entry = {"t": time.time(), "primary_id": str(primary_id),
                     "shadow_id": rec["shadow_id"], "label": rec["label"],
                     "trace_id": rec["trace_id"], "verdict": verdict}
            self._shadow_diffs.append(entry)
        _M_SHADOW_DIFFS.inc(verdict=verdict)
        _log_event("shadow_diff", **entry)

    def shadow_diffs(self) -> List[Dict[str, object]]:
        with self._lock:
            return list(self._shadow_diffs)

    # -- tenant config -------------------------------------------------------
    def set_tenant(self, tenant: str, weight: float) -> None:
        w = float(weight)
        if w <= 0:
            raise ValueError("tenant weight must be positive")
        with self._lock:
            self._tenants[str(tenant)] = w
        _log_event("registry_tenant", tenant=str(tenant), weight=w)

    def tenant_weight(self, tenant: str) -> float:
        with self._lock:
            return self._tenants.get(str(tenant), 1.0)

    def tenants(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._tenants)

    # -- introspection -------------------------------------------------------
    def versions(self, name: str) -> List[ModelVersion]:
        with self._lock:
            return list(self._models.get(str(name), {}).values())

    def snapshot(self) -> Dict[str, object]:
        """Full JSON-safe registry state — the /debug/registry payload."""
        with self._lock:
            models = {name: [mv.snapshot() for mv in versions.values()]
                      for name, versions in self._models.items()}
            rollbacks = list(self._rollbacks)
            tenants = dict(self._tenants)
            pending = len(self._shadow_pending)
        return {"models": models, "tenants": tenants,
                "rollbacks": rollbacks,
                "shadow_pending": pending,
                "shadow_diffs": self.shadow_diffs(),
                "margins": {"err_margin": self.err_margin,
                            "p99_margin": self.p99_margin,
                            "quant_margin": self.quant_margin,
                            "min_requests": self.min_requests}}

    def digest(self) -> Dict[str, object]:
        """Compact registry state for heartbeat piggybacking: per model,
        which version is live/canary and the lifecycle state counts."""
        with self._lock:
            models = {}
            for name, versions in self._models.items():
                live = [v.version for v in versions.values()
                        if v.state == "live"]
                canary = [v.version for v in versions.values()
                          if v.state == "canary"]
                models[name] = {
                    "live": live[-1] if live else None,
                    "canary": canary[-1] if canary else None,
                    "versions": len(versions)}
            return {"models": models, "tenants": dict(self._tenants),
                    "rollbacks": len(self._rollbacks)}

    def reset(self) -> None:
        with self._lock:
            self._models.clear()
            self._tenants.clear()
            self._rollbacks.clear()
            self._shadow_pending.clear()
            self._shadow_diffs.clear()
            self._canary_resolves = 0
        self._refresh_state_gauge()


_registry: Optional[ModelRegistry] = None
_registry_lock = threading.Lock()


def get_registry() -> ModelRegistry:
    """Process-global registry (the one the serving plane consults)."""
    global _registry
    with _registry_lock:
        if _registry is None:
            _registry = ModelRegistry()
        return _registry


def set_registry(registry: Optional[ModelRegistry]) -> None:
    global _registry
    with _registry_lock:
        _registry = registry


def reset_registry() -> None:
    set_registry(None)
