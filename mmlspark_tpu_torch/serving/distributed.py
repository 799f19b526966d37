"""Distributed serving: driver registry + cross-worker routing/forwarding.

Parity surface (the round-1 gap): the reference's multi-worker continuous
serving — per-executor ``WorkerServer``s register with a driver rendezvous
service (``DriverServiceUtils.createDriverService``,
``HTTPSourceV2.scala:134-195``), the driver keeps a routing table of live
workers (``:689``), failed/restarted readers re-register under the same id
and rehydrate their unanswered requests (``registerPartition``
``:489-506``), replies are routed to the worker holding the client
connection (``HTTPSourceStateHolder.getServer(machineIp).replyTo``,
``:536-554``), and an internal load balancer forwards requests between
servers (``:679-687``).

Shape: the engine (the DataFrame pipeline loop) polls *all* local
workers; replies travel back by worker id — over HTTP when the owning worker
is remote, in-process otherwise. Everything is testable with N workers in
one process, exactly how the reference tests distributed behavior in
local-mode Spark (SURVEY §4).

The port's copy of ``mmlspark_tpu/serving/distributed.py``.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple

from ..io.http.schema import (EntityData, HeaderData, HTTPRequestData,
                              HTTPResponseData, StatusLineData)
from ..observability import counter as _metric_counter
from ..observability import gauge as _metric_gauge
from ..observability import log_event as _log_event
from ..observability import tracing as _tracing
from ..observability import (ClusterAggregator, ClusterSampler,
                             snapshot_interval, worker_snapshot)
from ..reliability import (DEADLINE_HEADER, BreakerOpen, CircuitBreaker,
                           Deadline, DeadlineExceeded, RetryPolicy,
                           breaker_for, get_injector, start_supervised)
from ..reliability.lock_sanitizer import new_lock
from .admission import ConsistentHashRing
from .journal import ServingJournal
from .kv_pool import AFFINITY_HEADER
from .registry import WORKER_LIVENESS_STATES
from .registry import get_registry as _get_model_registry
from .server import CachedRequest, Overloaded, WorkerServer

__all__ = ["DriverRegistry", "DistributedWorker", "ServingCluster"]

_M_HEARTBEAT_FAILURES = _metric_counter(
    "mmlspark_heartbeat_failures_total",
    "Heartbeat re-register attempts that exhausted their retry budget")

_M_WORKER_LIVENESS = _metric_gauge(
    "mmlspark_worker_liveness",
    "Per-worker liveness state as a one-hot over "
    "alive/suspect/draining/dead (1 for the current state)",
    ("worker", "state"))

_M_DEAD_VERDICTS = _metric_counter(
    "mmlspark_worker_dead_verdicts_total",
    "Workers declared dead by the driver's liveness sweeper")


def _adopt_policy() -> str:
    """``MMLSPARK_TPU_ADOPT_POLICY``: ``warm`` (default) ships exported KV
    page blobs over ``/_adopt`` on graceful drain — zero recompute on the
    receiver; ``cold`` strips the blobs and relies on journal replay /
    re-prefill (deterministic for greedy, cheaper on the wire)."""
    policy = os.environ.get("MMLSPARK_TPU_ADOPT_POLICY", "warm").strip().lower()
    return policy if policy in ("warm", "cold") else "warm"


def _giveup(exc: BaseException) -> bool:
    # an HTTPError is a real response (the peer is up — 404 means "already
    # answered", not "try again"); BreakerOpen/DeadlineExceeded are the
    # fail-fast signals retrying would defeat
    return isinstance(exc, (urllib.error.HTTPError, BreakerOpen,
                            DeadlineExceeded))


#: default client policy for cross-process hops: three quick attempts with
#: full jitter — rides out one ECONNREFUSED during a worker restart without
#: stretching a dead-peer verdict past ~1s
_HTTP_RETRY = RetryPolicy(max_attempts=3, base_delay=0.05, max_delay=0.5,
                          retry_on=(OSError,), giveup=_giveup)


def _http_json(url: str, payload: Optional[dict] = None,
               timeout: float = 10.0, *, site: str = "peer_http",
               retry: Optional[RetryPolicy] = None,
               breaker: Optional[CircuitBreaker] = None,
               deadline: Optional[Deadline] = None) -> dict:
    """Retrying, breaker-guarded, deadline-aware JSON-over-HTTP client for
    every cross-process hop. With all guards at their defaults and faults
    disabled the per-attempt work is identical to a plain ``urlopen``."""
    policy = retry if retry is not None else _HTTP_RETRY

    def attempt() -> dict:
        budget = timeout if deadline is None else deadline.cap(timeout)
        if budget <= 0:
            # out of budget is the caller's clock running out, not a peer
            # failure — checked before allow() so it can't strand the
            # half-open probe slot
            raise DeadlineExceeded(url)
        if breaker is not None and not breaker.allow():
            raise BreakerOpen(breaker.peer)
        try:
            injector = get_injector()
            if injector.enabled:
                injector.fire(site)
            data = (json.dumps(payload).encode()
                    if payload is not None else None)
            headers = {"Content-Type": "application/json"}
            if deadline is not None:
                headers[DEADLINE_HEADER] = deadline.header_value()
            req = urllib.request.Request(url, data=data, headers=headers)
            with urllib.request.urlopen(req, timeout=budget) as r:
                out = json.loads(r.read().decode() or "{}")
        except urllib.error.HTTPError:
            # the peer answered — that's a transport success
            if breaker is not None:
                breaker.record_success()
            raise
        except BaseException:
            if breaker is not None:
                breaker.record_failure()
            raise
        if breaker is not None:
            breaker.record_success()
        return out

    return policy.call(attempt, site=site, deadline=deadline)


class _RegistryHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        pass

    def _json(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        reg: "DriverRegistry" = self.server.registry  # type: ignore[attr-defined]
        length = int(self.headers.get("Content-Length") or 0)
        payload = json.loads(self.rfile.read(length) or b"{}")
        if self.path == "/register":
            info = reg.register(payload["worker_id"], payload["address"])
            self._json(200, info)
        elif self.path == "/deregister":
            reg.deregister(payload["worker_id"])
            self._json(200, {"ok": True})
        elif self.path == "/heartbeat":
            known = reg.heartbeat(payload["worker_id"],
                                  digest=payload.get("digest"),
                                  telemetry=payload.get("telemetry"))
            self._json(200 if known else 410, {"known": known})
        else:
            self._json(404, {"error": f"no route {self.path}"})

    def do_GET(self):
        reg: "DriverRegistry" = self.server.registry  # type: ignore[attr-defined]
        if self.path == "/routing":
            self._json(200, reg.routing_table())
        elif self.path == "/workers":
            self._json(200, reg.workers())
        elif self.path == "/debug/cluster":
            self._json(200, reg.cluster_view())
        else:
            self._json(404, {"error": f"no route {self.path}"})


class DriverRegistry:
    """Driver-side worker registry + routing table.

    Re-registration with a known ``worker_id`` *replaces* the address and
    bumps the generation — that is the failure-recovery contract
    (``registerPartition`` sees the same epoch and rehydrates,
    ``HTTPSourceV2.scala:489-506``).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 liveness_timeout: float = 30.0,
                 liveness_interval: Optional[float] = None,
                 sweep_multiplier: Optional[float] = None):
        self._workers: Dict[str, dict] = {}
        self._lock = new_lock("serving.distributed.DriverRegistry._lock")
        self._generation = 0
        #: cluster-wide metrics federation: merges the counter/histogram/
        #: SLO snapshots workers piggyback on their heartbeats
        self.aggregator = ClusterAggregator()
        #: driver-side time-series plane: cluster series (per-worker
        #: queue depth / in-flight / HBM from digests, merged goodput and
        #: burn rate from the aggregator) accrue at the heartbeat — the
        #: same observation point /debug/cluster serves. Keyed by
        #: worker_id, so a restarted worker continues its series.
        self.timeseries = ClusterSampler()
        self.liveness_timeout = liveness_timeout
        # active liveness: a sweeper thread walks the worker table every
        # `liveness_interval` seconds, promoting missed heartbeats past
        # interval x sweep_multiplier to a DEAD verdict (eviction + the
        # on-dead callbacks that reassign journaled sessions). Unset /
        # non-positive keeps the legacy lazy-prune-only behavior.
        if liveness_interval is None:
            raw = os.environ.get("MMLSPARK_TPU_LIVENESS_INTERVAL", "")
            liveness_interval = float(raw) if raw else 0.0
        self.liveness_interval = float(liveness_interval or 0.0)
        if sweep_multiplier is None:
            sweep_multiplier = float(os.environ.get(
                "MMLSPARK_TPU_LIVENESS_SWEEP_MULT", "3.0"))
        self.sweep_multiplier = max(1.0, float(sweep_multiplier))
        #: worker ids mid-graceful-drain: still heartbeating (so not dead),
        #: but excluded from the routing table so no new traffic lands
        self._draining: set = set()
        self._dead_callbacks: List[Callable[[str, dict], None]] = []
        self._sweep_stop = threading.Event()
        self._sweep_thread: Optional[threading.Thread] = None
        self._httpd = ThreadingHTTPServer((host, port), _RegistryHandler)
        # keep-alive handler threads must not block process exit
        self._httpd.daemon_threads = True
        self._httpd.registry = self  # type: ignore[attr-defined]
        self.host, self.port = host, self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name=f"driver-registry-{self.port}",
                                        daemon=True)
        self._thread.start()
        if self.liveness_interval > 0:
            self._sweep_thread = start_supervised(
                self._sweep_once, name=f"liveness-sweeper-{self.port}",
                stop=self._sweep_stop, interval=self.liveness_interval)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _prune_locked(self, now: float) -> None:
        stale = [w for w, i in self._workers.items()
                 if now - i["last_seen"] >= self.liveness_timeout]
        for w in stale:
            del self._workers[w]
            self._draining.discard(w)

    # -- active liveness ---------------------------------------------------
    def _state_locked(self, worker_id: str, info: dict, now: float) -> str:
        """One of :data:`~.registry.WORKER_LIVENESS_STATES` for a worker
        still present in the table (``dead`` means the sweeper is about to
        evict it — the verdict)."""
        if worker_id in self._draining:
            return "draining"
        if self.liveness_interval <= 0:
            return "alive"
        age = now - info["last_seen"]
        if age < self.liveness_interval:
            return "alive"
        if age < self.liveness_interval * self.sweep_multiplier:
            return "suspect"
        return "dead"

    def _sweep_once(self) -> None:
        """One sweeper tick: refresh the liveness gauge for every worker,
        promote missed heartbeats past interval x multiplier to a dead
        verdict — evict from the table (and hence every routing view), then
        fire the on-dead callbacks outside the lock so they can take HTTP
        hops (session reassignment) without stalling registrations."""
        now = time.time()
        dead: List[Tuple[str, dict]] = []
        with self._lock:
            for w, i in list(self._workers.items()):
                state = self._state_locked(w, i, now)
                for s in WORKER_LIVENESS_STATES:
                    _M_WORKER_LIVENESS.set(1.0 if s == state else 0.0,
                                           worker=w, state=s)
                if state == "dead":
                    dead.append((w, dict(i)))
                    del self._workers[w]
                    self._draining.discard(w)
                    self._generation += 1
        for w, info in dead:
            _M_DEAD_VERDICTS.inc()
            _M_WORKER_LIVENESS.set(1.0, worker=w, state="dead")
            _log_event("worker_dead_verdict", worker_id=w,
                       address=info.get("address"),
                       last_seen_age=round(now - info["last_seen"], 3))
            for fn in list(self._dead_callbacks):
                try:
                    fn(w, info)
                except Exception as exc:
                    _log_event("dead_callback_failed", worker_id=w,
                               error=repr(exc))

    def add_dead_callback(self, fn: Callable[[str, dict], None]) -> None:
        """Register ``fn(worker_id, info)`` to run after a dead verdict
        (post-eviction; ``info`` still carries the last known address and
        digest). ServingCluster hooks session reassignment here."""
        self._dead_callbacks.append(fn)

    def mark_draining(self, worker_id: str) -> bool:
        """Graceful-drain entry: keep the worker registered (it still
        heartbeats and answers its parked requests) but drop it from
        :meth:`routing_table` so peers stop forwarding new work to it."""
        with self._lock:
            if worker_id not in self._workers:
                return False
            self._draining.add(worker_id)
            self._generation += 1
        _log_event("worker_draining", worker_id=worker_id)
        return True

    def register(self, worker_id: str, address: str) -> dict:
        now = time.time()
        with self._lock:
            self._prune_locked(now)  # crashed workers never /deregister
            prior = self._workers.get(worker_id)
            self._generation += 1
            # a re-registration is a fresh incarnation — it starts routable
            self._draining.discard(worker_id)
            self._workers[worker_id] = {"address": address,
                                        "generation": self._generation,
                                        "last_seen": now}
            return {"generation": self._generation,
                    "recovered": prior is not None,
                    "peers": {w: i["address"]
                              for w, i in self._workers.items()}}

    def deregister(self, worker_id: str) -> None:
        with self._lock:
            self._workers.pop(worker_id, None)
            self._draining.discard(worker_id)
            self._generation += 1
        # federation history survives the departure (forget() keeps the
        # accumulated totals — a dead worker's work still happened)
        self.aggregator.forget(worker_id)

    def heartbeat(self, worker_id: str, digest: Optional[dict] = None,
                  telemetry: Optional[dict] = None) -> bool:
        with self._lock:
            info = self._workers.get(worker_id)
            if info is None:
                return False
            info["last_seen"] = time.time()
            if digest is not None:
                info["digest"] = digest
        if telemetry is not None:
            self.aggregator.ingest(worker_id, telemetry)
        # feed the cluster series at the observation point: digest fields
        # directly, goodput/burn from the aggregator's merged totals only
        # when this heartbeat actually carried telemetry (otherwise the
        # delta window would dilute to zero)
        self.timeseries.observe(
            worker_id, digest=digest,
            scorecard=(self.aggregator.scorecard()
                       if telemetry is not None else None))
        return True

    def routing_table(self) -> Dict[str, str]:
        now = time.time()
        with self._lock:
            self._prune_locked(now)
            # draining workers are alive but not routable: peers rebuild
            # their ConsistentHashRing from this table, so exclusion here
            # is what actually moves the prefix keyspace off the worker
            return {w: i["address"] for w, i in self._workers.items()
                    if w not in self._draining}

    def workers(self) -> Dict[str, dict]:
        """Per-worker health view: routing info + liveness state + the
        latest heartbeat digest (queue depth, in-flight, open breakers,
        stall age)."""
        now = time.time()
        with self._lock:
            self._prune_locked(now)
            return {w: {"address": i["address"],
                        "generation": i["generation"],
                        "last_seen_age": round(now - i["last_seen"], 3),
                        "state": self._state_locked(w, i, now),
                        "digest": i.get("digest")}
                    for w, i in self._workers.items()}

    def cluster_view(self) -> dict:
        """The ``GET /debug/cluster`` payload: merged Prometheus text,
        the cluster SLO scorecard, and per-worker health digests."""
        return {"metrics": self.aggregator.render(),
                "scorecard": self.aggregator.scorecard(),
                "timeseries": self.timeseries.snapshot(),
                "workers": self.workers()}

    def close(self) -> None:
        self._sweep_stop.set()
        if self._sweep_thread is not None:
            self._sweep_thread.join(timeout=2)
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


class DistributedWorker:
    """A WorkerServer registered with a driver, with cross-worker routing.

    Internal control endpoints (parity: the reference's internal server +
    load balancer, ``HTTPSourceV2.scala:664-697``):

    * ``/_reply`` — accept a routed reply for a request parked *here*
    * ``/_forward`` — accept a forwarded public request (served locally even
      when this worker is in forwarding mode, to prevent loops)
    """

    def __init__(self, driver_url: str, worker_id: str,
                 host: str = "127.0.0.1", port: int = 0,
                 reply_timeout: float = 60.0,
                 heartbeat_interval: float = 10.0,
                 advertise_host: str = "",
                 max_queue: int = 10_000,
                 journal_path: Optional[str] = None,
                 journal_fsync: bool = False):
        self.driver_url = driver_url
        self.worker_id = worker_id
        self.max_queue = int(max_queue)
        self.journal_path = journal_path
        self.server = WorkerServer(host=host, port=port,
                                   reply_timeout=reply_timeout,
                                   max_queue=self.max_queue,
                                   journal_path=journal_path,
                                   journal_fsync=journal_fsync)
        self.server.control_routes["/_reply"] = self._handle_remote_reply
        self.server.control_routes["/_adopt"] = self._handle_adopt
        #: failover pluggables: ``adopt_handler(payload) -> dict`` overrides
        #: the journal-only default (a decoder harness attaches
        #: ``restore_session`` here); ``session_exporter() -> [entries]``
        #: is what drain_worker calls to checkpoint live sessions
        self.adopt_handler: Optional[Callable[[dict], dict]] = None
        self.session_exporter: Optional[Callable[[], List[dict]]] = None
        #: sessions accepted over ``/_adopt`` (newest last) — the in-memory
        #: twin of the journal record, inspectable by drills and tests
        self.adopted_sessions: List[dict] = []
        self.has_engine = True
        self._peers: Dict[str, str] = {}
        self._rr = 0
        #: prefix-affine placement: requests carrying a KV-prefix key
        #: (X-Mmlspark-Prefix) route to the worker whose pool already
        #: holds those pages; rebuilt on every peer-table change
        self._ring = ConsistentHashRing()
        #: worker id → forwards currently in flight (bounded-load input)
        self._fwd_inflight: Dict[str, int] = {}
        self._lock = new_lock("serving.distributed.DistributedWorker._lock")
        # the registered address must be PEER-routable: a 0.0.0.0 bind
        # address handed to peers would make them connect to themselves
        # (and /_forward always serves locally, so the wrong worker answers)
        if not advertise_host and host in ("0.0.0.0", "::"):
            import socket as _socket
            advertise_host = _socket.gethostbyname(_socket.gethostname())
        advertised = (f"http://{advertise_host}:{self.server.port}"
                      if advertise_host else self.server.address.rstrip("/"))
        self.advertised_address = advertised.rstrip("/")
        # its own site name: construction-time registration is not a peer
        # hop, and chaos specs targeting peer_http must not be able to kill
        # a worker while it boots
        info = _http_json(driver_url + "/register",
                          {"worker_id": worker_id,
                           "address": self.advertised_address},
                          site="register")
        self.generation = info["generation"]
        self.recovered = info["recovered"]
        self._peers = {w: a for w, a in info["peers"].items()
                       if w != worker_id}
        self._ring.rebuild(self._peers)
        # forwarding entry: serve locally, never re-forward
        self.server.control_routes["/_forward"] = self._handle_forwarded
        # keep last_seen fresh — without this the registry's liveness filter
        # would silently drop every worker after liveness_timeout
        self._hb_stop = threading.Event()
        # federation pacing: 0.0 forces telemetry on the FIRST heartbeat
        self._last_telemetry_t = 0.0
        # re-register retries get their own, more patient budget than the
        # default client policy — losing the registry entry for good is
        # worse than a slightly tardy heartbeat tick
        self._hb_policy = RetryPolicy(max_attempts=4, base_delay=0.1,
                                      max_delay=1.0, retry_on=(OSError,),
                                      giveup=_giveup)
        # supervised, not a bare daemon loop: a tick that raises (e.g. a
        # bug in digest collection) is contained and backed off instead of
        # silently killing the heartbeat — which would look exactly like a
        # dead worker to the driver's sweeper
        self._hb_thread = start_supervised(
            self._heartbeat_tick, name=f"heartbeat-{worker_id}",
            stop=self._hb_stop, interval=heartbeat_interval)

    def _heartbeat_tick(self) -> None:
        if self.heartbeat():
            return
        # registry forgot us (pruned while unreachable) → re-register;
        # a permanently-lost worker must be VISIBLE, not silent
        try:
            _http_json(self.driver_url + "/register",
                       {"worker_id": self.worker_id,
                        "address": self.advertised_address},
                       site="heartbeat", retry=self._hb_policy)
        except Exception as exc:
            _M_HEARTBEAT_FAILURES.inc()
            _log_event("heartbeat_reregister_failed",
                       worker_id=self.worker_id, error=repr(exc))

    # -- registry interaction ----------------------------------------------
    def refresh_peers(self) -> Dict[str, str]:
        table = _http_json(self.driver_url + "/routing", site="peer_http")
        with self._lock:
            self._peers = {w: a for w, a in table.items()
                           if w != self.worker_id}
            peers = dict(self._peers)
        # ring membership follows the routing table — restart_worker and
        # deregister both end here (ServingCluster refreshes every peer),
        # so only ~1/n of the prefix keyspace moves per membership change
        if self._ring.rebuild(peers):
            _log_event("ring_rebuilt", worker_id=self.worker_id,
                       nodes=len(peers))
        return peers

    def heartbeat(self) -> bool:
        """One keep-alive tick. Every heartbeat piggybacks the server's
        health digest; a compact metrics+SLO snapshot rides along at the
        federation interval (``MMLSPARK_TPU_FEDERATION_INTERVAL``: 0 =
        every heartbeat, negative = disabled) — the driver merges it into
        the cluster aggregator with counter-reset protection."""
        # canary governance ticks here, off the request path: one rolling
        # window comparison per heartbeat interval (auto-rollback fires
        # even on a worker receiving no canary traffic of its own)
        try:
            _get_model_registry().check_canaries()
        except Exception as exc:
            _log_event("canary_check_failed", worker_id=self.worker_id,
                       error=repr(exc))
        payload = {"worker_id": self.worker_id,
                   "digest": self.server.health_digest()}
        interval = snapshot_interval()
        now = time.monotonic()
        send_telemetry = (interval >= 0
                          and (interval == 0
                               or now - self._last_telemetry_t >= interval))
        if send_telemetry:
            payload["telemetry"] = worker_snapshot()
        try:
            out = _http_json(self.driver_url + "/heartbeat", payload,
                             site="heartbeat").get("known", False)
        except Exception:
            return False
        if send_telemetry and out:
            self._last_telemetry_t = now
        return out

    # -- engine surface ------------------------------------------------------
    def get_batch(self, max_rows: int, timeout: float = 0.1
                  ) -> List[Tuple[str, CachedRequest]]:
        return [(self.worker_id, c)
                for c in self.server.get_batch(max_rows, timeout)]

    # -- reply routing -------------------------------------------------------
    def reply(self, owner_id: str, request_id: str,
              response: HTTPResponseData) -> bool:
        """Reply to a request parked on ``owner_id`` — locally or over HTTP
        (parity: ``HTTPSourceStateHolder.getServer(ip).replyTo``)."""
        if owner_id == self.worker_id:
            return self.server.reply(request_id, response)
        addr = self._peers.get(owner_id)
        if addr is None:
            try:
                self.refresh_peers()
            except Exception:
                return False
            addr = self._peers.get(owner_id)
            if addr is None:
                return False
        try:
            out = _http_json(addr + "/_reply",
                             {"request_id": request_id,
                              "response": response.to_dict()},
                             breaker=breaker_for(addr))
        except Exception:
            # same contract as the local branch: an already-answered /
            # timed-out / unreachable target is False, never an exception
            return False
        return bool(out.get("ok"))

    def _handle_remote_reply(self, req: HTTPRequestData) -> HTTPResponseData:
        payload = json.loads(req.entity.content if req.entity else b"{}")
        # server.reply is where the request's root span closes (exactly
        # once, on THIS owning worker) and its counters tick — the hop
        # itself only logs, so forwarded replies aren't double-billed
        ok = self.server.reply(payload["request_id"],
                               HTTPResponseData.from_dict(payload["response"]))
        _log_event("remote_reply", worker_id=self.worker_id,
                   request_id=payload.get("request_id"), ok=ok)
        return HTTPResponseData(
            entity=EntityData.from_string(json.dumps({"ok": ok})),
            status_line=StatusLineData(status_code=200 if ok else 404))

    # -- session adoption (failover / drain handoff) -------------------------
    def adopt_sessions(self, payload: dict) -> dict:
        """Accept sessions handed over by the driver/cluster.

        Payload: ``{"sessions": [{"session": <canonical session>,
        "kv": <page blob or null>}], "mode": "warm"|"cold", "from": id}``.
        With :attr:`adopt_handler` set (a decoder harness binding
        ``ContinuousDecoder.restore_session``), the whole payload is
        delegated there. The default journals each session into this
        worker's own journal — write-ahead, so an adopted session survives
        a second failure before any engine picks it up — and records it in
        :attr:`adopted_sessions`.
        """
        entries = payload.get("sessions") or []
        mode = payload.get("mode", "cold")
        if self.adopt_handler is not None:
            out = self.adopt_handler(payload)
            if isinstance(out, dict):
                return out
            return {"ok": True, "adopted": len(entries), "mode": mode,
                    "worker": self.worker_id}
        adopted = 0
        journal = self.server._journal
        for entry in entries:
            sess = entry.get("session") or {}
            sid = str(sess.get("id") or "")
            if not sid:
                continue
            if journal is not None:
                journal.record_session(sid, sess.get("prompt") or [],
                                       sess.get("params") or {},
                                       phash=sess.get("phash"))
                emitted = sess.get("emitted") or []
                if emitted:
                    journal.record_session_tokens(sid, emitted)
            self.adopted_sessions.append(entry)
            adopted += 1
        _log_event("sessions_adopted", worker_id=self.worker_id,
                   n=adopted, mode=mode, source=payload.get("from"))
        return {"ok": True, "adopted": adopted, "mode": mode,
                "worker": self.worker_id}

    def _handle_adopt(self, req: HTTPRequestData) -> HTTPResponseData:
        payload = json.loads(req.entity.content if req.entity else b"{}")
        try:
            out = self.adopt_sessions(payload)
        except Exception as exc:
            body = json.dumps({"ok": False, "error": repr(exc)})
            return HTTPResponseData(
                entity=EntityData.from_string(body),
                status_line=StatusLineData(status_code=500))
        return HTTPResponseData(
            entity=EntityData.from_string(json.dumps(out)),
            status_line=StatusLineData(status_code=200))

    # -- request forwarding (load balancing) ---------------------------------
    _FWD_PREFIX = "/_forward"
    _FWD_HDR = "X-Mmlspark-Original-Method"

    def _handle_forwarded(self, req: HTTPRequestData) -> HTTPResponseData:
        # restore the client's original path/query and method before parking
        if req.url.startswith(self._FWD_PREFIX):
            req.url = req.url[len(self._FWD_PREFIX):] or "/"
        for h in req.headers:
            if h.name == self._FWD_HDR:
                req.method = h.value
        req.headers = [h for h in req.headers if h.name != self._FWD_HDR]
        try:
            cached = self.server._enqueue(req)
        except Overloaded as exc:
            return HTTPResponseData(
                headers=[HeaderData("Retry-After", f"{exc.retry_after:g}")],
                status_line=StatusLineData(status_code=429,
                                           reason_phrase="overloaded"))
        resp = cached.wait(self.server.wait_budget(cached))
        if resp is None:
            return HTTPResponseData(
                status_line=StatusLineData(status_code=504,
                                           reason_phrase="forwarded timeout"))
        return resp

    def enable_forwarding(self) -> None:
        """Engine detached: forward public requests round-robin to peers
        instead of parking them (parity: load balancer ``:679-687``)."""
        self.has_engine = False
        self.server.control_routes["/"] = self._forward_out

    def disable_forwarding(self) -> None:
        self.has_engine = True
        self.server.control_routes.pop("/", None)

    def _note_forward(self, worker_id: str, delta: int) -> None:
        with self._lock:
            n = self._fwd_inflight.get(worker_id, 0) + delta
            if n > 0:
                self._fwd_inflight[worker_id] = n
            else:
                self._fwd_inflight.pop(worker_id, None)

    def _forward_candidates(self, req: HTTPRequestData
                            ) -> List[Tuple[str, str]]:
        """Peer try-order for one forwarded request as ``(worker_id,
        address)`` pairs. Requests carrying a KV-prefix affinity key
        (``X-Mmlspark-Prefix``, the hex of ``PagedKVPool.prefix_hash``)
        go ring-first: the owning worker's pool already holds their
        shared-prefix pages, with bounded-load fallback to the next ring
        position when the owner is saturated. Unkeyed requests keep the
        round-robin rotation."""
        affinity = None
        for h in req.headers:
            if h.name.lower() == AFFINITY_HEADER.lower():
                affinity = h.value.strip() or None
        with self._lock:
            peer_map = dict(self._peers)
            start = self._rr
            self._rr += 1
            load = dict(self._fwd_inflight)
        if not peer_map:
            return []
        if affinity is not None and len(self._ring):
            first = self._ring.route(affinity, load=load)
            order = [w for w in self._ring.preferred(affinity)
                     if w in peer_map]
            if first in peer_map:
                order = [first] + [w for w in order if w != first]
            if order:
                return [(w, peer_map[w]) for w in order]
        items = sorted(peer_map.items())
        return [items[(start + i) % len(items)] for i in range(len(items))]

    def _forward_out(self, req: HTTPRequestData) -> HTTPResponseData:
        candidates = self._forward_candidates(req)
        if not candidates:
            return HTTPResponseData(
                status_line=StatusLineData(status_code=503,
                                           reason_phrase="no peers"))
        # never wait past what the client has left: honor an inbound
        # deadline, else budget this hop with our own reply_timeout
        deadline = None
        for h in req.headers:
            if h.name.lower() == DEADLINE_HEADER.lower():
                deadline = Deadline.from_header(h.value)
        if deadline is None:
            deadline = Deadline.after(self.server.reply_timeout)
        body = req.entity.content if req.entity else None
        # carry the client's path/query, method, and headers across the hop
        base_hdrs = {h.name: h.value for h in req.headers
                     if h.name.lower() not in ("host", "content-length",
                                               "connection")}
        base_hdrs[self._FWD_HDR] = req.method
        injector = get_injector()
        # try each peer at most once, in candidate order, skipping open
        # circuits; 502 only once every peer has been exhausted
        for wid, addr in candidates:
            brk = breaker_for(addr)
            remaining = deadline.remaining()
            if remaining <= 0:
                return HTTPResponseData(
                    status_line=StatusLineData(status_code=504,
                                               reason_phrase="deadline"))
            if not brk.allow():
                continue
            hop_hdrs = dict(base_hdrs)
            hop_hdrs[DEADLINE_HEADER] = deadline.header_value()
            fwd = urllib.request.Request(
                addr + self._FWD_PREFIX + req.url, data=body,
                headers=hop_hdrs, method="POST" if body else "GET")
            self._note_forward(wid, +1)
            try:
                if injector.enabled:
                    injector.fire("peer_http")
                # the peer enforces the deadline (parks at most `remaining`);
                # the socket timeout is only a dead-peer guard, and needs
                # slack so the peer's own 504 arrives instead of racing it
                with urllib.request.urlopen(fwd, timeout=remaining + 1.0) as r:
                    payload = r.read()
                    brk.record_success()
                    return HTTPResponseData(
                        entity=EntityData(content=payload,
                                          content_length=len(payload)),
                        status_line=StatusLineData(status_code=r.status))
            except urllib.error.HTTPError as e:
                # the peer answered (504/429/...): relay it, don't fail over
                payload = e.read()
                brk.record_success()
                return HTTPResponseData(
                    entity=EntityData(content=payload,
                                      content_length=len(payload)),
                    status_line=StatusLineData(status_code=e.code))
            except Exception as exc:
                brk.record_failure()
                _tracing.add_event("forward_failover", peer=addr,
                                   error=type(exc).__name__)
            finally:
                self._note_forward(wid, -1)
        return HTTPResponseData(
            status_line=StatusLineData(status_code=502,
                                       reason_phrase="no reachable peer"))

    def close(self, deregister: bool = True) -> None:
        self._hb_stop.set()
        if deregister:
            try:
                _http_json(self.driver_url + "/deregister",
                           {"worker_id": self.worker_id}, site="register")
            except Exception as exc:
                # best-effort on shutdown (liveness pruning will finish the
                # job), but leave a trace for anyone chasing ghosts
                _log_event("deregister_failed", worker_id=self.worker_id,
                           error=repr(exc))
        self.server.close()
        self._hb_thread.join(timeout=2)


class ServingCluster:
    """N distributed workers + driver registry in one process — the test
    harness shape (reference tests distributed serving in local mode too,
    SURVEY §4). The aggregate ``get_batch``/``reply`` pair is the
    distributed source/sink surface an engine loop drives."""

    def __init__(self, n_workers: int, reply_timeout: float = 60.0,
                 max_queue: int = 10_000,
                 liveness_interval: Optional[float] = None,
                 heartbeat_interval: float = 10.0,
                 journal_dir: Optional[str] = None):
        self.driver = DriverRegistry(liveness_interval=liveness_interval)
        #: worker id → journal path (survives the worker object: the dead
        #: worker's journal is what cold reassignment scans)
        self._journal_paths: Dict[str, str] = {}
        self.workers: List[DistributedWorker] = []
        for i in range(n_workers):
            wid = f"worker-{i}"
            jp = None
            if journal_dir is not None:
                jp = os.path.join(journal_dir, f"{wid}.journal")
                self._journal_paths[wid] = jp
            self.workers.append(
                DistributedWorker(self.driver.url, wid,
                                  reply_timeout=reply_timeout,
                                  max_queue=max_queue,
                                  heartbeat_interval=heartbeat_interval,
                                  journal_path=jp))
        for w in self.workers:
            w.refresh_peers()
        # failover: a sweeper dead-verdict evicts the worker from routing;
        # this callback evicts it from every survivor's ring (refresh) and
        # replays its journaled sessions onto a survivor via /_adopt
        self.driver.add_dead_callback(self._on_worker_dead)

    def worker(self, worker_id: str) -> DistributedWorker:
        for w in self.workers:
            if w.worker_id == worker_id:
                return w
        raise KeyError(worker_id)

    def get_batch(self, max_rows: int, timeout: float = 0.05
                  ) -> List[Tuple[str, CachedRequest]]:
        # non-blocking sweep over every worker; one short sleep only if the
        # whole cluster is idle (a per-worker blocking get would add
        # N*timeout dead time to each poll)
        def sweep():
            got: List[Tuple[str, CachedRequest]] = []
            for w in self.workers:
                if not w.has_engine:
                    continue
                got.extend(w.get_batch(max_rows - len(got), timeout=0.0))
                if len(got) >= max_rows:
                    break
            return got

        out = sweep()
        if not out and timeout > 0:
            time.sleep(timeout)
            out = sweep()
        return out

    def reply(self, owner_id: str, request_id: str,
              response: HTTPResponseData) -> bool:
        # any live worker can route the reply; prefer the owner directly
        try:
            return self.worker(owner_id).server.reply(request_id, response)
        except KeyError:
            pass
        # unknown owner (registry drift / restarted elsewhere): route via
        # the first worker whose server is still open — a closed worker
        # can't speak HTTP to the owner anymore
        for w in self.workers:
            if not w.server.closed:
                return w.reply(owner_id, request_id, response)
        return False

    def scorecard(self) -> dict:
        """Cluster SLO scorecard from the driver's federation aggregator,
        with per-worker health digests attached (the in-process twin of
        ``GET /debug/cluster``)."""
        card = dict(self.driver.aggregator.scorecard())
        card["worker_health"] = self.driver.workers()
        return card

    def restart_worker(self, worker_id: str,
                       reply_timeout: Optional[float] = None
                       ) -> DistributedWorker:
        """Chaos/ops helper: kill one worker ungracefully (no deregister —
        a crash doesn't say goodbye) and re-register a replacement under
        the SAME id, exercising the recovery contract. The replacement
        reopens the same journal, so the dead incarnation's sessions are
        replayable on it (``scan_sessions``/``replay_sessions``)."""
        for i, w in enumerate(self.workers):
            if w.worker_id != worker_id:
                continue
            w.close(deregister=False)
            replacement = DistributedWorker(
                self.driver.url, worker_id,
                reply_timeout=(reply_timeout if reply_timeout is not None
                               else w.server.reply_timeout),
                max_queue=w.max_queue,
                journal_path=self._journal_paths.get(worker_id))
            self.workers[i] = replacement
            for peer in self.workers:
                try:
                    peer.refresh_peers()
                except Exception as exc:
                    _log_event("refresh_peers_failed",
                               worker_id=peer.worker_id, error=repr(exc))
            return replacement
        raise KeyError(worker_id)

    # -- session failover --------------------------------------------------
    def _survivors(self, exclude: str) -> List[DistributedWorker]:
        return [w for w in self.workers
                if w.worker_id != exclude and not w.server.closed]

    def _on_worker_dead(self, worker_id: str, info: dict) -> None:
        """Sweeper dead-verdict hook: the registry already evicted the
        worker from the routing table; refresh every survivor (ring
        eviction) and cold-reassign the dead worker's journaled sessions."""
        survivors = self._survivors(worker_id)
        for w in survivors:
            try:
                w.refresh_peers()
            except Exception as exc:
                _log_event("refresh_peers_failed", worker_id=w.worker_id,
                           error=repr(exc))
        self.reassign_sessions(worker_id, survivors=survivors)

    def reassign_sessions(self, worker_id: str,
                          survivors: Optional[List[DistributedWorker]] = None
                          ) -> dict:
        """Cold path: scan the (dead) worker's journal for live sessions
        and replay them onto a survivor over ``/_adopt``. Read-only on the
        journal — safe while the dead incarnation's fd is still open."""
        path = self._journal_paths.get(worker_id)
        if path is None or not os.path.exists(path):
            return {"ok": True, "adopted": 0, "mode": "cold"}
        try:
            sessions = ServingJournal.scan_sessions(path)
        except Exception as exc:
            _log_event("session_reassign_failed", worker_id=worker_id,
                       error=repr(exc))
            return {"ok": False, "adopted": 0, "error": repr(exc)}
        if not sessions:
            return {"ok": True, "adopted": 0, "mode": "cold"}
        survivors = (survivors if survivors is not None
                     else self._survivors(worker_id))
        if not survivors:
            _log_event("session_reassign_failed", worker_id=worker_id,
                       error="no surviving workers")
            return {"ok": False, "adopted": 0, "error": "no survivors"}
        target = survivors[0]
        # scan_sessions keys by id; the canonical per-session form the
        # adopter expects carries it inline
        payload = {"sessions": [{"session": dict(s, id=sid), "kv": None}
                                for sid, s in sessions.items()],
                   "mode": "cold", "from": worker_id}
        try:
            out = _http_json(target.advertised_address + "/_adopt", payload,
                             site="peer_http")
        except Exception as exc:
            _log_event("session_reassign_failed", worker_id=worker_id,
                       error=repr(exc))
            return {"ok": False, "adopted": 0, "error": repr(exc)}
        _log_event("sessions_reassigned", worker_id=worker_id,
                   target=target.worker_id, n=out.get("adopted"))
        return out

    def drain_worker(self, worker_id: str,
                     target_id: Optional[str] = None) -> dict:
        """Graceful drain: mark the worker draining (no new routed traffic),
        hand its live sessions to a survivor over ``/_adopt`` — warm by
        default (exported KV page blobs, zero recompute on the receiver),
        cold under ``MMLSPARK_TPU_ADOPT_POLICY=cold`` — then deregister and
        retire the worker. Preserves the at-most-once reply edge: parked
        requests drain on the old worker; only *sessions* move."""
        w = self.worker(worker_id)
        self.driver.mark_draining(worker_id)
        policy = _adopt_policy()
        entries: List[dict] = []
        if w.session_exporter is not None:
            entries = list(w.session_exporter() or [])
        if policy == "cold":
            entries = [{"session": e.get("session"), "kv": None}
                       for e in entries]
        out = {"ok": True, "adopted": 0, "mode": policy}
        if entries:
            survivors = self._survivors(worker_id)
            if not survivors:
                raise RuntimeError(
                    f"drain {worker_id}: no surviving worker to adopt "
                    f"{len(entries)} session(s)")
            target = (self.worker(target_id) if target_id is not None
                      else survivors[0])
            out = _http_json(target.advertised_address + "/_adopt",
                             {"sessions": entries, "mode": policy,
                              "from": worker_id},
                             site="peer_http")
        w.close(deregister=True)
        self.workers = [x for x in self.workers if x.worker_id != worker_id]
        for peer in self.workers:
            try:
                peer.refresh_peers()
            except Exception as exc:
                _log_event("refresh_peers_failed", worker_id=peer.worker_id,
                           error=repr(exc))
        _log_event("worker_drained", worker_id=worker_id,
                   adopted=out.get("adopted"), mode=policy)
        return out

    def close(self) -> None:
        for w in self.workers:
            w.close()
        self.driver.close()
