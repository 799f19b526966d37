"""Long-decode session survivability drill for open-loop scenarios.

The ``decode-kill`` scenario runs live "generation sessions" alongside the
request traffic: each session is a real journal record stream (insert
record + per-tick emitted-token tails, the same ``sess``/``tail`` schema
``ContinuousDecoder`` writes) owned by one worker, with tokens produced by
a deterministic ticking stand-in — the loadgen twin of
``cluster_echo_engine``, which stands in for the model engine the same
way. When the chaos script kills the owning worker mid-decode, the drill
recovers exactly the way the serving plane does: scan the dead worker's
journal (``ServingJournal.scan_sessions``), ship the live sessions to a
survivor over the real ``/_adopt`` control hop, and resume emission from
the journaled tail. The scorecard gains ``sessions_lost`` /
``sessions_recovered`` / ``recovery_p99_ms``, and a session counts as
lost unless its final token stream is *identical* to the uninterrupted
run's — the same token-parity bar the real-decoder failover tests
(``tests/test_session_failover.py``) hold the warm/cold paths to.

Serving-plane imports live inside methods, matching ``scenarios.py``: the
plan/describe half of loadgen stays importable with nothing but the
stdlib.

The port's copy of ``mmlspark_tpu/loadgen/sessions.py``.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
import zlib
from typing import Dict, List, Optional

__all__ = ["SessionDrill", "session_token"]


def session_token(session_id: str, index: int) -> int:
    """The deterministic token stream: token ``index`` of ``session_id``.
    Pure, so the expected uninterrupted stream is computable without
    running anything — token parity after a failover is an equality
    check, not a statistical one."""
    return zlib.crc32(f"{session_id}:{index}".encode()) % 997


class SessionDrill:
    """Run ``n_sessions`` journal-backed decode sessions against a
    ``ServingCluster``, surviving mid-run worker kills.

    Lifecycle: :meth:`start` assigns sessions round-robin over the
    cluster's workers (journaling the insert record write-ahead), a
    ticker thread emits one token per live session per tick (journaling
    the tail), and :meth:`finish` waits for every session to complete,
    then returns the ``sessions`` scorecard block. Worker death is
    detected by incarnation change (``restart_worker`` replaces the
    object under the same id) or a closed server; recovery replays the
    dead incarnation's journal onto a survivor via ``/_adopt``.
    """

    def __init__(self, cluster, *, n_sessions: int,
                 tokens_per_session: int = 24,
                 tick_s: float = 0.02,
                 journal_dir: Optional[str] = None):
        self.cluster = cluster
        self.n_sessions = int(n_sessions)
        self.tokens_per_session = int(tokens_per_session)
        self.tick_s = float(tick_s)
        self._dir = journal_dir or tempfile.mkdtemp(prefix="session-drill-")
        self._lock = threading.Lock()
        #: guards the journal map alone — taken inside ``_journal_for``,
        #: which runs both on the ticker and on adopt-handler HTTP threads
        self._jlock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: sid → {"worker", "incarnation", "emitted", "done", "recovered"}
        self._sessions: Dict[str, dict] = {}
        #: drill-owned per-worker journals, keyed by worker id — separate
        #: files from the server's request journal so the drill runs
        #: against clusters constructed without ``journal_dir``
        self._journals: Dict[str, object] = {}
        self._journal_paths: Dict[str, str] = {}
        self._recovery_s: List[float] = []

    # -- journal plumbing ---------------------------------------------------
    def _journal_for(self, worker_id: str):
        from ..serving.journal import ServingJournal
        with self._jlock:
            j = self._journals.get(worker_id)
            if j is None or j.closed:
                path = os.path.join(self._dir, f"{worker_id}.sessions")
                self._journal_paths[worker_id] = path
                j = ServingJournal(path, fsync=False)
                self._journals[worker_id] = j
            return j

    def _worker(self, worker_id: str):
        for w in self.cluster.workers:
            if w.worker_id == worker_id:
                return w
        return None

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "SessionDrill":
        workers = list(self.cluster.workers)
        for w in workers:
            w.adopt_handler = self._make_adopt_handler(w)
        for k in range(self.n_sessions):
            w = workers[k % len(workers)]
            sid = f"decode-{k}"
            # write-ahead insert record, exactly like ContinuousDecoder
            # .submit: the session is recoverable before it is runnable
            self._journal_for(w.worker_id).record_session(
                sid, [k], {"max_new": self.tokens_per_session,
                           "temperature": 0.0, "seed": k})
            with self._lock:
                self._sessions[sid] = {
                    "worker": w.worker_id, "incarnation": id(w),
                    "emitted": [], "done": False, "recovered": False}
        self._thread = threading.Thread(target=self._run,
                                        name="session-drill", daemon=True)
        self._thread.start()
        return self

    def _make_adopt_handler(self, worker):
        def handler(payload: dict) -> dict:
            adopted = 0
            for entry in payload.get("sessions") or []:
                sess = entry.get("session") or {}
                sid = str(sess.get("id") or "")
                if not sid:
                    continue
                emitted = [int(t) for t in sess.get("emitted") or []]
                # re-journal the canonical form on the adopter first —
                # a second failure before the next tick must still find
                # the session whole
                j = self._journal_for(worker.worker_id)
                j.record_session(sid, sess.get("prompt") or [],
                                 sess.get("params") or {},
                                 phash=sess.get("phash"))
                if emitted:
                    j.record_session_tokens(sid, emitted)
                with self._lock:
                    st = self._sessions.get(sid)
                    if st is not None and not st["done"]:
                        st["worker"] = worker.worker_id
                        st["incarnation"] = id(worker)
                        st["emitted"] = emitted
                        st["recovered"] = True
                worker.adopted_sessions.append(entry)
                adopted += 1
            return {"ok": True, "adopted": adopted,
                    "mode": payload.get("mode", "cold"),
                    "worker": worker.worker_id}
        return handler

    # -- the ticker ---------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(self.tick_s):
            try:
                self._tick()
            except Exception:
                # a torn tick (worker mid-restart) is the next tick's
                # problem; the drill itself must survive the chaos it runs
                continue
            with self._lock:
                if all(s["done"] for s in self._sessions.values()):
                    return

    def _tick(self) -> None:
        with self._lock:
            sids = [sid for sid, st in self._sessions.items()
                    if not st["done"]]
        dead_workers: List[str] = []
        for sid in sids:
            # the whole journal-write + in-memory append is one critical
            # section: an adopt handler replacing the emitted tail (a
            # concurrent recovery landing on this worker) can only run
            # between whole tokens, never inside one
            with self._lock:
                st = self._sessions[sid]
                if st["done"]:
                    continue
                w = self._worker(st["worker"])
                if (w is None or id(w) != st["incarnation"]
                        or w.server.closed):
                    if st["worker"] not in dead_workers:
                        dead_workers.append(st["worker"])
                    continue
                tok = session_token(sid, len(st["emitted"]))
                self._journal_for(w.worker_id).record_session_tokens(
                    sid, [tok])
                st["emitted"].append(tok)
                if len(st["emitted"]) >= self.tokens_per_session:
                    st["done"] = True
                    self._journal_for(w.worker_id).record_session_end(sid)
        for wid in dead_workers:
            self._recover(wid)

    def _recover(self, worker_id: str) -> None:
        """Replay the dead incarnation's journaled sessions onto a
        survivor over the real ``/_adopt`` hop (driver-orchestrated
        failover's cold path, run drill-side because the drill owns the
        journals)."""
        from ..serving.distributed import _http_json
        from ..serving.journal import ServingJournal
        t0 = time.monotonic()
        with self._jlock:
            path = self._journal_paths.get(worker_id)
            old = self._journals.pop(worker_id, None)
        if path is None:
            return
        if old is not None and not old.closed:
            old.close()
        sessions = ServingJournal.scan_sessions(path)
        with self._lock:
            wanted = {sid for sid, st in self._sessions.items()
                      if st["worker"] == worker_id and not st["done"]}
        entries = [{"session": dict(s, id=sid), "kv": None}
                   for sid, s in sessions.items() if sid in wanted]
        if not entries:
            return
        survivors = [w for w in self.cluster.workers
                     if w.worker_id != worker_id and not w.server.closed]
        if not survivors:
            return
        target = survivors[0]
        out = _http_json(target.advertised_address + "/_adopt",
                         {"sessions": entries, "mode": "cold",
                          "from": worker_id},
                         site="peer_http")
        if out.get("adopted"):
            self._recovery_s.append(time.monotonic() - t0)

    # -- results ------------------------------------------------------------
    def finish(self, timeout: float = 10.0) -> dict:
        """Wait for every session to complete (bounded), stop the ticker,
        close the drill journals, and return the scorecard block."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if all(s["done"] for s in self._sessions.values()):
                    break
            time.sleep(self.tick_s)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        with self._jlock:
            journals = list(self._journals.values())
        for j in journals:
            if not j.closed:
                j.close()
        return self.scorecard()

    def scorecard(self) -> dict:
        """``{"sessions", "lost", "recovered", "recovery_p99_ms"}`` —
        a session is LOST unless it completed with the exact deterministic
        token stream an uninterrupted run would have produced."""
        lost = recovered = 0
        with self._lock:
            for sid, st in self._sessions.items():
                expect = [session_token(sid, i)
                          for i in range(self.tokens_per_session)]
                if not st["done"] or st["emitted"] != expect:
                    lost += 1
                elif st["recovered"]:
                    recovered += 1
        from .scorecard import quantiles_ms
        q = quantiles_ms(self._recovery_s)
        return {"sessions": self.n_sessions, "lost": lost,
                "recovered": recovered,
                "recovery_p99_ms": q["p99_ms"] if q else None}
