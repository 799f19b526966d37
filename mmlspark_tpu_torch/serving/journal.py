"""Durable serving offsets: a write-ahead journal for epochs + requests
(the port's copy of ``mmlspark_tpu/serving/journal.py``; the record
format is the reference's, byte for byte, so either package replays the
other's file).

Parity: the reference checkpoints serving progress through Spark's offset
machinery — ``HTTPOffset`` partition→epoch maps and the history queues that
outlive an engine restart (``org/apache/spark/sql/execution/streaming/
continuous/HTTPSourceV2.scala:96-113,225-258,489-506``). There the driver's
checkpoint directory makes epochs durable; here an append-only JSONL journal
per worker plays that role, so a worker **process** restart (not just an
engine restart) rehydrates every routed-but-unanswered request.

Records (one JSON object per line):
    {"t": "req",   "id": ..., "epoch": N, "request": {HTTPRequestData},
     "trace": "32-hex trace id"}          # optional — joins journal lines
                                          # against /debug/traces span trees
    {"t": "rep",   "id": ...}
    {"t": "epoch", "n": N}
    {"t": "sess",     "id": ..., "prompt": [ids], "params": {...},
     "phash": "40-hex prefix hash"}       # a live decode session, written
                                          # at insert (before any compute)
    {"t": "tail",     "id": ..., "toks": [ids]}   # emitted-token tail,
                                          # appended per drain tick
    {"t": "sess_end", "id": ...}          # session completed or retired

Session records make an in-flight *generation* reconstructible from the
journal alone (prompt + sampling params + every emitted token), which is
what driver-orchestrated failover replays through ``/_adopt``: the cold
path re-prefills prompt+tail on a surviving worker (deterministic for
greedy), the warm path ships the KV pages and only needs the tail to know
where decoding resumes.

The write protocol is write-ahead (a request is journaled before it is
visible to the engine), replies are journaled after routing succeeds, and
replay tolerates a truncated final line (the SIGKILL-mid-write case).
Fully-answered epochs are dropped at commit time by compaction.

Delivery semantics: replies are **at-most-once**. The reply record is
appended after the routing-table entry is claimed but before the bytes
reach the client socket, so a crash inside that window marks the request
answered without the client having seen the response; replay will not
rehydrate it. Journaling after the socket write instead would flip this to
at-least-once (duplicate replay of already-delivered replies on restart) —
for an HTTP server, whose client retries on a dropped connection anyway,
at-most-once is the right edge of that trade.
"""

from __future__ import annotations

import json
import os
import threading
import warnings
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

from ..io.http.schema import HTTPRequestData
from ..observability import counter as _metric_counter
from ..observability import gauge as _metric_gauge
from ..observability import log_event
from ..reliability.lock_sanitizer import new_lock

__all__ = ["ServingJournal"]

M_JOURNAL_BYTES = _metric_gauge(
    "mmlspark_journal_bytes",
    "Bytes on disk across this process's live serving journals (per-journal "
    "values are in ServingJournal.digest() and the watchdog stall bundle)")
M_JOURNAL_RECORDS = _metric_counter(
    "mmlspark_journal_records_total",
    "Journal records appended, by record type", ("type",))
M_JOURNAL_COMPACTIONS = _metric_counter(
    "mmlspark_journal_compactions_total",
    "Journal compactions (atomic rewrite down to the live set)")
M_JOURNAL_REPLAYED_SESS = _metric_counter(
    "mmlspark_journal_replayed_sessions_total",
    "Live decode sessions rehydrated from a journal (restart or /_adopt)")

#: live journals in this process — feeds the bytes gauge and the watchdog
#: stall bundle's ``journal`` block without keeping closed journals alive
_LIVE: "weakref.WeakSet[ServingJournal]" = weakref.WeakSet()


def _refresh_bytes_gauge() -> None:
    M_JOURNAL_BYTES.set(float(sum(j._bytes for j in list(_LIVE))))


def _journal_bundle_block() -> List[dict]:
    return [j.digest() for j in list(_LIVE)]


try:
    from ..observability.watchdog import register_bundle_provider
    register_bundle_provider("journal", _journal_bundle_block)
except Exception as _exc:  # pragma: no cover - watchdog optional at import
    log_event("journal_bundle_provider_unavailable", error=repr(_exc))


class ServingJournal:
    """Append-only JSONL journal with atomic-rename compaction."""

    def __init__(self, path: str, fsync: bool = True):
        self.path = path
        self.fsync = fsync
        self._lock = new_lock("serving.journal.ServingJournal._lock")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._repair_torn_tail(path)
        self._fh = open(path, "a", encoding="utf-8")
        self._lines_since_compact = 0
        try:
            self._bytes = os.path.getsize(path)
        except OSError:
            self._bytes = 0
        #: per-type append counts since open (digest() + stall bundle)
        self._record_counts: Dict[str, int] = {}
        #: session ids with a "sess" record and no "sess_end" yet
        self._live_sessions: set = set()
        _LIVE.add(self)
        _refresh_bytes_gauge()

    @staticmethod
    def _repair_torn_tail(path: str) -> None:
        """Terminate a non-newline-ended file before appending: without
        this, the first post-restart append would glue onto the torn
        record, corrupting an otherwise-valid line mid-file."""
        try:
            with open(path, "rb") as fh:
                fh.seek(0, os.SEEK_END)
                if fh.tell() == 0:
                    return
                fh.seek(-1, os.SEEK_END)
                last = fh.read(1)
            if last != b"\n":
                with open(path, "ab") as fh:
                    fh.write(b"\n")
        except FileNotFoundError:
            pass

    # -- write side ---------------------------------------------------------
    def _append(self, rec: dict, drop_if_closed: bool = False) -> None:
        with self._lock:
            if self._fh.closed and drop_if_closed:
                # a dispatcher can outlive engine.stop() (join timeout) and
                # reply after close(); losing the reply line only widens the
                # documented at-most-once window, whereas the ValueError
                # would kill the dispatcher thread mid-respond
                warnings.warn("ServingJournal closed; dropping record "
                              f"t={rec.get('t')!r}", RuntimeWarning)
                return
            # note: a closed handle WITHOUT drop_if_closed raises — the
            # write-ahead invariant (server._enqueue) depends on a failed
            # request append erroring the request out before it is queued
            line = json.dumps(rec, separators=(",", ":")) + "\n"
            self._fh.write(line)
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
            self._lines_since_compact += 1
            self._bytes += len(line.encode("utf-8"))
            t = str(rec.get("t"))
            self._record_counts[t] = self._record_counts.get(t, 0) + 1
            M_JOURNAL_RECORDS.inc(type=t)
            _refresh_bytes_gauge()

    def record_request(self, request_id: str, epoch: int,
                       request: HTTPRequestData,
                       trace_id: Optional[str] = None) -> None:
        rec = {"t": "req", "id": request_id, "epoch": epoch,
               "request": request.to_dict()}
        if trace_id is not None:
            rec["trace"] = trace_id
        self._append(rec)

    def record_reply(self, request_id: str) -> None:
        self._append({"t": "rep", "id": request_id}, drop_if_closed=True)

    def record_epoch(self, epoch: int) -> None:
        self._append({"t": "epoch", "n": epoch}, drop_if_closed=True)

    # -- decode sessions ----------------------------------------------------
    def record_session(self, session_id: str, prompt: Sequence[int],
                       params: dict,
                       phash: Optional[str] = None) -> None:
        """Journal a live decode session at insert time. Write-ahead like
        ``record_request``: a closed journal raises, erroring the submit
        out before any compute is spent on an unrecoverable session."""
        rec = {"t": "sess", "id": session_id,
               "prompt": [int(t) for t in prompt], "params": dict(params)}
        if phash is not None:
            rec["phash"] = phash
        self._append(rec)
        with self._lock:
            self._live_sessions.add(session_id)

    def record_session_tokens(self, session_id: str,
                              tokens: Sequence[int]) -> None:
        """Append one emitted-token tail record (batched per drain tick).
        Dropped when closed: losing a tail only widens the cold-replay
        re-decode window, never corrupts the session."""
        if not tokens:
            return
        self._append({"t": "tail", "id": session_id,
                      "toks": [int(t) for t in tokens]}, drop_if_closed=True)

    def record_session_end(self, session_id: str) -> None:
        self._append({"t": "sess_end", "id": session_id},
                     drop_if_closed=True)
        with self._lock:
            self._live_sessions.discard(session_id)

    # -- recovery side ------------------------------------------------------
    @staticmethod
    def _scan(path: str):
        """Yield records, skipping corrupt lines. A SIGKILL mid-append
        leaves at most one torn record (newline-terminated at next open by
        ``_repair_torn_tail``); skipping — rather than stopping at — a bad
        line preserves everything journaled after an earlier crash."""
        try:
            with open(path, "r", encoding="utf-8") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        yield json.loads(line)
                    except json.JSONDecodeError:
                        continue
        except FileNotFoundError:
            return

    def replay(self) -> Tuple[int, Dict[str, Tuple[int, HTTPRequestData]]]:
        """Current epoch + unanswered requests ({id: (epoch, request)})."""
        epoch = 0
        pending: Dict[str, Tuple[int, HTTPRequestData]] = {}
        for rec in self._scan(self.path):
            t = rec.get("t")
            if t == "req":
                pending[rec["id"]] = (
                    rec["epoch"], HTTPRequestData.from_dict(rec["request"]))
            elif t == "rep":
                pending.pop(rec["id"], None)
            elif t == "epoch":
                epoch = max(epoch, int(rec["n"]))
        return epoch, pending

    @staticmethod
    def scan_sessions(path: str) -> Dict[str, dict]:
        """Live decode sessions in the journal at ``path``:
        ``{id: {"prompt", "params", "phash", "emitted"}}``. A staticmethod
        on purpose — the driver reads a *dead* worker's journal for cold
        failover without opening the file for append (which would repair
        the tail and race a worker that is merely slow, not dead)."""
        sessions: Dict[str, dict] = {}
        for rec in ServingJournal._scan(path):
            t = rec.get("t")
            if t == "sess":
                sessions[rec["id"]] = {
                    "prompt": list(rec.get("prompt", ())),
                    "params": dict(rec.get("params", {})),
                    "phash": rec.get("phash"),
                    "emitted": [],
                }
            elif t == "tail":
                sess = sessions.get(rec["id"])
                if sess is not None:
                    sess["emitted"].extend(rec.get("toks", ()))
            elif t == "sess_end":
                sessions.pop(rec["id"], None)
        return sessions

    def replay_sessions(self) -> Dict[str, dict]:
        """Rehydrate this journal's live sessions (restart path). Counted
        into ``mmlspark_journal_replayed_sessions_total``."""
        sessions = self.scan_sessions(self.path)
        with self._lock:
            self._live_sessions.update(sessions)
        if sessions:
            M_JOURNAL_REPLAYED_SESS.inc(len(sessions))
        return sessions

    # -- compaction ---------------------------------------------------------
    def maybe_compact(self, epoch: int, min_lines: int = 256) -> bool:
        """Rewrite the journal down to the live set once enough dead lines
        accumulate. Atomic: write a sibling file, fsync, rename over."""
        with self._lock:
            if self._lines_since_compact < min_lines or self._fh.closed:
                return False
            self._fh.flush()
            # one lock span start-to-finish: an append racing between the
            # pending snapshot and the rename would be silently dropped
            # keep the RAW record dicts (not re-parsed request objects) so
            # optional fields ("trace", anything added later) survive the
            # rewrite byte-for-byte
            pending = {}
            sess: Dict[str, dict] = {}
            tails: Dict[str, List[int]] = {}
            for rec in self._scan(self.path):
                t = rec.get("t")
                if t == "req":
                    pending[rec["id"]] = rec
                elif t == "rep":
                    pending.pop(rec["id"], None)
                elif t == "sess":
                    sess[rec["id"]] = rec
                    tails[rec["id"]] = []
                elif t == "tail":
                    if rec["id"] in tails:
                        tails[rec["id"]].extend(rec.get("toks", ()))
                elif t == "sess_end":
                    # an ended session is dead weight: drop its sess record
                    # and every tail line with it
                    sess.pop(rec["id"], None)
                    tails.pop(rec["id"], None)
            tmp = self.path + ".compact"
            with open(tmp, "w", encoding="utf-8") as out:
                out.write(json.dumps({"t": "epoch", "n": epoch},
                                     separators=(",", ":")) + "\n")
                for rec in pending.values():
                    out.write(json.dumps(rec, separators=(",", ":")) + "\n")
                for sid, rec in sess.items():
                    # live sessions survive as sess + ONE merged tail, so
                    # a long decode compacts to two lines, not N drain
                    # ticks' worth
                    out.write(json.dumps(rec, separators=(",", ":")) + "\n")
                    if tails.get(sid):
                        out.write(json.dumps(
                            {"t": "tail", "id": sid, "toks": tails[sid]},
                            separators=(",", ":")) + "\n")
                out.flush()
                os.fsync(out.fileno())
            self._fh.close()
            os.replace(tmp, self.path)
            self._fh = open(self.path, "a", encoding="utf-8")
            self._lines_since_compact = 0
            self._live_sessions = set(sess)
            try:
                self._bytes = os.path.getsize(self.path)
            except OSError:
                pass
            M_JOURNAL_COMPACTIONS.inc()
            _refresh_bytes_gauge()
        return True

    # -- introspection ------------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._fh.closed

    def digest(self) -> dict:
        """Small JSON-able summary for ``/healthz`` digests and the
        watchdog stall bundle's ``journal`` block."""
        with self._lock:
            return {
                "path": self.path,
                "bytes": self._bytes,
                "closed": self._fh.closed,
                "lines_since_compact": self._lines_since_compact,
                "live_sessions": len(self._live_sessions),
                "records": dict(self._record_counts),
            }

    def close(self) -> None:
        with self._lock:
            _LIVE.discard(self)
            _refresh_bytes_gauge()
            try:
                self._fh.close()
            except Exception as exc:
                # a failed close can mean lost journal tail (buffered
                # writes) — worth a trace when chasing replay gaps
                log_event("journal_close_failed", path=self.path,
                          error=repr(exc))
