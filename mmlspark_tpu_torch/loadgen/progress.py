"""Live scenario progress: the process-global snapshot behind
``GET /debug/scenario``.

The scenario runner (``loadgen.scenarios``) updates this singleton as it
drives traffic; the serving plane's debug route reads it — on BOTH
WorkerServer transports — so an operator watching a chaos drill can see
sent/completed/shed counts move without waiting for the final scorecard.
Standalone on purpose: ``serving.server`` imports this lazily, and this
module imports nothing from ``serving``, so there is no cycle.

The port's copy of ``mmlspark_tpu/loadgen/progress.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

__all__ = ["ScenarioProgress", "get_progress", "set_progress",
           "reset_progress"]

#: live-timeline ring size cap — the structure is preallocated at begin()
#: and never grows, whatever the scenario duration (overflow completions
#: clamp into the last bucket)
MAX_LIVE_BUCKETS = 64


class ScenarioProgress:
    """Thread-safe counters for the scenario currently driving traffic,
    plus a fixed-size live timeline (per-bucket outcome counts and
    latency stats) so ``GET /debug/scenario`` shows the run's shape
    *mid-run*, not just after the scorecard lands."""

    def __init__(self):
        self._lock = threading.Lock()
        self._reset_locked()

    def _reset_locked(self) -> None:
        self.scenario: Optional[str] = None
        self.state = "idle"            # idle | running | done
        self.total = 0
        self.sent = 0
        self.done = 0
        self.ok = 0
        self.shed = 0
        self.errors = 0
        self.retries = 0
        self.started_t: Optional[float] = None
        self.updated_t: Optional[float] = None
        self.summary: Optional[Dict[str, object]] = None
        self.bucket_s = 1.0
        # preallocated at begin(); [ok, shed, errors, lat_sum, lat_max, n]
        self._buckets: list = []
        self._hi_bucket = -1

    def begin(self, scenario: str, total: int,
              duration_s: Optional[float] = None,
              bucket_s: Optional[float] = None) -> None:
        with self._lock:
            self._reset_locked()
            self.scenario = scenario
            self.state = "running"
            self.total = int(total)
            self.started_t = time.time()
            self.updated_t = self.started_t
            if bucket_s is None:
                bucket_s = (max(round(float(duration_s) / 12.0, 3), 0.1)
                            if duration_s else 1.0)
            self.bucket_s = float(bucket_s)
            n = MAX_LIVE_BUCKETS
            if duration_s:
                # +2 slack: completions trail the planned duration
                n = min(n, int(float(duration_s) / self.bucket_s) + 2)
            self._buckets = [[0, 0, 0, 0.0, 0.0, 0] for _ in range(n)]

    def note_sent(self, n: int = 1) -> None:
        with self._lock:
            self.sent += n
            self.updated_t = time.time()

    def note_done(self, outcome: str, retries: int = 0,
                  at_s: Optional[float] = None,
                  lat_s: Optional[float] = None) -> None:
        with self._lock:
            self.done += 1
            self.retries += int(retries)
            if outcome == "ok":
                self.ok += 1
            elif outcome == "shed":
                self.shed += 1
            else:
                self.errors += 1
            self.updated_t = time.time()
            if at_s is not None and self._buckets:
                i = min(max(int(at_s // self.bucket_s), 0),
                        len(self._buckets) - 1)
                if i > self._hi_bucket:
                    self._hi_bucket = i
                b = self._buckets[i]
                col = {"ok": 0, "shed": 1}.get(outcome, 2)
                b[col] += 1
                if outcome == "ok" and lat_s is not None:
                    b[3] += float(lat_s)
                    if lat_s > b[4]:
                        b[4] = float(lat_s)
                    b[5] += 1

    def finish(self, summary: Optional[Dict[str, object]] = None) -> None:
        with self._lock:
            self.state = "done"
            self.summary = dict(summary) if summary else None
            self.updated_t = time.time()

    def snapshot(self) -> Dict[str, object]:
        """JSON-safe live view (the /debug/scenario payload)."""
        with self._lock:
            out: Dict[str, object] = {
                "scenario": self.scenario, "state": self.state,
                "total": self.total, "sent": self.sent, "done": self.done,
                "ok": self.ok, "shed": self.shed, "errors": self.errors,
                "retries": self.retries,
                "started_t": self.started_t, "updated_t": self.updated_t,
            }
            if self.started_t is not None and self.state == "running":
                # a live debug-view field, not accumulated telemetry: the
                # run's durable numbers go through mmlspark_scenario_*
                # metrics in loadgen.scorecard
                out["elapsed_s"] = round(time.time() - self.started_t, 3)
            if self._hi_bucket >= 0:
                rows = []
                for i in range(self._hi_bucket + 1):
                    ok, shed, errors, lat_sum, lat_max, n = self._buckets[i]
                    rows.append({
                        "t0": round(i * self.bucket_s, 3),
                        "ok": ok, "shed": shed, "errors": errors,
                        "lat_mean_ms": (round(lat_sum / n * 1e3, 3)
                                        if n else None),
                        "lat_max_ms": (round(lat_max * 1e3, 3)
                                       if n else None)})
                out["timeline"] = {"bucket_s": self.bucket_s,
                                   "buckets": rows}
            if self.summary is not None:
                out["summary"] = dict(self.summary)
            return out


_progress_lock = threading.Lock()
_progress: Optional[ScenarioProgress] = None


def get_progress() -> ScenarioProgress:
    """The process-global progress object, created on first use."""
    global _progress
    with _progress_lock:
        if _progress is None:
            _progress = ScenarioProgress()
        return _progress


def set_progress(progress: ScenarioProgress) -> None:
    global _progress
    with _progress_lock:
        _progress = progress


def reset_progress() -> None:
    global _progress
    with _progress_lock:
        _progress = None
