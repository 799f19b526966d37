"""Device-stall watchdog: heartbeat watches + black-box diagnostic bundles
(the port's copy of ``mmlspark_tpu/observability/watchdog.py``).

BENCH_r05 died rc=124 inside a wedged device probe with zero runtime
diagnostics — the process had metrics and traces but nothing watching the
*long device calls themselves*. This module closes that hole:

- :func:`watch` is a context manager wrapped around every long device
  call (``BatchRunner.drain``'s ``device_get``, ``ContinuousDecoder``
  decode/prefill ticks, compile-cache warm-up, bench device probes). It
  registers a heartbeat; loops refresh it with ``.beat()``.
- a single :class:`Watchdog` daemon thread scans the active watches. A
  heartbeat stale past its budget fires **exactly once per stall**:
  ``mmlspark_watchdog_stalls_total{site}`` increments and an atomic
  black-box bundle (all-thread stacks via ``sys._current_frames`` +
  ``faulthandler``, the metrics ``snapshot()``, flight-recorder
  summaries, residency/KV-pool stats) lands under
  ``MMLSPARK_TPU_DIAG_DIR`` — so a post-mortem needs only the bundle,
  not a live process.

Disabled (the default — enable with ``MMLSPARK_TPU_WATCHDOG=1`` or
:func:`configure`), the hot path pays one attribute check: :func:`watch`
returns a shared no-op context, the same idiom as
``FaultInjector.enabled``. Knobs: ``MMLSPARK_TPU_WATCHDOG`` (enable),
``MMLSPARK_TPU_WATCHDOG_BUDGET`` (default per-watch budget, seconds),
``MMLSPARK_TPU_WATCHDOG_INTERVAL`` (scan period, seconds),
``MMLSPARK_TPU_DIAG_DIR`` (bundle directory).
"""

from __future__ import annotations

import faulthandler
import itertools
import json
import os
import re
import sys
import tempfile
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

from .registry import counter as _metric_counter
from .registry import gauge as _metric_gauge
from .registry import snapshot as _registry_snapshot

__all__ = ["Watchdog", "watch", "get_watchdog", "set_watchdog",
           "reset_watchdog", "configure", "register_hbm_gauges",
           "register_bundle_provider", "unregister_bundle_provider",
           "DIAG_DIR_ENV", "WATCHDOG_ENV", "BUDGET_ENV", "INTERVAL_ENV"]

WATCHDOG_ENV = "MMLSPARK_TPU_WATCHDOG"
DIAG_DIR_ENV = "MMLSPARK_TPU_DIAG_DIR"
BUDGET_ENV = "MMLSPARK_TPU_WATCHDOG_BUDGET"
INTERVAL_ENV = "MMLSPARK_TPU_WATCHDOG_INTERVAL"

M_STALLS = _metric_counter(
    "mmlspark_watchdog_stalls_total",
    "Watched device calls whose heartbeat went stale past budget, by site",
    ("site",))
M_BUNDLES = _metric_counter(
    "mmlspark_watchdog_bundles_total",
    "Diagnostic bundles written (one per detected stall, best-effort)")
M_ACTIVE = _metric_gauge(
    "mmlspark_watchdog_active_watches",
    "Watches currently registered with the stall watchdog")

# per-device memory occupancy, sampled at scrape time (registered by
# register_hbm_gauges once CUDA is initialized)
_M_HBM_IN_USE = _metric_gauge(
    "mmlspark_device_hbm_bytes_in_use",
    "Device memory in use (memory_stats; backends without it expose "
    "nothing)", ("device",))
_M_HBM_LIMIT = _metric_gauge(
    "mmlspark_device_hbm_bytes_limit",
    "Device memory limit (memory_stats)", ("device",))
_M_HBM_ALLOCATED = _metric_gauge(
    "mmlspark_device_hbm_bytes_allocated",
    "Device memory held by live tensors (torch.cuda.memory_allocated)",
    ("device",))
_M_HBM_RESERVED = _metric_gauge(
    "mmlspark_device_hbm_bytes_reserved",
    "Device memory held by the caching allocator "
    "(torch.cuda.memory_reserved)", ("device",))

_SITE_SANITIZE_RE = re.compile(r"[^A-Za-z0-9_.-]+")

# Extra stall-bundle blocks contributed by other subsystems (the journal
# registers one) without the watchdog importing them — the bundle must
# stay writable from a process where those layers never loaded.
_BUNDLE_PROVIDERS: Dict[str, Callable[[], object]] = {}


def register_bundle_provider(name: str, fn: Callable[[], object]) -> None:
    """Add a ``bundle[name] = fn()`` block to every future stall bundle.
    Provider failures degrade to an ``unavailable: ...`` string — a broken
    provider must never cost the stacks and metrics the bundle exists for."""
    _BUNDLE_PROVIDERS[name] = fn


def unregister_bundle_provider(name: str) -> None:
    _BUNDLE_PROVIDERS.pop(name, None)


def _truthy(value: Optional[str]) -> bool:
    return (value or "").strip().lower() in ("1", "true", "yes", "on")


class _NullWatch:
    """Shared no-op context for the disabled path — allocation-free."""

    __slots__ = ()

    def __enter__(self) -> "_NullWatch":
        return self

    def __exit__(self, *exc: object) -> None:
        pass

    def beat(self) -> None:
        pass


_NULL_WATCH = _NullWatch()


class _Watch:
    """One active heartbeat. ``beat()`` refreshes it (and re-arms the
    stall trigger, so a recovered-then-wedged loop fires again)."""

    __slots__ = ("site", "budget", "thread_ident", "thread_name",
                 "started", "last_beat", "stalled", "_wd", "_token")

    def __init__(self, wd: "Watchdog", site: str, budget: float):
        self.site = site
        self.budget = budget
        self._wd = wd
        self._token: Optional[int] = None
        self.thread_ident = 0
        self.thread_name = ""
        self.started = 0.0
        self.last_beat = 0.0
        self.stalled = False

    def __enter__(self) -> "_Watch":
        t = threading.current_thread()
        self.thread_ident = t.ident or 0
        self.thread_name = t.name
        self.started = self.last_beat = self._wd._clock()
        self.stalled = False
        self._token = self._wd._register(self)
        return self

    def __exit__(self, *exc: object) -> None:
        self._wd._unregister(self._token)

    def beat(self) -> None:
        self.last_beat = self._wd._clock()
        self.stalled = False


class Watchdog:
    """Daemon scanning the active watches for stale heartbeats.

    The scan thread starts lazily on the first registered watch and runs
    at ``interval`` seconds. ``clock`` is injectable for tests;
    :meth:`scan_once` runs one scan synchronously (no thread needed)."""

    def __init__(self, *, enabled: Optional[bool] = None,
                 interval: Optional[float] = None,
                 default_budget: Optional[float] = None,
                 diag_dir: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic):
        if enabled is None:
            enabled = _truthy(os.environ.get(WATCHDOG_ENV))
        if interval is None:
            interval = float(os.environ.get(INTERVAL_ENV, "0.5") or 0.5)
        if default_budget is None:
            default_budget = float(os.environ.get(BUDGET_ENV, "120") or 120)
        self.enabled = bool(enabled)
        self.interval = max(0.01, float(interval))
        self.default_budget = float(default_budget)
        self._diag_dir = diag_dir
        self._clock = clock
        self._lock = threading.Lock()
        self._watches: Dict[int, _Watch] = {}
        self._tokens = itertools.count()
        self._bundle_seq = itertools.count()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._callbacks: List[Callable[[dict], None]] = []
        #: (wall time, monotonic time) of the most recent stall, if any
        self.last_stall: Optional[Dict[str, float]] = None

    # -- watch registration --------------------------------------------------
    def watch(self, site: str, budget_seconds: Optional[float] = None):
        """Context manager guarding one long device call at ``site``.
        Falls back to the process default budget when none is given."""
        if not self.enabled:
            return _NULL_WATCH
        budget = (self.default_budget if budget_seconds is None
                  else float(budget_seconds))
        return _Watch(self, site, budget)

    def _register(self, w: _Watch) -> int:
        with self._lock:
            token = next(self._tokens)
            self._watches[token] = w
            M_ACTIVE.set(len(self._watches))
            if self._thread is None and self.enabled:
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._run, name="mmlspark-watchdog", daemon=True)
                self._thread.start()
        return token

    def _unregister(self, token: Optional[int]) -> None:
        if token is None:
            return
        with self._lock:
            self._watches.pop(token, None)
            M_ACTIVE.set(len(self._watches))

    def on_stall(self, cb: Callable[[dict], None]) -> None:
        """Register a callback invoked (from the scan thread) with each
        stall record — bench.py stamps its partial JSON through this."""
        with self._lock:
            self._callbacks.append(cb)

    # -- scanning ------------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.scan_once()
            except Exception:
                # the watchdog must never take the process down; a failed
                # scan retries on the next tick
                pass

    def scan_once(self) -> List[dict]:
        """One synchronous scan; returns the stall records fired (also the
        test hook — no daemon timing involved)."""
        now = self._clock()
        with self._lock:
            stale = [w for w in self._watches.values()
                     if not w.stalled and now - w.last_beat > w.budget]
            for w in stale:
                w.stalled = True
            callbacks = list(self._callbacks)
        records = []
        for w in stale:
            record = self._fire(w, now - w.last_beat)
            records.append(record)
            for cb in callbacks:
                try:
                    cb(record)
                except Exception:
                    pass
        return records

    def stop(self) -> None:
        self._stop.set()
        # under the lock: ``_register`` publishes the scan thread and
        # starts it under the same lock, so this never sees (and joins) a
        # thread another thread has made but not yet started
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2 * self.interval + 1.0)

    def last_stall_age(self) -> Optional[float]:
        """Seconds since the most recent stall, or None — the /healthz
        degraded check."""
        last = self.last_stall
        if last is None:
            return None
        return max(0.0, self._clock() - last["monotonic"])

    # -- stall handling ------------------------------------------------------
    def _fire(self, w: _Watch, stalled_for: float) -> dict:
        M_STALLS.inc(site=w.site)
        self.last_stall = {"wall": time.time(), "monotonic": self._clock(),
                           "site": w.site}
        record = {"site": w.site, "budget_seconds": w.budget,
                  "stalled_seconds": round(stalled_for, 3),
                  "thread": {"ident": w.thread_ident,
                             "name": w.thread_name},
                  "t": time.time(), "pid": os.getpid()}
        try:
            record["bundle"] = self._write_bundle(record)
        except Exception as e:
            record["bundle"] = None
            record["bundle_error"] = f"{type(e).__name__}: {e}"[:200]
        from .events import log_event
        log_event("watchdog_stall", site=w.site,
                  stalled_seconds=record["stalled_seconds"],
                  bundle=record.get("bundle"))
        return record

    def diag_dir(self) -> str:
        d = (self._diag_dir or os.environ.get(DIAG_DIR_ENV)
             or os.path.join(tempfile.gettempdir(), "mmlspark_tpu_diag"))
        os.makedirs(d, exist_ok=True)
        return d

    def _write_bundle(self, record: dict) -> str:
        """One atomic JSON bundle: tmp + ``os.replace`` so a reader never
        sees a torn file, and a killed writer leaves only ``*.tmp``."""
        bundle = dict(record)
        bundle["stacks"] = _thread_stacks()
        bundle["faulthandler"] = _faulthandler_dump()
        try:
            bundle["metrics"] = _registry_snapshot()
        except Exception as e:
            bundle["metrics"] = f"unavailable: {type(e).__name__}: {e}"
        try:
            from .tracing import get_flight_recorder
            bundle["traces"] = get_flight_recorder().summaries()
        except Exception as e:
            bundle["traces"] = f"unavailable: {type(e).__name__}: {e}"
        try:
            # guarded: residency imports torch; a failure there still
            # leaves stacks + metrics
            from ..core.residency import residency_stats
            bundle["residency"] = residency_stats()
        except Exception:
            bundle["residency"] = None
        try:
            # which thread holds which sanitized lock, and for how long —
            # a stalled device call plus this table is usually the whole
            # deadlock/convoy diagnosis (empty when the sanitizer is off)
            from ..reliability.lock_sanitizer import held_by_thread
            bundle["locks_held"] = held_by_thread()
        except Exception:
            bundle["locks_held"] = None
        for name, fn in list(_BUNDLE_PROVIDERS.items()):
            try:
                bundle[name] = fn()
            except Exception as e:
                bundle[name] = f"unavailable: {type(e).__name__}: {e}"
        site = _SITE_SANITIZE_RE.sub("_", record["site"])[:64] or "site"
        name = (f"watchdog_{site}_{os.getpid()}_"
                f"{next(self._bundle_seq)}.json")
        path = os.path.join(self.diag_dir(), name)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(bundle, fh, default=str)
        os.replace(tmp, path)
        M_BUNDLES.inc()
        return path


def _thread_stacks() -> Dict[str, List[str]]:
    """``{"<ident> <name>": [formatted frames]}`` for every live thread —
    the stalled thread's stack is the bundle's reason for existing."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: Dict[str, List[str]] = {}
    for ident, frame in sys._current_frames().items():
        key = f"{ident} {names.get(ident, '?')}"
        out[key] = traceback.format_stack(frame)
    return out


def _faulthandler_dump() -> str:
    """All-thread dump through faulthandler (C-level view: shows threads
    wedged inside native XLA calls that format_stack renders thin)."""
    try:
        with tempfile.TemporaryFile(mode="w+") as fh:
            faulthandler.dump_traceback(file=fh, all_threads=True)
            fh.seek(0)
            return fh.read()
    except Exception as e:
        return f"unavailable: {type(e).__name__}: {e}"


# -- the process-global watchdog ---------------------------------------------

_wd_lock = threading.Lock()
_WATCHDOG: Optional[Watchdog] = None


def get_watchdog() -> Watchdog:
    """The process-global watchdog (created on first use, enabled state
    from ``MMLSPARK_TPU_WATCHDOG``)."""
    global _WATCHDOG
    with _wd_lock:
        if _WATCHDOG is None:
            _WATCHDOG = Watchdog()
        return _WATCHDOG


def set_watchdog(wd: Optional[Watchdog]) -> None:
    global _WATCHDOG
    with _wd_lock:
        old = _WATCHDOG
        _WATCHDOG = wd
    if old is not None and old is not wd:
        old.stop()


def reset_watchdog() -> None:
    """Test hook: stop and drop the global watchdog so the next use
    re-reads the environment."""
    set_watchdog(None)


def configure(**kwargs) -> Watchdog:
    """Install a freshly-configured global watchdog (bench.py enables it
    programmatically: ``configure(enabled=True, default_budget=...)``)."""
    wd = Watchdog(**kwargs)
    set_watchdog(wd)
    return wd


def watch(site: str, budget_seconds: Optional[float] = None):
    """Module-level hot-path entry: ``with watch("runner_drain"): ...``.

    With the watchdog disabled this is one global read + one attribute
    check returning a shared no-op context — cheap enough for every
    drain/tick in the process (the ``injector.enabled`` idiom). The
    first call constructs the global (reading ``MMLSPARK_TPU_WATCHDOG``),
    so the env knob works without any route or configure() call having
    touched the watchdog first."""
    wd = _WATCHDOG
    if wd is None:
        wd = get_watchdog()
    if not wd.enabled:
        return _NULL_WATCH
    return wd.watch(site, budget_seconds)


def register_hbm_gauges() -> int:
    """Callback gauges for per-device memory occupancy on each CUDA device.

    Registers ``mmlspark_device_hbm_bytes_in_use{device}`` (total minus
    free from ``torch.cuda.mem_get_info``, sampled at scrape time),
    ``..._bytes_allocated`` and ``..._bytes_reserved`` (the caching
    allocator's view) and stamps ``..._bytes_limit`` (the card's total);
    returns how many devices registered. Never *triggers* torch import or
    CUDA initialization (the build_info rule): a process that has not
    touched the card registers nothing, quietly.
    """
    torch_mod = sys.modules.get("torch")
    if torch_mod is None:
        return 0
    try:
        if not torch_mod.cuda.is_initialized():
            return 0
        count = torch_mod.cuda.device_count()
    except Exception:
        return 0
    cuda = torch_mod.cuda

    def _in_use(i: int) -> float:
        free, total = cuda.mem_get_info(i)
        return float(total - free)

    n = 0
    for i in range(count):
        try:
            _free, total = cuda.mem_get_info(i)
        except Exception:
            continue
        label = f"cuda:{i}"
        _M_HBM_IN_USE.set_function(lambda i=i: _in_use(i), device=label)
        _M_HBM_ALLOCATED.set_function(
            lambda i=i: float(cuda.memory_allocated(i)), device=label)
        _M_HBM_RESERVED.set_function(
            lambda i=i: float(cuda.memory_reserved(i)), device=label)
        _M_HBM_LIMIT.set(float(total), device=label)
        n += 1
    return n
