"""Runtime lock-order sanitizer: the dynamic half of the TPU013 story.

tpulint's TPU012–TPU014 see the lock discipline the *source* promises;
this module watches the orders the *process* actually takes. An opt-in
(``MMLSPARK_TPU_LOCK_SANITIZER=1``) factory — :func:`new_lock`,
:func:`new_rlock`, :func:`new_condition` — is adopted by the hot threaded
modules (serving server/engine/distributed/journal, the runner's staging
pool, the residency manager, the compile cache, the breaker registry) in
place of bare ``threading.Lock()`` calls. Instrumented locks record, per
thread, the stack that acquired them; every cross-site acquisition edge
(holding A, taking B) lands once in a process-global graph, and an edge
that closes a cycle is reported with **both** stacks — the A→B path and
the B→A path some other code took earlier — which is exactly the pair a
deadlock post-mortem needs and exactly what a wedged process can no
longer produce.

Holds longer than ``MMLSPARK_TPU_LOCK_HOLD_BUDGET`` seconds (default 1.0)
are observed into ``mmlspark_lock_held_seconds{site}``; cycles increment
``mmlspark_lock_order_cycles_total``. The watchdog's black-box bundle
gains a "locks held per thread" table from :func:`held_by_thread`.

Cost model (the ``FaultInjector.enabled`` idiom, pushed to creation
time): the enabled check happens when a lock is *created* — disabled,
the factories return plain ``threading`` primitives, so steady state
pays literally nothing per acquire, not even an attribute check on the
hot path. The flip side: the env knob must be set (or :func:`configure`
called) before the guarded objects are constructed; module-global locks
adopt whatever the environment said at import.

Sanitizer bookkeeping uses plain ``threading.Lock`` internally and is
never adopted inside ``observability/registry.py`` — its metrics land in
the registry, whose series locks would otherwise recurse into the
sanitizer.

The port's copy of ``mmlspark_tpu/reliability/lock_sanitizer.py``.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

__all__ = ["LockSanitizer", "SanitizedLock", "SanitizedRLock",
           "new_lock", "new_rlock", "new_condition", "enabled",
           "configure", "get_sanitizer", "reset", "cycle_reports",
           "held_by_thread", "SANITIZER_ENV", "HOLD_BUDGET_ENV"]

SANITIZER_ENV = "MMLSPARK_TPU_LOCK_SANITIZER"
HOLD_BUDGET_ENV = "MMLSPARK_TPU_LOCK_HOLD_BUDGET"


def _truthy(value: Optional[str]) -> bool:
    return (value or "").strip().lower() in ("1", "true", "yes", "on")


class _Held:
    """One lock a thread currently holds."""

    __slots__ = ("site", "wrapper_id", "acquired_at", "stack")

    def __init__(self, site: str, wrapper_id: int, acquired_at: float,
                 stack: Optional[List[str]]):
        self.site = site
        self.wrapper_id = wrapper_id
        self.acquired_at = acquired_at
        self.stack = stack


class _Edge:
    """First-seen acquisition order between two sites, with the stack
    that established it (captured once — edges are a tiny, stable set)."""

    __slots__ = ("src", "dst", "stack", "thread_name")

    def __init__(self, src: str, dst: str, stack: List[str],
                 thread_name: str):
        self.src = src
        self.dst = dst
        self.stack = stack
        self.thread_name = thread_name


class LockSanitizer:
    """Process-global edge graph + per-thread held tables + hold budget."""

    def __init__(self, *, hold_budget: Optional[float] = None):
        if hold_budget is None:
            hold_budget = float(
                os.environ.get(HOLD_BUDGET_ENV, "1.0") or 1.0)
        self.hold_budget = float(hold_budget)
        # plain lock on purpose: the sanitizer must not sanitize itself
        self._lock = threading.Lock()
        self._edges: Dict[Tuple[str, str], _Edge] = {}
        self._cycles: List[dict] = []
        self._long_holds: List[dict] = []
        self._tls = threading.local()
        #: {thread ident: (thread name, that thread's held list)} — each
        #: list is only ever mutated by its own thread (append/pop are
        #: GIL-atomic); other threads snapshot it best-effort
        self._thread_held: Dict[int, Tuple[str, List[_Held]]] = {}

    # -- per-thread held list ------------------------------------------------
    def _held(self) -> List[_Held]:
        lst = getattr(self._tls, "held", None)
        if lst is None:
            lst = []
            self._tls.held = lst
            t = threading.current_thread()
            with self._lock:
                self._thread_held[t.ident or 0] = (t.name, lst)
        return lst

    # -- acquisition protocol ------------------------------------------------
    def before_acquire(self, site: str, wrapper_id: int) -> None:
        """Record held→new edges and check for cycles BEFORE blocking on
        the lock — a real deadlock would otherwise eat the report."""
        held = self._held()
        if not held:
            return
        for h in held:
            if h.site != site:
                self._note_edge(h.site, site)

    def after_acquire(self, site: str, wrapper_id: int) -> None:
        # bounded capture: the innermost frames are the diagnosis; a full
        # walk on every acquire would tax the very hot paths being watched
        self._held().append(_Held(
            site, wrapper_id, time.monotonic(),
            traceback.format_stack(limit=16)[:-2]))

    def on_release(self, site: str, wrapper_id: int) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i].wrapper_id == wrapper_id:
                entry = held.pop(i)
                dur = time.monotonic() - entry.acquired_at
                if dur >= self.hold_budget:
                    self._note_long_hold(entry, dur)
                return

    # -- edges + cycles ------------------------------------------------------
    def _note_edge(self, src: str, dst: str) -> None:
        with self._lock:
            if (src, dst) in self._edges:
                return   # steady state: one dict probe per nested acquire
        stack = traceback.format_stack()[:-3]
        tname = threading.current_thread().name
        with self._lock:
            if (src, dst) in self._edges:
                return
            edge = _Edge(src, dst, stack, tname)
            self._edges[(src, dst)] = edge
            path = self._find_path(dst, src)
        if path is not None:
            self._report_cycle(edge, path)

    def _find_path(self, start: str, goal: str) -> Optional[List[_Edge]]:
        """DFS over the edge graph (caller holds ``_lock``): a path
        start→…→goal means the just-added goal→start edge closes a cycle."""
        stack = [(start, [])]
        seen = {start}
        while stack:
            node, path = stack.pop()
            if node == goal:
                return path
            for (src, dst), edge in self._edges.items():
                if src == node and dst not in seen:
                    seen.add(dst)
                    stack.append((dst, path + [edge]))
        return None

    def _report_cycle(self, new_edge: _Edge, back_path: List[_Edge]) -> None:
        sites = [new_edge.src, new_edge.dst]
        sites += [e.dst for e in back_path]
        report = {
            "sites": sites,
            "forward": {"order": f"{new_edge.src} -> {new_edge.dst}",
                        "thread": new_edge.thread_name,
                        "stack": new_edge.stack},
            "reverse": [{"order": f"{e.src} -> {e.dst}",
                         "thread": e.thread_name,
                         "stack": e.stack} for e in back_path],
            "t": time.time(),
        }
        with self._lock:
            self._cycles.append(report)
        m = _metrics()
        if m is not None:
            m["cycles"].inc()
        _log_event("lock_order_cycle", sites=" -> ".join(sites))

    def _note_long_hold(self, entry: _Held, dur: float) -> None:
        record = {"site": entry.site, "held_seconds": round(dur, 4),
                  "thread": threading.current_thread().name,
                  "stack": entry.stack}
        with self._lock:
            self._long_holds.append(record)
            if len(self._long_holds) > 256:
                del self._long_holds[:-256]
        m = _metrics()
        if m is not None:
            m["held"].observe(dur, site=entry.site)

    # -- introspection -------------------------------------------------------
    def cycle_reports(self) -> List[dict]:
        with self._lock:
            return list(self._cycles)

    def long_hold_reports(self) -> List[dict]:
        with self._lock:
            return list(self._long_holds)

    def held_by_thread(self) -> Dict[str, List[dict]]:
        """``{"<ident> <name>": [{site, held_seconds}]}`` for every live
        thread holding sanitized locks — the watchdog bundle table."""
        live = {t.ident for t in threading.enumerate()}
        now = time.monotonic()
        out: Dict[str, List[dict]] = {}
        with self._lock:
            for ident in [i for i in self._thread_held if i not in live]:
                del self._thread_held[ident]
            snapshot = {i: (name, list(lst))
                        for i, (name, lst) in self._thread_held.items()}
        for ident, (name, entries) in sorted(snapshot.items()):
            if not entries:
                continue
            out[f"{ident} {name}"] = [
                {"site": e.site,
                 "held_seconds": round(now - e.acquired_at, 4)}
                for e in entries]
        return out


# -- instrumented primitives --------------------------------------------------

class SanitizedLock:
    """``threading.Lock`` wrapper wired into a :class:`LockSanitizer`.

    Supports the full Lock protocol plus enough of the private Condition
    protocol (``_at_fork_reinit`` excluded) that ``threading.Condition``'s
    ``acquire(False)``-probe fallback works against it.
    """

    _reentrant = False

    def __init__(self, san: LockSanitizer, site: str):
        self._san = san
        self.site = site
        self._inner = self._make_inner()

    def _make_inner(self):
        return threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._san.before_acquire(self.site, id(self))
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._san.after_acquire(self.site, id(self))
        return got

    def release(self) -> None:
        self._san.on_release(self.site, id(self))
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: object) -> None:
        self.release()

    def __repr__(self) -> str:
        return (f"<{type(self).__name__} site={self.site!r} "
                f"inner={self._inner!r}>")


class SanitizedRLock(SanitizedLock):
    """``threading.RLock`` wrapper: bookkeeping fires on the outermost
    acquire/release only, and the private ``_release_save`` /
    ``_acquire_restore`` / ``_is_owned`` protocol delegates to the inner
    RLock so ``threading.Condition`` works unmodified on top."""

    _reentrant = True

    def __init__(self, san: LockSanitizer, site: str):
        super().__init__(san, site)
        self._owner: Optional[int] = None
        self._depth = 0

    def _make_inner(self):
        return threading.RLock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        first = self._owner != me
        if first:
            self._san.before_acquire(self.site, id(self))
        got = self._inner.acquire(blocking, timeout)
        if got:
            if first:
                self._owner = me
                self._san.after_acquire(self.site, id(self))
            self._depth += 1
        return got

    def release(self) -> None:
        if self._owner != threading.get_ident():
            # surface the standard error without corrupting bookkeeping
            self._inner.release()
            return
        if self._depth == 1:
            self._san.on_release(self.site, id(self))
            self._owner = None
        self._depth -= 1
        self._inner.release()

    def locked(self) -> bool:
        return self._owner is not None

    # Condition protocol -----------------------------------------------------
    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()

    def _release_save(self):
        depth = self._depth
        self._san.on_release(self.site, id(self))
        self._owner = None
        self._depth = 0
        return self._inner._release_save(), depth

    def _acquire_restore(self, state) -> None:
        inner_state, depth = state
        self._inner._acquire_restore(inner_state)
        self._owner = threading.get_ident()
        self._depth = depth
        self._san.after_acquire(self.site, id(self))


# -- process-global sanitizer + factories -------------------------------------

_san_lock = threading.Lock()
_SANITIZER: Optional[LockSanitizer] = None
_ENABLED: Optional[bool] = None


def enabled() -> bool:
    """Whether new locks are instrumented (env read cached on first use)."""
    global _ENABLED
    if _ENABLED is None:
        with _san_lock:
            if _ENABLED is None:
                _ENABLED = _truthy(os.environ.get(SANITIZER_ENV))
    return _ENABLED


def get_sanitizer() -> LockSanitizer:
    global _SANITIZER
    with _san_lock:
        if _SANITIZER is None:
            _SANITIZER = LockSanitizer()
        return _SANITIZER


def configure(*, enabled: bool,
              hold_budget: Optional[float] = None) -> LockSanitizer:
    """Programmatic enable/disable (tests; bench harnesses). Affects
    locks created AFTER the call — existing locks keep their nature."""
    global _ENABLED, _SANITIZER
    with _san_lock:
        _ENABLED = bool(enabled)
        _SANITIZER = LockSanitizer(hold_budget=hold_budget)
        return _SANITIZER


def reset() -> None:
    """Test hook: drop all state; the next use re-reads the environment."""
    global _ENABLED, _SANITIZER
    with _san_lock:
        _ENABLED = None
        _SANITIZER = None


def new_lock(site: str):
    """A mutex for ``site`` (e.g. ``"serving.server.WorkerServer._lock"``):
    instrumented when the sanitizer is enabled, else a plain
    ``threading.Lock`` — the disabled path costs nothing per acquire."""
    if not enabled():
        return threading.Lock()
    return SanitizedLock(get_sanitizer(), site)


def new_rlock(site: str):
    if not enabled():
        return threading.RLock()
    return SanitizedRLock(get_sanitizer(), site)


def new_condition(site: str, lock=None):
    """A ``threading.Condition``; enabled, it rides a sanitized (R)Lock,
    so waits release the instrumented lock correctly."""
    if not enabled():
        return threading.Condition(lock)
    return threading.Condition(lock if lock is not None
                               else new_rlock(site))


def cycle_reports() -> List[dict]:
    """All lock-order cycles seen so far (empty when disabled/clean)."""
    if _SANITIZER is None:
        return []
    return _SANITIZER.cycle_reports()


def held_by_thread() -> Dict[str, List[dict]]:
    """Locks currently held, per live thread (the watchdog bundle table)."""
    if _SANITIZER is None:
        return {}
    return _SANITIZER.held_by_thread()


# -- lazy observability bridge ------------------------------------------------
# imported on first report, not at module import: reliability must stay
# importable without dragging in the observability package (and the
# registry's own locks are deliberately NOT sanitized)

_METRICS: Optional[dict] = None


def _metrics() -> Optional[dict]:
    global _METRICS
    if _METRICS is None:
        try:
            from ..observability.registry import counter, histogram
            _METRICS = {
                "held": histogram(
                    "mmlspark_lock_held_seconds",
                    "Lock holds exceeding the sanitizer budget, by site",
                    labelnames=("site",),
                    buckets=(0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)),
                "cycles": counter(
                    "mmlspark_lock_order_cycles_total",
                    "Dynamic lock-order cycles detected by the sanitizer"),
            }
        except Exception:
            return None
    return _METRICS


def _log_event(kind: str, **fields: object) -> None:
    try:
        from ..observability.events import log_event
        log_event(kind, **fields)
    except Exception:
        pass
