"""Time the generation front of ``chip_smoke.py`` phase 16a on the card:
phase 5's engine (FULL's decoder in bf16, 16 slots, pages of 16,
256-token chunks, 4 steps a dispatch) behind ``GenerationEngine``, and
phase 5's request mix with 16a's headers (each request's own
``traceparent``, one of two tenants, ``X-Mmlspark-Model: gen``; ``gen@1``
registered live where the tree has a model registry).

After one warm-up burst (``chip_smoke._plane_burst``), ``--reps`` timed
bursts. A timed burst is closed-loop (``chip_smoke._plane_closed_loop``):
each of the mix's requests is sent again as soon as its reply is in,
until ``--seconds`` have passed, so the engine runs at the mix's steady
occupancy for the whole burst. Prints one JSON line: tokens/s, the p50
engine tick and the tick count of each burst, with ``--clock`` the host
CPU time the plane's own code took during the burst, on every thread and
by module (``plane_host``), and the card's name and power limit.

``--variant`` switches parts of the observability plane off in a tree
that has it, to find what the plane costs the host-bound tick:
``no_sampler`` (no time-series scrape thread, so no memory-gauge reads),
``no_ledger`` (cost charges, ``charge_shares`` included, are no-ops),
``bare`` (both).

``--summarize`` reads files of these JSON lines (other lines are
skipped) and prints, per file and over all of them, each tree's quartiles
and the new tree's median against the old one's.

It imports the package and ``chip_smoke.py`` that sit beside it. To time
another commit's package with this traffic, unpack that package beside
copies of this script and ``chip_smoke.py``, and alternate the trees in
one call:

    mkdir -p build/old && git archive <commit> mmlspark_tpu_torch \\
        | tar -x -C build/old
    cp chip_smoke.py time_front.py build/old/
    python3 build/old/time_front.py; python3 time_front.py
    python3 time_front.py; python3 build/old/time_front.py
"""

import argparse
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

VARIANTS = ("full", "no_sampler", "no_ledger", "bare")


def _ablate(variant):
    """Switch off the parts of the plane ``variant`` names (before the
    engine and its server exist)."""
    if variant in ("no_sampler", "bare"):
        os.environ["MMLSPARK_TPU_TS_INTERVAL"] = "0"
    if variant in ("no_ledger", "bare"):
        from mmlspark_tpu_torch.observability.ledger import CostLedger
        CostLedger.charge = lambda self, *a, **k: None
        CostLedger.charge_shares = lambda self, *a, **k: None


#: the modules of the observability plane and the model registry: the code
#: whose host time ``--clock`` measures
PLANE_MODULES = ("observability.tracing", "observability.slo",
                 "observability.ledger", "observability.timeseries",
                 "observability.watchdog", "observability.federation",
                 "serving.registry", "utils.profiling",
                 "tuning.observations", "reliability.lock_sanitizer")
#: plane code that runs other code for as long as a thread lives (a
#: sampler's or watchdog's loop, the context-carrying wrapper of a thread's
#: target): left out, so that what it calls is timed on its own
UNTIMED = ("RegistrySampler._run", "Watchdog._run",
           "propagate.<locals>.wrapped")


class _PlaneClock:
    """Host CPU seconds spent running the plane's own code, on every
    thread, by module. ``sys.monitoring`` events are enabled on the code
    objects of ``PLANE_MODULES`` only, so other code runs as it would
    unobserved. A thread's clock (its own CPU time, so time spent waiting
    for the interpreter lock is not counted) runs from its outermost entry
    into plane code to its exit (a generator's suspensions excluded) and
    is billed to the module of that outermost code; the callbacks' own
    time is inside it, so the sums are an upper bound. Plane code holds
    the interpreter lock while it runs: the sum bounds what it takes from
    the engine's thread."""

    def __init__(self):
        import importlib
        import inspect
        import threading
        import types
        mon = sys.monitoring
        tool = mon.PROFILER_ID
        mon.use_tool_id(tool, "time_front")
        owner = {}

        def add(code, mod):
            if isinstance(code, types.CodeType) and code not in owner \
                    and code.co_qualname not in UNTIMED:
                owner[code] = mod
                for c in code.co_consts:
                    add(c, mod)

        for name in PLANE_MODULES:
            module = importlib.import_module(f"mmlspark_tpu_torch.{name}")
            members = [v for v in vars(module).values()
                       if getattr(v, "__module__", None) == module.__name__]
            for v in list(members):
                if isinstance(v, type):
                    members += [getattr(m, a, None) for m in vars(v).values()
                                for a in ("__func__", "fget", "fset", "fdel")]
                    members += list(vars(v).values())
            for v in members:
                if callable(v) and not isinstance(v, type):
                    add(getattr(inspect.unwrap(v), "__code__", None), name)
        local = threading.local()
        self._threads = []

        def enter(code, *_):
            if code not in owner:
                return
            depth = getattr(local, "depth", 0)
            if depth == 0:
                if not hasattr(local, "sums"):
                    local.sums = {}
                    self._threads.append(local.sums)
                local.mod, local.t0 = owner[code], time.thread_time()
            local.depth = depth + 1

        def leave(code, *_):
            depth = getattr(local, "depth", 0)
            if code not in owner or depth == 0:
                return
            local.depth = depth - 1
            if depth == 1:
                n, sec = local.sums.get(local.mod, (0, 0.0))
                local.sums[local.mod] = (n + 1, sec + time.thread_time()
                                         - local.t0)

        ev = mon.events
        for e, fn in ((ev.PY_START, enter), (ev.PY_RESUME, enter),
                      (ev.PY_THROW, enter), (ev.PY_RETURN, leave),
                      (ev.PY_YIELD, leave), (ev.PY_UNWIND, leave)):
            mon.register_callback(tool, e, fn)
        # a throw into or an unwind out of plane code has no local event
        mon.set_events(tool, ev.PY_THROW | ev.PY_UNWIND)
        for code in owner:
            mon.set_local_events(tool, code, ev.PY_START | ev.PY_RESUME
                                 | ev.PY_RETURN | ev.PY_YIELD)

    def take(self):
        """{module: {"entries", "ms"}} since the last take, all threads."""
        out = {}
        for sums in self._threads:
            for mod, (n, sec) in list(sums.items()):
                o = out.setdefault(mod, {"entries": 0, "ms": 0.0})
                o["entries"] += n
                o["ms"] += sec * 1e3
            sums.clear()
        return out


def _quartiles(xs):
    q = statistics.quantiles(xs, n=4) if len(xs) > 1 else list(xs) * 3
    return [round(q[0], 2), round(q[1], 2), round(q[2], 2)]


def summarize(paths):
    """Per file of this script's JSON lines (and over all of them): each
    tree's bursts by variant (tokens/s and p50 tick quartiles), the new
    tree's median against the old one's, and with ``--clock`` the share
    of the wall each plane module took, least and most over the bursts."""
    groups = {}
    for path in list(paths) + [None]:
        lines = ([ln for p in paths for ln in open(p)] if path is None
                 else list(open(path)))
        runs = {}
        for ln in lines:
            if not ln.startswith('{"tree"'):
                continue
            rec = json.loads(ln)
            key = ("new" if rec["plane"] else "old") + \
                ("" if rec["variant"] == "full" else f" {rec['variant']}")
            for r in rec["runs"]:
                k = key + " clock" if r.get("plane_host") else key
                runs.setdefault(k, []).append(r)
        out = {k: {"bursts": len(v),
                   "tok_per_s": _quartiles([r["tok_per_s"] for r in v]),
                   "p50_tick_ms": _quartiles([r["p50_tick_ms"] for r in v])}
               for k, v in runs.items()}
        if "old" in out and "new" in out:
            out["new_vs_old_pct"] = round(
                100 * (out["new"]["tok_per_s"][1]
                       / out["old"]["tok_per_s"][1] - 1), 2)
        for k, v in runs.items():
            if k.endswith("clock"):
                share = {}
                for r in v:
                    total = 0.0
                    for mod, t in r["plane_host"].items():
                        share.setdefault(mod, []).append(
                            t["ms"] / r["wall_s"] / 10)
                        total += t["ms"] / r["wall_s"] / 10
                    share.setdefault("all", []).append(total)
                out[k]["wall_pct"] = {m: [round(min(x), 3), round(max(x), 3)]
                                      for m, x in share.items()}
        groups[path or "all"] = out
    return groups


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=20.0,
                    help="least length of each timed burst")
    ap.add_argument("--variant", choices=VARIANTS, default="full")
    ap.add_argument("--clock", action="store_true",
                    help="time the plane's own code (PLANE_MODULES)")
    ap.add_argument("--summarize", nargs="+", metavar="JSONL",
                    help="summarize files of this script's output lines "
                         "instead of timing")
    args = ap.parse_args(argv)
    if args.summarize:
        print(json.dumps(summarize(args.summarize), indent=1))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("time_front: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from mmlspark_tpu_torch.models.zoo.transformer import init_transformer
    from mmlspark_tpu_torch.serving.generation import GenerationEngine
    try:
        from mmlspark_tpu_torch.serving.registry import get_registry
    except ImportError:     # a tree without the plane
        get_registry = None
        if args.variant != "full" or args.clock:
            print("time_front: --variant and --clock need a tree with the "
                  "plane", file=sys.stderr)
            return 2
    if args.variant != "full":
        _ablate(args.variant)
    clock = _PlaneClock() if args.clock else None
    dev_info = chip_smoke.phase_device()
    chip_smoke.phase_build()
    cfg = chip_smoke._full_cfg(torch.bfloat16)
    params_np = init_transformer(chip_smoke._full_cfg(torch.float32), seed=0)
    payloads = chip_smoke._serving_payloads(cfg.vocab, 64)
    eng = GenerationEngine(params_np, cfg, max_slots=16, max_len=1024,
                           page_size=16, prefill_chunk=256,
                           steps_per_dispatch=4)
    runs = []
    try:
        if get_registry is not None:
            get_registry().load("gen", "1", handle=eng)
        eng.start()
        chip_smoke._plane_burst(eng, payloads, {})
        for _ in range(args.reps):
            torch.cuda.synchronize()
            eng.decoder.tick_seconds.clear()
            if clock is not None:
                clock.take()
            replies, wall = chip_smoke._plane_closed_loop(
                eng, payloads, args.seconds)
            ticks = list(eng.decoder.tick_seconds)
            n_tok = 0
            for i, _, status, _, body in replies:
                if status != 200:
                    raise AssertionError(f"request {i}: {status} "
                                         f"{body[:200]!r}")
                n_tok += len(chip_smoke._stream_tokens(body)
                             if payloads[i].get("stream")
                             else json.loads(body)["tokens"])
            runs.append({"tok_per_s": n_tok / wall,
                         "p50_tick_ms": statistics.median(ticks) * 1e3,
                         "ticks": len(ticks), "requests": len(replies),
                         "tokens": n_tok, "wall_s": wall,
                         "plane_host": clock.take() if clock else None})
    finally:
        eng.stop()
    print(json.dumps({"tree": HERE, "plane": get_registry is not None,
                      "variant": args.variant, "runs": runs,
                      "tok_per_s": statistics.median(
                          r["tok_per_s"] for r in runs),
                      "p50_tick_ms": statistics.median(
                          r["p50_tick_ms"] for r in runs),
                      "card": dev_info["smi"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
