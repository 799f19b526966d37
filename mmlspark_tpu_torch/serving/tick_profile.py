"""Where a decode tick's time goes: the single-device engine and the
tensor-parallel engine on a one-rank ``tp`` mesh, side by side; or, with
``--spec``, the plain and the speculative engine at bench.py's generation
configuration.

    python -m mmlspark_tpu_torch.serving.tick_profile            # the card
    python -m mmlspark_tpu_torch.serving.tick_profile --spec     # the card
    python -m mmlspark_tpu_torch.serving.tick_profile --device cpu

Builds the repo's GPT-2-small-class decoder (bf16, weights from a seed;
a two-layer toy on the CPU, which only rehearses the script),
fills 16 slots with requests that keep decoding, and traces ``--ticks``
calls of ``step()`` (4 decode steps each) under ``torch.profiler``. For
each engine it prints one JSON line: wall ms per tick, device-busy ms per
tick (the kernels' summed time), kernel launches per tick, the
collectives' host ms per tick and the host ops with the most self time.
The card's name and power limit come first.

``--spec`` builds bench.py's generation target and draft
(bench.py:493-500; bf16, seeds 0 and 1; two-layer toys on the CPU) and
traces ``--ticks`` ticks (one step each, 16 slots decoding) of the plain
engine and of the speculative engine at gamma 2, 1, 2 and 1 again (the
autotuner off, so gamma stays put; each twice, since the host-paced wall
varies from engine to engine): one JSON line each, the same fields.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..models.zoo.transformer import TransformerConfig, init_transformer
from ..parallel import distributed
from ..parallel.mesh import make_mesh
from ..utils.device import device_info
from .continuous import ContinuousDecoder

FULL = dict(vocab=32000, layers=12, d_model=768, heads=12, d_ff=3072,
            max_len=2048)
SMALL = dict(vocab=256, layers=2, d_model=64, heads=4, d_ff=128,
             max_len=256)
#: bench.py's generation target and draft (bench.py:493-500), and the
#: CPU's toys (head dim 64 for the target, as the card's kernels take)
SPEC = dict(vocab=8192, layers=8, d_model=512, heads=8, d_ff=2048,
            max_len=1024)
SPEC_DRAFT = dict(vocab=8192, layers=2, d_model=128, heads=4, d_ff=512,
                  max_len=1024)
SPEC_SMALL = dict(vocab=256, layers=2, d_model=128, heads=2, d_ff=256,
                  max_len=256)
SPEC_DRAFT_SMALL = dict(vocab=256, layers=1, d_model=32, heads=2, d_ff=64,
                        max_len=256)


def _profile_ticks(eng, ticks: int, device: str) -> dict:
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.step()
        sync()
        wall = time.perf_counter() - t0
    ev = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    launches = sum(e.count for e in ev if "LaunchKernel" in e.key)
    coll = sum(e.cpu_time_total for e in ev
               if e.key.startswith(("c10d::", "nccl:", "gloo:")))
    top = sorted(ev, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    return {"wall_ms_per_tick": wall * 1e3 / ticks,
            "device_busy_ms_per_tick": sum(dev_us(e) for e in ev)
            / 1e3 / ticks,
            "launches_per_tick": launches / ticks,
            "collective_host_ms_per_tick": coll / 1e3 / ticks,
            "top_host_ops_ms_per_tick": {
                e.key: round(e.self_cpu_time_total / 1e3 / ticks, 4)
                for e in top}}


def _spec_ticks(device: str, ticks: int, gammas=(2, 1, 2, 1)) -> list:
    """The plain engine and the speculative engine at each of ``gammas``
    on bench.py's generation configuration, 16 slots decoding: one record
    each."""
    big = device == "cuda"
    cfg = TransformerConfig(**(SPEC if big else SPEC_SMALL), causal=True,
                            dtype=torch.bfloat16)
    d_cfg = TransformerConfig(**(SPEC_DRAFT if big else SPEC_DRAFT_SMALL),
                              causal=True, dtype=torch.bfloat16)
    params = init_transformer(cfg, 0)
    d_params = init_transformer(d_cfg, 1)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, 96) for _ in range(16)]
    recs = []
    for key, spec in [("plain", {})] + [(f"spec_gamma{g}", {"gamma": g})
                                        for g in gammas]:
        if spec:
            spec = dict(spec, draft_params=d_params, draft_cfg=d_cfg)
        eng = ContinuousDecoder(params, cfg, device=device, max_slots=16,
                                max_len=cfg.max_len, page_size=16,
                                prefill_chunk=256, **spec)
        reqs = [eng.submit(p, 4 * (ticks + 8)) for p in prompts]
        for _ in range(4):              # admit, prefill, warm the stream
            eng.step()
        rec = {"engine": key, "layers": cfg.layers, "slots": 16,
               "steps_per_tick": 1, **_profile_ticks(eng, ticks, device)}
        if spec:
            eng.flush()
            rec["tokens_per_round_slot"] = (eng.stats["spec_emitted"]
                                            / eng.stats["spec_round_slots"])
        recs.append(rec)
        eng.cancel_all()
        del eng, reqs
    return recs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ticks", type=int, default=8)
    ap.add_argument("--spec", action="store_true",
                    help="the plain and the speculative engine at "
                         "bench.py's generation configuration")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        name, power = device_info(0)
        print(f"{name}, {power}", flush=True)
    if args.spec:
        for rec in _spec_ticks(args.device, args.ticks):
            print(json.dumps(rec), flush=True)
        return
    widths = FULL if args.device == "cuda" else SMALL
    cfg = TransformerConfig(**widths, causal=True, norm="rmsnorm",
                            position="rope", dtype=torch.bfloat16)
    params = init_transformer(cfg, seed=0)
    distributed.initialize(device=args.device)
    try:
        mesh = make_mesh({"tp": 1}, args.device)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, cfg.vocab, 64) for _ in range(16)]
        for key, m in (("single", None), ("mesh_tp1", mesh)):
            eng = ContinuousDecoder(params, cfg, device=args.device,
                                    max_slots=16, max_len=1024,
                                    page_size=16, prefill_chunk=256,
                                    steps_per_dispatch=4, mesh=m)
            reqs = [eng.submit(p, 4 * (args.ticks + 8)) for p in prompts]
            for _ in range(4):          # admit, prefill, warm the stream
                eng.step()
            rec = {"engine": key, "layers": cfg.layers, "slots": 16,
                   "steps_per_tick": 4,
                   **_profile_ticks(eng, args.ticks, args.device)}
            print(json.dumps(rec), flush=True)
            eng.cancel_all()
            del eng, reqs
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
