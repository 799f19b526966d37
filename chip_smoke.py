"""Chip smoke test for the PyTorch + CUDA port (``mmlspark_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device — a CUDA card must be present; prints its name and power limit
   (``nvidia-smi``) and turns TF32 off for matmuls and cuDNN;
2. build — compiles every ``csrc/*.cu`` with nvcc for sm_90a, one nvcc
   per source, all started together;
3. kernels — each kernel of the serving path against its plain PyTorch
   version on the card, at the shapes the path gives it (a decode tick
   and a chunked-prefill extend at full width), with its time, the plain
   version's time, one PyTorch library call's time as a yardstick, and
   the least time the card could take (its bound);
4. parity — at full width in float32, the engine's greedy tokens through
   the kernel equal those through the plain gather path, token for token;
5. serving — a bf16 ``GenerationEngine`` at full width answers a dozen
   HTTP ``POST /generate`` requests (chunked prompts, a shared prefix, an
   SSE stream); every kernel of the path must have launched in this run.

The last three lines are the kernels' JSON record, the card's name and
power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` prints them, and ``{"ok": true, "device":
{...}}``. Nothing here imports JAX or the JAX package.
"""

import json
import os
import statistics
import sys
import threading
import time
import traceback
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))

#: data-sheet peaks by card name: (HBM bytes/s, dense bf16 FLOP/s)
PEAKS = [("H200", 4.8e12, 989e12), ("H100 NVL", 3.9e12, 835e12),
         ("H100 PCIe", 2.0e12, 756e12), ("H100", 3.35e12, 989e12)]

# full width: the repo's GPT-2-small-class decoder (scripts/bench_decode.py)
FULL = dict(vocab=32000, layers=12, d_model=768, heads=12, d_ff=3072,
            max_len=2048, causal=True, norm="rmsnorm", position="rope")


def log(msg):
    print(msg, flush=True)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False); nothing runs on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mmlspark_tpu_torch.utils.device import device_info
    smi_name, power = device_info(0)
    if power is None:
        raise RuntimeError("nvidia-smi did not report the power limit")
    smi = f"{smi_name}, {power}"
    name = torch.cuda.get_device_name(0)
    bw, flops = next((b, f) for key, b, f in PEAKS if key in name) \
        if any(k in name for k, _, _ in PEAKS) else (3.35e12, 989e12)
    log(f"[device] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | count {torch.cuda.device_count()}")
    log(f"[device] data-sheet peaks used for bounds: {bw / 1e12} TB/s, "
        f"{flops / 1e12} TFLOP/s bf16")
    return {"smi": smi, "name": name, "bw": bw, "flops": flops}


def phase_build():
    from mmlspark_tpu_torch.utils import cuda_build
    t0 = time.perf_counter()
    secs = cuda_build.build_all()
    log(f"[build] {secs} (wall {time.perf_counter() - t0:.2f} s)")
    for name, text in cuda_build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {name}: {line.strip()}")


def _cuda_ms(fns, reps):
    """Mean device ms per call over ``reps`` back-to-back calls between two
    CUDA events, cycling through ``fns`` (one per copy of the inputs, so
    that together they exceed the 50 MB L2 and each call finds its data
    cold, as each layer of the real model does)."""
    import torch
    for f in fns[:3]:
        f()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(reps):
        fns[i % len(fns)]()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _copies(nbytes):
    """How many copies of ``nbytes`` of inputs exceed twice the L2."""
    return int(min(64, max(4, -(-100 * 2 ** 20 // max(1, nbytes)))))


def _k1_case(dev_info, label, B, W, pos_list, active_list, seed):
    """K1 at one shape: correctness against the plain version, then
    times. Returns the record for this shape."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from mmlspark_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    H, hd, page = 12, 64, 16
    pos_np = np.array(pos_list, np.int64)
    P = int(-(-(pos_np.max() + W) // page))
    N = 1 + B * P
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    kp = torch.randn(N, H, page, hd, generator=g, device=dev).to(bf)
    vp = torch.randn(N, H, page, hd, generator=g, device=dev).to(bf)
    q, kn, vn = (torch.randn(B, H, W, hd, generator=g, device=dev).to(bf)
                 for _ in range(3))
    perm = torch.randperm(B * P, generator=g, device=dev) + 1
    bt = perm.reshape(B, P).to(torch.int32)
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    active = torch.tensor(active_list, device=dev)
    # unwritten slots hold garbage: NaN at every position >= pos
    t_idx = torch.arange(P * page, device=dev)
    for b in range(B):
        dead = t_idx >= int(pos_np[b])
        pages, offs = bt[b, t_idx[dead] // page].long(), t_idx[dead] % page
        kp[pages, :, offs] = float("nan")
        vp[pages, :, offs] = float("nan")
    scale = 1.0 / hd ** 0.5
    wlo, whi = pa.write_range(pos, W, page, active)
    kp_plain, vp_plain = kp.clone(), vp.clone()
    want = pa.paged_attention_window_plain(q, kn, vn, kp_plain, vp_plain,
                                           bt, pos, wlo, whi, scale)
    kp_k, vp_k = kp.clone(), vp.clone()
    got, _, _ = pa.paged_attention_window(q, kn, vn, kp_k, vp_k, bt, pos,
                                          active=active)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    # bf16 output: both round one f32 result whose sums are reordered, so
    # they may differ by about one bf16 ulp (<= 2**-7 relative)
    atol, rtol = 4e-3, 1e-2
    bad = diff > atol + rtol * want.float().abs()
    if not torch.isfinite(got).all() or bad.any():
        raise AssertionError(f"K1 {label}: ctx off by more than {atol} + "
                             f"{rtol}*|want| at {int(bad.sum())} elements "
                             f"(max_abs_err {err})")

    def bits(t):
        return t.view(torch.int16)
    if not (torch.equal(bits(kp_k[1:]), bits(kp_plain[1:]))
            and torch.equal(bits(vp_k[1:]), bits(vp_plain[1:]))):
        raise AssertionError(f"K1 {label}: pages differ from the plain "
                             f"version")
    for b in range(B):
        if not active_list[b]:
            rows = bt[b].long()
            if not (torch.equal(bits(kp_k[rows]), bits(kp[rows]))
                    and torch.equal(bits(vp_k[rows]), bits(vp[rows]))):
                raise AssertionError(f"K1 {label}: inactive row {b} wrote "
                                     f"its pages")
    # kernel time: raw back-to-back launches of the C entry point (no
    # wrapper work between them), over enough pool copies to defeat L2
    lib = pa._library()
    n = _copies(2 * kp.numel() * kp.element_size())
    pools = [(kp_k.clone(), vp_k.clone()) for _ in range(n)]
    stream = torch.cuda.current_stream().cuda_stream
    rc = []

    def launcher(kpc, vpc):
        def f():
            rc.append(lib.mmlspark_pa_window_fused(
                1, hd, q.data_ptr(), kn.data_ptr(), vn.data_ptr(),
                kpc.data_ptr(), vpc.data_ptr(), bt.data_ptr(),
                pos.data_ptr(), wlo.data_ptr(), whi.data_ptr(),
                got.data_ptr(), B, H, W, P, page, scale, stream))
        return f
    ms = _cuda_ms([launcher(*c) for c in pools], 200)
    if any(rc):
        raise AssertionError(f"K1 {label}: launch returned {set(rc)}")
    plain_ms = _cuda_ms([lambda c=c: pa.paged_attention_window_plain(
        q, kn, vn, c[0], c[1], bt, pos, wlo, whi, scale) for c in pools], 20)
    del pools
    # library yardstick: one SDPA call over the gathered contiguous K/V
    # plus the window (the port never calls it)
    L = P * page
    kc = kp[bt.long()].permute(0, 2, 1, 3, 4).reshape(B, H, L, hd)
    vc = vp[bt.long()].permute(0, 2, 1, 3, 4).reshape(B, H, L, hd)
    key_ok = t_idx[None] < pos.long()[:, None]
    kc = torch.where(key_ok[:, None, :, None], kc, 0).to(bf)
    vc = torch.where(key_ok[:, None, :, None], vc, 0).to(bf)
    k_all = torch.cat([kc, kn], 2).contiguous()
    v_all = torch.cat([vc, vn], 2).contiguous()
    causal = torch.tril(torch.ones(W, W, dtype=torch.bool, device=dev))
    mask = torch.cat([key_ok[:, None, None, :].expand(B, 1, W, L),
                      causal[None, None].expand(B, 1, W, W)], -1)
    n = _copies(2 * k_all.numel() * k_all.element_size())
    kvs = [(k_all.clone(), v_all.clone()) for _ in range(n)]
    library_ms = _cuda_ms([lambda c=c: F.scaled_dot_product_attention(
        q, c[0], c[1], attn_mask=mask) for c in kvs], 200)
    del kvs
    # bound: each input byte read once, each output byte written once —
    # live cached keys (< pos) of every row, q/k_new/v_new, ctx, and the
    # fresh rows of the active rows; flops: QK and PV over live keys
    live = int(pos_np.sum())
    n_active = int(sum(active_list))
    nbytes = (2 * live * H * hd * 2 + 3 * B * H * W * hd * 2
              + B * H * W * hd * 2 + 2 * n_active * W * H * hd * 2
              + bt.numel() * 4 + 3 * B * 4)
    flops = sum(4 * H * hd * W * (int(p) + W) for p in pos_np)
    t_bytes = nbytes / dev_info["bw"] * 1e3
    t_ops = flops / dev_info["flops"] * 1e3
    rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": library_ms,
           "shape": {"B": B, "H": H, "W": W, "hd": hd, "page": page,
                     "max_pos": int(pos_np.max()), "live_keys": live}}
    log(f"[k1 {label}] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def phase_kernels(dev_info):
    import numpy as np
    rng = np.random.default_rng(0)
    # decode tick: B=16, W=1, contexts up to ~1024 crossing page
    # boundaries (incl. 0, exact multiples of 16), two inactive rows
    pos = [0, 1, 15, 16, 17, 255, 256, 300, 511, 512, 700, 1000, 1023,
           int(rng.integers(1, 1024)), 64, 900]
    active = [True] * 16
    active[5] = active[11] = False
    decode = _k1_case(dev_info, "decode", 16, 1, pos, active, 1)
    # chunked-prefill extend: one row, a 256-token window at position 384
    extend = _k1_case(dev_info, "extend", 1, 256, [384], [True], 2)
    return decode, extend


def _full_cfg(torch_dtype):
    from mmlspark_tpu_torch.models.zoo.transformer import TransformerConfig
    return TransformerConfig(dtype=torch_dtype, **FULL)


def phase_parity(params_np):
    """f32 full width: kernel and plain-gather engines, same greedy tokens."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder
    cfg = _full_cfg(torch.float32)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (20, 70, 300)]
    outs = {}
    for impl in ("kernel", "gather"):
        eng = ContinuousDecoder(params_np, cfg, max_slots=4, max_len=384,
                                page_size=16, prefill_chunk=128,
                                steps_per_dispatch=2, paged_attn=impl)
        reqs = [eng.submit(p, 16) for p in prompts]
        for _ in range(400):
            if all(r.done for r in reqs):
                break
            eng.step()
        eng.flush()
        outs[impl] = [eng.result(r, timeout=1) for r in reqs]
        del eng
        torch.cuda.empty_cache()
    if outs["kernel"] != outs["gather"]:
        raise AssertionError(f"f32 greedy tokens differ: kernel "
                             f"{outs['kernel']} vs gather {outs['gather']}")
    log(f"[parity] f32 full width: kernel == gather for "
        f"{len(prompts)} requests x 16 tokens (prompts 20/70/300)")


def _post(url, payload, timeout=300):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def phase_serving(params_np, dev_info):
    import numpy as np
    import torch
    from mmlspark_tpu_torch.ops.paged_attention import paged_attention_window
    from mmlspark_tpu_torch.serving.generation import GenerationEngine
    cfg = _full_cfg(torch.bfloat16)
    rng = np.random.default_rng(2)
    max_new = 64
    shared = [int(t) for t in rng.integers(0, cfg.vocab, 96)]
    payloads = []
    for i, n in enumerate([32, 128, 384] * 3):
        payloads.append({"tokens": [int(t) for t in
                                    rng.integers(0, cfg.vocab, n)],
                         "max_new": max_new})
    for tail in (8, 24):
        payloads.append({"tokens": shared + [int(t) for t in
                                             rng.integers(0, cfg.vocab, tail)],
                         "max_new": max_new, "prefix_key": "system",
                         "prefix_len": len(shared)})
    payloads.append({"tokens": [int(t) for t in rng.integers(0, cfg.vocab, 48)],
                     "max_new": max_new, "stream": True})
    eng = GenerationEngine(params_np, cfg, max_slots=16, max_len=1024,
                           page_size=16, prefill_chunk=256,
                           steps_per_dispatch=4)
    results = {}
    try:
        eng.start()
        # warm-up request (cuBLAS handles, allocator), not part of the run
        st, _ = _post(eng.address, {"tokens": [1, 2, 3], "max_new": 4})
        assert st == 200
        eng.decoder.tick_seconds.clear()
        stats0 = dict(eng.decoder._kv.stats)
        paged_attention_window.launches = 0

        def client(i, p):
            try:
                results[i] = _post(eng.address, p)
            except Exception as e:      # recorded, checked below
                results[i] = (None, repr(e).encode())

        # the prefix owner goes first so its pages are registered
        t0 = time.perf_counter()
        first = threading.Thread(target=client, args=(9, payloads[9]))
        first.start()
        first.join(timeout=300)
        threads = [threading.Thread(target=client, args=(i, p))
                   for i, p in enumerate(payloads) if i != 9]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        launches = paged_attention_window.launches
        stats = eng.decoder._kv.stats
        ticks = list(eng.decoder.tick_seconds)
        prefix_hits = eng.decoder.stats["prefix_hits"]
    finally:
        eng.stop()
    n_tok = 0
    for i, p in enumerate(payloads):
        status, body = results.get(i, (None, b"missing"))
        if status != 200:
            raise AssertionError(f"request {i} answered {status}: {body!r}")
        if p.get("stream"):
            events = [json.loads(line[6:]) for line in
                      body.decode().split("\n\n") if line.startswith("data: ")]
            final = events[-1]
            if not final.get("done"):
                raise AssertionError(f"stream ended without done: {final}")
            toks = final["tokens"]
            streamed = [t for e in events[:-1] for t in e.get("tokens", [])]
            if streamed != toks:
                raise AssertionError("streamed tokens differ from the final "
                                     "event")
        else:
            toks = json.loads(body)["tokens"]
        if len(toks) != max_new or not all(0 <= t < cfg.vocab for t in toks):
            raise AssertionError(f"request {i}: {len(toks)} tokens, want "
                                 f"{max_new} in-vocab")
        n_tok += len(toks)
    gather = stats["gather_bytes"] - stats0["gather_bytes"]
    if launches <= 0 or gather != 0:
        raise AssertionError(f"K1 launches {launches}, gather_bytes {gather}")
    if prefix_hits < 1:
        raise AssertionError("the shared-prefix request did not hit")
    p50 = statistics.median(ticks) * 1e3 if ticks else float("nan")
    rec = {"requests": len(payloads), "tokens": n_tok, "wall_s": wall,
           "tok_per_s": n_tok / wall, "p50_tick_ms": p50,
           "ticks": len(ticks), "k1_launches": launches,
           "gather_bytes": gather, "prefix_hits": prefix_hits,
           "steps_per_dispatch": 4, "layers": cfg.layers}
    log(f"[serving] {json.dumps(rec)} | {dev_info['smi']}")
    return launches


def main():
    sys.path.insert(0, HERE)
    try:
        import mmlspark_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"chip_smoke: the port package is not next to this script ({e})")
        return 2
    t_start = time.perf_counter()
    dev_info = phase_device()
    phase_build()
    decode, extend = phase_kernels(dev_info)
    from mmlspark_tpu_torch.models.zoo.transformer import init_transformer
    import torch
    params_np = init_transformer(_full_cfg(torch.float32), seed=0)
    phase_parity(params_np)
    launches = phase_serving(params_np, dev_info)
    kernels = [{"name": "paged_attention_window", "route": "cuda",
                "source": "mmlspark_tpu_torch/csrc/paged_attention.cu",
                "replaces": "mmlspark_tpu/ops/paged_attention.py:226",
                "launches": launches,
                **{k: decode[k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")},
                "decode": decode, "extend": extend}]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(dev_info["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        code = 1
    sys.exit(code)
