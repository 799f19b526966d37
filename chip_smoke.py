"""Chip smoke test for the PyTorch + CUDA port (``mmlspark_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device — a CUDA card must be present; prints its name and power limit
   (``nvidia-smi``) and turns TF32 off for matmuls and cuDNN;
2. build — compiles every ``csrc/*.cu`` with nvcc for sm_90a, one nvcc
   per source, all started together;
3. kernels — each kernel (K1 on bf16 pages, K2 on int8 and fp8 pages, at
   a decode tick and a chunked-prefill extend at full width; K3 and K4
   at a read-only shape) against its plain PyTorch version on the card:
   context within about one bf16 ulp, pages and scales bitwise, inactive
   rows untouched, NaN planted past every bound kept out; then its time,
   the plain version's time, one PyTorch library call's time as a
   yardstick, and the least time the card could take (its bound);
4. parity — at full width in float32, the engine's greedy tokens through
   the kernel equal those through the plain gather path, token for token,
   on f32 pages and on int8 and fp8 pages;
5. serving — a bf16 ``GenerationEngine`` at full width answers a dozen
   HTTP ``POST /generate`` requests (chunked prompts, a shared prefix, an
   SSE stream); K1 must have launched in this run;
6. quantized serving — a bf16 ``ContinuousDecoder(kv_dtype="int8")`` at
   full width serves the same request mix through ``submit``/``step``
   (then a shorter fp8 run); K2 must have launched and K1 not, with the
   pool at 66/128 of the bf16 layout's bytes per position;
7. read-only sweep — the public ``paged_attention`` over bf16 and int8
   pools the model filled, every layer: K3, then K4.

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


def _bits(t):
    """A tensor's raw bits, for bitwise comparison of any dtype."""
    import torch
    return t.view({1: torch.uint8, 2: torch.int16,
                   4: torch.int32}[t.element_size()])


def _kv_case_inputs(B, W, pos_list, seed, store):
    """Random pools on the card (quantized through ``quantize_kv`` when
    ``store`` is a quantized dtype), a shuffled block table, and garbage
    in every slot at or past each row's bound: NaN values in bf16 pools;
    NaN scales, plus the NaN code 0x7F in fp8 pools, in quantized ones."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.ops.kv_quant import quantize_kv

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
    pools = [kp, vp]
    if store is not None:
        (kp, ks), (vp, vs) = quantize_kv(kp, store), quantize_kv(vp, store)
        pools = [kp, vp, ks, vs]
    t_idx = torch.arange(P * page, device=dev)
    for b in range(B):
        dead = t_idx >= int(pos_np[b])
        pages, offs = bt[b, t_idx[dead] // page].long(), t_idx[dead] % page
        if store is None:
            kp[pages, :, offs] = float("nan")
            vp[pages, :, offs] = float("nan")
            continue
        ks[pages, :, offs] = float("nan")
        vs[pages, :, offs] = float("nan")
        if store != torch.int8:
            kp.view(torch.uint8)[pages, :, offs] = 0x7F
            vp.view(torch.uint8)[pages, :, offs] = 0x7F
    return dict(H=H, hd=hd, page=page, P=P, pos_np=pos_np, q=q, kn=kn,
                vn=vn, bt=bt, pools=pools, t_idx=t_idx)


def _check_ctx(what, got, want):
    """bf16 output: both round one f32 result whose sums are reordered, so
    they may differ by about one bf16 ulp (<= 2**-7 relative)."""
    import torch
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    atol, rtol = 4e-3, 1e-2
    bad = diff > atol + rtol * want.float().abs()
    if not torch.isfinite(got).all() or bad.any():
        raise AssertionError(f"{what}: ctx off by more than {atol} + "
                             f"{rtol}*|want| at {int(bad.sum())} elements, "
                             f"or not finite (max_abs_err {err})")
    return err


def _bound(dev_info, nbytes, flops):
    t_bytes = nbytes / dev_info["bw"] * 1e3
    t_ops = flops / dev_info["flops"] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _dequant_kv(pools, bt, key_ok):
    """The library yardstick's inputs: each row's cached K/V gathered and
    dequantized to contiguous bf16, zero past the bound."""
    import torch
    from mmlspark_tpu_torch.ops import paged_attention as pa
    scales = pools[2:] or [None, None]
    return [torch.where(key_ok[:, None, :, None],
                        pa._gather_rows(p, s, bt.long()), 0.0
                        ).to(torch.bfloat16)
            for p, s in zip(pools[:2], scales)]


def _fused_case(dev_info, label, B, W, pos_list, active_list, seed,
                store=None):
    """The fused kernel at one shape: K1 over bf16 pages, or K2 over
    quantized pages of ``store`` dtype. Correctness against the plain
    version, then times. Returns the record for this shape."""
    import torch
    import torch.nn.functional as F
    from mmlspark_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    x = _kv_case_inputs(B, W, pos_list, seed, store)
    H, hd, page, P = x["H"], x["hd"], x["page"], x["P"]
    q, kn, vn, bt, pools = x["q"], x["kn"], x["vn"], x["bt"], x["pools"]
    pos_np = x["pos_np"]
    quant = store is not None
    what = (f"K2 {str(store).split('.')[-1]} {label}" if quant
            else f"K1 {label}")
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    active = torch.tensor(active_list, device=dev)
    scale = 1.0 / hd ** 0.5
    wlo, whi = pa.write_range(pos, W, page, active)
    plain = [t.clone() for t in pools]
    want = pa.paged_attention_window_plain(q, kn, vn, plain[0], plain[1],
                                           bt, pos, wlo, whi, scale,
                                           *plain[2:])
    kern = [t.clone() for t in pools]
    kw = {"k_scale": kern[2], "v_scale": kern[3]} if quant else {}
    got = pa.paged_attention_window(q, kn, vn, kern[0], kern[1], bt, pos,
                                    active=active, **kw)[0]
    torch.cuda.synchronize()
    err = _check_ctx(what, got, want)
    # every non-trash page (and scale) bitwise; inactive rows untouched
    if not all(torch.equal(_bits(a[1:]), _bits(b[1:]))
               for a, b in zip(kern, plain)):
        raise AssertionError(f"{what}: pages or scales differ from the "
                             f"plain version")
    for b in range(B):
        if not active_list[b]:
            rows = bt[b].long()
            if not all(torch.equal(_bits(a[rows]), _bits(o[rows]))
                       for a, o in zip(kern, pools)):
                raise AssertionError(f"{what}: inactive row {b} wrote its "
                                     f"pages")
    # kernel time: raw back-to-back launches of the C entry point (no
    # wrapper work between them), over enough pool copies to defeat L2
    lib = pa._library()
    n = _copies(sum(t.numel() * t.element_size() for t in pools))
    copies = [[t.clone() for t in kern] for _ in range(n)]
    stream = torch.cuda.current_stream().cuda_stream
    shape = (B, H, W, P, page, scale, stream)
    ints = (bt.data_ptr(), pos.data_ptr(), wlo.data_ptr(), whi.data_ptr(),
            got.data_ptr())
    rc = []

    def launcher(c):
        ptrs = [t.data_ptr() for t in c]
        if quant:
            return lambda: rc.append(lib.mmlspark_pa_window_fused_q(
                1, pa._STORES[store], hd, q.data_ptr(), kn.data_ptr(),
                vn.data_ptr(), *ptrs, *ints, *shape))
        return lambda: rc.append(lib.mmlspark_pa_window_fused(
            1, hd, q.data_ptr(), kn.data_ptr(), vn.data_ptr(), *ptrs,
            *ints, *shape))
    ms = _cuda_ms([launcher(c) for c in copies], 200)
    if any(rc):
        raise AssertionError(f"{what}: launch returned {set(rc)}")
    plain_ms = _cuda_ms([lambda c=c: pa.paged_attention_window_plain(
        q, kn, vn, c[0], c[1], bt, pos, wlo, whi, scale, *c[2:])
        for c in copies], 20)
    del copies
    # library yardstick: one SDPA call over the gathered (dequantized)
    # contiguous K/V plus the window (the port never calls it)
    L = P * page
    key_ok = x["t_idx"][None] < pos.long()[:, None]
    kc, vc = _dequant_kv(pools, bt, key_ok)
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
    # live cached keys (< pos) of every row with their scales,
    # q/k_new/v_new, ctx, and the fresh rows (codes and scales) of the
    # active rows; flops: QK and PV over live keys
    row_bytes = hd + 2 if quant else 2 * hd     # one K or V row of a head
    live = int(pos_np.sum())
    n_active = int(sum(active_list))
    nbytes = (2 * live * H * row_bytes + 3 * B * H * W * hd * 2
              + B * H * W * hd * 2 + 2 * n_active * W * H * row_bytes
              + bt.numel() * 4 + 3 * B * 4)
    flops = sum(4 * H * hd * W * (int(p) + W) for p in pos_np)
    rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **_bound(dev_info, nbytes, flops), "library_ms": library_ms,
           "shape": {"B": B, "H": H, "W": W, "hd": hd, "page": page,
                     "max_pos": int(pos_np.max()), "live_keys": live,
                     "pages": str(store or torch.bfloat16).split(".")[-1]}}
    tag = what.split()[0].lower() + " " + " ".join(what.split()[1:])
    log(f"[{tag}] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def _read_case(dev_info, label, B, W, len_list, seed, store=None):
    """The read-only sweep at one shape: K3 over bf16 pages, or K4 over
    quantized pages. Correctness against the plain version (rows with
    ``lengths == 0`` exactly zero, pools untouched), then times."""
    import torch
    import torch.nn.functional as F
    from mmlspark_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    x = _kv_case_inputs(B, W, len_list, seed, store)
    H, hd, page, P = x["H"], x["hd"], x["page"], x["P"]
    q, bt, pools = x["q"], x["bt"], x["pools"]
    quant = store is not None
    what = (f"K4 {str(store).split('.')[-1]} {label}" if quant
            else f"K3 {label}")
    lengths = torch.tensor(len_list, dtype=torch.int32, device=dev)
    scale = 1.0 / hd ** 0.5
    want = pa.paged_attention_plain(q, pools[0], pools[1], bt, lengths,
                                    scale, *pools[2:])
    kern = [t.clone() for t in pools]
    kw = {"k_scale": kern[2], "v_scale": kern[3]} if quant else {}
    got = pa.paged_attention(q, kern[0], kern[1], bt, lengths, **kw)
    torch.cuda.synchronize()
    err = _check_ctx(what, got, want)
    empty = lengths.long() == 0
    if empty.any() and not torch.equal(got[empty].float(),
                                       torch.zeros_like(got[empty]).float()):
        raise AssertionError(f"{what}: a row with lengths == 0 is not zero")
    if not all(torch.equal(_bits(a), _bits(b)) for a, b in zip(kern, pools)):
        raise AssertionError(f"{what}: the read-only sweep wrote its pools")
    lib = pa._library()
    n = _copies(sum(t.numel() * t.element_size() for t in pools))
    copies = [[t.clone() for t in kern] for _ in range(n)]
    stream = torch.cuda.current_stream().cuda_stream
    tail = (bt.data_ptr(), lengths.data_ptr(), got.data_ptr(), B, H, W, P,
            page, scale, stream)
    rc = []

    def launcher(c):
        ptrs = [t.data_ptr() for t in c]
        if quant:
            return lambda: rc.append(lib.mmlspark_pa_read_q(
                1, pa._STORES[store], hd, q.data_ptr(), *ptrs, *tail))
        return lambda: rc.append(lib.mmlspark_pa_read(
            1, hd, q.data_ptr(), *ptrs, *tail))
    ms = _cuda_ms([launcher(c) for c in copies], 200)
    if any(rc):
        raise AssertionError(f"{what}: launch returned {set(rc)}")
    plain_ms = _cuda_ms([lambda c=c: pa.paged_attention_plain(
        q, c[0], c[1], bt, lengths, scale, *c[2:]) for c in copies], 20)
    del copies
    L = P * page
    key_ok = x["t_idx"][None] < lengths.long()[:, None]
    kc, vc = _dequant_kv(pools, bt, key_ok)
    mask = key_ok[:, None, None, :].expand(B, 1, W, L)
    n = _copies(2 * kc.numel() * kc.element_size())
    kvs = [(kc.clone(), vc.clone()) for _ in range(n)]
    library_ms = _cuda_ms([lambda c=c: F.scaled_dot_product_attention(
        q, c[0], c[1], attn_mask=mask) for c in kvs], 200)
    del kvs
    # bound: live keys (< lengths) with their scales, q and ctx
    row_bytes = hd + 2 if quant else 2 * hd
    live = int(sum(len_list))
    nbytes = (2 * live * H * row_bytes + 2 * B * H * W * hd * 2
              + bt.numel() * 4 + B * 4)
    flops = 4 * H * hd * W * live
    rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **_bound(dev_info, nbytes, flops), "library_ms": library_ms,
           "shape": {"B": B, "H": H, "W": W, "hd": hd, "page": page,
                     "max_len": max(len_list), "live_keys": live,
                     "pages": str(store or torch.bfloat16).split(".")[-1]}}
    tag = what.split()[0].lower() + " " + " ".join(what.split()[1:])
    log(f"[{tag}] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def phase_kernels(dev_info):
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    # decode tick: B=16, W=1, contexts up to ~1024 crossing page
    # boundaries (incl. 0, exact multiples of 16), two inactive rows
    pos = [0, 1, 15, 16, 17, 255, 256, 300, 511, 512, 700, 1000, 1023,
           int(rng.integers(1, 1024)), 64, 900]
    active = [True] * 16
    active[5] = active[11] = False
    recs = {"K1": {}, "K2": {}}
    # chunked-prefill extend: one row, a 256-token window at position 384
    shapes = {"decode": (16, 1, pos, active, 1),
              "extend": (1, 256, [384], [True], 2)}
    for label, args in shapes.items():
        recs["K1"][label] = _fused_case(dev_info, label, *args)
    for store in (torch.int8, torch.float8_e4m3fn):
        name = str(store).split(".")[-1]
        for label, args in shapes.items():
            recs["K2"][f"{name} {label}"] = _fused_case(
                dev_info, label, *args, store=store)
    # the read-only sweep: 16 rows of 4 queries over the same ragged
    # lengths (row 0 has none)
    recs["K3"] = _read_case(dev_info, "read", 16, 4, pos, 3)
    recs["K4"] = _read_case(dev_info, "read", 16, 4, pos, 4,
                            store=torch.int8)
    return recs


def _full_cfg(torch_dtype):
    from mmlspark_tpu_torch.models.zoo.transformer import TransformerConfig
    return TransformerConfig(dtype=torch_dtype, **FULL)


def phase_parity(params_np):
    """f32 full width: kernel and plain-gather engines give the same greedy
    tokens, on model-dtype pages (K1) and on int8 and fp8 pages (K2)."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder
    cfg = _full_cfg(torch.float32)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (20, 70, 300)]
    for kv_dtype in (None, "int8", "fp8"):
        outs = {}
        for impl in ("kernel", "gather"):
            eng = ContinuousDecoder(params_np, cfg, max_slots=4, max_len=384,
                                    page_size=16, prefill_chunk=128,
                                    steps_per_dispatch=2, paged_attn=impl,
                                    kv_dtype=kv_dtype)
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
            raise AssertionError(
                f"f32 greedy tokens differ ({kv_dtype or 'f32'} pages): "
                f"kernel {outs['kernel']} vs gather {outs['gather']}")
        log(f"[parity] f32 full width, {kv_dtype or 'f32'} pages: kernel == "
            f"gather for {len(prompts)} requests x 16 tokens (prompts "
            f"20/70/300)")


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


def phase_quant_serving(params_np, dev_info, kv_dtype, sizes):
    """bf16 full width, quantized pages: a ``ContinuousDecoder`` driven by
    ``submit`` and ``step()`` until every request is done (prompts of
    ``sizes`` plus two sharing a 96-token prefix, the prefix owner first,
    64 new tokens each). K2 must be the only paged kernel launched in the
    run, nothing gathered, the prefix hit, the pool at 66/128 of bf16's
    bytes per position, and the write-time probe must have fired."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.ops.kv_quant import kv_bytes_per_position
    from mmlspark_tpu_torch.ops.paged_attention import paged_attention_window
    from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder
    cfg = _full_cfg(torch.bfloat16)
    rng = np.random.default_rng(3)
    max_new = 64
    shared = rng.integers(0, cfg.vocab, 96)
    # quant_probe=2: a run of this mix inserts prefill rows only a few
    # times (one batched insert per pad bucket, one for the prefix owner;
    # chunked prompts and prefix hits insert none), so a larger interval
    # would never fire within it
    eng = ContinuousDecoder(params_np, cfg, max_slots=16, max_len=1024,
                            page_size=16, prefill_chunk=256,
                            steps_per_dispatch=4, kv_dtype=kv_dtype,
                            quant_probe=2)
    warm = eng.submit([1, 2, 3], 4)     # cuBLAS handles, allocator
    while not warm.done:
        eng.step()
    eng.tick_seconds.clear()
    stats0 = dict(eng._kv.stats)
    hits0 = eng.stats["prefix_hits"]
    eng._quant_inserts = 0
    paged_attention_window.launches = 0
    paged_attention_window.launches_q = 0
    t0 = time.perf_counter()
    reqs = [eng.submit(np.concatenate([shared, rng.integers(0, cfg.vocab,
                                                            tail)]),
                       max_new, prefix_key="system", prefix_len=len(shared))
            for tail in (8, 24)]
    reqs += [eng.submit(rng.integers(0, cfg.vocab, n), max_new)
             for n in sizes]
    while not all(r.done for r in reqs):
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = (paged_attention_window.launches,
              paged_attention_window.launches_q)
    stats = eng._kv.stats
    for r in reqs:
        toks = eng.result(r, timeout=1)
        if len(toks) != max_new or not all(0 <= t < cfg.vocab for t in toks):
            raise AssertionError(f"{kv_dtype} request {r.rid}: {len(toks)} "
                                 f"tokens, want {max_new} in-vocab")
    gather = stats["gather_bytes"] - stats0["gather_bytes"]
    hits = eng.stats["prefix_hits"] - hits0
    probes = stats["quant_error_probes"] - stats0["quant_error_probes"]
    hd = cfg.d_model // cfg.heads
    bf16_bpp = cfg.layers * kv_bytes_per_position(cfg.heads, hd,
                                                  torch.bfloat16, False)
    bpp = eng._kv.bytes_per_position()
    if k2 <= 0 or k1 != 0 or gather != 0:
        raise AssertionError(f"{kv_dtype}: K2 launches {k2}, K1 launches "
                             f"{k1}, gather_bytes {gather}")
    if hits < 1:
        raise AssertionError(f"{kv_dtype}: the shared-prefix request did "
                             f"not hit")
    if bpp * 128 != bf16_bpp * 66:
        raise AssertionError(f"{kv_dtype}: {bpp} bytes per position, want "
                             f"66/128 of bf16's {bf16_bpp}")
    if probes < 1:
        raise AssertionError(f"{kv_dtype}: the quantization probe never "
                             f"fired")
    n_tok = sum(len(r.tokens) for r in reqs)
    ticks = list(eng.tick_seconds)
    rec = {"kv_dtype": kv_dtype, "requests": len(reqs), "tokens": n_tok,
           "wall_s": wall, "tok_per_s": n_tok / wall,
           "p50_tick_ms": statistics.median(ticks) * 1e3,
           "ticks": len(ticks), "k2_launches": k2, "k1_launches": k1,
           "gather_bytes": gather, "prefix_hits": hits,
           "bytes_per_position": bpp, "bytes_per_position_bf16": bf16_bpp,
           "pool_device_bytes": eng._kv.device_bytes(),
           "quant_error_probes": probes,
           "quant_error_max": stats["quant_error_max"],
           "steps_per_dispatch": 4, "layers": cfg.layers}
    log(f"[quant serving] {json.dumps(rec)} | {dev_info['smi']}")
    del eng
    torch.cuda.empty_cache()
    return rec


def phase_read_sweep(params_np, dev_info):
    """bf16 full width: the public read-only op over pools the model
    filled. Four prompts are prefilled and scattered into a bf16 pool and
    an int8 pool; ``paged_attention`` then runs every layer's queries
    over each (K3, then K4), held against a dense softmax over the
    gathered keys, with a row of length 0 giving zeros."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.models.zoo import transformer as tf
    from mmlspark_tpu_torch.ops.paged_attention import paged_attention
    from mmlspark_tpu_torch.utils.device import resolve_device
    cfg = _full_cfg(torch.bfloat16)
    dev = resolve_device()
    params = tf.params_from_numpy(params_np, cfg, dev)
    rng = np.random.default_rng(4)
    B, W, page, L = 4, 4, 16, 512
    fill = [37, 200, 1, 511]
    lengths = torch.tensor([37, 200, 0, 511], dtype=torch.int32, device=dev)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab, (B, L))).to(dev)
    _, rows = tf.prefill_cache(params, ids, torch.tensor(fill, device=dev),
                               cfg, L)
    P = L // page
    bt = (1 + torch.randperm(B * P, device=dev)).reshape(B, P).to(torch.int32)
    hd = cfg.d_model // cfg.heads
    q = torch.randn(cfg.layers, B, cfg.heads, W, hd, device=dev).to(
        torch.bfloat16)
    key_ok = (torch.arange(L, device=dev)[None]
              < lengths.long()[:, None])[:, None, None, :]
    counts = {}
    err = 0.0
    for kv_dtype in (None, "int8"):
        pages = tf.paged_scatter_rows(
            tf.init_paged_cache(cfg, 1 + B * P, page, dev, kv_dtype), rows,
            bt, page)
        gathered = tf.paged_gather(pages, bt, L, out_dtype=torch.float32)
        paged_attention.launches = paged_attention.launches_q = 0
        outs = []
        for li, c in enumerate(pages):
            scales = ({"k_scale": c["k_scale"], "v_scale": c["v_scale"]}
                      if kv_dtype else {})
            outs.append(paged_attention(q[li], c["k"], c["v"], bt, lengths,
                                        **scales))
        torch.cuda.synchronize()
        counts[kv_dtype or "bf16"] = (paged_attention.launches,
                                      paged_attention.launches_q)
        for li, (out, g) in enumerate(zip(outs, gathered)):
            s = (q[li].float() @ g["k"].transpose(-1, -2)) / hd ** 0.5
            s = torch.where(key_ok, s, -1e30)
            p = torch.softmax(s, -1) * key_ok
            want = p @ g["v"]
            if out.shape != q[li].shape:
                raise AssertionError(f"read sweep: ctx {tuple(out.shape)}")
            err = max(err, _check_ctx(f"read sweep {kv_dtype} layer {li}",
                                      out, want))
            if out[2].abs().max().item() != 0.0:
                raise AssertionError("read sweep: the length-0 row is not "
                                     "zero")
    k3, k4 = counts["bf16"][0], counts["int8"][1]
    if k3 != cfg.layers or k4 != cfg.layers or counts["bf16"][1] or \
            counts["int8"][0]:
        raise AssertionError(f"read sweep launches {counts}, want "
                             f"{cfg.layers} K3 then {cfg.layers} K4")
    rec = {"rows": B, "queries": W, "lengths": lengths.tolist(),
           "layers": cfg.layers, "k3_launches": k3, "k4_launches": k4,
           "max_abs_err_vs_dense": err}
    log(f"[read sweep] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


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
    recs = phase_kernels(dev_info)
    from mmlspark_tpu_torch.models.zoo.transformer import init_transformer
    import torch
    params_np = init_transformer(_full_cfg(torch.float32), seed=0)
    phase_parity(params_np)
    k1_launches = phase_serving(params_np, dev_info)
    q8 = phase_quant_serving(params_np, dev_info, "int8",
                             [32, 128, 384] * 3)
    f8 = phase_quant_serving(params_np, dev_info, "fp8", [32, 384])
    sweep = phase_read_sweep(params_np, dev_info)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    src = "mmlspark_tpu_torch/csrc/paged_attention.cu"
    ref = "mmlspark_tpu/ops/paged_attention.py"
    kernels = [
        {"name": "paged_attention_window", "route": "cuda", "source": src,
         "replaces": f"{ref}:226", "launches": k1_launches,
         **{k: recs["K1"]["decode"][k] for k in keys}, **recs["K1"]},
        {"name": "paged_attention_window (k_scale/v_scale)", "route": "cuda",
         "source": src, "replaces": f"{ref}:404",
         "launches": q8["k2_launches"], "launches_fp8_run": f8["k2_launches"],
         **{k: recs["K2"]["int8 decode"][k] for k in keys}, **recs["K2"]},
        {"name": "paged_attention", "route": "cuda", "source": src,
         "replaces": f"{ref}:195", "launches": sweep["k3_launches"],
         **{k: recs["K3"][k] for k in keys}, "read": recs["K3"]},
        {"name": "paged_attention (k_scale/v_scale)", "route": "cuda",
         "source": src, "replaces": f"{ref}:356",
         "launches": sweep["k4_launches"],
         **{k: recs["K4"][k] for k in keys}, "read": recs["K4"]}]
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
