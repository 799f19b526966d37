"""Chip smoke test for the PyTorch + CUDA port (``mmlspark_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device — a CUDA card must be present; prints its name and power limit
   (``nvidia-smi``) and turns TF32 off for matmuls and cuDNN;
2. build — compiles every ``csrc/*.cu`` with nvcc for sm_90a, one nvcc
   per source, all started together;
3. kernels — each kernel (K1 on bf16 pages, K2 on int8 and fp8 pages, at
   a decode tick, serving's own decode over its 64-page block table, a
   2047-key straggler, a chunked-prefill extend at full width and
   serving's own window shapes: a prompt's first and second chunks, an
   8-token prefix suffix at an unaligned position, four rows with one
   inactive; K3 and K4 at a read-only shape) against its plain PyTorch
   version on the card: context within about one bf16 ulp (plus 2^-8 of
   the same attention over |V| for the tensor-core window body, K1/K2 at
   W > 1, which rounds P to bf16), pages and scales bitwise, inactive
   rows untouched, NaN planted past every bound kept out; K1/K2 on the
   body the library reports (split at W = 1, tensor-core at W > 1), one
   kernel launch a call (``torch.profiler``); then its time, the plain
   version's time, one PyTorch library call's time as a yardstick, and
   the least time the card could take (its bound);
4. parity — at full width in float32, the engine's greedy tokens through
   the kernel equal those through the plain gather path, token for token,
   on f32 pages and on int8 and fp8 pages, the kernel engine's decode
   steps on the split body;
5. serving — a bf16 ``GenerationEngine`` at full width answers a dozen
   HTTP ``POST /generate`` requests (chunked prompts, a shared prefix, an
   SSE stream); K1 must have launched in this run, its launches split by
   the body the library reports into extends on the tensor-core body
   (prefill chunks and prefix suffixes, each once per layer, from the
   engine's chunk trace and prefix hits) and decode steps on the split
   body (the engine's other attention calls, once per layer), no other;
6. quantized serving — a bf16 ``ContinuousDecoder(kv_dtype="int8")`` at
   full width serves the same request mix through ``submit``/``step``
   (then a shorter fp8 run); K2 must have launched and K1 not, split by
   body as in 5, with the pool at 66/128 of the bf16 layout's bytes per
   position;
7. read-only sweep — the public ``paged_attention`` over bf16 and int8
   pools the model filled, every layer: K3, then K4;
8. GBDT — (a) the histogram kernel K6 against its plain version at the
   level shapes of an 11M x 28 run (1 ... 16 nodes), at 256 nodes on
   ragged rows, on uint16 bins, bf16-rounded stats, bagged-out rows and
   a 2-bin feature: counts bitwise, g/h within 2e-6 * sum|stat| + 1e-7
   of a float64 sum; times beside the plain version, one ``index_add_``
   and the bound; (b) one full-size tree (depth 5) through K6 and
   through the plain version: the same splits, or a recorded tie; (c)
   ``train()`` on the repo's HIGGS-shaped 11,000,000 x 28 matrix, 100
   iterations after a 1-iteration warm-up: exactly 5 K6 launches per
   iteration and no plain call, train AUC above 0.75, a bitwise model
   string round trip; bin, upload and boosting seconds, sec/iter and
   K6's share of an iteration;
9. flash attention — (a) K7 (with and without stats), K8a and K8b
   against their plain versions at BERT-base (B=8, H=12, S=512, D=64,
   ragged padding masks with one fully padded row, NaN planted in every
   masked key row), the causal decoder (B=2, S=2048), an unaligned S=200
   at D=32 and D=128, the main paths' own shapes, and masks with a whole
   64-key hole in every row (the masked-tile skip) at D=64 and D=128,
   each in bf16 and f32: f32 within 1e-5 * max|ref|, bf16 within 2 bf16
   ulps (+ 1e-5 * max|ref|) of the plain f32 result, plus 2^-8 of the
   same product over absolute values for the bf16 K7's o, K8a's dK and
   dV and K8b's dQ (they round P and dS to bf16 once); the fully padded row
   exactly 0; times at the ``FLASH_TIMED`` shapes beside the plain
   versions, SDPA (forward and its autograd backward) and the bounds;
   (b) BERT-base f32 ``transformer_apply(use_flash=True)`` and
   the gradients of ``loss_fn`` through the kernels against the same
   through the plain versions, and dense against flash on the rows that
   are not fully padded; (c) bf16 encoder inference at B=32, S=512:
   sequences/s with exactly 12 K7 launches per forward, and the
   hidden states against one forward through dense attention; (d) bf16
   training at B=16, S=512: 10 ``train_step``s after a warm-up, 12
   launches each of K7, K8a and K8b per step, the loss lower at the
   end, step seconds and tokens/s; then one step of the causal decoder
   at B=4, S=2048 with flash and with dense attention: flash's peak
   device memory below dense's;
10. the mesh — (a) K5a (bf16 pages) and K5b (int8, fp8) against their
   plain versions at the decode (split body) and extend (tensor-core
   body) shapes, the decode on 6 heads (one rank's shard at tp = 2),
   serving's own decode (16 rows up to 448 keys over a 64-page block
   table) and a straggler (one row at 2047, the rest at 64 or below):
   ctx within about one bf16 ulp (plus 2^-8 of the same attention over
   |V| at the extend), NaN planted at and past pos kept out, every pool
   bit untouched, the body the library reports, one kernel launch a
   call (``torch.profiler``); times beside the plain versions, SDPA and
   the bounds, the wrapper's host-paced time and host issue cost, and
   the rows the mesh path writes after the kernel timed alone; (b) a tp
   = 1 mesh (a world of one rank over NCCL): f32 full-width greedy
   tokens of the meshed kernel engine equal phase 4's single-device ones
   and the meshed gather engine's, on f32, int8 and fp8 pages, through
   K5a/K5b (decode steps on the split body) and never K1/K2; (c) bf16
   serving of phase 6's mix on a single-device engine and on the tp = 1
   mesh: K1 (single device) or K5a (mesh) once per layer per attention
   call, the tensor-core launches exactly the prefill chunks and prefix
   suffixes times the layers and the split ones the decode steps,
   tokens/s and p50 tick side by side;
   (d) tp = 2 as two gloo processes sharing the card, six heads and a
   pool shard each: both ranks' f32 tokens equal each other's and 10b's
   over all 16 tokens, the decode steps on the split body.

``python3 chip_smoke.py 10`` runs phases 1, 2, 4 and 10 only,
``python3 chip_smoke.py 9`` phases 1, 2 and 9, and ``python3
chip_smoke.py 3`` phases 1, 2 and 3; each prints no result and exits 3.

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

#: data-sheet peaks by card name: (HBM bytes/s, dense bf16 FLOP/s,
#: float32 FLOP/s outside the tensor cores)
PEAKS = [("H200", 4.8e12, 989e12, 67e12),
         ("H100 NVL", 3.9e12, 835e12, 60e12),
         ("H100 PCIe", 2.0e12, 756e12, 51e12),
         ("H100", 3.35e12, 989e12, 67e12)]

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
    bw, flops, f32 = next(((b, f, f32) for key, b, f, f32 in PEAKS
                           if key in name), PEAKS[-1][1:])
    log(f"[device] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | count {torch.cuda.device_count()}")
    log(f"[device] data-sheet peaks used for bounds: {bw / 1e12} TB/s, "
        f"{flops / 1e12} TFLOP/s bf16, {f32 / 1e12} TFLOP/s f32")
    return {"smi": smi, "name": name, "bw": bw, "flops": flops,
            "flops_f32": f32}


def phase_build():
    from mmlspark_tpu_torch.utils import cuda_build
    t0 = time.perf_counter()
    secs = cuda_build.build_all()
    log(f"[build] {secs} (wall {time.perf_counter() - t0:.2f} s)")
    for name, text in cuda_build.build_logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "smem")):
                log(f"[build] {name}: {line.strip()}")


def _cuda_ms(fns, reps, head_start=True):
    """Mean device ms per call over ``reps`` back-to-back calls between two
    CUDA events, cycling through ``fns`` (one per copy of the inputs, so
    that together they exceed the 50 MB L2 and each call finds its data
    cold, as each layer of the real model does).

    ``head_start``: the stream first spins for longer than the host takes
    to issue all ``reps`` calls, so the events time the device alone; a
    call whose kernels finish faster than the host issues them (SDPA with
    a mask, a few small kernels a call) would otherwise time the host.
    Without it the reading is paced by whichever is slower."""
    import torch
    t0 = time.perf_counter()
    for f in fns[:3]:
        f()
    host_s = (time.perf_counter() - t0) / min(3, len(fns))
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if head_start:
        # 2e9 cycles a second bounds the H100's SM clock from above, so
        # the spin lasts at least 2 x the host's issue time (at most 0.1 s)
        torch.cuda._sleep(int(min(0.1, 2 * host_s * reps) * 2e9))
    a.record()
    for i in range(reps):
        fns[i % len(fns)]()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _host_ms(fns, reps):
    """Mean host ms to issue one call, over ``reps`` calls cycling through
    ``fns`` while the stream spins far longer than the loop takes: no
    call waits for the device, so this is the caller's host cost alone."""
    import torch
    torch.cuda.synchronize()
    torch.cuda._sleep(int(1e8))     # >= 50 ms at the H100's top SM clock
    t0 = time.perf_counter()
    for i in range(reps):
        fns[i % len(fns)]()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / reps * 1e3


def _copies(nbytes):
    """How many copies of ``nbytes`` of inputs exceed twice the L2."""
    return int(min(64, max(4, -(-100 * 2 ** 20 // max(1, nbytes)))))


def _bits(t):
    """A tensor's raw bits, for bitwise comparison of any dtype."""
    import torch
    return t.view({1: torch.uint8, 2: torch.int16,
                   4: torch.int32}[t.element_size()])


def _kv_case_inputs(B, W, pos_list, seed, store, H=12, P=None):
    """Random pools on the card (quantized through ``quantize_kv`` when
    ``store`` is a quantized dtype), a shuffled block table, and garbage
    in every slot at or past each row's bound: NaN values in bf16 pools;
    NaN scales, plus the NaN code 0x7F in fp8 pools, in quantized ones.
    ``H`` heads (12 at full width, 6 for one rank's shard at tp = 2);
    the block table ``P`` pages wide (an engine's max_len / page), or
    just wide enough for the longest row."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.ops.kv_quant import quantize_kv

    dev = torch.device("cuda")
    hd, page = 64, 16
    pos_np = np.array(pos_list, np.int64)
    P = max(P or 0, int(-(-(pos_np.max() + W) // page)))
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


def _check_ctx(what, got, want, r=None):
    """bf16 output: both round one f32 result whose sums are reordered, so
    they may differ by about one bf16 ulp (<= 2**-7 relative). ``r``: the
    tensor-core window body (K1/K2 at W > 1) also rounds each P (or P times
    the V scale) to bf16 once, which may move ctx by 2**-8 * r more, r
    from ``paged_rounding_scale``."""
    import torch
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    atol, rtol = 4e-3, 1e-2
    bad = diff > atol + rtol * want.float().abs() + (
        0.0 if r is None else 2.0 ** -8 * r)
    if not torch.isfinite(got).all() or bad.any():
        extra = "" if r is None else " + 2**-8*R"
        raise AssertionError(f"{what}: ctx off by more than {atol} + "
                             f"{rtol}*|want|{extra} at {int(bad.sum())} "
                             f"elements, or not finite (max_abs_err {err})")
    return err


def _bound(dev_info, nbytes, flops, peak="flops"):
    t_bytes = nbytes / dev_info["bw"] * 1e3
    t_ops = flops / dev_info[peak] * 1e3
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
                store=None, P=None):
    """The fused kernel at one shape: K1 over bf16 pages, or K2 over
    quantized pages of ``store`` dtype, over a block table ``P`` pages
    wide (or just wide enough). Correctness against the plain version
    (ctx, every page and scale bitwise with NaN planted at and past each
    pos, inactive rows untouched), the body the library reports (split at
    W = 1, tensor-core at W > 1) and one call = one kernel on the card;
    then times. Returns the record for this shape."""
    import torch
    import torch.nn.functional as F
    from mmlspark_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    x = _kv_case_inputs(B, W, pos_list, seed, store, P=P)
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
    # W > 1 runs the tensor-core body: its bound adds 2**-8 * R
    r = pa.paged_rounding_scale(
        q, kn, vn, pools[0], pools[1], bt, pos, scale,
        *((pools[2], pools[3]) if quant else ())) if W > 1 else None
    kern = [t.clone() for t in pools]
    kw = {"k_scale": kern[2], "v_scale": kern[3]} if quant else {}
    b0 = _bodies()
    got = pa.paged_attention_window(q, kn, vn, kern[0], kern[1], bt, pos,
                                    active=active, **kw)[0]
    torch.cuda.synchronize()
    body = _body_ran(b0, _bodies(), quant)
    if body != ("split" if W == 1 else "mma"):
        raise AssertionError(f"{what}: ran the {body} body")
    err = _check_ctx(what, got, want, r)
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
    # one call is one kernel on the card (the split body's workspace is
    # cached: no memset, no second launch); it writes the same rows again
    launches, memsets, device = _kernel_launches(lambda: pa._fused_window(
        q, kn, vn, kern[0], kern[1], bt, pos, wlo, whi, scale, *kern[2:]))
    if launches != 1 or memsets or len(device) > 1:
        raise AssertionError(f"{what}: one call ran {launches} launches "
                             f"and {memsets} memsets / copies; device "
                             f"activity {device}")
    # kernel time: raw back-to-back launches of the C entry point (no
    # wrapper work between them), over enough pool copies to defeat L2
    lib = pa._library()
    n = _copies(sum(t.numel() * t.element_size() for t in pools))
    copies = [[t.clone() for t in kern] for _ in range(n)]
    stream = torch.cuda.current_stream().cuda_stream
    shape = (B, H, W, P, page, scale, stream)
    work = (None, None)
    if W == 1:
        work = tuple(t.data_ptr() for t in pa._split_workspace(
            q.device, B, H, P, page, hd, lib.split_chunk))
    ints = (bt.data_ptr(), pos.data_ptr(), wlo.data_ptr(), whi.data_ptr(),
            got.data_ptr(), *work)
    rc = []

    def launcher(c):
        ptrs = [t.data_ptr() for t in c]
        if quant:
            return lambda: rc.append(lib.mmlspark_pa_window_fused_q(
                1, pa._STORES[store], hd, q.data_ptr(), kn.data_ptr(),
                vn.data_ptr(), *ptrs, *ints, *shape, None))
        return lambda: rc.append(lib.mmlspark_pa_window_fused(
            1, hd, q.data_ptr(), kn.data_ptr(), vn.data_ptr(), *ptrs,
            *ints, *shape, None))
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
    sdpa = [lambda c=c: F.scaled_dot_product_attention(
        q, c[0], c[1], attn_mask=mask) for c in kvs]
    library_ms = _cuda_ms(sdpa, 200)
    library_host = _cuda_ms(sdpa, 200, head_start=False)
    del kvs, sdpa
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
           "library_ms_host_paced": library_host, "body": body,
           "launches_per_call": launches,
           "shape": {"B": B, "H": H, "W": W, "hd": hd, "page": page, "P": P,
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
    sdpa = [lambda c=c: F.scaled_dot_product_attention(
        q, c[0], c[1], attn_mask=mask) for c in kvs]
    library_ms = _cuda_ms(sdpa, 200)
    library_host = _cuda_ms(sdpa, 200, head_start=False)
    del kvs, sdpa
    # bound: live keys (< lengths) with their scales, q and ctx
    row_bytes = hd + 2 if quant else 2 * hd
    live = int(sum(len_list))
    nbytes = (2 * live * H * row_bytes + 2 * B * H * W * hd * 2
              + bt.numel() * 4 + B * 4)
    flops = 4 * H * hd * W * live
    rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **_bound(dev_info, nbytes, flops), "library_ms": library_ms,
           "library_ms_host_paced": library_host,
           "shape": {"B": B, "H": H, "W": W, "hd": hd, "page": page,
                     "max_len": max(len_list), "live_keys": live,
                     "pages": str(store or torch.bfloat16).split(".")[-1]}}
    tag = what.split()[0].lower() + " " + " ".join(what.split()[1:])
    log(f"[{tag}] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def _decode_rows():
    """The decode ticks of phase 3 and 10a, 16 rows each with rows 5 and
    11 inactive: ``pos``, contexts up to 1023 crossing page and chunk
    boundaries (incl. 0, exact multiples of 16); serving's own decode
    (``serve``, up to 10c's 448 keys); a straggler (one row at 2047, the
    rest at 64 or below: continuous batching with one long context).
    Returns (pos, active, serve, straggler)."""
    import numpy as np
    rng = np.random.default_rng(0)
    pos = [0, 1, 15, 16, 17, 255, 256, 300, 511, 512, 700, 1000, 1023,
           int(rng.integers(1, 1024)), 64, 900]
    active = [True] * 16
    active[5] = active[11] = False
    serve = [int(p) for p in rng.integers(0, 449, 16)]
    straggler = [2047, 0, 64] + [int(p) for p in rng.integers(1, 65, 13)]
    return pos, active, serve, straggler


def phase_kernels(dev_info):
    import torch
    pos, active, serve, straggler = _decode_rows()
    recs = {"K1": {}, "K2": {}}
    # the decode tick (the split body): B=16, W=1; serving's decode over
    # its engine's 64-page block table; the straggler. Chunked-prefill
    # extend: one row, a 256-token window at position 384; then serving's
    # own window shapes: a 384-token prompt's first chunk (no cached key)
    # and its second, a prefix-suffix window of the smallest bucket at an
    # unaligned position (a page straddled, half of an m16 query tile
    # empty), and four rows, one inactive (writes nothing)
    shapes = {"decode": ((16, 1, pos, active, 1), {}),
              "serving decode": ((16, 1, serve, active, 12), {"P": 64}),
              "straggler": ((16, 1, straggler, active, 13), {}),
              "extend": ((1, 256, [384], [True], 2), {}),
              "chunk1": ((1, 256, [0], [True], 8), {}),
              "chunk2": ((1, 128, [256], [True], 9), {}),
              "suffix8": ((1, 8, [90], [True], 10), {}),
              "extend b4": ((4, 128, [384, 0, 90, 256],
                             [True, True, False, True], 11), {})}
    for label, (args, kw) in shapes.items():
        recs["K1"][label] = _fused_case(dev_info, label, *args, **kw)
    for store in (torch.int8, torch.float8_e4m3fn):
        name = str(store).split(".")[-1]
        for label, (args, kw) in shapes.items():
            recs["K2"][f"{name} {label}"] = _fused_case(
                dev_info, label, *args, store=store, **kw)
    # the read-only sweep: 16 rows of 4 queries over the same ragged
    # lengths (row 0 has none)
    recs["K3"] = _read_case(dev_info, "read", 16, 4, pos, 3)
    recs["K4"] = _read_case(dev_info, "read", 16, 4, pos, 4,
                            store=torch.int8)
    return recs


def _full_cfg(torch_dtype):
    from mmlspark_tpu_torch.models.zoo.transformer import TransformerConfig
    return TransformerConfig(dtype=torch_dtype, **FULL)


#: phases 4 and 10b: the f32 parity engine and its prompts
PARITY = dict(max_slots=4, max_len=384, page_size=16, prefill_chunk=128,
              steps_per_dispatch=2)
PARITY_PROMPTS = (20, 70, 300)
PARITY_NEW = 16


def _parity_prompts(vocab):
    import numpy as np
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, n) for n in PARITY_PROMPTS]


def _parity_tokens(params_np, cfg, impl, kv_dtype, mesh=None):
    """One f32 parity engine's greedy tokens for the parity prompts, and
    its decode steps: its attention calls less its prefill chunks and
    prefix suffixes."""
    import torch
    from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder
    eng = ContinuousDecoder(params_np, cfg, paged_attn=impl,
                            kv_dtype=kv_dtype, mesh=mesh, **PARITY)
    reqs = [eng.submit(p, PARITY_NEW) for p in _parity_prompts(cfg.vocab)]
    for _ in range(400):
        if all(r.done for r in reqs):
            break
        eng.step()
    eng.flush()
    out = [eng.result(r, timeout=1) for r in reqs]
    steps = (eng._kv.stats[f"attn_ticks_{impl}"] - len(eng._chunk_trace)
             - eng.stats["prefix_hits"])
    del eng
    torch.cuda.empty_cache()
    return out, steps


def phase_parity(params_np):
    """f32 full width: kernel and plain-gather engines give the same greedy
    tokens, on model-dtype pages (K1) and on int8 and fp8 pages (K2), the
    kernel engine's decode steps on the split body (one launch per layer
    each) and nothing on the tensor-core body (f32 queries). Returns the
    kernel engine's tokens per page type (10b's reference)."""
    import torch
    cfg = _full_cfg(torch.float32)
    single = {}
    for kv_dtype in (None, "int8", "fp8"):
        outs = {}
        for impl in ("kernel", "gather"):
            _zero_pa_counts()
            outs[impl], steps = _parity_tokens(params_np, cfg, impl, kv_dtype)
            if impl == "kernel":
                bodies, kernel_steps = _bodies(), steps
        name = kv_dtype or "f32"
        if outs["kernel"] != outs["gather"]:
            raise AssertionError(
                f"f32 greedy tokens differ ({name} pages): "
                f"kernel {outs['kernel']} vs gather {outs['gather']}")
        split = bodies["split"] + bodies["q_split"]
        if bodies["mma"] or bodies["q_mma"] or \
                split != kernel_steps * cfg.layers:
            raise AssertionError(f"parity {name} pages: bodies {bodies}, "
                                 f"want {kernel_steps} decode steps x "
                                 f"{cfg.layers} layers on the split body")
        single[kv_dtype] = outs["kernel"]
        log(f"[parity] f32 full width, {name} pages: kernel == gather for "
            f"{len(PARITY_PROMPTS)} requests x {PARITY_NEW} tokens (prompts "
            f"{'/'.join(map(str, PARITY_PROMPTS))}); {split} decode launches "
            f"on the split body")
    return single


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
        chunks0 = len(eng.decoder._chunk_trace)
        hits0 = eng.decoder.stats["prefix_hits"]
        _zero_pa_counts()

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
        # every request is answered: the engine launches nothing more
        launches, bodies = paged_attention_window.launches, _bodies()
        stats = dict(eng.decoder._kv.stats)
        ticks = list(eng.decoder.tick_seconds)
        prefix_hits = eng.decoder.stats["prefix_hits"] - hits0
        chunks = len(eng.decoder._chunk_trace) - chunks0
    finally:
        eng.stop()
    calls = stats["attn_ticks_kernel"] - stats0["attn_ticks_kernel"]
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
    split = _window_split("K1", launches, bodies, calls, chunks,
                          prefix_hits, cfg.layers)
    p50 = statistics.median(ticks) * 1e3 if ticks else float("nan")
    rec = {"requests": len(payloads), "tokens": n_tok, "wall_s": wall,
           "tok_per_s": n_tok / wall, "p50_tick_ms": p50,
           "ticks": len(ticks), "k1_launches": launches,
           "k1_launches_decode": split["decode"],
           "k1_launches_extend": split["extend"],
           "decode_steps": split["decode_steps"],
           "prefill_chunks": chunks, "gather_bytes": gather,
           "prefix_hits": prefix_hits, "steps_per_dispatch": 4,
           "layers": cfg.layers}
    log(f"[serving] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def _window_split(what, launches, bodies, calls, chunks, hits, layers):
    """A bf16 run's K1, K2 or K5a launches split by the body the library
    reported (``bodies``, :func:`_bodies`' record of the run): the
    extends (W > 1) on the tensor-core body, the decode steps (W = 1) on
    the split body, nothing on the FMA body. Cross-check against the
    engine: its ``calls`` attention calls are every prefill chunk and
    prefix-suffix window of its chunk trace and prefix hits (one extend
    per layer each) and its decode steps (the rest, one split launch per
    layer each)."""
    mma = bodies["mma"] + bodies["q_mma"]
    split = bodies["split"] + bodies["q_split"]
    extend, steps = (chunks + hits) * layers, calls - chunks - hits
    if not 0 < mma < launches or mma != extend or \
            split != steps * layers or mma + split != launches:
        raise AssertionError(f"{what}: {launches} launches, {mma} on the "
                             f"tensor-core body and {split} on the split "
                             f"body; want {extend} from {chunks} chunks and "
                             f"{hits} prefix hits and {steps * layers} from "
                             f"{steps} decode steps, x {layers} layers")
    return {"decode": split, "extend": mma, "decode_steps": steps}


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
    chunks0 = len(eng._chunk_trace)
    eng._quant_inserts = 0
    _zero_pa_counts()
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
    k1, k2 = paged_attention_window.launches, paged_attention_window.launches_q
    bodies = _bodies()
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
    chunks = len(eng._chunk_trace) - chunks0
    calls = stats["attn_ticks_kernel"] - stats0["attn_ticks_kernel"]
    split = _window_split(f"K2 {kv_dtype}", k2, bodies, calls, chunks, hits,
                          cfg.layers)
    rec = {"kv_dtype": kv_dtype, "requests": len(reqs), "tokens": n_tok,
           "wall_s": wall, "tok_per_s": n_tok / wall,
           "p50_tick_ms": statistics.median(ticks) * 1e3,
           "ticks": len(ticks), "k2_launches": k2,
           "k2_launches_decode": split["decode"],
           "k2_launches_extend": split["extend"],
           "decode_steps": split["decode_steps"],
           "prefill_chunks": chunks, "k1_launches": k1,
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


def make_higgs_like(n, f=28, seed=0):
    """The repo's HIGGS-shaped generator (``scripts/bench_gbdt_higgs.py``):
    53% positives, standard-normal features, a correlated shift on the
    positives."""
    import numpy as np
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.53).astype(np.float64)
    X = rng.normal(0, 1, (n, f)).astype(np.float32)
    shift = (0.3 * rng.normal(1, 0.2, f)).astype(np.float32)
    X[y == 1] += shift
    return X, y


def _auc(y, p):
    import numpy as np
    order = np.argsort(p)
    ranks = np.empty(len(p))
    ranks[order] = np.arange(1, len(p) + 1)
    pos = y == 1
    n1, n0 = pos.sum(), (~pos).sum()
    return float((ranks[pos].sum() - n1 * (n1 + 1) / 2) / (n1 * n0))


def check_hist(what, got, plain, ref, mag):
    """K6 against its plain version: counts bitwise equal to the f32 plain
    version's; g/h within 2e-6 * sum|stat| + 1e-7 of the float64 plain
    version (``ref``; ``mag`` is the same on |g|, |h|): the kernel adds in
    atomic order, the reference sums exactly. Returns (max_abs_err,
    max error over its bound)."""
    import torch
    if got.shape != plain.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: shape {tuple(got.shape)} or "
                             f"non-finite values")
    if not torch.equal(got[..., 2], plain[..., 2]):
        raise AssertionError(f"{what}: counts differ from the plain version")
    err = (got[..., :2].double() - ref[..., :2]).abs()
    bound = 2e-6 * mag[..., :2] + 1e-7
    if bool((err > bound).any()):
        raise AssertionError(f"{what}: g/h off by more than 2e-6 * "
                             f"sum|stat| + 1e-7 at {int((err > bound).sum())}"
                             f" slots (max_abs_err {err.max().item()})")
    return err.max().item(), (err / bound).max().item()


def _hist_case(dev_info, label, n, F, n_nodes, n_bins, seed,
               bin_dtype=None, stats_dtype=None, bagged=0.0, two_bin=False,
               reps=20):
    """K6 at one level shape against its plain version, then its time, the
    plain version's, one ``index_add_`` over the whole output with
    precomputed flat ids (the library yardstick) and its bound."""
    import torch
    from mmlspark_tpu_torch.ops import histogram as hm

    dev = torch.device("cuda")
    bin_dtype = bin_dtype or torch.uint8
    gen = torch.Generator(device=dev).manual_seed(seed)
    bins = torch.randint(0, n_bins, (F, n), generator=gen, device=dev,
                         dtype=torch.int32)
    if two_bin:                                  # a binary flag column
        bins[0] = torch.randint(1, 3, (n,), generator=gen, device=dev,
                                dtype=torch.int32)
    bins = bins.to(bin_dtype)
    node = torch.randint(0, n_nodes, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    g = torch.randn(n, generator=gen, device=dev)
    h = torch.rand(n, generator=gen, device=dev)
    w = torch.ones(n, device=dev)
    if bagged:
        w = (torch.rand(n, generator=gen, device=dev) >= bagged).float()
        g, h = g * w, h * w
    args = (bins, node, g, h, w)
    kw = {"stats_dtype": stats_dtype}
    got = hm.level_histogram(*args, n_nodes, n_bins, **kw)
    torch.cuda.synchronize()
    plain = hm.level_histogram_plain(*args, n_nodes, n_bins, **kw)
    gs, hs, ws = (t.to(stats_dtype).float() if stats_dtype else t
                  for t in (g, h, w))
    ref = hm.level_histogram_plain(bins, node, gs.double(), hs.double(),
                                   ws.double(), n_nodes, n_bins)
    mag = hm.level_histogram_plain(bins, node, gs.abs().double(),
                                   hs.abs().double(), ws.double(), n_nodes,
                                   n_bins)
    err, ratio = check_hist(f"K6 {label}", got, plain, ref, mag)
    del plain, ref, mag
    itemsize = 1 if bin_dtype == torch.uint8 else 2
    nbytes = hm.hist_bytes(n, F, itemsize, n_nodes, n_bins)
    copies = [[t.clone() for t in args]
              for _ in range(_copies(nbytes))]
    ms = _cuda_ms([lambda c=c: hm.level_histogram(*c, n_nodes, n_bins, **kw)
                   for c in copies], reps)
    plain_ms = _cuda_ms([lambda c=c: hm.level_histogram_plain(
        *c, n_nodes, n_bins, **kw) for c in copies], 3)
    del copies
    # library yardstick: one index_add_ of every (row, feature) pair's
    # stats into the flattened (n_nodes * F * n_bins, 3) output
    data = torch.stack([gs, hs, ws], -1)
    ids = ((node.long()[None] * F + torch.arange(F, device=dev)[:, None])
           * n_bins + hm.bins_as_int(bins).long()).reshape(-1)
    src = data.repeat(F, 1)
    out = torch.zeros(n_nodes * F * n_bins, 3, device=dev)
    library_ms = _cuda_ms([lambda: out.index_add_(0, ids, src)], 3)
    del ids, src, out
    torch.cuda.empty_cache()
    rec = {"max_abs_err": err, "err_over_bound": ratio, "ms": ms,
           "plain_ms": plain_ms,
           **_bound(dev_info, nbytes, 3 * n * F, peak="flops_f32"),
           "library_ms": library_ms,
           "shape": {"n": n, "F": F, "n_nodes": n_nodes, "n_bins": n_bins,
                     "bins": str(bin_dtype).split(".")[-1],
                     "stats": str(stats_dtype or torch.float32).split(".")[-1],
                     "bagged": bagged, "two_bin_feature": two_bin}}
    log(f"[k6 {label}] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


#: phase 8 at HIGGS's published size (scripts/bench_gbdt_higgs.py)
GBDT = dict(rows=11_000_000, features=28, iters=100, ragged=1_000_003)


def phase_hist_kernel(dev_info):
    """8a: K6 against its plain version at the level shapes of the HIGGS
    run (1 ... 16 nodes), several slot chunks (256 nodes, ragged rows),
    uint16 bins, bf16-rounded stats, bagged-out rows and a 2-bin
    feature."""
    import torch
    n, F = GBDT["rows"], GBDT["features"]
    recs = {}
    for i, nodes in enumerate((1, 2, 4, 8, 16)):
        recs[f"nodes{nodes}"] = _hist_case(dev_info, f"nodes{nodes}", n, F,
                                           nodes, 255, 10 + i)
    recs["ragged_nodes256"] = _hist_case(dev_info, "ragged_nodes256",
                                         GBDT["ragged"], F, 256, 255, 20)
    recs["uint16_bins1024"] = _hist_case(dev_info, "uint16_bins1024",
                                         GBDT["ragged"], F, 4, 1024, 21,
                                         bin_dtype=torch.int16)
    recs["bf16_stats"] = _hist_case(dev_info, "bf16_stats", n, F, 16, 255, 22,
                                    stats_dtype=torch.bfloat16)
    recs["bagged10"] = _hist_case(dev_info, "bagged10", n, F, 16, 255, 23,
                                  bagged=0.1)
    recs["two_bin_feature"] = _hist_case(dev_info, "two_bin_feature", n, F,
                                         1, 255, 24, two_bin=True)
    return recs


def phase_tree_parity(X, y, dev_info, depth=5):
    """8b: one full-size tree (num_leaves 31, depth 5) at the binary
    objective's first-iteration g/h, built through K6 and through the
    plain version on the card: the same split at every node, or a tie
    (gains within 1e-5 relative) that is recorded. Nodes below a tie are
    not compared (their rows differ)."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.models.gbdt.binning import BinMapper
    from mmlspark_tpu_torch.models.gbdt.objectives import get_objective
    from mmlspark_tpu_torch.models.gbdt.train import bins_on_device
    from mmlspark_tpu_torch.models.gbdt.trees import build_tree
    from mmlspark_tpu_torch.utils.device import resolve_device
    dev = resolve_device()
    mapper = BinMapper(max_bin=255, seed=0).fit(X)
    bins = bins_on_device(mapper, X, dev)[0]
    obj = get_objective("binary")
    w = np.ones(len(y))
    base = torch.tensor(obj.init_score(y, w), dtype=torch.float32, device=dev)
    y_d = torch.as_tensor(y, dtype=torch.float32).to(dev)
    live = torch.ones(len(y), dtype=torch.float32, device=dev)
    g, h = obj.grad_hess(torch.zeros_like(y_d) + base, y_d, live)
    kw = dict(depth=depth, n_bins=mapper.n_bins, lam=1e-10, alpha=0.0,
              min_gain=0.0, min_child_weight=1e-3, min_data_in_leaf=20.0)
    outs = {impl: [t.cpu().numpy() for t in build_tree(
        bins, g, h, live, hist_impl=impl, **kw)]
        for impl in ("kernel", "plain")}
    (fk, tk, lk, _, gk, _), (fp, tp, lp, _, gp, _) = (outs["kernel"],
                                                      outs["plain"])
    ties, tied = [], set()
    for i in range(len(fk)):
        anc, a = False, i
        while a > 0:
            a = (a - 1) // 2
            anc = anc or a in tied
        if anc or (fk[i], tk[i]) == (fp[i], tp[i]):
            continue
        gap = abs(float(gk[i]) - float(gp[i])) / max(abs(float(gp[i])), 1e-30)
        log(f"[tree parity] node {i}: kernel ({fk[i]}, {tk[i]}) gain "
            f"{gk[i]!r} vs plain ({fp[i]}, {tp[i]}) gain {gp[i]!r}")
        if gap > 1e-5:
            raise AssertionError(f"tree parity: node {i} splits differ with "
                                 f"a gain gap of {gap:.3g} relative")
        ties.append({"node": i, "kernel": [int(fk[i]), int(tk[i])],
                     "plain": [int(fp[i]), int(tp[i])],
                     "gain_kernel": float(gk[i]), "gain_plain": float(gp[i])})
        tied.add(i)
    rec = {"rows": len(y), "depth": depth, "nodes": len(fk),
           "stub_nodes": int((fk < 0).sum()),
           "identical": not ties, "ties": ties,
           "leaf_max_abs_diff": float(np.abs(lk - lp).max()) if not ties
           else None}
    log(f"[tree parity] {json.dumps(rec)} | {dev_info['smi']}")
    del bins
    torch.cuda.empty_cache()
    return rec


def phase_gbdt(X, y, dev_info, hist_recs):
    """8c: ``train()`` at ``device=None`` on the HIGGS-shaped matrix, after
    a 1-iteration warm-up: K6 must launch exactly 5 times per iteration
    and the plain version never; train AUC above 0.75; the model string
    round trip predicts bitwise the same on the card."""
    import numpy as np
    from mmlspark_tpu_torch.models.gbdt import Booster, train
    from mmlspark_tpu_torch.ops.histogram import (level_histogram,
                                                  level_histogram_plain)
    from mmlspark_tpu_torch.utils.device import resolve_device
    iters = GBDT["iters"]
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 20,
              "num_iterations": iters}
    t0 = time.perf_counter()
    train({**params, "num_iterations": 1}, X, y)
    warm = time.perf_counter() - t0
    level_histogram.launches = 0
    level_histogram_plain.calls = 0
    t0 = time.perf_counter()
    b = train(params, X, y)
    wall = time.perf_counter() - t0
    launches, plain_calls = (level_histogram.launches,
                             level_histogram_plain.calls)
    if launches != 5 * iters or plain_calls != 0:
        raise AssertionError(f"K6 launches {launches} (want {5 * iters}), "
                             f"plain calls {plain_calls} (want 0)")
    if b.num_trees != iters or b.device != resolve_device():
        raise AssertionError(f"{b.num_trees} trees on {b.device}")
    t0 = time.perf_counter()
    p = b.predict(X)
    predict_s = time.perf_counter() - t0
    if p.shape != (len(y),) or not np.isfinite(p).all():
        raise AssertionError(f"predictions {p.shape}, finite "
                             f"{np.isfinite(p).all()}")
    auc = _auc(y, p)
    if auc <= 0.75:
        raise AssertionError(f"train AUC {auc} <= 0.75")
    p2 = Booster.from_string(b.to_string()).predict(X)
    if not np.array_equal(p, p2):
        raise AssertionError("the model string round trip predicts "
                             "differently")
    ph = b.phase_seconds
    sec_iter = ph["boost"] / iters
    k6_ms = sum(hist_recs[f"nodes{k}"]["ms"] for k in (1, 2, 4, 8, 16))
    rec = {"rows": len(y), "features": X.shape[1], "iterations": iters,
           "num_leaves": 31, "bin_fit_s": ph["bin_fit"],
           "bin_transform_s": ph["bin_transform"], "upload_s": ph["upload"],
           "boost_s": ph["boost"], "sec_per_iter": sec_iter,
           "train_wall_s": wall, "warmup_wall_s": warm,
           "predict_s": predict_s, "train_auc": auc,
           "k6_launches": launches, "k6_ms_per_iter": k6_ms,
           "k6_share_of_iter": k6_ms / (sec_iter * 1e3),
           "stub_nodes": int((b.feats < 0).sum())}
    log(f"[gbdt] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


# ---- phase 9: flash attention (K7, K8a, K8b) -------------------------------

#: the repo's BERT_BASE (models/zoo/transformer.py:74): the published
#: BERT-base widths, LayerNorm, learned positions, non-causal
BERT = dict(vocab=30522, layers=12, d_model=768, heads=12, d_ff=3072,
            max_len=512)
#: 9a shapes: label -> (B, H, S, D, causal, mask): mask "padded" is
#: ``_ragged_mask`` (one fully padded row), "lengths" is 9c's
#: ``_lengths_mask``, "holes" is ``_holes_mask``, None is no mask.
#: "infer", "train" and "decoder" are the main paths' own: 9c's
#: inference, 9d's training and 9d's causal decoder.
FLASH_CASES = {"bert": (8, 12, 512, 64, False, "padded"),
               "causal": (2, 12, 2048, 64, True, None),
               "unaligned": (2, 4, 200, 32, False, "padded"),
               "d128": (2, 8, 512, 128, True, "padded"),
               "infer": (32, 12, 512, 64, False, "lengths"),
               "train": (16, 12, 512, 64, False, None),
               "decoder": (4, 12, 2048, 64, True, None),
               "holes": (2, 4, 192, 64, False, "holes"),
               "holes_d128": (3, 4, 200, 128, True, "holes")}
#: the 9a shapes timed (in bf16), beside their plain versions and SDPA
FLASH_TIMED = ("bert", "causal", "infer", "train", "decoder")


def _ragged_mask(B, S, gen, dev):
    """BERT padding masks: row b keeps a random prefix of its keys, row 1
    keeps none (a fully padded sequence)."""
    import torch
    lengths = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
    lengths[0] = S
    lengths[1] = 0
    return torch.arange(S, device=dev)[None] < lengths[:, None]


def _holes_mask(B, S, gen, dev):
    """Non-prefix masks: 70% of the keys at random, with keys 64 ... 127
    (one whole key tile) masked in every row and the last row masked
    whole."""
    import torch
    mask = torch.rand(B, S, generator=gen, device=dev) < 0.7
    mask[:, 64:128] = False
    mask[-1] = False
    return mask


def _lengths_mask(B, S, gen, dev):
    """9c's padding masks: row b keeps its first 64 ... S keys."""
    import torch
    lengths = torch.randint(64, S + 1, (B,), generator=gen, device=dev)
    return torch.arange(S, device=dev)[None] < lengths[:, None]


def _ulp_check(what, got, want, rel=None):
    """``got`` against the plain version's result ``want`` (f32, computed
    from the same inputs). f32 output: within 1e-5 * max|want| (the sums
    run in another order). bf16 output: within 2 bf16 ulps of ``want``
    plus 1e-5 * max|want| (the rounding to bf16, and near-zero entries
    whose ulp is below the f32 summation error), plus 2^-8 * ``rel``
    where given: ``rel`` is the output taken over absolute values
    (``bf16_rounding_scale``), for the bf16 K7's o, K8a's dK and dV and
    K8b's dQ, which round each P or dS element to bf16 once before a
    tensor-core product (2^-8 is bf16's unit roundoff). Returns
    max_abs_err."""
    import torch
    want = want.float()
    diff = (got.float() - want).abs()
    floor = 1e-5 * want.abs().max().item()
    if got.dtype == torch.bfloat16:
        mag = want.abs().clamp_min(2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        allowed = 2 * ulp + floor
        if rel is not None:
            allowed = allowed + 2.0 ** -8 * rel
        bad = diff > allowed
    else:
        bad = diff > floor
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()) or \
            bad.any():
        raise AssertionError(f"{what}: off by more than the stated bound at "
                             f"{int(bad.sum())} elements, or not finite "
                             f"(max_abs_err {diff.max().item()})")
    return diff.max().item()


def _flash_inputs(B, H, S, D, mask_kind, dtype, seed):
    """Random q/k/v/dO on the card, the mask (or None) and NaN planted in
    every key/value row past the mask."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(B, H, S, D, generator=gen, device=dev)
                   .to(dtype) for _ in range(4))
    make = {"padded": _ragged_mask, "lengths": _lengths_mask,
            "holes": _holes_mask}.get(mask_kind)
    mask = None if make is None else make(B, S, gen, dev)
    if mask is not None:
        dead = ~mask[:, None, :, None].expand(B, H, S, D)
        k[dead] = float("nan")
        v[dead] = float("nan")
    return q, k, v, do, mask


def _flash_case(dev_info, label, dtype, seed, timed):
    """K7 (with and without stats), K8a and K8b against their plain
    versions at one 9a shape; then, when ``timed``, their times beside
    the plain versions', one SDPA call (forward, and its autograd
    backward) and the bounds."""
    import torch
    import torch.nn.functional as F
    from mmlspark_tpu_torch.ops import flash_attention as fa

    B, H, S, D, causal, mask_kind = FLASH_CASES[label]
    q, k, v, do, mask = _flash_inputs(B, H, S, D, mask_kind, dtype, seed)
    scale = D ** -0.5
    name = f"{label} {str(dtype).split('.')[-1]}"
    o0 = fa.flash_attention(q, k, v, kv_mask=mask, causal=causal)
    o, l, m = fa._fwd_kernel(q, k, v, mask, causal, scale, True)
    dq, dk, dv = fa._bwd_kernel(q, k, v, mask, o, l, m, do, causal, scale)
    torch.cuda.synchronize()
    # the plain versions in f32 on the same inputs (the kernel's o, l, m
    # feed both backwards, as the autograd function feeds them)
    f32 = [t.float() for t in (q, k, v)]
    wo, wl, wm = fa.flash_attention_plain(*f32, mask, causal=causal)
    wq, wk, wv = fa.flash_attention_bwd_plain(*f32, mask, o.float(), l, m,
                                              do.float(), causal=causal)
    r_o = r_dq = r_dk = r_dv = None
    if dtype == torch.bfloat16:
        r_o, r_dq, r_dk, r_dv = fa.bf16_rounding_scale(
            *f32, mask, o.float(), l, m, do.float(), causal=causal)
    err = {"K7": _ulp_check(f"K7 {name}", o0, wo, r_o),
           "K7 stats": _ulp_check(f"K7 stats {name}", o, wo, r_o),
           "K8a": max(_ulp_check(f"K8a dK {name}", dk, wk, r_dk),
                      _ulp_check(f"K8a dV {name}", dv, wv, r_dv)),
           "K8b": _ulp_check(f"K8b dQ {name}", dq, wq, r_dq)}
    if not torch.equal(o0, o):
        raise AssertionError(f"K7 {name}: with and without stats differ")
    live = wl > 0
    if not torch.equal(live, l > 0) or \
            (l[live] - wl[live]).abs().max().item() > 1e-5 * \
            wl.max().item() or \
            (m[live] - wm[live]).abs().max().item() > 1e-5 * \
            wm[live].abs().max().item():
        raise AssertionError(f"K7 stats {name}: l/m off by more than "
                             f"1e-5 of their largest value")
    dead = None if mask is None else ~mask.any(-1)
    if dead is not None and bool(dead.any()):
        outs = (o, l, dq, dk, dv)
        if not all(t[dead].abs().max().item() == 0.0 for t in outs) or \
                not bool((m[dead] == -1e30).all()):
            raise AssertionError(f"{name}: the fully masked row is not "
                                 f"exactly 0 (l = 0, m = -1e30, grads 0)")
    rec = {k2: {"max_abs_err": e} for k2, e in err.items()}
    log(f"[flash {name}] max_abs_err {json.dumps(err)}")
    if not timed:
        return rec
    lib = fa._library()
    code = fa._DTYPES[dtype]
    stream = torch.cuda.current_stream().cuda_stream
    it = q.element_size()
    slab = B * H * S * D * it
    mptr = None if mask is None else mask.data_ptr()
    delta = fa._delta(do, o)
    n_in = _copies(4 * slab)
    copies = [[t.clone() for t in (q, k, v, do)] for _ in range(n_in)]
    rc = []

    def fwd(c, stats):
        outs = (o.data_ptr(), l.data_ptr() if stats else None,
                m.data_ptr() if stats else None)
        return lambda: rc.append(lib.mmlspark_fa_fwd(
            code, D, c[0].data_ptr(), c[1].data_ptr(), c[2].data_ptr(),
            mptr, *outs, B * H, H, S, scale, int(causal), stream))

    def bwd(c, which):
        common = (c[0].data_ptr(), c[1].data_ptr(), c[2].data_ptr(), mptr,
                  c[3].data_ptr(), m.data_ptr(), l.data_ptr(),
                  delta.data_ptr())
        if which == "dkv":
            return lambda: rc.append(lib.mmlspark_fa_bwd_dkv(
                code, D, *common, dk.data_ptr(), dv.data_ptr(), B * H, H, S,
                scale, int(causal), stream))
        return lambda: rc.append(lib.mmlspark_fa_bwd_dq(
            code, D, *common, dq.data_ptr(), B * H, H, S, scale,
            int(causal), stream))

    ms = {"K7": _cuda_ms([fwd(c, False) for c in copies], 50),
          "K7 stats": _cuda_ms([fwd(c, True) for c in copies], 50),
          "K8a": _cuda_ms([bwd(c, "dkv") for c in copies], 30),
          "K8b": _cuda_ms([bwd(c, "dq") for c in copies], 30)}
    if any(rc):
        raise AssertionError(f"flash {name}: launch returned {set(rc)}")
    plain_fwd = _cuda_ms([lambda c=c: fa.flash_attention_plain(
        c[0], c[1], c[2], mask, causal=causal) for c in copies], 5)
    plain_bwd = _cuda_ms([lambda c=c: fa.flash_attention_bwd_plain(
        c[0], c[1], c[2], mask, o, l, m, c[3], causal=causal)
        for c in copies], 5)
    # library yardstick: SDPA with the same boolean mask (the fully padded
    # row attends everything instead: SDPA gives NaN there), and the
    # autograd backward of that call; the port never calls either
    sdpa_mask = None
    if mask is not None:
        lm = mask.clone()
        lm[~lm.any(-1)] = True
        sdpa_mask = lm[:, None, None, :]
    clean = [torch.nan_to_num(t) for t in (q, k, v)]
    lib_fwd = _cuda_ms([lambda: F.scaled_dot_product_attention(
        *clean, attn_mask=sdpa_mask, is_causal=causal)], 50)
    leaves = [t.clone().requires_grad_(True) for t in clean]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=sdpa_mask,
                                         is_causal=causal)
    lib_bwd = _cuda_ms([lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True)], 20)
    del copies, leaves, out
    torch.cuda.empty_cache()
    # what this input needs: the flops of the valid (query, key) pairs;
    # K and V rows only where a key is valid (a masked row is never read),
    # q and dO only for batch rows with a valid key, every output in full
    pairs = H * fa.attention_pairs(mask, B, S, causal)
    peak = "flops" if dtype == torch.bfloat16 else "flops_f32"
    if mask is None:
        kv_frac = live_frac = 1.0
        mbytes = 0
    else:
        kv_frac = mask.float().mean().item()
        live_frac = mask.any(-1).float().mean().item()
        mbytes = B * S
    kv, qin = 2 * slab * kv_frac, slab * live_frac
    stats = 3 * B * H * S * 4                     # m, l, delta (f32)
    bounds = {"K7": _bound(dev_info, qin + kv + slab + mbytes,
                           4 * D * pairs, peak),
              "K7 stats": _bound(dev_info, qin + kv + slab + mbytes
                                 + 2 * B * H * S * 4, 4 * D * pairs, peak),
              "K8a": _bound(dev_info, 2 * qin + kv + 2 * slab + stats
                            + mbytes, 8 * D * pairs, peak),
              "K8b": _bound(dev_info, 2 * qin + kv + slab + stats + mbytes,
                            6 * D * pairs, peak)}
    shape = {"B": B, "H": H, "S": S, "D": D, "causal": causal,
             "mask": {"padded": "ragged, one fully padded row",
                      "lengths": "ragged, 64 ... S keys"}.get(mask_kind),
             "dtype": str(dtype).split(".")[-1], "pairs": pairs,
             "valid_key_share": kv_frac}
    for key in rec:
        fwd_side = key.startswith("K7")
        rec[key].update({"ms": ms[key],
                         "plain_ms": plain_fwd if fwd_side else plain_bwd,
                         **bounds[key],
                         "library_ms": lib_fwd if fwd_side else lib_bwd,
                         "shape": shape})
    log(f"[flash {name}] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def phase_flash_kernels(dev_info):
    """9a: every shape in bf16 and f32; times at the ``FLASH_TIMED`` shapes
    in bf16."""
    import torch
    recs = {}
    for i, label in enumerate(FLASH_CASES):
        for j, dtype in enumerate((torch.bfloat16, torch.float32)):
            timed = dtype == torch.bfloat16 and label in FLASH_TIMED
            recs[f"{label} {str(dtype).split('.')[-1]}"] = _flash_case(
                dev_info, label, dtype, 90 + 2 * i + j, timed)
    return recs


def _bert_cfg(torch_dtype, **kw):
    from mmlspark_tpu_torch.models.zoo.transformer import TransformerConfig
    return TransformerConfig(dtype=torch_dtype, **{**BERT, **kw})


def phase_flash_parity(bert_np, dev_info):
    """9b: BERT-base in f32, B = 2, S = 512 with ragged masks (one fully
    padded row): the flash forward through the kernels against the same
    model on the host, where the port runs the plain versions; the dense
    path against flash on the rows that are not fully padded; the
    gradients of ``loss_fn`` through the kernels against those on the
    host."""
    import torch
    from mmlspark_tpu_torch.models.zoo import transformer as tf
    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd_plain, flash_attention_plain)
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    cfg = _bert_cfg(torch.float32, use_flash=True)
    gen = torch.Generator(device=dev).manual_seed(5)
    B, S = 2, 512
    ids = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    labels = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    mask = _ragged_mask(B, S, gen, dev)
    mask[0, 400:] = False
    host = {"ids": ids.to(cpu), "labels": labels.to(cpu),
            "mask": mask.to(cpu)}
    flash_attention.launches = flash_attention.launches_dkv = 0
    flash_attention.launches_dq = 0
    flash_attention_plain.calls = flash_attention_bwd_plain.calls = 0
    with torch.no_grad():
        params = tf.params_from_numpy(bert_np, cfg, dev)
        hk = tf.transformer_apply(params, ids, cfg, mask=mask)
        hd = tf.transformer_apply(params, ids, cfg._replace(use_flash=False),
                                  mask=mask)
        del params
        hp = tf.transformer_apply(tf.params_from_numpy(bert_np, cfg, cpu),
                                  host["ids"], cfg, mask=host["mask"])
    if flash_attention.launches != cfg.layers or \
            flash_attention_plain.calls != cfg.layers:
        raise AssertionError(f"9b: {flash_attention.launches} K7 launches, "
                             f"{flash_attention_plain.calls} plain calls, "
                             f"want {cfg.layers} each")
    fwd_err = (hk.cpu() - hp).abs().max().item()
    dense_err = (hk[0] - hd[0]).abs().max().item()
    # f32 hidden states after the final LayerNorm are O(1): the card and
    # the host differ in the attention's and every matmul's summation
    # order, carried through 12 layers; dense differs also by exp
    # underflow vs the mask
    if not torch.isfinite(hk).all() or fwd_err > 1e-4 or dense_err > 1e-4:
        raise AssertionError(f"9b: hidden kernel-vs-plain {fwd_err}, "
                             f"flash-vs-dense {dense_err} (bound 1e-4)")
    grads, losses = {}, {}
    for run, d in (("kernel", dev), ("plain", cpu)):
        master = tf.params_from_numpy(bert_np, cfg, d, master=True)
        leaves = tf.tree_leaves(master)
        ids_r, labels_r = (ids, labels) if d == dev else \
            (host["ids"], host["labels"])
        loss = tf.loss_fn(master, ids_r, labels_r, cfg)
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads[run] = [None if x is None else x.detach().cpu() for x in g]
        losses[run] = loss.item()
        del master, leaves, loss, g
    if (flash_attention.launches_dkv, flash_attention.launches_dq,
            flash_attention_bwd_plain.calls) != (cfg.layers,) * 3:
        raise AssertionError(f"9b: K8a/K8b launches "
                             f"{flash_attention.launches_dkv}/"
                             f"{flash_attention.launches_dq}, plain "
                             f"backward calls "
                             f"{flash_attention_bwd_plain.calls}, want "
                             f"{cfg.layers} each")
    grad_err = 0.0
    for a, b in zip(grads["kernel"], grads["plain"]):
        if a is None:
            continue
        rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        grad_err = max(grad_err, rel)
    # each leaf's gradient within 1e-3 of its largest entry: f32 backward
    # through 12 layers, card and host summation orders
    loss_err = abs(losses["kernel"] - losses["plain"])
    if grad_err > 1e-3 or loss_err > 1e-4 or \
            not all(torch.isfinite(x).all() for x in grads["kernel"]
                    if x is not None):
        raise AssertionError(f"9b: gradient rel err {grad_err}, loss err "
                             f"{loss_err}")
    rec = {"B": B, "S": S, "dtype": "float32",
           "hidden_kernel_vs_plain": fwd_err,
           "hidden_flash_vs_dense_unpadded_rows": dense_err,
           "loss_kernel": losses["kernel"], "loss_plain": losses["plain"],
           "grad_max_rel_err": grad_err}
    log(f"[flash parity] {json.dumps(rec)} | {dev_info['smi']}")
    del grads
    torch.cuda.empty_cache()
    return rec


def phase_flash_inference(bert_np, dev_info, k7_ms, reps=5):
    """9c: BERT-base encoder inference in bf16, B = 32, S = 512, ragged
    padding masks: 12 K7 launches per forward and no plain call; K7's
    share of a forward from ``k7_ms``, its time at this shape in 9a."""
    import torch
    from mmlspark_tpu_torch.models.zoo import transformer as tf
    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)
    dev = torch.device("cuda")
    cfg = _bert_cfg(torch.bfloat16, use_flash=True)
    params = tf.params_from_numpy(bert_np, cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    B, S = 32, 512
    ids = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    mask = _lengths_mask(B, S, gen, dev)
    with torch.no_grad():
        tf.transformer_apply(params, ids, cfg, mask=mask)    # warm-up
        torch.cuda.synchronize()
        flash_attention.launches = 0
        flash_attention_plain.calls = 0
        t0 = time.perf_counter()
        for _ in range(reps):
            h = tf.transformer_apply(params, ids, cfg, mask=mask)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = flash_attention.launches
        plain = flash_attention_plain.calls
        # untimed: the same ids and masks through dense attention (every
        # row keeps >= 64 keys, so both define the same function there)
        hd = tf.transformer_apply(params, ids, cfg._replace(use_flash=False),
                                  mask=mask)
    if launches != cfg.layers * reps or plain != 0:
        raise AssertionError(f"9c: {launches} K7 launches (want "
                             f"{cfg.layers * reps}), {plain} plain calls")
    if h.shape != (B, S, cfg.d_model) or h.dtype != torch.bfloat16 or \
            not torch.isfinite(h).all():
        raise AssertionError(f"9c: hidden {tuple(h.shape)} {h.dtype}, "
                             f"finite {bool(torch.isfinite(h).all())}")
    # bf16 flash against bf16 dense: both round P once (dense after the
    # normalisation, flash before it) and every layer's activations to
    # bf16, and 12 layers carry the differences; 2^-3 of the largest
    # hidden value is 16 to 32 bf16 ulps at its magnitude. A wrong
    # fragment or a skipped live tile moves the hidden states by
    # O(max|h|).
    dense_err = (h.float() - hd.float()).abs().max().item()
    dense_bound = 2.0 ** -3 * hd.float().abs().max().item()
    if not dense_err <= dense_bound:
        raise AssertionError(f"9c: bf16 flash vs dense hidden max |diff| "
                             f"{dense_err} above {dense_bound}")
    ms_fwd = wall / reps * 1e3
    rec = {"B": B, "S": S, "forwards": reps, "wall_s": wall,
           "seq_per_s": B * reps / wall, "ms_per_forward": ms_fwd,
           "real_tokens": int(mask.sum()), "k7_launches": launches,
           "k7_share_of_forward": cfg.layers * k7_ms / ms_fwd,
           "hidden_flash_vs_dense_max_abs": dense_err,
           "hidden_flash_vs_dense_bound": dense_bound}
    log(f"[flash inference] {json.dumps(rec)} | {dev_info['smi']}")
    del params, h, hd
    torch.cuda.empty_cache()
    return rec


def _train_run(params_np, cfg, B, S, steps, lr, seed):
    """``train_step`` ``steps`` times on one fixed batch after one warm-up
    step; returns (losses, per-step seconds, launch counts, plain calls,
    peak bytes). The counts cover the timed steps, or the warm-up step
    itself when ``steps`` is 0."""
    import torch
    from mmlspark_tpu_torch.models.zoo import transformer as tf
    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd_plain, flash_attention_plain)
    dev = torch.device("cuda")
    params = tf.params_from_numpy(params_np, cfg, dev, master=True)
    opt = [torch.zeros_like(t) for t in tf.tree_leaves(params)]
    gen = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    labels = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def zero_counts():
        flash_attention.launches = flash_attention.launches_dkv = 0
        flash_attention.launches_dq = 0
        flash_attention_plain.calls = flash_attention_bwd_plain.calls = 0

    zero_counts()
    losses = [float(tf.train_step(params, opt, ids, labels, cfg, lr=lr)[2])]
    if steps:
        zero_counts()
    secs = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(tf.train_step(params, opt, ids, labels, cfg,
                                          lr=lr)[2]))
        secs.append(time.perf_counter() - t0)
    counts = (flash_attention.launches, flash_attention.launches_dkv,
              flash_attention.launches_dq)
    plain = flash_attention_plain.calls + flash_attention_bwd_plain.calls
    peak = torch.cuda.max_memory_allocated()
    del params, opt
    torch.cuda.empty_cache()
    return losses, secs, counts, plain, peak


def phase_flash_training(bert_np, dev_info, kernel_ms, steps=10):
    """9d: BERT-base bf16 training, B = 16, S = 512, ``steps`` steps on one
    fixed batch after a warm-up step (12 launches each of K7, K8a and K8b
    per step, no plain call, the loss finite and lower at the end), and
    the kernels' share of a step from ``kernel_ms``, their summed time at
    this shape in 9a; then one step of the FULL causal decoder at B = 4,
    S = 2048 with flash (12 launches of each kernel) and with dense
    attention (none): flash's peak device memory below dense's."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.models.zoo.transformer import init_transformer
    cfg = _bert_cfg(torch.bfloat16, use_flash=True)
    B, S = 16, 512
    # lr 1e-3: at the reference's 1e-4, ten steps of random-label training
    # move the loss by ~5e-4, too close to bf16 rounding to assert on
    losses, secs, counts, plain, peak = _train_run(bert_np, cfg, B, S, steps,
                                                   1e-3, 7)
    want = tuple([cfg.layers * steps] * 3)
    if counts != want or plain != 0:
        raise AssertionError(f"9d: K7/K8a/K8b launches {counts} (want "
                             f"{want}), plain calls {plain}")
    if not np.all(np.isfinite(losses)) or not losses[-1] < losses[1]:
        raise AssertionError(f"9d: losses {losses}")
    step_s = statistics.median(secs)
    bert = {"B": B, "S": S, "steps": steps, "lr": 1e-3,
            "loss_first": losses[1], "loss_last": losses[-1],
            "step_s_median": step_s, "step_s": secs,
            "tokens_per_s": B * S / step_s, "peak_bytes": peak,
            "k7_launches": counts[0], "k8a_launches": counts[1],
            "k8b_launches": counts[2],
            "flash_share_of_step": cfg.layers * kernel_ms / (step_s * 1e3)}
    log(f"[flash training] {json.dumps(bert)} | {dev_info['smi']}")
    dec_np = init_transformer(_full_cfg(torch.float32), seed=0)
    mem, dcounts = {}, {}
    for use_flash in (True, False):
        dcfg = _full_cfg(torch.bfloat16)._replace(use_flash=use_flash)
        dl, ds, dc, dp, dpeak = _train_run(dec_np, dcfg, 4, 2048, 0, 1e-4, 8)
        want = (dcfg.layers if use_flash else 0,) * 3
        if not np.isfinite(dl[0]) or dc != want or dp != 0:
            raise AssertionError(f"9d decoder (use_flash={use_flash}): loss "
                                 f"{dl}, K7/K8a/K8b launches {dc} (want "
                                 f"{want}), plain calls {dp}")
        mem["flash" if use_flash else "dense"] = dpeak
        dcounts["flash" if use_flash else "dense"] = dc
    if not mem["flash"] < mem["dense"]:
        raise AssertionError(f"9d decoder: flash peak {mem['flash']} not "
                             f"below dense {mem['dense']}")
    dec = {"B": 4, "S": 2048, "launches_flash_step": dcounts["flash"],
           "peak_bytes_flash": mem["flash"],
           "peak_bytes_dense": mem["dense"],
           "flash_over_dense": mem["flash"] / mem["dense"]}
    log(f"[flash decoder memory] {json.dumps(dec)} | {dev_info['smi']}")
    return bert, dec


def _kernel_launches(fn):
    """What one call of ``fn`` asks of the card, by ``torch.profiler``:
    (kernel launches the runtime saw, as ``serving/tick_profile.py``
    counts them; memset and copy calls; the device activity recorded).
    The runtime calls are the count: a second profiler session in one
    process may record no device activity at all."""
    import warnings
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        # "Profiler clears events at the end of each cycle": one cycle here
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    ev = prof.key_averages()
    launches = sum(e.count for e in ev if "LaunchKernel" in e.key)
    copies = sum(e.count for e in ev
                 if "Memset" in e.key or "Memcpy" in e.key)
    device = [e.key for e in ev if str(e.device_type).endswith("CUDA")
              for _ in range(e.count)]
    return launches, copies, device


def _bodies(kind=""):
    """K1/K2 (``kind=""``) or K5a/K5b (``kind="window"``) launches by the
    body the library reported: tensor-core (``mma``, K1 or K5a / ``q_mma``,
    K2 or K5b) and split decode (``split``, ``q_split``)."""
    from mmlspark_tpu_torch.ops.paged_attention import paged_attention_window
    pre = "launches_" + (kind + "_" if kind else "")
    return {k: getattr(paged_attention_window, pre + k)
            for k in ("mma", "q_mma", "split", "q_split")}


def _body_ran(b0, b1, quant):
    """The body one call ran, from :func:`_bodies` before (``b0``) and
    after (``b1``): "split", "mma", or "fma" with the counters that
    moved."""
    ran = {k for k in b1 if b1[k] > b0[k]}
    q = "q_" if quant else ""
    return ("split" if ran == {q + "split"} else
            "mma" if ran == {q + "mma"} else f"fma {ran}")


def _window_case(dev_info, label, B, W, pos_list, active_list, seed,
                 store=None, H=12, P=None):
    """The window read at one shape: K5a over bf16 pages, or K5b over
    quantized pages of ``store`` dtype, ``H`` heads, bf16 queries.
    Correctness against the plain version (ctx within about one bf16 ulp,
    plus 2**-8 * R for the tensor-core body at W > 1; the NaN planted at
    and past each row's pos kept out, every pool bit untouched), the body
    the library reports (split at W = 1, tensor-core at W > 1) and one
    call = one kernel on the card; then its time, the plain version's,
    one SDPA over the gathered dequantized K/V and the window (the
    library yardstick), its bound, the wrapper's host-paced time, and on
    their own the rows the mesh path writes after it (``_mount_writes``)."""
    import torch
    import torch.nn.functional as F
    from mmlspark_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    x = _kv_case_inputs(B, W, pos_list, seed, store, H=H, P=P)
    hd, page, P = x["hd"], x["page"], x["P"]
    q, kn, vn, bt, pools = x["q"], x["kn"], x["vn"], x["bt"], x["pools"]
    pos_np = x["pos_np"]
    quant = store is not None
    what = (f"K5b {str(store).split('.')[-1]} {label}" if quant
            else f"K5a {label}")
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    active = torch.tensor(active_list, device=dev)
    scale = 1.0 / hd ** 0.5
    want = pa.paged_attention_window_read_plain(q, kn, vn, pools[0],
                                                pools[1], bt, pos, scale,
                                                *pools[2:])
    # W > 1 runs the tensor-core body: its bound adds 2**-8 * R
    r = pa.paged_rounding_scale(q, kn, vn, pools[0], pools[1], bt, pos,
                                scale, *pools[2:]) if W > 1 else None
    kern = [t.clone() for t in pools]
    b0 = _bodies("window")
    got = pa._window_read(q, kn, vn, kern[0], kern[1], bt, pos, scale,
                          *kern[2:])
    torch.cuda.synchronize()
    body = _body_ran(b0, _bodies("window"), quant)
    if body != ("split" if W == 1 else "mma"):
        raise AssertionError(f"{what}: ran the {body} body")
    err = _check_ctx(what, got, want, r)
    if not all(torch.equal(_bits(a), _bits(b)) for a, b in zip(kern, pools)):
        raise AssertionError(f"{what}: the window read wrote its pools")
    # one call is one kernel on the card (the split body's workspace is
    # cached: no memset, no second launch)
    launches, memsets, device = _kernel_launches(lambda: pa._window_read(
        q, kn, vn, kern[0], kern[1], bt, pos, scale, *kern[2:]))
    if launches != 1 or memsets or len(device) > 1:
        raise AssertionError(f"{what}: one call ran {launches} launches "
                             f"and {memsets} memsets / copies; device "
                             f"activity {device}")
    lib = pa._library()
    n = _copies(sum(t.numel() * t.element_size() for t in pools))
    copies = [[t.clone() for t in kern] for _ in range(n)]
    stream = torch.cuda.current_stream().cuda_stream
    acts = (q.data_ptr(), kn.data_ptr(), vn.data_ptr())
    tail = (B, H, W, P, page, scale, stream)
    work = (None, None)
    if W == 1:
        work = tuple(t.data_ptr() for t in pa._split_workspace(
            q.device, B, H, P, page, hd, lib.split_chunk))
    rc = []

    def launcher(c):
        ptrs = [t.data_ptr() for t in c]
        ints = (bt.data_ptr(), pos.data_ptr(), got.data_ptr(), *work)
        if quant:
            return lambda: rc.append(lib.mmlspark_pa_window_read_q(
                1, pa._STORES[store], hd, *acts, *ptrs, *ints, *tail, None))
        return lambda: rc.append(lib.mmlspark_pa_window_read(
            1, hd, *acts, *ptrs, *ints, *tail, None))

    wrapped = [lambda c=c: pa._window_read(q, kn, vn, c[0], c[1], bt, pos,
                                           scale, *c[2:]) for c in copies]
    raw = [launcher(c) for c in copies]
    # warm-up, untimed (and past the profiler)
    _cuda_ms(raw + wrapped, len(raw) + len(wrapped), head_start=False)
    # the kernel back to back (device time), the wrapper paced by the
    # host, and the wrapper's host cost alone
    ms = _cuda_ms(raw, 200)
    host_paced = _cuda_ms(wrapped, 200, head_start=False)
    host_ms = _host_ms(wrapped, 200)
    if any(rc):
        raise AssertionError(f"{what}: launch returned {set(rc)}")
    plain_ms = _cuda_ms([lambda c=c: pa.paged_attention_window_read_plain(
        q, kn, vn, c[0], c[1], bt, pos, scale, *c[2:]) for c in copies], 20)

    write_ms = _cuda_ms([lambda c=c: pa._mount_writes(kn, vn, c, bt, pos,
                                                      active)
                         for c in copies], 200)
    del copies
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
    sdpa = [lambda c=c: F.scaled_dot_product_attention(
        q, c[0], c[1], attn_mask=mask) for c in kvs]
    library_ms = _cuda_ms(sdpa, 200)
    library_host = _cuda_ms(sdpa, 200, head_start=False)
    del kvs, sdpa
    # bound: K1's less the window-row writes — live cached keys (< pos)
    # with their scales, q/k_new/v_new, ctx; flops QK and PV over live
    # keys and the window. The writes' own bound: k_new/v_new read, the
    # active rows' codes (and scales) written.
    row_bytes = hd + 2 if quant else 2 * hd
    live = int(pos_np.sum())
    n_active = int(sum(active_list))
    nbytes = (2 * live * H * row_bytes + 3 * B * H * W * hd * 2
              + B * H * W * hd * 2 + bt.numel() * 4 + B * 4)
    flops = sum(4 * H * hd * W * (int(p) + W) for p in pos_np)
    wbytes = (2 * B * H * W * hd * 2 + 2 * n_active * W * H * row_bytes
              + bt.numel() * 4 + B * 4)
    rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **_bound(dev_info, nbytes, flops), "library_ms": library_ms,
           "library_ms_host_paced": library_host,
           "window_read_ms_host_paced": host_paced,
           "window_read_host_ms": host_ms,
           "body": body, "launches_per_call": launches,
           "write_ms": write_ms,
           "write_bound_ms": _bound(dev_info, wbytes, 0)["bound_ms"],
           "shape": {"B": B, "H": H, "W": W, "hd": hd, "page": page, "P": P,
                     "max_pos": int(pos_np.max()), "live_keys": live,
                     "pages": str(store or torch.bfloat16).split(".")[-1]}}
    tag = what.split()[0].lower() + " " + " ".join(what.split()[1:])
    log(f"[{tag}] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def window_cases():
    """10a's cases, ``(kernel, label, args, keywords)`` for
    :func:`_window_case` (and ``time_window_read.py``): K5a on bf16 pages
    and K5b on int8 and fp8 pages at phase 3's decode and extend shapes
    (12 heads), the decode shape on 6 heads (one rank's shard at tp = 2),
    serving's own decode (16 rows up to 10c's 448 keys over its 64-page
    block table) and a straggler (one row at 2047, the rest at 64 or
    below: continuous batching with one long context)."""
    import torch
    pos, active, serve, straggler = _decode_rows()
    shapes = {"decode": ((16, 1, pos, active), {}),
              "extend": ((1, 256, [384], [True]), {}),
              "decode h6": ((16, 1, pos, active), {"H": 6}),
              "serving decode": ((16, 1, serve, active), {"P": 64}),
              "straggler": ((16, 1, straggler, active), {})}
    cases, seed = [], 5
    for store in (None, torch.int8, torch.float8_e4m3fn):
        name = "" if store is None else str(store).split(".")[-1] + " "
        for label, (args, kw) in shapes.items():
            cases.append(("K5a" if store is None else "K5b", name + label,
                          (label, *args, seed), {"store": store, **kw}))
            seed += 1
    return cases


def phase_window_kernels(dev_info):
    """10a: every case of :func:`window_cases`."""
    recs = {"K5a": {}, "K5b": {}}
    for kernel, name, args, kw in window_cases():
        recs[kernel][name] = _window_case(dev_info, *args, **kw)
    return recs


def _zero_pa_counts():
    from mmlspark_tpu_torch.ops.paged_attention import paged_attention_window
    for name in ("", "_q", "_mma", "_q_mma", "_split", "_q_split",
                 "_window", "_window_q", "_window_mma", "_window_q_mma",
                 "_window_split", "_window_q_split"):
        setattr(paged_attention_window, "launches" + name, 0)


def _pa_counts():
    """(K1, K2, K5a, K5b) launches since the last zeroing."""
    from mmlspark_tpu_torch.ops.paged_attention import paged_attention_window
    p = paged_attention_window
    return (p.launches, p.launches_q, p.launches_window,
            p.launches_window_q)


def phase_mesh_parity(params_np, single, mesh):
    """10b: f32 full width on a tp = 1 mesh (a world of one rank over
    NCCL): the meshed kernel engine's greedy tokens equal the single-device
    kernel engine's (phase 4's) and the meshed gather engine's, on f32,
    int8 and fp8 pages; K5a (f32) or K5b (int8, fp8) launched, K1 and K2
    never, the decode steps through the split body (f32 queries: none on
    the tensor-core body). Returns the launches per page type."""
    import torch
    cfg = _full_cfg(torch.float32)
    launches = {}
    for kv_dtype in (None, "int8", "fp8"):
        outs, counts = {}, {}
        for impl in ("kernel", "gather"):
            _zero_pa_counts()
            outs[impl] = _parity_tokens(params_np, cfg, impl, kv_dtype,
                                        mesh)[0]
            counts[impl] = _pa_counts()
            if impl == "kernel":
                bodies = _bodies("window")
        name = kv_dtype or "f32"
        if not outs["kernel"] == single[kv_dtype] == outs["gather"]:
            raise AssertionError(
                f"10b {name} pages: meshed kernel {outs['kernel']}, single "
                f"device {single[kv_dtype]}, meshed gather {outs['gather']}")
        k1, k2, k5a, k5b = counts["kernel"]
        want = (k5a > 0 and k5b == 0) if kv_dtype is None else \
            (k5b > 0 and k5a == 0)
        split = bodies["split"] + bodies["q_split"]
        mma = bodies["mma"] + bodies["q_mma"]
        if k1 or k2 or not want or any(counts["gather"]) or mma or \
                not 0 < split < k5a + k5b:
            raise AssertionError(f"10b {name} pages: (K1, K2, K5a, K5b) "
                                 f"launches {counts}, bodies {bodies}")
        launches[name] = {"k5a": k5a, "k5b": k5b, "split": split}
        log(f"[mesh parity] f32 full width, tp1 mesh, {name} pages: meshed "
            f"kernel == single-device kernel == meshed gather for "
            f"{len(PARITY_PROMPTS)} requests x {PARITY_NEW} tokens; K5a "
            f"{k5a}, K5b {k5b} ({split} on the split body), K1/K2 0")
    return launches


def _serve_mix(eng, rng, vocab, sizes, max_new):
    """Phase 6's request mix through ``submit``/``step``: two requests
    sharing a 96-token prefix (the owner first), then prompts of
    ``sizes``; returns (requests, wall seconds)."""
    import numpy as np
    import torch
    shared = rng.integers(0, vocab, 96)
    t0 = time.perf_counter()
    reqs = [eng.submit(np.concatenate([shared,
                                       rng.integers(0, vocab, tail)]),
                       max_new, prefix_key="system", prefix_len=len(shared))
            for tail in (8, 24)]
    reqs += [eng.submit(rng.integers(0, vocab, n), max_new) for n in sizes]
    while not all(r.done for r in reqs):
        eng.step()
    torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0


def phase_mesh_serving(params_np, dev_info, mesh, q8, write_ms):
    """10c: bf16 full width, phase 6's mix (64 new tokens each) through a
    single-device engine and then a tp = 1 meshed engine, bf16 pages.
    The meshed run must launch K5a once per layer per attention call
    (decode step or extend) and no K1/K2 (the single-device run K1 and
    nothing else), gather nothing and hit the prefix; each run's launches
    split by body as phases 5 and 6 split K1's and K2's: the tensor-core
    ones exactly the engine's prefill chunks and prefix suffixes times
    the layers, the split ones the rest (the decode steps); tokens/s and
    p50 tick beside the single-device bf16 run and phase 6's int8
    numbers. Then one all-reduce of a decode step's (16, 1, d_model)
    activations on the mesh's group is timed, and with 10a's time of the
    rows written outside the kernel (``write_ms``) gives the mesh's added
    time per tick: layers x steps x (writes + two all-reduces)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from mmlspark_tpu_torch.parallel.mesh import axis_group
    from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder
    from mmlspark_tpu_torch.utils.device import resolve_device
    cfg = _full_cfg(torch.bfloat16)
    sizes, max_new = [32, 128, 384] * 3, 64
    out = {}
    for key, m in (("single", None), ("mesh", mesh)):
        eng = ContinuousDecoder(params_np, cfg, max_slots=16, max_len=1024,
                                page_size=16, prefill_chunk=256,
                                steps_per_dispatch=4, mesh=m)
        warm = eng.submit([1, 2, 3], 4)     # cuBLAS handles, allocator
        while not warm.done:
            eng.step()
        eng.tick_seconds.clear()
        stats0, hits0 = dict(eng._kv.stats), eng.stats["prefix_hits"]
        chunks0 = len(eng._chunk_trace)
        _zero_pa_counts()
        reqs, wall = _serve_mix(eng, np.random.default_rng(3), cfg.vocab,
                                sizes, max_new)
        counts = _pa_counts()
        bodies = _bodies("window" if m is not None else "")
        chunks = len(eng._chunk_trace) - chunks0
        stats = eng._kv.stats
        calls = stats["attn_ticks_kernel"] - stats0["attn_ticks_kernel"]
        gather = stats["gather_bytes"] - stats0["gather_bytes"]
        for r in reqs:
            toks = eng.result(r, timeout=1)
            if len(toks) != max_new or not all(0 <= t < cfg.vocab
                                               for t in toks):
                raise AssertionError(f"10c {key} request {r.rid}: "
                                     f"{len(toks)} tokens")
        hits = eng.stats["prefix_hits"] - hits0
        want = ((cfg.layers * calls, 0, 0, 0) if key == "single"
                else (0, 0, cfg.layers * calls, 0))
        if counts != want or gather != 0 or hits < 1:
            raise AssertionError(f"10c {key}: (K1, K2, K5a, K5b) launches "
                                 f"{counts}, want {want}; gather {gather}, "
                                 f"prefix hits {hits}")
        ticks = list(eng.tick_seconds)
        n_tok = sum(len(r.tokens) for r in reqs)
        out[key] = {"requests": len(reqs), "tokens": n_tok, "wall_s": wall,
                    "tok_per_s": n_tok / wall,
                    "p50_tick_ms": statistics.median(ticks) * 1e3,
                    "ticks": len(ticks), "attn_calls": calls,
                    "k1_launches": counts[0], "k5a_launches": counts[2],
                    "prefill_chunks": chunks, "prefix_hits": hits,
                    "mesh_shape": eng._mesh_shape,
                    "pool_device_bytes": eng._kv.device_bytes()}
        what, i = ("K5a", 2) if key == "mesh" else ("K1", 0)
        split = _window_split(what, counts[i], bodies, calls, chunks, hits,
                              cfg.layers)
        out[key].update({f"{what.lower()}_launches_decode": split["decode"],
                         f"{what.lower()}_launches_extend": split["extend"]})
        del eng
        torch.cuda.empty_cache()
    x = torch.zeros(16, 1, cfg.d_model, dtype=cfg.dtype,
                    device=resolve_device())
    group = axis_group(mesh, "tp")
    allreduce_ms = _cuda_ms([lambda: dist.all_reduce(x, group=group)], 200)
    added = cfg.layers * 4 * (write_ms + 2 * allreduce_ms)
    rec = {**out, "phase6_int8_single": {k: q8[k] for k in
                                         ("tok_per_s", "p50_tick_ms")},
           "allreduce_ms": allreduce_ms, "write_ms": write_ms,
           "added_ms_per_tick_from_parts": added,
           "added_ms_per_tick_measured": (out["mesh"]["p50_tick_ms"]
                                          - out["single"]["p50_tick_ms"]),
           "steps_per_dispatch": 4, "layers": cfg.layers}
    log(f"[mesh serving] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def _tp2_rank(mesh, seed):
    """One rank of 10d: the f32 full-width model from ``seed``, this
    rank's six heads, a pool shard, the parity prompts; its tokens, its
    (K1, K2, K5a, K5b) launches and its shard's bytes."""
    import torch
    from mmlspark_tpu_torch.models.zoo.transformer import init_transformer
    from mmlspark_tpu_torch.parallel.mesh import axis_rank
    from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _full_cfg(torch.float32)
    params_np = init_transformer(cfg, seed=seed)
    eng = ContinuousDecoder(params_np, cfg, mesh=mesh, **PARITY)
    _zero_pa_counts()
    reqs = [eng.submit(p, PARITY_NEW) for p in _parity_prompts(cfg.vocab)]
    for _ in range(400):
        if all(r.done for r in reqs):
            break
        eng.step()
    eng.flush()
    return {"rank": axis_rank(mesh, "tp"), "mesh_shape": eng._mesh_shape,
            "tokens": [eng.result(r, timeout=1) for r in reqs],
            "launches": _pa_counts(), "bodies": _bodies("window"),
            "pool_heads": eng._kv.heads,
            "pool_device_bytes": eng._kv.device_bytes(),
            "pool_device_bytes_global": eng._kv.device_bytes_global()}


def phase_tp2(dev_info, want):
    """10d: tp = 2 on the one card — two rank processes over gloo, each
    with six heads and its own pool shard, the f32 parity engine: both
    ranks' tokens equal each other's and 10b's over all
    ``PARITY_NEW`` tokens; K5a launched on each rank, its decode steps on
    the split body, K1/K2 never."""
    from mmlspark_tpu_torch.parallel.launch import run_ranks
    t0 = time.perf_counter()
    res = run_ranks(_tp2_rank, 2, args=(0,), device="cuda", timeout=600)
    wall = time.perf_counter() - t0
    for r in res:
        k1, k2, k5a, k5b = r["launches"]
        split, mma = r["bodies"]["split"], r["bodies"]["mma"]
        if r["tokens"] != want or r["mesh_shape"] != "tp2" or \
                r["pool_heads"] != 6 or k1 or k2 or k5b or mma or \
                not 0 < split < k5a:
            raise AssertionError(f"10d rank {r['rank']}: tokens "
                                 f"{r['tokens']} (want {want}), launches "
                                 f"{r['launches']}, bodies {r['bodies']}, "
                                 f"heads {r['pool_heads']}")
    rec = {"ranks": 2, "backend": "gloo", "horizon_tokens": PARITY_NEW,
           "k5a_launches_per_rank": [r["launches"][2] for r in res],
           "k5a_launches_split_per_rank": [r["bodies"]["split"]
                                           for r in res],
           "pool_device_bytes_per_rank": res[0]["pool_device_bytes"],
           "pool_device_bytes_global": res[0]["pool_device_bytes_global"],
           "wall_s": wall}
    log(f"[tp2] {json.dumps(rec)} | {dev_info['smi']}")
    return rec


def _phase10(params_np, dev_info, single, q8):
    """10a-10d; the NCCL world of one that 10b and 10c share is left
    before 10d spawns its two gloo ranks."""
    from mmlspark_tpu_torch.parallel import distributed
    from mmlspark_tpu_torch.parallel.mesh import make_mesh
    win = phase_window_kernels(dev_info)
    distributed.initialize(device="cuda")
    try:
        mesh = make_mesh({"tp": 1})
        mesh_par = phase_mesh_parity(params_np, single, mesh)
        serve = phase_mesh_serving(params_np, dev_info, mesh, q8,
                                   win["K5a"]["decode"]["write_ms"])
    finally:
        distributed.shutdown()
    tp2 = phase_tp2(dev_info, single[None])
    return win, mesh_par, serve, tp2


def _phase9(dev_info):
    """Phases 9a-9d; the kernels' 9a times at 9c's and 9d's own shapes
    give their shares."""
    import torch
    from mmlspark_tpu_torch.models.zoo.transformer import init_transformer
    flash_recs = phase_flash_kernels(dev_info)
    bert_np = init_transformer(_bert_cfg(torch.float32), seed=0)
    flash_parity = phase_flash_parity(bert_np, dev_info)
    infer_rec = flash_recs["infer bfloat16"]
    train_rec = flash_recs["train bfloat16"]
    infer = phase_flash_inference(bert_np, dev_info, infer_rec["K7"]["ms"])
    train, dec_mem = phase_flash_training(
        bert_np, dev_info,
        sum(train_rec[k]["ms"] for k in ("K7 stats", "K8a", "K8b")))
    return flash_recs, flash_parity, infer, train, dec_mem


def main(argv=()):
    sys.path.insert(0, HERE)
    try:
        import mmlspark_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"chip_smoke: the port package is not next to this script ({e})")
        return 2
    # "python3 chip_smoke.py 10": only phase 10 and what it needs (1, 2,
    # 4); "9": phases 1, 2 and 9; "3": phases 1, 2 and 3; a partial run
    # prints no result and exits 3
    only = set(argv)
    if not only <= {"3", "9", "10"}:
        log(f"chip_smoke: unknown phases {sorted(only - {'3', '9', '10'})};"
            f" the arguments are 3, 9 and 10")
        return 2
    t_start = time.perf_counter()
    dev_info = phase_device()
    phase_build()
    from mmlspark_tpu_torch.models.zoo.transformer import init_transformer
    import torch
    params_np = init_transformer(_full_cfg(torch.float32), seed=0)
    if only:
        if "3" in only:
            phase_kernels(dev_info)
        if "9" in only:
            _phase9(dev_info)
        if "10" in only:
            single = phase_parity(params_np)
            _phase10(params_np, dev_info, single,
                     {"tok_per_s": None, "p50_tick_ms": None})
        log(f"[done] partial run of phases {sorted(only)}, "
            f"{time.perf_counter() - t_start:.1f} s; no result")
        return 3
    recs = phase_kernels(dev_info)
    single = phase_parity(params_np)
    serving = phase_serving(params_np, dev_info)
    q8 = phase_quant_serving(params_np, dev_info, "int8",
                             [32, 128, 384] * 3)
    f8 = phase_quant_serving(params_np, dev_info, "fp8", [32, 384])
    sweep = phase_read_sweep(params_np, dev_info)
    hist_recs = phase_hist_kernel(dev_info)
    X, y = make_higgs_like(GBDT["rows"], GBDT["features"])
    parity = phase_tree_parity(X, y, dev_info)
    gbdt = phase_gbdt(X, y, dev_info, hist_recs)
    del X, y
    flash_recs, flash_parity, infer, train, dec_mem = _phase9(dev_info)
    infer_rec = flash_recs["infer bfloat16"]
    train_rec = flash_recs["train bfloat16"]
    win, mesh_par, serve, tp2 = _phase10(params_np, dev_info, single, q8)
    del params_np
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    src = "mmlspark_tpu_torch/csrc/paged_attention.cu"
    ref = "mmlspark_tpu/ops/paged_attention.py"
    # K1/K2's decode launches are the split body's (``_window_split``
    # asserts it), so they are its ``launches_split``
    kernels = [
        {"name": "paged_attention_window", "route": "cuda", "source": src,
         "replaces": f"{ref}:226", "launches": serving["k1_launches"],
         "launches_decode": serving["k1_launches_decode"],
         "launches_extend": serving["k1_launches_extend"],
         "launches_split": serving["k1_launches_decode"],
         **{k: recs["K1"]["decode"][k] for k in keys}, **recs["K1"]},
        {"name": "paged_attention_window (k_scale/v_scale)", "route": "cuda",
         "source": src, "replaces": f"{ref}:404",
         "launches": q8["k2_launches"], "launches_fp8_run": f8["k2_launches"],
         "launches_decode": q8["k2_launches_decode"],
         "launches_extend": q8["k2_launches_extend"],
         "launches_fp8_run_decode": f8["k2_launches_decode"],
         "launches_fp8_run_extend": f8["k2_launches_extend"],
         "launches_split": q8["k2_launches_decode"],
         "launches_fp8_run_split": f8["k2_launches_decode"],
         **{k: recs["K2"]["int8 decode"][k] for k in keys}, **recs["K2"]},
        {"name": "paged_attention", "route": "cuda", "source": src,
         "replaces": f"{ref}:195", "launches": sweep["k3_launches"],
         **{k: recs["K3"][k] for k in keys}, "read": recs["K3"]},
        {"name": "paged_attention (k_scale/v_scale)", "route": "cuda",
         "source": src, "replaces": f"{ref}:356",
         "launches": sweep["k4_launches"],
         **{k: recs["K4"][k] for k in keys}, "read": recs["K4"]},
        {"name": "paged_attention_window (mesh=)", "route": "cuda",
         "source": src, "replaces": f"{ref}:297",
         "launches": serve["mesh"]["k5a_launches"],
         "launches_decode": serve["mesh"]["k5a_launches_decode"],
         "launches_extend": serve["mesh"]["k5a_launches_extend"],
         "launches_mesh_parity_f32": mesh_par["f32"]["k5a"],
         "launches_mesh_parity_f32_split": mesh_par["f32"]["split"],
         "launches_tp2_per_rank": tp2["k5a_launches_per_rank"],
         "launches_tp2_split_per_rank": tp2["k5a_launches_split_per_rank"],
         **{k: win["K5a"]["decode"][k] for k in keys}, **win["K5a"]},
        {"name": "paged_attention_window (mesh=, k_scale/v_scale)",
         "route": "cuda", "source": src, "replaces": f"{ref}:461",
         "launches": mesh_par["int8"]["k5b"] + mesh_par["fp8"]["k5b"],
         "launches_int8_run": mesh_par["int8"]["k5b"],
         "launches_fp8_run": mesh_par["fp8"]["k5b"],
         "launches_split": (mesh_par["int8"]["split"]
                            + mesh_par["fp8"]["split"]),
         **{k: win["K5b"]["int8 decode"][k] for k in keys}, **win["K5b"]},
        {"name": "level_histogram", "route": "cuda",
         "source": "mmlspark_tpu_torch/csrc/histogram.cu",
         "replaces": "mmlspark_tpu/ops/pallas_kernels.py:124",
         "launches": gbdt["k6_launches"],
         **{k: hist_recs["nodes16"][k] for k in keys},
         "max_abs_err_all_cases": max(r["max_abs_err"]
                                      for r in hist_recs.values()),
         "cases": hist_recs, "tree_parity": parity,
         "sec_per_iter": gbdt["sec_per_iter"],
         "share_of_iter": gbdt["k6_share_of_iter"]}]
    fsrc = "mmlspark_tpu_torch/csrc/flash_attention.cu"
    fref = "mmlspark_tpu/ops/flash_attention.py"
    sdpa = "F.scaled_dot_product_attention"
    # headline times at the main paths' shapes: K7 at 9c's inference
    # (without stats), K8a/K8b at 9d's training
    main_rec = {"K7": infer_rec, "K8a": train_rec, "K8b": train_rec}
    extras = {
        "K7": {"with_stats": {k: train_rec["K7 stats"][k] for k in keys},
               "launches_inference": infer["k7_launches"],
               "launches_training": train["k7_launches"],
               "library_call": sdpa, "model_parity": flash_parity,
               "inference": infer},
        "K8a": {"library_call": f"autograd backward of {sdpa} (dQ, dK "
                                f"and dV together)",
                "training": train, "decoder_memory": dec_mem},
        "K8b": {"library_call": f"autograd backward of {sdpa} (dQ, dK "
                                f"and dV together)"}}
    for key, name, line, launches in (
            ("K7", "flash_attention", 64,
             infer["k7_launches"] + train["k7_launches"]),
            ("K8a", "flash_attention backward (dK, dV)", 230,
             train["k8a_launches"]),
            ("K8b", "flash_attention backward (dQ)", 270,
             train["k8b_launches"])):
        kernels.append({
            "name": name, "route": "cuda", "source": fsrc,
            "replaces": f"{fref}:{line}", "launches": launches,
            **{k: main_rec[key][key][k] for k in keys},
            "shape": main_rec[key][key]["shape"],
            "max_abs_err_all_cases": max(r[key]["max_abs_err"]
                                         for r in flash_recs.values()),
            "cases": {label: {k: flash_recs[f"{label} bfloat16"][key][k]
                              for k in keys + ("shape",)}
                      for label in FLASH_TIMED},
            **extras[key]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(dev_info["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main(sys.argv[1:])
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        code = 1
    sys.exit(code)
