"""Times the read-only sweep (K3 on bf16 pages, K4 on int8 and fp8 pages)
of the port package next to this script, at every K3/K4 case of
``chip_smoke.py`` phase 3 (``chip_smoke.read_cases``), through the
package's public ``ops.paged_attention.paged_attention``: so it times any
checkout of the port whose wrapper takes the same arguments, whichever
kernel body that checkout runs.

For each case it prints one JSON line: the device time per call (the
stream spun ahead, as ``chip_smoke._cuda_ms`` does, so the host's pace
is not timed), the host-paced time, the host's issue cost per call, the
kernel launches and memsets of one call (``torch.profiler``), the body
the wrapper counted (where the checkout counts bodies), and the largest
difference from the plain version (the NaN planted past each row's
length must stay out). The last line is the card's name and power limit
as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
prints them.

To compare two checkouts on one card, put this script and
``chip_smoke.py`` next to each checkout's ``mmlspark_tpu_torch/`` and run
them one after the other in one command, alternating (A, B, B, A), e.g.
with another commit unpacked under ``build/``::

    mkdir -p build/old && git archive <commit> mmlspark_tpu_torch \\
        | tar -x -C build/old
    cp chip_smoke.py time_read.py build/old/
    python3 build/old/time_read.py; python3 time_read.py; ...

Each checkout builds its kernels into its own ``build/``. Needs a CUDA
card; exits 2 without one, or without the package next to it.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _body_counts(pa):
    """The K3/K4 launches by body, where this checkout counts them."""
    return {k: getattr(pa.paged_attention, "launches_" + k, None)
            for k in ("split", "q_split")}


def time_case(kernel, name, args, kw):
    import torch
    import chip_smoke as cs
    from mmlspark_tpu_torch.ops import paged_attention as pa

    _label, B, W, len_list, seed = args
    store, P = kw.get("store"), kw.get("P")
    x = cs._kv_case_inputs(B, W, len_list, seed, store, P=P)
    q, bt, pools = x["q"], x["bt"], x["pools"]
    lengths = torch.tensor(len_list, dtype=torch.int32, device=q.device)
    scale = 1.0 / x["hd"] ** 0.5

    def call(c):
        kw_ = {"k_scale": c[2], "v_scale": c[3]} if store is not None else {}
        return pa.paged_attention(q, c[0], c[1], bt, lengths, **kw_)

    want = pa.paged_attention_plain(q, pools[0], pools[1], bt, lengths,
                                    scale, *pools[2:])
    b0 = _body_counts(pa)
    got = call(pools)
    torch.cuda.synchronize()
    b1 = _body_counts(pa)
    body = sorted(k for k in b1 if b1[k] is not None and b1[k] > b0[k])
    err = (got.float() - want.float()).abs().max().item()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{kernel} {name}: the context is not finite")
    launches, memsets, _ = cs._kernel_launches(lambda: call(pools))
    n = cs._copies(sum(t.numel() * t.element_size() for t in pools))
    copies = [[t.clone() for t in pools] for _ in range(n)]
    calls = [lambda c=c: call(c) for c in copies]
    cs._cuda_ms(calls, len(calls), head_start=False)     # warm-up
    return {"kernel": kernel, "case": name, "W": W,
            "ms": cs._cuda_ms(calls, 200),
            "host_paced_ms": cs._cuda_ms(calls, 200, head_start=False),
            "host_ms": cs._host_ms(calls, 200),
            "launches_per_call": launches, "memsets_per_call": memsets,
            "body": body or "not counted", "max_abs_err": err}


def main():
    sys.path.insert(0, HERE)
    try:
        import mmlspark_tpu_torch  # noqa: F401
        import chip_smoke as cs
    except ImportError as e:
        print(f"time_read: needs chip_smoke.py and the port package next "
              f"to it ({e})", flush=True)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("time_read: no CUDA device", flush=True)
        return 2
    dev_info = cs.phase_device()
    print(f"[tree] {HERE}", flush=True)
    for kernel, name, args, kw in cs.read_cases():
        print(json.dumps(time_case(kernel, name, args, kw)), flush=True)
    print(dev_info["smi"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
