"""Times the mesh mount's window read (K5a on bf16 pages, K5b on int8 and
fp8 pages) of the port package next to this script, at every case of
``chip_smoke.py`` phase 10a, through the package's own wrapper
``ops.paged_attention._window_read``: so it times any checkout of the
port whose wrapper takes the same arguments, whichever kernel body that
checkout runs.

For each case it prints one JSON line: the device time per call (the
stream spun ahead, as ``chip_smoke._cuda_ms`` does, so the host's pace
is not timed), the host-paced time, the host's issue cost per call, the
kernel launches and memsets of one call (``torch.profiler``), and the
largest difference from the plain version (the NaN planted past each
row's bound must stay out). The last line is the card's name and power
limit as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
prints them.

To compare two checkouts on one card, put this script and
``chip_smoke.py`` next to each checkout's ``mmlspark_tpu_torch/`` and run
them one after the other in one command, alternating (A, B, B, A), e.g.
with another commit unpacked under ``build/``::

    mkdir -p build/old && git archive <commit> mmlspark_tpu_torch \\
        | tar -x -C build/old
    cp chip_smoke.py time_window_read.py build/old/
    python3 build/old/time_window_read.py; python3 time_window_read.py; ...

Each checkout builds its kernels into its own ``build/``. Needs a CUDA
card; exits 2 without one, or without the package next to it.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def time_case(kernel, name, args, kw):
    import torch
    import chip_smoke as cs
    from mmlspark_tpu_torch.ops import paged_attention as pa

    _label, B, W, pos_list, _active, seed = args
    store, H, P = kw.get("store"), kw.get("H", 12), kw.get("P")
    x = cs._kv_case_inputs(B, W, pos_list, seed, store, H=H, P=P)
    q, kn, vn, bt, pools = x["q"], x["kn"], x["vn"], x["bt"], x["pools"]
    pos = torch.tensor(pos_list, dtype=torch.int32, device=q.device)
    scale = 1.0 / x["hd"] ** 0.5
    want = pa.paged_attention_window_read_plain(q, kn, vn, pools[0],
                                                pools[1], bt, pos, scale,
                                                *pools[2:])
    got = pa._window_read(q, kn, vn, pools[0], pools[1], bt, pos, scale,
                          *pools[2:])
    err = (got.float() - want.float()).abs().max().item()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{kernel} {name}: the context is not finite")
    launches, memsets, _ = cs._kernel_launches(lambda: pa._window_read(
        q, kn, vn, pools[0], pools[1], bt, pos, scale, *pools[2:]))
    n = cs._copies(sum(t.numel() * t.element_size() for t in pools))
    copies = [[t.clone() for t in pools] for _ in range(n)]
    calls = [lambda c=c: pa._window_read(q, kn, vn, c[0], c[1], bt, pos,
                                         scale, *c[2:]) for c in copies]
    cs._cuda_ms(calls, len(calls), head_start=False)     # warm-up
    return {"kernel": kernel, "case": name, "ms": cs._cuda_ms(calls, 200),
            "host_paced_ms": cs._cuda_ms(calls, 200, head_start=False),
            "host_ms": cs._host_ms(calls, 200),
            "launches_per_call": launches, "memsets_per_call": memsets,
            "max_abs_err": err}


def main():
    sys.path.insert(0, HERE)
    try:
        import mmlspark_tpu_torch  # noqa: F401
        import chip_smoke as cs
    except ImportError as e:
        print(f"time_window_read: needs chip_smoke.py and the port package "
              f"next to it ({e})", flush=True)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("time_window_read: no CUDA device", flush=True)
        return 2
    dev_info = cs.phase_device()
    print(f"[tree] {HERE}", flush=True)
    for kernel, name, args, kw in cs.window_cases():
        print(json.dumps(time_case(kernel, name, args, kw)), flush=True)
    print(dev_info["smi"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
