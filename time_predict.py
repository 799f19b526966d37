"""Times the GBDT model's prediction paths of the port package next to
this script, at BASELINE #2's size (the HIGGS-shaped 11M x 28 matrix of
``chip_smoke.make_higgs_like``), on the card:

- ``predict``: ``Booster.predict`` over all rows (phase 8c's
  ``predict_s``);
- ``transform_12a``: ``LightGBMClassificationModel.transform`` of the
  first ``chip_smoke.GBDT["bin_rows"]`` rows (12a's ``transform_s``);
- ``transform_1m``: the same over the first 1,000,000 rows (19a's
  ``B.transform``), with its parts timed alone after it: the two
  ``Booster.predict`` calls it makes (raw scores, probabilities) and the
  building of its two object columns on the host;
- ``refit``: ``Booster.refit`` on rows 10,000,000-10,999,999 (19a's
  refit), where the checkout's ``Booster`` has one.

Each is called ``--reps`` times (the card synchronised after each call)
and every reading is printed, first call included. The trees come from a
model string: ``--model PATH`` loads it; where PATH does not exist, the
script first trains 8c's model (``train()`` at ``device=None``, 100
iterations, 31 leaves, 255 bins) and writes it there, so that two
checkouts time the same trees. One JSON line a reading; the last line is
the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` prints them.

To compare two checkouts on one card, put this script and
``chip_smoke.py`` next to each checkout's ``mmlspark_tpu_torch/`` and run
them one after the other in one command, alternating (A, B, B, A)::

    mkdir -p build/old && git archive <commit> mmlspark_tpu_torch \\
        | tar -x -C build/old
    cp chip_smoke.py time_predict.py build/old/
    python3 time_predict.py --model build/m.json        # trains, writes
    python3 build/old/time_predict.py --model build/m.json; ...

Usage: ``python3 time_predict.py [--model PATH] [--reps N]``. Needs a
CUDA card; exits 2 without one, or without the package next to it.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default=os.path.join(HERE, "build",
                                                    "higgs_8c_model.json"))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_predict: no CUDA card", file=sys.stderr)
        return 2
    try:
        import chip_smoke as cs
        from mmlspark_tpu_torch.core import DataFrame
        from mmlspark_tpu_torch.models.gbdt import Booster, train
        from mmlspark_tpu_torch.models.gbdt.estimators import \
            LightGBMClassificationModel, _object_rows
    except ImportError as e:
        print(f"time_predict: the port package is not next to this script "
              f"({e})", file=sys.stderr)
        return 2
    X, y = cs.make_higgs_like(cs.GBDT["rows"], cs.GBDT["features"])
    if not os.path.exists(args.model):
        t0 = time.perf_counter()
        b = train({"objective": "binary", "num_leaves": 31, "max_bin": 255,
                   "learning_rate": 0.1, "min_data_in_leaf": 20,
                   "num_iterations": cs.GBDT["iters"]}, X, y)
        os.makedirs(os.path.dirname(os.path.abspath(args.model)),
                    exist_ok=True)
        with open(args.model, "w") as f:
            f.write(b.to_string())
        print(json.dumps({"trained_s": time.perf_counter() - t0,
                          "trees": b.num_trees}), flush=True)
    with open(args.model) as f:
        b = Booster.from_string(f.read())
    model = LightGBMClassificationModel(booster=b)

    def report(what, rows, secs, **extra):
        print(json.dumps({"package": os.path.join(HERE, "mmlspark_tpu_torch"),
                          "what": what, "rows": rows, "seconds": secs,
                          "rows_per_s": rows / secs, **extra}), flush=True)

    n12 = cs.GBDT["bin_rows"]
    for rep in range(args.reps):
        secs, _ = _timed(lambda: b.predict(X))
        report("predict", len(y), secs, rep=rep)
    for rep in range(args.reps):
        secs, _ = _timed(lambda: model.transform(
            DataFrame({"features": X[:n12]})))
        report("transform_12a", n12, secs, rep=rep)
    x1m = X[:1_000_000]
    for rep in range(args.reps):
        secs, _ = _timed(lambda: model.transform(
            DataFrame({"features": x1m})))
        parts = {}
        parts["raw_score"], raw = _timed(lambda: b.predict(x1m,
                                                           raw_score=True))
        parts["predict"], prob = _timed(lambda: b.predict(x1m))
        t0 = time.perf_counter()
        _object_rows(np.stack([-raw, raw], axis=1))
        _object_rows(np.stack([1 - prob, prob], axis=1))
        parts["object_rows"] = time.perf_counter() - t0
        report("transform_1m", len(x1m), secs, rep=rep, parts_s=parts)
    if hasattr(b, "refit"):
        lo, hi = 10_000_000, 11_000_000
        for rep in range(args.reps):
            secs, _ = _timed(lambda: b.refit(X[lo:hi], y[lo:hi]))
            report("refit", hi - lo, secs, rep=rep)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
