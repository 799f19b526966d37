"""Port parity: the model registry and ``ServingEngine`` with its source and
sink (``mmlspark_tpu_torch/serving/{registry,engine,source}.py``)
against the JAX package's.

The registry cases follow the reference's ``tests/test_registry.py``:
the same calls, with an injected-clock SLO tracker behind the canary
verdicts, give EQUAL results in both packages — the deterministic split
``_bucket`` over 1000 seeded ids, the state machine, resolutions,
auto-rollback verdicts, the shadow join and its diffs, tenant weights,
and ``retire`` releasing what a handle holds (a bound ``transform``'s
model's ``_device_params`` too).

The engine case serves the tiny ResNet of ``tests/test_torch_onnx_model``
(``ResNetConfig([1, 1], num_classes=7, width=8)``, 32×32 images as JSON
lists) through each package's ``ServingEngine`` over its own
``ONNXModel``, with ``net@1`` live and ``net@2`` (the same bytes) as a
25% canary and a 50% shadow, both registered by ``register_model``.
Request ids are minted from one deterministic sequence in both
packages, so routing is compared id for id: the same rows reach
``net@2`` and the same requests are mirrored. Replies agree within
``F32`` (rtol 1e-5, atol 1e-5: float32 sums in another order), the
tolerance ``tests/test_torch_onnx_model.py`` states.
"""

import itertools
import json
import time
import types
import urllib.request

import numpy as np
import pytest
import torch

import mmlspark_tpu.serving.engine as r_engine
import mmlspark_tpu_torch.serving.engine as p_engine
from mmlspark_tpu.models.onnx_model import ONNXModel as JONNXModel
from mmlspark_tpu_torch.models.onnx_model import ONNXModel
from mmlspark_tpu_torch.models.zoo import resnet as pres
from test_torch_tracing_slo import PKGS, assert_same, reset_plane

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

PKGS["jax"].engine, PKGS["port"].engine = r_engine, p_engine

F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _clean_plane():
    reset_plane()
    yield
    reset_plane()


def test_bucket_split_equal_over_1000_seeded_ids():
    rng = np.random.default_rng(7)
    ids = [bytes(rng.integers(0, 256, 16, dtype=np.uint8)).hex()
           for _ in range(1000)]
    out = assert_same(lambda pkg: [
        [pkg.registry._bucket(i, salt) for i in ids]
        for salt in ("canary", "shadow")])
    assert sorted(set(out[0])) == list(range(100))


def _clean_version(v):
    """A version's snapshot without ``warmed_seconds``: a perf_counter
    reading in both packages (0.0 or 1e-06 for a no-op warm-up)."""
    v = json.loads(json.dumps(v))
    v.pop("warmed_seconds", None)
    return v


def _clean_snapshot(snap):
    snap = json.loads(json.dumps(snap))
    for versions in snap["models"].values():
        versions[:] = [_clean_version(v) for v in versions]
    for r in snap["rollbacks"] + snap["shadow_diffs"]:
        r.pop("t", None)
    return snap


def _registry_script(pkg):
    now = [0.0]
    tracker = pkg.slo.SloTracker(clock=lambda: now[0])
    pkg.obs.set_tracker(tracker)
    reg = pkg.registry.ModelRegistry(min_requests=5, check_every=4)
    warmed = []
    reg.load("m", "1", handle="h1", warm_up=lambda: warmed.append(1))
    reg.load("m", "2", handle="h2", canary_percent=25, shadow_percent=50)
    try:
        reg.load("m", "2")
        dup = None
    except ValueError as e:
        dup = str(e)
    res = []
    for i in range(60):
        r = reg.resolve("m", f"{i:032x}")
        res.append((r.label, r.shadow, r.decision))
        if r.shadow is not None:
            reg.shadow_begin(f"{i:032x}", f"s{i}", r.shadow,
                             trace_id=f"{i:032x}")
            reg.shadow_result(f"{i:032x}", b'{"y": 1}', from_shadow=i % 2)
            reg.shadow_result(f"{i:032x}",
                              b'{"y": 1}' if i % 3 else b'{"y": 2}',
                              from_shadow=not i % 2)
            reg.note_done(r.shadow)
        reg.note_done(r.label)
    passthrough = reg.resolve("other", "x").label
    for i in range(10):
        tracker.observe(transport="threaded", route="api", model="m@1",
                        seconds=0.01, tenant="t0")
        tracker.observe(transport="threaded", route="api", model="m@2",
                        seconds=0.5, error=i % 2 == 0, tenant="t0")
    verdicts = reg.check_canaries()
    reg.set_tenant("t0", 3.0)
    try:
        reg.set_tenant("t1", 0.0)
        bad = None
    except ValueError as e:
        bad = str(e)
    reg.load("m", "3", canary_percent=10)
    promoted = _clean_version(reg.promote("m", "3").snapshot())
    retired = reg.retire("m", "1")
    return (dup, res, passthrough, json.loads(json.dumps(verdicts)),
            reg.tenants(), reg.tenant_weight("t9"), bad, promoted, retired,
            _clean_snapshot(reg.snapshot()), reg.digest(), warmed)


def test_registry_state_machine_resolution_and_canary_verdicts_equal():
    out = assert_same(_registry_script)
    res, verdicts = out[1], out[3]
    assert {d for _, _, d in res} == {"incumbent", "canary"}
    assert verdicts and verdicts[0]["breach"]


def test_retire_releases_what_the_handle_holds():
    class _Model:
        def __init__(self):
            self._device_params = {("cuda:0", "bfloat16"): object()}

        def transform(self, df):
            return df

    class _Pool:
        closed = False

        def close(self):
            self.closed = True

    def run(pkg):
        reg = pkg.registry.ModelRegistry()
        model = _Model()
        reg.load("b", "1", handle=model.transform)
        holder = types.SimpleNamespace(_device_params={"slot0": 1},
                                       pool=_Pool())
        reg.load("c", "1", handle=holder)
        out = (reg.retire("b", "1"), reg.retire("c", "1"),
               holder._device_params, holder.pool.closed,
               reg.handle_for("b@1"))
        return out, model._device_params
    out = {name: run(pkg) for name, pkg in PKGS.items()}
    assert out["port"][0] == out["jax"][0]
    assert out["port"][0][2] == {} and out["port"][0][3] is True
    # the port releases a bound transform's model's params; the reference
    # keys only on the handle itself
    assert out["port"][1] == {}


# ---------------------------------------------------------------------------
# ServingEngine over ONNXModel, both packages


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, 32, 32, 3)).astype(np.uint8)


KW = dict(feed_dict={"input": "image"}, fetch_dict={"logits": "logits"},
          transpose_dict={"input": [0, 3, 1, 2]}, mini_batch_size=4)


@pytest.fixture(scope="module")
def model_bytes():
    return pres.export_resnet_onnx(
        pres.ResNetConfig([1, 1], num_classes=7, width=8), seed=0,
        input_size=32)


def _post(url, payload, headers):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json",
                                          **headers})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, dict(r.headers), json.loads(r.read())


def _serve(pkg, name, model_bytes, images, monkeypatch):
    seq = itertools.count(1)
    monkeypatch.setattr(pkg.tracing, "new_request_id",
                        lambda: f"{next(seq):032x}")
    make = (lambda: JONNXModel(model_bytes, **KW)) if name == "jax" else \
        (lambda: ONNXModel(model_bytes, device="cpu", **KW))
    # rollback verdicts off: the canary count must stay exact
    pkg.registry.set_registry(pkg.registry.ModelRegistry(
        min_requests=10 ** 9))
    served = {"1": [], "2": []}
    eng = pkg.engine.ServingEngine({}, schema={"image": list},
                                   reply_col="logits", max_batch=8,
                                   poll_timeout=0.01)
    for v in ("1", "2"):
        m = make()

        def handle(df, m=m, v=v):
            served[v].extend(df["id"])
            return m.transform(df)
        kw = {} if v == "1" else dict(canary_percent=25, shadow_percent=50)
        mv = eng.register_model("net", v, handle,
                                warm_up=lambda m=m: m.transform(
                                    _df(name, images[:1])), **kw)
        assert mv.state == ("live" if v == "1" else "canary")
    replies = []
    with eng:
        for i, img in enumerate(images):
            status, headers, body = _post(
                eng.address, {"image": img.tolist()},
                {"X-Mmlspark-Model": "net", "X-Mmlspark-Tenant": f"t{i % 2}",
                 "traceparent": f"00-{i + 1:032x}-{'1' * 16}-01"})
            replies.append((status, headers["X-Request-Id"],
                            np.asarray(body, np.float64)))
        reg = pkg.registry.get_registry()
        for _ in range(200):      # the last mirrors may still be in flight
            if not reg.snapshot()["shadow_pending"]:
                break
            time.sleep(0.01)
        snap = _clean_snapshot(reg.snapshot())
    # warm-up rows carry no id column: only served requests count
    return replies, {v: sorted(ids) for v, ids in served.items()}, snap


def _df(name, images):
    if name == "jax":
        from mmlspark_tpu.core import DataFrame as D
        from mmlspark_tpu.core.dataframe import object_col as oc
    else:
        from mmlspark_tpu_torch.core import DataFrame as D
        from mmlspark_tpu_torch.core.dataframe import object_col as oc
    return D({"image": oc(np.asarray(x, np.int64) for x in images)})


def test_serving_engines_route_and_answer_alike(model_bytes, monkeypatch):
    images = _images(16)
    out = {name: _serve(pkg, name, model_bytes, images, monkeypatch)
           for name, pkg in PKGS.items()}
    (r_j, served_j, snap_j), (r_p, served_p, snap_p) = out["jax"], out["port"]
    assert [s for s, _, _ in r_p] == [s for s, _, _ in r_j] == [200] * 16
    ids = [rid for _, rid, _ in r_p]
    assert ids == [rid for _, rid, _ in r_j]
    assert served_p == served_j
    canary = [rid for rid in ids
              if PKGS["port"].registry._bucket(rid, "canary") < 25]
    assert sorted(set(served_p["2"]) & set(ids)) == sorted(canary)
    assert snap_p == snap_j
    assert snap_p["shadow_diffs"] and all(
        d["verdict"] in ("match", "diff") for d in snap_p["shadow_diffs"])
    for (_, _, a), (_, _, b) in zip(r_p, r_j):
        np.testing.assert_allclose(a, b, **F32)


def test_tuning_auto_is_not_ported():
    """Named before the cost model was ported: ``tuning="auto"`` is now
    accepted (the tuned models switch at ``start``); other values still
    raise."""
    eng = p_engine.ServingEngine(lambda df: df, tuning="auto")
    try:
        assert eng.tuning == "auto" and eng.tuned_models == []
    finally:
        eng.stop()
    with pytest.raises(ValueError):
        p_engine.ServingEngine(lambda df: df, tuning="fast")
