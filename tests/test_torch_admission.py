"""Port parity: weighted-fair admission and the consistent-hash ring
(``serving/admission.py``).

One scripted sequence of ``put_nowait`` / ``put`` / ``get`` /
``check_admit`` calls, under an injected clock, runs through both
packages' ``AdmissionQueue``: the dequeue order, every shed (its type,
depth and budget), each ``snapshot()`` and each ``suggest_retry_after``
must agree. The ring's routes, fallbacks and rebuilds must too.
"""

import queue
import time

import numpy as np
import pytest
import torch

from mmlspark_tpu.serving import admission as ref_adm
from mmlspark_tpu_torch.serving import admission as port_adm

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"


class _Item:
    def __init__(self, tenant, n):
        self.tenant = tenant
        self.n = n


WEIGHTS = {"gold": 3.0, "silver": 1.0, "bronze": 0.5, "zero": 0.0}


def _script(mod, clock, seed):
    """Run one seeded script of queue calls; returns its transcript."""
    rng = np.random.default_rng(seed)
    q = mod.AdmissionQueue(maxsize=12, weight_fn=lambda t: WEIGHTS.get(t, 1),
                           burst=1.5)
    tenants = ["gold", "silver", "bronze", "zero", "other"]
    out = []
    for step in range(160):
        clock[0] += float(rng.choice([0.01, 0.05, 0.3, 6.0],
                                     p=[0.5, 0.3, 0.15, 0.05]))
        # a filling phase, then a draining one
        op = rng.choice(["put_nowait", "put", "get", "check", "hint"],
                        p=([0.6, 0.05, 0.15, 0.1, 0.1] if step < 100
                           else [0.15, 0.05, 0.6, 0.1, 0.1]))
        t = str(rng.choice(tenants))
        try:
            if op == "put_nowait":
                q.put_nowait(_Item(t, step))
                out.append(("put", t, step))
            elif op == "put":
                q.put(_Item(t, step))
                out.append(("put!", t, step))
            elif op == "get":
                it = q.get_nowait()
                out.append(("get", it.tenant, it.n))
            elif op == "check":
                q.check_admit(t)
                out.append(("admit", t))
            else:
                out.append(("hint", q.suggest_retry_after(floor=0.5),
                            q.suggest_retry_after(floor=0.5, tenant=t)))
        except mod.TenantOverBudget as e:
            out.append(("over", e.tenant, e.depth, e.budget, e.reason))
        except queue.Full:
            out.append(("full", t))
        except queue.Empty:
            out.append(("empty",))
        out.append(("snap", q.snapshot(), q.qsize(), q.full(), q.depths()))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_queue_script_agrees(monkeypatch, seed):
    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    want = _script(ref_adm, clock, seed)
    clock[0] = 1000.0
    got = _script(port_adm, clock, seed)
    assert got == want
    kinds = {e[0] for e in want}
    # the script exercised every outcome
    assert {"put", "get", "over", "full", "empty", "hint"} <= kinds


def test_blocking_get_times_out_and_wakes():
    for mod in (ref_adm, port_adm):
        q = mod.AdmissionQueue(maxsize=2)
        with pytest.raises(queue.Empty):
            q.get(timeout=0.05)
        q.put(_Item("a", 1))
        assert q.get(timeout=1.0).n == 1
        assert q.empty()


def test_lone_tenant_uses_the_whole_queue():
    for mod in (ref_adm, port_adm):
        q = mod.AdmissionQueue(maxsize=4)
        for i in range(4):
            q.put_nowait(_Item("solo", i))
        with pytest.raises(queue.Full) as e:
            q.put_nowait(_Item("solo", 9))
        assert not isinstance(e.value, mod.TenantOverBudget)
        assert [q.get_nowait().n for _ in range(4)] == [0, 1, 2, 3]


@pytest.mark.parametrize("replicas,factor", [(64, 1.25), (8, 1.0)])
def test_ring_routes_and_rebuilds_agree(replicas, factor):
    rings = [mod.ConsistentHashRing(replicas=replicas, load_factor=factor)
             for mod in (ref_adm, port_adm)]
    rng = np.random.default_rng(replicas)
    keys = [f"prefix-{int(k)}" for k in rng.integers(0, 1 << 30, 200)]
    for members in (["w0", "w1", "w2"], ["w0", "w1", "w2"],
                    ["w1", "w2", "w3", "w4"], [], ["solo"]):
        changed = [r.rebuild(members) for r in rings]
        assert changed[0] == changed[1]
        assert rings[0].nodes() == rings[1].nodes()
        assert len(rings[0]) == len(rings[1])
        load = {m: float(rng.integers(0, 10)) for m in members}
        for key in keys:
            assert rings[0].preferred(key) == rings[1].preferred(key)
            assert rings[0].preferred(key, 2) == rings[1].preferred(key, 2)
            assert rings[0].route(key) == rings[1].route(key)
            assert rings[0].route(key, load) == rings[1].route(key, load)
