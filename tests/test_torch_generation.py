"""Port parity: the HTTP generation endpoint (``serving/generation.py``
over ``serving/server.py``). The port's engine runs on the CPU; its
``/generate`` answers must carry the tokens the JAX ``generate_cached``
gives, over the same wire contract (JSON replies, SSE streams, 400s)."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.models.zoo import transformer as ref_tf
from mmlspark_tpu_torch.models.zoo.transformer import TransformerConfig
from mmlspark_tpu_torch.serving.generation import GenerationEngine

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

REF_CFG = ref_tf.TransformerConfig(vocab=128, layers=2, d_model=64, heads=4,
                                   d_ff=128, max_len=64, causal=True,
                                   norm="rmsnorm", position="rope",
                                   dtype=jnp.float32)
CFG = TransformerConfig(vocab=128, layers=2, d_model=64, heads=4, d_ff=128,
                        max_len=64, causal=True, norm="rmsnorm",
                        position="rope", dtype=torch.float32)


@pytest.fixture(scope="module")
def params():
    return ref_tf.init_transformer(REF_CFG, seed=0)


def _post(url, payload, timeout=120.0):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _want(params, prompt, max_new):
    ids = ref_tf.generate_cached(params, np.asarray(prompt)[None], REF_CFG,
                                 max_new_tokens=max_new)
    return [int(t) for t in np.asarray(ids)[0, len(prompt):]]


def _engine(params, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_len", 48)
    return GenerationEngine(params, CFG, device="cpu", **kw)


def test_single_request_roundtrip(params):
    with _engine(params) as eng:
        prompt = [5, 17, 9, 80]
        status, _, body = _post(eng.address, {"tokens": prompt, "max_new": 6})
        assert status == 200
        assert json.loads(body)["tokens"] == _want(params, prompt, 6)


def test_sse_stream(params):
    prompt = [3, 44, 7, 91, 12]
    with _engine(params, steps_per_dispatch=2) as eng:
        status, ctype, body = _post(
            eng.address, {"tokens": prompt, "max_new": 7, "stream": True})
    assert status == 200 and ctype == "text/event-stream"
    events = [json.loads(chunk[len("data: "):])
              for chunk in body.decode().split("\n\n") if chunk]
    final = events[-1]
    want = _want(params, prompt, 7)
    assert final == {"done": True, "tokens": want}
    assert [t for e in events[:-1] for t in e["tokens"]] == want


def test_concurrent_clients_and_prefix(params):
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, 128, 3 + i)]
               for i in range(4)]
    shared = [int(t) for t in rng.integers(0, 128, 9)]
    payloads = [{"tokens": p, "max_new": 5} for p in prompts]
    payloads += [{"tokens": shared + [1, 2], "max_new": 5,
                  "prefix_key": "sys", "prefix_len": 9},
                 {"tokens": shared + [7], "max_new": 5,
                  "prefix_key": "sys", "prefix_len": 9}]
    results = {}
    with _engine(params, page_size=4) as eng:
        results[4] = _post(eng.address, payloads[4])

        def client(i):
            results[i] = _post(eng.address, payloads[i])
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(payloads)) if i != 4]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert eng.decoder.stats["prefix_hits"] == 1
    for i, p in enumerate(payloads):
        status, _, body = results[i]
        assert status == 200
        assert json.loads(body)["tokens"] == _want(params, p["tokens"], 5)


def test_bad_requests_get_400_and_healthz(params):
    with _engine(params, max_slots=1, max_len=16) as eng:
        for payload in ({"tokens": []}, {"max_new": 4},
                        {"tokens": [1, CFG.vocab]}, {"tokens": [1, -3]},
                        {"tokens": list(range(15)), "max_new": 8},
                        {"tokens": [1, 2], "max_new": "ten"}):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(eng.address, payload)
            assert ei.value.code == 400
            assert "error" in json.loads(ei.value.read())
        url = eng.server.address.replace("/generate", "/healthz")
        with urllib.request.urlopen(url, timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["transport"] == "threaded"
        status, _, body = _post(eng.address, {"tokens": [1, 2], "max_new": 3})
        assert status == 200
        assert json.loads(body)["tokens"] == _want(params, [1, 2], 3)
