"""Port parity: durable sessions — KV-page export/adopt
(``serving/kv_pool.py``) and checkpoint/restore on the decoder
(``serving/continuous.py``), the reference's
``tests/test_session_failover.py:105-255`` restated against the JAX
package.

* blobs: export/adopt round trips are bitwise on f32, bf16, int8 and fp8
  pools in both directions (a JAX blob adopts into the port's pool and
  re-exports to the same blob, and the reverse); layout and quantization
  mismatches raise; a pool too small to adopt leaks no page;
* the decoder at f32: cold restore from the journal alone, warm adopt
  (no prefill), a double failover and a spent session give the JAX
  engine's uninterrupted greedy tokens; a JAX checkpoint, blob and all,
  restores on the port's engine; a sampled session restored cold or warm
  continues the uninterrupted port run (its draws key on the seed and
  the absolute position); the checkpoint holds at a dispatch boundary and
  mid-block (``steps_per_dispatch`` > 1) and after a ``compact()`` remap;
* bench.py's own failover configuration (``bench.py:706-758``: head
  dim 16, 8-token pages) on the plain path.
"""

import base64

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu.models.zoo import transformer as ref_tf
from mmlspark_tpu.serving.continuous import ContinuousDecoder as RefDecoder
from mmlspark_tpu.serving.kv_pool import PagedKVPool as RefPool
from mmlspark_tpu_torch.models.zoo import transformer as port_tf
from mmlspark_tpu_torch.serving.continuous import ContinuousDecoder
from mmlspark_tpu_torch.serving.journal import ServingJournal
from mmlspark_tpu_torch.serving.kv_pool import PagedKVPool, PoolExhausted

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

WIDTHS = dict(vocab=128, layers=2, d_model=64, heads=4, d_ff=128,
              max_len=64, causal=True, norm="rmsnorm", position="rope")
REF_CFG = ref_tf.TransformerConfig(dtype=jnp.float32, **WIDTHS)
CFG = port_tf.TransformerConfig(dtype=torch.float32, **WIDTHS)


@pytest.fixture(scope="module")
def params():
    return ref_tf.init_transformer(REF_CFG, seed=0)


def _finish(eng, req, max_steps=400):
    for _ in range(max_steps):
        if req.done:
            break
        eng.step()
    assert req.done
    return eng.session_result(req)


def _engine(params, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_len", 64)
    return ContinuousDecoder(params, CFG, device="cpu", **kw)


_WANT = {}


def _ref_tokens(params, prompt, max_new):
    """The JAX engine's uninterrupted greedy tokens (cached per case)."""
    key = (tuple(int(t) for t in prompt), max_new)
    if key not in _WANT:
        eng = RefDecoder(params, REF_CFG, max_slots=2, max_len=64)
        _WANT[key] = _finish(eng, eng.submit(prompt, max_new))
    return _WANT[key]


# ---------------------------------------------------------------------------
# blobs

POOL_CASES = {"f32": (jnp.float32, torch.float32, None),
              "bf16": (jnp.bfloat16, torch.bfloat16, None),
              "int8": (jnp.float32, torch.float32, "int8"),
              "fp8": (jnp.float32, torch.float32, "fp8")}


def _pools(case, num_pages=8, page_size=4):
    jdt, tdt, kv = POOL_CASES[case]
    ref = RefPool(REF_CFG._replace(dtype=jdt), num_pages=num_pages,
                  page_size=page_size, kv_dtype=kv, residency=False)
    port = PagedKVPool(CFG._replace(dtype=tdt), num_pages=num_pages,
                       page_size=page_size, kv_dtype=kv, device="cpu")
    return ref, port


def _fill_ref(pool, pages, seed):
    rng = np.random.default_rng(seed)
    new = []
    for c in pool.buffers:
        nc = {}
        for key, buf in c.items():
            fill = rng.standard_normal(
                (len(pages),) + buf.shape[1:]).astype(np.float32) * 3
            nc[key] = buf.at[jnp.asarray(pages)].set(
                jnp.asarray(fill, buf.dtype))
        new.append(nc)
    pool.buffers = new


def _fill_port(pool, pages, seed):
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(pages)
    for c in pool.buffers:
        for buf in c.values():
            fill = torch.from_numpy(rng.standard_normal(
                (len(pages),) + tuple(buf.shape[1:])).astype(np.float32) * 3)
            if buf.dtype == torch.int8:
                fill = fill.round().clamp(-127, 127)
            buf.view(torch.uint8)[idx] = fill.to(buf.dtype).view(torch.uint8)


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_blob_round_trips_bitwise_both_ways(case):
    ref, port = _pools(case)
    # JAX -> port: the port adopts the JAX blob and re-exports it
    src = ref.alloc(3)
    _fill_ref(ref, src, 1)
    blob_j = ref.export_session(src, length=10)
    got = port.adopt_session(blob_j)
    assert len(got) == 3 and port.stats["sessions_adopted"] == 1
    assert port.export_session(got, length=10) == blob_j
    # port -> JAX: the reverse, from content the port wrote
    ref2, port2 = _pools(case)
    src2 = port2.alloc(2)
    port2.alloc(1)                      # the exported pages are not first
    _fill_port(port2, src2, 2)
    blob_p = port2.export_session(src2, length=7)
    assert blob_p["value_dtype"] == blob_j["value_dtype"]
    assert blob_p["scale_dtype"] == blob_j["scale_dtype"]
    adopted = ref2.adopt_session(blob_p)
    assert ref2.export_session(adopted, length=7) == blob_p
    assert port2.stats["sessions_exported"] == 1
    # the bytes are the pages' own: values and scales, page order kept
    raw = base64.b64decode(blob_p["data"][1]["v"])
    want = port2.buffers[1]["v"].view(torch.uint8)[torch.as_tensor(src2)]
    assert raw == want.numpy().tobytes()


def test_blob_dtype_names_are_numpys():
    names = {}
    for case in POOL_CASES:
        _, port = _pools(case)
        blob = port.export_session(port.alloc(1), length=1)
        names[case] = (blob["value_dtype"], blob["scale_dtype"])
    assert names == {"f32": ("float32", None), "bf16": ("bfloat16", None),
                     "int8": ("int8", "bfloat16"),
                     "fp8": ("float8_e4m3fn", "bfloat16")}


@pytest.mark.parametrize("src_case,dst_case,dst_page", [
    ("f32", "f32", 8), ("int8", "f32", 4), ("f32", "int8", 4),
    ("int8", "fp8", 4), ("bf16", "f32", 4)])
def test_adopt_rejects_layout_mismatch(src_case, dst_case, dst_page):
    ref, port = _pools(src_case)
    blob_j = ref.export_session(ref.alloc(2), length=5)
    blob_p = port.export_session(port.alloc(2), length=5)
    _, dst = _pools(dst_case, page_size=dst_page)
    free = len(dst._free)
    for blob in (blob_j, blob_p):
        with pytest.raises(ValueError, match="layout mismatch"):
            dst.adopt_session(blob)
    assert len(dst._free) == free


def test_adopt_leaks_nothing():
    ref, _ = _pools("int8")
    blob = ref.export_session(ref.alloc(3), length=9)
    _, small = _pools("int8", num_pages=4)
    small.alloc(1)
    free, refs = len(small._free), small._refs.copy()
    with pytest.raises(PoolExhausted):
        small.adopt_session(blob)
    assert len(small._free) == free and np.array_equal(small._refs, refs)
    # a corrupt blob fails after allocating: its pages go back
    _, roomy = _pools("int8")
    bad = dict(blob, data=[dict(e) for e in blob["data"]])
    bad["data"][1]["v_scale"] = base64.b64encode(b"short").decode()
    free = len(roomy._free)
    with pytest.raises(ValueError, match="v_scale"):
        roomy.adopt_session(bad)
    assert len(roomy._free) == free and roomy.pages_in_use == 0


# ---------------------------------------------------------------------------
# the decoder against the JAX engine


def test_cold_restore_from_the_journal_alone(params, tmp_path):
    prompt = np.arange(5, 12, dtype=np.int32)
    want = _ref_tokens(params, prompt, 12)
    jpath = str(tmp_path / "a.journal")
    ja = ServingJournal(jpath, fsync=False)
    ea = _engine(params, journal=ja)
    ra = ea.submit(prompt, 12, session_id="sess-X")
    for _ in range(5):
        ea.step()
    assert ra.tokens and not ra.done       # genuinely mid-decode
    ja.close()                             # the process dies: the journal
    sessions = ServingJournal.scan_sessions(jpath)     # is all that's left
    sess = dict(sessions["sess-X"], id="sess-X")
    assert sess["emitted"] == ra.tokens[:len(sess["emitted"])]
    assert sess["params"]["max_new"] == 12
    jb = ServingJournal(str(tmp_path / "b.journal"), fsync=False)
    eb = _engine(params, journal=jb)
    rb = eb.restore_session(sess)
    assert rb.pre_emitted == sess["emitted"]
    assert _finish(eb, rb) == want
    # the survivor journaled the canonical session, then closed it
    jb.close()
    assert ServingJournal.scan_sessions(str(tmp_path / "b.journal")) == {}


def test_warm_adopt_reprefills_nothing(params):
    prompt = np.arange(3, 10, dtype=np.int32)
    want = _ref_tokens(params, prompt, 10)
    ea = _engine(params)
    ra = ea.submit(prompt, 10)
    for _ in range(4):
        ea.step()
    assert ra.tokens and not ra.done
    ckpt = ea.checkpoint_session(ra)
    assert ckpt["kv"] is not None
    assert ckpt["session"]["emitted"] == ra.tokens
    assert ckpt["kv"]["length"] == prompt.size + len(ra.tokens) - 1
    eb = _engine(params)
    rb = eb.restore_session(ckpt["session"], kv_blob=ckpt["kv"])
    assert _finish(eb, rb) == want
    assert eb.stats["prefills"] == 0 and eb.stats["sessions_adopted"] == 1


def test_double_failover_round_trips(params):
    prompt = np.arange(2, 8, dtype=np.int32)
    want = _ref_tokens(params, prompt, 12)
    ea = _engine(params)
    ra = ea.submit(prompt, 12)
    for _ in range(4):
        ea.step()
    c1 = ea.checkpoint_session(ra)
    eb = _engine(params)
    rb = eb.restore_session(c1["session"], kv_blob=c1["kv"])
    for _ in range(3):
        eb.step()
    c2 = eb.checkpoint_session(rb)
    # canonical: the ORIGINAL prompt and budget, the merged emitted tail
    assert c2["session"]["prompt"] == [int(t) for t in prompt]
    assert c2["session"]["params"]["max_new"] == 12
    ec = _engine(params)
    rc = ec.restore_session(c2["session"], kv_blob=c2["kv"])
    assert _finish(ec, rc) == want
    ed = _engine(params)                   # and the same hop, cold
    rd = ed.restore_session(c2["session"])
    assert _finish(ed, rd) == want


def test_spent_session_restores_completed(params):
    eng = _engine(params)
    req = eng.restore_session({"id": "done", "prompt": [1, 2],
                               "params": {"max_new": 3},
                               "emitted": [4, 5, 6]})
    assert req.done and eng.session_result(req) == [4, 5, 6]
    eos = _engine(params, eos_id=9)
    req = eos.restore_session({"prompt": [1, 2], "params": {"max_new": 8},
                               "emitted": [4, 9]})
    assert req.done and eos.session_result(req) == [4, 9]


def test_warm_adopt_refusals(params):
    eng = _engine(params)
    with pytest.raises(ValueError, match="emitted token"):
        eng.restore_session({"prompt": [1, 2], "params": {"max_new": 4}},
                            kv_blob={"length": 1})
    with pytest.raises(ValueError, match="positions"):
        eng.restore_session({"prompt": [1, 2], "params": {"max_new": 4},
                             "emitted": [3]}, kv_blob={"length": 5})
    draft = ref_tf.init_transformer(REF_CFG, seed=3)
    spec = _engine(params, draft_params=draft, draft_cfg=CFG, gamma=2)
    with pytest.raises(ValueError, match="speculative"):
        spec.restore_session({"prompt": [1, 2], "params": {"max_new": 4},
                              "emitted": [3]}, kv_blob={"length": 2})
    # a speculative engine restores cold, and exports no pages
    prompt = np.arange(4, 9, dtype=np.int32)
    req = spec.restore_session({"prompt": prompt.tolist(),
                                "params": {"max_new": 9},
                                "emitted": _ref_tokens(params, prompt, 9)[:3]})
    assert _finish(spec, req) == _ref_tokens(params, prompt, 9)
    live = spec.submit(prompt, 9)
    spec.step()
    assert spec.checkpoint_session(live)["kv"] is None


def test_jax_checkpoint_restores_on_the_port(params):
    prompt = np.arange(6, 15, dtype=np.int32)
    want = _ref_tokens(params, prompt, 14)
    ref = RefDecoder(params, REF_CFG, max_slots=2, max_len=64)
    live = ref.submit(prompt, 14, session_id="from-jax")
    for _ in range(5):
        ref.step()
    ckpt = ref.checkpoint_session(live)
    assert ckpt["kv"] is not None and not live.done
    warm = _engine(params)
    rw = warm.restore_session(ckpt["session"], kv_blob=ckpt["kv"])
    assert _finish(warm, rw) == want and warm.stats["prefills"] == 0
    cold = _engine(params)
    rc = cold.restore_session(ckpt["session"])
    assert rc.session_id == "from-jax"
    assert _finish(cold, rc) == want


@pytest.mark.parametrize("k,steps", [(1, 5), (4, 2), (3, 1)])
def test_checkpoint_at_and_inside_a_dispatch(params, k, steps):
    """``steps_per_dispatch`` k with blocks still in flight: the
    checkpoint drains them, and the blob's length is prompt + emitted - 1
    whether the last block ended on the request's budget or not."""
    prompt = np.arange(9, 20, dtype=np.int32)
    want = _ref_tokens(params, prompt, 15)
    ea = _engine(params, steps_per_dispatch=k, pipeline_depth=2)
    ra = ea.submit(prompt, 15)
    for _ in range(steps):
        ea.step()
    assert ea._pending or k == 1
    ckpt = ea.checkpoint_session(ra)
    assert not ea._pending and not ra.done
    assert ckpt["kv"]["length"] == prompt.size + len(ra.tokens) - 1
    for kw in ({"kv_blob": ckpt["kv"]}, {}):
        eb = _engine(params, steps_per_dispatch=k)
        rb = eb.restore_session(ckpt["session"], **kw)
        assert _finish(eb, rb) == want


def test_checkpoint_after_compaction(params):
    """Retirements compact the pool (threshold 1): the live session's
    pages move, and the export follows the remapped page list."""
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 128, 20).astype(np.int32)
    want = _ref_tokens(params, prompt, 20)
    ea = _engine(params, max_slots=3, page_size=4, defrag_threshold=1)
    short = [ea.submit(rng.integers(0, 128, 9), 2) for _ in range(2)]
    live = ea.submit(prompt, 20)
    for _ in range(6):
        ea.step()
    assert all(r.done for r in short) and not live.done
    assert ea._kv.stats["defrag_moves"] > 0
    ckpt = ea.checkpoint_session(live)
    eb = _engine(params, page_size=4)
    rb = eb.restore_session(ckpt["session"], kv_blob=ckpt["kv"])
    assert _finish(eb, rb) == want


@pytest.mark.parametrize("k", [1, 3])
def test_sampled_session_resumes_on_schedule(params, k):
    prompt = np.arange(7, 16, dtype=np.int32)
    kw = dict(temperature=0.9, top_k=20, top_p=0.95, seed=1234)
    base = _engine(params, steps_per_dispatch=k)
    want = _finish(base, base.submit(prompt, 12, **kw))
    ea = _engine(params, steps_per_dispatch=k)
    ra = ea.submit(prompt, 12, **kw)
    ea.submit(np.arange(1, 5), 10, temperature=1.0, seed=5)   # a neighbour
    for _ in range(3):
        ea.step()
    ckpt = ea.checkpoint_session(ra)
    assert 0 < len(ckpt["session"]["emitted"]) < 12
    for blob in (ckpt["kv"], None):
        eb = _engine(params, steps_per_dispatch=k)
        rb = eb.restore_session(ckpt["session"], kv_blob=blob)
        assert _finish(eb, rb) == want


def test_bench_failover_configuration(params):
    """bench.py's ``_failover_phase`` on the port's plain path: its own
    config (d_model 64 over 4 heads: head dim 16; 8-token pages; the
    default layer norm), checkpoint after 6 steps, cold and warm restores
    both give the uninterrupted tokens, the warm one with no prefill past
    its priming request."""
    widths = dict(vocab=128, d_model=64, heads=4, layers=2, d_ff=128,
                  max_len=64, causal=True)
    ref_cfg = ref_tf.TransformerConfig(**widths)
    cfg = port_tf.TransformerConfig(**widths)
    assert cfg.d_model // cfg.heads == 16
    p = ref_tf.init_transformer(ref_cfg, 0)
    prompt = np.arange(5, 13, dtype=np.int32)
    ref = RefDecoder(p, ref_cfg, max_slots=2, max_len=64, page_size=8)
    want = _finish(ref, ref.submit(prompt, 16))

    def engine():
        return ContinuousDecoder(p, cfg, device="cpu", max_slots=2,
                                 max_len=64, page_size=8)

    src = engine()
    live = src.submit(prompt, 16)
    for _ in range(6):
        src.step()
    ckpt = src.checkpoint_session(live)
    assert len(ckpt["session"]["emitted"]) == 7     # the prefill's + 6
    assert ckpt["kv"]["n_pages"] == 2 and ckpt["kv"]["length"] == 14
    cold_eng, warm_eng = engine(), engine()
    for e in (cold_eng, warm_eng):
        _finish(e, e.submit(prompt, 2))
    cold = cold_eng.restore_session(ckpt["session"])
    warm = warm_eng.restore_session(ckpt["session"], kv_blob=ckpt["kv"])
    assert _finish(cold_eng, cold) == want
    assert _finish(warm_eng, warm) == want
    assert warm_eng.stats["prefills"] - 1 == 0
