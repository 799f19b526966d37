"""Port parity: the durable serving journal (``serving/journal.py``).

The port writes the reference's record format byte for byte, so either
package replays the other's file: the same calls give the same bytes, a
journal written by one replays identically through the other
(``replay``, ``scan_sessions``, ``replay_sessions``), a torn tail is
repaired the same way, compaction keeps the same lines, and appends
after ``close`` are dropped (or raise, write-ahead) the same way.
"""

import json
import warnings

import pytest
import torch

from mmlspark_tpu.io.http import schema as ref_schema
from mmlspark_tpu.serving.journal import ServingJournal as RefJournal
from mmlspark_tpu_torch.io.http import schema as port_schema
from mmlspark_tpu_torch.serving.journal import ServingJournal as PortJournal

torch.set_num_threads(1)  # one a worker: README, "Testing & benchmarks"

PACKAGES = {"jax": (RefJournal, ref_schema), "port": (PortJournal,
                                                      port_schema)}


def _request(schema, body: str, url: str = "/generate"):
    return schema.HTTPRequestData(
        url=url, method="POST",
        headers=[schema.HeaderData("Content-Type", "application/json"),
                 schema.HeaderData("X-Mmlspark-Tenant", "team-a")],
        entity=schema.EntityData.from_string(body))


def _write(cls, schema, path, n_tail=3):
    """One fixed sequence of every record type through ``cls``."""
    j = cls(path, fsync=False)
    j.record_request("r1", 0, _request(schema, '{"tokens": [1, 2]}'))
    j.record_request("r2", 0, _request(schema, '{"tokens": [3]}', "/x"))
    j.record_reply("r1")
    j.record_epoch(1)
    j.record_request("r3", 1, _request(schema, '{"q": 7}'))
    j.record_session("s1", [5, 6, 7], {"max_new": 8, "temperature": 0.5,
                                       "top_k": 0, "top_p": 1.0, "seed": 3,
                                       "prefix_key": None,
                                       "prefix_len": None}, phash="ab" * 20)
    for k in range(n_tail):
        j.record_session_tokens("s1", [10 + k, 20 + k])
    j.record_session("s2", [1], {"max_new": 4})
    j.record_session_tokens("s2", [9])
    j.record_session_end("s2")
    j.record_session("s3", [4, 4], {"max_new": 2})
    j.record_session_tokens("s3", [])          # empty tails write nothing
    return j


def _replayed(cls, path):
    j = cls(path, fsync=False)
    epoch, pending = j.replay()
    pend = {rid: (e, r.to_dict()) for rid, (e, r) in pending.items()}
    live = j.replay_sessions()
    digest = j.digest()
    j.close()
    return {"epoch": epoch, "pending": pend, "scan": cls.scan_sessions(path),
            "replay_sessions": live,
            "digest": {k: digest[k] for k in ("live_sessions", "closed")}}


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_journal_replays_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / "w.journal")
    wcls, wschema = PACKAGES[writer]
    _write(wcls, wschema, path).close()
    got = _replayed(PACKAGES[reader][0], path)
    want = _replayed(wcls, path)
    assert got == want
    assert got["epoch"] == 1 and set(got["pending"]) == {"r2", "r3"}
    assert set(got["scan"]) == {"s1", "s3"}
    assert got["scan"]["s1"]["emitted"] == [10, 20, 11, 21, 12, 22]


def test_same_calls_write_the_same_bytes(tmp_path):
    paths = {}
    for name, (cls, schema) in PACKAGES.items():
        paths[name] = str(tmp_path / f"{name}.journal")
        _write(cls, schema, paths[name]).close()
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_torn_tail_repaired_the_same_way(tmp_path, writer):
    """A crash mid-append leaves a half-written last line: every record
    before it scans in both packages, and reopening (either package)
    terminates it so later appends stay parseable."""
    files = {}
    for opener in ("jax", "port"):
        path = str(tmp_path / f"{writer}-{opener}.journal")
        wcls, wschema = PACKAGES[writer]
        _write(wcls, wschema, path, n_tail=1).close()
        with open(path, "a") as fh:
            fh.write('{"t": "tail", "id": "s1", "toks": [99')   # torn
        for cls, _ in PACKAGES.values():
            assert cls.scan_sessions(path)["s1"]["emitted"] == [10, 20]
        j = PACKAGES[opener][0](path, fsync=False)
        j.record_session_tokens("s1", [30])
        j.close()
        for cls, _ in PACKAGES.values():
            assert cls.scan_sessions(path)["s1"]["emitted"] == [10, 20, 30]
        files[opener] = open(path, "rb").read()
    assert files["jax"] == files["port"]


def test_compaction_keeps_the_same_lines(tmp_path):
    out = {}
    for name, (cls, schema) in PACKAGES.items():
        path = str(tmp_path / f"{name}.journal")
        j = _write(cls, schema, path, n_tail=300)
        assert not j.maybe_compact(epoch=2, min_lines=10_000)
        assert j.maybe_compact(epoch=2, min_lines=64)
        j.record_session_tokens("s1", [77])
        j.close()
        with open(path) as fh:
            out[name] = fh.read()
    assert out["jax"] == out["port"]
    recs = [json.loads(line) for line in out["port"].splitlines()]
    assert [r["t"] for r in recs] == ["epoch", "req", "req", "sess", "tail",
                                      "sess", "tail"]
    emitted = PortJournal.scan_sessions(str(tmp_path / "port.journal"))
    assert emitted["s1"]["emitted"][-3:] == [309, 319, 77]


@pytest.mark.parametrize("name", ["jax", "port"])
def test_appends_after_close(tmp_path, name):
    """Reply, epoch, tail and end records are dropped with a warning after
    ``close``; request and session records raise (write-ahead: a request
    that cannot be journaled must fail, not run unrecoverable)."""
    cls, schema = PACKAGES[name]
    j = cls(str(tmp_path / "j.journal"), fsync=False)
    j.record_epoch(1)
    j.close()
    assert j.closed
    for call in (lambda: j.record_reply("x"), lambda: j.record_epoch(2),
                 lambda: j.record_session_tokens("s", [1]),
                 lambda: j.record_session_end("s")):
        with pytest.warns(RuntimeWarning):
            call()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(ValueError):
            j.record_request("r", 0, _request(schema, "{}"))
        with pytest.raises(ValueError):
            j.record_session("s", [1], {"max_new": 1})
    with open(str(tmp_path / "j.journal")) as fh:
        assert fh.read() == '{"t":"epoch","n":1}\n'
