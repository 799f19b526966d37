"""HTTP generation endpoint over the continuous-batching decoder
(counterpart of ``serving/generation.py:47-217``).

Clients POST ``{"tokens": [...], "max_new": N}`` and get ``{"tokens":
[...]}`` back; ``"stream": true`` opens a Server-Sent-Events reply that
carries each tick's new tokens and a final ``{"done": true, "tokens":
[...]}`` event. One engine thread owns the decoder: each loop admits new
HTTP requests, runs one engine tick, pushes stream events and answers the
finished requests.
"""

from __future__ import annotations

import json
import logging
import threading
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from .continuous import ContinuousDecoder
from .server import StreamingReply, WorkerServer

__all__ = ["GenerationEngine"]

_log = logging.getLogger("mmlspark_tpu_torch.serving")


@dataclass
class _InFlight:
    """One parked generation: the server request, the decoder ticket, an
    open SSE stream when asked for, and how many tokens it has sent."""
    rid: str
    ticket: object
    stream: Optional[StreamingReply] = None
    sent: int = 0


class GenerationEngine:
    """Serve ``{"tokens": [...], "max_new": N}`` → ``{"tokens": [...]}``
    over a :class:`ContinuousDecoder` slot pool. ``device=None`` means
    the CUDA card (and raises without one). ``mesh`` must be None: a
    meshed front needs rank 0 to broadcast its submissions to the other
    ranks, which is not ported (ROADMAP.md, 'Slice 6 leftovers'); drive
    a meshed ``ContinuousDecoder`` on every rank instead."""

    def __init__(self, params, cfg, *, device=None, max_slots: int = 4,
                 max_len: int = 256, eos_id: Optional[int] = None,
                 default_max_new: int = 32,
                 host: str = "127.0.0.1", port: int = 0,
                 api_path: str = "/generate",
                 reply_timeout: float = 120.0,
                 steps_per_dispatch: int = 1,
                 pipeline_depth: int = 2,
                 page_size: int = 16, prefill_chunk: int = 256,
                 kv_pages: Optional[int] = None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "GenerationEngine(mesh=) is not ported to mmlspark_tpu_torch "
                "yet (queued in ROADMAP.md, 'Slice 6 leftovers')")
        self.decoder = ContinuousDecoder(
            params, cfg, device=device, max_slots=max_slots,
            max_len=max_len, eos_id=eos_id,
            steps_per_dispatch=steps_per_dispatch,
            pipeline_depth=pipeline_depth, page_size=page_size,
            prefill_chunk=prefill_chunk, kv_pages=kv_pages)
        self.default_max_new = int(default_max_new)
        self.server = WorkerServer(host, port, api_path,
                                   reply_timeout=reply_timeout)
        #: decoder rid -> _InFlight
        self._inflight: Dict[int, _InFlight] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        return self.server.address.rstrip("/") + "/"

    def start(self) -> "GenerationEngine":
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"generation-engine-{self.server.port}")
        self._thread.start()
        return self

    def _admit_one(self, cached) -> None:
        """Parse + submit ONE request; any failure 400s only that request."""
        rid = cached.request_id
        try:
            ent = cached.request.entity
            body = json.loads(ent.string_content()) if ent else {}
            toks = body.get("tokens")
            if not toks:
                raise ValueError("missing or empty 'tokens'")
            mn = int(body.get("max_new", self.default_max_new))
            pl = body.get("prefix_len")
            stream = bool(body.get("stream", False))
            ticket = self.decoder.submit(
                np.asarray(toks, np.int32), mn,
                temperature=float(body.get("temperature", 0.0)),
                top_k=int(body.get("top_k", 0)),
                top_p=float(body.get("top_p", 1.0)),
                seed=int(body.get("seed", 0)),
                prefix_key=body.get("prefix_key"),
                prefix_len=int(pl) if pl is not None else None)
        except Exception as e:
            self.server.reply_json(rid, {"error": str(e)}, status=400)
            return
        handle = self.server.reply_stream(rid) if stream else None
        self._inflight[ticket.rid] = _InFlight(rid, ticket, handle)

    def _admit_http(self, idle: bool) -> None:
        # mid-stream the poll does not block: its timeout would add to
        # every emitted token's latency; only an idle engine waits
        for cached in self.server.get_batch(64, timeout=0.002 if idle else 0):
            self._admit_one(cached)

    def _pump_streams(self) -> None:
        """Push newly emitted tokens on every streaming reply."""
        for f in self._inflight.values():
            if f.stream is None:
                continue
            fresh = f.ticket.tokens[f.sent:]
            if fresh:
                f.stream.send_event({"tokens": list(fresh)})
                f.sent += len(fresh)

    def _reply_finished(self) -> None:
        done = [drid for drid, f in self._inflight.items() if f.ticket.done]
        for drid in done:
            f = self._inflight.pop(drid)
            err = f.ticket.error
            if f.stream is not None:
                if err is not None:
                    f.stream.send_event({"error": str(err)})
                else:
                    f.stream.send_event({"done": True,
                                         "tokens": list(f.ticket.tokens)})
                f.stream.close()
            elif err is not None:
                self.server.reply_json(f.rid, {"error": str(err)}, status=400)
            else:
                self.server.reply_json(f.rid, {"tokens": f.ticket.tokens})
        if done:
            self.server.commit_epoch()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._admit_http(idle=not self._inflight)
                stepped = self.decoder.step()
                self._pump_streams()
                self._reply_finished()
                if stepped == 0 and not self._inflight:
                    self._stop.wait(0.005)
            except Exception:
                _log.exception("generation engine tick failed")
                # fail every in-flight request rather than hang clients,
                # and free the slot pool
                self._fail_inflight("internal error", 500)
                try:
                    self.decoder.cancel_all()
                except Exception:
                    _log.exception("decoder cancel_all failed")
                self._stop.wait(0.2)

    def _fail_inflight(self, message: str, status: int) -> None:
        for f in self._inflight.values():
            if f.stream is not None:
                f.stream.send_event({"error": message})
                f.stream.close()
            else:
                self.server.reply_json(f.rid, {"error": message},
                                       status=status)
        self._inflight.clear()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._fail_inflight("server shutting down", 503)
        self.decoder.cancel_all()
        self.decoder.stop()
        self.server.close()

    def __enter__(self) -> "GenerationEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
