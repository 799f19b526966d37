"""HTTP generation endpoint over the continuous-batching decoder
(counterpart of ``serving/generation.py:47-217``).

Clients POST ``{"tokens": [...], "max_new": N}`` and get ``{"tokens":
[...]}`` back; ``"stream": true`` opens a Server-Sent-Events reply that
carries each tick's new tokens and a final ``{"done": true, "tokens":
[...]}`` event. One engine thread owns the decoder: each loop admits new
HTTP requests, runs one engine tick, pushes stream events and answers the
finished requests. A request is submitted under its root span, so the
decoder bills its device time and KV pages to the request's class and
records its prefill chunks in the request's trace.

On a mesh (``mesh=``) every rank builds the engine over the same mesh
and calls :meth:`GenerationEngine.start` and
:meth:`GenerationEngine.stop`. The JAX engine passes the mesh on to one
program; the port runs one process per rank, and every rank's decoder
must take the same submissions and the same steps. So the world's rank
0 decides: it owns the :class:`WorkerServer`, the replies and the
streams, submits each new request to its own decoder first (a request
it refuses is answered 400 there and goes no further), and before each
engine tick broadcasts the submissions its decoder accepted (prompt
tokens already int32, ``max_new_tokens``, sampling parameters, prefix
key) and the stop. The other ranks run a follower loop that applies
the message, then steps. A failed tick on any rank ends serving for
the whole world, since the ranks could no longer step together: rank 0
answers what is in flight with 500 and broadcasts the end, a follower
leaves its loop, and every rank's :meth:`GenerationEngine.stop` raises
the failure (:attr:`GenerationEngine.error`).
"""

from __future__ import annotations

import json
import logging
import threading
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from ..observability import tracing as _tracing
from ..parallel.distributed import broadcast_object, world_info
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
    the CUDA card (and raises without one). ``mesh`` serves on a mesh
    (the module docstring): rank 0 of the world owns the HTTP front and
    :attr:`address`, which is None on the other ranks. ``draft_params``,
    ``draft_cfg``, ``gamma``, ``autotune`` and ``prefill_ahead`` go to
    the decoder (speculative decoding, the autotuner, prefill-ahead
    staging); ``transport`` (``"threaded"`` or ``"async"``) to the
    :class:`WorkerServer`."""

    def __init__(self, params, cfg, *, device=None, max_slots: int = 4,
                 max_len: int = 256, eos_id: Optional[int] = None,
                 default_max_new: int = 32,
                 host: str = "127.0.0.1", port: int = 0,
                 api_path: str = "/generate",
                 reply_timeout: float = 120.0,
                 transport: str = "threaded",
                 steps_per_dispatch: int = 1,
                 pipeline_depth: int = 2,
                 prefill_ahead: int = 0,
                 draft_params=None, draft_cfg=None, gamma: int = 4,
                 page_size: int = 16, prefill_chunk: int = 256,
                 kv_pages: Optional[int] = None, autotune: bool = False,
                 mesh=None):
        self.decoder = ContinuousDecoder(
            params, cfg, device=device, max_slots=max_slots,
            max_len=max_len, eos_id=eos_id,
            steps_per_dispatch=steps_per_dispatch,
            pipeline_depth=pipeline_depth, prefill_ahead=prefill_ahead,
            draft_params=draft_params, draft_cfg=draft_cfg, gamma=gamma,
            page_size=page_size, prefill_chunk=prefill_chunk,
            kv_pages=kv_pages, autotune=autotune, mesh=mesh)
        self.default_max_new = int(default_max_new)
        self._mesh = mesh
        #: this process owns the HTTP front: always off a mesh, rank 0 of
        #: the world on one
        self.leader = mesh is None or world_info()["process_index"] == 0
        self.server = (WorkerServer(host, port, api_path,
                                    reply_timeout=reply_timeout,
                                    transport=transport)
                       if self.leader else None)
        #: decoder rid -> _InFlight
        self._inflight: Dict[int, _InFlight] = {}
        self._stop = threading.Event()
        #: what ended serving on a mesh (a failed tick on this rank or rank
        #: 0's); :meth:`stop` raises it
        self.error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Optional[str]:
        """The front's URL (None on a follower rank)."""
        if self.server is None:
            return None
        return self.server.address.rstrip("/") + "/"

    def start(self) -> "GenerationEngine":
        name = (f"generation-engine-{self.server.port}" if self.leader
                else "generation-engine-follower")
        self._thread = threading.Thread(
            target=self._loop if self.leader else self._follow,
            daemon=True, name=name)
        self._thread.start()
        return self

    def _parse(self, cached) -> Optional[tuple]:
        """One request's body → (the decoder's ``submit`` keywords, whether
        it streams), or None after a 400. Token ids must fit int32: they
        are converted here, once, and the followers get the converted
        array."""
        try:
            ent = cached.request.entity
            body = json.loads(ent.string_content()) if ent else {}
            toks = body.get("tokens")
            if not toks:
                raise ValueError("missing or empty 'tokens'")
            ids = np.asarray(toks, np.int64).reshape(-1)
            lim = np.iinfo(np.int32)
            if ids.min() < lim.min or ids.max() > lim.max:
                raise ValueError("token ids must fit int32")
            pl = body.get("prefix_len")
            sub = {"prompt_ids": ids.astype(np.int32),
                   "max_new_tokens": int(body.get("max_new",
                                                  self.default_max_new)),
                   "temperature": float(body.get("temperature", 0.0)),
                   "top_k": int(body.get("top_k", 0)),
                   "top_p": float(body.get("top_p", 1.0)),
                   "seed": int(body.get("seed", 0)),
                   "prefix_key": body.get("prefix_key"),
                   "prefix_len": int(pl) if pl is not None else None}
            return sub, bool(body.get("stream", False))
        except Exception as e:
            self.server.reply_json(cached.request_id, {"error": str(e)},
                                   status=400)
            return None

    def _admit_http(self, idle: bool) -> list:
        """Parse and submit the new HTTP requests: each ticket is parked,
        under the request's root span, or a refused request answered 400.
        Returns the submissions the decoder accepted, in order."""
        # mid-stream the poll does not block: its timeout would add to
        # every emitted token's latency; only an idle engine waits
        accepted = []
        for cached in self.server.get_batch(64, timeout=0.002 if idle else 0):
            parsed = self._parse(cached)
            if parsed is None:
                continue
            sub, stream = parsed
            rid = cached.request_id
            try:
                # the decoder captures its cost class, trace id and span
                # at submit
                with _tracing.activate(cached.trace_span):
                    ticket = self.decoder.submit(**sub)
            except Exception as e:
                self.server.reply_json(rid, {"error": str(e)}, status=400)
                continue
            accepted.append(sub)
            handle = self.server.reply_stream(rid) if stream else None
            self._inflight[ticket.rid] = _InFlight(rid, ticket, handle)
        return accepted

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
        """The leader's loop: admit the HTTP requests, tell the followers
        what was admitted (on a mesh), step, answer. Off a mesh a failed
        tick fails what is in flight and serving goes on; on a mesh it
        ends serving on every rank (the module docstring)."""
        self.decoder.bind_thread()
        while True:
            stop = self._stop.is_set()
            telling = False
            try:
                subs = [] if stop else self._admit_http(
                    idle=not self._inflight)
                telling = True
                self._tell({"subs": subs, "stop": stop, "failed": False})
                telling = False
                if stop:
                    return
                stepped = self.decoder.step()
                self._pump_streams()
                self._reply_finished()
                if stepped == 0 and not self._inflight:
                    self._stop.wait(0.005)
            except Exception as e:
                _log.exception("generation engine tick failed")
                # fail every in-flight request rather than hang clients
                self._fail_inflight("internal error", 500)
                if self._mesh is not None:
                    self.error = e
                    if not telling:     # else the exchange itself failed
                        try:
                            self._tell({"subs": [], "stop": True,
                                        "failed": True})
                        except Exception:
                            _log.exception("could not tell the followers")
                    return
                try:
                    self.decoder.cancel_all()
                except Exception:
                    _log.exception("decoder cancel_all failed")
                self._stop.wait(0.2)

    def _tell(self, msg: dict) -> None:
        """Broadcast this tick's message to the followers (on a mesh)."""
        if self._mesh is not None:
            broadcast_object(msg)

    def _follow(self) -> None:
        """A follower rank's loop: apply rank 0's message (the submissions
        its decoder accepted), step, until the stop. Any failure here, or
        rank 0's, ends the loop with :attr:`error` set: a follower that
        skipped a submission or a step would leave the ranks' schedulers
        apart and their collectives unmatched."""
        self.decoder.bind_thread()
        try:
            while True:
                msg = broadcast_object(None)
                if msg["failed"]:
                    raise RuntimeError("rank 0's generation tick failed; "
                                       "the mesh stopped serving")
                if msg["stop"]:
                    return
                for sub in msg["subs"]:
                    self.decoder.submit(**sub)
                self.decoder.step()
        except Exception as e:
            _log.exception("generation engine follower stopped")
            self.error = e

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
        """Stop serving. On a mesh the leader broadcasts the stop, and a
        follower waits here until it arrives (every rank calls this);
        then raises :attr:`error` where a failed tick ended serving."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10 if self.leader else None)
        if self.leader:
            self._fail_inflight("server shutting down", 503)
        self.decoder.cancel_all()
        self.decoder.stop()
        if self.server is not None:
            self.server.close()
        if self.error is not None:
            raise RuntimeError("serving on the mesh failed") from self.error

    def __enter__(self) -> "GenerationEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
