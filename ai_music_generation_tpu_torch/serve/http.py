"""Minimal stdlib HTTP front end for the port's continuous-batching
engines: the port of ``ai_music_generation_tpu/serve/http.py``
(``EngineRunner``, the GPT engine's ``make_handler`` and ``serve``, the
TunesFormer engine's ``make_tunes_handler`` and ``serve_tunes``).

``ThreadingHTTPServer`` handles client connections; one engine thread owns
the model and drives the engine's ``step`` (:class:`GenerationServer` or
:class:`TunesServer`) whenever work is queued. Handler threads block on
per-request events.

Endpoints:
- ``POST /generate``: JSON ``{"prompt": "<text>"}`` (tokenized with the
  checkpoint's codec) or ``{"tokens": [..]}``; optional ``max_new_tokens``,
  ``temperature``, ``top_k``, ``top_p``, ``seed``, ``stop_token``. Returns
  ``{"id", "tokens", "text"}`` when generation finishes. With
  ``"stream": true`` the response is Server-Sent Events instead: one
  ``data: {"tokens": [...], "text": "..."}`` event per engine step that
  produced tokens for this request (``ticks_per_call`` decode ticks, the
  engine's host round trip), then a final
  ``data: {"done": true, "id": ..., "tokens": all, "text": all}`` event.
- ``GET /health``: ``{"slots", "active", "queued"}``, the step phases, the
  latency percentiles and, after a crash, ``engine_error``.

The TunesFormer handler takes ``{"prompt": "<ABC text>"}`` with optional
``max_patch``, ``top_p``, ``top_k``, ``temperature``, ``seed``,
``show_control_code`` and returns ``{"id", "text"}`` (no streaming).

The engine's determinism contract means a request's output depends only on
its own fields (prompt, seed, sampling parameters), never on concurrent
traffic.
"""

from __future__ import annotations

import json
import queue as _queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from ai_music_generation_tpu_torch.serve.engine import GenerationServer, Request
from ai_music_generation_tpu_torch.serve.tunes_engine import (
    TunesServer,
    TuneRequest,
)


class EngineRunner:
    """Owns the engine on one thread; hands out completion events. The
    engine is a :class:`GenerationServer` (token prompts in, tokens out) or
    a :class:`TunesServer` (ABC text in, text out)."""

    def __init__(self, engine: GenerationServer | TunesServer):
        self.engine = engine
        self.error: Optional[str] = None  # set once if the engine thread dies
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._events: dict[int, threading.Event] = {}
        self._results: dict[int, Request] = {}
        # rid -> [request, n_tokens_pushed, SimpleQueue] for streaming
        # consumers; fed by _loop after every engine step
        self._streams: dict[int, list] = {}
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, prompt_tokens, want_stream: bool = False, **kw) -> int:
        with self._lock:
            # checked under the lock (and set under it in _loop): a submit
            # racing the crash handler either registers before the handler
            # fails all pending events, or sees error set and fails fast —
            # never an orphaned event that waits out the full client timeout
            if self.error is not None:
                raise RuntimeError(f"engine thread dead: {self.error}")
            rid = self.engine.submit(prompt_tokens, **kw)
            self._events[rid] = threading.Event()
            if want_stream:
                # registered under the SAME lock as engine.submit: the
                # engine loop's post-step handoff also takes this lock, so
                # no step's demux can slip between submit and registration
                # — chunk boundaries are exactly one-per-engine-step
                self._streams[rid] = [self.engine._live[rid], 0,
                                      _queue.SimpleQueue()]
        self._wake.set()
        return rid

    def wait(self, rid: int, timeout: Optional[float] = None
             ) -> Optional[Request | TuneRequest]:
        ev = self._events[rid]
        if not ev.wait(timeout):
            # abandon: cancel engine-side and drop any bookkeeping so a
            # timed-out request can never leak its event/result entries
            # (the engine may have finished it between wait() expiring and
            # the lock being taken — discard that result too)
            self._abandon(rid)
            return None
        with self._lock:
            self._events.pop(rid, None)
            return self._results.pop(rid)

    def stream(self, rid: int, timeout: Optional[float] = None):
        """Incremental view of a request submitted with ``want_stream``:
        yields ``(new_tokens, finished_request_or_None)`` chunks as the
        engine loop pushes them — exactly one chunk per engine step that
        demuxed tokens for this request (the step is the engine's
        ``ticks_per_call``-tick host round-trip, i.e. the true streaming
        granularity of the device program) — ending with ``([], request)``.
        On engine death raises RuntimeError; on timeout cancels the
        request and raises TimeoutError."""
        import time as _time

        with self._lock:
            entry = self._streams.get(rid)
        if entry is None:
            raise KeyError(f"request {rid} was not submitted with "
                           "want_stream=True (or already consumed)")
        q = entry[2]
        deadline = None if timeout is None else _time.perf_counter() + timeout
        try:
            while True:
                remaining = (None if deadline is None
                             else max(0.0, deadline - _time.perf_counter()))
                try:
                    kind, val = q.get(timeout=remaining)
                except _queue.Empty:
                    raise TimeoutError(f"request {rid} timed out") from None
                if kind == "chunk":
                    yield val, None
                elif kind == "done":
                    yield [], val
                    return
                else:  # "error"
                    raise RuntimeError(f"engine thread dead: {val}")
        finally:
            # abandoned mid-stream (client disconnect, timeout, engine
            # death, or a dropped generator): release bookkeeping + cancel
            with self._lock:
                self._streams.pop(rid, None)
            if rid in self._events:
                self._abandon(rid)

    def _abandon(self, rid: int) -> None:
        """Drop a request's event/result bookkeeping and cancel it
        engine-side (wait() timeout, stream() timeout, or a streaming
        client that disconnected mid-generation)."""
        with self._lock:
            self._events.pop(rid, None)
            self._results.pop(rid, None)
            cancel = getattr(self.engine, "cancel", None)
            if cancel is not None:
                cancel(rid)

    def stats(self) -> dict:
        e = self.engine
        out = {
            "slots": e.n_slots,
            "active": sum(r is not None for r in e._slots),
            "queued": len(e._queue),
        }
        phases = getattr(e, "stats", None)
        if phases:  # per-phase wall-time accounting
            out["phases"] = {k: (round(v, 3) if isinstance(v, float) else v)
                             for k, v in phases.items()}
        if hasattr(e, "latency_stats"):
            out["latency"] = e.latency_stats()
        if self.error is not None:
            out["engine_error"] = self.error
        return out

    def shutdown(self):
        """Stop the engine thread; a sharded engine's followers get the
        stop packet."""
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=30)
        if not self._thread.is_alive():
            self.engine.shutdown()

    def _loop(self):
        while not self._stop:
            if not self.engine.busy:
                self._wake.wait(timeout=0.5)
                self._wake.clear()
                continue
            try:
                # step() runs OUTSIDE the lock: the engines document that
                # submit/cancel from producer threads are safe against a
                # concurrent engine thread (atomic deque/dict ops), and a
                # step takes up to a full scan (seconds at large slot
                # counts) — holding the lock across it would block every
                # /generate submit for that long. Only the event/result
                # handoff needs the lock. A request submitted mid-step is
                # registered in _events under the same lock acquisition as
                # engine.submit, so the handoff below can never see a
                # finished request before its event exists.
                finished = self.engine.step()
                with self._lock:
                    for req in finished:
                        ev = self._events.get(req.id)
                        if ev is None:
                            continue  # abandoned (wait() timed out) — drop
                        self._results[req.id] = req
                        ev.set()
                    for rid, entry in list(self._streams.items()):
                        req, sent, q = entry
                        n = len(req.generated)
                        if n > sent:
                            q.put(("chunk", list(req.generated[sent:n])))
                            entry[1] = n
                        if req.done:
                            q.put(("done", req))
                            # the stream consumed this request: drop the
                            # wait()-side bookkeeping too
                            del self._streams[rid]
                            self._events.pop(rid, None)
                            self._results.pop(rid, None)
            except Exception as exc:  # noqa: BLE001 — engine thread must not
                # die silently: fail every pending waiter (they return 500
                # instead of hanging to 504) and mark the engine dead so
                # /health reports it.
                with self._lock:
                    self.error = f"{type(exc).__name__}: {exc}"
                    for rid, ev in list(self._events.items()):
                        self._results.setdefault(rid, None)  # None = engine error
                        ev.set()
                    for entry in self._streams.values():
                        entry[2].put(("error", self.error))
                    self._streams.clear()
                return


def _make_base_handler(runner: EngineRunner, submit_fn, respond_fn,
                       chunk_fn=None):
    """Shared HTTP scaffold of the engines: /health GET, /generate POST
    with submit -> wait -> 504-on-timeout -> JSON response. ``submit_fn``
    maps the request payload to a request id; ``respond_fn`` maps a
    finished Request to the response dict. ``chunk_fn`` (optional) maps an
    incremental token chunk to a streamed-event dict — when provided,
    ``"stream": true`` payloads get a Server-Sent-Events response."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _sse(self, rid: int, timeout: float):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            try:
                for chunk, done in runner.stream(rid, timeout=timeout):
                    obj = (respond_fn(done) | {"done": True}) if done \
                        else chunk_fn(chunk)
                    self.wfile.write(
                        b"data: " + json.dumps(obj).encode() + b"\n\n")
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                runner._abandon(rid)  # client left mid-stream: stop paying
            except TimeoutError:
                pass  # stream() already cancelled; the socket just closes

        def do_GET(self):
            if self.path == "/health":
                self._json(200, runner.stats())
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(n) or b"{}")
                if payload.get("stream") and chunk_fn is None:
                    self._json(400, {"error": "streaming not supported "
                                              "for this engine"})
                    return
                rid = submit_fn(payload)
                if payload.get("stream"):
                    self._sse(rid, timeout=float(payload.get("timeout", 600)))
                    return
                req = runner.wait(rid, timeout=float(payload.get("timeout", 600)))
                if req is None:
                    if runner.error is not None:
                        self._json(500, {"error": f"engine thread dead: "
                                                  f"{runner.error}", "id": rid})
                    else:
                        self._json(504, {"error": "generation timed out",
                                         "id": rid})
                    return
                self._json(200, respond_fn(req))
            except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
                # malformed payload / invalid params -> client error
                self._json(400, {"error": str(e)})
            except RuntimeError as e:
                # engine thread dead (runner.submit raises) -> service down,
                # NOT the client's fault: 503 so load balancers retry/alert
                self._json(503, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — serve errors as JSON
                self._json(500, {"error": str(e)})

    return Handler


def make_handler(runner: EngineRunner,
                 encode: Callable[[str], list],
                 decode: Callable[[list], str]):
    """GPT engine handler: token- or text-prompt in, tokens + text out."""

    def submit(payload):
        if "tokens" in payload:
            prompt = [int(t) for t in payload["tokens"]]
        else:
            prompt = list(encode(payload["prompt"]))
        return runner.submit(
            prompt,
            want_stream=bool(payload.get("stream", False)),
            max_new_tokens=int(payload.get("max_new_tokens", 500)),
            temperature=float(payload.get("temperature", 0.8)),
            top_k=int(payload.get("top_k", 200)),
            top_p=float(payload.get("top_p", 1.0)),
            seed=int(payload.get("seed", 1337)),
            stop_token=int(payload.get("stop_token", -1)),
        )

    def respond(req):
        return {"id": req.id, "tokens": req.generated,
                "text": decode(req.generated)}

    def chunk(tokens):
        return {"tokens": tokens, "text": decode(tokens)}

    return _make_base_handler(runner, submit, respond, chunk_fn=chunk)


def serve(runner: EngineRunner, encode, decode, host: str = "127.0.0.1",
          port: int = 8000) -> ThreadingHTTPServer:
    """Build (and return) the HTTP server; caller runs ``serve_forever``."""
    handler = make_handler(runner, encode, decode)
    return ThreadingHTTPServer((host, port), handler)


def make_tunes_handler(runner: EngineRunner):
    """TunesServer handler: ABC text in, text out, with the TunesFormer
    sampling parameters (the reference generate CLI's flags)."""

    def submit(payload):
        return runner.submit(
            payload["prompt"],
            max_patch=int(payload.get("max_patch", 128)),
            top_p=float(payload.get("top_p", 0.8)),
            top_k=int(payload.get("top_k", 8)),
            temperature=float(payload.get("temperature", 1.2)),
            seed=int(payload.get("seed", 0)),
            show_control_code=bool(payload.get("show_control_code", True)),
        )

    return _make_base_handler(
        runner, submit, lambda req: {"id": req.id, "text": req.text})


def serve_tunes(runner: EngineRunner, host: str = "127.0.0.1",
                port: int = 8000) -> ThreadingHTTPServer:
    """Build (and return) the HTTP server over a TunesServer engine; the
    caller runs ``serve_forever``."""
    return ThreadingHTTPServer((host, port), make_tunes_handler(runner))
