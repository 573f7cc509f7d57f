"""Asyncio streaming front door (port of
``repro/serving/frontdoor/server.py``; ``asyncio`` + raw HTTP/1.1, numpy
for the prompt).

Endpoints
---------

``POST /v1/generate``
    Body: ``{"prompt": [ints], "max_new_tokens": 16, "slo_class":
    "default", "stream": false, "deadline_s": null, "ttft_deadline_s":
    null}``.  Non-streaming replies with one JSON object once the
    request reaches a terminal state.  With ``"stream": true`` the reply
    is ``text/event-stream``: one ``data: {"token": t, "index": i}``
    event per token as it commits, then a final ``data: {"done": true,
    ...}`` event.  A client that disconnects mid-stream maps onto the
    engine's existing cancellation lifecycle (``engine.cancel`` → next
    sweep evicts the request and frees its slot/blocks) — disconnects
    cost capacity for at most one sweep interval, never leak it.

``GET /healthz``
    ``{"ok": true}`` liveness probe.

``GET /v1/stats``
    Router + per-replica load/cost/prefix-cache gauges (JSON).

Responses are ``Connection: close`` framed (body ends when the socket
does) — no chunked encoding, so the tiny test client stays a plain
socket reader.

:class:`FrontDoor` bundles replicas + router + server and runs the
asyncio event loop on a background thread, giving tests and benchmarks a
synchronous ``start()``/``stop()`` surface.
"""

from __future__ import annotations

import asyncio
import json
import threading
from typing import Optional, Sequence

import numpy as np

from repro_torch.serving.frontdoor.replica import Replica
from repro_torch.serving.frontdoor.router import Router
from repro_torch.serving.queue import Request

_MAX_HEADER = 64 * 1024
_MAX_BODY = 16 * 1024 * 1024


def _response(status: str, body: bytes,
              content_type: str = "application/json") -> bytes:
    return (f"HTTP/1.1 {status}\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n\r\n").encode() + body


def _json_response(status: str, obj) -> bytes:
    return _response(status, json.dumps(obj).encode())


def _sse_event(obj) -> bytes:
    return b"data: " + json.dumps(obj).encode() + b"\n\n"


class HttpError(Exception):
    def __init__(self, status: str, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class FrontDoorServer:
    """The asyncio server proper (runs inside an existing event loop)."""

    def __init__(self, router: Router, *, host: str = "127.0.0.1",
                 port: int = 0):
        self.router = router
        self.host = host
        self.port = port          # 0 = ephemeral; real port set at start
        self._server: Optional[asyncio.base_events.Server] = None

    async def start(self) -> int:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self):
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    # -- request plumbing ---------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter):
        try:
            try:
                method, path, body = await self._read_request(reader)
            except HttpError as e:
                writer.write(_json_response(e.status, {"error": e.message}))
                await writer.drain()
                return
            try:
                await self._dispatch(method, path, body, reader, writer)
            except HttpError as e:
                writer.write(_json_response(e.status, {"error": e.message}))
                await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _read_request(self, reader):
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except asyncio.LimitOverrunError:
            raise HttpError("431 Request Header Fields Too Large",
                            "header block too large")
        if len(head) > _MAX_HEADER:
            raise HttpError("431 Request Header Fields Too Large",
                            "header block too large")
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, path, _ = lines[0].split(" ", 2)
        except ValueError:
            raise HttpError("400 Bad Request", "malformed request line")
        headers = {}
        for line in lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        length = int(headers.get("content-length", "0") or "0")
        if length > _MAX_BODY:
            raise HttpError("413 Payload Too Large", "body too large")
        body = await reader.readexactly(length) if length else b""
        return method.upper(), path, body

    async def _dispatch(self, method, path, body, reader, writer):
        if method == "GET" and path == "/healthz":
            writer.write(_json_response("200 OK", {"ok": True}))
            await writer.drain()
        elif method == "GET" and path == "/v1/stats":
            writer.write(_json_response("200 OK", self.router.stats()))
            await writer.drain()
        elif method == "POST" and path == "/v1/generate":
            await self._generate(body, reader, writer)
        else:
            raise HttpError("404 Not Found", f"no route {method} {path}")

    # -- /v1/generate -------------------------------------------------------

    def _parse_generate(self, body: bytes) -> dict:
        try:
            obj = json.loads(body.decode())
        except (ValueError, UnicodeDecodeError):
            raise HttpError("400 Bad Request", "body is not valid JSON")
        prompt = obj.get("prompt")
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) for t in prompt)):
            raise HttpError("400 Bad Request",
                            "prompt must be a non-empty list of ints")
        return obj

    async def _generate(self, body, reader, writer):
        obj = self._parse_generate(body)
        aloop = asyncio.get_running_loop()
        events: asyncio.Queue = asyncio.Queue()

        def _post(event: dict):
            try:
                aloop.call_soon_threadsafe(events.put_nowait, event)
            except RuntimeError:
                pass    # event loop already closed (shutdown race) —
                        # nobody is waiting on this connection anymore

        def on_token(tok: int, index: int):
            _post({"token": tok, "index": index})

        def on_finish(req: Request):
            _post({"done": True, "finish_reason": req.finish_reason,
                   "n_tokens": len(req.tokens)})

        stream = bool(obj.get("stream", False))
        request = Request(
            prompt=np.asarray(obj["prompt"], np.int32),
            max_new_tokens=int(obj.get("max_new_tokens", 16)),
            slo_class=str(obj.get("slo_class", "default")),
            deadline_s=obj.get("deadline_s"),
            ttft_deadline_s=obj.get("ttft_deadline_s"))
        tokens = []
        try:
            replica, rid = self.router.submit(
                request, on_token=on_token if stream else None,
                on_finish=on_finish)
        except (RuntimeError, ValueError) as e:
            raise HttpError("503 Service Unavailable", str(e))

        if not stream:
            done = await events.get()
            done.update(request_id=rid, replica=replica.name,
                        tokens=[int(t) for t in request.tokens])
            writer.write(_json_response("200 OK", done))
            await writer.drain()
            return

        # streaming: SSE events as tokens commit; a concurrent EOF watch
        # on the reader detects the client hanging up mid-stream
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\n"
                     b"Connection: close\r\n\r\n")
        await writer.drain()
        eof = asyncio.ensure_future(reader.read(1))
        try:
            while True:
                get = asyncio.ensure_future(events.get())
                await asyncio.wait({get, eof},
                                   return_when=asyncio.FIRST_COMPLETED)
                if eof.done():
                    eof.exception()     # observe (a client RST lands here)
                    if not get.done():
                        get.cancel()
                        raise ConnectionResetError("client disconnected")
                event = get.result()
                if "token" in event:
                    tokens.append(event["token"])
                event.setdefault("request_id", rid)
                event.setdefault("replica", replica.name)
                try:
                    writer.write(_sse_event(event))
                    await writer.drain()
                except (ConnectionError, OSError):
                    raise ConnectionResetError("client disconnected")
                if event.get("done"):
                    return
        except ConnectionResetError:
            # the disconnect path: cancel into the engine lifecycle —
            # the replica's next sweep frees the slot and its blocks
            replica.cancel(rid)
            raise
        finally:
            if not eof.done():
                eof.cancel()
            elif not eof.cancelled():
                eof.exception()         # keep the loop's unretrieved-
                                        # exception warning quiet


class FrontDoor:
    """Replicas + router + HTTP server with a synchronous lifecycle.

    ``start()`` spins the replica worker threads and an asyncio event
    loop on a background thread, then binds the server (``port=0`` picks
    an ephemeral port, published as ``self.port``).  ``stop()`` tears
    everything down and returns the per-replica ``ServeReport``s."""

    def __init__(self, replicas: Sequence[Replica], *,
                 host: str = "127.0.0.1", port: int = 0,
                 router: Optional[Router] = None, **router_kw):
        self.replicas = list(replicas)
        engines = [id(r.engine) for r in self.replicas]
        if len(set(engines)) != len(engines):
            # cancellation rides engine._pending_cancels; with a shared
            # engine one replica's sweep would steal (and silently drop)
            # another replica's cancel ids
            raise ValueError(
                "replicas must not share a ServingEngine: build one "
                "engine per replica (params can be shared)")
        self.router = (router if router is not None
                       else Router(self.replicas, **router_kw))
        self.host = host
        self.port = port
        self.server: Optional[FrontDoorServer] = None
        self._aloop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "FrontDoor":
        if self._thread is not None:
            raise RuntimeError("front door already started")
        for r in self.replicas:
            r.start()
        self._aloop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._aloop.run_forever, name="frontdoor-http",
            daemon=True)
        self._thread.start()
        self.server = FrontDoorServer(self.router, host=self.host,
                                      port=self.port)
        fut = asyncio.run_coroutine_threadsafe(self.server.start(),
                                               self._aloop)
        self.port = fut.result(timeout=30)
        return self

    def stop(self) -> dict:
        """Graceful shutdown; returns ``{replica_name: ServeReport}``."""
        if self.server is not None:
            asyncio.run_coroutine_threadsafe(
                self.server.stop(), self._aloop).result(timeout=30)
            self.server = None
        # drain replicas while the event loop is still alive: in-flight
        # requests' on_token/on_finish callbacks bridge onto it
        reports = {r.name: r.close() for r in self.replicas}
        if self._aloop is not None:
            self._aloop.call_soon_threadsafe(self._aloop.stop)
            self._thread.join(timeout=30)
            self._aloop.close()
            self._aloop = self._thread = None
        return reports
