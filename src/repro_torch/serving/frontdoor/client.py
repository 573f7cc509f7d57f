"""Minimal blocking HTTP/SSE client for the front door (stdlib sockets;
port of ``repro/serving/frontdoor/client.py``, the same code).

Tests and benchmarks drive the server through real TCP connections with
this client instead of mocking the transport, so the disconnect path —
``disconnect_after=k`` hard-closes the socket after the k-th token event
— exercises exactly what a flaky client does to the server.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Callable, List, Optional


class FrontDoorClient:
    def __init__(self, host: str, port: int, timeout_s: float = 60.0):
        self.host = host
        self.port = port
        self.timeout_s = timeout_s

    # -- transport ----------------------------------------------------------

    def _connect(self) -> socket.socket:
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.timeout_s)
        return sock

    def _send(self, sock: socket.socket, method: str, path: str,
              body: bytes = b""):
        head = (f"{method} {path} HTTP/1.1\r\n"
                f"Host: {self.host}:{self.port}\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"Connection: close\r\n\r\n").encode()
        sock.sendall(head + body)

    @staticmethod
    def _read_head(sock: socket.socket):
        """Read up to the end of the header block; returns (status_line,
        leftover-bytes-already-read-past-the-headers)."""
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = sock.recv(4096)
            if not chunk:
                raise ConnectionError("server closed during headers")
            buf += chunk
        head, rest = buf.split(b"\r\n\r\n", 1)
        status = head.split(b"\r\n", 1)[0].decode("latin-1")
        return status, rest

    @staticmethod
    def _read_all(sock: socket.socket, rest: bytes) -> bytes:
        chunks = [rest]
        while True:
            chunk = sock.recv(4096)
            if not chunk:
                return b"".join(chunks)
            chunks.append(chunk)

    def _request_json(self, method: str, path: str, obj=None) -> dict:
        body = b"" if obj is None else json.dumps(obj).encode()
        with self._connect() as sock:
            self._send(sock, method, path, body)
            status, rest = self._read_head(sock)
            payload = self._read_all(sock, rest)
        out = json.loads(payload.decode()) if payload else {}
        if " 200 " not in status + " ":
            detail = out.get("error", repr(payload))
            raise RuntimeError(f"{status}: {detail}")
        return out

    # -- API ----------------------------------------------------------------

    def healthz(self) -> dict:
        return self._request_json("GET", "/healthz")

    def stats(self) -> dict:
        return self._request_json("GET", "/v1/stats")

    def generate(self, prompt, *, max_new_tokens: int = 16,
                 slo_class: str = "default", stream: bool = False,
                 deadline_s: Optional[float] = None,
                 ttft_deadline_s: Optional[float] = None,
                 disconnect_after: Optional[int] = None,
                 on_token: Optional[Callable[[int, int], None]] = None
                 ) -> dict:
        """One generation round trip.

        Returns ``{"tokens": [...], "finish_reason": ..., "request_id":
        ..., "replica": ..., "disconnected": bool}``.  With ``stream``
        the tokens arrive as SSE events (``on_token`` observes each);
        ``disconnect_after=k`` (implies ``stream``) hard-closes the
        socket after the k-th token event — the returned dict then holds
        the partial stream and ``disconnected=True``."""
        stream = stream or disconnect_after is not None
        body = {"prompt": [int(t) for t in prompt],
                "max_new_tokens": int(max_new_tokens),
                "slo_class": slo_class, "stream": stream,
                "deadline_s": deadline_s,
                "ttft_deadline_s": ttft_deadline_s}
        if not stream:
            out = self._request_json("POST", "/v1/generate", body)
            out["disconnected"] = False
            return out

        tokens: List[int] = []
        result = {"tokens": tokens, "finish_reason": None,
                  "request_id": None, "replica": None,
                  "disconnected": False}
        sock = self._connect()
        try:
            self._send(sock, "POST", "/v1/generate",
                       json.dumps(body).encode())
            status, buf = self._read_head(sock)
            if " 200 " not in status + " ":
                payload = self._read_all(sock, buf)
                raise RuntimeError(f"{status}: {payload!r}")
            while True:
                while b"\n\n" in buf:
                    raw, buf = buf.split(b"\n\n", 1)
                    if not raw.startswith(b"data: "):
                        continue
                    event = json.loads(raw[len(b"data: "):].decode())
                    result["request_id"] = event.get(
                        "request_id", result["request_id"])
                    result["replica"] = event.get(
                        "replica", result["replica"])
                    if event.get("done"):
                        result["finish_reason"] = event["finish_reason"]
                        return result
                    tokens.append(int(event["token"]))
                    if on_token is not None:
                        on_token(event["token"], event["index"])
                    if (disconnect_after is not None
                            and len(tokens) >= disconnect_after):
                        # hard hangup mid-stream: reset rather than
                        # FIN-drain, like a crashed client
                        sock.setsockopt(socket.SOL_SOCKET,
                                        socket.SO_LINGER,
                                        struct.pack("ii", 1, 0))
                        result["disconnected"] = True
                        return result
                chunk = sock.recv(4096)
                if not chunk:
                    # server closed without a done event (e.g. it saw our
                    # own earlier hangup); report what we have
                    result["disconnected"] = True
                    return result
                buf += chunk
        finally:
            sock.close()
