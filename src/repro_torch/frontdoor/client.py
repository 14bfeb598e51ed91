"""Blocking socket client for the front door (stdlib only).

Used by tests, the saturation benchmark and the `--frontdoor` demo
driver.  `FrontDoorClient.query()` POSTs the SQL and returns a
`QueryHandle` as soon as the `hello` frame arrives (i.e. immediately,
even while the session waits in the admission queue); iterating
`handle.frames()` decodes the chunked NDJSON stream.  `handle.abort()`
closes the socket mid-stream — the server sees the EOF and fires the
session's CancelScope, which is exactly the client-disconnect path a
real browser exercises.
"""
from __future__ import annotations

import json
import socket
from typing import Dict, Iterator, List, Optional


class QueryRejected(Exception):
    """Admission control returned 429 (or another non-200 status)."""

    def __init__(self, status: int, payload: dict):
        super().__init__(f"front door returned {status}: {payload}")
        self.status = status
        self.payload = payload


class QueryHandle:
    """One streaming response.  Frames are decoded lazily; `rows()` /
    `result()` drain the stream and memoize the trailer."""

    def __init__(self, sock: socket.socket, session_id: str, tenant: str):
        self._sock = sock
        self._fp = sock.makefile("rb")
        self.session_id = session_id
        self.tenant = tenant
        self.trailer: Optional[dict] = None
        self._chunks: List[dict] = []
        self._drained = False

    def frames(self) -> Iterator[dict]:
        """Yield chunk/trailer frames as they arrive (hello was consumed
        by `query()`)."""
        if self._drained:
            yield from self._chunks
            if self.trailer is not None:
                yield self.trailer
            return
        try:
            for frame in _ndjson_frames(self._fp):
                if frame.get("type") == "trailer":
                    self.trailer = frame
                else:
                    self._chunks.append(frame)
                yield frame
        finally:
            self._drained = True
            self.close()

    def rows(self) -> List[dict]:
        out: List[dict] = []
        for frame in self.frames():
            if frame.get("type") == "chunk":
                out.extend(frame["rows"])
        return out

    def result(self) -> dict:
        """Drain the stream; returns the trailer frame."""
        for _ in self.frames():
            pass
        return self.trailer or {"type": "trailer", "status": "disconnected"}

    def stats(self) -> dict:
        return (self.result() or {}).get("stats", {})

    def abort(self) -> None:
        """Simulate the client going away: hard-close the socket.  The
        server's EOF watch fires the session's CancelScope."""
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.close()

    def close(self) -> None:
        try:
            self._fp.close()
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


class FrontDoorClient:
    def __init__(self, host: str, port: int, *, timeout: float = 30.0):
        self.host = host
        self.port = port
        self.timeout = timeout

    # ------------------------------------------------------------------
    def query(self, sql: str, *, tenant: str = "",
              explain: bool = False,
              deadline_ms: Optional[int] = None) -> QueryHandle:
        """POST /query; returns once the hello frame arrives.  Raises
        `QueryRejected` on 429 (admission), 503 (breaker open — check
        the Retry-After hint in the payload), or any other error."""
        spec: Dict[str, object] = {"sql": sql, "tenant": tenant,
                                   "explain": explain}
        if deadline_ms is not None:
            spec["deadline_ms"] = int(deadline_ms)
        body = json.dumps(spec).encode()
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.timeout)
        sock.sendall(self._request("POST", "/query", body))
        fp = sock.makefile("rb")
        status, headers = _read_status_and_headers(fp)
        if status != 200:
            payload = _read_json_body(fp, headers)
            fp.close()
            sock.close()
            raise QueryRejected(status, payload)
        hello = next(_ndjson_frames(fp))
        handle = QueryHandle(sock, hello.get("session", ""), tenant)
        handle._fp = fp
        return handle

    def cancel(self, session_id: str) -> bool:
        payload = self._simple("DELETE", f"/query/{session_id}")
        return bool(payload.get("cancelled", False))

    def server_stats(self) -> dict:
        return self._simple("GET", "/stats")

    # ------------------------------------------------------------------
    def _simple(self, method: str, path: str) -> dict:
        with socket.create_connection((self.host, self.port),
                                      timeout=self.timeout) as sock:
            sock.sendall(self._request(method, path, b""))
            fp = sock.makefile("rb")
            status, headers = _read_status_and_headers(fp)
            payload = _read_json_body(fp, headers)
            fp.close()
            if status >= 500:
                raise QueryRejected(status, payload)
            return payload

    def _request(self, method: str, path: str, body: bytes) -> bytes:
        return ("{} {} HTTP/1.1\r\nHost: {}:{}\r\n"
                "Content-Type: application/json\r\n"
                "Content-Length: {}\r\nConnection: close\r\n\r\n".format(
                    method, path, self.host, self.port,
                    len(body))).encode() + body


# -- wire helpers --------------------------------------------------------
def _read_status_and_headers(fp) -> "tuple[int, Dict[str, str]]":
    line = fp.readline()
    if not line:
        raise ConnectionError("empty response from front door")
    status = int(line.split()[1])
    headers: Dict[str, str] = {}
    while True:
        h = fp.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        name, _, val = h.decode("latin-1").partition(":")
        headers[name.strip().lower()] = val.strip()
    return status, headers


def _read_json_body(fp, headers: Dict[str, str]) -> dict:
    n = int(headers.get("content-length", 0) or 0)
    raw = fp.read(n) if n else b"{}"
    try:
        return json.loads(raw.decode() or "{}")
    except ValueError:
        return {"raw": raw.decode(errors="replace")}


def _ndjson_frames(fp) -> Iterator[dict]:
    """Decode chunked transfer encoding and re-split into NDJSON lines
    (a frame may span transfer chunks; a transfer chunk may carry many
    frames)."""
    buf = b""
    while True:
        size_line = fp.readline()
        if not size_line:
            break
        try:
            size = int(size_line.strip() or b"0", 16)
        except ValueError:
            break
        if size == 0:
            fp.readline()                   # trailing CRLF after 0-chunk
            break
        data = fp.read(size)
        fp.read(2)                          # chunk-terminating CRLF
        if data is None:
            break
        buf += data
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            if line.strip():
                yield json.loads(line.decode())
    if buf.strip():
        yield json.loads(buf.decode())
