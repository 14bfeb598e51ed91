"""Asyncio HTTP front door (stdlib only).

One `FrontDoor` wraps one `IPDB`.  The socket/HTTP layer runs on a
dedicated asyncio thread; query execution runs on a worker-thread pool
(the engine is thread-based) and frames cross back into the loop via
`call_soon_threadsafe`.  HTTP/1.1 is hand-rolled — the protocol surface
is three routes:

    POST   /query        {"sql": ..., "tenant": ..., "explain": bool}
                         → 200, Transfer-Encoding: chunked,
                           application/x-ndjson: a `hello` frame (the
                           session id, sent even while queued), then one
                           `chunk` frame per produced result chunk, then
                           one `trailer` frame (ExecStats / EXPLAIN, or
                           the cancelled/error outcome);
                         → 429 + JSON when admission control rejects.
    DELETE /query/<id>   cancel a session → {"cancelled": bool}
    GET    /stats        server + gate counters as JSON.

Admission control: at most `max_sessions` sessions execute at once
(that is also the worker-pool width); up to `max_queued` more may wait
for a worker; beyond that POST /query is rejected with 429 BEFORE any
engine work happens.  Disconnect detection: while streaming, the
handler watches the connection's read side — EOF (or a failed write)
fires the session's CancelScope, which drops the session's queued
inference requests within one flush (see core/cancel.py).
"""
from __future__ import annotations

import asyncio
import collections
import json
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

from repro_torch.frontdoor.fairness import DeficitRoundRobin
from repro_torch.frontdoor.session import QuerySession

_MAX_BODY = 8 << 20
_DONE = object()            # sentinel closing a session's frame queue


class FrontDoor:
    def __init__(self, db, *, host: str = "127.0.0.1", port: int = 0,
                 max_sessions: int = 4, max_queued: int = 8,
                 gate=None, tenant_weights: Optional[Dict[str, float]] = None,
                 gate_slots: Optional[int] = None,
                 snapshot_every_s: float = 0.0, retry_after_s: int = 1):
        self.db = db
        self.host = host
        self.port = port                    # 0 → ephemeral, set by start()
        self.max_sessions = max(1, int(max_sessions))
        self.max_queued = max(0, int(max_queued))
        # graceful degradation: while any backend breaker is open, new
        # queries are shed with 503 + Retry-After instead of queueing work
        # that would only feed the outage
        self.retry_after_s = max(1, int(retry_after_s))
        # crash safety: with the db configured for snapshots, persist its
        # warm state every snapshot_every_s seconds (and once at stop())
        self.snapshot_every_s = float(snapshot_every_s)
        self._snap_stop = threading.Event()
        self._snap_thread: Optional[threading.Thread] = None
        self.gate = gate if gate is not None else DeficitRoundRobin(
            gate_slots if gate_slots is not None else self.max_sessions,
            weights=tenant_weights)
        self._pool = ThreadPoolExecutor(
            max_workers=self.max_sessions,
            thread_name_prefix="frontdoor-session")
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._lock = threading.Lock()
        self._sessions: Dict[str, QuerySession] = {}
        self._seq = 0
        self._active = 0
        self._queued = 0
        self.counters = collections.Counter()   # accepted/rejected/...

    # -- lifecycle -------------------------------------------------------
    def start(self) -> Tuple[str, int]:
        """Start serving on a dedicated asyncio thread; returns the bound
        (host, port) — port 0 resolves to an ephemeral port."""
        self._thread = threading.Thread(target=self._serve_thread,
                                        name="frontdoor-loop", daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise RuntimeError("front door failed to start")
        if self.snapshot_every_s > 0 and getattr(self.db, "snapshot_dir",
                                                 None):
            self._snap_stop.clear()
            self._snap_thread = threading.Thread(
                target=self._snapshot_loop, name="frontdoor-snapshot",
                daemon=True)
            self._snap_thread.start()
        return self.host, self.port

    def _snapshot_loop(self) -> None:
        while not self._snap_stop.wait(self.snapshot_every_s):
            self._snapshot_once()

    def _snapshot_once(self) -> None:
        try:
            if self.db.save_snapshot() is not None:
                self.counters["snapshots"] += 1
        except Exception:
            # a failed snapshot (disk full, race with shutdown) must
            # never take the serving path down
            self.counters["snapshot_failures"] += 1

    def stop(self) -> None:
        """Cancel live sessions, close the listener, join the loop thread
        and the worker pool (idempotent)."""
        if self._snap_thread is not None:
            self._snap_stop.set()
            self._snap_thread.join(timeout=10)
            self._snap_thread = None
            self._snapshot_once()           # parting snapshot: warm state
            # survives a clean shutdown as well as a crash
        with self._lock:
            sessions = list(self._sessions.values())
        for s in sessions:
            s.cancel("server shutdown")
        loop = self._loop
        ev = getattr(self, "_shutdown_ev", None)
        if loop is not None and ev is not None and loop.is_running():
            loop.call_soon_threadsafe(ev.set)
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "FrontDoor":
        self.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()

    def _serve_thread(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        self._shutdown_ev = asyncio.Event()
        try:
            loop.run_until_complete(self._serve())
        finally:
            loop.close()

    async def _serve(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._started.set()
        try:
            await self._shutdown_ev.wait()
        finally:
            self._server.close()
            await self._server.wait_closed()
            # reap straggling connection handlers so the loop closes clean
            tasks = [t for t in asyncio.all_tasks()
                     if t is not asyncio.current_task()]
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

    # -- http plumbing ---------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            req = await self._read_request(reader)
            if req is None:
                return
            method, path, body = req
            if method == "POST" and path == "/query":
                await self._route_query(reader, writer, body)
            elif method == "DELETE" and path.startswith("/query/"):
                self._route_cancel(writer, path[len("/query/"):])
            elif method == "GET" and path == "/stats":
                self._write_json(writer, 200, self._stats_dict())
            else:
                self._write_json(writer, 404, {"error": "not found"})
        except (ConnectionResetError, BrokenPipeError, asyncio.TimeoutError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _read_request(self, reader: asyncio.StreamReader):
        line = await reader.readline()
        if not line:
            return None
        parts = line.decode("latin-1").split()
        if len(parts) < 2:
            return None
        method, path = parts[0].upper(), parts[1]
        length = 0
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            name, _, val = h.decode("latin-1").partition(":")
            if name.strip().lower() == "content-length":
                length = min(int(val.strip() or 0), _MAX_BODY)
        body = await reader.readexactly(length) if length else b""
        return method, path, body

    def _write_json(self, writer: asyncio.StreamWriter, status: int,
                    obj: dict, *, headers: Optional[Dict[str, str]] = None
                    ) -> None:
        payload = json.dumps(obj).encode()
        reason = {200: "OK", 404: "Not Found",
                  429: "Too Many Requests", 400: "Bad Request",
                  503: "Service Unavailable"}.get(status, "OK")
        extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
        writer.write(
            "HTTP/1.1 {} {}\r\nContent-Type: application/json\r\n"
            "Content-Length: {}\r\n{}Connection: close\r\n\r\n".format(
                status, reason, len(payload), extra).encode() + payload)

    # -- routes ----------------------------------------------------------
    async def _route_query(self, reader, writer, body: bytes) -> None:
        try:
            spec = json.loads(body.decode() or "{}")
            sql = spec["sql"]
        except (ValueError, KeyError):
            self._write_json(writer, 400, {"error": "bad request body"})
            return
        tenant = str(spec.get("tenant", ""))
        deadline_ms = spec.get("deadline_ms")
        # breaker-open shed BEFORE admission: while a backend is tripped,
        # accepted queries would mostly burn their deadline against
        # CircuitOpenError, so tell clients when to come back instead
        svc = getattr(self.db, "inference_service", None)
        if svc is not None and svc.breaker_open():
            self.counters["rejected_breaker"] += 1
            self._write_json(
                writer, 503, {"error": "backend circuit open",
                              "retry_after_s": self.retry_after_s},
                headers={"Retry-After": str(self.retry_after_s)})
            return
        with self._lock:
            if (self._active >= self.max_sessions
                    and self._queued >= self.max_queued):
                self.counters["rejected"] += 1
                self._write_json(writer, 429, {
                    "error": "too many sessions",
                    "active": self._active, "queued": self._queued})
                return
            self._seq += 1
            sid = f"fd{self._seq}"
            session = QuerySession(
                self.db, sql, tenant=tenant, session_id=sid,
                gate=self.gate, explain=bool(spec.get("explain", False)),
                deadline_ms=None if deadline_ms is None
                else int(deadline_ms))
            self._sessions[sid] = session
            self._queued += 1
            self.counters["accepted"] += 1
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: application/x-ndjson\r\n"
                     b"Transfer-Encoding: chunked\r\n"
                     b"Connection: close\r\n\r\n")
        frames: asyncio.Queue = asyncio.Queue()
        loop = asyncio.get_running_loop()

        def emit(frame):                    # worker thread → loop
            try:
                loop.call_soon_threadsafe(frames.put_nowait, frame)
            except RuntimeError:
                pass                        # loop already closed (shutdown)

        self._pool.submit(self._run_session, session, emit)
        try:
            await self._stream_frames(
                reader, writer, frames,
                hello={"type": "hello", "session": sid, "tenant": tenant})
        except (ConnectionResetError, BrokenPipeError, OSError):
            session.cancel("client disconnected")
        finally:
            # drain until the session signals done so its emits never
            # pile onto a dead queue, then forget it
            while True:
                frame = await frames.get()
                if frame is _DONE:
                    break
            with self._lock:
                self._sessions.pop(sid, None)
                if session.status == "cancelled":
                    self.counters["cancelled_sessions"] += 1
                elif session.status == "error":
                    self.counters["errored_sessions"] += 1
                else:
                    self.counters["completed"] += 1

    def _run_session(self, session: QuerySession, emit) -> None:
        with self._lock:
            self._queued -= 1
            self._active += 1
        try:
            session.run(emit)
        finally:
            with self._lock:
                self._active -= 1
            emit(_DONE)

    async def _stream_frames(self, reader, writer, frames: asyncio.Queue,
                             *, hello: dict) -> None:
        session_done = False
        self._write_chunk(writer, hello)
        await writer.drain()
        # watch the read side for EOF: an HTTP client that goes away
        # half-closes or resets, and that is our only disconnect signal
        eof_task = asyncio.ensure_future(reader.read(1))
        get_task: Optional[asyncio.Task] = None
        try:
            while True:
                if get_task is None:
                    get_task = asyncio.ensure_future(frames.get())
                done, _ = await asyncio.wait(
                    {get_task, eof_task},
                    return_when=asyncio.FIRST_COMPLETED)
                if eof_task in done and not get_task.done():
                    raise ConnectionResetError("client went away")
                frame = get_task.result()
                get_task = None
                if frame is _DONE:
                    session_done = True
                    frames.put_nowait(_DONE)    # re-arm the outer drain
                    break
                self._write_chunk(writer, frame)
                await writer.drain()
            writer.write(b"0\r\n\r\n")
            await writer.drain()
        finally:
            for t in (eof_task, get_task):
                if t is not None and not t.done():
                    t.cancel()
            if not session_done:
                # let the outer drain-loop wait for the worker's _DONE
                pass

    def _write_chunk(self, writer, frame: dict) -> None:
        data = (json.dumps(frame, default=str) + "\n").encode()
        writer.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")

    def _route_cancel(self, writer, sid: str) -> None:
        with self._lock:
            session = self._sessions.get(sid)
        if session is None:
            self._write_json(writer, 404,
                             {"session": sid, "cancelled": False})
            return
        fired = session.cancel("DELETE /query")
        self.counters["delete_cancels"] += 1 if fired else 0
        self._write_json(writer, 200, {"session": sid, "cancelled": fired})

    def _stats_dict(self) -> dict:
        with self._lock:
            d = {"active": self._active, "queued": self._queued,
                 "max_sessions": self.max_sessions,
                 "max_queued": self.max_queued,
                 "gate_waiting": self.gate.waiting(),
                 "gate_grants": dict(self.gate.grants)}
            d.update(self.counters)
        return d
