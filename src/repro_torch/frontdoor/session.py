"""One front-door query session: db.stream() → NDJSON frames.

`QuerySession.run(emit)` executes on a worker thread.  It opens a
`QueryStream` tagged with the session id, then alternates

    gate.acquire(tenant)  →  produce one chunk  →  gate.release(cost)

where `cost` is the chunk's actual dispatched-call delta read from the
service's per-session counters (post-paid fairness, see fairness.py).
Each produced chunk is emitted as one `{"type": "chunk", ...}` frame;
the stream always ends with a `trailer` frame carrying the final
ExecStats (and the EXPLAIN text when requested) — or the cancellation /
error outcome.  `emit` must be thread-safe and non-blocking (the server
bridges frames into its asyncio loop).

Cancellation: the session's `CancelScope` is fired by the server on
client disconnect or DELETE /query/<id>.  The scope's callbacks (wired
here) set the session's abort event and kick the gate, so a session
blocked waiting for a fairness slot aborts immediately instead of
consuming one; a session mid-chunk unwinds at the next chunk boundary
while the service has already dropped its queued requests.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import traceback
from typing import Callable, Optional

from repro_torch.core.cancel import CancelScope, QueryCancelled


def stats_frame_dict(stats) -> dict:
    """ExecStats → JSON-safe dict for the trailer frame."""
    if stats is None:
        return {}
    return dataclasses.asdict(stats)


class QuerySession:
    def __init__(self, db, sql: str, *, tenant: str = "",
                 session_id: str, gate, explain: bool = False,
                 deadline_ms: Optional[int] = None):
        self.db = db
        self.sql = sql
        self.tenant = tenant
        self.id = session_id
        self.gate = gate
        self.explain = explain
        self.deadline_ms = deadline_ms
        self.scope = CancelScope()
        self.status = "queued"          # queued|running|ok|cancelled|error
        self.rows_emitted = 0
        self.created_s = time.time()
        self.first_chunk_s: Optional[float] = None
        self.finished_s: Optional[float] = None
        self._abort = threading.Event()
        # order matters: set the abort flag BEFORE waking gate waiters so
        # a woken acquire() observes it and returns without a grant
        self.scope.add_callback(self._abort.set)
        self.scope.add_callback(gate.kick)

    def cancel(self, reason: str = "") -> bool:
        return self.scope.cancel(reason)

    # ------------------------------------------------------------------
    def run(self, emit: Callable[[dict], None]) -> None:
        self.status = "running"
        svc = self.db.inference_service
        try:
            stream = self.db.stream(self.sql, tenant=self.tenant,
                                    session=self.id,
                                    cancel_scope=self.scope,
                                    explain=self.explain,
                                    deadline_ms=self.deadline_ms)
        except QueryCancelled:
            self._trail(emit, "cancelled", None)
            return
        except Exception as exc:                    # bind/parse errors
            self._trail(emit, "error", None, error="{}: {}".format(
                type(exc).__name__, exc))
            return
        seq = 0
        gen = stream.chunks()
        try:
            while True:
                if not self.gate.acquire(self.tenant, abort=self._abort):
                    gen.close()                     # runs stream teardown
                    break
                before = svc.session_stats(self.id).dispatched_calls
                try:
                    chunk = next(gen, None)
                finally:
                    cost = (svc.session_stats(self.id).dispatched_calls
                            - before)
                    self.gate.release(self.tenant, cost=float(cost))
                if chunk is None:
                    break
                if self.first_chunk_s is None:
                    self.first_chunk_s = time.time()
                rows = chunk.rows()
                self.rows_emitted += len(rows)
                emit({"type": "chunk", "session": self.id, "seq": seq,
                      "rows": rows})
                seq += 1
        except Exception:
            gen.close()
            self._trail(emit, "error", stream.stats,
                        error=traceback.format_exc(limit=4))
            return
        cancelled = self.scope.cancelled or stream.cancelled \
            or (stream.stats is not None and stream.stats.cancelled)
        self._trail(emit, "cancelled" if cancelled else "ok",
                    stream.stats, plan=stream.plan)

    def _trail(self, emit, status: str, stats, *, plan: Optional[str] = None,
               error: str = "") -> None:
        self.status = status
        self.finished_s = time.time()
        frame = {"type": "trailer", "session": self.id, "status": status,
                 "rows": self.rows_emitted,
                 "stats": stats_frame_dict(stats)}
        if plan is not None:
            frame["plan"] = plan
        if error:
            frame["error"] = error
        emit(frame)
