"""End-to-end query cancellation.

A `CancelScope` is the single object that ties a query session's
lifecycle together across layers: the front door cancels it when the
client disconnects (or an explicit DELETE /query/<id> arrives), the
physical pipeline checks it at every chunk boundary, and registered
callbacks let the inference service drop the session's still-queued
requests without waiting for the pipeline to unwind on its own.

Propagation contract ("within one flush"):

  * the executing thread raises `QueryCancelled` at the next
    `PhysicalOp.next_chunk` boundary; the exception unwinds the operator
    tree, running every `finally:` — pipelined operators cancel their
    pending chunks, which releases the still-queued service handles;
  * a dispatch batch that already started (flush or speculative kick)
    is never interrupted mid-executor-call — it completes, its results
    are discarded with the unwinding pipeline;
  * scope callbacks run on the CANCELLING thread, exactly once, even if
    `cancel()` races; a callback added after cancellation fires
    immediately.  The front door registers
    `InferenceService.cancel_session` here so queued requests disappear
    even while the executing thread is blocked inside a running flush.

Thread safety: `cancel()` and `add_callback()` may be called from any
thread; `cancelled`/`raise_if_cancelled` are lock-free reads of a
`threading.Event`.
"""
from __future__ import annotations

import threading
from typing import Callable, List


class QueryCancelled(Exception):
    """Raised by the executing pipeline when its CancelScope fires."""


class CancelScope:
    __slots__ = ("_event", "_lock", "_callbacks", "reason")

    def __init__(self):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._callbacks: List[Callable[[], None]] = []
        self.reason = ""

    @property
    def cancelled(self) -> bool:
        return self._event.is_set()

    def raise_if_cancelled(self) -> None:
        if self._event.is_set():
            raise QueryCancelled(self.reason or "query cancelled")

    def add_callback(self, fn: Callable[[], None]) -> None:
        """Register `fn` to run when the scope is cancelled.  If the
        scope is already cancelled the callback runs immediately (on the
        registering thread) — registration order never races the
        cancel."""
        run_now = False
        with self._lock:
            if self._event.is_set():
                run_now = True
            else:
                self._callbacks.append(fn)
        if run_now:
            fn()

    def cancel(self, reason: str = "") -> bool:
        """Fire the scope (idempotent).  Returns True on the first call.
        Callbacks run outside the lock, in registration order, on the
        cancelling thread; a callback that raises does not block the
        others."""
        with self._lock:
            if self._event.is_set():
                return False
            self.reason = reason or self.reason
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            try:
                fn()
            except Exception:
                pass
        return True
