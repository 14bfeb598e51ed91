"""Per-tenant weighted fair sharing over the shared dispatch pool.

Sessions do not talk to the inference service directly for scheduling —
before producing each result chunk they `acquire()` a slot from a gate,
and `release()` it afterwards with the chunk's actual cost (the
dispatched-call delta the service accounted for the session).  The gate
decides WHICH waiting session gets the next free slot:

`DeficitRoundRobin` keeps one FIFO of waiters per tenant and a signed
credit balance per tenant.  A slot goes to the waiting tenant with the
highest credit (ties broken by arrival order); when every waiting tenant
is out of credit, all of them are replenished by `quantum * weight`
rounds until one is positive — classic deficit round robin, except the
cost is charged POST-PAID at release time because a chunk's dispatch
cost is only known after it ran.  A heavy tenant's large charges drive
its balance negative, so a light tenant's waiters keep winning slots
even while the heavy tenant has a deep backlog: the light tenant's tail
latency is bounded by slots-in-flight, not by the heavy backlog.

Credits are capped above (idle tenants cannot hoard) and floored below
(an ancient debt cannot starve a tenant forever).  `FifoGate` grants in
pure arrival order with the same interface — the benchmark's baseline.

Both gates are thread-safe and deterministic: grant order is a pure
function of (arrival order, weights, released costs).
"""
from __future__ import annotations

import collections
import threading
from typing import Deque, Dict, Optional


class _Waiter:
    __slots__ = ("ticket", "tenant")

    def __init__(self, ticket: int, tenant: str):
        self.ticket = ticket
        self.tenant = tenant


class _GateBase:
    """Common slot accounting: a condition variable, `slots` concurrent
    grants, a global ticket counter, per-tenant grant/wait statistics."""

    def __init__(self, slots: int = 1):
        self._cv = threading.Condition()
        self._slots = max(1, int(slots))
        self._free = self._slots
        self._ticket = 0
        self.grants: Dict[str, int] = collections.defaultdict(int)

    def kick(self) -> None:
        """Wake every waiter (cancel scopes call this so a waiter blocked
        on a slot notices its abort event without polling)."""
        with self._cv:
            self._cv.notify_all()

    def release(self, tenant: str, cost: float = 1.0) -> None:
        with self._cv:
            self._free += 1
            self._charge(tenant, float(cost))
            self._cv.notify_all()

    def waiting(self) -> int:
        with self._cv:
            return self._n_waiting()

    # subclass hooks ---------------------------------------------------
    def _charge(self, tenant: str, cost: float) -> None:
        pass

    def _n_waiting(self) -> int:
        raise NotImplementedError


class FifoGate(_GateBase):
    """Grant slots in pure arrival order, tenant-blind (the baseline the
    fairness benchmark compares DRR against)."""

    def __init__(self, slots: int = 1):
        super().__init__(slots)
        self._queue: Deque[_Waiter] = collections.deque()

    def acquire(self, tenant: str, timeout: Optional[float] = None,
                abort: Optional[threading.Event] = None) -> bool:
        with self._cv:
            self._ticket += 1
            w = _Waiter(self._ticket, tenant)
            self._queue.append(w)
            while not (self._free > 0 and self._queue[0] is w):
                if abort is not None and abort.is_set():
                    self._queue.remove(w)
                    return False
                if not self._cv.wait(timeout):
                    self._queue.remove(w)
                    return False
            self._queue.popleft()
            self._free -= 1
            self.grants[tenant] += 1
            self._cv.notify_all()
            return True

    def _n_waiting(self) -> int:
        return len(self._queue)


class DeficitRoundRobin(_GateBase):
    """Weighted deficit-round-robin credit scheduler (see module doc)."""

    def __init__(self, slots: int = 1, *, quantum: float = 4.0,
                 weights: Optional[Dict[str, float]] = None,
                 default_weight: float = 1.0, debt_cap_rounds: int = 16):
        super().__init__(slots)
        self._quantum = max(1e-9, float(quantum))
        self._weights = dict(weights or {})
        self._default_weight = float(default_weight)
        self._debt_cap_rounds = max(1, int(debt_cap_rounds))
        self._queues: Dict[str, Deque[_Waiter]] = collections.OrderedDict()
        self._credit: Dict[str, float] = collections.defaultdict(float)

    def weight(self, tenant: str) -> float:
        return float(self._weights.get(tenant, self._default_weight))

    def set_weight(self, tenant: str, weight: float) -> None:
        with self._cv:
            self._weights[tenant] = float(weight)

    def credit(self, tenant: str) -> float:
        with self._cv:
            return self._credit[tenant]

    def acquire(self, tenant: str, timeout: Optional[float] = None,
                abort: Optional[threading.Event] = None) -> bool:
        with self._cv:
            self._ticket += 1
            w = _Waiter(self._ticket, tenant)
            q = self._queues.get(tenant)
            if q is None:
                q = self._queues[tenant] = collections.deque()
                # a tenant re-entering after idling cannot spend hoarded
                # credit (DRR resets deficit on empty queues); debt is
                # kept — it is the memory that makes heavy tenants yield
                cap = self._quantum * self.weight(tenant)
                self._credit[tenant] = min(self._credit[tenant], cap)
            q.append(w)
            while not self._grantable(w):
                if abort is not None and abort.is_set():
                    self._drop(w)
                    return False
                if not self._cv.wait(timeout):
                    self._drop(w)
                    return False
            self._queues[tenant].popleft()
            if not self._queues[tenant]:
                del self._queues[tenant]
            self._free -= 1
            self.grants[tenant] += 1
            self._cv.notify_all()
            return True

    # internals (caller holds the lock) --------------------------------
    def _drop(self, w: _Waiter) -> None:
        q = self._queues.get(w.tenant)
        if q is not None:
            try:
                q.remove(w)
            except ValueError:
                pass
            if not q:
                del self._queues[w.tenant]

    def _grantable(self, w: _Waiter) -> bool:
        if self._free <= 0:
            return False
        q = self._queues.get(w.tenant)
        if q is None or q[0] is not w:
            return False
        return self._pick() == w.tenant

    def _pick(self) -> Optional[str]:
        waiting = [t for t, q in self._queues.items() if q]
        if not waiting:
            return None
        if all(self._credit[t] <= 0.0 for t in waiting):
            # replenish one DRR round at a time until somebody can spend;
            # bounded because debt is floored at debt_cap_rounds quanta
            for _ in range(self._debt_cap_rounds + 1):
                for t in waiting:
                    cap = self._quantum * self.weight(t)
                    self._credit[t] = min(self._credit[t] + cap, cap)
                if any(self._credit[t] > 0.0 for t in waiting):
                    break
        # richest tenant wins; ties go to the earliest-arrived head
        # waiter so the pick is deterministic and starvation-free
        return min(waiting,
                   key=lambda t: (-self._credit[t],
                                  self._queues[t][0].ticket))

    def _charge(self, tenant: str, cost: float) -> None:
        floor = -self._debt_cap_rounds * self._quantum * self.weight(tenant)
        self._credit[tenant] = max(self._credit[tenant] - max(0.0, cost),
                                   floor)

    def _n_waiting(self) -> int:
        return sum(len(q) for q in self._queues.values())
