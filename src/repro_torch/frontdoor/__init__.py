"""Serving tier: the HTTP front door over the iPDB engine.

`FrontDoor` (server.py) accepts concurrent query sessions over HTTP,
streams each session's result chunks as NDJSON while the chunked
physical pipeline produces them, and closes every stream with an
ExecStats trailer.  Admission control bounds concurrent + queued
sessions (429 beyond the cap); `DeficitRoundRobin` (fairness.py)
schedules chunk production across tenants with weighted fair credits
charged post-paid from the inference service's per-tenant dispatch
counters; cancellation (client disconnect, DELETE /query/<id>) flows
through a per-session `CancelScope` into the service so a dead session
stops consuming dispatch within one flush.

Everything is stdlib: asyncio for the socket/HTTP layer, threads for
query execution (the engine is thread-based), a blocking socket client
(client.py) for tests, benchmarks and the demo driver.
"""
from repro_torch.frontdoor.client import FrontDoorClient, QueryRejected
from repro_torch.frontdoor.fairness import DeficitRoundRobin, FifoGate
from repro_torch.frontdoor.server import FrontDoor
from repro_torch.frontdoor.session import QuerySession

__all__ = ["FrontDoor", "FrontDoorClient", "QueryRejected",
           "DeficitRoundRobin", "FifoGate", "QuerySession"]
