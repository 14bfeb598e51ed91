"""Plan executor: lowers the logical plan to the chunked physical pipeline
(`repro.relational.physical`) and drains it.

All per-operator execution logic (streaming semantic joins, vectorized
relational operators, chunk-at-a-time predict) lives in the physical layer;
this module owns lowering, result assembly and stats aggregation.
Predict/SemanticJoin nodes run through core.predict operators created by a
factory (so the database layer controls executor resolution, the
cross-query prompt cache, and stats collection).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.relational.catalog import Catalog
from repro_torch.relational.physical import PhysicalOp, lower, physical_repr
from repro_torch.relational.plan import Node, PredictInfo
from repro_torch.relational.table import Table


@dataclasses.dataclass
class ExecStats:
    llm_calls: int = 0
    in_tokens: int = 0
    out_tokens: int = 0
    sim_latency_s: float = 0.0
    serial_latency_s: float = 0.0
    wall_s: float = 0.0
    cache_hits: int = 0
    retries: int = 0
    batch_fallbacks: int = 0
    rows_predicted: int = 0
    prompt_cache_hits: int = 0      # cross-query cache (database-owned)
    prompt_cache_misses: int = 0
    # inference-service dispatch accounting (filled per-query by IPDB from
    # the shared service's counters)
    dispatch_batches: int = 0       # complete_many executor invocations
    mean_batch_occupancy: float = 0.0   # dispatched calls / dispatch batch
    inflight_dedup_hits: int = 0    # submits that joined a pending handle
    # optimize-time pilot-sampling calls (selectivity calibration); their
    # tokens/latency are folded into the totals above, the call count is
    # kept separate so llm_calls stays the pure execution count
    pilot_calls: int = 0
    # engine-side serving accounting (jax backend): how much prefill vs
    # decode work the query actually pushed through the model, and how
    # often the shared-prefix KV memo answered instead of a prefill
    prefill_tokens: int = 0
    decode_tokens: int = 0
    prefix_hits: int = 0
    radix_hit_tokens: int = 0       # prompt tokens served from the radix tree
    # cascade accounting (CascadePredictor routes; zero for direct plans)
    proxy_calls: int = 0            # proxy-stage prompts scored
    escalated_calls: int = 0        # expensive-stage calls actually made
    cascade_rows: int = 0           # rows routed through a cascade
    escalated_rows: int = 0         # rows escalated to the expensive stage
    # front-door session accounting (zero for the plain Python API)
    cancelled: bool = False         # query ended by its CancelScope
    cancelled_requests: int = 0     # queued service requests dropped
    # mid-query re-optimization: times a SemanticSelectStackOp re-ranked
    # its remaining units on observed chunk selectivities
    reranks: int = 0
    # resilience accounting: operator-side retry/drop/degradation counts
    # come from the predict operators via _absorb; timeout/breaker shed
    # counts are service-side and filled per-query by IPDB
    transient_retries: int = 0      # resubmits after a TransientError
    deadline_drops: int = 0         # batches/retries dropped past deadline
    degraded_calls: int = 0         # cascade calls served proxy-only
    backend_timeouts: int = 0       # dispatch batches killed by call timeout
    breaker_rejections: int = 0     # requests shed by an open breaker

    @property
    def tokens(self) -> int:
        return self.in_tokens + self.out_tokens


class PlanExecutor:
    def __init__(self, catalog: Catalog,
                 predict_factory: Callable[[PredictInfo], "PredictOperator"],
                 chunk_size: int = 2048, stats_store=None,
                 cancel_scope=None):
        self.cat = catalog
        self.predict_factory = predict_factory
        self.chunk_size = chunk_size
        self.stats_store = stats_store
        self.cancel_scope = cancel_scope
        self.stats = ExecStats()
        # human-readable re-rank decisions (one line each) from stack
        # operators; EXPLAIN's `-- rewrites --` section appends them
        self.rerank_log = []

    # ------------------------------------------------------------------
    def run(self, plan: Node) -> Table:
        parts = list(self.run_chunks(plan))
        out = parts[0]
        for p in parts[1:]:
            out = out.concat(p)
        return out

    def run_chunks(self, plan: Node):
        """Streaming drain: yield result chunks as the pipeline produces
        them (the front door's entry point; `run` materializes them).
        A fired CancelScope raises QueryCancelled out of `next_chunk`; the
        `finally:` closes the tree, which cancels every pending predict
        chunk on the way down — the caller decides whether cancellation
        is an error (sql()) or a session outcome (streams)."""
        root = self.lower(plan)
        root.open()
        try:
            while True:
                chunk = root.next_chunk()
                if chunk is None:
                    break
                yield chunk
        finally:
            root.close()

    def lower(self, plan: Node) -> PhysicalOp:
        return lower(plan, self.cat, self.predict_factory, self.chunk_size,
                     absorber=self, stats_store=self.stats_store,
                     cancel_scope=self.cancel_scope)

    def physical_plan(self, plan: Node) -> str:
        """Lowered pipeline as text (operators are created lazily, so no
        model executors are loaded)."""
        return physical_repr(self.lower(plan))

    # ------------------------------------------------------------------
    def _absorb(self, op) -> None:
        s = op.stats
        self.stats.llm_calls += s.calls
        self.stats.in_tokens += s.in_tokens
        self.stats.out_tokens += s.out_tokens
        self.stats.sim_latency_s += s.sim_latency_s
        self.stats.serial_latency_s += s.serial_latency_s
        self.stats.wall_s += s.wall_s
        self.stats.cache_hits += s.cache_hits
        self.stats.retries += s.retries
        self.stats.batch_fallbacks += s.batch_fallbacks
        self.stats.rows_predicted += s.rows_in
        self.stats.prompt_cache_hits += s.pc_hits
        self.stats.prompt_cache_misses += s.pc_misses
        self.stats.prefill_tokens += s.prefill_tokens
        self.stats.decode_tokens += s.decode_tokens
        self.stats.prefix_hits += s.prefix_hits
        self.stats.radix_hit_tokens += s.radix_hit_tokens
        self.stats.proxy_calls += s.proxy_calls
        self.stats.escalated_calls += s.escalated_calls
        self.stats.cascade_rows += s.cascade_rows
        self.stats.escalated_rows += s.escalated_rows
        self.stats.transient_retries += s.transient_retries
        self.stats.deadline_drops += s.deadline_drops
        self.stats.degraded_calls += s.degraded_calls

    def _note_reranks(self, count: int, lines) -> None:
        """Called once per SemanticSelectStackOp when it closes."""
        self.stats.reranks += int(count)
        self.rerank_log.extend(lines)
