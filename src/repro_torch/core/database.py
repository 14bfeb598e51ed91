"""iPDB — the public database API (PyTorch port of ``repro.core.database``).

    db = IPDB()                     # device None = CUDA; IPDB(device="cpu")
    db.register_table("Product", table)
    db.sql("CREATE LLM MODEL o4mini PATH 'oracle:pcparts' ON PROMPT API '...'")
    out = db.sql("SELECT name FROM Product WHERE LLM o4mini (PROMPT '...')")

Executor resolution by model PATH scheme:
    oracle:<name>   → OracleExecutor using a registered oracle fn
    torch:<arch>    → TorchExecutor on an in-process InferenceEngine on the
                      database's device (smoke-size config of the named
                      architecture); ``jax:<arch>`` belongs to the JAX
                      package and raises here
    *.onnx / tabular:<name> → TabularExecutor via a registered predict fn
    custom:<name>   → a registered executor factory (tests/benchmarks)
"""
from __future__ import annotations

import dataclasses
import inspect
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional

from repro_torch.core.cancel import CancelScope, QueryCancelled

from repro_torch.core.executors import (OracleExecutor, Predictor,
                                        TabularExecutor, TorchExecutor)
from repro_torch.core.optimizer import DEFAULT_FLAGS, Optimizer
from repro_torch.core.predict import PredictOperator, PromptCache
from repro_torch.core.rewrite import rewrites_section
from repro_torch.core.service import InferenceService
from repro_torch.core.stats import (CostModel, PilotSampler, StatisticsStore,
                              stats_section)
from repro_torch.relational.binder import Binder
from repro_torch.relational.catalog import Catalog, ModelEntry
from repro_torch.relational.executor import ExecStats, PlanExecutor
from repro_torch.relational.parser import (CreateModel, CreateTableAs, SelectStmt,
                                     SetStmt, parse_sql)
from repro_torch.relational.plan import Node, PredictInfo, plan_repr
from repro_torch.relational.table import Table
from repro_torch.serving.engine import resolve_device


@dataclasses.dataclass
class QueryResult:
    table: Optional[Table]
    stats: ExecStats
    plan: Optional[str] = None


class IPDB:
    def __init__(self, *, session_options: Optional[Dict[str, object]] = None,
                 snapshot_dir: Optional[str] = None, device=None):
        #: where `torch:` engines run: None means CUDA (raises without a
        #: GPU); the CPU only when asked for
        self.device = resolve_device(device)
        self.catalog = Catalog()
        self.options: Dict[str, object] = {
            "batch_size": 16, "n_threads": 16, "use_batching": True,
            "use_dedup": True, "rate_limit_rpm": 0.0,
            "inflight_windows": 1, "max_dispatch_calls": 0,
            # per-backend dispatch worker pools: 1 = synchronous flush on
            # the submitting thread (the pre-pool behavior); >1 lets
            # concurrency-capable backends dispatch on background threads
            # (clamped to each executor's max_concurrency).  Speculative
            # flush starts complete max_dispatch_calls-sized slices early.
            "dispatch_workers": 1, "speculative_flush": True,
            # adaptive statistics: pilot-sample predicates with no history
            # at optimize time (only when the input is ≳4× the sample —
            # override with pilot_min_rows — so the pilot cost amortizes)
            "enable_pilot": True, "pilot_sample_rows": 16,
            # serving engine KV layout: "dense" keeps per-slot
            # max_len caches (seed behavior); "paged" switches to the
            # block-table page pool with zero-copy shared-prefix pages.
            # kv_pool_pages pins the pool size (None = grow on demand).
            "kv_layout": "dense", "kv_page_size": 64, "kv_pool_pages": None,
            # paged-engine prefix reuse: "radix" discovers partial token
            # overlap in a refcounted prefix tree; "exact" is the
            # whole-string memo.  kv_quant="int8" stores tree-frozen pages
            # as int8 with per-page scales (live pages stay fp).
            # n_samples>1 decodes that many streams per row off a shared
            # copy-on-write prompt fork and majority-votes the answer.
            "kv_prefix_mode": "radix", "kv_quant": "none", "n_samples": 1,
            # calibrated model cascades: any model whose merged options
            # carry cascade_proxy=<model> routes through a CascadePredictor
            # targeting cascade_target_precision (override per model via
            # OPTIONS or per expression via PREDICT ... WITH (...)).
            # cascade_min_records gates calibration on held-out evidence;
            # cascade_audit_every audits 1-in-N accepted rows to keep the
            # reservoir honest (0 disables).  enable_cascade (optimizer
            # flag, in DEFAULT_FLAGS) turns routing off entirely.
            "cascade_target_precision": 0.9, "cascade_min_records": 8,
            "cascade_audit_every": 16,
            # fault tolerance: per-dispatch-call timeout (0 = unbounded,
            # the seed behavior), deterministic-jitter retry backoff for
            # transient failures, per-backend circuit-breaker policy, and
            # a session-default end-to-end deadline (0 = none; override
            # per expression via WITH (deadline_ms=...)).  snapshot_keep
            # bounds the on-disk warm-state snapshot history.
            "call_timeout_s": 0.0, "retry_backoff_s": 0.0,
            "breaker_threshold": 3, "breaker_probe_every": 4,
            "deadline_ms": 0, "snapshot_keep": 3,
            **DEFAULT_FLAGS,
        }
        if session_options:
            self.options.update(session_options)
        self._oracles: Dict[str, Callable] = {}
        self._tabular_fns: Dict[str, Callable] = {}
        # keyed (arch, kv_layout, page_size, pool, max_len, pmode, quant)
        self._torch_engines: Dict[tuple, object] = {}
        self._oracle_kwargs: Dict[str, dict] = {}
        self._executor_factories: Dict[str, Callable] = {}
        self.last_stats: Optional[ExecStats] = None
        # cross-query prompt cache: shared by every predict operator this
        # database creates (keyed by model + instruction + input tuple)
        self.prompt_cache = PromptCache()
        # adaptive statistics: per-(model, instruction) observed
        # selectivity / tokens / latency / retry rates, persisting across
        # queries exactly like the prompt cache
        self.stats_store = StatisticsStore()
        # one inference service per session: every predict operator routes
        # its dispatch through it (batching, in-flight dedup, scheduling);
        # dispatched calls feed the statistics store
        self.inference_service = InferenceService(stats_store=self.stats_store)
        # front-door streams: parse/bind/optimize are serialized (the
        # binder's column-name counter and the optimizer's store access
        # are cheap; the chunked EXECUTION below them runs concurrently),
        # and each stream gets a monotonically numbered session tag
        self._bind_lock = threading.Lock()
        self._stream_seq = 0
        # crash-safe warm state: when snapshot_dir is set, opening the
        # database restores the newest valid snapshot (prompt cache,
        # statistics store, radix prefix-cache KV); corrupt or missing
        # snapshots mean a cold start, never an error.  Radix payloads are
        # restored lazily — engines are created on first use, so restored
        # KV is staged per engine cache key until then.
        self.snapshot_dir = snapshot_dir
        self.restored_snapshot: Optional[str] = None
        self.snapshot_skipped: List[str] = []
        self._pending_radix: Dict[tuple, dict] = {}
        if snapshot_dir:
            self._restore_snapshot()

    # -- warm-state snapshots --------------------------------------------
    def save_snapshot(self) -> Optional[str]:
        """Atomically write the database's warm state to `snapshot_dir`:
        prompt-cache entries, statistics-store records, and the radix
        prefix-cache KV pages of every live torch engine.  Returns the
        snapshot path, or None when no snapshot_dir is configured."""
        if not self.snapshot_dir:
            return None
        from repro_torch.core.snapshot import write_snapshot
        radix: Dict[tuple, dict] = {}
        for key, eng in self._torch_engines.items():
            state = eng.export_radix_state()
            if state is not None and state.get("entries"):
                radix[key] = state
        payload = {
            "prompt_cache": self.prompt_cache.export_state(),
            "stats_store": self.stats_store.export_state(),
            "radix": radix,
        }
        return write_snapshot(self.snapshot_dir, payload,
                              keep=int(self.options.get("snapshot_keep", 3)))

    def _restore_snapshot(self) -> None:
        """Restore the newest valid snapshot; any failure (corrupt file,
        schema drift) degrades to a cold start, never an error."""
        from repro_torch.core.snapshot import load_latest
        payload, path, skipped = load_latest(self.snapshot_dir)
        self.snapshot_skipped = skipped
        if payload is None:
            return
        try:
            self.prompt_cache.restore_state(payload.get("prompt_cache") or [])
            self.stats_store.restore_state(payload.get("stats_store") or {})
            self._pending_radix = dict(payload.get("radix") or {})
            self.restored_snapshot = path
        except Exception:
            # a half-applied restore must not poison the session
            self.prompt_cache = PromptCache()
            self.stats_store.clear()
            self._pending_radix = {}
            self.restored_snapshot = None
            if path:
                self.snapshot_skipped.append(path)

    # -- lifecycle -------------------------------------------------------
    def close(self, *, cancel_pending: bool = False) -> None:
        """Shut the session's inference service down and join its dispatch
        worker threads (idempotent).  Queued requests are drained first
        unless `cancel_pending`.  Sessions that never raise
        `dispatch_workers` above 1 have no threads to join, so existing
        callers that drop the database without closing leak nothing."""
        self.inference_service.shutdown(cancel_pending=cancel_pending)

    def __enter__(self) -> "IPDB":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(cancel_pending=exc_type is not None)

    # -- registration ---------------------------------------------------
    def register_table(self, name: str, t: Table) -> None:
        self.catalog.register_table(name, t)

    def register_oracle(self, name: str, fn: Callable, **kwargs) -> None:
        """Oracle executors for accuracy-bearing benchmarks:
        fn(instruction, rows) -> list of output dicts."""
        self._oracles[name] = fn
        self._oracle_kwargs[name] = kwargs

    def register_tabular(self, name: str, fn: Callable) -> None:
        self._tabular_fns[name] = fn

    def register_executor(self, name: str, factory: Callable) -> None:
        """Custom executor backends: `factory(entry) -> Predictor` is
        resolved by model PATH 'custom:<name>'.  Used by tests/benchmarks
        to plug scripted backends into the full SQL path."""
        self._executor_factories[name] = factory

    def set_option(self, key: str, value) -> None:
        self.options[key] = value

    # -- executor resolution ---------------------------------------------
    def _make_executor(self, entry: ModelEntry) -> Predictor:
        path = entry.path
        if path.startswith("oracle:"):
            name = path.split(":", 1)[1]
            if name not in self._oracles:
                raise KeyError(f"oracle {name!r} not registered")
            return OracleExecutor(self._oracles[name],
                                  **self._oracle_kwargs.get(name, {}))
        if path.startswith("jax:"):
            raise ValueError(
                f"PATH {path!r} runs on the JAX package (repro.core.database"
                ".IPDB); this database serves 'torch:<arch>'")
        if path.startswith("torch:"):
            arch = path.split(":", 1)[1]
            layout = str(entry.options.get(
                "kv_layout", self.options.get("kv_layout", "dense")))
            pool = entry.options.get(
                "kv_pool_pages", self.options.get("kv_pool_pages"))
            pool = None if pool is None else int(pool)
            page_size = int(entry.options.get(
                "kv_page_size", self.options.get("kv_page_size", 64)))
            max_len = int(entry.options.get("max_len", 512))
            if layout == "dense":
                # paged-only knobs must not split behaviorally identical
                # dense engines into separate instances
                page_size, pool = 64, None
            pmode = str(entry.options.get(
                "kv_prefix_mode", self.options.get("kv_prefix_mode",
                                                   "radix")))
            quant = str(entry.options.get(
                "kv_quant", self.options.get("kv_quant", "none")))
            if layout == "dense":
                pmode, quant = "radix", "none"
            # every option that shapes the engine is part of the cache
            # key — two models must never silently share a mismatched one
            key = (arch, layout, page_size, pool, max_len, pmode, quant)
            if key not in self._torch_engines:
                import repro_torch.configs as C
                from repro_torch.serving.engine import InferenceEngine
                cfg = C.get_smoke_config(arch).replace(vocab_size=259)
                # the paged layout (and with it the radix tree a warm
                # snapshot restores) is not ported yet: the engine raises
                self._torch_engines[key] = InferenceEngine(
                    cfg, max_len=max_len, kv_layout=layout,
                    device=self.device)
            return TorchExecutor(self._torch_engines[key])
        if path.startswith("custom:"):
            name = path.split(":", 1)[1]
            if name not in self._executor_factories:
                raise KeyError(f"custom executor {name!r} not registered")
            return self._executor_factories[name](entry)
        if path.endswith(".onnx") or path.startswith("tabular:"):
            name = path.split(":", 1)[1] if ":" in path else entry.name
            if name not in self._tabular_fns:
                raise KeyError(f"tabular model fn {name!r} not registered")
            return TabularExecutor(self._tabular_fns[name])
        raise ValueError(f"cannot resolve executor for PATH {path!r}")

    def _predict_factory(self, info: PredictInfo,
                         extra_options: Optional[Dict[str, object]] = None
                         ) -> PredictOperator:
        entry = self.catalog.model(info.model_name)
        # catalog metadata flows into the operator (API url, secret, options)
        merged = dict(info.options or {})
        merged.setdefault("base_api", entry.base_api)
        info = dataclasses.replace(info, options=merged)
        session_options = self.options if not extra_options \
            else {**self.options, **extra_options}
        return PredictOperator(info, self._resolve_executor(entry, info),
                               session_options,
                               prompt_cache=self.prompt_cache,
                               service=self.inference_service,
                               stats_store=self.stats_store)

    def _factory_with(self, extra: Dict[str, object]):
        """Bind per-query extra options (deadline anchor, session tags)
        into the operator factory.  Tests monkeypatch `_predict_factory`
        with single-argument wrappers, so only pass `extra` when the
        current factory accepts it — a one-arg factory just loses the
        shared anchor and operators fall back to construction time."""
        fn = self._predict_factory
        try:
            takes_extra = len(inspect.signature(fn).parameters) >= 2
        except (TypeError, ValueError):
            takes_extra = True
        if takes_extra:
            return lambda info: fn(info, extra)
        return fn

    def _resolve_executor(self, entry: ModelEntry,
                          info: PredictInfo) -> Predictor:
        """Executor for one predict node: the entry's backend, wrapped in a
        CascadePredictor when a cascade proxy is configured (session
        option < model OPTIONS < expression WITH precedence) and the
        optimizer did not route the node direct."""
        merged = {**self.options, **(info.options or {})}
        proxy_name = merged.get("cascade_proxy")
        if (proxy_name and bool(merged.get("enable_cascade", True))
                and str(merged.get("cascade_route", "cascade")) != "direct"
                and not info.agg):
            from repro_torch.core.cascade import CascadePredictor
            from repro_torch.core.stats import stats_key
            proxy_entry = self.catalog.model(str(proxy_name))
            return CascadePredictor(
                self._make_executor(proxy_entry),
                self._make_executor(entry),
                store=self.stats_store, key=stats_key(info),
                proxy_model=str(proxy_name),
                target_precision=float(
                    merged.get("cascade_target_precision", 0.9)),
                min_records=int(merged.get("cascade_min_records", 8)),
                audit_every=int(merged.get("cascade_audit_every", 16)),
                # the expensive stage gets its own breaker (distinct from
                # the dispatch-level one keyed by the cascade's model
                # name), so an expensive-backend outage degrades routed
                # batches to proxy-only instead of failing them
                breaker=self.inference_service.breaker_for(
                    f"{entry.name}#expensive"))
        return self._make_executor(entry)

    # -- entry point -------------------------------------------------------
    def sql(self, query: str, *, explain: bool = False) -> QueryResult:
        stmt = parse_sql(query)
        if isinstance(stmt, SetStmt):
            self.options[stmt.key] = stmt.value
            return QueryResult(None, ExecStats())
        if isinstance(stmt, CreateModel):
            self.catalog.register_model(ModelEntry(
                name=stmt.name, path=stmt.path, type=stmt.model_type,
                on_prompt=stmt.on_prompt, base_api=stmt.api,
                relation=stmt.relation, input_set=stmt.features,
                output_set=stmt.output, options=stmt.options))
            return QueryResult(None, ExecStats())
        if isinstance(stmt, CreateTableAs):
            res = self._run_select(stmt.select, explain)
            self.catalog.register_table(stmt.name, res.table)
            return res
        if isinstance(stmt, SelectStmt):
            return self._run_select(stmt, explain)
        raise TypeError(type(stmt))

    # -- streaming sessions (the front door's entry point) -----------------
    def stream(self, query: str, *, tenant: str = "",
               session: Optional[str] = None,
               cancel_scope: Optional[CancelScope] = None,
               explain: bool = False,
               deadline_ms: Optional[int] = None) -> "QueryStream":
        """Open one streaming query session: parse/bind/optimize now
        (serialized under a short lock), execute lazily — iterating
        `QueryStream.chunks()` drains the chunked physical pipeline and
        yields each result chunk as it is produced.  Every inference
        request the session submits is tagged (tenant, session), so
        dispatch batches are session-pure, per-session ExecStats are
        deterministic under concurrency, and `cancel_scope.cancel()`
        (client disconnect, DELETE /query/<id>) drops the session's
        still-queued requests within one flush.  Only SELECT statements
        stream; DDL/SET go through `sql()`."""
        t0 = time.time()
        stmt = parse_sql(query)
        if not isinstance(stmt, SelectStmt):
            raise ValueError("stream() supports SELECT statements only; "
                             f"got {type(stmt).__name__}")
        scope = cancel_scope if cancel_scope is not None else CancelScope()
        svc = self.inference_service
        with self._bind_lock:
            self._stream_seq += 1
            tag = session or f"q{self._stream_seq}"
            plan = Binder(self.catalog, self.options).bind_select(stmt)
            svc.max_dispatch = int(self.options.get("max_dispatch_calls", 0))
            svc.speculative = bool(self.options.get("speculative_flush",
                                                    True))
            svc.cost_model = CostModel(self.stats_store, self.options)
            self._stamp_resilience(svc)
            pilot = self._make_pilot()
            opt = Optimizer(self.catalog, self.options,
                            stats=self.stats_store, pilot=pilot)
            plan = opt.optimize(plan)
        # deadline anchoring: operators derive their own deadline_ts from
        # the precedence-resolved deadline_ms (session < OPTIONS < WITH)
        # against this shared monotonic query start, so every expression
        # in the query races the same wall deadline
        extra: Dict[str, object] = {"tenant": tenant, "session": tag,
                                    "query_start_ts": time.monotonic()}
        if deadline_ms is not None:
            extra["deadline_ms"] = int(deadline_ms)
        ex = PlanExecutor(self.catalog, self._factory_with(extra),
                          chunk_size=int(self.options.get("chunk_size",
                                                          2048)),
                          stats_store=self.stats_store, cancel_scope=scope)
        plan_text = (plan_repr(plan) + "\n-- physical --\n"
                     + ex.physical_plan(plan) + "\n-- dispatch --\n"
                     + self._dispatch_repr() + "\n-- stats --\n"
                     + self._stats_repr(plan) + "\n-- cascade --\n"
                     + self._cascade_repr(plan) + "\n-- resilience --\n"
                     + self._resilience_repr() + "\n-- rewrites --\n"
                     + rewrites_section(opt.rewrite_events)) \
            if explain else None
        return QueryStream(self, plan, ex, scope, tag, tenant, plan_text,
                           pilot, t0)

    def _stamp_resilience(self, svc: InferenceService) -> None:
        """Push the session's resilience options onto the service before a
        query runs (mirrors the max_dispatch/speculative stamping)."""
        svc.call_timeout_s = float(self.options.get("call_timeout_s", 0)
                                   or 0)
        svc.set_breaker_policy(
            int(self.options.get("breaker_threshold", 3)),
            int(self.options.get("breaker_probe_every", 4)))

    def _resilience_repr(self) -> str:
        from repro_torch.core.faults import resilience_section
        return resilience_section(self.inference_service, self.options)

    def _dispatch_repr(self) -> str:
        o = self.options
        line = ("InferenceService inflight_windows={} batch_size={} "
                "n_threads={} rate_limit_rpm={} max_dispatch_calls={} "
                "use_dedup={} use_batching={} dispatch_workers={} "
                "speculative_flush={}".format(
                    o.get("inflight_windows", 1), o.get("batch_size", 16),
                    o.get("n_threads", 16), o.get("rate_limit_rpm", 0),
                    o.get("max_dispatch_calls", 0),
                    o.get("use_dedup", True), o.get("use_batching", True),
                    o.get("dispatch_workers", 1),
                    o.get("speculative_flush", True)))
        # serving-engine KV layout + session-cumulative prefix-reuse
        # counters, so prefix sharing is visible at the query layer.
        # Layouts come from the LIVE engines (a model can override the
        # session default per-entry); the option is the fallback before
        # any torch engine exists.
        hits = prefill = decoded = radix_toks = 0
        used = total = hwm = 0
        for eng in self._torch_engines.values():
            hits += eng.total.prefix_hits
            prefill += eng.total.prefill_tokens
            decoded += eng.total.output_tokens
            radix_toks += eng.total.radix_hit_tokens
            alloc = getattr(eng, "_alloc", None)
            if alloc is not None:
                used += alloc.resident_pages
                total += alloc.num_pages
                hwm += alloc.high_water
        layouts = sorted({k[1] for k in self._torch_engines}) \
            or [str(o.get("kv_layout", "dense"))]
        line += ("\nEngine kv_layout={} kv_page_size={} kv_quant={} "
                 "prefix_hits={} radix_hit_tokens={} prefill_tokens={} "
                 "decode_tokens={}".format(
                     ",".join(layouts), o.get("kv_page_size", 64),
                     o.get("kv_quant", "none"), hits, radix_toks,
                     prefill, decoded))
        line += "\npool: {}/{} pages, hwm={}".format(used, total, hwm)
        return line

    def _stats_repr(self, plan: Node) -> str:
        return stats_section(plan, self.stats_store,
                             CostModel(self.stats_store, self.options))

    def _cascade_repr(self, plan: Node) -> str:
        from repro_torch.core.cascade import cascade_section
        return cascade_section(plan, self.stats_store, self.options)

    def _make_pilot(self) -> Optional[PilotSampler]:
        if not bool(self.options.get("enable_pilot", True)):
            return None
        min_rows = self.options.get("pilot_min_rows")
        return PilotSampler(
            self._predict_factory, self.stats_store,
            sample_rows=int(self.options.get("pilot_sample_rows", 16)),
            min_table_rows=None if min_rows is None else int(min_rows))

    def explain(self, query: str) -> str:
        stmt = parse_sql(query)
        assert isinstance(stmt, SelectStmt)
        plan = Binder(self.catalog, self.options).bind_select(stmt)
        # no pilot sampling from EXPLAIN: explaining must stay side-effect
        # free; estimates use whatever the store has already observed
        optimizer = Optimizer(self.catalog, self.options,
                              stats=self.stats_store)
        opt = optimizer.optimize(plan)
        ex = PlanExecutor(self.catalog, self._predict_factory,
                          chunk_size=int(self.options.get("chunk_size", 2048)))
        return ("-- logical --\n" + plan_repr(plan)
                + "\n-- optimized --\n" + plan_repr(opt)
                + "\n-- physical --\n" + ex.physical_plan(opt)
                + "\n-- dispatch --\n" + self._dispatch_repr()
                + "\n-- stats --\n" + self._stats_repr(opt)
                + "\n-- cascade --\n" + self._cascade_repr(opt)
                + "\n-- resilience --\n" + self._resilience_repr()
                + "\n-- rewrites --\n"
                + rewrites_section(optimizer.rewrite_events))

    def _run_select(self, stmt: SelectStmt, explain: bool) -> QueryResult:
        t0 = time.time()
        plan = Binder(self.catalog, self.options).bind_select(stmt)
        svc = self.inference_service
        # apply the dispatch configuration BEFORE optimizing: pilot
        # sampling inside optimize() dispatches through the service too
        svc.max_dispatch = int(self.options.get("max_dispatch_calls", 0))
        svc.speculative = bool(self.options.get("speculative_flush", True))
        # fresh cost model per query so SET option changes take effect;
        # drives the service's smallest-makespan-first flush ordering
        svc.cost_model = CostModel(self.stats_store, self.options)
        self._stamp_resilience(svc)
        pilot = self._make_pilot()
        opt = Optimizer(self.catalog, self.options, stats=self.stats_store,
                        pilot=pilot)
        plan = opt.optimize(plan)
        # one monotonic anchor per query: deadline_ms (from any precedence
        # level) counts down from here in every operator
        extra: Dict[str, object] = {"query_start_ts": time.monotonic()}
        ex = PlanExecutor(self.catalog, self._factory_with(extra),
                          chunk_size=int(self.options.get("chunk_size", 2048)),
                          stats_store=self.stats_store)
        plan_text = (plan_repr(plan) + "\n-- physical --\n"
                     + ex.physical_plan(plan) + "\n-- dispatch --\n"
                     + self._dispatch_repr() + "\n-- stats --\n"
                     + self._stats_repr(plan) + "\n-- cascade --\n"
                     + self._cascade_repr(plan)) if explain else None
        before = dataclasses.replace(svc.stats)
        table = ex.run(plan)
        if plan_text is not None:
            # the resilience + rewrites sections close the report AFTER
            # execution so they can include what actually happened (retries
            # taken, breakers tripped, mid-query re-ranks)
            plan_text += ("\n-- resilience --\n" + self._resilience_repr()
                          + "\n-- rewrites --\n" + rewrites_section(
                              opt.rewrite_events, ex.rerank_log))
        st = ex.stats
        st.dispatch_batches = svc.stats.dispatch_batches \
            - before.dispatch_batches
        calls = svc.stats.dispatched_calls - before.dispatched_calls
        st.mean_batch_occupancy = (calls / st.dispatch_batches
                                   if st.dispatch_batches else 0.0)
        st.inflight_dedup_hits = svc.stats.inflight_dedup_hits \
            - before.inflight_dedup_hits
        # service-side resilience counters (operator-side retry/drop/
        # degradation counts are already absorbed from the op stats)
        st.backend_timeouts = svc.stats.backend_timeouts \
            - before.backend_timeouts
        st.breaker_rejections = svc.stats.breaker_rejections \
            - before.breaker_rejections
        if pilot is not None and pilot.calls:
            # pilot work is part of the query's honest accounting: calls
            # are kept in their own counter, tokens/latency join the totals
            st.pilot_calls = pilot.calls
            st.in_tokens += pilot.in_tokens
            st.out_tokens += pilot.out_tokens
            st.sim_latency_s += pilot.sim_latency_s
        st.wall_s = time.time() - t0
        self.last_stats = st
        return QueryResult(table, st, plan_text)


class QueryStream:
    """One streaming query session (created by `IPDB.stream`).

    Iterate `chunks()` to drain the chunked physical pipeline; each yielded
    Table is one result chunk, produced as soon as the pipeline finishes
    it.  `stats` is populated when the stream ends (normally, by
    cancellation, or by abandoning the iterator) from the service's
    per-session counters — never from global deltas, so concurrent streams
    account exactly.  `cancel()` (or firing the scope from any thread)
    raises QueryCancelled at the executing thread's next chunk boundary
    AND immediately drops the session's still-queued service requests, so
    a cancelled stream stops consuming dispatch within one flush."""

    def __init__(self, db: IPDB, plan: Node, executor: PlanExecutor,
                 scope: CancelScope, session: str, tenant: str,
                 plan_text: Optional[str], pilot: Optional[PilotSampler],
                 t0: float):
        self.db = db
        self.scope = scope
        self.session = session
        self.tenant = tenant
        self.plan = plan_text
        self.stats: Optional[ExecStats] = None
        self.cancelled = False
        self._plan_node = plan
        self._ex = executor
        self._pilot = pilot
        self._t0 = t0
        self._finished = threading.Event()
        scope.add_callback(self._on_cancel)

    # runs on the CANCELLING thread (not the executing one): dropping the
    # queued requests here — instead of waiting for the executing thread
    # to notice — is what bounds cancellation to one flush
    def _on_cancel(self) -> None:
        svc = self.db.inference_service
        svc.cancel_session(self.session)
        if self._finished.is_set():
            # scope fired after the stream already finished and released
            # its tag; drop the tombstone cancel_session just re-created
            svc.release_session(self.session)

    def cancel(self, reason: str = "") -> bool:
        return self.scope.cancel(reason)

    def chunks(self) -> Iterator[Table]:
        gen = self._ex.run_chunks(self._plan_node)
        try:
            for chunk in gen:
                yield chunk
        except QueryCancelled:
            self.cancelled = True
        finally:
            gen.close()
            self._finish()

    def run(self) -> QueryResult:
        """Materialize the whole stream (tests / non-streaming callers)."""
        parts = list(self.chunks())
        table: Optional[Table] = None
        if parts:
            table = parts[0]
            for p in parts[1:]:
                table = table.concat(p)
        return QueryResult(table, self.stats, self.plan)

    def _finish(self) -> None:
        if self._finished.is_set():
            return
        svc = self.db.inference_service
        st = self._ex.stats
        sess = svc.session_stats(self.session)
        if sess is not None:
            st.dispatch_batches = sess.dispatch_batches
            st.mean_batch_occupancy = (
                sess.dispatched_calls / sess.dispatch_batches
                if sess.dispatch_batches else 0.0)
            st.inflight_dedup_hits = sess.inflight_dedup_hits
            st.cancelled_requests = sess.cancelled_requests
            st.backend_timeouts = sess.backend_timeouts
            st.breaker_rejections = sess.breaker_rejections
        st.cancelled = self.cancelled
        if self._pilot is not None and self._pilot.calls:
            st.pilot_calls = self._pilot.calls
            st.in_tokens += self._pilot.in_tokens
            st.out_tokens += self._pilot.out_tokens
            st.sim_latency_s += self._pilot.sim_latency_s
        st.wall_s = time.time() - self._t0
        self.stats = st
        self.db.last_stats = st
        self._finished.set()
        svc.release_session(self.session)
