"""Calibrated model cascades: proxy-scored semantic operators with
accuracy contracts (Cortex AISQL / Larch, PAPERS.md).

A `CascadePredictor` composes two registered backends behind the ordinary
`Predictor` interface, so every existing layer (PredictOperator marshaling,
InferenceService lanes, the optimizer's cost estimates) works unchanged:

  proxy stage      ONE batched `complete_many` scores every marshaled
                   prompt; per-row confidence comes from
                   `CallResult.confidences` (never re-parsed from text —
                   text-only backends degrade to a logit-free 1.0).
  threshold pair   a calibrated (tau_pos, tau_neg) acceptance pair per
                   proxy verdict: rows at-or-above their class threshold
                   resolve immediately, rows below EITHER threshold form
                   the escalation band.
  expensive stage  only the escalation band re-enters the expensive
                   backend — escalated rows from ALL prompts in the
                   dispatch batch are re-marshaled into `batch_size`-row
                   prompts, so the expensive model sees full batches, not
                   per-row dribble.

Calibration is a SNAPSHOT taken once per query (`load()`): thresholds come
from the per-(model, instruction) held-out reservoir in the
StatisticsStore (`calibrate_cascade`), targeting the user-declared
contract (`cascade_target_precision` via db option, model OPTIONS, or
`PREDICT ... WITH (...)`).  Evidence recorded while the query runs —
escalated-row agreement, score sketches, periodic audits of
would-be-accepted rows — only affects FUTURE queries, which keeps routing
a pure function of the batch contents (the PR 4 determinism contract).

Stats accounting is stage-split to fix the double-count: the cascade
records proxy-stage calls under (proxy_model, instruction) and
expensive-stage calls under the BASE (model, instruction) key — so the
cost model's direct-route estimate stays observed — while the
InferenceService records the merged two-stage call under the
`staged_key(..., "cascade")` tag (`Predictor.stats_stage`).
"""
from __future__ import annotations

import hashlib
import json
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.executors import CallResult, Predictor
from repro_torch.core.faults import TransientError
from repro_torch.core.predict import parse_structured, render_rows
from repro_torch.core.stats import (CascadeCalibration, StatisticsStore,
                              stats_key)

__all__ = ["CascadePredictor", "confidences_of", "row_hash",
           "cascade_section"]


def confidences_of(res: CallResult, num_rows: int) -> List[float]:
    """Per-row confidence vector for one call result: `None` (a text-only
    backend with no score channel) reads as all-1.0, short vectors pad
    with 0.0 (rows the backend could not answer)."""
    if res.confidences is None:
        return [1.0] * num_rows
    confs = [float(c) for c in res.confidences[:num_rows]]
    confs.extend([0.0] * (num_rows - len(confs)))
    return confs


def row_hash(instruction: str, row: dict) -> int:
    """Deterministic 64-bit identity of one (instruction, input row) pair:
    keys the agreement reservoir and the audit schedule, so both are
    independent of batch composition and dispatch order."""
    payload = json.dumps([instruction, sorted(row.items())], default=str)
    return int.from_bytes(hashlib.sha256(payload.encode()).digest()[:8],
                          "little")


class CascadePredictor(Predictor):
    """Two-stage cascade behind the `Predictor` interface.

    The dispatch concurrency it declares is the MIN of its stages (a
    dispatch runs both), so the InferenceService gives the cascade its own
    lane and overlapping chunks pipeline through proxy and expensive
    stages exactly like any concurrency-capable backend."""
    name = "cascade"
    #: stage tag: requests routed through this executor batch/dedup/record
    #: separately from the direct route (see `service.staged_key`)
    stats_stage = "cascade"

    def __init__(self, proxy: Predictor, expensive: Predictor, *,
                 store: Optional[StatisticsStore] = None,
                 key: Tuple[str, str] = ("", ""), proxy_model: str = "",
                 target_precision: float = 0.9, min_records: int = 8,
                 audit_every: int = 16, breaker=None):
        self.proxy = proxy
        self.expensive = expensive
        self.store = store
        # optional CircuitBreaker guarding the expensive backend (the
        # database wires the service's per-model breaker in).  When it is
        # open — or the expensive stage throws a TransientError — the
        # escalation band falls back to the proxy's answers (graceful
        # degradation) instead of failing the whole batch; passthrough
        # prompts keep the raw proxy text and rely on the operator's
        # parse-retry path once the backend recovers.
        self.breaker = breaker
        self.key = key
        self.proxy_model = proxy_model or getattr(proxy, "name", "proxy")
        self.target_precision = float(target_precision)
        self.min_records = max(1, int(min_records))
        # 1-in-N deterministic audit of would-be-accepted rows (by row
        # hash): keeps the held-out reservoir honest after calibration
        # converges.  0 disables auditing.
        self.audit_every = max(0, int(audit_every))
        self.max_concurrency = min(proxy.max_concurrency,
                                   expensive.max_concurrency)
        self.calibration = CascadeCalibration(target=self.target_precision)

    # -- lifecycle ---------------------------------------------------------
    def configure(self, options: Dict[str, object]) -> None:
        super().configure(options)
        self.proxy.configure(options)
        self.expensive.configure(options)

    def load(self) -> None:
        self.proxy.load()
        self.expensive.load()
        # calibration snapshot for the whole query: prefer the thresholds
        # the optimizer stamped on the plan (EXPLAIN shows exactly what
        # runs), else calibrate from the store now
        opts = self.options or {}
        if "cascade_tau_pos" in opts:
            self.calibration = CascadeCalibration(
                target=float(opts.get("cascade_target_precision",
                                      self.target_precision)),
                tau_pos=float(opts["cascade_tau_pos"]),
                tau_neg=float(opts.get("cascade_tau_neg", 2.0)),
                escalation_rate=float(opts.get("cascade_esc_rate", 1.0)),
                status=str(opts.get("cascade_status", "ok")))
        elif self.store is not None:
            self.calibration = self.store.calibrate_cascade(
                self.key, self.target_precision,
                min_records=self.min_records)

    # -- dispatch ----------------------------------------------------------
    def complete(self, prompt, schema, num_rows, *, shared_prefix="",
                 rows=None, instruction=""):
        return self.complete_many(
            [prompt], schema, [num_rows], shared_prefix=shared_prefix,
            rows_list=[rows], instruction=instruction)[0]

    def complete_many(self, prompts, schema, num_rows_list, *,
                      shared_prefix="", rows_list=None, instruction=""):
        rows_list = rows_list if rows_list is not None \
            else [None] * len(prompts)
        cal = self.calibration
        # ---- proxy stage: score every prompt in one batched call --------
        pres_list = self.proxy.complete_many(
            prompts, schema, num_rows_list, shared_prefix=shared_prefix,
            rows_list=rows_list, instruction=instruction)
        if self.store is not None:
            pkey = (self.proxy_model, self.key[1])
            for pr in pres_list:
                self.store.record_call(pkey, pr.in_tokens, pr.out_tokens,
                                       pr.sim_latency_s)

        boolean = bool(schema) and schema[0][1].upper() == "BOOLEAN"
        first_out = schema[0][0] if schema else None
        parsed_list: List[Optional[List[dict]]] = []
        confs_list: List[Optional[List[float]]] = []
        passthrough: List[int] = []    # prompt indices sent whole
        esc: List[Tuple] = []          # (pi, ri, row, preamble, conf,
        #                                 pos, hash, audited)
        scored_confs: List[float] = []
        scored_pos: List[bool] = []
        for pi, (prompt, nr, rows, pres) in enumerate(
                zip(prompts, num_rows_list, rows_list, pres_list)):
            parsed = parse_structured(pres.text, schema, nr) \
                if nr > 0 else None
            rendered = render_rows(rows) if rows else ""
            # rows we cannot re-marshal (table generation, aggregates,
            # unparseable proxy output) pass through to the expensive
            # stage unchanged — the cascade never degrades correctness
            if not rows or parsed is None or not prompt.endswith(rendered):
                parsed_list.append(None)
                confs_list.append(None)
                passthrough.append(pi)
                continue
            preamble = prompt[:len(prompt) - len(rendered)]
            confs = confidences_of(pres, nr)
            parsed_list.append(parsed)
            confs_list.append(confs)
            for ri in range(nr):
                pos = bool(parsed[ri].get(first_out)) if boolean else True
                conf = confs[ri]
                scored_confs.append(conf)
                scored_pos.append(pos)
                rh = row_hash(instruction, rows[ri])
                tau = cal.tau_pos if pos else cal.tau_neg
                audited = (conf >= tau and self.audit_every > 0
                           and cal.status == "ok"
                           and rh % self.audit_every == 0)
                if conf < tau or audited:
                    esc.append((pi, ri, rows[ri], preamble, conf, pos, rh,
                                audited))
        if self.store is not None and scored_confs:
            self.store.record_cascade_scores(self.key, scored_confs,
                                             scored_pos)

        # ---- expensive stage: re-marshal the escalation band ------------
        bs = int(self.options.get("batch_size", 16)) \
            if self.options.get("use_batching", True) else 1
        bs = max(1, bs)
        esc_groups = [esc[s:s + bs] for s in range(0, len(esc), bs)]
        exp_prompts: List[str] = []
        exp_nrs: List[int] = []
        exp_rows: List[Optional[List[dict]]] = []
        for g in esc_groups:
            g_rows = [e[2] for e in g]
            # every prompt in a dispatch batch shares its preamble (same
            # queue key ⇒ same instruction/schema), so the first
            # contributor's preamble re-marshals the group faithfully
            exp_prompts.append(g[0][3] + render_rows(g_rows))
            exp_nrs.append(len(g_rows))
            exp_rows.append(g_rows)
        for pi in passthrough:
            exp_prompts.append(prompts[pi])
            exp_nrs.append(num_rows_list[pi])
            exp_rows.append(rows_list[pi])
        eres_list: List[CallResult] = []
        degraded = False
        if exp_prompts:
            if self.breaker is not None and not self.breaker.allow():
                degraded = True        # breaker open: proxy-only fallback
            else:
                try:
                    eres_list = self.expensive.complete_many(
                        exp_prompts, schema, exp_nrs,
                        shared_prefix=shared_prefix, rows_list=exp_rows,
                        instruction=instruction)
                except TransientError:
                    if self.breaker is not None:
                        self.breaker.record_failure()
                    degraded = True
                else:
                    if self.breaker is not None:
                        self.breaker.record_success()
            if self.store is not None:
                for er in eres_list:
                    # base key: the cost model's direct-route estimate
                    # keeps observing the expensive backend
                    self.store.record_call(self.key, er.in_tokens,
                                           er.out_tokens, er.sim_latency_s)

        # ---- merge: splice expensive verdicts over proxy answers --------
        for gi, g in enumerate(esc_groups):
            if gi >= len(eres_list):
                break                  # degraded: keep the proxy answers
            eparsed = parse_structured(eres_list[gi].text, schema, len(g))
            for k, (pi, ri, row, _pre, conf, pos, rh, audited) in \
                    enumerate(g):
                if eparsed is None:
                    continue           # keep the proxy answer
                exp_obj = eparsed[k]
                if self.store is not None:
                    agree = exp_obj == parsed_list[pi][ri]
                    self.store.record_cascade_agreement(
                        self.key, rh, conf, pos, agree, audited=audited)
                parsed_list[pi][ri] = exp_obj
                confs_list[pi][ri] = confidences_of(
                    eres_list[gi], len(g))[k]

        merged: List[CallResult] = []
        pt_results = dict(zip(passthrough, eres_list[len(esc_groups):]))
        for pi, (nr, pres) in enumerate(zip(num_rows_list, pres_list)):
            if parsed_list[pi] is None:
                er = pt_results.get(pi)
                if er is None:
                    # degraded passthrough: only the proxy's raw text is
                    # available — the operator's parse/retry path decides
                    # what survives
                    merged.append(CallResult(
                        pres.text, pres.in_tokens, pres.out_tokens,
                        pres.sim_latency_s, pres.wall_s,
                        confidences=pres.confidences))
                    continue
                merged.append(CallResult(
                    er.text, pres.in_tokens + er.in_tokens,
                    pres.out_tokens + er.out_tokens,
                    pres.sim_latency_s + er.sim_latency_s,
                    pres.wall_s + er.wall_s, confidences=er.confidences))
                continue
            objs = parsed_list[pi]
            text = json.dumps(objs[0] if nr == 1 else objs)
            merged.append(CallResult(
                text, pres.in_tokens, pres.out_tokens, pres.sim_latency_s,
                pres.wall_s, confidences=confs_list[pi]))
        # escalation-group cost rides on the group's first contributor
        for gi, g in enumerate(esc_groups):
            if gi >= len(eres_list):
                break                  # degraded: no expensive cost to add
            er, m = eres_list[gi], merged[g[0][0]]
            m.in_tokens += er.in_tokens
            m.out_tokens += er.out_tokens
            m.sim_latency_s += er.sim_latency_s
            m.wall_s += er.wall_s

        routed = sum(nr for pl, nr in zip(parsed_list, num_rows_list)
                     if pl is not None)
        if merged:
            # whole-batch cascade accounting on the first result, like the
            # JAX engine counters (operators only ever sum these)
            merged[0].proxy_calls += len(prompts)
            merged[0].escalated_calls += len(eres_list)
            merged[0].cascade_rows += routed
            merged[0].escalated_rows += len(esc)
            if degraded:
                merged[0].degraded_calls += len(exp_prompts)
        if self.store is not None:
            self.store.record_cascade_batch(
                self.key, routed, len(esc), len(prompts), len(eres_list),
                degraded=int(degraded))
        return merged


# ---------------------------------------------------------------------------
def cascade_section(plan, store: Optional[StatisticsStore],
                    options: Optional[Dict[str, object]] = None) -> str:
    """EXPLAIN `-- cascade --` body: per cascaded operator the chosen
    route, the threshold pair, the contract with its empirical estimate,
    and the estimated vs observed escalation rate."""
    from repro_torch.relational.plan import Predict, SemanticJoin, walk_plan

    def fmt(v, spec="{:.3f}"):
        return spec.format(v) if v is not None else "n/a"

    lines: List[str] = []
    for node in walk_plan(plan):
        if not isinstance(node, (Predict, SemanticJoin)):
            continue
        info = node.info
        opts = {**(options or {}), **(info.options or {})}
        proxy = opts.get("cascade_proxy")
        if not proxy:
            continue
        key = stats_key(info)
        route = str(opts.get("cascade_route", "cascade"))
        status = str(opts.get("cascade_status", "cold"))
        target = opts.get("cascade_target_precision")
        tau_pos = opts.get("cascade_tau_pos")
        tau_neg = opts.get("cascade_tau_neg")
        esc_rate = opts.get("cascade_esc_rate")
        rec = store.cascade_get(key) if store is not None else None
        emp = held = None
        observed = "none"
        if rec is not None:
            held = rec.n_records
            if rec.audited > 0:
                emp = rec.audit_agree / rec.audited
            if rec.routed_rows:
                observed = (f"rows={rec.escalated_rows}/{rec.routed_rows} "
                            f"proxy_calls={rec.proxy_calls} "
                            f"expensive_calls={rec.expensive_calls}")
            if rec.degraded_batches > 0:
                # proxy-only fallback fired (expensive backend down /
                # breaker open): the contract is not currently enforced
                status = "degraded"
                observed += f" degraded_batches={rec.degraded_batches}"
        kind = type(node).__name__
        instr = key[1] if len(key[1]) <= 48 else key[1][:45] + "..."
        lines.append(
            f"{kind}[{info.model_name}] '{instr}'\n"
            f"  route={route} proxy={proxy} status={status}\n"
            f"  thresholds: accept_pos>={fmt(tau_pos)} "
            f"accept_neg>={fmt(tau_neg)}\n"
            f"  contract: target_precision={fmt(target)} "
            f"empirical={fmt(emp)} "
            f"held_out={held if held is not None else 0}\n"
            f"  escalation: est_rate={fmt(esc_rate)} observed={observed}")
    return "\n".join(lines) if lines else "(no cascaded operators)"
