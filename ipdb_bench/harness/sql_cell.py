"""A SQL cell: bulk semantic projections over FoodReviews through
``repro_torch.core.database.IPDB.sql``.

The window is made of whole queries, each over 1014 review rows that no
earlier query of the run read (fresh ``#visit`` tags from the seed, so the
database's prompt cache misses).  It starts when the first timed query is
issued and ends when the first query that finishes after `seconds`
returns.  ``rows_per_s`` is the rows answered (an answer that parsed under
the schema) over the window's seconds.
"""
from __future__ import annotations

import gc
import json
import time
from typing import Dict

import torch

from ipdb_bench.harness import foodreviews, weights
from ipdb_bench.harness.spans import Instruments
from ipdb_bench.reference import judge


def _query_sql(traffic: dict, table: str, preamble: str,
               model: str = "m") -> str:
    out = ", ".join(traffic["select"])
    return (f"SELECT {out}, LLM {model} (PROMPT '{preamble}"
            f"{traffic['prompt']}') AS {traffic['out_col']} FROM {table}")


def _options_sql(opts: Dict[str, object]) -> str:
    def lit(v):
        return f"'{v}'" if isinstance(v, str) else repr(v)
    return ", ".join(f"'{k}': {lit(v)}" for k, v in opts.items())


def run(ctx) -> dict:
    from repro_torch.core.database import IPDB
    from repro_torch.core.executors import TorchExecutor
    from repro_torch.relational.table import Table
    from repro_torch.serving.engine import InferenceEngine

    traffic, dev, seed = ctx.traffic, ctx.device, ctx.seed
    model = ctx.model()
    cfg = weights.model_config({"model": model})
    traffic = {**traffic, **ctx.override.get("traffic", {})}
    eng_opts = dict(traffic["engine"])
    params = weights.make_weights(cfg, seed, dev, ctx.config.get("init"))
    inst = Instruments(ctx.trace, ctx.wraps()).install()
    try:
        engine = InferenceEngine(cfg, params, seed=seed % 2**63,
                                 device=dev, **eng_opts)
        db = IPDB(device=dev)

        def factory(entry):
            ex = TorchExecutor(engine)
            ex.configure(dict(entry.options))
            return ex
        db.register_executor("bench", factory)
        db.sql("CREATE LLM MODEL m PATH 'custom:bench' ON PROMPT OPTIONS "
               f"{{ {_options_sql(traffic['options'])} }}")
        preamble = foodreviews.fewshot_preamble(
            seed, int(traffic.get("fewshot_bytes", 0)))
        n_rows = int(traffic["rows_per_query"])

        def query(k: int):
            rows = foodreviews.fresh_table(seed, k, n_rows)
            name = f"Reviews{k}"
            db.register_table(name, Table.from_rows(rows))
            r = db.sql(_query_sql(traffic, name, preamble))
            return rows, r.table.rows()

        warm(engine, db, traffic, seed, preamble)
        k = 1
        if ctx.fault is not None:
            ctx.fault(engine)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        inst.reset()
        before = {f: getattr(engine.total, f) for f in
                  ("output_tokens", "decode_steps", "prefill_tokens",
                   "radix_hit_tokens")}
        ctx.setup_done()
        prof = ctx.profiler()
        results, query_s = [], []
        with prof:
            t0 = t1 = time.perf_counter()
            while True:
                rows_in, rows_out = query(k)
                k += 1
                query_s.append(time.perf_counter() - t1)
                t1 = time.perf_counter()
                results.append((rows_in, rows_out))
                # a traced window is one query: the device's events of
                # one query are ~10^6
                if ctx.trace or t1 - t0 >= ctx.seconds:
                    break
        window = t1 - t0
        after = {f: getattr(engine.total, f) for f in before}
        out_col = traffic["out_col"]
        attempted = sum(len(r) for r, _ in results)
        answered = sum(1 for _, rows in results for r in rows
                       if isinstance(r.get(out_col), str))
        ctx.read_memory()
        reading = {"window_s": window, "rows": answered,
                   "query_s": query_s,
                   "gen": {f: after[f] - before[f] for f in before},
                   "num_slots": int(traffic["options"]["num_slots"]),
                   "spans": {k2: list(v) for k2, v in inst.spans.items()},
                   "kernels": inst.kernels,
                   "requests": list(inst.requests),
                   "n_params": weights.matmul_params(
                       params, bool(cfg.tie_embeddings)),
                   "model": model}
        if ctx.trace:
            ctx.read_trace(prof, window, inst.ranges, reading)
        metrics = {"rows_per_s": (answered / window, "rows/s")}
        requests = list(inst.requests)
        program = _program_logits(inst.samples, requests)
    finally:
        inst.remove()
    # the program's state goes before the reference runs
    del engine, db
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    fields = [(traffic["out_field"], "VARCHAR")]
    max_str = int(traffic["options"]["max_str"])
    checks = judge.check_rows(
        results, requests, fields, key=traffic["select"][0],
        inputs=traffic["inputs"], out_cols=[out_col], max_str=max_str)
    picked = judge.pick(requests, ctx.sample_calls, seed)
    with _no_tf32():
        checks.update(judge.check_logits(model, params, requests, picked,
                                         fields, max_str, ctx.control,
                                         program))
    return {"attempted": attempted, "failed": attempted - answered,
            "metrics": metrics, "checks": checks, "reading": reading}


def _program_logits(samples, requests):
    """i -> the logits (n, 259) that the program chose request i's n
    served tokens from: the rows of the slot its grammar held, round after
    round."""
    held = {}
    for r, (logits, gs) in enumerate(samples):
        for slot, g in enumerate(gs):
            if g is not None:
                held.setdefault(id(g), []).append((r, slot))

    def rows(i):
        got = held.get(id(requests[i][3]), [])
        if not got:
            return torch.zeros(0, samples[0][0].shape[1] if samples else 0)
        return torch.stack([samples[r][0][slot] for r, slot in got])
    return rows


def warm(engine, db, traffic: dict, seed: int, preamble: str) -> None:
    """Warm up the shapes of the cell's traffic and no others: the prompts
    of the first `calls` calls that the predict operator makes for a
    query (read through a probe executor, on rows no window query reads)
    run through the engine's batcher at the cell's slots for `new_tokens`
    tokens: the prefill bucket, the decode and sampling ticks at every
    slot, and, paged, the pool and the radix tree."""
    from repro_torch.core.executors import CallResult, Predictor
    from repro_torch.relational.table import Table
    from repro_torch.serving.grammar import Field, JsonGrammar
    from repro_torch.serving.scheduler import ContinuousBatcher, Request

    spec = traffic["warmup"]
    if not int(spec["calls"]):
        return
    opts = traffic["options"]
    seen = []

    class Probe(Predictor):
        def complete(self, prompt, schema, num_rows, *, shared_prefix="",
                     rows=None, instruction=""):
            seen.append((shared_prefix + prompt, num_rows))
            row = {n: "x" for n, _ in schema}
            text = json.dumps(row if num_rows == 1 else [row] * num_rows)
            return CallResult(text, 0, 0, 0.0, 0.0)

    db.register_executor("probe", lambda entry: Probe())
    db.sql("CREATE LLM MODEL probe PATH 'custom:probe' ON PROMPT OPTIONS "
           f"{{ {_options_sql(opts)} }}")
    rows = foodreviews.fresh_table(seed, 0, int(traffic["rows_per_query"]))
    db.register_table("Warm", Table.from_rows(rows))
    db.sql(_query_sql(traffic, "Warm", preamble, model="probe"))
    fields = [Field(traffic["out_field"], "VARCHAR")]
    reqs = [Request(prompt=p, grammar=JsonGrammar(
        fields, num_rows=nr, max_str=int(opts["max_str"])),
        max_new_tokens=int(spec["new_tokens"]))
        for p, nr in seen[:int(spec["calls"])]]
    ContinuousBatcher(engine, num_slots=int(opts["num_slots"])).run(
        reqs, temperature=float(opts["temperature"]))


class _no_tf32:
    """float32 products in float32 for the reference."""

    def __enter__(self):
        self.old = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.old
