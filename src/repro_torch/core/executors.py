"""Model executors behind the physical predict operator (paper §5.4,
Table 4: Config / Load / PredictChunk / ScanChunk interface).

Three executors, mirroring the paper's ONNX / llama.cpp / LLM-API trio:
  * TorchExecutor   — the in-process PyTorch serving engine on the GPU
                      (grammar-forced generation; real compute, real wall
                      time).  Port of repro's JaxExecutor.
  * OracleExecutor  — deterministic semantic oracle with a calibrated
                      latency model + error injection. Used by the
                      accuracy-bearing benchmarks: it isolates the SYSTEMS
                      effects (calls/tokens/ordering) that the paper
                      evaluates, while exercising the same prompt/parse/
                      fallback code paths as a real model.
  * TabularExecutor — encoder/classifier models bound to a table
                      (CREATE TABULAR MODEL; hubert-style frame classifier)

All executors consume the SAME rewritten prompt text and return raw text;
structured parsing/validation lives in the predict operator.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os.path
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving import tokenizer as TOK


@dataclasses.dataclass
class CallResult:
    text: str
    in_tokens: int
    out_tokens: int
    sim_latency_s: float          # modeled provider latency (oracle) or wall
    wall_s: float
    # engine-side accounting (TorchExecutor fills these; remote-API-style
    # backends have no visible prefill/decode split and leave them 0)
    prefill_tokens: int = 0       # tokens actually prefit through the model
    decode_tokens: int = 0        # lock-step decode tokens generated
    prefix_hits: int = 0          # shared-prefix KV memo/radix hits
    radix_hit_tokens: int = 0     # prompt tokens served from the radix tree
    # per-answer confidence scores, one per returned row, aligned with the
    # parsed objects.  Backends with calibrated scores (tabular classifiers,
    # oracles carrying a "__confidence__" field) populate them; text-only
    # backends leave None, which readers treat as all-1.0 (logit-free).
    confidences: Optional[List[float]] = None
    # cascade accounting (CascadePredictor fills these; whole-batch counts
    # ride on the first result of a dispatch, like the engine counters)
    proxy_calls: int = 0          # proxy-stage complete_many prompt count
    escalated_calls: int = 0      # expensive-stage calls actually made
    cascade_rows: int = 0         # rows routed through the cascade
    escalated_rows: int = 0       # rows escalated to the expensive stage
    degraded_calls: int = 0       # expensive-stage calls skipped because the
                                  # backend was down (proxy-only degradation)


class Predictor:
    """Extensible executor interface (paper Table 4)."""
    name = "base"
    options: Dict[str, object] = {}
    #: hard cap on concurrent `complete_many` dispatches this backend can
    #: take (1 = not thread-safe, dispatch stays synchronous).  Stateless
    #: remote-API-style backends raise it; the in-process engine
    #: cannot (one engine, one compute stream).
    max_concurrency = 1

    def configure(self, options: Dict[str, object]) -> None:
        self.options = dict(options)

    def load(self) -> None:
        pass

    def dispatch_workers(self) -> int:
        """Effective dispatch-worker-pool size for this backend: the
        session/model `dispatch_workers` option clamped to the backend's
        declared `max_concurrency`.  1 (the default) keeps the old
        synchronous flush-on-the-submitting-thread behavior."""
        want = int(self.options.get("dispatch_workers", 1) or 1)
        return max(1, min(self.max_concurrency, want))

    def complete(self, prompt: str, schema: Sequence[Tuple[str, str]],
                 num_rows: int, *, shared_prefix: str = "",
                 rows: Optional[List[dict]] = None,
                 instruction: str = "") -> CallResult:
        raise NotImplementedError

    def complete_many(self, prompts: Sequence[str],
                      schema: Sequence[Tuple[str, str]],
                      num_rows_list: Sequence[int], *,
                      shared_prefix: str = "",
                      rows_list: Optional[List[Optional[List[dict]]]] = None,
                      instruction: str = "") -> List[CallResult]:
        """Answer a batch of marshaled prompts in one dispatch (the
        InferenceService entry point).  Base implementation loops
        `complete`; backends override with real batched execution."""
        rows_list = rows_list if rows_list is not None \
            else [None] * len(prompts)
        return [self.complete(p, schema, nr, shared_prefix=shared_prefix,
                              rows=r, instruction=instruction)
                for p, nr, r in zip(prompts, num_rows_list, rows_list)]

    def scan_chunk(self, prompt: str, schema, max_rows: int) -> CallResult:
        return self.complete(prompt, schema, max_rows, instruction=prompt)


# ---------------------------------------------------------------------------
class TorchExecutor(Predictor):
    """Local model executor: grammar-constrained generation on the
    in-process PyTorch engine (llama.cpp-analog, §5.2 'grammar forced
    generation').

    Single prompts go through `engine.generate` (keeping shared-prefix KV
    reuse); multi-prompt dispatches from the InferenceService run through
    ONE slot-based `ContinuousBatcher.run`, so relational queries get real
    continuous batching instead of sequential generate calls."""
    name = "torch"
    # one engine, one compute stream: dispatch batches must not overlap —
    # intra-dispatch parallelism comes from the continuous batcher instead
    max_concurrency = 1

    def __init__(self, engine):
        self.engine = engine
        self._batcher = None

    def _grammar(self, schema, num_rows):
        from repro_torch.serving.grammar import Field, JsonGrammar
        nr = num_rows if num_rows > 0 else \
            int(self.options.get("gen_rows", 4))     # table generation
        return JsonGrammar([Field(n, t) for n, t in schema], num_rows=nr,
                           max_str=int(self.options.get("max_str", 24)))

    def complete(self, prompt, schema, num_rows, *, shared_prefix="",
                 rows=None, instruction=""):
        g = self._grammar(schema, num_rows)
        ns = max(1, int(self.options.get("n_samples", 1)))
        t0 = time.time()
        res = self.engine.generate(
            [prompt] * ns, grammar=g, shared_prefix=shared_prefix,
            max_new_tokens=int(self.options.get("max_tokens", 4096)),
            temperature=float(self.options.get("temperature", 0.7)))
        wall = time.time() - t0
        s = res.stats
        if ns > 1:
            # self-consistency: majority text across the sampled streams
            # (the paged engine shares their prompt KV zero-copy)
            from repro_torch.serving.scheduler import _vote
            text = _vote(res.texts)
        else:
            text = res.texts[0]
        return CallResult(text, s.input_tokens, s.output_tokens,
                          wall, wall, prefill_tokens=s.prefill_tokens,
                          decode_tokens=s.output_tokens,
                          prefix_hits=s.prefix_hits,
                          radix_hit_tokens=s.radix_hit_tokens)

    def complete_many(self, prompts, schema, num_rows_list, *,
                      shared_prefix="", rows_list=None, instruction=""):
        paged = getattr(self.engine, "kv_layout", "dense") == "paged"
        # single prompt, or a shared instruction prefix under the DENSE
        # layout (whose per-slot prefill cannot KV-share): generate path.
        # The paged batcher CAN share a prefix — its pages are referenced,
        # not copied, by every slot's block table — so it keeps batching.
        if len(prompts) == 1 or (shared_prefix and not paged):
            return super().complete_many(
                prompts, schema, num_rows_list, shared_prefix=shared_prefix,
                rows_list=rows_list, instruction=instruction)
        from repro_torch.serving.scheduler import ContinuousBatcher, Request
        if self._batcher is None:
            self._batcher = ContinuousBatcher(
                self.engine, num_slots=int(self.options.get("num_slots", 8)))
        # `prompts` are suffixes EXCLUDING any caller-provided shared_prefix
        # (the InferenceService contract) — only a prefix WE carve out of
        # the prompts below may be stripped from them
        prefix = shared_prefix
        run_prompts = list(prompts)
        radix = getattr(self.engine, "prefix_cache_mode", "exact") == "radix"
        if paged and not prefix and not radix:
            # Exact mode only: marshaled prompts all start with the same
            # instruction text, so carve the common prefix out and prefill
            # it once into shared pages (only worth it at >= one full
            # page).  The radix engine skips this — partial overlap is
            # discovered token-by-token at match time, and a text-level
            # carve would only constrain it.
            #
            # The carve must land on a TOKEN boundary: tokens are UTF-8
            # bytes, so compare byte encodings (two prompts can share a
            # lead byte inside a multi-byte character that a character
            # comparison would miss), trim in byte units, then back off
            # until the cut decodes — prefix/suffix stay real strings.
            # Keep every suffix non-empty — a prompt that EQUALS the
            # common prefix must still contribute its last token to the
            # prefill.
            enc = [p.encode("utf-8") for p in run_prompts]
            cb = os.path.commonprefix(enc)
            cb = cb[:max(0, min(len(e) for e in enc) - 1)]
            common = ""
            while cb:
                try:
                    common = cb.decode("utf-8")
                    break
                except UnicodeDecodeError:
                    cb = cb[:-1]
            if TOK.count_tokens(common) + 1 >= self.engine.page_size:
                prefix = common
                run_prompts = [p[len(prefix):] for p in prompts]
        max_new = min(int(self.options.get("max_tokens", 4096)),
                      self.engine.max_len)
        ns = max(1, int(self.options.get("n_samples", 1)))
        reqs = [Request(prompt=p, grammar=self._grammar(schema, nr),
                        max_new_tokens=max_new, n_samples=ns)
                for p, nr in zip(run_prompts, num_rows_list)]
        bs = self._batcher.stats
        before = (bs.prefill_tokens, bs.output_tokens, bs.prefix_hits,
                  bs.radix_hit_tokens)
        t0 = time.time()
        done = self._batcher.run(
            reqs, temperature=float(self.options.get("temperature", 0.7)),
            shared_prefix=prefix if paged else "")
        per = (time.time() - t0) / max(1, len(done))
        out = []
        for orig, r in zip(prompts, done):
            text = r.text or ""
            out.append(CallResult(text,
                                  TOK.count_tokens(shared_prefix + orig),
                                  TOK.count_tokens(text), per, per))
        # whole-run engine accounting rides on the first result (per-row
        # attribution of lock-step prefill/decode work is arbitrary; the
        # operator only ever sums these)
        out[0].prefill_tokens = bs.prefill_tokens - before[0]
        out[0].decode_tokens = bs.output_tokens - before[1]
        out[0].prefix_hits = bs.prefix_hits - before[2]
        out[0].radix_hit_tokens = bs.radix_hit_tokens - before[3]
        return out


# ---------------------------------------------------------------------------
def default_latency_model(in_tokens: int, out_tokens: int) -> float:
    """Calibrated against paper Fig. 4 (o4-mini): ~2 s base + per-token."""
    return 2.0 + 2.5e-4 * in_tokens + 6e-3 * out_tokens


class OracleExecutor(Predictor):
    """Simulated remote LLM: answers come from a task oracle
    (benchmark-registered `oracle_fn(instruction, rows) -> List[dict]`),
    serialized as the same JSON a real model would emit, with seeded error
    injection so F1 < 1 and failure-handling paths run.

    Answers, rng draws and modeled latency are keyed by the prompt text
    alone, so the executor is batch-invariant AND thread-safe: it may take
    concurrent dispatches (`max_concurrency`).  `sleep_per_call_s` adds a
    real wall-clock sleep per answered call — an API round-trip stand-in
    that makes dispatch overlap measurable (`bench_multibackend`) without
    touching the modeled latency."""
    name = "oracle"
    max_concurrency = 32

    def __init__(self, oracle_fn: Callable[[str, List[dict]], List[dict]],
                 *, error_rate: float = 0.0, malform_rate: float = 0.0,
                 refusal_rate: float = 0.0,
                 latency_model: Callable[[int, int], float] = default_latency_model,
                 seed: int = 0, sleep_per_call_s: float = 0.0):
        self.oracle_fn = oracle_fn
        self.error_rate = error_rate
        self.malform_rate = malform_rate
        self.refusal_rate = refusal_rate
        self.latency_model = latency_model
        self.seed = seed
        self.sleep_per_call_s = float(sleep_per_call_s)

    def _rng(self, prompt: str) -> np.random.Generator:
        h = hashlib.sha256(f"{self.seed}:{prompt}".encode()).digest()
        return np.random.default_rng(int.from_bytes(h[:8], "little"))

    def _corrupt(self, val, typ, rng):
        t = typ.upper()
        if t == "BOOLEAN":
            return not bool(val)
        if t == "INTEGER":
            return int(val) + int(rng.integers(1, 5)) if val is not None else 0
        if t == "DOUBLE":
            return (float(val) if val is not None else 0.0) * float(rng.uniform(0.5, 2.0))
        return f"{val}x" if val else "unknown"

    def _answer(self, prompt, schema, num_rows, shared_prefix, rows,
                instruction) -> CallResult:
        """One request; the rng is keyed by the full prompt so answers are
        deterministic regardless of how requests were batched."""
        wall = self.sleep_per_call_s
        if wall:
            time.sleep(wall)
        rng = self._rng(prompt)
        full = shared_prefix + prompt
        in_toks = TOK.count_tokens(full)
        if rng.uniform() < self.refusal_rate:
            text = "I cannot help with that request."
            out = TOK.count_tokens(text)
            return CallResult(text, in_toks, out,
                              self.latency_model(in_toks, out), wall)
        answers = self.oracle_fn(instruction, rows or [{}] * num_rows)
        objs, confs = [], []
        # num_rows == 0 → table generation: the oracle decides cardinality
        take = answers if num_rows == 0 else answers[:num_rows]
        for r_ans in take:
            o = {}
            for name, typ in schema:
                v = r_ans.get(name)
                if rng.uniform() < self.error_rate:
                    v = self._corrupt(v, typ, rng)
                o[name] = v
            objs.append(o)
            # oracles may carry a per-row score under the reserved
            # "__confidence__" key; schema filtering keeps it out of `o`
            confs.append(float(r_ans.get("__confidence__", 1.0)))
        while len(objs) < num_rows:
            objs.append({name: None for name, _ in schema})
            confs.append(0.0)
        text = json.dumps(objs[0] if num_rows == 1 else objs)
        if rng.uniform() < self.malform_rate:
            text = "Sure! Here is the result:\n" + text[:max(3, len(text) - 5)]
        out_toks = TOK.count_tokens(text)
        return CallResult(text, in_toks, out_toks,
                          self.latency_model(in_toks, out_toks), wall,
                          confidences=confs if num_rows > 0 else None)

    def complete(self, prompt, schema, num_rows, *, shared_prefix="",
                 rows=None, instruction=""):
        return self._answer(prompt, schema, num_rows, shared_prefix, rows,
                            instruction)

    def complete_many(self, prompts, schema, num_rows_list, *,
                      shared_prefix="", rows_list=None, instruction=""):
        # baseline emulations override complete(); route through it so
        # their behavior (refusal abort, unstructured output) is preserved
        if type(self).complete is not OracleExecutor.complete:
            return super().complete_many(
                prompts, schema, num_rows_list, shared_prefix=shared_prefix,
                rows_list=rows_list, instruction=instruction)
        rows_list = rows_list if rows_list is not None \
            else [None] * len(prompts)
        return [self._answer(p, schema, nr, shared_prefix, r, instruction)
                for p, nr, r in zip(prompts, num_rows_list, rows_list)]


# ---------------------------------------------------------------------------
class TabularExecutor(Predictor):
    """CREATE TABULAR MODEL executor: features in, typed outputs out, no
    prompting (paper Listing 4). predict_fn maps a feature-row list to
    output dicts — backed by e.g. the hubert encoder config or any
    ONNX-analog callable."""
    name = "tabular"

    def __init__(self, predict_fn: Callable[[List[dict]], List[dict]],
                 latency_per_row: float = 1e-4, max_concurrency: int = 1):
        self.predict_fn = predict_fn
        self.latency_per_row = latency_per_row
        # concurrency is a property of the wrapped callable: pure feature
        # mappers can take parallel dispatches, stateful ones cannot
        self.max_concurrency = max(1, int(max_concurrency))

    def complete(self, prompt, schema, num_rows, *, shared_prefix="",
                 rows=None, instruction=""):
        t0 = time.time()
        outs = self.predict_fn(rows or [])
        objs = [{n: o.get(n) for n, _ in schema} for o in outs]
        confs = [float(o.get("__confidence__", 1.0)) for o in outs]
        text = json.dumps(objs[0] if num_rows == 1 else objs)
        wall = time.time() - t0
        return CallResult(text, 0, 0,
                          max(wall, self.latency_per_row * max(1, num_rows)),
                          wall, confidences=confs or None)

    def complete_many(self, prompts, schema, num_rows_list, *,
                      shared_prefix="", rows_list=None, instruction=""):
        """Vectorized dispatch: all requests' feature rows go through ONE
        predict_fn call, then the outputs are split back per request."""
        rows_list = rows_list if rows_list is not None \
            else [[] for _ in prompts]
        t0 = time.time()
        flat = [r for rws in rows_list for r in (rws or [])]
        outs = self.predict_fn(flat)
        per = (time.time() - t0) / max(1, len(prompts))
        results, off = [], 0
        for rws, nr in zip(rows_list, num_rows_list):
            k = len(rws or [])
            part = outs[off:off + k]
            objs = [{n: o.get(n) for n, _ in schema} for o in part]
            confs = [float(o.get("__confidence__", 1.0)) for o in part]
            off += k
            text = json.dumps(objs[0] if nr == 1 else objs)
            results.append(CallResult(
                text, 0, 0,
                max(per, self.latency_per_row * max(1, nr)), per,
                confidences=confs or None))
        return results
