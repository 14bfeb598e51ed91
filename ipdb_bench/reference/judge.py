"""The comparison that decides `correct` for a SQL cell, in plain PyTorch
and Python.

* rows: every row a window query read comes back once, with an answer that
  the output schema allows (``schema``), and the query's result equals a
  plain evaluation of the projection over the served answers
  (``relational``);
* logits: for a sample of the served calls, the reference runs once over
  the prompt and the served tokens, and at each served token reads how far
  that token's logit lies below the best logit among the tokens the schema
  allows there (``logit_gap``: the widest such gap; the engine decodes
  greedily, so a sound program serves the reference's best token up to
  rounding), and how far the logits the program chose from (captured on
  the timed path) lie from the reference's over the allowed tokens
  (``logit_err``: the widest difference);
* the sampler: each served token is the best allowed one of the program's
  own logits, lowest index on ties (``sampler_mismatch``: tokens that are
  not).

This file imports nothing of the program.
"""
from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ipdb_bench.reference import grammar, models

_ROWS_RE = re.compile(r"Inputs \((\d+) rows [^:]*: ")


def prompt_rows(prompt: str) -> Optional[List[dict]]:
    """The input rows a call's prompt carries, in order."""
    m = _ROWS_RE.search(prompt)
    if m is not None:
        return json.loads(prompt[m.end():])
    at = prompt.rfind("Input: ")
    return None if at < 0 else [json.loads(prompt[at + len("Input: "):])]


def served_tokens(text: Optional[str], error) -> List[int]:
    toks = list((text or "").encode("utf-8"))
    return toks + ([grammar.EOS] if error is None else [])


def answers(requests: Sequence[tuple], fields: Sequence[str]
            ) -> Dict[Tuple[str, str], object]:
    """(input column, value) -> the answer dict a served call gave for
    that input row, from every call that parsed; later calls (retries)
    win."""
    out: Dict[Tuple[str, str], object] = {}
    for prompt, text, error, *_ in requests:
        rows = prompt_rows(prompt)
        if rows is None or error is not None or text is None:
            continue
        try:
            got = json.loads(text)
        except ValueError:
            continue
        got = got if isinstance(got, list) else [got]
        if len(got) != len(rows):
            continue
        for r, a in zip(rows, got):
            out[tuple(sorted(r.items()))] = a
    return out


def check_rows(tables: Sequence[Tuple[List[dict], List[dict]]],
               requests: Sequence[tuple], fields: Sequence[Tuple[str, str]],
               key: str, inputs: Sequence[str], out_cols: Sequence[str],
               max_str: int) -> Dict[str, int]:
    """tables: (input rows, result rows) of each window query.  Counts rows
    that are missing or doubled, answers outside the schema, and result
    rows that differ from the plain projection over the served answers."""
    served = answers(requests, [f for f, _ in fields])
    missing = schema = relational = 0
    for rows_in, rows_out in tables:
        by_key = {}
        for r in rows_out:
            by_key.setdefault(r.get(key), []).append(r)
        for r in rows_in:
            got = by_key.get(r[key], [])
            if len(got) != 1:
                missing += 1
                continue
            got = got[0]
            ans = served.get(tuple(sorted((c, r[c]) for c in inputs)))
            for (f, _), col in zip(fields, out_cols):
                v = got.get(col)
                if not (isinstance(v, str) and 1 <= len(v) <= max_str
                        and all(ord(c) in grammar.STR_BYTES for c in v)):
                    schema += 1
                want = None if ans is None else ans.get(f)
                if v != want:
                    relational += 1
    return {"rows_missing": missing, "schema_violations": schema,
            "relational_mismatch": relational}


def pick(requests: Sequence[tuple], n: int, seed: int) -> List[int]:
    """The calls to hold to the reference: the longest served one and n-1
    others drawn from `seed`."""
    ok = [i for i, (_, text, error, *_) in enumerate(requests)
          if error is None and text]
    if not ok:
        return []
    size = [len(requests[i][0]) + len(requests[i][1]) for i in ok]
    longest = ok[int(np.argmax(size))]
    rest = [i for i in ok if i != longest]
    rng = np.random.default_rng(seed % 2**63)
    extra = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) \
        if rest and n > 1 else []
    return [longest] + [rest[int(k)] for k in extra]


def _prepare(prompt: str, text: str, fields, max_str: int):
    """(the sequence to run, the positions to read, the allowed mask
    (n, 259), the served tokens (n,)) of one served call."""
    ids = grammar.encode(prompt)
    served = served_tokens(text, None)
    steps = list(grammar.walk([f for f, _ in fields], len(prompt_rows(prompt)),
                              max_str, served))
    n = len(steps)
    mask = torch.zeros(n, grammar.EOS + 1, dtype=torch.bool)
    for j, (allowed, _) in enumerate(steps):
        mask[j, sorted(allowed)] = True
    tok = torch.tensor([t for _, t in steps])
    return (ids + served[:n - 1], list(range(len(ids) - 1, len(ids) - 1 + n)),
            mask, tok)


def _numbers(ref, low, prog, mask, tok) -> dict:
    """The numbers of one call from the reference's logits, the control's
    (or None) and the program's (or None)."""
    C = mask.shape[1]
    ref = ref[:, :C]
    mask, tok = mask.to(ref.device), tok.to(ref.device)
    best = ref.masked_fill(~mask, float("-inf")).amax(dim=1)

    def gap_of(first):
        return float((best - ref.gather(1, first[:, None])[:, 0]).max())

    def err_of(other):
        return float((other[:, :C] - ref).abs().masked_fill(~mask, 0).max())

    def first(logits):
        return logits[:, :C].masked_fill(~mask, float("-inf")).argmax(dim=1)
    n = tok.shape[0]
    out = {"tokens_compared": n,
           "tokens_off_schema": int((~mask.gather(1, tok[:, None])).sum()),
           "logit_gap": gap_of(tok)}
    if prog is not None:
        p = prog[:n].to(ref.device, torch.float32)
        out["sampler_mismatch"] = int((first(p) != tok[:p.shape[0]]).sum()) \
            + abs(n - prog.shape[0])
        out["logit_err"] = err_of(p)
    if low is not None:
        out["control_gap"] = gap_of(first(low))
        out["control_err"] = err_of(low)
    return out


def check_logits(model: dict, W: dict, requests: Sequence[tuple],
                 picked: Sequence[int], fields, max_str: int, quant=None,
                 program=None, batch: int = 8) -> Dict[str, float]:
    """The numbers over the picked calls, run `batch` calls at a time:
    widest gaps and differences, summed counts.  `program(i)`: the logits
    the program chose call i's served tokens from."""
    total: Dict[str, float] = {}
    for b0 in range(0, len(picked), batch):
        part = picked[b0:b0 + batch]
        prep = [_prepare(requests[i][0], requests[i][1], fields, max_str)
                for i in part]
        seqs, ats = [p[0] for p in prep], [p[1] for p in prep]
        refs = models.logits_batch(model, W, seqs, ats)
        lows = [None] * len(part) if quant is None else \
            models.logits_batch(model, W, seqs, ats, quant)
        for i, p, ref, low in zip(part, prep, refs, lows):
            got = _numbers(ref, low, None if program is None else program(i),
                           p[2], p[3])
            for k, v in got.items():
                summed = k.startswith(("tokens", "sampler"))
                total[k] = total.get(k, 0) + v if summed else \
                    max(total.get(k, 0.0), v)
    return total
