"""FoodReviews, the iPDB paper's data set D2, as plain dicts.

Frozen copy of ``benchmarks/datasets.py::make_foodreviews`` (line 104),
rewritten without the JAX package's ``Table``.  Each review is unique by
its ``#visit<n>`` tag, so a query over a table that no earlier query read
misses the database's prompt cache.  ``fresh_table(seed, k, n)`` gives the
k-th such table of a run: its tags start at ``seed``'s own offset plus k·n,
so the tables of one run never share a review.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

ROWS = 1014          # the paper's D2 size: 1014 / 16 = 64 marshaled calls


def make_foodreviews(seed: int = 1, n: int = ROWS, first_tag: int = 0
                     ) -> List[Dict[str, object]]:
    """n rows {"rid", "review", "label_gt"}; the review text is drawn from
    `seed` exactly as the original draws it, the visit tags numbered from
    `first_tag`."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        is_food = bool(rng.uniform() < 0.55)
        text = (f"the burger and fries were {'cold' if rng.uniform()<.4 else 'tasty'}"
                if is_food else
                f"the staff was {'rude' if rng.uniform()<.4 else 'friendly'} at the counter")
        rows.append({"rid": i, "review": f"{text} #visit{first_tag + i}",
                     "label_gt": "food" if is_food else "service"})
    return rows


def fresh_table(seed: int, k: int, n: int = ROWS) -> List[Dict[str, object]]:
    """The k-th table of the run with `seed`: rows {"rid", "review"}.  The
    tags are the same size for every seed (7 digits), so every seed's
    prompts have the same lengths up to the review texts' own draw."""
    base = 1_000_000 + (seed % 4_000) * 2_000
    rows = make_foodreviews(seed=(seed * 1_000_003 + k) % 2**63, n=n,
                            first_tag=base + k * n)
    return [{"rid": r["rid"], "review": r["review"]} for r in rows]


def fewshot_preamble(seed: int, nbytes: int) -> str:
    """Labelled examples from the generator, `nbytes` bytes in all (cut at
    the last whole example, then padded with spaces): the few-shot part of
    an instruction that every call of a query shares.  It holds no brace
    and no quote, which the PROMPT string of a query cannot carry."""
    if nbytes <= 0:
        return ""
    rows = make_foodreviews(seed=seed, n=max(1, nbytes // 40), first_tag=0)
    parts, size = ["Examples:"], len("Examples:")
    for r in rows:
        ex = f" review: {r['review']} -> topic: {r['label_gt']};"
        if size + len(ex) > nbytes:
            break
        parts.append(ex)
        size += len(ex)
    return ("".join(parts)).ljust(nbytes)
