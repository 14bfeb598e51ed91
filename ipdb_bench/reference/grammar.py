"""What a served answer may say next, worked out from the query's output
schema alone, as plain Python.

The answer to a call over n rows is ``[{"f1": "v", "f2": "v"}, ...]``
with n objects (one object without the brackets for n = 1), every value a
VARCHAR of 1 to `max_str` printable ASCII bytes other than the quote and
the backslash, then the end-of-sequence token.  Tokens are the bytes, with
257 the beginning and 258 the end of a sequence.

This file imports nothing of the program.
"""
from __future__ import annotations

from typing import Iterator, List, Sequence, Set, Tuple

BOS, EOS = 257, 258
QUOTE = ord('"')
STR_BYTES = frozenset(b for b in range(32, 127) if b not in (QUOTE, 92))


def encode(text: str) -> List[int]:
    """The byte tokens of a prompt, as a model reads it."""
    return [BOS] + list(text.encode("utf-8"))


def template(fields: Sequence[str], num_rows: int) -> List[Tuple[str, bytes]]:
    """The answer as literal pieces and string holes (``("str", b"")``)."""
    row: List[Tuple[str, bytes]] = []
    lit = b"{"
    for i, name in enumerate(fields):
        lit += (b", " if i else b"") + f'"{name}": "'.encode()
        row += [("lit", lit), ("str", b"")]
        lit = b'"'
    row.append(("lit", lit + b"}"))
    if num_rows == 1:
        return row
    out: List[Tuple[str, bytes]] = [("lit", b"[")]
    for r in range(num_rows):
        if r:
            out.append(("lit", b", "))
        out += row
    out.append(("lit", b"]"))
    merged: List[Tuple[str, bytes]] = []
    for kind, val in out:                 # adjacent literals as one
        if merged and kind == "lit" and merged[-1][0] == "lit":
            merged[-1] = ("lit", merged[-1][1] + val)
        else:
            merged.append((kind, val))
    return merged


def walk(fields: Sequence[str], num_rows: int, max_str: int,
         served: Sequence[int]) -> Iterator[Tuple[Set[int], int]]:
    """(the tokens allowed next, the token served) for each served token.
    Stops at the first token that is not allowed (after yielding it)."""
    segs = template(fields, num_rows)
    i, j = 0, 0                 # segment, bytes consumed in it
    for tok in served:
        if i == len(segs):
            allowed = {EOS}
        elif segs[i][0] == "lit":
            allowed = {segs[i][1][j]}
        else:
            allowed = set(STR_BYTES) if j < max_str else set()
            if j >= 1:
                allowed.add(segs[i + 1][1][0])      # the closing quote
        yield allowed, tok
        if tok not in allowed or i == len(segs):
            return
        if segs[i][0] == "lit":
            j += 1
            if j == len(segs[i][1]):
                i, j = i + 1, 0
        elif tok in STR_BYTES and j < max_str:
            j += 1
        else:                                      # the closing quote
            i, j = i + 1, 1
            if j == len(segs[i][1]):
                i, j = i + 1, 0
