"""Grammar-forced generation (iPDB §5.2), TPU-adapted.

The paper constrains llama.cpp's sampler with a BNF grammar. Here the
grammar is a byte-level pushdown automaton compiled from the PREDICT
clause's output schema (column names + SQL types): the decoder must emit

    {"col1": <v1>, "col2": <v2>, ...}            (single row)
    [{...}, {...}, ...]                          (marshaled rows)

The automaton steps on the host (O(bytes), trivially cheap next to a
forward pass) and emits a per-step vocab mask; the mask is APPLIED on
device by the fused `constrained_logits` Pallas kernel. Every reachable
terminal state yields a string that json.loads() accepts and that casts to
the declared SQL types — the paper's schema-compliance guarantee becomes a
mechanical property (tests/test_grammar.py proves it by property testing
against a random-weight model).

Supported SQL types (paper Table 3): VARCHAR, INTEGER, DOUBLE, BOOLEAN,
DATETIME.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.tokenizer import EOS_ID, VOCAB_SIZE

DIGITS = frozenset(b"0123456789")
# characters allowed inside VARCHAR values (no quote/backslash/control)
STR_BYTES = frozenset(b for b in range(32, 127) if b not in (34, 92))


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    type: str  # VARCHAR | INTEGER | DOUBLE | BOOLEAN | DATETIME


def _lit(s: str) -> List[Tuple[str, object]]:
    return [("lit", b) for b in s.encode()]


def _value_prog(ftype: str, max_str: int) -> List[Tuple[str, object]]:
    t = ftype.upper()
    if t in ("VARCHAR", "TEXT", "STRING"):
        return [("lit", 34), ("str", max_str), ("lit", 34)]
    if t in ("INTEGER", "INT", "BIGINT"):
        return [("int", 12)]
    if t in ("DOUBLE", "FLOAT", "REAL"):
        return [("num", 16)]
    if t in ("BOOLEAN", "BOOL"):
        return [("bool", None)]
    if t in ("DATETIME", "DATE", "TIMESTAMP"):
        # "YYYY-MM-DD HH:MM:SS" — digit/sep template inside quotes
        prog: List[Tuple[str, object]] = [("lit", 34)]
        for ch in "dddd-dd-dd dd:dd:dd":
            prog.append(("digit", None) if ch == "d" else ("lit", ord(ch)))
        prog.append(("lit", 34))
        return prog
    raise ValueError(f"unsupported type {ftype}")


def compile_program(fields: Sequence[Field], num_rows: int = 1,
                    max_str: int = 48) -> List[Tuple[str, object]]:
    """Flatten the schema into a linear program of byte-class instructions.
    Variable-length instructions (str/int/num/bool) consume multiple steps
    with internal sub-state."""
    row: List[Tuple[str, object]] = [("lit", 123)]                 # '{'
    for i, f in enumerate(fields):
        if i:
            row += _lit(", ")
        row += _lit(f'"{f.name}": ')
        row += _value_prog(f.type, max_str)
    row.append(("lit", 125))                                       # '}'

    if num_rows == 1:
        return row + [("end", None)]
    prog: List[Tuple[str, object]] = [("lit", 91)]                 # '['
    for r in range(num_rows):
        if r:
            prog += _lit(", ")
        prog += row
    prog.append(("lit", 93))                                       # ']'
    return prog + [("end", None)]


@dataclasses.dataclass
class GrammarState:
    pc: int = 0          # program counter
    sub: int = 0         # chars consumed inside a variable-length instr
    aux: int = 0         # e.g. bool branch (0=undecided, 1=true, 2=false),
                         # num: bit0 seen digit, bit1 seen dot


class JsonGrammar:
    """Schema-driven constrained decoder. One instance per PREDICT schema
    (stateless); per-sequence state is a GrammarState."""

    def __init__(self, fields: Sequence[Field], num_rows: int = 1,
                 max_str: int = 48, vocab_size: int = VOCAB_SIZE):
        self.fields = list(fields)
        self.num_rows = num_rows
        self.max_str = max_str
        self.vocab = vocab_size
        self.prog = compile_program(self.fields, num_rows, max_str)

    def init_state(self) -> GrammarState:
        return GrammarState()

    def done(self, st: GrammarState) -> bool:
        return self.prog[st.pc][0] == "end" and st.sub > 0

    # -- allowed byte sets ----------------------------------------------------
    def _allowed(self, st: GrammarState) -> Tuple[frozenset, bool]:
        """Returns (allowed bytes, may_advance_to_next_instr). For
        variable-length instrs the 'next literal byte' is also allowed once
        the minimum length is satisfied — handled by advance()."""
        op, arg = self.prog[st.pc]
        if op == "lit":
            return frozenset((arg,)), False
        if op == "digit":
            return DIGITS, False
        if op == "str":
            allowed = set(STR_BYTES) if st.sub < arg else set()
            return frozenset(allowed), st.sub >= 1      # non-empty strings
        if op == "int":
            # aux bits: 1 = seen digit, 8 = leading zero (closes int part —
            # JSON forbids further digits after a leading 0)
            allowed = set() if (st.aux & 8) else set(DIGITS)
            if st.sub == 0:
                allowed.add(ord("-"))
            can_term = (st.aux & 1) == 1
            if st.sub >= arg and can_term:
                allowed = set()       # length cap (only once terminable)
            return frozenset(allowed), can_term
        if op == "num":
            # aux bits: 1 seen digit, 2 seen dot, 4 last-was-dot,
            # 8 leading zero in integer part
            allowed: set = set()
            if st.sub == 0:
                allowed.add(ord("-"))
            if st.aux & 2:
                allowed |= DIGITS                       # fraction digits
            elif st.aux & 8:
                allowed.add(ord("."))                   # only ".x" after 0
            else:
                allowed |= DIGITS
                if st.aux & 1:
                    allowed.add(ord("."))
            can_term = (st.aux & 1) == 1 and not (st.aux & 4)
            if st.sub >= arg and can_term:
                allowed = set()
            return frozenset(allowed), can_term
        if op == "bool":
            TRUE, FALSE = b"true", b"false"
            if st.aux == 0:
                return frozenset((TRUE[0], FALSE[0])), False
            word = TRUE if st.aux == 1 else FALSE
            if st.sub < len(word):
                return frozenset((word[st.sub],)), False
            return frozenset(), True
        if op == "end":
            return frozenset(), False
        raise AssertionError(op)

    def _next_literal(self, pc: int) -> Optional[int]:
        """First byte of the next instruction (for terminating var-length
        values)."""
        if pc + 1 >= len(self.prog):
            return EOS_ID
        op, arg = self.prog[pc + 1]
        if op == "lit":
            return arg
        if op == "end":
            return EOS_ID
        return None

    def mask(self, st: GrammarState) -> np.ndarray:
        m = np.zeros(self.vocab, dtype=np.int8)
        if self.prog[st.pc][0] == "end":
            m[EOS_ID] = 1
            return m
        allowed, can_term = self._allowed(st)
        for b in allowed:
            m[b] = 1
        if can_term or not allowed:
            nxt = self._next_literal(st.pc)
            if nxt is not None:
                m[nxt] = 1
        return m

    def advance(self, st: GrammarState, token: int) -> GrammarState:
        op, arg = self.prog[st.pc]
        if op == "end":
            return GrammarState(pc=st.pc, sub=1)
        allowed, can_term = self._allowed(st)
        if token in allowed:
            if op == "lit":
                return GrammarState(pc=st.pc + 1)
            if op == "digit":
                return GrammarState(pc=st.pc + 1)
            if op == "str":
                return GrammarState(st.pc, st.sub + 1, st.aux)
            if op == "int":
                aux = st.aux
                if token in DIGITS:
                    if not (aux & 1) and token == ord("0"):
                        aux |= 8        # leading zero closes the int part
                    aux |= 1
                return GrammarState(st.pc, st.sub + 1, aux)
            if op == "num":
                aux = st.aux
                if token in DIGITS:
                    if not (aux & 1) and not (aux & 2) and token == ord("0"):
                        aux |= 8
                    aux |= 1
                    aux &= ~4
                elif token == ord("."):
                    aux |= 2 | 4        # bit4: last char was the dot
                return GrammarState(st.pc, st.sub + 1, aux)
            if op == "bool":
                if st.aux == 0:
                    aux = 1 if token == ord("t") else 2
                    return GrammarState(st.pc, 1, aux)
                return GrammarState(st.pc, st.sub + 1, st.aux)
        # termination byte of a variable-length value → consume next instr
        nxt = self._next_literal(st.pc)
        if nxt is not None and token == nxt:
            if nxt == EOS_ID:
                return GrammarState(pc=st.pc + 1, sub=1)
            return GrammarState(pc=st.pc + 2)
        raise ValueError(
            f"token {token} not allowed at pc={st.pc} ({op}, sub={st.sub})")
