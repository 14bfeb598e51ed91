"""Byte-level tokenizer: vocab = 256 raw bytes + PAD/BOS/EOS.

Self-contained and loss-free — exactly what an in-database engine wants for
schema-compliant round-trips. All token counts reported by benchmarks use
this tokenizer consistently across every system emulation, so count RATIOS
are comparable with the paper's (which used OpenAI BPE)."""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

PAD_ID = 256
BOS_ID = 257
EOS_ID = 258
VOCAB_SIZE = 259


def encode(text: str, *, bos: bool = True) -> List[int]:
    ids = list(text.encode("utf-8", errors="replace"))
    return ([BOS_ID] if bos else []) + ids


def decode(ids: Sequence[int]) -> str:
    bs = bytes(i for i in ids if 0 <= i < 256)
    return bs.decode("utf-8", errors="replace")


def count_tokens(text: str) -> int:
    return len(text.encode("utf-8", errors="replace"))


def pad_batch(seqs: List[List[int]], length: int | None = None
              ) -> tuple[np.ndarray, np.ndarray]:
    """Right-pad to a common length. Returns (tokens (B, L) int32,
    lengths (B,) int32)."""
    length = length or max(len(s) for s in seqs)
    out = np.full((len(seqs), length), PAD_ID, np.int32)
    lens = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        s = s[:length]
        out[i, :len(s)] = s
        lens[i] = len(s)
    return out, lens
