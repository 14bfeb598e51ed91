"""Deterministic synthetic LM data pipeline.

Sharded, stateless-resumable: batch i is a pure function of (seed, step,
host_shard), so restart-after-failure reproduces the exact token stream
with no data-state checkpointing (the production pattern for elastic
clusters — the loader re-shards by recomputing, never by migrating state).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.config import ENCODER, VLM, ModelConfig


@dataclasses.dataclass
class DataConfig:
    seed: int = 1234
    batch: int = 8
    seq_len: int = 128
    num_hosts: int = 1
    host_id: int = 0


def _rng_for(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id]))


def synthetic_batch(mcfg: ModelConfig, dcfg: DataConfig, step: int
                    ) -> Dict[str, np.ndarray]:
    """Markov-ish token stream (structured enough that a model can reduce
    loss quickly — used by the convergence smoke tests)."""
    rng = _rng_for(dcfg, step)
    b = dcfg.batch // dcfg.num_hosts
    s = dcfg.seq_len
    v = mcfg.vocab_size

    if mcfg.family == ENCODER:
        embeds = rng.normal(0, 1, (b, s, mcfg.d_model)).astype(np.float32)
        labels = rng.integers(0, v, (b, s), dtype=np.int64)
        return {"embeds": embeds.astype(np.float32),
                "positions": np.broadcast_to(np.arange(s, dtype=np.int32),
                                             (b, s)).copy(),
                "labels": labels.astype(np.int32),
                "mask": np.ones((b, s), np.float32)}

    # token LM: repeating n-gram motifs + noise
    motif_len = 8
    n_motifs = 32
    # motifs are global (host-independent, step-independent)
    motifs = np.random.default_rng(dcfg.seed).integers(1, v, (n_motifs, motif_len))
    seqs = np.zeros((b, s + 1), np.int64)
    for i in range(b):
        pos = 0
        while pos < s + 1:
            m = motifs[rng.integers(0, n_motifs)]
            k = min(motif_len, s + 1 - pos)
            seqs[i, pos:pos + k] = m[:k]
            pos += k
        noise = rng.uniform(size=s + 1) < 0.05
        seqs[i, noise] = rng.integers(1, v, noise.sum())

    out = {"tokens": seqs[:, :-1].astype(np.int32),
           "labels": seqs[:, 1:].astype(np.int32),
           "positions": np.broadcast_to(np.arange(s, dtype=np.int32),
                                        (b, s)).copy(),
           "mask": np.ones((b, s), np.float32)}
    if mcfg.family == VLM:
        p = mcfg.num_prefix_tokens
        text = s - p
        out = {"tokens": seqs[:, :text].astype(np.int32),
               "prefix_embeds": rng.normal(0, 1, (b, p, mcfg.d_model))
               .astype(np.float32),
               "positions": np.broadcast_to(np.arange(text, dtype=np.int32),
                                            (b, text)).copy(),
               "labels": np.concatenate(
                   [np.zeros((b, p), np.int32),
                    seqs[:, 1:text + 1].astype(np.int32)], axis=1),
               "mask": np.concatenate(
                   [np.zeros((b, p), np.float32),
                    np.ones((b, text), np.float32)], axis=1)}
    return out


def batches(mcfg: ModelConfig, dcfg: DataConfig, start_step: int = 0
            ) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield synthetic_batch(mcfg, dcfg, step)
        step += 1
