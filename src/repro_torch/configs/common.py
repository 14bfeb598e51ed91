"""Shared input-spec construction for every (arch x shape) cell (port of
``repro/configs/common.py``).

The specs are ``(shape, torch dtype)`` pairs, the form
``models.params.param_specs`` uses: allocation-free stand-ins for every
model input, which the dry-run (``launch/dryrun.py``) sizes and the rules of
``launch/mesh.py`` shard.  The same dict keys are produced (as real arrays)
by the training data pipeline and the serving engine.  The decode cache's
specs are ``models.model.cache_specs``', whose write cursor is a host int.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import model as MDL
from repro_torch.models.config import ENCODER, VLM, ModelConfig, ShapeSpec

I32, F32, BF16 = torch.int32, torch.float32, torch.bfloat16


def train_batch_specs(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, Any]:
    """Batch for one train_step: token LM (or frame-classification for the
    encoder, prefix-LM for the VLM)."""
    if cfg.family == ENCODER:
        return {
            "embeds": ((batch, seq, cfg.d_model), BF16),
            "positions": ((batch, seq), I32),
            "labels": ((batch, seq), I32),
            "mask": ((batch, seq), F32),
        }
    if cfg.family == VLM:
        p = cfg.num_prefix_tokens
        text = seq - p
        return {
            "tokens": ((batch, text), I32),
            "prefix_embeds": ((batch, p, cfg.d_model), BF16),
            "positions": ((batch, text), I32),
            # labels cover the full (prefix + text) logits row; loss mask
            # zeroes the prefix positions
            "labels": ((batch, seq), I32),
            "mask": ((batch, seq), F32),
        }
    return {
        "tokens": ((batch, seq), I32),
        "positions": ((batch, seq), I32),
        "labels": ((batch, seq), I32),
        "mask": ((batch, seq), F32),
    }


def prefill_batch_specs(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, Any]:
    if cfg.family == ENCODER:
        return {
            "embeds": ((batch, seq, cfg.d_model), BF16),
            "positions": ((batch, seq), I32),
        }
    if cfg.family == VLM:
        p = cfg.num_prefix_tokens
        return {
            "tokens": ((batch, seq - p), I32),
            "prefix_embeds": ((batch, p, cfg.d_model), BF16),
            "positions": ((batch, seq - p), I32),
        }
    return {
        "tokens": ((batch, seq), I32),
        "positions": ((batch, seq), I32),
    }


def decode_batch_specs(cfg: ModelConfig, batch: int) -> Dict[str, Any]:
    return {
        "tokens": ((batch, 1), I32),
        "positions": ((batch, 1), I32),
    }


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """All step inputs for the given cell, EXCLUDING params/opt-state (those
    come from ``params.param_specs`` / the train-state builder)."""
    if shape.kind == "train":
        return {"batch": train_batch_specs(cfg, shape.global_batch, shape.seq_len)}
    if shape.kind == "prefill":
        return {"batch": prefill_batch_specs(cfg, shape.global_batch, shape.seq_len)}
    # decode: one new token against a seq_len-deep cache
    return {
        "batch": decode_batch_specs(cfg, shape.global_batch),
        "cache": MDL.cache_specs(cfg, shape.global_batch, shape.seq_len),
    }
