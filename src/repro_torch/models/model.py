"""Model assembly for the dense family (port of ``repro/models/model.py``).

One pre-norm decoder stack: embedding, per layer [norm → GQA attention with
RoPE → residual → norm → SwiGLU | GELU MLP → residual], final norm, tied or
separate LM head.  Params are the stacked tree of ``models/params.py``; the
layers run in a Python loop over the stacked leaves in place of
``lax.scan``.

Three modes, as in the JAX package:
  train   — full-sequence forward, no cache, returns token logits
  prefill — full-sequence forward that fills a decode cache (optionally
            extending a cached prefix: ``extend_offset``)
  decode  — single-token step against the ring-buffered KV cache

Unlike the JAX version, which returns new arrays, the port updates the cache
IN PLACE: ``k``/``v``, ``slot_pos`` and ``row_idx`` tensors are written
where they lie, and the returned dict holds the same tensors (with a new
``idx``).  Callers that must keep a cache unchanged pass a copy.

Attention goes through the Hopper kernel wrappers in ``kernels/ops.py`` by
default (``attn_fn``/``decode_attn_fn`` override them, e.g. with the plain
``models.layers`` versions).  The paged KV layout is not ported yet.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops as KOPS
from repro_torch.models import layers as L
from repro_torch.models.config import DENSE, VLM, ModelConfig
from repro_torch.models.params import DTYPES


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != DENSE:
        raise NotImplementedError(
            f"{cfg.family} family: only the dense family is ported (see ROADMAP)")


# ================================ cache =======================================
def cache_specs(cfg: ModelConfig, batch: int, cache_len: int,
                include_row_idx: bool = False
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """name → (shape, dtype) of the decode cache's tensors.  include_row_idx
    adds the per-row write cursor (continuous batching: ragged fill
    levels).  The shared write cursor ``idx`` is a host int, not a tensor."""
    _require_dense(cfg)
    ln, cd = cfg.num_layers, DTYPES[cfg.compute_dtype]
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    lc = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
    out = {}
    if include_row_idx:
        out["row_idx"] = ((batch,), torch.int32)
    out["k"] = ((ln, batch, lc, kv, hd), cd)
    out["v"] = ((ln, batch, lc, kv, hd), cd)
    out["slot_pos"] = ((batch, lc), torch.int32)
    return out


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               include_row_idx: bool = False, *, device="cpu"
               ) -> Dict[str, Any]:
    out: Dict[str, Any] = {
        k: torch.zeros(shape, dtype=dt, device=device)
        for k, (shape, dt) in cache_specs(cfg, batch, cache_len,
                                          include_row_idx).items()}
    out["slot_pos"].fill_(-1)
    out["idx"] = 0
    return out


# ================================ blocks ======================================
def _norm_p(lp: Dict[str, torch.Tensor], prefix: str) -> Optional[dict]:
    scale = lp.get(f"{prefix}.scale")
    bias = lp.get(f"{prefix}.bias")
    if scale is None and bias is None:
        return None
    return {"scale": scale, "bias": bias}


def _attention(cfg: ModelConfig, x, lp, positions, mode, ck, cv, slot_pos,
               write_slot, attn_fn, decode_attn_fn, extend_offset: int = 0):
    """x (B, S, M) → (B, S, M).  ck/cv: this layer's (B, lc, KV, hd) cache
    views, written in place (prefill, decode); slot_pos (B, lc) — in decode
    already holding this step's positions; write_slot (B,) decode write
    slots."""
    B, S, m = x.shape
    h, kv, hd = cfg.padded_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ lp["attn.wq"].reshape(m, h * hd)).view(B, S, h, hd)
    k = (x @ lp["attn.wk"].reshape(m, kv * hd)).view(B, S, kv, hd)
    v = (x @ lp["attn.wv"].reshape(m, kv * hd)).view(B, S, kv, hd)
    if cfg.qkv_bias:
        q = q + lp["attn.bq"]
        k = k + lp["attn.bk"]
        v = v + lp["attn.bv"]
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    prefix_len = cfg.num_prefix_tokens if cfg.family == VLM else 0

    if mode == "decode":
        rows = torch.arange(B, device=x.device)
        ck[rows, write_slot] = k[:, 0].to(ck.dtype)
        cv[rows, write_slot] = v[:, 0].to(cv.dtype)
        o = decode_attn_fn(q[:, 0], ck, cv, slot_pos,
                           positions[:, 0].contiguous())[:, None]
    elif mode == "prefill" and extend_offset > 0:
        off = extend_offset
        lc = ck.shape[1]
        assert off + S <= lc and not cfg.sliding_window, (off, S, lc)
        k_all = torch.cat([ck[:, :off].to(k.dtype), k], dim=1)
        v_all = torch.cat([cv[:, :off].to(v.dtype), v], dim=1)
        kv_pos = torch.cat([slot_pos[:, :off], positions], dim=1)
        o = attn_fn(q, k_all, v_all, positions, kv_pos, causal=cfg.causal,
                    window=0, prefix_len=prefix_len)
        ck[:, off:off + S] = k.to(ck.dtype)
        cv[:, off:off + S] = v.to(cv.dtype)
    else:
        o = attn_fn(q, k, v, positions, positions, causal=cfg.causal,
                    window=cfg.sliding_window, prefix_len=prefix_len)
        if mode == "prefill":
            lc = ck.shape[1]
            if S >= lc:          # ring: keep the last lc tokens at slot p % lc
                shift = S % lc
                ck.copy_(torch.roll(k[:, S - lc:].to(ck.dtype), shift, dims=1))
                cv.copy_(torch.roll(v[:, S - lc:].to(cv.dtype), shift, dims=1))
            else:
                ck[:, :S] = k.to(ck.dtype)
                cv[:, :S] = v.to(cv.dtype)
    return o.reshape(B, S, h * hd) @ lp["attn.wo"].reshape(h * hd, m)


def _block(cfg: ModelConfig, x, lp, positions, mode, ck, cv, slot_pos,
           write_slot, attn_fn, decode_attn_fn, extend_offset: int = 0):
    """One residual block of the dense family."""
    xin = L.apply_norm(cfg.norm_type, x, _norm_p(lp, "ln_attn"))
    x = x + _attention(cfg, xin, lp, positions, mode, ck, cv, slot_pos,
                       write_slot, attn_fn, decode_attn_fn, extend_offset)
    xin2 = L.apply_norm(cfg.norm_type, x, _norm_p(lp, "ln_mlp"))
    if cfg.mlp_act == "silu":
        return x + L.swiglu_mlp(xin2, lp["mlp.w_gate"], lp["mlp.w_up"],
                                lp["mlp.w_down"])
    return x + L.gelu_mlp(xin2, lp["mlp.w_in"], lp["mlp.b_in"],
                          lp["mlp.w_out"], lp["mlp.b_out"])


# ============================== full forward ==================================
def forward(cfg: ModelConfig, params: dict, batch: Dict[str, torch.Tensor],
            mode: str = "train", cache: Optional[Dict[str, Any]] = None, *,
            attn_fn=None, decode_attn_fn=None, last_only: bool = False,
            extend_offset: int = 0
            ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Run the stack.  batch: tokens (B, S) int, positions (B, S) int32.
    Returns (logits (B, S, Vp) in the compute dtype, cache or None); the
    cache is updated in place (see the module docstring)."""
    _require_dense(cfg)
    attn_fn = attn_fn or KOPS.flash_attention
    decode_attn_fn = decode_attn_fn or KOPS.decode_attention
    cd = DTYPES[cfg.compute_dtype]
    positions = batch["positions"]
    x = params["embed"][batch["tokens"]]
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cd)
    B, S = positions.shape

    slot_pos = write_slot = row_idx = None
    idx = 0
    if cache is not None:
        slot_pos, row_idx = cache["slot_pos"], cache.get("row_idx")
        idx = int(cache.get("idx", 0))
    if mode == "decode":
        lc = slot_pos.shape[1]
        if row_idx is not None:      # per-row write slots (ragged fills)
            write_slot = (row_idx % lc).long()
        else:
            write_slot = torch.full((B,), idx % lc, dtype=torch.long,
                                    device=x.device)
        slot_pos[torch.arange(B, device=x.device), write_slot] = positions[:, 0]

    for i in range(cfg.num_layers):
        lp = {k: v[i] for k, v in params["layers"].items()}
        ck = cv = None
        if cache is not None:
            ck, cv = cache["k"][i], cache["v"][i]
        x = _block(cfg, x, lp, positions, mode, ck, cv, slot_pos, write_slot,
                   attn_fn, decode_attn_fn, extend_offset)

    fn_params = {k: v for k, v in params.items() if k.startswith("final_norm")}
    x = L.apply_norm(cfg.norm_type, x, _norm_p(fn_params, "final_norm"))
    if last_only:
        x = x[:, -1:]
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head

    if mode == "train" or cache is None:
        return logits, None
    new_cache = dict(cache)
    if mode == "decode":
        if row_idx is not None:
            row_idx.add_(1)
        new_cache["idx"] = idx + 1
    else:
        off = extend_offset
        lc = slot_pos.shape[1]
        if off == 0 and S >= lc:
            slot_pos.copy_(torch.roll(positions[:, S - lc:], S % lc, dims=1))
        else:
            slot_pos[:, off:off + S] = positions
            slot_pos[:, off + S:] = -1
        new_cache["idx"] = off + S
    return logits, new_cache
