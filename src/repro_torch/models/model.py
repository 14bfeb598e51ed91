"""Model assembly for every family of the JAX package: dense, MoE, ssm,
hybrid, VLM and encoder (port of ``repro/models/model.py``).

One pre-norm stack: embedding (the encoder reads frame embeddings
instead; the VLM prepends image-patch embeddings with bidirectional
prefix-LM masking), per layer a residual block, final norm, tied or
separate LM head.  The block by family:
  dense / moe / vlm / encoder :
                norm → GQA attention with RoPE (bidirectional for the
                encoder) → residual → norm → SwiGLU | GELU MLP |
                capacity-bounded top-k MoE (``models/moe.py``) → residual
  ssm         : norm → Mamba-1 mixer (``models/mamba.py``) → residual
  hybrid      : norm → attention ∥ mixer on the same input, their mean →
                residual → norm → SwiGLU MLP → residual (hymba)
Params are the stacked tree of ``models/params.py``; the layers run in a
Python loop over the stacked leaves in place of ``lax.scan``.

Three modes, as in the JAX package:
  train   — full-sequence forward, no cache, returns token logits; with
            master weights (``params.param_specs``) the forward casts them
            to the compute dtype inside the autograd graph, as the JAX
            forward's ``.astype(cd)`` does, so their gradients are fp32
            (``launch/steps.py``).  By default each layer is rematerialised
            in the backward (``remat``, ``remat_policy``: JAX's
            ``jax.checkpoint`` of the scanned layer body)
  prefill — full-sequence forward that fills a decode cache (optionally
            extending a cached prefix: ``extend_offset``)
  decode  — single-token step against the KV cache

Two KV layouts, chosen by the cache dict: the dense ring cache
(``init_cache``) and the paged pool (``init_paged_cache`` plus the
``block_tables`` the engine adds per call; see ``paged_cache_specs``).  The
ssm and hybrid families carry a per-row SSM state (``conv``, ``h``) beside
the KV in either layout; an attention-free cache holds only that state.

Unlike the JAX version, which returns new arrays, the port updates the cache
IN PLACE: ``k``/``v``, ``slot_pos``, ``row_idx``, ``conv`` and ``h``
tensors (dense) or the pool pages and the SSM state (paged) are written
where they lie, and the returned dict holds the same tensors (with a new
``idx``).  Callers that must keep a cache unchanged pass a copy.

Attention, the MoE expert products and the selective scan go through the
Hopper kernel wrappers in ``kernels/ops.py`` by default (``attn_fn``,
``decode_attn_fn``, ``prefix_attn_fn``, ``paged_decode_attn_fn``,
``gmm_fn`` and ``scan_fn`` override them, e.g. with the plain versions of
``kernels/ref.py``).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.kernels import ops as KOPS
from repro_torch.models import layers as L
from repro_torch.models import mamba as MAMBA
from repro_torch.models import moe as MOE
from repro_torch.models.config import HYBRID, SSM, VLM, ModelConfig
from repro_torch.models.params import DTYPES, _dtype, require_ported


def param_count_actual(params: dict) -> int:
    """Elements in a parameter tree."""
    return sum(x.numel() for x in [*params["layers"].values(),
                                   *(v for k, v in params.items()
                                     if k != "layers")])


# ================================ cache =======================================
def cache_specs(cfg: ModelConfig, batch: int, cache_len: int,
                include_row_idx: bool = False
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """name → (shape, dtype) of the decode cache's tensors: the KV ring
    (``k``, ``v``, ``slot_pos``) where the model has attention, the fp32
    SSM state (``conv``, ``h``) where it has a mixer.  include_row_idx
    adds the per-row write cursor (continuous batching: ragged fill
    levels).  The shared write cursor ``idx`` is a host int, not a tensor."""
    require_ported(cfg)
    out = {}
    if include_row_idx:
        out["row_idx"] = ((batch,), torch.int32)
    if cfg.has_attention:
        ln, cd = cfg.num_layers, DTYPES[cfg.compute_dtype]
        kv, hd = cfg.num_kv_heads, cfg.head_dim
        lc = min(cache_len, cfg.sliding_window) if cfg.sliding_window \
            else cache_len
        out["k"] = ((ln, batch, lc, kv, hd), cd)
        out["v"] = ((ln, batch, lc, kv, hd), cd)
        out["slot_pos"] = ((batch, lc), torch.int32)
    out.update(_ssm_specs(cfg, batch))
    return out


def _ssm_specs(cfg: ModelConfig, batch: int
               ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """The per-row SSM state of `batch` rows (none without a mixer)."""
    if not cfg.has_ssm:
        return {}
    ln, di = cfg.num_layers, cfg.d_inner
    return {"conv": ((ln, batch, cfg.ssm_conv - 1, di), torch.float32),
            "h": ((ln, batch, di, cfg.ssm_state), torch.float32)}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               include_row_idx: bool = False, *, device="cpu"
               ) -> Dict[str, Any]:
    out: Dict[str, Any] = {
        k: torch.zeros(shape, dtype=dt, device=device)
        for k, (shape, dt) in cache_specs(cfg, batch, cache_len,
                                          include_row_idx).items()}
    if "slot_pos" in out:
        out["slot_pos"].fill_(-1)
    out["idx"] = 0
    return out


def paged_cache_specs(cfg: ModelConfig, num_pages: int, page_size: int,
                      quant: bool = False, batch: int = 0
                      ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """Paged KV layout: one GLOBAL pool of fixed-size pages per layer,
    addressed through per-row block tables that the engine passes with each
    call, so a shared prefix is one set of pages referenced by every row.
    Pools are (layers, KV, P, ps, head_dim): without the JAX package's lane
    pad of head_dim to 128, which only made its Pallas view a free reshape;
    the CUDA kernels read the natural strides.  With `quant`, int8 shadow
    pools and per-(layer, kv-head, page) fp32 scales are added for
    quantize-on-commit of frozen pages.  The SSM state of a hybrid stays
    per row and dense (it is O(1) in sequence length): `batch` > 0 adds
    that of `batch` rows, which the engine keeps apart from the pool."""
    require_ported(cfg)
    ln, cd = cfg.num_layers, DTYPES[cfg.compute_dtype]
    shape = (ln, cfg.num_kv_heads, num_pages, page_size, cfg.head_dim)
    out = {"k": (shape, cd), "v": (shape, cd)}
    if quant:
        out.update(kq=(shape, torch.int8), vq=(shape, torch.int8),
                   kscale=(shape[:3], torch.float32),
                   vscale=(shape[:3], torch.float32))
    if batch:
        out.update(_ssm_specs(cfg, batch))
    return out


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     quant: bool = False, *, device="cpu") -> Dict[str, Any]:
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in paged_cache_specs(
                cfg, num_pages, page_size, quant).items()}


def _paged_decode_kernels(q, k_pool, v_pool, block_tables, q_position,
                          quant=None):
    """The paged decode kernel of the pool: int8 frozen pages or not."""
    if quant is None:
        return KOPS.decode_attention_paged(q, k_pool, v_pool, block_tables,
                                           q_position)
    return KOPS.decode_attention_paged_quant(q, k_pool, v_pool, block_tables,
                                             q_position, quant)


# ================================ blocks ======================================
def _norm_p(lp: Dict[str, torch.Tensor], prefix: str) -> Optional[dict]:
    scale = lp.get(f"{prefix}.scale")
    bias = lp.get(f"{prefix}.bias")
    if scale is None and bias is None:
        return None
    return {"scale": scale, "bias": bias}


def _ring_write(ck, cv, k, v, lc: Optional[int] = None, lo: int = 0):
    """A prefill's K/V (B, S, KV, D) into the ring (B, lc, KV, D): the last
    lc tokens at slot p % lc where S >= lc, else the first S slots.  A
    rank whose ck/cv hold the ring's slots lo .. lo + n of `lc` (a cache
    split over its slots) writes those."""
    S, n = k.shape[1], ck.shape[1]
    lc = lc or n
    if S >= lc:          # slot j holds the token of the last lc with p % lc == j
        at = (torch.arange(lo, lo + n, device=k.device) - S) % lc + (S - lc)
        ck.copy_(k[:, at])
        cv.copy_(v[:, at])
    elif S > lo:
        hi = min(S, lo + n)
        ck[:, :hi - lo] = k[:, lo:hi].to(ck.dtype)
        cv[:, :hi - lo] = v[:, lo:hi].to(cv.dtype)


def _pos_range(shard, n: int) -> Tuple[int, int]:
    """(the ring's slots, this rank's first) of a slot-position shard of
    `n` columns: a batch that does not split over the data axes splits
    them over those axes (``ServeShards.pos_axes``)."""
    if shard is None or not shard.serving or not shard.pos_axes:
        return n, 0
    lc = n * shard.mesh.size(shard.pos_axes)
    return lc, shard.lo(shard.pos_axes, lc)


def _attention(cfg: ModelConfig, x, lp, positions, mode, ck, cv, slot_pos,
               write_slot, attn_fn, decode_attn_fn, extend_offset: int = 0,
               paged=None, hooks=None):
    """x (B, S, M) → (B, S, M).  ck/cv: this layer's (B, lc, KV, hd) cache
    views, written in place (prefill, decode); slot_pos (B, lc) — in decode
    already holding this step's positions; write_slot (B,) decode write
    slots.  paged (dict or None): ck/cv are then this layer's (KV, P, ps,
    hd) pools; paged holds the block tables, the write indices
    (``forward``'s ``writes``), the prefix table and length of a paged
    prefill, the layer's int8 pages (`quant`) and the two attention
    functions.  hooks (``Hooks``; train mode on a mesh): with heads over
    `model` the rank's wq/wo hold its query heads, it takes the kv heads
    they read from the replicated wk/wv, and its output is summed over
    `model`."""
    B, S, m = x.shape
    hooks = hooks or NO_HOOKS
    if hooks.shard is not None and hooks.shard.serving:
        return _serve_attention(cfg, x, lp, positions, mode, ck, cv,
                                slot_pos, write_slot, attn_fn, decode_attn_fn,
                                hooks)
    h, hd = lp["attn.wq"].shape[1], cfg.head_dim
    wk, wv = lp["attn.wk"], lp["attn.wv"]
    bk, bv = lp.get("attn.bk"), lp.get("attn.bv")
    tp = hooks.shard is not None and hooks.shard.heads_tp
    if tp:
        x = hooks.shard.to_model(x)
        wk, wv = hooks.shard.kv_heads(wk, h), hooks.shard.kv_heads(wv, h)
        if cfg.qkv_bias:
            bk, bv = hooks.shard.kv_heads(bk, h), hooks.shard.kv_heads(bv, h)
    kv = wk.shape[1]
    q = (x @ lp["attn.wq"].reshape(m, h * hd)).view(B, S, h, hd)
    k = (x @ wk.reshape(m, kv * hd)).view(B, S, kv, hd)
    v = (x @ wv.reshape(m, kv * hd)).view(B, S, kv, hd)
    if cfg.qkv_bias:
        q = q + lp["attn.bq"]
        k = k + bk
        v = v + bv
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    if mode != "decode":
        k = hooks.kv_cs(k)
        v = hooks.kv_cs(v)
    prefix_len = cfg.num_prefix_tokens if cfg.family == VLM else 0

    if paged is not None:
        rows, toks, pages, offs = paged["writes"]
        quant = paged["quant"]
        if mode == "decode":
            ck[:, pages, offs] = k[rows, toks].transpose(0, 1).to(ck.dtype)
            cv[:, pages, offs] = v[rows, toks].transpose(0, 1).to(cv.dtype)
            o = paged["decode_fn"](q[:, 0], ck, cv, paged["block_tables"],
                                   positions[:, 0].contiguous(),
                                   quant=quant)[:, None]
        else:
            # suffix attention merged with an in-place read of the shared
            # prefix pages (never replicated per row); then the new K/V go
            # straight into the rows' pages
            assert mode == "prefill" and not cfg.sliding_window
            ptab = paged["prefix_table"]
            if ptab is not None and ptab.shape[0]:
                o = paged["prefix_fn"](q, k, v, positions, ck, cv, ptab,
                                       paged["prefix_len"], quant)
            else:        # the mean over the suffix for a pad row, as the
                o = attn_fn(q, k, v, positions, positions, causal=cfg.causal,
                            window=0, prefix_len=0, kv_block=1)
            ck[:, pages, offs] = k[rows, toks].transpose(0, 1).to(ck.dtype)
            cv[:, pages, offs] = v[rows, toks].transpose(0, 1).to(cv.dtype)
    elif mode == "decode":
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
            _ring_write(ck, cv, k, v)
    o = o.reshape(B, S, h * hd) @ lp["attn.wo"].reshape(h * hd, m)
    return hooks.shard.from_model(o) if tp else o


def _mixer(cfg: ModelConfig, x, lp, state, scan_fn, shard=None):
    """The layer's Mamba mixer; `state` (an ``SSMState`` of this layer's
    cache views, None in train mode) is updated in place.  With `shard`
    (train mode, a model axis wider than 1) the rank's leaves hold its
    d_inner channels, whose partial sums go over `model`."""
    if shard is not None and shard.serving and shard.seq:
        return _seq_mixer(cfg, x, lp, state, scan_fn, shard)
    tp = shard is not None and shard.mixer_tp
    out, _ = MAMBA.mamba_mixer(
        x, {k[4:]: v for k, v in lp.items() if k.startswith("ssm.")},
        ssm_state_dim=cfg.ssm_state, dt_rank=cfg.dt_rank_eff,
        conv_dim=cfg.ssm_conv, state=state, scan_fn=scan_fn,
        to_model=shard.to_model if tp else None,
        from_model=shard.from_model if tp else None)
    return out


def _mlp(cfg: ModelConfig, x, lp, shard=None):
    """The dense MLP; with `shard` (a model axis wider than 1) on the rank's
    d_ff slice, its down products summed over `model`."""
    if shard is not None and shard.serving:
        return _serve_mlp(cfg, x, lp, shard)
    if shard is None or not shard.tp:
        if cfg.mlp_act == "silu":
            return L.swiglu_mlp(x, lp["mlp.w_gate"], lp["mlp.w_up"],
                                lp["mlp.w_down"])
        return L.gelu_mlp(x, lp["mlp.w_in"], lp["mlp.b_in"], lp["mlp.w_out"],
                          lp["mlp.b_out"])
    x = shard.to_model(x)
    if cfg.mlp_act == "silu":
        return shard.from_model(L.swiglu_mlp(
            x, lp["mlp.w_gate"], lp["mlp.w_up"], lp["mlp.w_down"]))
    h = L.gelu_mlp(x, lp["mlp.w_in"], lp["mlp.b_in"], lp["mlp.w_out"])
    return shard.from_model(h) + lp["mlp.b_out"]


# ====================== the serving layouts of a mesh ==========================
# With `shard` a ``launch.mesh.ServeShards`` (the prefill and decode step
# builders on a mesh), the blocks below run on the rank's shards, with the
# collectives of ``launch/dist.py`` written out where JAX's GSPMD inserts
# them.  No autograd.

def _serve_attention(cfg, x, lp, positions, mode, ck, cv, slot_pos,
                     write_slot, attn_fn, decode_attn_fn, hooks):
    """The attention of a serving layout.  The rank's wq/wk/wv/wo hold its
    query heads (heads over `model`), its head_dim columns of every head
    (hd), or every head (replicated, lc, ZeRO-3).  Its cache holds the
    kv heads and head_dim columns of ``shard.cache_kv`` / ``cache_hd``,
    its slots split over ``shard.slot_axes`` (`model` in lc; the data axes
    too where the batch does not split over them): a prefill computes
    every kv head and writes its cache's columns and slots of the ring
    (the cache is in the hd layout whatever the attention's); a decode
    step writes the new K/V where this rank holds the slot (a masked
    write: the ranks of a cache split over its slots hold a slot each).
    Decode attention over a head_dim slice is kernel (b), two launches with
    the scores summed over the slice's axes between them (over a slot range
    too, its output launch writes each head's lse and the ranges are
    merged as (a)'s); over a slot range alone it is kernel (a), the ranks'
    (out, lse) merged by ``_combine_slot_splits``; else kernel 2 on the kv
    heads of the rank's query heads.  RoPE rotates column i with i + hd /
    2, so a head_dim slice gathers the new token's q and k over its axes to
    rotate them.
    The output projection's partial sums (heads or head_dim split) are
    summed over their axes."""
    shard = hooks.shard
    B, S, m = x.shape
    hd = cfg.head_dim
    wq, wk, wv, wo = (lp[f"attn.{n}"] for n in ("wq", "wk", "wv", "wo"))
    hq, kvw, hdl = wq.shape[1], wk.shape[1], wq.shape[2]
    q = (x @ wq.reshape(m, hq * hdl)).view(B, S, hq, hdl)
    k = (x @ wk.reshape(m, kvw * hdl)).view(B, S, kvw, hdl)
    v = (x @ wv.reshape(m, kvw * hdl)).view(B, S, kvw, hdl)
    if cfg.qkv_bias:
        q = q + lp["attn.bq"]
        k = k + lp["attn.bk"]
        v = v + lp["attn.bv"]
    if hdl < hd:
        lo, axes = shard.hd_lo, shard.hd_axes
        q, k = (L.rope(shard.mesh.all_gather(t, 3, axes), positions,
                       cfg.rope_theta)[..., lo:lo + hdl] for t in (q, k))
    else:
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    if mode == "decode":
        o = _serve_decode_attention(cfg, shard, q[:, 0].contiguous(), k[:, 0],
                                    v[:, 0], ck, cv, slot_pos, write_slot,
                                    positions[:, 0].contiguous(),
                                    decode_attn_fn)[:, None]
    else:
        k, v = hooks.kv_cs(k), hooks.kv_cs(v)
        ka, va = k, v
        if shard.heads_tp:
            ka, va = (shard.kv_subset(t, hq, 2) for t in (k, v))
        o = attn_fn(q, ka, va, positions, hooks.kv_positions,
                    causal=cfg.causal, window=cfg.sliding_window,
                    prefix_len=cfg.num_prefix_tokens if cfg.family == VLM
                    else 0)
        if mode == "prefill":
            hlo, hn = shard.cache_hd
            lc = ck.shape[1] * shard.mesh.size(shard.slot_axes)
            _ring_write(ck, cv, k[..., hlo:hlo + hn], v[..., hlo:hlo + hn],
                        lc, shard.lo(shard.slot_axes, lc))
    o = o.reshape(B, S, hq * hdl) @ wo.reshape(hq * hdl, m)
    return shard.sum(o, shard.union(shard.axes_of("attn.wo", 0),
                                    shard.axes_of("attn.wo", 1)))


def _serve_decode_attention(cfg, shard, q, k, v, ck, cv, slot_pos,
                            write_slot, qpos, decode_attn_fn):
    """One decode step's attention on a rank (``_serve_attention``): q (B,
    hq, hdl), the new k/v (B, kv, hdl), this layer's cache shard (B, lc',
    kv', hd'), slot_pos this rank's shard of the (B, lc) slot positions
    (``_pos_range``) with this step's positions written, write_slot (B,)
    the ring's slot of each row."""
    B = q.shape[0]
    klo, kn = shard.cache_kv
    sn = ck.shape[1]
    lc = sn * shard.mesh.size(shard.slot_axes)
    slo = shard.lo(shard.slot_axes, lc)
    # the masked write: a row whose slot another rank holds writes back the
    # value it read
    rows = torch.arange(B, device=q.device)
    local = write_slot - slo
    mine = ((local >= 0) & (local < sn))[:, None, None]
    at = local.clamp(0, sn - 1)
    for cache, new in ((ck, k), (cv, v)):
        cache[rows, at] = torch.where(mine, new[:, klo:klo + kn].to(
            cache.dtype), cache[rows, at])
    # this rank's slots' positions
    plo = slo - _pos_range(shard, slot_pos.shape[1])[1]
    spos = slot_pos if sn == slot_pos.shape[1] else \
        slot_pos[:, plo:plo + sn].contiguous()
    if q.shape[-1] < cfg.head_dim:                       # kernel (b)
        scores = KOPS.decode_attention_hd_scores(q, ck,
                                                 1.0 / math.sqrt(cfg.head_dim))
        shard.sum(scores, shard.hd_axes)
        o, lse = KOPS.decode_attention_hd_out(scores, cv, spos, qpos)
        return _combine_slot_splits(shard, o, lse) if shard.slot_axes else o
    if shard.heads_tp and kn == cfg.num_kv_heads:
        ck, cv = (shard.kv_subset(t, q.shape[1], 2) for t in (ck, cv))
    if shard.slot_axes:                                   # kernel (a)
        o, lse = KOPS.decode_attention_lse(q, ck, cv, spos, qpos)
        return _combine_slot_splits(shard, o, lse)
    return decode_attn_fn(q, ck, cv, spos, qpos)


def _combine_slot_splits(shard, o, lse):
    """The ranks' decode attention over their slot ranges (o (B, H, D),
    lse (B, H)) merged: sum_r e^(lse_r - max) o_r / sum_r e^(lse_r - max),
    a rank with no valid slot (lse -inf) weighing 0.  Where no rank has one,
    the mean of the ranks' outputs (each the mean of V over its equal share
    of the slots): the mean of V over every slot, as the one-device
    softmax over all -1e30 scores gives."""
    axes = shard.slot_axes
    os_ = shard.mesh.all_gather(o[None], 0, axes).float()
    ls = shard.mesh.all_gather(lse[None], 0, axes)
    top = ls.max(0).values
    w = torch.where(torch.isneginf(ls), 0.0, torch.exp(ls - top))
    w = torch.where(torch.isneginf(top)[None], 1.0, w)
    return ((w[..., None] * os_).sum(0) / w.sum(0)[..., None]).to(o.dtype)


def _serve_mlp(cfg, x, lp, shard):
    """The dense MLP on the rank's d_ff slice (over `model`, or in the
    resident layout over every axis that divides d_ff: the rows are then
    gathered over the data axes first), its partial down products summed
    over the slice's axes."""
    name = "mlp.w_gate" if cfg.mlp_act == "silu" else "mlp.w_in"
    axes = shard.axes_of(name, 1)
    if not axes:
        return _mlp(cfg, x, lp)
    xa = shard.rows_over(x, axes)
    if cfg.mlp_act == "silu":
        y = L.swiglu_mlp(xa, lp["mlp.w_gate"], lp["mlp.w_up"],
                         lp["mlp.w_down"])
    else:
        b_in = lp["mlp.b_in"]
        if b_in.shape[0] != lp["mlp.w_in"].shape[1]:   # split otherwise
            n = lp["mlp.w_in"].shape[1]
            lo = shard.lo(axes, cfg.d_ff)
            b_in = shard.whole("mlp.b_in", b_in)[lo:lo + n]
        y = L.gelu_mlp(xa, lp["mlp.w_in"], b_in, lp["mlp.w_out"])
    y = shard.sum(y, axes)
    if cfg.mlp_act != "silu":
        y = y + lp["mlp.b_out"]
    return shard.own_rows(y, axes)


def _serve_moe(cfg, x, lp, shard, num_groups, gmm_fn):
    """The MoE block on the rank's experts (EP) or d_ff slice (TP), routing
    exactly JAX's capacity groups (contiguous runs of the B·S tokens): a
    data rank routes its rows in its share of `num_groups` groups, or, where
    a group would span data ranks (``shard.moe_gather``), every rank routes
    every row; a sequence split over `model` is gathered first, so no
    rank's slice is ever routed as a group of its own.  The expert outputs
    are summed over the experts' and d_ff's axes."""
    m = x.shape[2]
    xa = shard.mesh.all_gather(x, 1, "model") if shard.seq else x
    if shard.moe_gather:
        xa = shard.mesh.all_gather(xa, 0, shard.data)
    groups = num_groups if shard.moe_gather or shard.row_shards == 1 \
        else num_groups // shard.row_shards
    y = MOE.moe_block(xa.reshape(-1, m),
                      {k[4:]: v for k, v in lp.items() if k.startswith("moe.")},
                      num_experts=cfg.num_experts, top_k=cfg.top_k,
                      capacity_factor=cfg.capacity_factor, num_groups=groups,
                      compute_dtype=DTYPES[cfg.compute_dtype], gmm_fn=gmm_fn,
                      combine_cs=lambda t: shard.sum(t, shard.moe_axes),
                      first_expert=shard.expert_lo).reshape(xa.shape)
    if shard.moe_gather:
        y = y[shard.rows_lo:shard.rows_lo + shard.rows_n]
    return shard.seq_chunk(y) if shard.seq else y


def _seq_mixer(cfg, x, lp, state, scan_fn, shard):
    """The mixer of a sequence split over `model`: the scan runs along the
    whole sequence, so each rank gathers it (and the state, split over
    d_inner), runs the whole mixer (ZeRO-3 weights are whole) and keeps its
    slice of the output and its channels of the new state."""
    xa = shard.mesh.all_gather(x, 1, "model")
    full = None
    if state is not None:
        full = MAMBA.SSMState(
            conv=shard.mesh.all_gather(state.conv, 2, "model"),
            h=shard.mesh.all_gather(state.h, 1, "model"))
    out = _mixer(cfg, xa, lp, full, scan_fn)
    if state is not None:
        di = state.conv.shape[-1]
        lo = shard.lo(("model",), cfg.d_inner) if di < cfg.d_inner else 0
        state.conv.copy_(full.conv[..., lo:lo + di])
        state.h.copy_(full.h[:, lo:lo + di])
    return shard.seq_chunk(out)


def _serve_embed(shard, emb: torch.Tensor, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """The embedding lookup of the rank's vocab rows (tokens of another
    rank's rows give zeros), summed over the vocab's axes; the tokens of
    every data rank where the vocab splits over the data axes."""
    axes = shard.axes_of("embed", 0)
    if not axes:
        return emb[tokens]
    toks = shard.rows_over(tokens, axes)
    local = toks - shard.lo(axes, shard.cfg.padded_vocab)
    mine = (local >= 0) & (local < emb.shape[0])
    rows = emb[torch.where(mine, local, 0)] * mine[..., None].to(emb.dtype)
    return shard.own_rows(shard.sum(rows, axes), axes)


def _serve_logits(cfg, shard, x, head):
    """The logits of the rank's rows: its vocab columns over `model` where
    the model axis is wider than 1 and the layout is not ZeRO-3 (JAX's
    output specs), else every column.  A head whose vocab splits over other
    axes too (resident) gives its columns for every data rank's rows, which
    are all-gathered to the whole vocab and sliced."""
    axes = shard.axes_of("embed", 0) if cfg.tie_embeddings else \
        shard.axes_of("lm_head", 1)
    want = ("model",) if shard.tp else ()
    if axes == want:
        return x @ head
    full = shard.mesh.all_gather(shard.rows_over(x, axes) @ head, x.dim() - 1,
                                 axes)
    lo = shard.lo(want, cfg.padded_vocab)
    n = cfg.padded_vocab // (shard.mesh.size(want) if want else 1)
    return shard.own_rows(full, axes)[..., lo:lo + n]


class Hooks(NamedTuple):
    """The distribution layer's hooks of a forward (``launch/mesh.py``):
    JAX's names, the identity by default.  ``shard`` (a
    ``mesh.TrainShards``, or None on one device) gathers the FSDP leaves and
    supplies the tensor-parallel collectives."""
    dispatch_cs: Callable = MOE.Identity
    combine_cs: Callable = MOE.Identity
    kv_cs: Callable = MOE.Identity
    residual_cs: Callable = MOE.Identity
    shard: Any = None
    #: the K/V positions of a non-decode call: kv_cs of the positions (the
    #: whole sequence where the residual stream splits it), or None
    kv_positions: Any = None


NO_HOOKS = Hooks()


def _block(cfg: ModelConfig, x, lp, positions, mode, ck, cv, slot_pos,
           write_slot, attn_fn, decode_attn_fn, extend_offset: int = 0,
           paged=None, num_groups: int = 1, gmm_fn=None, state=None,
           scan_fn=None, hooks=NO_HOOKS):
    """One residual block (the module docstring's table by family)."""
    if cfg.family == SSM:
        xin = L.apply_norm(cfg.norm_type, x, _norm_p(lp, "ln_ssm"))
        return x + _mixer(cfg, xin, lp, state, scan_fn, hooks.shard)
    xin = L.apply_norm(cfg.norm_type, x, _norm_p(lp, "ln_attn"))
    a = _attention(cfg, xin, lp, positions, mode, ck, cv, slot_pos,
                   write_slot, attn_fn, decode_attn_fn, extend_offset, paged,
                   hooks)
    if cfg.family == HYBRID:
        x = x + 0.5 * (a + _mixer(cfg, xin, lp, state, scan_fn, hooks.shard))
    else:
        x = x + a
    xin2 = L.apply_norm(cfg.norm_type, x, _norm_p(lp, "ln_mlp"))
    if cfg.has_moe and hooks.shard is not None and hooks.shard.serving:
        return x + _serve_moe(cfg, xin2, lp, hooks.shard, num_groups, gmm_fn)
    if cfg.has_moe:
        B, S, m = x.shape
        y = MOE.moe_block(xin2.reshape(B * S, m),
                          {k[4:]: v for k, v in lp.items()
                           if k.startswith("moe.")},
                          num_experts=cfg.num_experts, top_k=cfg.top_k,
                          capacity_factor=cfg.capacity_factor,
                          num_groups=num_groups,
                          compute_dtype=DTYPES[cfg.compute_dtype],
                          gmm_fn=gmm_fn, dispatch_cs=hooks.dispatch_cs,
                          combine_cs=hooks.combine_cs,
                          first_expert=0 if hooks.shard is None
                          else hooks.shard.expert_lo)
        return x + y.reshape(B, S, m)
    return x + _mlp(cfg, xin2, lp, hooks.shard)


# ============================== full forward ==================================
def _leaf_cast(cfg: ModelConfig, params: dict):
    """name, leaf → the leaf in its serving dtype.  The identity for a
    serving tree; for master weights a cast, recorded by autograd."""
    if all(v.dtype == _dtype(cfg, k) for k, v in params["layers"].items()):
        return lambda _name, t: t
    return lambda name, t: t.to(_dtype(cfg, name))


#: the products that ``remat_policy="dots"`` keeps: a matrix product with
#: no batch dimension (``x @ w`` of a (B, S, M) activation and a 2-D weight
#: reaches the dispatcher as ``mm``; a product with a bias as ``addmm``)
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(_ctx, op, *_args, **_kwargs):
    """The ``dots`` policy, ``jax.checkpoint_policies.
    dots_with_no_batch_dims_saveable``: keep the output of each product
    with no batch dimension that autograd records (the q/k/v/o and MLP
    projections, the router, the mixer's in/x/dt/out projections) and
    recompute all else: the kernels' forwards, batched products, norms and
    elementwise work.  The products inside an autograd Function (the
    plain versions of the kernels on the CPU) run with grad off and are
    recomputed, as the kernels they stand for are."""
    if op in _DOT_OPS and torch.is_grad_enabled():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_fn(policy: str):
    """fn, *tensors → fn(*tensors) under the non-reentrant checkpoint of
    `policy` ("nothing": keep only the inputs; "dots": also the products
    of ``_save_dots``).  Non-reentrant: the train step takes
    ``torch.autograd.grad``, which the reentrant form does not support."""
    if policy == "nothing":
        return functools.partial(checkpoint, use_reentrant=False)
    if policy == "dots":
        return functools.partial(checkpoint, use_reentrant=False,
                                 context_fn=functools.partial(
                                     create_selective_checkpoint_contexts,
                                     _save_dots))
    raise ValueError(f"remat_policy {policy!r}: 'nothing' or 'dots'")


def _layer(cfg: ModelConfig, names, cast, block_args, x, *leaves):
    """One layer from its master (or serving) leaves in `names` order: the
    cast to the serving dtypes (on a mesh with the FSDP all-gather), then
    the block.  The unit that remat recomputes, so the layer's bf16 weights
    live only while it runs."""
    lp = {k: cast(k, v) for k, v in zip(names, leaves)}
    return block_args[-1].residual_cs(_block(cfg, x, lp, *block_args))


def forward(cfg: ModelConfig, params: dict, batch: Dict[str, torch.Tensor],
            mode: str = "train", cache: Optional[Dict[str, Any]] = None, *,
            attn_fn=None, decode_attn_fn=None, prefix_attn_fn=None,
            paged_decode_attn_fn=None, gmm_fn=None, scan_fn=None,
            num_groups: int = 1, last_only: bool = False,
            extend_offset: int = 0, remat: bool = True,
            remat_policy: str = "nothing", dispatch_cs=MOE.Identity,
            combine_cs=MOE.Identity, logits_cs=MOE.Identity,
            residual_cs=MOE.Identity, kv_cs=MOE.Identity, shard=None
            ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Run the stack.  batch: tokens (B, S) int | embeds (B, S, M) (the
    encoder's frame embeddings), positions (B, S) int32; the VLM may add
    prefix_embeds (B, P, M), prepended at positions 0..P-1 with the text
    positions shifted by P, so the logits cover P + S positions.  Returns
    (logits (B, S, Vp) in the compute dtype, cache or None); the cache is
    updated in place (see the module docstring).  `params` is the serving
    tree or the master tree (leaves in the param dtype), which is cast to
    the serving dtypes on use.

    A cache holding ``block_tables`` (B, NB) int32 is the paged pool.  It
    also holds ``writes``, a (4, n) int64 tensor: the (row, token index,
    page, in-page offset) of each new token whose K/V the pool keeps, the
    same for every layer (the engine builds it on the host; pads, tokens
    past the table and -1 entries are left out, where the JAX model sends
    them out of bounds with mode="drop").  It may hold ``quant_flags`` (P,)
    int8 (with the int8 pools), and in prefill ``prefix_table`` (npre,)
    int32 and the host int ``prefix_len`` of a shared prefix read in
    place.  The ssm and hybrid families read and overwrite the cache's
    per-row ``conv`` (L, B, K-1, Di) and ``h`` (L, B, Di, N) in either
    layout: prefill continues the state it finds (zeros in a fresh cache;
    the memoised prefix's in an extend-offset prefill) through every
    token, left pads included, as the JAX model does.

    The MoE family routes all B·S rows of a call, in `num_groups` capacity
    groups (the JAX default 1: what the serving engine runs; the train step
    passes ``moe.pick_num_groups`` of its micro-batch's tokens).  In train
    mode the ssm and hybrid mixers scan from zeros and keep no state.

    `remat` (train mode only; JAX's names and defaults) runs each layer
    under ``torch.utils.checkpoint``: the backward recomputes the layer's
    forward, kernels included, from what `remat_policy` kept -- "nothing":
    the layer's input and views of its master leaves; "dots": also the
    outputs of its products with no batch dimension.  Any other policy
    name raises ValueError.  The gradients are those of the forward
    without remat, to the bit: the recompute runs the same operations on
    the same inputs.

    The distribution layer's hooks are JAX's (``dispatch_cs``,
    ``combine_cs``: the MoE block's; ``logits_cs``; ``residual_cs`` after
    the embedding and each layer; ``kv_cs`` on a non-decode K/V), the
    identity by default, plus `shard` (``launch.mesh.TrainShards``, train
    mode): `params` are then the rank's shards of the master tree, each
    cast and all-gathered over the data axes where it is used (a stacked
    leaf one layer at a time, inside the layer that remat recomputes), and
    the attention, MLP, mixer, MoE block, embedding and logits run on the
    rank's heads, d_ff, d_inner, experts and vocabulary with the
    collectives over `model` of ``launch/dist.py``; the logits are the
    rank's vocab columns (``lm_loss`` takes the same `shard`).  Without a
    mesh the one-device path is unchanged, to the bit."""
    require_ported(cfg)
    remat_layer = _remat_fn(remat_policy)
    attn_fn = attn_fn or KOPS.flash_attention
    decode_attn_fn = decode_attn_fn or KOPS.decode_attention
    cd = DTYPES[cfg.compute_dtype]
    cast = _leaf_cast(cfg, params) if shard is None else shard.leaf
    serving = shard is not None and shard.serving
    tp = shard is not None and shard.tp and not serving
    positions = batch["positions"]
    if "embeds" in batch:                       # encoder / stub frontend
        x = batch["embeds"].to(cd)
    else:
        emb = cast("embed", params["embed"])
        if serving:
            x = _serve_embed(shard, emb, batch["tokens"])
        else:
            x = _vocab_rows(shard, emb, batch["tokens"]) if tp else \
                emb[batch["tokens"]]
        if cfg.scale_embed:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cd)
        if cfg.family == VLM and "prefix_embeds" in batch:
            pe = batch["prefix_embeds"]
            P = pe.shape[1]
            x = torch.cat([pe.to(cd), x], dim=1)
            positions = torch.cat([
                torch.arange(P, dtype=positions.dtype,
                             device=positions.device).expand(pe.shape[0], P),
                positions + P], dim=1)
    if serving and shard.seq:
        # the sequence-parallel prefill takes the batch whole over `model`:
        # this rank's chunk of the (for the VLM, joined image + text)
        # sequence, as JAX's residual_cs lays it out; kv_cs gathers the
        # positions whole
        x, positions = shard.seq_chunk(x), shard.seq_chunk(positions)
    B, S = positions.shape
    x = residual_cs(x)
    kv_positions = None if mode == "decode" else kv_cs(positions)
    hooks = Hooks(dispatch_cs, combine_cs, kv_cs, residual_cs, shard,
                  kv_positions)

    slot_pos = write_slot = row_idx = paged = None
    idx = 0
    if cache is not None and "block_tables" in cache:
        paged = {"block_tables": cache["block_tables"],
                 "writes": cache["writes"],
                 "prefix_table": cache.get("prefix_table"),
                 "prefix_len": int(cache.get("prefix_len", 0)),
                 "prefix_fn": prefix_attn_fn or KOPS.flash_attention_prefix,
                 "decode_fn": paged_decode_attn_fn or _paged_decode_kernels}
    elif cache is not None:
        slot_pos, row_idx = cache.get("slot_pos"), cache.get("row_idx")
        idx = int(cache.get("idx", 0))
    if mode == "decode" and slot_pos is not None:
        lc, lo = _pos_range(shard, slot_pos.shape[1])
        if row_idx is not None:      # per-row write slots (ragged fills)
            write_slot = (row_idx % lc).long()
        else:
            write_slot = torch.full((B,), idx % lc, dtype=torch.long,
                                    device=x.device)
        rows = torch.arange(B, device=x.device)
        if lc == slot_pos.shape[1]:             # the whole ring
            slot_pos[rows, write_slot] = positions[:, 0]
        else:         # a slot range: only where this rank holds the slot
            at = write_slot - lo
            mine = (at >= 0) & (at < slot_pos.shape[1])
            at = at.clamp(0, slot_pos.shape[1] - 1)
            slot_pos[rows, at] = torch.where(mine, positions[:, 0],
                                             slot_pos[rows, at])

    # one unbind a leaf: its backward stacks the layers' gradients once,
    # where indexing each layer would add L zero-padded full-size ones
    stacked = {k: v.unbind(0) for k, v in params["layers"].items()}
    names = list(stacked)
    if not (remat and mode == "train"):
        remat_layer = None
    for i in range(cfg.num_layers):
        ck = cv = state = None
        if cache is not None and cfg.has_attention:
            ck, cv = cache["k"][i], cache["v"][i]
        if cache is not None and cfg.has_ssm and mode != "train":
            state = MAMBA.SSMState(conv=cache["conv"][i], h=cache["h"][i])
        if paged is not None:
            paged["quant"] = None if "kq" not in cache else {
                "kq": cache["kq"][i], "vq": cache["vq"][i],
                "kscale": cache["kscale"][i], "vscale": cache["vscale"][i],
                "flags": cache["quant_flags"]}
        layer = functools.partial(
            _layer, cfg, names, cast,
            (positions, mode, ck, cv, slot_pos, write_slot, attn_fn,
             decode_attn_fn, extend_offset, paged, num_groups, gmm_fn, state,
             scan_fn, hooks))
        leaves = [stacked[k][i] for k in names]
        x = layer(x, *leaves) if remat_layer is None else \
            remat_layer(layer, x, *leaves)

    fn_params = {k: cast(k, v) for k, v in params.items()
                 if k.startswith("final_norm")}
    x = L.apply_norm(cfg.norm_type, x, _norm_p(fn_params, "final_norm"))
    if last_only:
        x = x[:, -1:]
    head = cast("embed", params["embed"]).t() if cfg.tie_embeddings else \
        cast("lm_head", params["lm_head"])
    if serving:
        logits = logits_cs(_serve_logits(cfg, shard, x, head))
    else:
        logits = logits_cs((shard.to_model(x) if tp else x) @ head)

    if mode == "train" or cache is None:
        return logits, None
    new_cache = dict(cache)
    if paged is not None:
        return logits, new_cache
    if mode == "decode":
        if row_idx is not None:
            row_idx.add_(1)
        new_cache["idx"] = idx + 1
    else:
        off = extend_offset
        positions = kv_positions            # the whole sequence
        S = positions.shape[1]
        if slot_pos is not None:
            n = slot_pos.shape[1]
            lc, lo = _pos_range(shard, n)   # this rank's slots lo .. lo + n
            if off == 0 and S >= lc:
                slot_pos.copy_(torch.roll(positions[:, S - lc:], S % lc,
                                          dims=1)[:, lo:lo + n])
            else:
                a, b = max(off, lo), min(off + S, lo + n)
                if b > a:
                    slot_pos[:, a - lo:b - lo] = positions[:, a - off:b - off]
                slot_pos[:, max(off + S - lo, 0):] = -1
        new_cache["idx"] = off + S
    return logits, new_cache


def _vocab_rows(shard, emb: torch.Tensor, tokens: torch.Tensor
                ) -> torch.Tensor:
    """The embedding lookup of a vocab-sharded table: each rank takes the
    rows of the tokens in its slice (zeros for the others), summed over
    `model`."""
    local = tokens - shard.vocab_lo
    mine = (local >= 0) & (local < emb.shape[0])
    rows = emb[torch.where(mine, local, 0)] * mine[..., None].to(emb.dtype)
    return shard.from_model(rows)


def lm_loss(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor,
            mask: torch.Tensor, shard=None) -> torch.Tensor:
    """Cross-entropy over the (padded) vocab in fp32, averaged over the
    mask's positions (``repro/models/model.py::lm_loss``).

    With `shard` (``launch.mesh.TrainShards``) the rows are this data
    rank's and the logits its vocab columns: the log-sum-exp is vocab
    parallel (the max, the sum of exponentials and the true logit each
    reduced over `model`) and the mean divides by the mask's count over
    every data rank, so the data ranks' losses sum to the global mean."""
    lf = logits.float()
    if shard is not None and shard.tp:
        gmax = shard.model_max(lf.amax(dim=-1))
        lse = torch.log(shard.from_model(
            torch.exp(lf - gmax[..., None]).sum(-1))) + gmax
        local = labels.long() - shard.vocab_lo
        mine = (local >= 0) & (local < lf.shape[-1])
        true = shard.from_model(torch.where(mine, torch.gather(
            lf, -1, torch.where(mine, local, 0)[..., None])[..., 0], 0.0))
    else:
        lse = torch.logsumexp(lf, dim=-1)
        true = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = (lse - true) * mask
    count = mask.sum() if shard is None else shard.data_sum(mask.sum())
    return nll.sum() / torch.clamp(count, min=1.0)
