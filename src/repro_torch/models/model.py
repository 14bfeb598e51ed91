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
            (``launch/steps.py``)
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

import math
from typing import Any, Dict, Optional, Tuple

import torch

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


def _attention(cfg: ModelConfig, x, lp, positions, mode, ck, cv, slot_pos,
               write_slot, attn_fn, decode_attn_fn, extend_offset: int = 0,
               paged=None):
    """x (B, S, M) → (B, S, M).  ck/cv: this layer's (B, lc, KV, hd) cache
    views, written in place (prefill, decode); slot_pos (B, lc) — in decode
    already holding this step's positions; write_slot (B,) decode write
    slots.  paged (dict or None): ck/cv are then this layer's (KV, P, ps,
    hd) pools; paged holds the block tables, the write indices
    (``forward``'s ``writes``), the prefix table and length of a paged
    prefill, the layer's int8 pages (`quant`) and the two attention
    functions."""
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
            lc = ck.shape[1]
            if S >= lc:          # ring: keep the last lc tokens at slot p % lc
                shift = S % lc
                ck.copy_(torch.roll(k[:, S - lc:].to(ck.dtype), shift, dims=1))
                cv.copy_(torch.roll(v[:, S - lc:].to(cv.dtype), shift, dims=1))
            else:
                ck[:, :S] = k.to(ck.dtype)
                cv[:, :S] = v.to(cv.dtype)
    return o.reshape(B, S, h * hd) @ lp["attn.wo"].reshape(h * hd, m)


def _mixer(cfg: ModelConfig, x, lp, state, scan_fn):
    """The layer's Mamba mixer; `state` (an ``SSMState`` of this layer's
    cache views, None in train mode) is updated in place."""
    out, _ = MAMBA.mamba_mixer(
        x, {k[4:]: v for k, v in lp.items() if k.startswith("ssm.")},
        ssm_state_dim=cfg.ssm_state, dt_rank=cfg.dt_rank_eff,
        conv_dim=cfg.ssm_conv, state=state, scan_fn=scan_fn)
    return out


def _block(cfg: ModelConfig, x, lp, positions, mode, ck, cv, slot_pos,
           write_slot, attn_fn, decode_attn_fn, extend_offset: int = 0,
           paged=None, num_groups: int = 1, gmm_fn=None, state=None,
           scan_fn=None):
    """One residual block (the module docstring's table by family)."""
    if cfg.family == SSM:
        xin = L.apply_norm(cfg.norm_type, x, _norm_p(lp, "ln_ssm"))
        return x + _mixer(cfg, xin, lp, state, scan_fn)
    xin = L.apply_norm(cfg.norm_type, x, _norm_p(lp, "ln_attn"))
    a = _attention(cfg, xin, lp, positions, mode, ck, cv, slot_pos,
                   write_slot, attn_fn, decode_attn_fn, extend_offset, paged)
    if cfg.family == HYBRID:
        x = x + 0.5 * (a + _mixer(cfg, xin, lp, state, scan_fn))
    else:
        x = x + a
    xin2 = L.apply_norm(cfg.norm_type, x, _norm_p(lp, "ln_mlp"))
    if cfg.has_moe:
        B, S, m = x.shape
        y = MOE.moe_block(xin2.reshape(B * S, m),
                          {k[4:]: v for k, v in lp.items()
                           if k.startswith("moe.")},
                          num_experts=cfg.num_experts, top_k=cfg.top_k,
                          capacity_factor=cfg.capacity_factor,
                          num_groups=num_groups,
                          compute_dtype=DTYPES[cfg.compute_dtype],
                          gmm_fn=gmm_fn)
        return x + y.reshape(B, S, m)
    if cfg.mlp_act == "silu":
        return x + L.swiglu_mlp(xin2, lp["mlp.w_gate"], lp["mlp.w_up"],
                                lp["mlp.w_down"])
    return x + L.gelu_mlp(xin2, lp["mlp.w_in"], lp["mlp.b_in"],
                          lp["mlp.w_out"], lp["mlp.b_out"])


# ============================== full forward ==================================
def _leaf_cast(cfg: ModelConfig, params: dict):
    """name, leaf → the leaf in its serving dtype.  The identity for a
    serving tree; for master weights a cast, recorded by autograd."""
    if all(v.dtype == _dtype(cfg, k) for k, v in params["layers"].items()):
        return lambda _name, t: t
    return lambda name, t: t.to(_dtype(cfg, name))


def forward(cfg: ModelConfig, params: dict, batch: Dict[str, torch.Tensor],
            mode: str = "train", cache: Optional[Dict[str, Any]] = None, *,
            attn_fn=None, decode_attn_fn=None, prefix_attn_fn=None,
            paged_decode_attn_fn=None, gmm_fn=None, scan_fn=None,
            num_groups: int = 1, last_only: bool = False,
            extend_offset: int = 0
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
    groups (the JAX default 1: what the serving engine runs)."""
    require_ported(cfg)
    attn_fn = attn_fn or KOPS.flash_attention
    decode_attn_fn = decode_attn_fn or KOPS.decode_attention
    cd = DTYPES[cfg.compute_dtype]
    cast = _leaf_cast(cfg, params)
    positions = batch["positions"]
    if "embeds" in batch:                       # encoder / stub frontend
        x = batch["embeds"].to(cd)
    else:
        x = cast("embed", params["embed"])[batch["tokens"]]
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
    B, S = positions.shape

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
        lc = slot_pos.shape[1]
        if row_idx is not None:      # per-row write slots (ragged fills)
            write_slot = (row_idx % lc).long()
        else:
            write_slot = torch.full((B,), idx % lc, dtype=torch.long,
                                    device=x.device)
        slot_pos[torch.arange(B, device=x.device), write_slot] = positions[:, 0]

    # one unbind a leaf: its backward stacks the layers' gradients once,
    # where indexing each layer would add L zero-padded full-size ones
    stacked = {k: v.unbind(0) for k, v in params["layers"].items()}
    for i in range(cfg.num_layers):
        lp = {k: cast(k, v[i]) for k, v in stacked.items()}
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
        x = _block(cfg, x, lp, positions, mode, ck, cv, slot_pos, write_slot,
                   attn_fn, decode_attn_fn, extend_offset, paged, num_groups,
                   gmm_fn, state, scan_fn)

    fn_params = {k: v for k, v in params.items() if k.startswith("final_norm")}
    x = L.apply_norm(cfg.norm_type, x, _norm_p(fn_params, "final_norm"))
    if last_only:
        x = x[:, -1:]
    head = cast("embed", params["embed"]).t() if cfg.tie_embeddings else \
        cast("lm_head", params["lm_head"])
    logits = x @ head

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
        if slot_pos is not None:
            lc = slot_pos.shape[1]
            if off == 0 and S >= lc:
                slot_pos.copy_(torch.roll(positions[:, S - lc:], S % lc,
                                          dims=1))
            else:
                slot_pos[:, off:off + S] = positions
                slot_pos[:, off + S:] = -1
        new_cache["idx"] = off + S
    return logits, new_cache


def lm_loss(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """Cross-entropy over the (padded) vocab in fp32, averaged over the
    mask's positions (``repro/models/model.py::lm_loss``)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    true = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = (lse - true) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)
