"""Shared neural-net layers: norms, RoPE, attention, MLPs.

Port of ``repro/models/layers.py``.  ``flash_attention`` is the plain
blockwise streamed-softmax forward (the JAX package's production fallback,
the prefill attention of its SQL path);
``reference_attention``, ``decode_attention``, ``decode_attention_paged``
and ``prefix_suffix_attention`` are the naive oracles.  The model calls the
kernel wrappers in ``kernels/ops.py`` by default; these are the plain
versions they are held against.  The dense and MoE families (``models/
model.py``) use them all; the MoE block itself is ``models/moe.py``.  The
norms, RoPE and MLPs are differentiated by autograd; the attention's
backward is the JAX package's hand-written one (``_flash_bwd``), as
``kernels/ref.py::flash_attention_bwd_ref`` and its CUDA kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import (NEG_INF, attention_mask,
                                     decode_attention_paged_ref,
                                     decode_attention_ref,
                                     flash_attention_ref,
                                     prefix_suffix_attention_ref)


# -- norms ---------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, w: Optional[torch.Tensor]) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + 1e-6)
    if w is not None:
        y = y * w.float()
    return y.to(x.dtype)


def layernorm(x: torch.Tensor, w: Optional[torch.Tensor],
              b: Optional[torch.Tensor]) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + 1e-5)
    if w is not None:
        y = y * w.float()
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def apply_norm(norm_type: str, x: torch.Tensor, params: Optional[dict]
               ) -> torch.Tensor:
    if norm_type == "rmsnorm":
        return rmsnorm(x, params["scale"] if params else None)
    if norm_type == "layernorm":
        return layernorm(x, params["scale"], params["bias"])
    if norm_type == "nonparam_ln":
        return layernorm(x, None, None)
    raise ValueError(norm_type)


# -- rotary embeddings ----------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D) with D even; positions: (B, S) absolute positions.
    Half-split rotation with fp32 angles."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs             # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# -- attention ------------------------------------------------------------------
def flash_attention(q, k, v, q_positions, kv_positions, *, causal=True,
                    window=0, prefix_len=0, block_q=512, block_kv=1024):
    """Blockwise streamed-softmax attention, forward only.  q (B, Sq, H, D);
    k, v (B, Skv, KV, D); GQA via H = KV·G; kv position -1 marks padding.
    Never materializes more than a (block_q × block_kv) score tile per head.
    The last kv block counts as zero-padded to block_kv keys of score -1e30,
    as in the JAX function, which only a row with no visible key sees (see
    ``ref.flash_attention_ref``).  Returns (B, Sq, H, D) in q.dtype."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, Sq, KV, G, D) / math.sqrt(D)
    kf, vf = k.float(), v.float()
    out = torch.empty(B, Sq, KV, G, D, dtype=torch.float32, device=q.device)
    for q0 in range(0, Sq, block_q):
        qb = qf[:, q0:q0 + block_q]
        nq = qb.shape[1]
        m = torch.full((B, KV, G, nq), NEG_INF, device=q.device)
        l = torch.zeros((B, KV, G, nq), device=q.device)
        acc = torch.zeros((B, KV, G, nq, D), device=q.device)
        for k0 in range(0, Skv, block_kv):
            s = torch.einsum("bqkgd,bjkd->bkgqj", qb,
                             kf[:, k0:k0 + block_kv])
            ok = attention_mask(q_positions[:, q0:q0 + block_q],
                                kv_positions[:, k0:k0 + block_kv],
                                causal=causal, window=window,
                                prefix_len=prefix_len)
            s = torch.where(ok[:, None, None], s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            pad = (block_kv - s.shape[-1]) * torch.exp(NEG_INF - m_new)
            l = l * corr + p.sum(dim=-1) + pad
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqj,bjkd->bkgqd", p, vf[:, k0:k0 + block_kv])
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]      # (B,KV,G,nq,D)
        out[:, q0:q0 + nq] = o.permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, H, D).to(q.dtype)


#: naive attention over the full score matrix (test oracle)
reference_attention = flash_attention_ref
#: single-token attention against the dense ring cache
decode_attention = decode_attention_ref
#: single-token attention against the page pool through block tables, int8
#: frozen pages dequantized when ``quant`` is given (the JAX function's
#: ``head_dim`` argument is gone: the port's pools carry no lane pad)
decode_attention_paged = decode_attention_paged_ref
#: paged prefill: suffix attention merged with a shared prefix read once
prefix_suffix_attention = prefix_suffix_attention_ref


# -- MLPs ------------------------------------------------------------------------
def swiglu_mlp(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x, w_in, b_in, w_out, b_out=None):
    """b_out None: the down product alone (a partial sum where d_ff is
    sharded, whose bias is added after the sum)."""
    # jax.nn.gelu defaults to the tanh approximation
    y = F.gelu(x @ w_in + b_in, approximate="tanh") @ w_out
    return y if b_out is None else y + b_out
