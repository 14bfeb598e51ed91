"""Plain float32 forward passes of the benchmark's configurations, in plain
PyTorch, from the published description of each architecture.

* ``dense`` (OLMo, arXiv:2402.00838): pre-norm blocks; a non-parametric
  layer norm (eps 1e-5) or an RMS norm with a scale; multi-head attention
  with rotary embeddings (half-split, theta 10,000) over the causal
  context, scaled by 1/sqrt(head_dim); a SwiGLU MLP; the embedding tied as
  the LM head.
* ``ssm`` (Mamba-1 as Falcon-Mamba uses it, arXiv:2410.05355): pre-norm
  blocks of an RMS norm (eps 1e-6, with a scale) and the mixer: the input
  projected twice (x, z), a depthwise causal conv of width K with a bias
  on x, SiLU, the projection to (dt rank, B, C), dt = softplus(dt_rank @
  dt_proj + dt_bias), the selective scan h_t = exp(dt_t A) h_{t-1} +
  dt_t B_t x_t with A = -exp(A_log), y_t = C_t h_t + D x_t, gated by
  SiLU(z), projected out; a separate LM head.  The published Falcon-Mamba
  also RMS-normalises B, C and dt inside the mixer; the configuration as
  run (``configs/falcon-mamba-7b.json``, ``departures``) does not, and
  neither does this reference.

Everything runs in float32 with TF32 off, a few sequences at a time and
one layer at a time, each layer's weights cast from the tensors the
benchmark made.  ``quant`` (the control, ``control.py``) rounds both operands of
every matrix product through a lower precision first.

This file imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _mm(x: torch.Tensor, w: torch.Tensor, quant: Quant) -> torch.Tensor:
    if quant is not None:
        x, w = quant(x), quant(w)
    return x @ w


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def _layer_norm(x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5)


def _rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + 1e-6) * _f32(scale)


def _norm(model: dict, x, W: dict, name: str, i: Optional[int]):
    if model["norm_type"] == "nonparam_ln":
        return _layer_norm(x)
    scale = W["layers"][name + ".scale"][i] if i is not None \
        else W[name + ".scale"]
    return _rms_norm(x, scale)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, H, D): positions 0..T-1, the two halves of D rotated."""
    T, D = x.shape[1], x.shape[3]
    half = D // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _attention(model: dict, x, W: dict, i: int, quant: Quant):
    B, T, M = x.shape
    H, KV, D = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    lw = W["layers"]

    def proj(name, heads):
        w = _f32(lw[name][i]).reshape(M, heads * D)
        return _mm(x, w, quant).view(B, T, heads, D)
    theta = float(model.get("rope_theta", 10000.0))
    q, k = _rope(proj("attn.wq", H), theta), _rope(proj("attn.wk", KV), theta)
    v = proj("attn.wv", KV)
    G = H // KV
    out = torch.empty(B, T, H, D, device=x.device)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    for h in range(H):               # one head's (B, T, T) scores at a time
        s = _mm(q[:, :, h], k[:, :, h // G].transpose(1, 2), quant) \
            / math.sqrt(D)
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        out[:, :, h] = _mm(p, v[:, :, h // G], quant)
    return _mm(out.reshape(B, T, H * D),
               _f32(lw["attn.wo"][i]).reshape(H * D, M), quant)


def _swiglu(x, W: dict, i: int, quant: Quant):
    lw = W["layers"]
    g = _mm(x, _f32(lw["mlp.w_gate"][i]), quant)
    u = _mm(x, _f32(lw["mlp.w_up"][i]), quant)
    return _mm(F.silu(g) * u, _f32(lw["mlp.w_down"][i]), quant)


def selective_scan(u, dt, A, Bm, Cm, Dv, chunk: int = 16):
    """y (B, T, Di) of the selective scan from a zero state, exactly:
    within each chunk of `chunk` steps h_t = sum_{s<=t} exp(sum_{s<r<=t}
    dt_r A) dt_s B_s u_s + exp(sum_{r<=t} dt_r A) h_0, every decay factor
    in (0, 1].  u, dt (B, T, Di); A (Di, N); Bm, Cm (B, T, N); Dv (Di,)."""
    Bz, T, Di = u.shape
    N = A.shape[1]
    h = torch.zeros(Bz, Di, N, dtype=u.dtype, device=u.device)
    ys = []
    for t0 in range(0, T, chunk):
        dtc, uc = dt[:, t0:t0 + chunk], u[:, t0:t0 + chunk]
        Bc, Cc = Bm[:, t0:t0 + chunk], Cm[:, t0:t0 + chunk]
        n = dtc.shape[1]
        cum = torch.cumsum(dtc[..., None] * A, dim=1)          # (B, n, Di, N)
        # decay from step s (exclusive) to step t (inclusive), s <= t
        seg = cum[:, :, None] - cum[:, None, :]                 # (B, t, s, ..)
        keep = torch.ones(n, n, dtype=torch.bool, device=u.device).tril()
        seg = seg.masked_fill(~keep[:, :, None, None], float("-inf"))
        x = (dtc * uc)[..., None] * Bc[:, :, None, :]          # (B, n, Di, N)
        hs = torch.einsum("btsdn,bsdn->btdn", torch.exp(seg), x) \
            + torch.exp(cum) * h[:, None]
        ys.append(torch.einsum("btdn,btn->btd", hs, Cc) + uc * Dv)
        h = hs[:, -1]
    return torch.cat(ys, dim=1)


def _mixer(model: dict, x, W: dict, i: int, quant: Quant):
    lw = W["layers"]
    B, T, _ = x.shape
    K, N = model["ssm_conv"], model["ssm_state"]
    R = model.get("dt_rank") or max(1, model["d_model"] // 16)
    xi = _mm(x, _f32(lw["ssm.in_x"][i]), quant)                # (B, T, Di)
    z = _mm(x, _f32(lw["ssm.in_z"][i]), quant)
    cw, cb = _f32(lw["ssm.conv_w"][i]), _f32(lw["ssm.conv_b"][i])
    padded = torch.cat([xi.new_zeros(B, K - 1, xi.shape[2]), xi], dim=1)
    conv = sum(padded[:, j:j + T] * cw[j] for j in range(K)) + cb
    u = F.silu(conv)
    dbc = _mm(u, _f32(lw["ssm.x_proj"][i]), quant)
    dt = F.softplus(_mm(dbc[..., :R], _f32(lw["ssm.dt_proj"][i]), quant)
                    + _f32(lw["ssm.dt_bias"][i]))
    A = -torch.exp(_f32(lw["ssm.A_log"][i]))
    y = selective_scan(u, dt, A, dbc[..., R:R + N], dbc[..., R + N:],
                       _f32(lw["ssm.D"][i]))
    return _mm(y * F.silu(z), _f32(lw["ssm.out_proj"][i]), quant)


@torch.no_grad()
def logits_batch(model: dict, W: dict, seqs: Sequence[Sequence[int]],
                 ats: Sequence[Sequence[int]], quant: Quant = None
                 ) -> List[torch.Tensor]:
    """For each token sequence (read from position 0), the float32 logits
    (len(at), vocab) of the next token after each position in its `at`.
    The sequences run as one batch, right-padded: a causal model's logits
    at a position do not read what follows it."""
    dev = W["embed"].device
    T = max(len(s) for s in seqs)
    toks = torch.zeros(len(seqs), T, dtype=torch.long, device=dev)
    for b, s in enumerate(seqs):
        toks[b, :len(s)] = torch.tensor(list(s), dtype=torch.long)
    x = _f32(W["embed"][toks])
    family = model["family"]
    for i in range(model["num_layers"]):
        if family == "dense":
            x = x + _attention(model, _norm(model, x, W, "ln_attn", i), W, i,
                               quant)
            x = x + _swiglu(_norm(model, x, W, "ln_mlp", i), W, i, quant)
        elif family == "ssm":
            x = x + _mixer(model, _norm(model, x, W, "ln_ssm", i), W, i,
                           quant)
        else:
            raise ValueError(f"no reference for the {family} family")
    head = _f32(W["embed"].t() if model.get("tie_embeddings")
                else W["lm_head"])
    out = []
    for b, at in enumerate(ats):
        xb = _norm(model, x[b, torch.tensor(list(at), device=dev)], W,
                   "final_norm", None)
        out.append(_mm(xb, head, quant))
    return out

