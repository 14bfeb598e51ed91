"""Mamba-1 selective SSM mixer (falcon-mamba's blocks, hymba's SSM heads;
port of ``repro/models/mamba.py``).

The JAX package scans a prefill in chunks (``lax.scan`` over chunks,
``lax.associative_scan`` inside each) and runs decode as a separate
single-step recurrence (``mode="decode"``).  Here one path serves train,
prefill and decode: the selective scan ``scan_fn`` (the Hopper kernel
``kernels.ops.selective_scan`` by default), where a decode step is the scan
over one token from the carried state, exactly the JAX single-step
formula.

The carried state is written IN PLACE: given an ``SSMState`` of cache
views, ``mamba_mixer`` overwrites its ``conv`` and ``h`` with the new state
(the scan writes ``h`` where it read it), as the port's forward does for
K/V.  Callers that must keep a state unchanged pass a copy.  Train mode
(no state) starts from zeros, as the JAX train forward does, and writes no
state: the scan is then differentiated (its backward kernel on the card),
which an in-place state write under autograd would defeat.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as KOPS


class SSMState(NamedTuple):
    conv: torch.Tensor   # (B, conv-1, d_inner) fp32: last inputs of the conv
    h: torch.Tensor      # (B, d_inner, state) fp32: SSM hidden state


def _causal_conv(x: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                 prev: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv in x's dtype, summed in the JAX order (the K
    products in turn, then the bias).  x (B, S, D); conv_w (K, D); prev
    (B, K-1, D), read in x's dtype.  Returns (y (B, S, D), new_prev (B,
    K-1, D) in x's dtype)."""
    K, S = conv_w.shape[0], x.shape[1]
    xx = torch.cat([prev.to(x.dtype), x], dim=1)              # (B, S+K-1, D)
    y = xx[:, :S] * conv_w[0]
    for i in range(1, K):
        y = y + xx[:, i:i + S] * conv_w[i]
    y = y + conv_b
    new_prev = xx[:, S:] if K > 1 else prev
    return y, new_prev


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``'s formula, max(x, 0) + log1p(exp(-|x|))."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def mamba_mixer(x: torch.Tensor, params: dict, *, ssm_state_dim: int,
                dt_rank: int, conv_dim: int,
                state: Optional[SSMState] = None, scan_fn=None,
                to_model=None, from_model=None
                ) -> Tuple[torch.Tensor, Optional[SSMState]]:
    """The mamba-1 mixer.  x (B, S, M) in the compute dtype (S = 1 for a
    decode step).  params: in_x/in_z (M, Di), conv_w (K, Di), conv_b (Di),
    x_proj (Di, R+2N), dt_proj (R, Di) in the compute dtype; dt_bias (Di),
    A_log (Di, N), D (Di) fp32.  `state` None is train mode: zeros in, no
    state out (the scan's final state is dropped).  Otherwise the state's
    tensors are read and overwritten in place.  Returns (out (B, S, M), the
    new state, or None in train mode).

    With d_inner sharded over `model` (the train step on a mesh), `params`
    hold the rank's channels and `to_model` / `from_model` are the
    collectives of ``launch/dist.py`` over `model`: x enters by
    ``to_model``, x_proj's output (dt, B and C of every channel) is a
    partial sum made whole by ``from_model`` and then read per channel
    (``to_model``), and out_proj's partial sums leave by ``from_model``."""
    Bz = x.shape[0]
    Di = params["A_log"].shape[0]
    N, R, K = ssm_state_dim, dt_rank, conv_dim
    scan_fn = scan_fn or KOPS.selective_scan

    if to_model is not None:
        x = to_model(x)
    x_in = x @ params["in_x"]                                 # (B, S, Di)
    z = x @ params["in_z"]
    prev = x_in.new_zeros(Bz, K - 1, Di) if state is None else state.conv
    conv_out, new_conv = _causal_conv(x_in, params["conv_w"],
                                      params["conv_b"], prev)
    u = F.silu(conv_out.float()).to(x.dtype)

    dbc = u @ params["x_proj"]                                # (B, S, R+2N)
    if to_model is not None:
        dbc = to_model(from_model(dbc))
    dt = softplus((dbc[..., :R] @ params["dt_proj"]).float()
                  + params["dt_bias"])                        # (B, S, Di)
    A = -torch.exp(params["A_log"])                           # (Di, N)
    Bm, Cm = dbc[..., R:R + N], dbc[..., R + N:]
    if state is None:
        y, _ = scan_fn(u, dt, A, Bm, Cm, params["D"])
    else:
        y, _ = scan_fn(u, dt, A, Bm, Cm, params["D"], state.h, h_out=state.h)
        state.conv.copy_(new_conv)
    out = (y.to(x.dtype) * F.silu(z)) @ params["out_proj"]
    return (out if from_model is None else from_model(out)), state
