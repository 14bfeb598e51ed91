"""Parameter trees for the port: the JAX package's layout, as torch tensors.

The tree mirrors ``repro/models/model.py::param_specs``: ``{"layers": {name:
(num_layers, ...)}, "embed": (Vp, M), ["lm_head"], ["final_norm.*"]}`` with
the 3-D ``attn.wq/wk/wv`` ``(M, H, hd)`` and ``attn.wo`` ``(H, hd, M)``
leaves, so converting a JAX tree is a plain copy.

The JAX forward casts the fp32 params to the compute dtype on every use
(``.astype(cd)``).  For serving, the port keeps ONE compute-dtype copy of
each weight instead, made at load time — the same numbers.  Training keeps
the JAX layout: master weights in the param dtype (``param_specs``,
``init_params(..., master=True)``, ``train_state_from_jax``), which the
forward casts inside the autograd graph.  Norm scales and biases stay
fp32: the norms read them in fp32; so does the MoE router (``moe.router``),
whose fp32 logits pick the experts, and so do the Mamba mixer's
``ssm.A_log``, ``ssm.D`` and ``ssm.dt_bias``, which it reads in fp32 (a
compute-dtype ``dt_bias`` would move every channel's step size).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.models.config import (DENSE, ENCODER, HYBRID, MOE, SSM, VLM,
                                       ModelConfig)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


#: the model families the port runs: all six of the JAX package
PORTED_FAMILIES = (DENSE, MOE, SSM, HYBRID, VLM, ENCODER)


def require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.family} family: only the {', '.join(PORTED_FAMILIES)} "
            "families are ported (see ROADMAP)")


_FP32_LEAVES = ("moe.router", "ssm.A_log", "ssm.D", "ssm.dt_bias")


def _fp32_leaf(name: str) -> bool:
    """Leaves kept in fp32 whatever the compute dtype: the norms', the MoE
    router and the mixer's A_log, D and dt_bias."""
    return name.startswith(("ln_", "final_norm")) or name in _FP32_LEAVES


def _layer_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Per-layer leaf name → shape without the layer axis."""
    require_ported(cfg)
    m, h, kv, hd = cfg.d_model, cfg.padded_heads, cfg.num_kv_heads, cfg.head_dim
    out: Dict[str, Tuple[int, ...]] = {}

    def norm(prefix: str):
        if cfg.norm_type in ("rmsnorm", "layernorm"):
            out[f"{prefix}.scale"] = (m,)
        if cfg.norm_type == "layernorm":
            out[f"{prefix}.bias"] = (m,)

    if cfg.has_attention:
        norm("ln_attn")
        out["attn.wq"] = (m, h, hd)
        out["attn.wk"] = (m, kv, hd)
        out["attn.wv"] = (m, kv, hd)
        out["attn.wo"] = (h, hd, m)
        if cfg.qkv_bias:
            out["attn.bq"] = (h, hd)
            out["attn.bk"] = (kv, hd)
            out["attn.bv"] = (kv, hd)
    if cfg.has_ssm:
        if not cfg.has_attention:
            norm("ln_ssm")
        di, n, r, k = cfg.d_inner, cfg.ssm_state, cfg.dt_rank_eff, cfg.ssm_conv
        out["ssm.in_x"] = (m, di)
        out["ssm.in_z"] = (m, di)
        out["ssm.conv_w"] = (k, di)
        out["ssm.conv_b"] = (di,)
        out["ssm.x_proj"] = (di, r + 2 * n)
        out["ssm.dt_proj"] = (r, di)
        out["ssm.dt_bias"] = (di,)
        out["ssm.A_log"] = (di, n)
        out["ssm.D"] = (di,)
        out["ssm.out_proj"] = (di, m)
    if cfg.has_moe:
        norm("ln_mlp")
        e, f = cfg.num_experts, cfg.d_ff
        out["moe.router"] = (m, e)
        out["moe.w_gate"] = (e, m, f)
        out["moe.w_up"] = (e, m, f)
        out["moe.w_down"] = (e, f, m)
    if cfg.has_mlp:
        norm("ln_mlp")
        if cfg.mlp_act == "silu":
            out["mlp.w_gate"] = (m, cfg.d_ff)
            out["mlp.w_up"] = (m, cfg.d_ff)
            out["mlp.w_down"] = (cfg.d_ff, m)
        else:
            out["mlp.w_in"] = (m, cfg.d_ff)
            out["mlp.b_in"] = (cfg.d_ff,)
            out["mlp.w_out"] = (cfg.d_ff, m)
            out["mlp.b_out"] = (m,)
    return out


def _top_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """The leaves outside the layer stack; the encoder has no embedding
    (it reads frame embeddings) and always its own LM head."""
    m, vp = cfg.d_model, cfg.padded_vocab
    out = {} if cfg.family == ENCODER else {"embed": (vp, m)}
    if not cfg.tie_embeddings:
        out["lm_head"] = (m, vp)
    if cfg.norm_type in ("rmsnorm", "layernorm"):
        out["final_norm.scale"] = (m,)
    if cfg.norm_type == "layernorm":
        out["final_norm.bias"] = (m,)
    return out


def _dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    """A leaf's serving dtype: the compute dtype, fp32 for _fp32_leaf."""
    return torch.float32 if _fp32_leaf(name) else DTYPES[cfg.compute_dtype]


def _master_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    """A leaf's training dtype, as the JAX ``param_specs`` gives it: the
    param dtype, fp32 for the mixer's A_log and D."""
    if name in ("ssm.A_log", "ssm.D"):
        return torch.float32
    return DTYPES[cfg.param_dtype]


def _cast(cfg: ModelConfig, name: str, x: torch.Tensor) -> torch.Tensor:
    return x.to(_dtype(cfg, name))


def param_specs(cfg: ModelConfig) -> dict:
    """(shape, dtype) of every leaf of the master tree, in the param dtype
    (``repro/models/model.py::param_specs``): ``{"layers": {name: ((L,) +
    shape, dtype)}, "embed", ["lm_head"], ["final_norm.*"]}``."""
    out = {"layers": {k: ((cfg.num_layers,) + s, _master_dtype(cfg, k))
                      for k, s in _layer_shapes(cfg).items()}}
    out.update({k: (s, _master_dtype(cfg, k))
                for k, s in _top_shapes(cfg).items()})
    return out


def params_from_jax(cfg: ModelConfig, tree, device) -> dict:
    """The JAX param tree with numpy leaves (e.g.
    ``jax.tree.map(np.asarray, params)``) → the port's tree on `device`, in
    the compute dtype (the fp32 leaves of ``_fp32_leaf`` in fp32)."""
    def conv(name, x):
        return _cast(cfg, name, torch.from_numpy(np.array(x)).to(device))

    out = {"layers": {k: conv(k, v) for k, v in tree["layers"].items()}}
    out.update({k: conv(k, v) for k, v in tree.items() if k != "layers"})
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator, device, *,
                master: bool = False) -> dict:
    """Random weights by the JAX initializer's rules (``model.py``
    ``init_params``): ``ssm.A_log`` is log(1..N) in every channel and
    ``ssm.D`` ones; other 1-D leaves are ones (scales) or zeros (biases); every
    other leaf is normal with std 1/sqrt(fan_in), where fan_in is M for
    wq/wk/wv, H·hd for wo and the second-to-last dim otherwise.  The draws
    come from `generator` (on `device`), so they differ from
    ``jax.random``'s.  A stacked leaf is drawn one layer at a time straight
    into its tensor, so the fp32 scratch is one layer's (a full-depth MoE
    leaf would need tens of GB of it).  `master` draws the training tree's
    master weights (param dtype, ``param_specs``) instead of the serving
    tree; the draws are the same, so the serving tree equals the masters
    cast to their serving dtypes."""
    leaf_dtype = _master_dtype if master else _dtype

    def draw(name, shape, stacked):
        full = ((cfg.num_layers,) if stacked else ()) + shape
        dt = leaf_dtype(cfg, name)
        if name == "ssm.A_log":
            return torch.log(torch.arange(1, shape[-1] + 1, dtype=dt,
                                          device=device)).expand(full).clone()
        if name == "ssm.D":
            return torch.ones(full, dtype=dt, device=device)
        if len(shape) == 1:
            return (torch.ones if name.endswith("scale") else torch.zeros)(
                full, dtype=dt, device=device)
        if name == "attn.wo":
            fan_in = shape[0] * shape[1]
        elif name.startswith("attn.w"):
            fan_in = shape[0]
        else:
            fan_in = shape[-2]
        std = 1.0 / math.sqrt(max(1, fan_in))
        out = torch.empty(full, dtype=dt, device=device)
        for part in (out if stacked else out[None]):
            part.copy_(torch.randn(shape, generator=generator,
                                   device=device).mul_(std))
        return out

    out = {"layers": {k: draw(k, s, True)
                      for k, s in _layer_shapes(cfg).items()}}
    out.update({k: draw(k, s, False) for k, s in _top_shapes(cfg).items()})
    return out


def train_state_from_jax(cfg: ModelConfig, state, device) -> dict:
    """The JAX train state ``{"params", "opt": {"m", "v"}, "step"}`` with
    numpy leaves (``jax.tree.map(np.asarray, state)``) → the port's
    (``launch/steps.py``): master params in the param dtype, fp32 moments,
    the step as an int."""
    def conv(tree, dtype_of):
        def one(name, x):
            return torch.from_numpy(np.array(x)).to(device, dtype_of(name))
        out = {"layers": {k: one(k, v) for k, v in tree["layers"].items()}}
        out.update({k: one(k, v) for k, v in tree.items() if k != "layers"})
        return out

    def f32(_name):
        return torch.float32

    return {"params": conv(state["params"],
                           lambda name: _master_dtype(cfg, name)),
            "opt": {"m": conv(state["opt"]["m"], f32),
                    "v": conv(state["opt"]["v"], f32)},
            "step": int(np.asarray(state["step"]))}
