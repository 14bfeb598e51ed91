"""Parameter trees for the port: the JAX package's layout, as torch tensors.

The tree mirrors ``repro/models/model.py::param_specs``: ``{"layers": {name:
(num_layers, ...)}, "embed": (Vp, M), ["lm_head"], ["final_norm.*"]}`` with
the 3-D ``attn.wq/wk/wv`` ``(M, H, hd)`` and ``attn.wo`` ``(H, hd, M)``
leaves, so converting a JAX tree is a plain copy.

The JAX forward casts the fp32 params to the compute dtype on every use
(``.astype(cd)``).  The port keeps ONE compute-dtype copy of each weight
instead, made at load time — the same numbers.  Norm scales and biases stay
fp32: the norms read them in fp32.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.models.config import DENSE, ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _is_norm(name: str) -> bool:
    return name.startswith(("ln_", "final_norm"))


def _layer_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Per-layer leaf name → shape without the layer axis (dense family)."""
    if cfg.family != DENSE:
        raise NotImplementedError(
            f"{cfg.family} family: only the dense family is ported (see ROADMAP)")
    m, h, kv, hd = cfg.d_model, cfg.padded_heads, cfg.num_kv_heads, cfg.head_dim
    out: Dict[str, Tuple[int, ...]] = {}

    def norm(prefix: str):
        if cfg.norm_type in ("rmsnorm", "layernorm"):
            out[f"{prefix}.scale"] = (m,)
        if cfg.norm_type == "layernorm":
            out[f"{prefix}.bias"] = (m,)

    norm("ln_attn")
    out["attn.wq"] = (m, h, hd)
    out["attn.wk"] = (m, kv, hd)
    out["attn.wv"] = (m, kv, hd)
    out["attn.wo"] = (h, hd, m)
    if cfg.qkv_bias:
        out["attn.bq"] = (h, hd)
        out["attn.bk"] = (kv, hd)
        out["attn.bv"] = (kv, hd)
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
    m, vp = cfg.d_model, cfg.padded_vocab
    out = {"embed": (vp, m)}
    if not cfg.tie_embeddings:
        out["lm_head"] = (m, vp)
    if cfg.norm_type in ("rmsnorm", "layernorm"):
        out["final_norm.scale"] = (m,)
    if cfg.norm_type == "layernorm":
        out["final_norm.bias"] = (m,)
    return out


def _cast(cfg: ModelConfig, name: str, x: torch.Tensor) -> torch.Tensor:
    return x.float() if _is_norm(name) else x.to(DTYPES[cfg.compute_dtype])


def params_from_jax(cfg: ModelConfig, tree, device) -> dict:
    """The JAX param tree with numpy leaves (e.g.
    ``jax.tree.map(np.asarray, params)``) → the port's tree on `device`, in
    the compute dtype (norm leaves in fp32)."""
    def conv(name, x):
        return _cast(cfg, name, torch.from_numpy(np.array(x)).to(device))

    out = {"layers": {k: conv(k, v) for k, v in tree["layers"].items()}}
    out.update({k: conv(k, v) for k, v in tree.items() if k != "layers"})
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """Random weights by the JAX initializer's rules (``model.py``
    ``init_params``): 1-D leaves are ones (scales) or zeros (biases); every
    other leaf is normal with std 1/sqrt(fan_in), where fan_in is M for
    wq/wk/wv, H·hd for wo and the second-to-last dim otherwise.  The draws
    come from `generator` (on `device`), so they differ from
    ``jax.random``'s."""
    def draw(name, shape, stacked):
        full = ((cfg.num_layers,) if stacked else ()) + shape
        if len(shape) == 1:
            v = (torch.ones if name.endswith("scale") else torch.zeros)(
                full, device=device)
        else:
            if name == "attn.wo":
                fan_in = shape[0] * shape[1]
            elif name.startswith("attn.w"):
                fan_in = shape[0]
            else:
                fan_in = shape[-2]
            v = torch.randn(full, generator=generator, device=device)
            v.mul_(1.0 / math.sqrt(max(1, fan_in)))
        return _cast(cfg, name, v)

    out = {"layers": {k: draw(k, s, True)
                      for k, s in _layer_shapes(cfg).items()}}
    out.update({k: draw(k, s, False) for k, s in _top_shapes(cfg).items()})
    return out
