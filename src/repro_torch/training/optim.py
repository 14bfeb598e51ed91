"""AdamW with global-norm clipping and a linear-warmup/cosine schedule
(port of ``repro/training/optim.py``).

The optimizer state is two fp32 trees shaped like the parameters.  The
arithmetic is the JAX package's, in float32 scalars and elementwise ops;
unlike the JAX version, which returns new trees, ``adamw_update`` writes the
parameters and moments IN PLACE, one leaf at a time, so the update needs
no second copy of the train state on the device.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def lr_at(cfg: AdamWConfig, step: int) -> torch.Tensor:
    """The learning rate of `step` as a float32 scalar: linear warm-up to
    cfg.lr over warmup_steps, then a cosine to lr · min_lr_ratio at
    total_steps."""
    s = _f32(step)
    warm = s / max(1.0, cfg.warmup_steps)
    frac = (s - cfg.warmup_steps) / max(1.0, cfg.total_steps
                                        - cfg.warmup_steps)
    frac = torch.clamp(frac, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(_f32(math.pi) * frac))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def leaves(tree) -> list:
    """A tree's tensors in the JAX package's leaf order (dict keys sorted,
    depth first), as ``jax.tree.leaves`` gives them."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_opt_state(params) -> Dict[str, dict]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    return torch.sqrt(torch.stack([torch.sum(torch.square(x.float()))
                                   for x in leaves(tree)]).sum())


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, opt: Dict[str, dict],
                 step: int) -> Tuple[dict, Dict[str, dict], Dict[str, torch.Tensor]]:
    """One AdamW step at `step` (0-based): clip the gradients to global norm
    cfg.clip_norm, update the fp32 moments, bias-correct them, and apply
    the step with decoupled weight decay on every leaf.  params, opt["m"]
    and opt["v"] are written in place and returned, with the stats
    ``{"grad_norm", "lr"}`` (float32 scalars on the params' device)."""
    dev = leaves(params)[0].device
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_at(cfg, step).to(dev)
    t = _f32(step) + 1.0
    bc1 = (1.0 - _f32(cfg.b1) ** t).to(dev)
    bc2 = (1.0 - _f32(cfg.b2) ** t).to(dev)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(opt["m"]),
                          leaves(opt["v"])):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        step_dir = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        step_dir.add_(cfg.weight_decay * p.float())
        p.copy_(p.float() - lr * step_dir)
    return params, opt, {"grad_norm": gnorm, "lr": lr}
