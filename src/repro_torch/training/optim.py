"""AdamW with global-norm clipping and a linear-warmup/cosine schedule
(port of ``repro/training/optim.py``).

The optimizer state is two fp32 trees shaped like the parameters.  The
arithmetic is the JAX package's, in float32 scalars and elementwise ops;
unlike the JAX version, which returns new trees, ``adamw_update`` writes the
parameters and moments IN PLACE, one leaf at a time, so the update needs
no second copy of the train state on the device.

On a mesh (the train step's ``mesh``) every tree holds the rank's shards,
laid out alike (``launch.steps.train_state_pspecs``): the update is
elementwise on them, and the clipping norm is the global one, summing each
distinct element once (``global_norm``'s `specs`).
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


def global_norm(tree, specs=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares.

    On a mesh (`specs`: the leaves' specs, laid out as `tree`; `mesh`: a
    ``launch.dist.Mesh``) the tree holds this rank's shards: the leaves'
    sums of squares are added up by the set of axes (wider than 1) that
    they are sharded on, and each such partial sum over those axes' ranks,
    so a leaf replicated over an axis counts once, not once a rank.  With
    no such axis it is the one-device sum, to the bit."""
    squares = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    if mesh is None:
        return torch.sqrt(torch.stack(squares).sum())
    by_axes: Dict[tuple, list] = {}
    for sq, spec in zip(squares, leaves(specs)):
        named = {a for e in spec for a in mesh.axes(e)}
        axes = tuple(a for a in mesh.axis_names
                     if a in named and mesh.shape[a] > 1)
        by_axes.setdefault(axes, []).append(sq)
    partial = [mesh.all_reduce_(torch.stack(v).sum(), axes)
               for axes, v in by_axes.items()]
    return torch.sqrt(torch.stack(partial).sum())


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, opt: Dict[str, dict],
                 step: int, *, specs=None, mesh=None
                 ) -> Tuple[dict, Dict[str, dict], Dict[str, torch.Tensor]]:
    """One AdamW step at `step` (0-based): clip the gradients to global norm
    cfg.clip_norm, update the fp32 moments, bias-correct them, and apply
    the step with decoupled weight decay on every leaf.  params, opt["m"]
    and opt["v"] are written in place and returned, with the stats
    ``{"grad_norm", "lr"}`` (float32 scalars on the params' device).  On a
    mesh the trees are the rank's shards and `specs` the params' specs
    (``global_norm``)."""
    dev = leaves(params)[0].device
    gnorm = global_norm(grads, specs, mesh)
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
