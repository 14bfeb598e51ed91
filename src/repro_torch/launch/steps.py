"""The one-device train step (port of the train part of
``repro/launch/steps.py`` with ``mesh=None``).

The train state is ``{"params": master weights in the param dtype (fp32 by
default), "opt": {"m", "v"} fp32 moments, "step": int}``, the JAX package's
layout (``train_state_from_jax`` converts one).  A step runs the forward in
train mode (the masters cast to the compute dtype inside the graph, the
attention through the training path of ``kernels.ops.flash_attention``:
kernel 1 with its lse, differentiated by the flash backward kernel),
``lm_loss``, the gradients in fp32, optional micro-batch accumulation, and
AdamW in place.  The prefill and decode step builders belong to the serving
engine (``serving/engine.py``).

Every family trains.  The MoE family's expert products go through the
grouped matmul and its backward kernel (``kernels.ops.gmm``/``gmm_bwd``),
routed in ``pick_num_groups`` capacity groups of each micro-batch's tokens
as the JAX step picks them with no mesh; the ssm and hybrid families' mixers
through the selective scan and its backward kernel
(``kernels.ops.selective_scan``/``selective_scan_bwd``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.models import model as MDL
from repro_torch.models import moe as MOE
from repro_torch.models import params as PRM
from repro_torch.models.config import ModelConfig, ShapeSpec
from repro_torch.training import optim as OPT


def train_state_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """(shape, dtype) of every tensor of the train state; the step is an
    int (``training.checkpoint.restore`` takes this as its `like`)."""
    ps = PRM.param_specs(cfg)

    def f32(spec):
        return (spec[0], torch.float32)
    return {"params": ps, "opt": {"m": OPT.map_tree(f32, ps),
                                  "v": OPT.map_tree(f32, ps)},
            "step": int}


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     device) -> Dict[str, Any]:
    """Master weights by the JAX initializer's rules from `generator`
    (``params.init_params(master=True)``), zero moments, step 0."""
    params = PRM.init_params(cfg, generator, device, master=True)
    return {"params": params, "opt": OPT.init_opt_state(params), "step": 0}


def make_train_step(cfg: ModelConfig, shape: ShapeSpec, num_micro: int = 1,
                    opt_cfg: OPT.AdamWConfig = None, device=None, *,
                    remat: bool = True,
                    remat_policy: str = "nothing") -> Callable:
    """Returns ``step(state, batch) -> (state, metrics)``.  batch: the data
    pipeline's dict (numpy arrays or tensors) of shape.global_batch rows;
    with num_micro > 1 it is cut into that many micro-batches along the
    batch axis, whose fp32 gradients are summed and divided by num_micro
    (the loss likewise).  The state is updated in place and returned;
    metrics ``{"loss", "grad_norm", "lr"}`` are float32 scalars on the
    device (`device`, or the params' when None).  `remat` and
    `remat_policy` go to every forward, the micro-batches' included
    (``models.model.forward``; JAX's names and defaults): the gradients
    are the same to the bit, the memory held until the backward is not."""
    opt_cfg = opt_cfg or OPT.AdamWConfig()
    if shape.global_batch % num_micro:
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"into {num_micro} micro-batches")
    micro_tokens = (shape.global_batch // num_micro) * shape.seq_len
    num_groups = MOE.pick_num_groups(micro_tokens, 1) if cfg.has_moe else 1

    def loss_fn(params, mb):
        logits, _ = MDL.forward(cfg, params, mb, mode="train",
                                num_groups=num_groups, remat=remat,
                                remat_policy=remat_policy)
        return MDL.lm_loss(cfg, logits, mb["labels"], mb["mask"])

    def train_step(state, batch):
        params = state["params"]
        leaves = OPT.leaves(params)
        dev = device or leaves[0].device
        batch = {k: v if isinstance(v, torch.Tensor) else
                 torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in batch.items()}
        batch = {k: v.to(dev) for k, v in batch.items()}
        for p in leaves:
            p.requires_grad_(True)
        try:
            if num_micro == 1:
                loss = loss_fn(params, batch)
                grads = torch.autograd.grad(loss, leaves)
                loss = loss.detach()
            else:
                n = shape.global_batch // num_micro
                loss = torch.zeros((), dtype=torch.float32, device=dev)
                grads = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
                         for p in leaves]
                for i in range(num_micro):
                    mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                    lm = loss_fn(params, mb)
                    for acc, g in zip(grads, torch.autograd.grad(lm, leaves)):
                        acc.add_(g)
                    loss = loss + lm.detach()
                loss = loss / num_micro
                grads = [g / num_micro for g in grads]
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = _like_tree(params, grads)
        _, _, stats = OPT.adamw_update(opt_cfg, params, grads, state["opt"],
                                       state["step"])
        state["step"] += 1
        return state, {"loss": loss, **stats}

    return train_step


def _like_tree(tree, flat: list):
    """`flat` (in OPT.leaves order) laid out as `tree`."""
    return _laid_out(tree, iter(flat))


def _laid_out(tree, it):
    # a module-level function, not a closure that calls itself: such a
    # closure is a reference cycle that would keep `flat` (a step's fp32
    # gradients) alive until the garbage collector's next pass
    if isinstance(tree, dict):
        return {k: _laid_out(tree[k], it) for k in sorted(tree)}
    return next(it)


def state_equal(a, b) -> Tuple[bool, str]:
    """Whether two train states are equal to the bit; else the first leaf
    that differs."""
    la, lb = OPT.leaves(a["params"]), OPT.leaves(b["params"])
    la += OPT.leaves(a["opt"])
    lb += OPT.leaves(b["opt"])
    if a["step"] != b["step"]:
        return False, "step"
    for i, (x, y) in enumerate(zip(la, lb)):
        if not torch.equal(x, y):
            return False, f"leaf {i}"
    return True, ""
