"""The train step, on one device or on a mesh of ranks (port of the train
part of ``repro/launch/steps.py``: ``make_train_step(..., mesh=)``).

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

With ``mesh`` (a ``launch.dist.Mesh``) the step is JAX's 2D FSDP x TP
layout: the state is laid out by ``train_state_pspecs`` (each rank holds
its shards: ``init_train_state(..., mesh=)``, ``shard_train_state``), the
batch by ``batch_pspecs``, and the forward runs on the rank's shards with
the hooks of ``launch/mesh.py`` (``TrainShards``, ``moe_constraint_fns``,
``logits_constraint``): FSDP leaves gathered a layer at a time and their
gradients reduce-scattered, heads / d_ff / d_inner / experts / vocabulary
over `model`.  The gradients of leaves replicated over the data axes are
summed over them, the loss is the global masked mean, the clipping norm
the global one, and the metrics are the same on every rank.  Micro-batch
i is the global rows [i n, (i + 1) n), split over the data axes, as JAX's
``micro_cs`` groups them, and the MoE family routes a data rank's tokens
in its share of ``pick_num_groups(micro-batch tokens, data shards)``
groups; a count that is not a multiple of the data shards would let a
group span two ranks, and the step refuses it.  The prefill and decode
builders with a mesh (the serving half) are not ported yet (ROADMAP).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs import common as CC
from repro_torch.launch import dist as D
from repro_torch.launch import mesh as MS
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


def train_state_pspecs(cfg: ModelConfig, mesh, *, fsdp: bool = True
                       ) -> Dict[str, Any]:
    """The train state's specs: moments laid out like the weights."""
    pp = MS.param_pspecs(cfg, mesh, fsdp=fsdp)
    return {"params": pp, "opt": {"m": pp, "v": pp}, "step": MS.P()}


def train_state_shardings(cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """``train_state_pspecs`` on a running mesh, as ``mesh.NamedSharding``
    leaves (the step: None): the `shardings` of ``training.checkpoint``'s
    save and restore."""
    specs = train_state_pspecs(cfg, mesh)
    return {"params": OPT.map_tree(lambda s: MS.NamedSharding(mesh, s),
                                   specs["params"]),
            "opt": {k: OPT.map_tree(lambda s: MS.NamedSharding(mesh, s), v)
                    for k, v in specs["opt"].items()},
            "step": None}


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     device=None, *, mesh=None) -> Dict[str, Any]:
    """Master weights by the JAX initializer's rules from `generator`
    (``params.init_params(master=True)``), zero moments, step 0.  With
    `mesh` every rank draws the same weights, one layer at a time on the
    mesh's device, and keeps its shards (``train_state_pspecs``): the
    state is the one-device state's, sharded.  Without `mesh`, `device`
    None means CUDA, which raises without a GPU (``dist.device_type_of``):
    pass "cpu" to build the state on the CPU."""
    if mesh is None:
        if device is None:
            device = D.device_type_of(None)
        params = PRM.init_params(cfg, generator, device, master=True)
    else:
        specs = MS.param_pspecs(cfg, mesh)

        def local(name, t):
            spec = specs["layers"][name][1:] if name in specs["layers"] \
                else specs[name]
            return MS.local_shard(t, spec, mesh, mesh.coords)
        params = PRM.init_params(cfg, generator, mesh.device, master=True,
                                 local=local)
    return {"params": params, "opt": OPT.init_opt_state(params), "step": 0}


def shard_train_state(cfg: ModelConfig, state, mesh) -> Dict[str, Any]:
    """A full train state (on any device) as this rank's shards on the
    mesh's device (``train_state_pspecs``)."""
    return _placed(state, train_state_shardings(cfg, mesh), "place")


def gather_train_state(cfg: ModelConfig, state, mesh) -> Dict[str, Any]:
    """The reverse: the full state from every rank's shards (each rank gets
    it, on the mesh's device)."""
    return _placed(state, train_state_shardings(cfg, mesh), "gather")


def _placed(state, shardings, how: str):
    if isinstance(state, dict):
        return {k: _placed(v, shardings[k], how) for k, v in state.items()}
    return state if shardings is None else getattr(shardings, how)(state)


def make_train_step(cfg: ModelConfig, shape: ShapeSpec, num_micro: int = 1,
                    opt_cfg: OPT.AdamWConfig = None, device=None, *,
                    remat: bool = True, remat_policy: str = "nothing",
                    mesh=None, num_groups: int = None) -> Callable:
    """Returns ``step(state, batch) -> (state, metrics)``.  batch: the data
    pipeline's dict (numpy arrays or tensors) of shape.global_batch rows;
    with num_micro > 1 it is cut into that many micro-batches along the
    batch axis, whose fp32 gradients are summed and divided by num_micro
    (the loss likewise).  The state is updated in place and returned;
    metrics ``{"loss", "grad_norm", "lr"}`` are float32 scalars on the
    device (`device`, or the params' when None).  `remat` and
    `remat_policy` go to every forward, the micro-batches' included
    (``models.model.forward``; JAX's names and defaults): the gradients
    are the same to the bit, the memory held until the backward is not.

    With `mesh` (a ``launch.dist.Mesh``; the module docstring) every rank
    calls the step with its shards of the state and the same global batch,
    of which it moves its own rows to its device.  On a mesh whose axes
    are all 1 the step is the one-device step, to the bit.  `num_groups`
    overrides the MoE family's capacity-group count over the whole
    micro-batch (by default ``pick_num_groups(micro-batch tokens, data
    shards)``, as JAX picks it)."""
    opt_cfg = opt_cfg or OPT.AdamWConfig()
    if shape.global_batch % num_micro:
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"into {num_micro} micro-batches")
    n = shape.global_batch // num_micro
    data_shards = MS.axis_size(mesh, MS.data_axes(mesh)) if mesh else 1
    if n % data_shards:
        raise ValueError(f"micro-batches of {n} rows (batch "
                         f"{shape.global_batch} x {shape.seq_len} in "
                         f"{num_micro}) do not split over {data_shards} "
                         "data shards")
    if num_groups is None:
        num_groups = MOE.pick_num_groups(n * shape.seq_len, data_shards) \
            if cfg.has_moe else 1
    if cfg.has_moe and num_groups % data_shards:
        raise ValueError(
            f"batch {shape.global_batch} x {shape.seq_len} in {num_micro} "
            f"micro-batches: {num_groups} capacity groups of "
            f"{n * shape.seq_len} tokens are not a multiple of the "
            f"{data_shards} data shards, so a group would span two data "
            "ranks")
    hooks, shard, rows, norm_on_mesh = {}, None, n, {}
    if mesh is not None:
        da = MS.data_axes(mesh)
        shard = MS.TrainShards(cfg, mesh)
        dispatch_cs, combine_cs = MS.moe_constraint_fns(cfg, mesh, True)
        hooks = dict(dispatch_cs=dispatch_cs, combine_cs=combine_cs,
                     logits_cs=MS.logits_constraint(cfg, mesh, True),
                     shard=shard)
        norm_on_mesh = dict(specs=shard.specs, mesh=mesh)
        rows = n // data_shards
        # a micro-batch's rows over the data axes (JAX's micro_cs)
        micro_specs = MS.batch_pspecs(
            cfg, mesh, CC.train_batch_specs(cfg, n, shape.seq_len))
        # leaves replicated over the data axes: their gradients are summed
        # there (the FSDP leaves' are reduce-scattered in the backward)
        summed = [not any(set(mesh.axes(e)) & set(da) for e in spec)
                  for spec in OPT.leaves(shard.specs)]

    def loss_fn(params, mb):
        logits, _ = MDL.forward(cfg, params, mb, mode="train",
                                num_groups=max(1, num_groups // data_shards),
                                remat=remat, remat_policy=remat_policy,
                                **hooks)
        return MDL.lm_loss(cfg, logits, mb["labels"], mb["mask"], shard)

    def micro(batch, i):
        """This rank's rows of micro-batch i, the global rows [i n, (i + 1)
        n) laid out by ``batch_pspecs``."""
        return {k: MS.local_shard(v[i * n:(i + 1) * n], micro_specs[k], mesh,
                                  mesh.coords) for k, v in batch.items()}

    def train_step(state, batch):
        params = state["params"]
        leaves = OPT.leaves(params)
        dev = mesh.device if mesh is not None else \
            (device or leaves[0].device)
        batch = {k: v if isinstance(v, torch.Tensor) else
                 torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in batch.items()}
        if mesh is not None:
            parts = [micro(batch, i) for i in range(num_micro)]
            batch = {k: torch.cat([p[k] for p in parts]) for k in batch}
        batch = {k: v.to(dev) for k, v in batch.items()}
        for p in leaves:
            p.requires_grad_(True)
        try:
            if num_micro == 1:
                loss = loss_fn(params, batch)
                grads = torch.autograd.grad(loss, leaves)
                loss = loss.detach()
            else:
                loss = torch.zeros((), dtype=torch.float32, device=dev)
                grads = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
                         for p in leaves]
                for i in range(num_micro):
                    mb = {k: v[i * rows:(i + 1) * rows]
                          for k, v in batch.items()}
                    lm = loss_fn(params, mb)
                    for acc, g in zip(grads, torch.autograd.grad(lm, leaves)):
                        acc.add_(g)
                    loss = loss + lm.detach()
                loss = loss / num_micro
                grads = [g / num_micro for g in grads]
        finally:
            for p in leaves:
                p.requires_grad_(False)
        if mesh is not None:
            for g, s in zip(grads, summed):
                if s:
                    mesh.all_reduce_(g, da)
            mesh.all_reduce_(loss, da)
        grads = _like_tree(params, grads)
        _, _, stats = OPT.adamw_update(opt_cfg, params, grads, state["opt"],
                                       state["step"], **norm_on_mesh)
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
