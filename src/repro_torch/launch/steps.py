"""The train, prefill and decode steps, on one device or on a mesh of ranks
(port of ``repro/launch/steps.py``: ``make_train_step(..., mesh=)``,
``make_prefill_step`` and ``make_decode_step``).

The train state is ``{"params": master weights in the param dtype (fp32 by
default), "opt": {"m", "v"} fp32 moments, "step": int}``, the JAX package's
layout (``train_state_from_jax`` converts one).  A step runs the forward in
train mode (the masters cast to the compute dtype inside the graph, the
attention through the training path of ``kernels.ops.flash_attention``:
kernel 1 with its lse, differentiated by the flash backward kernel),
``lm_loss``, the gradients in fp32, optional micro-batch accumulation, and
AdamW in place.

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
group span two ranks, and the step refuses it.

The serving builders (JAX's names, arguments and defaults) run the forward
without autograd: ``make_prefill_step`` a full-sequence forward into a fresh
decode cache, returning the last position's logits; ``make_decode_step``
one token against a ``shape.seq_len``-deep cache.  With `mesh` they are
JAX's sharded steps, each rank running its shards through
``launch.mesh.ServeShards``: the prefill in the train layout (heads over
`model`, FSDP over the data axes unless ``fsdp=False``) or sequence
parallel over ZeRO-3 weights, its cache in the hd layout; the decode step
in the layout that ``cache_shard_mode`` (hd, lc, kv) and
``resident_weights`` pick, as JAX picks it.  A mesh step takes the rank's
parameter shards (the step's ``param_pspecs``; ``mesh.shard_tree``), the
global batch (it keeps its rows; in the sequence-parallel prefill the
forward cuts its chunk of the sequence after the embedding, for the VLM
after the image prefix joins the text) and, in decode, the rank's cache
shard; it returns
the rank's logits and cache shards (``logits_pspec``, ``cache_pspecs``).
``reshard_cache`` moves a prefill's cache into a decode layout.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

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


# ------------------------------ serving steps ---------------------------------
def _refuse_calibrate(calibrate: bool) -> None:
    if calibrate:
        raise NotImplementedError(
            "calibrate: XLA's unrolled cost-analysis compile has no torch "
            "counterpart (see launch/dryrun.py)")


def _tensors(batch, dev) -> Dict[str, torch.Tensor]:
    return {k: (v if isinstance(v, torch.Tensor) else
                torch.from_numpy(np.ascontiguousarray(v))).to(dev)
            for k, v in batch.items()}


def _local_cache(cfg, batch: int, cache_len: int, specs, mesh,
                 include_row_idx: bool = False) -> Dict[str, Any]:
    """A fresh cache's shards on this rank (``init_cache``'s values)."""
    out: Dict[str, Any] = {
        k: torch.zeros(MS.local_shape(shape, specs[k], mesh), dtype=dt,
                       device=mesh.device)
        for k, (shape, dt) in MDL.cache_specs(cfg, batch, cache_len,
                                              include_row_idx).items()}
    if "slot_pos" in out:
        out["slot_pos"].fill_(-1)
    out["idx"] = 0
    return out


def _serving(step, **attrs):
    for k, v in attrs.items():
        setattr(step, k, v)
    return step


def make_prefill_step(cfg: ModelConfig, mesh, shape: ShapeSpec, *,
                      cache_len: Optional[int] = None,
                      emit_cache: bool = True, calibrate: bool = False,
                      banded: bool = False, seq_parallel: bool = False,
                      fsdp: bool = True, device=None):
    """Prefill: full-sequence forward → (last-token logits, decode cache).
    Returns (step, (param_specs, batch_specs)); ``step(params, batch)``.

    A fresh ``init_cache(B, cache_len or shape.seq_len)`` (where
    `emit_cache` and the model decodes; else the forward runs in train mode
    and no cache is returned), ``forward(mode="prefill")`` with
    ``last_only`` for a model that decodes, the MoE family in
    ``pick_num_groups(B·S, data shards)`` capacity groups.

    banded -- JAX's sliding-window flash runs only the kv blocks of a band
              from the batch's least query position.  Kernel 1 already skips
              every tile wholly outside the window, so the step is the same
              (ROADMAP queue 3: where left pads exceed a kv block, JAX's
              band drops visible keys; this step does not).
    seq_parallel -- (mesh) the sequence over `model`, ZeRO-3 weights
              gathered whole a layer at a time, K/V all-gathered for
              full-context attention; logits of the whole vocabulary.
              The sequence is `shape.seq_len` (the VLM's image prefix and
              text together, each rank a chunk of the joined sequence, as
              JAX lays it out); a length that does not split over `model`
              raises ValueError.
    fsdp   -- (mesh) the train layout's data-axis sharding of the weights.
    device -- (no mesh) where the cache is made and the batch moved: CUDA
              by default, "cpu" on request; the params must be there.
    calibrate=True raises: XLA's cost-analysis compile has no counterpart.

    With `mesh` the step has ``param_pspecs``, ``batch_pspecs``,
    ``cache_pspecs`` (hd layout; None without a cache) and
    ``logits_pspec``; it takes the rank's parameter shards and the global
    batch and returns the rank's logits and cache shards.  A batch that
    does not split over the data axes (batch 1, an odd batch) is laid out
    by JAX's rules: every data rank holds every row, the cache splits its
    slots over the data axes (each rank writes its slots of the ring), and
    the logits' rows are whole (``P(None, "model")``: JAX's decode step's
    rule, where its prefill step refuses such a batch)."""
    _refuse_calibrate(calibrate)
    B, S = shape.global_batch, shape.seq_len
    batch_specs = CC.prefill_batch_specs(cfg, B, S)
    cache_len = cache_len or S
    data_shards = MS.axis_size(mesh, MS.data_axes(mesh)) if mesh else 1
    num_groups = MOE.pick_num_groups(B * S, data_shards) if cfg.has_moe \
        else 1
    with_cache = emit_cache and cfg.supports_decode
    mode = "prefill" if with_cache else "train"
    fwd = dict(mode=mode, remat=False, num_groups=num_groups,
               last_only=cfg.supports_decode)

    if mesh is None:
        dev = device or D.device_type_of(None)

        def prefill_step(params, batch):
            batch = _tensors(batch, dev)
            cache = MDL.init_cache(cfg, B, cache_len, device=dev) \
                if with_cache else None
            with torch.no_grad():
                logits, cache = MDL.forward(cfg, params, batch, cache=cache,
                                            **fwd)
            return logits[:, -1], cache

        return prefill_step, (PRM.param_specs(cfg), batch_specs)

    pp = MS.param_pspecs_zero3(cfg, mesh) if seq_parallel else \
        MS.param_pspecs(cfg, mesh, fsdp=fsdp)
    bps = MS.batch_pspecs(cfg, mesh, batch_specs)
    seq = seq_parallel and mesh.size("model") > 1
    if seq_parallel:
        if S % mesh.size("model"):
            raise ValueError(f"seq_parallel: sequence {S} does not split "
                             f"over model ({mesh.size('model')})")
    cps = MS.cache_pspecs(cfg, mesh, MDL.cache_specs(cfg, B, cache_len)) \
        if with_cache else None
    rows = bps["positions"][0]
    shard = MS.ServeShards(cfg, mesh, pp, batch=B, rows=rows, cache=cps,
                           zero3=seq_parallel, seq=seq,
                           num_groups=num_groups)
    if seq:
        fwd["residual_cs"], fwd["kv_cs"] = MS.seq_parallel_hooks(mesh)

    def mesh_prefill_step(params, batch):
        batch = {k: MS.local_shard(v, bps[k], mesh, mesh.coords)
                 for k, v in _tensors(batch, "cpu").items()}
        batch = {k: v.to(mesh.device) for k, v in batch.items()}
        cache = _local_cache(cfg, B, cache_len, cps, mesh) if with_cache \
            else None
        with torch.no_grad():
            logits, cache = MDL.forward(cfg, params, batch, cache=cache,
                                        shard=shard, **fwd)
            out = logits[:, -1]
            if seq:       # the last position is the last model rank's
                last = mesh.index("model") == mesh.size("model") - 1
                out = shard.sum(out if last else torch.zeros_like(out),
                                ("model",))
        return out, cache

    return _serving(mesh_prefill_step, param_pspecs=pp, batch_pspecs=bps,
                    cache_pspecs=cps,
                    logits_pspec=MS.P(rows, None if seq_parallel else "model")
                    ), (PRM.param_specs(cfg), batch_specs)


def decode_attn_mode(cfg: ModelConfig, cache_shard_mode: str) -> str:
    """The attention layout of a decode step on a mesh, as JAX picks it."""
    if cache_shard_mode == "hd" and cfg.head_dim % 16 == 0:
        return "hd"
    if cache_shard_mode == "lc":
        return "replicated"      # the model axis belongs to the cache length
    return "heads"


def make_decode_step(cfg: ModelConfig, mesh, shape: ShapeSpec, *,
                     cache_shard_mode: str = "hd", donate_cache: bool = True,
                     calibrate: bool = False, per_row_write: bool = False,
                     resident_weights: bool = False, device=None):
    """One-token serve step against a ``shape.seq_len``-deep cache.
    Returns (step, (param_specs, batch_specs, cache_specs));
    ``step(params, batch, cache) -> (logits (B, 1, Vp), cache)``.

    The cache is updated in place and returned (JAX donates it); with
    ``donate_cache=False`` the step works on a copy and leaves the caller's
    cache as it was.  `per_row_write`: the cache carries ``row_idx`` (B,),
    each row's own write cursor (``cache_specs(include_row_idx=True)``).
    The MoE family routes in ``pick_num_groups(B, data shards)`` groups.

    With `mesh`: ``cache_shard_mode`` 'hd' (head_dim over `model`, the
    attention weights' head_dim too, kernel (b)), 'lc' (the cache length
    over `model`, attention weights replicated, kernel (a); with
    per_row_write the slot write is masked), 'kv' (kv heads over `model`
    where they divide 16, heads over `model`, kernel 2 on the rank's
    heads) or 'none'; ``resident_weights`` takes ``param_pspecs(fsdp=False,
    resident=True)`` (nothing gathered per step).  The step has
    ``param_pspecs``, ``batch_pspecs``, ``cache_pspecs`` and
    ``logits_pspec``.  A batch that does not split over the data axes
    keeps every row on every data rank and splits the cache's slots over
    the data axes (JAX's long_500k layout): hd then runs kernel (b) over
    the rank's slot range and head_dim slice and merges the slot ranges by
    their lse, lc splits the slots over the data axes and `model`, kv and
    'none' over the data axes (kernel (a)); the logits' rows are whole
    (``P(None, None, "model")``).  calibrate=True raises, as in
    make_prefill_step."""
    _refuse_calibrate(calibrate)
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name} has no decode step")
    B = shape.global_batch
    batch_specs = CC.decode_batch_specs(cfg, B)
    cache_specs = MDL.cache_specs(cfg, B, shape.seq_len,
                                  include_row_idx=per_row_write)
    data_shards = MS.axis_size(mesh, MS.data_axes(mesh)) if mesh else 1
    num_groups = MOE.pick_num_groups(B, data_shards) if cfg.has_moe else 1
    fwd = dict(mode="decode", remat=False, num_groups=num_groups)

    def copied(cache):
        return cache if donate_cache else {
            k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in cache.items()}

    if mesh is None:
        dev = device or D.device_type_of(None)

        def decode_step(params, batch, cache):
            with torch.no_grad():
                return MDL.forward(cfg, params, _tensors(batch, dev),
                                   cache=copied(cache), **fwd)

        return decode_step, (PRM.param_specs(cfg), batch_specs, cache_specs)

    pp = MS.param_pspecs(cfg, mesh, fsdp=not resident_weights,
                         attn_mode=decode_attn_mode(cfg, cache_shard_mode),
                         resident=resident_weights)
    bps = MS.batch_pspecs(cfg, mesh, batch_specs)
    cps = MS.cache_pspecs(cfg, mesh, cache_specs,
                          shard_mode=cache_shard_mode)
    rows = bps["positions"][0]
    shard = MS.ServeShards(cfg, mesh, pp, batch=B, rows=rows, cache=cps,
                           resident=resident_weights, num_groups=num_groups)

    def mesh_decode_step(params, batch, cache):
        batch = {k: MS.local_shard(v, bps[k], mesh, mesh.coords).to(
            mesh.device) for k, v in _tensors(batch, "cpu").items()}
        with torch.no_grad():
            return MDL.forward(cfg, params, batch, cache=copied(cache),
                               shard=shard, **fwd)

    return _serving(mesh_decode_step, param_pspecs=pp, batch_pspecs=bps,
                    cache_pspecs=cps,
                    logits_pspec=MS.P(rows, None, "model")), \
        (PRM.param_specs(cfg), batch_specs, cache_specs)


def reshard_cache(mesh, cache, src, dst):
    """A rank's cache shards laid out by `src` (a prefill step's
    ``cache_pspecs``: hd) as laid out by `dst` (a decode step's): an
    all-to-all over `model` where a dim's split moves (hd → lc, hd → kv;
    at a batch that does not split, hd's slot range over the data axes
    cut further over `model` for lc), the same tensors where nothing
    moves.  The decode step's cache may carry
    ``row_idx``, which a prefill's lacks: each row's cursor starts at the
    shared ``idx``."""
    out = MS.reshard_tree(mesh, cache, src, dst)
    if "row_idx" in dst and "row_idx" not in out:
        b = cache["slot_pos"].shape[0] if "slot_pos" in cache else \
            cache["conv"].shape[1]
        out["row_idx"] = torch.full((b,), int(cache["idx"]),
                                    dtype=torch.int32, device=mesh.device)
    return out
