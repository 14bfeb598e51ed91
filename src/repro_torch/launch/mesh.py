"""Production mesh + sharding rules (port of ``repro/launch/mesh.py``), and
what one rank of a mesh reads of them in the train and serving steps.

The rules are data: a spec is a tuple with one entry a dim -- None, an axis
name, or a tuple of names (``P(...)`` builds one) -- and every rule takes an
object with ``.shape`` ({axis: size}) and ``.axis_names``, as JAX's do, so
one stand-in mesh serves both packages' rules, and a ``dist.Mesh`` of
running ranks serves the step.  Axes:
  single-pod : (data=16, model=16)            -- 256 devices
  multi-pod  : (pod=2, data=16, model=16)     -- 512 devices

The rules and their thresholds are the JAX package's, unchanged: the tests
of divisibility are against the production model axis's 16
(``heads_shardable``, ``expert_sharding``, ``head_dim % 16``, ``kvh % 16``,
``di % 16``), whatever the mesh's size.
  * training  = 2D FSDP x TP: weight contraction dims shard over `data`
    (+`pod`), feature dims over `model`; optimizer state like weights.
  * serving   = the same weight layout, or ``resident`` / ``hd`` /
    ``replicated`` attention and ZeRO-3 (``param_pspecs_zero3``); caches
    by ``cache_pspecs`` (hd, lc, kv or none), which the prefill and decode
    step builders of ``launch/steps.py`` run (``ServeShards``).
  * attention = query heads over `model` when the padded head count
    divides 16; otherwise attention weights replicate over `model`.
  * MoE       = experts over `model` when num_experts % 16 == 0 (EP), else
    per-expert FFN TP (mixtral).
  * vocab     = padded to a multiple of 256 -> shards over `model`.

``local_shape``, ``local_shard`` and ``put_shard`` map between a full
tensor and a rank's shard under a spec; a dim that does not divide raises
(nothing is padded); ``shard_tree`` / ``gather_tree`` do it for a tree of a
running mesh, and ``reshard`` moves a rank's shard from one spec to another
(a cache from the prefill's hd layout to a decode mode's: an all-to-all over
`model`).  ``TrainShards`` is the train step's view of a mesh for one rank
(``models.model.forward``'s ``shard``): which leaves it gathers over the
data axes and along which dim, its slice of the heads, vocabulary and
experts, and the collectives of ``launch/dist.py`` over `model` and the
data axes.  ``ServeShards`` is the serving steps' (prefill and decode, any
of the layouts above).  ``moe_constraint_fns``, ``logits_constraint`` and
``seq_parallel_hooks`` give the forward's ``dispatch_cs``/``combine_cs``,
``logits_cs`` and ``residual_cs``/``kv_cs`` hooks.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.models import params as PRM
from repro_torch.models.config import ModelConfig

PyTree = Any
Mesh = Any   # a MeshShape, a dist.Mesh, or any object with .shape/.axis_names


def P(*entries) -> tuple:
    """A spec: one entry a dim (None, an axis name or a tuple of names); a
    tuple of one name is that name, as in a JAX PartitionSpec."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


class MeshShape:
    """A mesh's axes and sizes, which is all the rules read."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The production mesh's axes: (data 16, model 16) or (pod 2, data 16,
    model 16).  Running it takes that many ranks (``dist.Mesh``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshShape(dict(zip(axes, shape)))


def data_axes(mesh: Mesh):
    """The (possibly compound) batch-sharding axis."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def axis_size(mesh: Mesh, name) -> int:
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= mesh.shape[n]
        return out
    return mesh.shape[name]


def _shape(spec) -> Tuple[int, ...]:
    """A (shape, dtype) spec's shape (or a tensor's)."""
    return tuple(spec.shape) if hasattr(spec, "shape") else tuple(spec[0])


def _map_named(fn, tree, prefix: str = ""):
    """`tree` with each leaf replaced by fn(path, leaf): the path is
    ".layers.attn.wq", as the JAX rules build it from
    ``jax.tree_util.keystr``."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, f"{prefix}.{k}") for k, v in tree.items()}
    return fn(prefix, tree)


# ----------------------------- parameter specs --------------------------------
def param_pspecs(cfg: ModelConfig, mesh: Mesh, *, fsdp: bool = True,
                 attn_mode: str = "heads", resident: bool = False) -> PyTree:
    """Spec tree matching ``params.param_specs(cfg)``.

    attn_mode:
      'heads'      -- query heads over `model` when divisible (train/prefill);
      'hd'         -- head_dim over `model` for all attention tensors (decode:
                      uniform across archs, matches the hd-sharded KV cache);
      'replicated' -- attention weights carry no model-axis sharding (used
                      with length-sharded caches).

    resident=True (serving decode): weights stay sharded on device across
    steps -- feature dims spread over BOTH mesh axes when they divide, and
    nothing is sharded on a dim that would force a per-step weight
    all-gather."""
    da = data_axes(mesh)
    fa = da if fsdp else None          # fsdp axis (contraction dims)
    mdl = "model"
    heads_tp = cfg.heads_shardable and attn_mode == "heads"
    hd_tp = attn_mode == "hd" and cfg.head_dim % 16 == 0

    bd = axis_size(mesh, da)
    both = tuple(da) + (mdl,)
    nboth = bd * mesh.shape[mdl]

    def wide(dim: int):
        # widest axis set dividing `dim` (for resident layouts)
        if dim % nboth == 0:
            return both
        if dim % mesh.shape[mdl] == 0:
            return mdl
        if dim % bd == 0:
            return da
        return None

    if resident:
        fa = None

    def spec_for(path: str, ndim_core: int) -> tuple:
        # vectors (norm scales, biases over d_model / dt / conv)
        if path.endswith((".scale", ".bias")):
            return P(*([None] * ndim_core))
        if ".attn.wq" in path or ".attn.wk" in path or ".attn.wv" in path:
            # (M, H|KV, hd)
            if hd_tp:
                return P(fa, None, mdl)
            if ".attn.wq" in path and heads_tp:
                return P(fa, mdl, None)
            return P(fa, None, None)           # KV replicated / odd heads
        if ".attn.wo" in path:
            if hd_tp:
                return P(None, mdl, fa)
            return P(mdl, None, fa) if heads_tp else P(None, None, fa)
        if ".attn.b" in path:
            if hd_tp:
                return P(None, mdl)
            return P(mdl, None) if (heads_tp and ".bq" in path) else P(None, None)
        if ".mlp.w_gate" in path or ".mlp.w_up" in path or ".mlp.w_in" in path:
            return P(None, wide(cfg.d_ff)) if resident else P(fa, mdl)
        if ".mlp.w_down" in path or ".mlp.w_out" in path:
            return P(wide(cfg.d_ff), None) if resident else P(mdl, fa)
        if ".mlp.b_in" in path:
            return P(mdl)
        if ".mlp.b_out" in path:
            return P(None)
        if ".moe.router" in path:
            return P(fa, None)
        if ".moe.w_gate" in path or ".moe.w_up" in path:
            # (E, M, F)
            if resident:
                fdim = da if cfg.d_ff % bd == 0 else None
                return P(mdl, None, fdim) if cfg.expert_sharding == "ep" \
                    else P(None, None, wide(cfg.d_ff))
            return P(mdl, fa, None) if cfg.expert_sharding == "ep" \
                else P(None, fa, mdl)
        if ".moe.w_down" in path:
            # (E, F, M)
            if resident:
                fdim = da if cfg.d_ff % bd == 0 else None
                return P(mdl, fdim, None) if cfg.expert_sharding == "ep" \
                    else P(None, wide(cfg.d_ff), None)
            return P(mdl, None, fa) if cfg.expert_sharding == "ep" \
                else P(None, mdl, fa)
        if ".ssm.in_x" in path or ".ssm.in_z" in path:
            return P(fa, mdl)
        if ".ssm.conv_w" in path:
            return P(None, mdl)
        if ".ssm.conv_b" in path or ".ssm.dt_bias" in path or "ssm.D" in path:
            return P(mdl)
        if ".ssm.x_proj" in path:
            return P(mdl, None)
        if ".ssm.dt_proj" in path:
            return P(None, mdl)
        if ".ssm.A_log" in path:
            return P(mdl, None)
        if ".ssm.out_proj" in path:
            return P(mdl, fa)
        if "embed" in path:
            if resident:
                return P(wide(cfg.padded_vocab), None)
            return P(mdl, fa)                  # (Vp, M)
        if "lm_head" in path:
            if resident:
                return P(None, wide(cfg.padded_vocab))
            return P(fa, mdl)                  # (M, Vp)
        raise ValueError(f"no sharding rule for {path}")

    def leaf(pstr, spec):
        stacked = ".layers." in pstr
        core = len(_shape(spec)) - (1 if stacked else 0)
        sp = spec_for(pstr, core)
        return P(None, *sp) if stacked else sp  # leading layer-stack axis

    return _map_named(leaf, PRM.param_specs(cfg))


# ------------------------------ batch/cache specs ------------------------------
def batch_pspecs(cfg: ModelConfig, mesh: Mesh, batch_specs: Dict[str, Any]
                 ) -> Dict[str, Any]:
    da = data_axes(mesh)
    bd = axis_size(mesh, da)
    out = {}
    for k, v in batch_specs.items():
        shape = _shape(v)
        b = shape[0]
        lead = da if b % bd == 0 and b >= bd else None
        out[k] = P(lead, *([None] * (len(shape) - 1)))
    return out


def cache_pspecs(cfg: ModelConfig, mesh: Mesh, cache_specs: Dict[str, Any],
                 *, shard_mode: str = "hd") -> Dict[str, Any]:
    """shard_mode: 'hd' (head_dim over model), 'lc' (cache length over
    model), 'kv' (kv heads over model), 'none'. Batch=1 cells fall back to
    sharding the length axis over `data`.  (The port's cache holds its
    write cursor ``idx`` on the host; a JAX-style spec dict may still name
    it.)"""
    da = data_axes(mesh)
    bd = axis_size(mesh, da)
    out: Dict[str, Any] = {}
    for k, v in cache_specs.items():
        if k == "idx":
            out[k] = P()
            continue
        shape = _shape(v)
        if k == "row_idx":                       # (B,)
            b = shape[0]
            out[k] = P(da if (b % bd == 0 and b >= bd) else None)
            continue
        if k == "slot_pos":                      # (B, lc)
            b, lc = shape
            if b % bd == 0 and b >= bd:
                out[k] = P(da, None)
            elif lc % bd == 0:
                out[k] = P(None, da)
            else:
                out[k] = P(None, None)
            continue
        if k in ("k", "v"):                      # (L, B, lc, KV, hd)
            _, b, lc, kvh, hd = shape
            bspec = da if (b % bd == 0 and b >= bd) else None
            lspec = None if bspec is not None else (da if lc % bd == 0 else None)
            kspec, hspec = None, None
            if shard_mode == "kv" and kvh % 16 == 0:
                kspec = "model"
            elif shard_mode == "lc" and lc % 16 == 0:
                # JAX's rule nests the data tuple here, (("data",), "model"),
                # which a PartitionSpec refuses: the port flattens it
                lspec = (*lspec, "model") if lspec else "model"
            elif shard_mode == "hd" and hd % 16 == 0:
                hspec = "model"
            out[k] = P(None, bspec, lspec, kspec, hspec)
            continue
        if k == "conv":                          # (L, B, K-1, Di)
            _, b, _, di = shape
            bspec = da if (b % bd == 0 and b >= bd) else None
            out[k] = P(None, bspec, None, "model" if di % 16 == 0 else None)
            continue
        if k == "h":                             # (L, B, Di, N)
            _, b, di, _ = shape
            bspec = da if (b % bd == 0 and b >= bd) else None
            out[k] = P(None, bspec, "model" if di % 16 == 0 else None, None)
            continue
        raise ValueError(k)
    return out


# --------------------------- ZeRO-3 / sequence parallel -----------------------
def param_pspecs_zero3(cfg: ModelConfig, mesh: Mesh) -> PyTree:
    """ZeRO-3 layout for sequence-parallel prefill: every weight leaf is
    flat-sharded on its largest divisible dim over as many axes as divide
    it; weights are all-gathered per layer at use while activations stay
    (batch x sequence)-sharded."""
    da = data_axes(mesh)
    bd = axis_size(mesh, da)
    md = mesh.shape["model"]
    candidates = [tuple(da) + ("model",), tuple(da), ("model",)]
    sizes = [bd * md, bd, md]

    def leaf_spec(shape, stacked):
        core = list(shape[1:] if stacked else shape)
        order = sorted(range(len(core)), key=lambda i: -core[i])
        for cand, n in zip(candidates, sizes):
            for d in order:
                if core[d] % n == 0:
                    sp = [None] * len(core)
                    sp[d] = cand if len(cand) > 1 else cand[0]
                    return P(*([None] + sp if stacked else sp))
        return P(*([None] * len(shape)))

    return _map_named(lambda pstr, spec: leaf_spec(_shape(spec),
                                                   "layers" in pstr),
                      PRM.param_specs(cfg))


# ------------------------------- local shards ----------------------------------
def _entry_sizes(spec, mesh) -> list:
    return [1 if e is None else axis_size(mesh, e) for e in spec]


def local_shape(shape, spec, mesh: Mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard of a `shape` tensor under `spec`;
    raises where a sharded dim does not divide."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    out = list(shape)
    for d, n in enumerate(_entry_sizes(spec, mesh)):
        if out[d] % n:
            raise ValueError(f"dim {d} ({out[d]}) of {tuple(shape)} does not "
                             f"divide over {spec[d]} ({n})")
        out[d] //= n
    return tuple(out)


def _index(entry, mesh: Mesh, coords: Dict[str, int]) -> int:
    """A rank's index along a spec entry: row-major over its axes."""
    i = 0
    for a in ((entry,) if isinstance(entry, str) else entry):
        i = i * mesh.shape[a] + coords[a]
    return i


def _slices(shape, spec, mesh, coords) -> tuple:
    loc = local_shape(shape, spec, mesh)
    return tuple(slice(None) if e is None else
                 slice(_index(e, mesh, coords) * loc[d],
                       (_index(e, mesh, coords) + 1) * loc[d])
                 for d, e in enumerate(spec))


def local_shard(full: torch.Tensor, spec, mesh: Mesh,
                coords: Dict[str, int]) -> torch.Tensor:
    """The shard of `full` that the rank at `coords` ({axis: index}) holds
    under `spec` (a view)."""
    return full[_slices(full.shape, spec, mesh, coords)]


def put_shard(full: torch.Tensor, shard: torch.Tensor, spec, mesh: Mesh,
              coords: Dict[str, int]) -> torch.Tensor:
    """The reverse: write the rank's `shard` into its place in `full`."""
    full[_slices(full.shape, spec, mesh, coords)] = shard
    return full


# --------------------------- the train step's hooks ---------------------------
def moe_constraint_fns(cfg: ModelConfig, mesh: Mesh, shardable_groups: bool):
    """dispatch/combine hooks for the MoE block on a ``dist.Mesh``.

    The tokens of a data rank are replicated over `model` (the residual
    stream is), so JAX's EP all-to-all of the capacity buffer (dispatch:
    experts over `model`; combine: back to token-local) moves nothing on
    the way in: each model rank dispatches its own experts' rows
    (``moe_block``'s ``first_expert``), and the way back gathers every
    expert's rows.  Here both layouts use the same pair:
      dispatch_cs -- the token rows entering the expert products: identity
                     forward, their gradient summed over `model` (each rank
                     differentiates only its experts' or its d_ff slice's
                     rows);
      combine_cs  -- the choice-ordered expert outputs, summed over `model`
                     before the K-weighted sum: under EP each row comes from
                     one rank (the others hold zeros), under TP the ranks'
                     partial down products add up.
    Capacity groups stay inside a data rank (``shardable_groups``; the
    step refuses a group count that would split one)."""
    if not shardable_groups:
        raise ValueError("the port's capacity groups stay inside a data "
                         "rank: shardable_groups must be True")

    def dispatch_cs(x):
        return mesh.copy_to(x, "model")

    def combine_cs(y):
        return mesh.reduce_from(y, "model")

    return dispatch_cs, combine_cs


def logits_constraint(cfg: ModelConfig, mesh: Mesh, batch_shardable: bool):
    """The logits stay vocab-sharded over `model` (rows over the data axes
    where `batch_shardable`): each rank holds its (B, S, Vp / model)
    slice, which this checks."""
    width = cfg.padded_vocab // mesh.shape["model"]

    def f(x):
        if x.shape[-1] != width:
            raise ValueError(f"logits of width {x.shape[-1]}: a rank holds "
                             f"{width} of the {cfg.padded_vocab} vocab columns")
        return x

    return f


class TrainShards:
    """One rank's view of the train layout (``param_pspecs(fsdp=True,
    attn_mode="heads")``) on a ``dist.Mesh``, which ``models.model.forward``
    takes as `shard`:

    * ``leaf(name, t)``: a master shard cast to its compute dtype and
      all-gathered over the data axes along its FSDP dim (inside the layer
      that remat recomputes, so the recompute gathers again and no rank
      holds a full stacked leaf); its gradient is reduce-scattered back;
    * ``tp``: the model axis is wider than 1; then ``heads_tp`` (query heads
      over `model`), ``q_lo`` / ``vocab_lo`` / ``expert_lo`` (the first of
      this rank's query heads, vocab rows and experts), ``to_model`` and
      ``from_model`` (``dist.Mesh.copy_to`` / ``reduce_from`` over `model`);
    * ``data_sum``/``model_max``: collectives without gradient (the loss's
      mask count over the data axes, the vocab-parallel log-sum-exp's max).
    """

    serving = False

    def __init__(self, cfg: ModelConfig, mesh):
        self.cfg, self.mesh = cfg, mesh
        self.specs = param_pspecs(cfg, mesh, fsdp=True)
        self.data = data_axes(mesh)
        m = mesh.size("model")
        self.tp = self.mixer_tp = m > 1
        self.heads_tp = self.tp and cfg.has_attention and cfg.heads_shardable
        mi = mesh.index("model")
        self.q_lo = mi * (cfg.padded_heads // m) if self.heads_tp else 0
        self.vocab_lo = mi * (cfg.padded_vocab // m)
        self.expert_lo = mi * (cfg.num_experts // m) \
            if cfg.expert_sharding == "ep" and self.tp else 0

    def spec(self, name: str) -> tuple:
        if name in self.specs["layers"]:
            return self.specs["layers"][name][1:]
        return self.specs[name]

    def leaf(self, name: str, t: torch.Tensor) -> torch.Tensor:
        dtype = PRM._dtype(self.cfg, name)
        fsdp = [d for d, e in enumerate(self.spec(name))
                if e is not None and e != "model"]
        if not fsdp:
            return t.to(dtype)
        (dim,) = fsdp
        return self.mesh.gather_cast(t, dtype, dim, self.spec(name)[dim])

    def to_model(self, x: torch.Tensor) -> torch.Tensor:
        return self.mesh.copy_to(x, "model")

    def from_model(self, x: torch.Tensor) -> torch.Tensor:
        return self.mesh.reduce_from(x, "model")

    def kv_heads(self, w: torch.Tensor, h: int) -> torch.Tensor:
        """The kv heads (dim 1 of wk/wv, dim 0 of bk/bv after the layer
        axis is gone) that this rank's `h` query heads read, from a weight
        replicated over `model` (``_kv_pick``).  The weight's gradient is
        summed over `model`."""
        return self._kv_pick(self.to_model(w), h, 1 if w.dim() == 3 else 0)

    def _kv_pick(self, t: torch.Tensor, h: int, dim: int) -> torch.Tensor:
        """Of `t` (every kv head along `dim`), those that this rank's `h`
        query heads from ``q_lo`` read: a contiguous run where the heads
        tile whole GQA groups or sit inside one, else one kv head per query
        head."""
        cfg = self.cfg
        g = cfg.padded_heads // cfg.num_kv_heads
        lo = self.q_lo
        if h % g == 0 or (g % h == 0 and lo // g == (lo + h - 1) // g):
            return t.narrow(dim, lo // g, max(1, h // g))
        idx = torch.tensor([(lo + i) // g for i in range(h)], device=t.device)
        return t.index_select(dim, idx)

    def data_sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce_(t.detach().clone(), self.data)

    def model_max(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce_(t.detach().clone(), "model",
                                     op=dist.ReduceOp.MAX)


def seq_parallel_hooks(mesh):
    """(residual_cs, kv_cs) of the sequence-parallel prefill on a
    ``dist.Mesh``.  JAX constrains the residual stream to (batch over the
    data axes, sequence over `model`) and K/V to replicated over `model`,
    and GSPMD inserts the all-gather.  Here the step hands each rank its
    rows and its slice of the sequence, so residual_cs is the identity;
    kv_cs all-gathers a (B, S, ...) tensor (K, V and their positions) along
    the sequence over `model`, for full-context attention."""
    def residual_cs(x):
        return x

    def kv_cs(x):
        return mesh.all_gather(x, 1, "model")

    return residual_cs, kv_cs


class ServeShards(TrainShards):
    """One rank's view of a serving layout on a ``dist.Mesh``: the prefill
    and decode steps' `shard` (``models.model.forward``), with no autograd.

    `specs` is the parameter layout (``param_pspecs`` of any attention mode,
    FSDP or not, resident or not, or ``param_pspecs_zero3``), `cache` the
    cache's specs (``cache_pspecs``, or None).  Of each leaf's spec entries
    the rank gathers some where the layer runs and keeps the others split:
      * FSDP layouts: the data axes are gathered (one layer at a time),
        `model` stays (heads, head_dim, d_ff, d_inner, experts, vocab);
      * resident layouts: nothing is gathered; a feature dim split over the
        data axes (and `model`) is tensor parallel over them, so the tiny
        decode activations are all-gathered over the data axes before such
        a product and its partial sums reduced over all its axes;
      * ZeRO-3 (`zero3`, the sequence-parallel prefill): every leaf is
        gathered whole; the rank holds its rows and its slice of the
        sequence (`seq`: ``seq_chunk``, cut in the forward after the
        embedding and, for the VLM, the image prefix's join), K/V and
        positions are gathered along it, and the
        mixer and the MoE block (whose capacity groups and scan run along
        the sequence) gather the sequence too.
    ``axes_of`` gives a leaf dim's kept axes (those wider than 1) and
    ``lo`` a rank's first index along them; ``cache_kv`` / ``cache_hd`` are
    the (first, count) of the kv heads and head_dim columns this rank's
    cache holds, ``slot_axes`` the axes its slots split over and
    ``pos_axes`` those of its slot positions.

    `row_shards` is the number of data shards the batch's rows are split
    over, from `rows`, the rows' entry of ``batch_pspecs``.  JAX splits
    them where the batch divides the data shards; else (batch 1, an odd batch) it is 1: every data
    rank holds and computes every row, as GSPMD does for a replicated
    batch, and the cache splits its slots over the data axes instead
    (``cache_pspecs``), with the slot positions: alone (hd at `model` 1,
    kv, none), with `model` (lc), or beside a head_dim split over `model`
    (hd).  The conv and SSM states are then whole over the data axes.
    `moe_gather` says that the MoE block must all-gather the split rows
    over the data axes to route JAX's capacity groups (a group count that
    is no multiple of the data shards, or expert weights split over
    them)."""

    serving = True

    def __init__(self, cfg: ModelConfig, mesh, specs, *, batch: int,
                 rows=None, cache=None, resident: bool = False, zero3: bool = False,
                 seq: bool = False, num_groups: int = 1):
        self.cfg, self.mesh, self.specs = cfg, mesh, specs
        self.data = data_axes(mesh)
        self.zero3, self.resident = zero3, resident
        m = mesh.size("model")
        self.tp = m > 1 and not zero3
        self.seq = seq and m > 1
        ds = mesh.size(self.data)
        # `rows`: the rows' entry of ``batch_pspecs`` (the data axes where
        # the batch splits over them, else None: every data rank holds
        # every row)
        self.row_shards = mesh.size(rows) if rows else 1
        self.rows_n = batch // self.row_shards
        self.rows_lo = mesh.index(self.data) * self.rows_n \
            if self.row_shards > 1 else 0
        self.heads_tp = False
        if cfg.has_attention:
            self.heads_tp = bool(self.axes_of("attn.wq", 1))
            self.q_lo = self.lo(self.axes_of("attn.wq", 1), cfg.padded_heads)
            self.hd_axes = self.axes_of("attn.wq", 2)
            self.hd_lo = self.lo(self.hd_axes, cfg.head_dim)
        self.mixer_tp = cfg.has_ssm and bool(self.axes_of("ssm.in_x", 1))
        if cfg.has_moe:
            self.expert_axes = self.axes_of("moe.w_gate", 0)
            self.expert_lo = self.lo(self.expert_axes, cfg.num_experts)
            self.moe_axes = self.union(self.expert_axes,
                                       self.axes_of("moe.w_gate", 2))
            self.moe_gather = self.row_shards > 1 and (
                num_groups % ds != 0
                or bool(set(self.moe_axes) & set(self.data)))
        self.cache_kv = self.cache_hd = None
        self.slot_axes = self.pos_axes = ()
        if cache is not None and "k" in cache:
            _, _, lspec, kspec, hspec = cache["k"]
            kv, hd = cfg.num_kv_heads, cfg.head_dim
            self.slot_axes = self._split(lspec)
            self.cache_kv = self._range(kspec, kv)
            self.cache_hd = self._range(hspec, hd)
            self.pos_axes = self._split(cache["slot_pos"][1])
        if cache is not None and "h" in cache and self.mixer_tp \
                and not mesh.axes(cache["h"][2]):
            raise ValueError("d_inner is split over `model` but the SSM "
                             "state is not (d_inner % 16 != 0)")

    def _range(self, entry, n: int) -> tuple:
        axes = self.mesh.axes(entry)
        k = self.mesh.size(axes) if axes else 1
        return (self.lo(axes, n), n // k)

    def _split(self, entry) -> tuple:
        """The axes of a spec entry wider than 1."""
        return tuple(a for a in self.mesh.axes(entry)
                     if self.mesh.shape[a] > 1)

    def _kept(self, entry) -> tuple:
        axes = self._split(entry)
        if self.zero3:
            return ()
        if self.resident:
            return axes
        return tuple(a for a in axes if a == "model")

    def union(self, *axes) -> tuple:
        """Tuples of axes together, in mesh order."""
        names = {a for t in axes for a in t}
        return tuple(a for a in self.mesh.axis_names if a in names)

    def axes_of(self, name: str, dim: int) -> tuple:
        """The axes that leaf `name`'s core dim `dim` stays split over on
        this rank (the layer axis not counted)."""
        return self._kept(self.spec(name)[dim])

    def lo(self, axes, n: int) -> int:
        """This rank's first index of a dim of `n` split over `axes`."""
        if not axes:
            return 0
        return self.mesh.index(axes) * (n // self.mesh.size(axes))

    def leaf(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The shard in its serving dtype, gathered along the entries the
        layout gathers (no autograd)."""
        t = t.to(PRM._dtype(self.cfg, name))
        for dim, entry in enumerate(self.spec(name)):
            if entry is not None and not self._kept(entry):
                t = self.mesh.all_gather(t, dim, entry)
        return t

    def whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The leaf gathered whole, whatever the layout keeps split."""
        for dim, entry in enumerate(self.spec(name)):
            if self._kept(entry):
                t = self.mesh.all_gather(t, dim, self._kept(entry))
        return t

    def to_model(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def from_model(self, x: torch.Tensor) -> torch.Tensor:
        return self.sum(x, ("model",))

    def sum(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The sum over `axes`' ranks (in place; no-op without axes)."""
        return self.mesh.all_reduce_(t.contiguous(), axes) if axes else t

    def rows_over(self, x: torch.Tensor, axes) -> torch.Tensor:
        """`x` (rows first) with every data rank's rows, where `axes` (a
        product's split axes) include data axes and the rows are split."""
        if self.row_shards > 1 and set(axes) & set(self.data):
            return self.mesh.all_gather(x, 0, self.data)
        return x

    def own_rows(self, x: torch.Tensor, axes) -> torch.Tensor:
        """The reverse of ``rows_over``: this rank's rows."""
        if self.row_shards > 1 and set(axes) & set(self.data):
            return x[self.rows_lo:self.rows_lo + self.rows_n]
        return x

    def seq_chunk(self, t: torch.Tensor) -> torch.Tensor:
        """This `model` rank's contiguous chunk of a (B, S, ...) sequence:
        [r S / m, (r + 1) S / m) of rank r of m."""
        n = t.shape[1] // self.mesh.size("model")
        lo = self.mesh.index("model") * n
        return t[:, lo:lo + n].contiguous()

    def kv_subset(self, t: torch.Tensor, h: int, dim: int) -> torch.Tensor:
        """``_kv_pick`` of a K/V tensor or cache, contiguous (the attention
        kernels read it whole)."""
        return self._kv_pick(t, h, dim).contiguous()


def shard_tree(mesh, tree, specs):
    """A full tree (params, or a cache whose host int ``idx`` passes
    through) as this rank's shards on the mesh's device."""
    if isinstance(tree, dict):
        return {k: shard_tree(mesh, v, specs[k]) if k in specs else v
                for k, v in tree.items()}
    return mesh.local(tree, specs)


def gather_tree(mesh, tree, specs):
    """The reverse of ``shard_tree`` (a collective: every rank gets the
    full tree)."""
    if isinstance(tree, dict):
        return {k: gather_tree(mesh, v, specs[k]) if k in specs else v
                for k, v in tree.items()}
    return mesh.full(tree, specs)


def reshard(mesh, t: torch.Tensor, src, dst) -> torch.Tensor:
    """This rank's shard of a tensor laid out by `src`, laid out by `dst`.
    Where one dim's axes move to another dim, after the axes that dim
    already splits over (a cache from head_dim over `model` to its length
    or kv heads over `model`; a batch-1 cache's slots over the data axes,
    head_dim over `model`, to its slots over the data axes and `model`) an
    all-to-all over those axes; otherwise an all-gather and a slice."""
    src, dst = tuple(src), tuple(dst)
    if src == dst:
        return t
    moved = [d for d in range(len(src)) if src[d] != dst[d]]
    if len(moved) == 2:
        for a, b in (moved, moved[::-1]):
            went = mesh.axes(src[a])
            if went and dst[a] is None and \
                    mesh.axes(dst[b]) == mesh.axes(src[b]) + went:
                return mesh.all_to_all(t, b, a, src[a])
    return mesh.local(mesh.full(t, src), dst)


def reshard_tree(mesh, tree, src, dst):
    """``reshard`` of every tensor of a tree (a cache: ``idx`` passes)."""
    if isinstance(tree, dict):
        return {k: reshard_tree(mesh, v, src[k], dst[k]) if k in src else v
                for k, v in tree.items()}
    return reshard(mesh, tree, src, dst)


class NamedSharding:
    """A spec on a running mesh (JAX's name): ``place`` puts a full tensor's
    shard for this rank on the mesh's device, ``gather`` rebuilds the full
    tensor from every rank's shard (a collective)."""

    def __init__(self, mesh, spec: tuple):
        self.mesh, self.spec = mesh, spec

    def place(self, full: torch.Tensor) -> torch.Tensor:
        return self.mesh.local(full, self.spec)

    def gather(self, shard: torch.Tensor) -> torch.Tensor:
        return self.mesh.full(shard, self.spec)
