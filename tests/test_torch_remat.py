"""Remat in the port's train step against the JAX package's, in float32 on
the CPU, for the six families at their smoke configs (olmo-1b, paligemma-3b,
hubert-xlarge, qwen3-moe-30b-a3b, falcon-mamba-7b, hymba-1.5b):

* the loss, the logits and every gradient leaf with remat off, "nothing"
  and "dots" are equal to the bit in the port, and each matches JAX's
  ``forward(remat=..., remat_policy=p)`` under ``jax.value_and_grad`` (the
  loss of JAX's ``make_train_step``);
* (tests/test_torch_remat_steps.py: AdamW steps and resume under each
  policy);
* what each policy keeps until the backward, at 2 and 4 layers: the
  tensors autograd saves (``torch.autograd.graph.saved_tensors_hooks``;
  the non-reentrant checkpoint saves its inputs through them) and the
  products that the "dots" policy caches; the shapes of those products
  against the residuals ``jax.ad_checkpoint.print_saved_residuals`` lists;
* a MoE case whose capacity drops choices: the recompute routes the same
  rows (the same ``group_sizes`` at every grouped matmul) and gives the
  same gradients.

Tolerances are tests/test_torch_training.py's: logits and loss 1e-5
absolute and relative; gradients 1e-5 of each leaf's largest |gradient|
(at least 1e-3).
"""
import collections
import contextlib
import functools
import io
import re

import jax
from jax.ad_checkpoint import print_saved_residuals
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

import repro.configs as JC
import repro_torch.configs as TC
from repro.launch import steps as JST
from repro.models import model as JMDL
from repro_torch.kernels import ops
from repro_torch.launch import steps as ST
from repro_torch.models import model as MDL
from repro_torch.models.config import ShapeSpec
from repro_torch.models.params import train_state_from_jax
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import optim as OPT
from repro_torch.training.data import DataConfig, synthetic_batch
from torch_cases import one_torch_thread  # noqa: F401

ARCHS = ["olmo-1b", "paligemma-3b", "hubert-xlarge", "qwen3-moe-30b-a3b",
         "falcon-mamba-7b", "hymba-1.5b"]
#: the port's remat settings by name ("off": remat=False)
POLICIES = {"off": dict(remat=False), "nothing": dict(remat_policy="nothing"),
            "dots": dict(remat_policy="dots")}
B, S = 4, 16          # paligemma's smoke config: 8 image tokens + 8 text
TOL = dict(atol=1e-5, rtol=1e-5)
#: the port's "dots" policy (the accounting test wraps it)
SAVE_DOTS = MDL._save_dots


def cfgs(arch, **kw):
    kw = dict(compute_dtype="float32", **kw)
    return (JC.get_smoke_config(arch).replace(**kw),
            TC.get_smoke_config(arch).replace(**kw))


@functools.lru_cache(maxsize=None)
def jax_state(arch, **kw):
    return jax.tree.map(np.asarray, JST.init_train_state(
        cfgs(arch, **kw)[0], jax.random.PRNGKey(0)))


def port_state(arch, **kw):
    return train_state_from_jax(cfgs(arch, **kw)[1], jax_state(arch, **kw),
                                "cpu")


def batch_np(arch, step):
    return synthetic_batch(cfgs(arch)[1], DataConfig(batch=B, seq_len=S),
                           step)


def jax_kw(policy):
    return dict(remat=policy != "off",
                remat_policy="nothing" if policy == "off" else policy)


def port_grads(cfg, params, batch, **kw):
    """(logits, loss, gradients of every master leaf) of one train-mode
    forward; `kw` goes to MDL.forward."""
    leaves = OPT.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
        logits, _ = MDL.forward(cfg, params, tb, mode="train", **kw)
        loss = MDL.lm_loss(cfg, logits, tb["labels"], tb["mask"])
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return logits.detach(), loss.detach(), grads


def assert_bit_equal(a, b, what):
    (la, sa, ga), (lb, sb, gb) = a, b
    assert torch.equal(la, lb), f"{what}: logits"
    assert torch.equal(sa, sb), f"{what}: loss"
    for i, (x, y) in enumerate(zip(ga, gb)):
        assert torch.equal(x, y), f"{what}: gradient leaf {i}"


# -------------------------- forward, loss, gradients --------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_grads_equal_to_the_bit_and_match_jax(arch):
    jcfg, tcfg = cfgs(arch)
    batch = batch_np(arch, 0)
    params = port_state(arch)["params"]
    runs = {p: port_grads(tcfg, params, batch, **kw)
            for p, kw in POLICIES.items()}
    for p in ("nothing", "dots"):
        assert_bit_equal(runs[p], runs["off"], f"{arch} {p} vs off")

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    names = [n for n, _ in CKPT._flatten(params)]
    for policy in ("nothing", "dots"):
        def jloss(p):
            logits, _ = JMDL.forward(jcfg, p, jb, mode="train",
                                     **jax_kw(policy))
            return JMDL.lm_loss(jcfg, logits, jb["labels"], jb["mask"]), \
                logits
        (loss_j, logits_j), grads_j = jax.value_and_grad(
            jloss, has_aux=True)(jax.tree.map(jnp.asarray,
                                              jax_state(arch)["params"]))
        logits, loss, grads = runs[policy]
        torch.testing.assert_close(logits, torch.from_numpy(
            np.array(logits_j)), **TOL)
        torch.testing.assert_close(loss, torch.tensor(float(loss_j)), **TOL)
        gj = [np.asarray(x) for x in jax.tree.leaves(grads_j)]
        assert len(gj) == len(grads)
        for name, got, want in zip(names, grads, gj):
            scale = max(float(np.abs(want).max()), 1e-3)
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * scale,
                                       rtol=0, err_msg=f"{policy} {name}")


def test_remat_policy_names():
    """JAX's policy dict raises KeyError for an unknown name; the port
    raises ValueError, in every mode."""
    _, tcfg = cfgs("olmo-1b")
    params = port_state("olmo-1b")["params"]
    tb = {k: torch.from_numpy(np.array(v))
          for k, v in batch_np("olmo-1b", 0).items()}
    for mode in ("train", "prefill"):
        with pytest.raises(ValueError, match="remat_policy"):
            MDL.forward(tcfg, params, tb, mode=mode, remat_policy="everything")
    with pytest.raises(ValueError, match="remat_policy"):
        ST.make_train_step(tcfg, ShapeSpec("t", S, B, "train"),
                           remat_policy="dots_saveable")(port_state(
                               "olmo-1b"), batch_np("olmo-1b", 0))


def test_remat_acts_only_in_train_mode(monkeypatch):
    """The serving engine's prefill and decode calls are unchanged: no
    checkpoint is entered outside train mode, even with remat=True."""
    import torch.utils.checkpoint as TUC
    calls = []
    real = TUC.checkpoint

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(MDL, "checkpoint", spy)
    _, tcfg = cfgs("olmo-1b")
    params = port_state("olmo-1b")["params"]
    tb = {k: torch.from_numpy(np.array(v))
          for k, v in batch_np("olmo-1b", 0).items()}
    cache = MDL.init_cache(tcfg, B, 2 * S)
    with torch.no_grad():
        MDL.forward(tcfg, params, tb, mode="prefill", cache=cache)
    assert not calls
    port_grads(tcfg, params, batch_np("olmo-1b", 0))
    assert len(calls) == tcfg.num_layers


# ------------------------------ what each policy keeps --------------------------
def kept(arch, layers, policy, monkeypatch):
    """What a train-mode forward of `layers` layers keeps for its
    backward: (Counter of (shape, is a view of a master leaf) of the
    tensors autograd saves, Counter of the shapes of the products the
    "dots" policy caches).  Leaf views share the masters' storage."""
    _, tcfg = cfgs(arch)
    cfg = tcfg.replace(num_layers=layers)
    state = ST.init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    leaves = OPT.leaves(state["params"])
    masters = {p.untyped_storage().data_ptr() for p in leaves}
    saved, products = collections.Counter(), collections.Counter()

    def pack(t):
        saved[(tuple(t.shape),
               t.untyped_storage().data_ptr() in masters)] += 1
        return t

    def record(ctx, op, *args, **kwargs):
        out = SAVE_DOTS(ctx, op, *args, **kwargs)
        if out == CheckpointPolicy.MUST_SAVE:
            a, b = args[-2:]                  # mm(a, b), addmm(bias, a, b)
            products[(a.shape[0], b.shape[1])] += 1
        return out
    monkeypatch.setattr(MDL, "_save_dots", record)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in synthetic_batch(
        cfg, DataConfig(batch=B, seq_len=S), 0).items()}
    for p in leaves:
        p.requires_grad_(True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        logits, _ = MDL.forward(cfg, state["params"], tb, mode="train",
                                **POLICIES[policy])
        MDL.lm_loss(cfg, logits, tb["labels"], tb["mask"])
    return saved, products


def per_layer(run2, run4):
    """What two more layers add, halved: one layer's share."""
    out = collections.Counter(run4)
    out.subtract(run2)
    assert all(v >= 0 and v % 2 == 0 for v in out.values()), out
    return collections.Counter({k: v // 2 for k, v in out.items() if v})


def nbytes(counter, itemsize=4):
    return sum(int(np.prod(shape)) * n * itemsize
               for (shape, _), n in counter.items())


def expected_products(cfg, tokens):
    """(tokens, width) of each product with no batch dimension of one
    layer, by family: the attention's q, k, v and o projections, the
    SwiGLU MLP's gate, up and down (the GELU MLP's in and out), the
    router, the mixer's in_x, in_z, x_proj, dt_proj and out_proj."""
    m, out = cfg.d_model, collections.Counter()
    if cfg.has_attention:
        out[(tokens, cfg.padded_heads * cfg.head_dim)] += 1
        out[(tokens, cfg.num_kv_heads * cfg.head_dim)] += 2
        out[(tokens, m)] += 1
    if cfg.has_ssm:
        di = cfg.d_inner
        out[(tokens, di)] += 3
        out[(tokens, cfg.dt_rank_eff + 2 * cfg.ssm_state)] += 1
        out[(tokens, m)] += 1
    if cfg.has_moe:
        out[(tokens, cfg.num_experts)] += 1
    elif cfg.family != "ssm":
        n = 2 if cfg.mlp_act == "silu" else 1
        out[(tokens, cfg.d_ff)] += n
        out[(tokens, m)] += 1
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_saved_tensors_per_layer(arch, monkeypatch):
    """Per layer, "nothing" keeps the layer's input and views of its master
    leaves and nothing else; "dots" keeps the same through autograd plus
    exactly the outputs of its products with no batch dimension; remat off
    keeps more than both."""
    _, tcfg = cfgs(arch)
    runs = {p: [kept(arch, n, p, monkeypatch) for n in (2, 4)]
            for p in POLICIES}
    layer = {p: (per_layer(r2[0], r4[0]), per_layer(r2[1], r4[1]))
             for p, (r2, r4) in runs.items()}
    saved, products = layer["nothing"]
    acts = collections.Counter({k: n for k, n in saved.items() if not k[1]})
    views = collections.Counter({k[0]: n for k, n in saved.items() if k[1]})
    ((xshape, _), n), = acts.items()
    assert n == 1 and len(xshape) == 3 and xshape[-1] == tcfg.d_model
    layer_leaves = collections.Counter(
        tuple(v.shape[1:]) for v in port_state(arch)["params"]["layers"]
        .values())
    assert views == layer_leaves
    assert not products
    tokens = xshape[0] * xshape[1]
    saved_d, products_d = layer["dots"]
    assert saved_d == saved
    assert products_d == expected_products(tcfg, tokens)
    saved_off, products_off = layer["off"]
    assert not products_off
    kept_nothing = nbytes(acts)
    kept_dots = kept_nothing + sum(a * b * n * 4 for (a, b), n in
                                   products_d.items())
    kept_off = nbytes(collections.Counter(
        {k: n for k, n in saved_off.items() if not k[1]}))
    assert kept_off > kept_dots > kept_nothing


def jax_residual_widths(arch):
    """The per-layer residuals that print_saved_residuals lists for JAX's
    loss under "dots" at 2 layers (the scanned body's outputs with the
    layer axis first), as a set of (tokens, width)."""
    jcfg, _ = cfgs(arch)
    jcfg = jcfg.replace(num_layers=2)
    params = JST.init_train_state(jcfg, jax.random.PRNGKey(0))["params"]
    batch = {k: jnp.asarray(v) for k, v in synthetic_batch(
        jcfg, DataConfig(batch=B, seq_len=S), 0).items()}

    def loss(p):
        logits, _ = JMDL.forward(jcfg, p, batch, mode="train",
                                 remat_policy="dots")
        return JMDL.lm_loss(jcfg, logits, batch["labels"], batch["mask"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        print_saved_residuals(loss, params)
    widths = set()
    for m in re.finditer(r"^\w+\[([\d,]+)\] output of scan", out.getvalue(),
                         re.M):
        dims = [int(d) for d in m.group(1).split(",")]
        if dims[0] != 2:                       # the final carry
            continue
        rest = dims[1:]
        lead = 2 if len(rest) > 2 and rest[0] == B else 1
        widths.add((int(np.prod(rest[:lead])),
                    int(np.prod(rest[lead:]))))
    return widths


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_keeps_the_shapes_jax_lists(arch, monkeypatch):
    """The (tokens, width) shapes "dots" keeps per layer -- the layer's
    input and its products' outputs -- are those of the residuals JAX's
    ``print_saved_residuals`` lists for the scanned body under
    ``dots_with_no_batch_dims_saveable``.  As sets: JAX lists a product
    that feeds only the residual sum (the MLP's down, the ssm mixer's out)
    not at all, and v twice (the attention's pad of it); the port's cache
    holds each product once."""
    r2, r4 = (kept(arch, n, "dots", monkeypatch) for n in (2, 4))
    saved, products = per_layer(r2[0], r4[0]), per_layer(r2[1], r4[1])
    (xshape, _), = [k for k in saved if not k[1]]
    mine = {(xshape[0] * xshape[1], xshape[2])} | set(products)
    assert mine == jax_residual_widths(arch)


# --------------------------- MoE routing under recompute ------------------------
def test_moe_recompute_routes_the_same_rows():
    """qwen3-moe at capacity factor 0.5: choices are dropped, so a group's
    rows stop short of T * K and rows past the groups' sum are padding.
    Under "nothing" and "dots" each grouped matmul of the backward's
    recompute sees the same group_sizes as the forward's, and the
    gradients equal remat off's to the bit."""
    arch = "qwen3-moe-30b-a3b"
    _, tcfg = cfgs(arch, capacity_factor=0.5)
    params = port_state(arch, capacity_factor=0.5)["params"]
    batch = batch_np(arch, 0)
    tokens = B * S
    runs, sizes = {}, {}
    for policy, kw in POLICIES.items():
        log = []

        def gmm_fn(x, w, gs, log=log):
            log.append(gs.clone())
            return ops.gmm(x, w, gs)
        runs[policy] = port_grads(tcfg, params, batch, gmm_fn=gmm_fn, **kw)
        sizes[policy] = log
    per_layer_calls = 3 * tcfg.num_layers
    assert len(sizes["off"]) == per_layer_calls
    fwd = sizes["off"]
    assert all(int(gs.sum()) < tokens * tcfg.top_k for gs in fwd)
    for policy in ("nothing", "dots"):
        got = sizes[policy]
        # the forward's calls, then each layer's again in the backward
        # (the last layer's first)
        assert len(got) == 2 * per_layer_calls
        for a, b in zip(got[:per_layer_calls], fwd):
            assert torch.equal(a, b)
        recomputed = [got[per_layer_calls + 3 * i: per_layer_calls + 3 * i + 3]
                      for i in range(tcfg.num_layers)][::-1]
        for i, calls in enumerate(recomputed):
            for a, b in zip(calls, fwd[3 * i: 3 * i + 3]):
                assert torch.equal(a, b), (policy, i)
        assert_bit_equal(runs[policy], runs["off"], f"{arch} {policy}")
