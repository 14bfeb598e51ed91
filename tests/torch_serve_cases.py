"""The rank side of tests/test_torch_serve_mesh.py: configs, seeded weights
and batches, and the functions that ``launch.dist.run_ranks`` runs in each
spawned rank (gloo on the CPU).  Imports no jax, so the ranks start
quickly; the JAX reference (``jax_reference``) imports it inside, in its
own process.

Every rank draws the same weights from a seeded torch generator, keeps its
shards (``mesh.shard_tree``) and returns the outputs of its steps gathered
whole (``mesh.full`` / ``mesh.gather_tree``); rank 0's are compared with
the one-device step in the test process."""
import numpy as np
import torch

import repro_torch.configs as TC
from repro_torch.configs import common as CC
from repro_torch.launch import dist as D
from repro_torch.launch import mesh as MS
from repro_torch.launch import steps as ST
from repro_torch.models import model as MDL
from repro_torch.models import moe as MOE
from repro_torch.models import params as PRM
from repro_torch.models.config import ShapeSpec

#: batch, prompt length, and the decode steps' cache depth (the lc split
#: needs a length that divides 16; mixtral's smoke window makes it 16)
B, S, LC = 4, 16, 32
DECODE_STEPS = 3
#: batches that do not split over the data axes (JAX's layout: every data
#: rank holds every row, the cache's slots split over the data axes) and
#: their prompt length, past the windowed configs' 16-slot ring so that it
#: wraps
UNSPLIT = (1, 3)
S_UNSPLIT = 24
MESHES = {"2x2": {"data": 2, "model": 2},
          "pod2x2x1": {"pod": 2, "data": 2, "model": 1}}
#: the sequence-parallel prefill on (data 1, model 4) at a prompt of
#: S_SEQ: the VLM's 4 image embeddings and 4 text tokens, so that each rank
#: holds 2 positions and the image prefix spans ranks 0 and 1
SEQ_MESH = {"1x4": {"data": 1, "model": 4}}
S_SEQ = 8
SEQ_CASES = ("vlm", "encoder")
#: joined lengths that do not split over `model` 2: the sequence-parallel
#: prefill refuses them (ValueError)
UNEVEN = (("vlm", 15), ("vlm", 17), ("encoder", 15))
#: the smoke configs in float32, widened where a rule branch needs it
CASES = {
    # 16 heads over `model`, 4 kv heads replicated, q/k/v biases, hd 16
    "dense_heads": ("qwen2-7b", dict(num_heads=16, num_kv_heads=4,
                                     head_dim=16)),
    # 16 kv heads: the kv mode's cache splits its kv heads over `model`
    "dense_kv16": ("olmo-1b", dict(num_heads=16, num_kv_heads=16)),
    # 16 experts over `model` (EP), 16 heads on 1 kv head
    "moe_ep": ("qwen3-moe-30b-a3b", dict(num_experts=16, num_heads=16,
                                         num_kv_heads=1)),
    # mixtral: per-expert d_ff over `model` (TP), sliding window 16
    "moe_tp": ("mixtral-8x22b", {}),
    "ssm": ("falcon-mamba-7b", {}),        # d_inner 128 over `model`
    "hybrid": ("hymba-1.5b", {}),          # hd 8: its hd mode is "heads"
    "vlm": ("paligemma-3b", {}),           # 4 image tokens, tied head
    "encoder": ("hubert-xlarge", {}),      # prefill only
}
#: the prefill variants (banded: the sliding-window config only)
PREFILL = {"default": {}, "no_fsdp": dict(fsdp=False),
           "seq_parallel": dict(seq_parallel=True), "banded": dict(banded=True)}
DECODE = {"hd": {}, "lc_per_row": dict(cache_shard_mode="lc",
                                       per_row_write=True),
          "kv": dict(cache_shard_mode="kv"),
          "resident": dict(resident_weights=True)}
#: the variants held against JAX's own sharded steps on (data 2, model 2),
#: at batch B and at batch 1 (``UNSPLIT_JAX_*``)
JAX_PREFILL = (("dense_heads", "seq_parallel"), ("moe_tp", "seq_parallel"),
               ("vlm", "seq_parallel"), ("encoder", "seq_parallel"))
JAX_DECODE = (("dense_heads", "hd"), ("dense_kv16", "lc_per_row"),
              ("moe_tp", "hd"))
UNSPLIT_JAX_PREFILL = (("dense_heads", "default"),)
UNSPLIT_JAX_DECODE = (("dense_heads", "hd"), ("moe_tp", "lc_per_row"),
                      ("hybrid", "hd"))


def cfg_of(case: str):
    arch, kw = CASES[case]
    return TC.get_smoke_config(arch).replace(compute_dtype="float32", **kw)


def prefill_variants(case: str):
    cfg = cfg_of(case)
    return [k for k in PREFILL
            if not (k == "banded" and not cfg.sliding_window)]


def decode_variants(case: str):
    return list(DECODE) if cfg_of(case).supports_decode else []


def params(case: str):
    cfg = cfg_of(case)
    return PRM.init_params(cfg, torch.Generator().manual_seed(
        sorted(CASES).index(case)), "cpu")


def prefill_batch(case: str, b: int = B, s: int = S) -> dict:
    cfg = cfg_of(case)
    rng = np.random.default_rng(1)
    out = {}
    for k, (shape, dt) in CC.prefill_batch_specs(cfg, b, s).items():
        if k == "tokens":
            out[k] = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        elif k == "positions":
            out[k] = np.broadcast_to(np.arange(shape[1], dtype=np.int32),
                                     shape).copy()
        else:
            out[k] = rng.standard_normal(shape).astype(np.float32)
    return out


def decode_batch(case: str, step: int, b: int = B, s: int = S) -> dict:
    cfg = cfg_of(case)
    rng = np.random.default_rng(100 + step)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32),
            "positions": np.full((b, 1), s + step, np.int32)}


def shape(kind: str, b: int = B, s: int = S) -> ShapeSpec:
    return ShapeSpec(kind, s if kind == "prefill" else LC, b, kind)


def groups(case: str, data_shards: int, tokens: int) -> int:
    """The capacity groups a mesh step picks (the one-device reference
    must route the same)."""
    return MOE.pick_num_groups(tokens, data_shards) \
        if cfg_of(case).has_moe else 1


def one_device(case: str, data_shards: int, b: int = B, s: int = S,
               prefills=None, decodes=None) -> dict:
    """The one-device prefill (logits, cache) of the mesh's capacity
    groups (the `prefills` variants' keys, every prefill variant's by
    default: they are the same step on one device), and from its cache
    each decode variant's (of `decodes`, every one by default)
    DECODE_STEPS steps (stacked logits, final cache), at batch `b` of `s`
    prompt tokens."""
    cfg = cfg_of(case)
    p = params(case)
    with_cache = cfg.supports_decode

    def prefill():
        pb = {k: torch.from_numpy(v)
              for k, v in prefill_batch(case, b, s).items()}
        cache = MDL.init_cache(cfg, b, LC) if with_cache else None
        with torch.no_grad():
            logits, cache = MDL.forward(
                cfg, p, pb, "prefill" if with_cache else "train", cache,
                remat=False, last_only=with_cache,
                num_groups=groups(case, data_shards, b * s))
        return logits[:, -1], cache

    out = {("prefill", k): prefill()
           for k in prefills or prefill_variants(case)}
    for k in decode_variants(case) if decodes is None else decodes:
        _, cache = prefill()
        if DECODE[k].get("per_row_write"):
            cache["row_idx"] = torch.full((b,), s, dtype=torch.int32)
        logits = []
        for st in range(DECODE_STEPS):
            db = {n: torch.from_numpy(v) for n, v in
                  decode_batch(case, st, b, s).items()}
            with torch.no_grad():
                lg, cache = MDL.forward(
                    cfg, p, db, "decode", cache, remat=False,
                    num_groups=groups(case, data_shards, b))
            logits.append(lg)
        out[("decode", k)] = (torch.stack(logits), cache)
    return out


def mesh_runs(case: str, mesh, b: int = B, s: int = S,
              prefills=None, decodes=None) -> dict:
    """Every variant of `case` on `mesh` at batch `b` of `s` prompt tokens
    (of the prefill and decode variants, `prefills` and `decodes`, every
    one by default), gathered
    whole: the prefill variants' (logits, cache), and each decode variant's
    (stacked logits, final cache, the collective bytes of its steps) from
    the default mesh prefill's cache resharded into the decode layout."""
    cfg = cfg_of(case)
    p = params(case)
    out = {}
    for k in prefills or prefill_variants(case):
        step, _ = ST.make_prefill_step(cfg, mesh, shape("prefill", b, s),
                                       cache_len=LC, **PREFILL[k])
        logits, cache = step(MS.shard_tree(mesh, p, step.param_pspecs),
                             prefill_batch(case, b, s))
        out[("prefill", k)] = (
            mesh.full(logits, step.logits_pspec),
            None if cache is None else
            MS.gather_tree(mesh, cache, step.cache_pspecs))
    for k in decode_variants(case) if decodes is None else decodes:
        pre, _ = ST.make_prefill_step(cfg, mesh, shape("prefill", b, s),
                                      cache_len=LC)
        _, cache = pre(MS.shard_tree(mesh, p, pre.param_pspecs),
                       prefill_batch(case, b, s))
        step, _ = ST.make_decode_step(cfg, mesh, shape("decode", b),
                                      **DECODE[k])
        cache = ST.reshard_cache(mesh, cache, pre.cache_pspecs,
                                 step.cache_pspecs)
        local = MS.shard_tree(mesh, p, step.param_pspecs)
        mesh.bytes.clear()
        logits = []
        for st in range(DECODE_STEPS):
            lg, cache = step(local, decode_batch(case, st, b, s), cache)
            logits.append(mesh.full(lg, step.logits_pspec))
        moved = dict(mesh.bytes)
        out[("decode", k)] = (torch.stack(logits),
                              MS.gather_tree(mesh, cache, step.cache_pspecs),
                              moved)
    return out


def unsplit_cases():
    """The families that decode (an unsplit batch matters to the cache)."""
    return [c for c in CASES if cfg_of(c).supports_decode]


# ------------------------------ rank functions --------------------------------
def serve_ranks(rank, world):
    """Every case on both 4-rank meshes, then the sequence-parallel
    prefill of SEQ_CASES on SEQ_MESH at S_SEQ; rank 0 returns the
    results."""
    out = {}
    for mk, shp in MESHES.items():
        mesh = D.Mesh(shp, device_type="cpu")
        for case in CASES:
            for key, val in mesh_runs(case, mesh).items():
                out[(mk, case) + key] = val
    for mk, shp in SEQ_MESH.items():
        mesh = D.Mesh(shp, device_type="cpu")
        for case in SEQ_CASES:
            for key, val in mesh_runs(case, mesh, B, S_SEQ, ["seq_parallel"],
                                      []).items():
                out[(mk, case) + key] = val
    return out if rank == 0 else None


def unsplit_ranks(rank, world):
    """Every family that decodes at the UNSPLIT batches on both 4-rank
    meshes; rank 0 returns the results, keyed (mesh, case, batch, kind,
    variant)."""
    out = {}
    for mk, shp in MESHES.items():
        mesh = D.Mesh(shp, device_type="cpu")
        for case in unsplit_cases():
            for b in UNSPLIT:
                for key, val in mesh_runs(case, mesh, b, S_UNSPLIT,
                                          ["default"]).items():
                    out[(mk, case, b) + key] = val
    return out if rank == 0 else None


def one_by_one_ranks(rank, world):
    """Every case on a 1 x 1 mesh against the one-device builders (the
    same groups: one data shard), compared to the bit here: {(case, kind,
    variant): (equal, collective bytes)}."""
    mesh = D.Mesh({"data": 1, "model": 1}, device_type="cpu")
    out = {}
    for case in CASES:
        cfg = cfg_of(case)
        p = params(case)
        ref = one_device(case, 1)
        got = mesh_runs(case, mesh)
        for key, want in ref.items():
            g = got[key]
            same = torch.equal(g[0], want[0]) and (
                want[1] is None or all(
                    torch.equal(g[1][n], want[1][n]) if
                    isinstance(want[1][n], torch.Tensor)
                    else g[1][n] == want[1][n] for n in want[1]))
            out[(case,) + key] = (same, sum(mesh.bytes.values()))
        # and the one-device builders themselves on the same inputs
        step, _ = ST.make_prefill_step(cfg, None, shape("prefill"),
                                       cache_len=LC, device="cpu")
        logits, _ = step(p, prefill_batch(case))
        out[(case, "builder")] = (torch.equal(
            logits, ref[("prefill", "default")][0]), 0)
    return out


def refusing_ranks(rank, world):
    """The refusals a mesh step makes, as (variant, (exception type name,
    message)) pairs (None where the step was built): ``calibrate=True`` on
    (data 2, model 1), and on (data 1, model 2) the sequence-parallel
    prefill of each UNEVEN joined length."""
    builds = [("calibrate", {"data": 2, "model": 1},
               lambda mesh: ST.make_prefill_step(
                   cfg_of("dense_heads"), mesh, shape("prefill"),
                   calibrate=True))]
    for case, s in UNEVEN:
        builds.append((f"uneven {case} {s}", {"data": 1, "model": 2},
                       lambda mesh, case=case, s=s: ST.make_prefill_step(
                           cfg_of(case), mesh, shape("prefill", B, s),
                           seq_parallel=True)))
    meshes, out = {}, []
    for what, shp, build in builds:
        key = tuple(shp.items())
        if key not in meshes:
            meshes[key] = D.Mesh(shp, device_type="cpu")
        try:
            build(meshes[key])
            out.append((what, None))
        except (ValueError, NotImplementedError) as e:
            out.append((what, (type(e).__name__, str(e))))
    return out


# ------------------------------ JAX's own steps -------------------------------
def jax_reference(out_path: str) -> None:
    """JAX's sharded steps (``repro.launch.steps.make_prefill_step`` /
    ``make_decode_step`` on a (data 2, model 2) mesh of 4 host devices) for
    JAX_PREFILL and JAX_DECODE, on the same weights and batches; logits and
    caches to `out_path` (npz; the encoder's logits alone: its step returns
    no cache).  The decode runs from JAX's default sharded
    prefill.  Run in a process whose XLA_FLAGS give the host 4 devices."""
    import jax
    import jax.numpy as jnp

    import repro.configs as JC
    from repro.launch import steps as JST
    from repro.models.config import ShapeSpec as JShape
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}

    def jcfg_of(case):
        arch, kw = CASES[case]
        return JC.get_smoke_config(arch).replace(compute_dtype="float32",
                                                 **kw)

    def jparams(case):
        return jax.tree.map(lambda t: jnp.asarray(t.numpy()), params(case))

    def put(prefix, tree):
        for k, v in tree.items():
            out[f"{prefix}|{k}"] = np.asarray(v)

    for case, k in JAX_PREFILL:
        fn, _ = JST.make_prefill_step(jcfg_of(case), mesh,
                                      JShape("p", S, B, "prefill"),
                                      cache_len=LC, **PREFILL[k])
        logits, cache = fn(jparams(case), {n: jnp.asarray(v) for n, v in
                                           prefill_batch(case).items()})
        put(f"{case}|prefill|{k}", dict(cache or {}, logits=logits))
    for case, k in JAX_DECODE:
        jcfg = jcfg_of(case)
        pre, _ = JST.make_prefill_step(jcfg, mesh, JShape("p", S, B,
                                                          "prefill"),
                                       cache_len=LC)
        jp = jparams(case)
        _, cache = pre(jp, {n: jnp.asarray(v) for n, v in
                            prefill_batch(case).items()})
        cache = jax.tree.map(np.asarray, cache)
        if DECODE[k].get("per_row_write"):
            cache["row_idx"] = np.full((B,), S, np.int32)
        fn, _ = JST.make_decode_step(jcfg, mesh, JShape("d", LC, B, "decode"),
                                     donate_cache=False, **DECODE[k])
        logits = []
        for st in range(DECODE_STEPS):
            lg, cache = fn(jp, {n: jnp.asarray(v) for n, v in
                                decode_batch(case, st).items()}, cache)
            logits.append(np.asarray(lg))
        put(f"{case}|decode|{k}", dict(cache, logits=np.stack(logits)))
    out.update(_jax_unsplit(mesh, jcfg_of, jparams))
    np.savez(out_path, **out)


def _jax_unsplit(mesh, jcfg_of, jparams) -> dict:
    """JAX's sharded steps at batch 1 (S_UNSPLIT prompt tokens): the
    default prefill of UNSPLIT_JAX_PREFILL and, from it, the decode steps
    of UNSPLIT_JAX_DECODE; keys "b1|case|kind|variant|name".  Two of JAX's
    own rules refuse this batch, and the reference steps round them as the
    port does:
      * its prefill step names the data axes for the logits' rows
        (``P(da, "model")``), which one row does not divide: its step
        function is jitted again with the decode step's rule for the
        logits, ``P(None, "model")``, and its own parameter, batch and cache
        shardings;
      * its lc rule nests the data tuple, (("data",), "model"), which a
        PartitionSpec refuses: its rules make their specs flattened, as the
        port's ``cache_pspecs`` does (``repro.launch.mesh.P`` swapped for
        this process's run of them)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from repro.launch import mesh as JMS
    from repro.launch import steps as JST
    from repro.models.config import ShapeSpec as JShape
    b, s = 1, S_UNSPLIT
    out = {}

    def flat(e):
        if not isinstance(e, tuple):
            return e
        names = tuple(a for x in e for a in (x if isinstance(x, tuple)
                                             else (x,)))
        return names[0] if len(names) == 1 else names

    def flat_spec(*entries):
        return JP(*(flat(e) for e in entries))

    def prefill(case):
        jcfg = jcfg_of(case)
        fn, (pspecs, bspecs) = JST.make_prefill_step(
            jcfg, mesh, JShape("p", s, b, "prefill"), cache_len=LC)
        batch = {n: jnp.asarray(v) for n, v in
                 prefill_batch(case, b, s).items()}
        try:
            fn(jparams(case), batch)
            raise AssertionError("JAX's prefill step took a batch of 1")
        except ValueError:
            pass
        step = jax.jit(fn.__wrapped__, in_shardings=(
            JST._named(mesh, JMS.param_pspecs(jcfg, mesh, fsdp=True)),
            JST._named(mesh, JMS.batch_pspecs(jcfg, mesh, bspecs))),
            out_shardings=(NamedSharding(mesh, JP(None, "model")),
                           JST._named(mesh, JMS.cache_pspecs(
                               jcfg, mesh, JM.cache_specs(jcfg, b, LC)))))
        return step(jparams(case), batch)

    from repro.models import model as JM
    JMS.P = flat_spec               # the spec maker of JAX's rules
    try:
        for case, k in UNSPLIT_JAX_PREFILL:
            logits, cache = prefill(case)
            for n, v in dict(cache, logits=logits).items():
                out[f"b1|{case}|prefill|{k}|{n}"] = np.asarray(v)
        for case, k in UNSPLIT_JAX_DECODE:
            jcfg = jcfg_of(case)
            _, cache = prefill(case)
            cache = jax.tree.map(np.asarray, cache)
            if DECODE[k].get("per_row_write"):
                cache["row_idx"] = np.full((b,), s, np.int32)
            fn, _ = JST.make_decode_step(jcfg, mesh,
                                         JShape("d", LC, b, "decode"),
                                         donate_cache=False, **DECODE[k])
            jp = jparams(case)
            logits = []
            for st in range(DECODE_STEPS):
                lg, cache = fn(jp, {n: jnp.asarray(v) for n, v in
                                    decode_batch(case, st, b, s).items()},
                               cache)
                logits.append(np.asarray(lg))
            for n, v in dict(cache, logits=np.stack(logits)).items():
                out[f"b1|{case}|decode|{k}|{n}"] = np.asarray(v)
    finally:
        JMS.P = JP
    return out
