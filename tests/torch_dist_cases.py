"""The rank side of tests/test_torch_distributed.py: configs, seeded batches
and the functions that ``launch.dist.run_ranks`` runs in each spawned rank
(gloo on the CPU).  Imports no jax, so the ranks start quickly; the JAX
reference (``jax_reference``) imports it inside, in its own process."""
import numpy as np
import torch

import repro_torch.configs as TC
from repro_torch.launch import dist as D
from repro_torch.launch import mesh as MS
from repro_torch.launch import steps as ST
from repro_torch.models.config import ShapeSpec
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import optim as OPT
from repro_torch.training.data import DataConfig, synthetic_batch

B, S = 8, 16
#: warm-up 0: the first step moves the weights by ~lr
OPT_KW = dict(lr=1e-3, warmup_steps=0, total_steps=10)
MICRO = (1, 2)
MESHES = {"2x2": {"data": 2, "model": 2},
          "pod2x2x1": {"pod": 2, "data": 2, "model": 1}}
#: the smoke configs, widened where a rule branch needs it (the smoke
#: configs have 4-5 heads and 8 experts, which take no sharded branch)
CASES = {
    # 16 heads on 4 kv heads with q/k/v biases: heads over `model`
    "dense_heads": ("qwen2-7b", dict(num_heads=16, num_kv_heads=4,
                                     head_dim=8)),
    # 48 heads on 3 kv heads: a rank's 24 query heads straddle GQA groups
    # of 16, so it reads one kv head a query head
    "dense_heads_straddle": ("qwen2-7b", dict(num_heads=48, num_kv_heads=3,
                                              head_dim=8)),
    # 4 heads (attention replicated over `model`), tied embeddings
    "dense_replicated": ("olmo-1b", {}),
    # 16 experts: expert parallelism; 16 heads on 1 kv head: a rank's
    # heads inside one GQA group
    "moe_ep": ("qwen3-moe-30b-a3b", dict(num_experts=16, num_heads=16,
                                         num_kv_heads=1, head_dim=8)),
    # 8 experts: per-expert d_ff over `model`
    "moe_tp": ("qwen3-moe-30b-a3b", {}),
    "ssm": ("falcon-mamba-7b", {}),          # d_inner 128
    "hybrid": ("hymba-1.5b", {}),            # d_inner 128, 5 heads
    # the hybrid with its heads over `model` beside the mixer's channels
    "hybrid_heads": ("hymba-1.5b", dict(num_heads=16, num_kv_heads=4)),
    "vlm": ("paligemma-3b", {}),
    "encoder": ("hubert-xlarge", {}),
}
#: the cases also held against JAX's own sharded step
JAX_CASES = ("dense_heads", "moe_ep", "ssm")
#: the elastic-restore case
ELASTIC = "dense_heads"


def cfg_of(case: str):
    arch, kw = CASES[case]
    return TC.get_smoke_config(arch).replace(compute_dtype="float32", **kw)


def shape_of() -> ShapeSpec:
    return ShapeSpec("t", S, B, "train")


def batch(case: str, step: int) -> dict:
    return synthetic_batch(cfg_of(case), DataConfig(batch=B, seq_len=S),
                           step)


def uneven_batch(case: str) -> dict:
    """Batch 0 with most of the first data rank's rows masked out: the
    data ranks' mask counts differ."""
    b = batch(case, 0)
    b["mask"] = b["mask"].copy()
    b["mask"][:B // 2 - 1] = 0.0
    b["mask"][B // 2 - 1, 3:] = 0.0
    return b


def opt_cfg():
    return OPT.AdamWConfig(**OPT_KW)


def like(case: str):
    return ST.train_state_specs(cfg_of(case))


def numpy_state(state) -> dict:
    return {n: (v if isinstance(v, int) else v.detach().cpu().numpy())
            for n, v in CKPT._flatten(state)}


def step_once(cfg, state, mesh, num_micro, b):
    fn = ST.make_train_step(cfg, shape_of(), num_micro=num_micro,
                            opt_cfg=opt_cfg(), mesh=mesh)
    state, m = fn(state, b)
    return state, {k: float(v) for k, v in m.items()}


def _full(cfg, state, mesh, rank):
    full = ST.gather_train_state(cfg, state, mesh)
    return numpy_state(full) if rank == 0 else None


# ------------------------------ rank functions --------------------------------
def parity_ranks(rank, world, ckpt_root, out_root):
    """Every case on both 4-rank meshes, num_micro 1 and 2, from the
    JAX-written initial checkpoint; then the global-norm and uneven-mask
    checks and the elastic run.  Rank 0 returns the gathered states."""
    out = {"steps": {}, "bytes": {}}
    meshes = {k: D.Mesh(v, device_type="cpu") for k, v in MESHES.items()}
    for mk, mesh in meshes.items():
        for case in CASES:
            cfg = cfg_of(case)
            for nm in MICRO:
                state = CKPT.restore(f"{ckpt_root}/{case}", 0, like(case),
                                     shardings=ST.train_state_shardings(
                                         cfg, mesh))
                mesh.bytes.clear()
                state, m = step_once(cfg, state, mesh, nm, batch(case, 0))
                out["bytes"][(mk, case, nm)] = dict(mesh.bytes)
                out["steps"][(mk, case, nm)] = (m, _full(cfg, state, mesh,
                                                         rank))
    mesh = meshes["2x2"]
    out["norm"] = norm_check(mesh)
    case = "dense_heads"
    cfg = cfg_of(case)
    state = CKPT.restore(f"{ckpt_root}/{case}", 0, like(case),
                         shardings=ST.train_state_shardings(cfg, mesh))
    _, m = step_once(cfg, state, mesh, 1, uneven_batch(case))
    out["uneven"] = m
    out["elastic"] = elastic(rank, mesh, ckpt_root, out_root)
    return out


def norm_check(mesh):
    """``global_norm`` of a gradient tree's shards against the norm of the
    full tree, and the norm that sums every rank's squares (which counts a
    replicated leaf once a rank)."""
    cfg = cfg_of("dense_heads")
    specs = MS.param_pspecs(cfg, mesh)
    g = torch.Generator().manual_seed(7)
    full = OPT.map_tree(lambda s: torch.randn(s[0], generator=g),
                        ST.train_state_specs(cfg)["params"])
    flat_local = [mesh.local(t, s) for t, s in zip(OPT.leaves(full),
                                                   OPT.leaves(specs))]
    local = ST._like_tree(full, flat_local)
    naive = torch.stack([torch.sum(t * t) for t in flat_local]).sum()
    naive = mesh.all_reduce_(naive, ("data", "model"))
    # each leaf counted once per rank that holds a copy of it
    world = mesh.size(("data", "model"))
    copies = torch.stack([
        torch.sum(t * t) * world / mesh.size(tuple(
            a for a in mesh.axis_names
            if any(a in mesh.axes(e) for e in spec)))
        for t, spec in zip(OPT.leaves(full), OPT.leaves(specs))]).sum()
    return {"mesh": float(OPT.global_norm(local, specs, mesh)),
            "one_device": float(OPT.global_norm(full)),
            "every_rank": float(torch.sqrt(naive)),
            "every_copy": float(torch.sqrt(copies))}


def elastic(rank, mesh, ckpt_root, out_root):
    """Step 0 on 2 x 2, a sharded save, step 1 (the uninterrupted run); then
    the saved state restored onto a 4 x 1 mesh and stepped again."""
    case = ELASTIC
    cfg = cfg_of(case)
    state = CKPT.restore(f"{ckpt_root}/{case}", 0, like(case),
                         shardings=ST.train_state_shardings(cfg, mesh))
    state, _ = step_once(cfg, state, mesh, 1, batch(case, 0))
    CKPT.save(f"{out_root}/elastic", 1, state,
              shardings=ST.train_state_shardings(cfg, mesh))
    state, m_a = step_once(cfg, state, mesh, 1, batch(case, 1))
    a = _full(cfg, state, mesh, rank)
    wide = D.Mesh({"data": 4, "model": 1}, device_type="cpu")
    state = CKPT.restore(f"{out_root}/elastic", 1, like(case),
                         shardings=ST.train_state_shardings(cfg, wide))
    state, m_b = step_once(cfg, state, wide, 1, batch(case, 1))
    return {"uninterrupted": (m_a, a),
            "restored_4x1": (m_b, _full(cfg, state, wide, rank))}


def one_by_one_ranks(rank, world, ckpt_root):
    """Every case on a 1 x 1 mesh: the step and the one-device step from the
    same state, states compared to the bit here."""
    mesh = D.Mesh({"data": 1, "model": 1}, device_type="cpu")
    out = {}
    for case in CASES:
        cfg = cfg_of(case)
        for nm in MICRO:
            a = CKPT.restore(f"{ckpt_root}/{case}", 0, like(case),
                             shardings=ST.train_state_shardings(cfg, mesh))
            b = CKPT.restore(f"{ckpt_root}/{case}", 0, like(case))
            a, ma = step_once(cfg, a, mesh, nm, batch(case, 0))
            b, mb = step_once(cfg, b, None, nm, batch(case, 0))
            out[(case, nm)] = (ST.state_equal(a, b), ma, mb,
                               sum(mesh.bytes.values()))
    return out


def cpu_entry_ranks(rank, world, device_type):
    """A 1 x 1 mesh of `device_type`, a sharded state and one step on it:
    (the state's device type, its step)."""
    mesh = D.Mesh({"data": 1, "model": 1}, device_type=device_type)
    cfg = cfg_of("dense_heads")
    state = ST.init_train_state(cfg, torch.Generator().manual_seed(0),
                                mesh=mesh)
    state, _ = step_once(cfg, state, mesh, 1, batch("dense_heads", 0))
    return OPT.leaves(state["params"])[0].device.type, state["step"]


def failing_ranks(rank, world):
    """Rank 1 raises; the others wait in a collective it never joins."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    t = torch.ones(1)
    torch.distributed.all_reduce(t)
    return float(t)


def stuck_failing_ranks(rank, world):
    """As failing_ranks, but rank 1's process then takes two minutes to
    exit, as an NCCL rank may whose teardown waits on its peers."""
    if rank == 1:
        import atexit
        import time
        atexit.register(time.sleep, 120)
    return failing_ranks(rank, world)


def sleeping_ranks(rank, world):
    import time
    time.sleep(600)


# ------------------------------ JAX's own step --------------------------------
def jax_reference(ckpt_root: str, out_path: str) -> None:
    """JAX's sharded train step (``repro.launch.steps.make_train_step`` on
    a (data 2, model 2) mesh of 4 host devices) for each of JAX_CASES and
    num_micro 1 and 2, from the same checkpoint and batch; the metrics and
    states go to `out_path` (npz).  Run in a process whose XLA_FLAGS give
    the host 4 devices."""
    import jax
    import jax.numpy as jnp

    import repro.configs as JC
    from repro.launch import steps as JST
    from repro.models.config import ShapeSpec as JShape
    from repro.training import checkpoint as JCKPT
    from repro.training import optim as JOPT
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    for case in JAX_CASES:
        arch, kw = CASES[case]
        jcfg = JC.get_smoke_config(arch).replace(compute_dtype="float32",
                                                 **kw)
        for nm in MICRO:
            fn, (specs, _) = JST.make_train_step(
                jcfg, mesh, JShape("t", S, B, "train"), num_micro=nm,
                donate=False, opt_cfg=JOPT.AdamWConfig(**OPT_KW))
            state = JCKPT.restore(f"{ckpt_root}/{case}", 0, specs)
            b = {k: jnp.asarray(v) for k, v in batch(case, 0).items()}
            state, m = fn(state, b)
            for path, v in jax.tree_util.tree_flatten_with_path(state)[0]:
                out[f"{case}|{nm}|{jax.tree_util.keystr(path)}"] = \
                    np.asarray(v)
            for k, v in m.items():
                out[f"{case}|{nm}|metric|{k}"] = np.asarray(v)
    np.savez(out_path, **out)
