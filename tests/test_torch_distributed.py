"""The sharded train step of repro_torch on meshes of spawned ranks (gloo on
the CPU), against the port's one-device step and JAX's own sharded step:

* every family (tests/torch_dist_cases.py's CASES: heads over `model`,
  replicated attention, expert-parallel and tensor-parallel MoE, ssm and
  hybrid with d_inner over `model`, VLM, encoder) on (data 2, model 2) and
  (pod 2, data 2, model 1), one step with num_micro 1 and 2 (the MoE
  micro-batches in one capacity group a data rank), from a checkpoint the
  JAX package wrote, against the one-device step on the same state and
  capacity groups;
* on a 1 x 1 mesh, equal to the bit to the one-device step;
* dense heads-TP, EP MoE and ssm against ``repro.launch.steps.
  make_train_step`` on a (2, 2) mesh of 4 host devices, in a subprocess
  whose XLA_FLAGS alone give it 4 devices;
* the global gradient norm with replicated leaves, the loss with an uneven
  mask across data ranks, and a capacity-group count that would span two
  data ranks (refused);
* elastic restore: a state saved on 2 x 2 (sharded save, the JAX format)
  continues on a 4 x 1 mesh and on one device as the uninterrupted run
  does, and ``repro.training.checkpoint.restore`` reads it;
* a rank that raises fails the run at once, and a run that outlives its
  limit fails: no test waits for the suite's clock.

The ranks run in the background while this process computes the
one-device references and a subprocess JAX's steps.

Tolerances (float32, sums in another order): loss and gradient norm 1e-5
relative; moments 2e-5 of each leaf's largest |moment|, and parameters
within 1 % of one step's size (lr) of the reference, as in
tests/test_torch_training.py.  Where an element's step m / (sqrt(v) + eps)
is ill-conditioned (sqrt(v) under 100 eps: a gradient within 1e-6 of 0,
whose step direction turns on its last bits) the parameter is held to the
bound of one step, 2 lr.
"""
import concurrent.futures
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest

import repro.configs as JC
import torch_dist_cases as T
from repro.launch import steps as JST
from repro.training import checkpoint as JCKPT
from repro_torch.launch import dist as D
from repro_torch.launch import mesh as MS
from repro_torch.launch import steps as ST
from repro_torch.models import moe as MOE
from repro_torch.models.config import ShapeSpec
from repro_torch.training import checkpoint as CKPT
from torch_cases import one_torch_thread  # noqa: F401

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
RANKS_TIMEOUT = 240.0
LR = T.OPT_KW["lr"]
EPS = 1e-8


def _groups(case, mesh_key, nm):
    """The capacity groups of the whole micro-batch on that mesh."""
    cfg = T.cfg_of(case)
    if not cfg.has_moe:
        return None
    shape = T.MESHES[mesh_key]
    return MOE.pick_num_groups(T.B // nm * T.S,
                               shape["data"] * shape.get("pod", 1))


def _one_device(ckpt, step, case, nm, b, groups):
    cfg = T.cfg_of(case)
    state = CKPT.restore(ckpt, step, T.like(case))
    fn = ST.make_train_step(cfg, T.shape_of(), num_micro=nm,
                            opt_cfg=T.opt_cfg(), num_groups=groups)
    state, m = fn(state, b)
    return {k: float(v) for k, v in m.items()}, T.numpy_state(state)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist")
    ckpt = root / "init"
    for i, case in enumerate(T.CASES):
        arch, kw = T.CASES[case]
        jcfg = JC.get_smoke_config(arch).replace(compute_dtype="float32",
                                                 **kw)
        state = JST.init_train_state(jcfg, jax.random.PRNGKey(i))
        JCKPT.save(str(ckpt / case), 0, jax.tree.map(np.asarray, state))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=f"{SRC}{os.pathsep}{TESTS}")
    jax_out = root / "jax.npz"
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", "import torch_dist_cases as T; "
         f"T.jax_reference({str(ckpt)!r}, {str(jax_out)!r})"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            ranks = pool.submit(D.run_ranks, T.parity_ranks, 4, str(ckpt),
                                str(root), device_type="cpu",
                                timeout_s=RANKS_TIMEOUT, workdir=str(root))
            one = pool.submit(D.run_ranks, T.one_by_one_ranks, 1, str(ckpt),
                              device_type="cpu", timeout_s=RANKS_TIMEOUT,
                              workdir=str(root))
            refs = {}
            for mk in T.MESHES:
                for case in T.CASES:
                    for nm in T.MICRO:
                        refs[(mk, case, nm)] = _one_device(
                            str(ckpt / case), 0, case, nm, T.batch(case, 0),
                            _groups(case, mk, nm))
            refs["uneven"] = _one_device(
                str(ckpt / "dense_heads"), 0, "dense_heads", 1,
                T.uneven_batch("dense_heads"), None)
            out["parity"] = ranks.result()[0]
            out["one_by_one"] = one.result()[0]
        out["refs"] = refs
        out["elastic_ref"] = _one_device(str(root / "elastic"), 1, T.ELASTIC,
                                         1, T.batch(T.ELASTIC, 1), None)
        log, _ = jax_proc.communicate(timeout=RANKS_TIMEOUT)
        assert jax_proc.returncode == 0, log[-4000:]
        with np.load(jax_out) as z:
            out["jax"] = dict(z)
        out["root"] = root
        yield out
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()


def assert_states_close(got, want, what):
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        if name.startswith("['params']"):
            v = want[name.replace("['params']", "['opt']['v']")]
            ill = np.sqrt(v / (1 - 0.95)) < 100 * EPS
            tol = np.where(ill, 2 * LR, 1e-2 * LR)
            bad = np.abs(g - w) > tol
            assert not bad.any(), (what, name, float(np.abs(g - w).max()))
        elif name.startswith("['opt']"):
            scale = max(float(np.abs(w).max()), 1e-12)
            np.testing.assert_allclose(g, w, atol=2e-5 * scale, rtol=0,
                                       err_msg=f"{what} {name}")
        else:
            assert int(g) == int(w), (what, name)


def assert_metrics_close(got, want, what):
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                   err_msg=f"{what} {k}")


STEPS = [(mk, case, nm) for mk in T.MESHES for case in T.CASES
         for nm in T.MICRO]


@pytest.mark.parametrize("mk,case,nm", STEPS,
                         ids=[f"{m}-{c}-micro{n}" for m, c, n in STEPS])
def test_sharded_step_matches_one_device(runs, mk, case, nm):
    m, state = runs["parity"]["steps"][(mk, case, nm)]
    rm, rstate = runs["refs"][(mk, case, nm)]
    assert_metrics_close(m, rm, (mk, case, nm))
    assert_states_close(state, rstate, (mk, case, nm))
    moved = runs["parity"]["bytes"][(mk, case, nm)]
    assert moved["all_gather"] > 0 and moved["reduce_scatter"] > 0, moved


ONE = [(case, nm) for case in T.CASES for nm in T.MICRO]


@pytest.mark.parametrize("case,nm", ONE,
                         ids=[f"{c}-micro{n}" for c, n in ONE])
def test_one_by_one_mesh_equals_one_device_to_the_bit(runs, case, nm):
    (same, where), ma, mb, moved = runs["one_by_one"][(case, nm)]
    assert same, where
    assert ma == mb
    assert moved == 0


JAXS = [(case, nm) for case in T.JAX_CASES for nm in T.MICRO]


@pytest.mark.parametrize("case,nm", JAXS,
                         ids=[f"{c}-micro{n}" for c, n in JAXS])
def test_sharded_step_matches_jax_sharded_step(runs, case, nm):
    m, state = runs["parity"]["steps"][("2x2", case, nm)]
    z = runs["jax"]
    pre = f"{case}|{nm}|"
    assert_metrics_close(m, {k: float(z[f"{pre}metric|{k}"])
                             for k in ("loss", "grad_norm", "lr")}, case)
    want = {k[len(pre):]: z[k] for k in z
            if k.startswith(pre) and "|metric|" not in k}
    assert_states_close(state, want, ("jax", case, nm))


def test_global_norm_counts_replicated_leaves_once(runs):
    n = runs["parity"]["norm"]
    np.testing.assert_allclose(n["mesh"], n["one_device"], rtol=1e-6)
    # summing every rank's squares counts a leaf once per rank holding a
    # copy (2 for a leaf sharded on one axis, 4 for a replicated one)
    np.testing.assert_allclose(n["every_rank"], n["every_copy"], rtol=1e-6)
    assert n["every_rank"] > n["one_device"] * (1 + 1e-3)


def test_loss_is_the_global_masked_mean(runs):
    b = T.uneven_batch("dense_heads")
    rows = b["mask"].reshape(2, -1).sum(1)
    assert rows[0] < rows[1] / 4          # the data ranks' counts differ
    assert_metrics_close(runs["parity"]["uneven"], runs["refs"]["uneven"][0],
                         "uneven mask")


def test_capacity_group_never_spans_data_ranks():
    """pick_num_groups(2 x 8193 tokens, 2 shards) gives 3 groups: the step
    refuses it, naming the batch."""
    cfg = T.cfg_of("moe_ep")
    mesh = MS.MeshShape({"data": 2, "model": 1})
    assert MOE.pick_num_groups(2 * 8193, 2) == 3
    with pytest.raises(ValueError, match=r"batch 2 x 8193 .*span two data"):
        ST.make_train_step(cfg, ShapeSpec("t", 8193, 2, "train"),
                           mesh=mesh)


def test_elastic_restore_continues_the_run(runs):
    e = runs["parity"]["elastic"]
    m_a, a = e["uninterrupted"]
    m_b, b = e["restored_4x1"]
    m_c, c = runs["elastic_ref"]
    assert a["['step']"] == b["['step']"] == c["['step']"] == 2
    for what, (m, s) in {"4x1": (m_b, b), "one device": (m_c, c)}.items():
        assert_metrics_close(m, m_a, what)
        assert_states_close(s, a, what)


def test_sharded_checkpoint_reads_in_the_jax_package(runs):
    arch, kw = T.CASES[T.ELASTIC]
    jcfg = JC.get_smoke_config(arch).replace(compute_dtype="float32", **kw)
    path = str(runs["root"] / "elastic")
    theirs = jax.tree.map(np.asarray, JCKPT.restore(
        path, 1, JST.train_state_specs(jcfg)))
    mine = T.numpy_state(CKPT.restore(path, 1, T.like(T.ELASTIC)))
    flat = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(theirs)[0]}
    assert flat.keys() == mine.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(v, mine[k], err_msg=k)


@pytest.mark.parametrize("fn", [T.failing_ranks, T.stuck_failing_ranks],
                         ids=["exits", "stuck_exiting"])
def test_a_failing_rank_fails_the_run_at_once(fn):
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        D.run_ranks(fn, 2, device_type="cpu", timeout_s=60)
    assert time.monotonic() - t < 30


def test_a_run_past_its_limit_fails():
    t = time.monotonic()
    with pytest.raises(TimeoutError):
        D.run_ranks(T.sleeping_ranks, 2, device_type="cpu", timeout_s=4)
    assert time.monotonic() - t < 30
