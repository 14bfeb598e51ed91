"""Remat in the port's train step against the JAX package's: AdamW steps,
in float32 on the CPU, for the six families at their smoke configs (the
gradients and what each policy keeps: tests/test_torch_remat.py):

* 1 step, then 5 with 2 micro-batches, with remat off, "nothing" and
  "dots": the port's three runs equal to the bit, and "dots" close to
  JAX's ``make_train_step(remat=True, remat_policy="dots")``;
* under "nothing", 3 steps, a checkpoint, a restore and 3 more equal 6
  steps straight to the bit.

Tolerances are tests/test_torch_training.py's: after AdamW steps the
parameters within 1 % of one step's size (lr) of JAX's, the moments 2e-5
of each leaf's largest |moment|, losses and gradient norms 1e-4 relative.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as JST
from repro.models.config import ShapeSpec as JShape
from repro.training import optim as JOPT
from repro_torch.launch import steps as ST
from repro_torch.models.config import ShapeSpec
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import optim as OPT
from test_torch_remat import (ARCHS, B, POLICIES, S, batch_np, cfgs, jax_kw,
                              jax_state, port_state)
from torch_cases import one_torch_thread  # noqa: F401

LR = 1e-3
OPT_KW = dict(lr=LR, warmup_steps=2, total_steps=10)


@functools.lru_cache(maxsize=None)
def jax_step(arch, policy, num_micro):
    fn, _ = JST.make_train_step(cfgs(arch)[0], None,
                                JShape("t", S, B, "train"),
                                num_micro=num_micro, donate=False,
                                opt_cfg=JOPT.AdamWConfig(**OPT_KW),
                                **jax_kw(policy))
    return fn


def port_run(arch, policy, state, steps, num_micro=1):
    fn = ST.make_train_step(cfgs(arch)[1], ShapeSpec("t", S, B, "train"),
                            num_micro=num_micro,
                            opt_cfg=OPT.AdamWConfig(**OPT_KW),
                            **POLICIES[policy])
    metrics = []
    for s in range(state["step"], steps):
        state, m = fn(state, batch_np(arch, s))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def jax_run(arch, policy, state, steps, num_micro=1):
    fn = jax_step(arch, policy, num_micro)
    metrics = []
    for s in range(int(np.asarray(state["step"])), steps):
        state, m = fn(state, {k: jnp.asarray(v)
                              for k, v in batch_np(arch, s).items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree.map(np.asarray, state), metrics


def flat(state):
    return {name: v.detach().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for name, v in CKPT._flatten(state)}


def assert_states_close(port, jax_s):
    mine, theirs = flat(port), flat(jax_s)
    assert mine.keys() == theirs.keys()
    for name, want in theirs.items():
        got = mine[name]
        if name.startswith("['params']"):
            np.testing.assert_allclose(got, want, atol=1e-2 * LR, rtol=0,
                                       err_msg=name)
        elif name.startswith("['opt']"):
            scale = max(float(np.abs(want).max()), 1e-12)
            np.testing.assert_allclose(got, want, atol=2e-5 * scale, rtol=0,
                                       err_msg=name)
        else:
            assert int(got) == int(want), name


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_steps_equal_across_policies_and_match_jax(arch):
    """1 step, then 5 with 2 micro-batches, under each policy: the port's
    three runs equal to the bit, and "dots" against JAX's step under
    "dots" ("nothing", the default of both packages, is held against
    JAX's step by tests/test_torch_training.py; remat off equals both to
    the bit here)."""
    runs = {}
    for policy in POLICIES:
        state, m1 = port_run(arch, policy, port_state(arch), 1)
        state, m5 = port_run(arch, policy, state, 6, num_micro=2)
        runs[policy] = (state, m1 + m5)
    for policy in ("nothing", "dots"):
        same, where = ST.state_equal(runs[policy][0], runs["off"][0])
        assert same, f"{policy} vs off: {where}"
        assert runs[policy][1] == runs["off"][1]
    js, j1 = jax_run(arch, "dots", jax_state(arch), 1)
    js, j5 = jax_run(arch, "dots", js, 6, num_micro=2)
    state, metrics = runs["dots"]
    for a, b in zip(metrics, j1 + j5):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    assert_states_close(state, js)


def test_remat_resume_is_bit_exact(tmp_path):
    """Under "nothing": 3 steps, a checkpoint, a restore and 3 more equal 6
    steps straight to the bit."""
    arch = "hymba-1.5b"
    straight, m = port_run(arch, "nothing", port_state(arch), 6)
    half, _ = port_run(arch, "nothing", port_state(arch), 3)
    CKPT.save(str(tmp_path), 3, half)
    back = CKPT.restore(str(tmp_path), 3, ST.train_state_specs(cfgs(arch)[1]),
                        device="cpu")
    resumed, m2 = port_run(arch, "nothing", back, 6)
    same, where = ST.state_equal(straight, resumed)
    assert same, where
    assert m2 == m[3:]
