"""The training path of repro_torch against the JAX package's, on the same
weights and seeded batches, in float32 on the CPU (mirrors
tests/test_training.py and tests/test_models.py's train-step smoke test):

* train-mode logits and ``lm_loss``, and the gradient of every master leaf,
  for olmo-1b (dense), paligemma-3b (VLM, with ``prefix_embeds``),
  hubert-xlarge (encoder, with ``embeds``), qwen3-moe-30b-a3b (MoE: the
  grouped matmul's plain backward pair), falcon-mamba-7b (ssm) and
  hymba-1.5b (hybrid: the selective scan's plain backward pair);
* one ``make_train_step`` step, then 5 with micro-batch accumulation, from
  the JAX initial state (``train_state_from_jax``), and one MoE step whose
  micro-batch splits into two capacity groups (``pick_num_groups``);
* the VLM's prefill and decode with ``prefix_embeds``, and its
  grammar-constrained ``generate`` on both KV layouts (texts and stats
  equal);
* checkpoints: round trip, retention, atomicity, and crossing between the
  packages in both directions (a checkpoint of one, stepped by the other,
  equals the first's own continued run);
* resume equal to the bit, and the driver's failure and resume;
* the refusal of a forward-only kernel wrapper reached with inputs that
  require grad.

Tolerances (float32, sums in another order than XLA's): logits and loss
1e-5 absolute and relative; gradients 1e-5 relative to each leaf's largest
|gradient| (at least 1e-3); after AdamW steps the parameters within 1 % of
one step's size (lr) of JAX's (AdamW moves every element by up to lr, and
m / sqrt(v) of an element whose gradient is ~0 is sensitive to the last
bits; measured: 0.03 % of lr after 6 steps), the moments 2e-5 relative to
each leaf's largest |moment| (measured: 1.6e-6), losses and gradient norms
1e-4 relative.
"""
import functools
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.launch import steps as JST
from repro.models import model as JMDL
from repro.models.config import ShapeSpec as JShape
from repro.training import checkpoint as JCKPT
from repro.training import optim as JOPT
from repro.training.data import DataConfig as JData
from repro.training.data import synthetic_batch as jax_batch
from repro_torch.kernels import ops
from repro_torch.launch import steps as ST
from repro_torch.launch import train as TR
from repro_torch.models import model as MDL
from repro_torch.models.config import ShapeSpec
from repro_torch.models.params import param_specs, train_state_from_jax
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import optim as OPT
from repro_torch.training.data import DataConfig, synthetic_batch
from torch_cases import (engine_pair, gen_stats, grammar_pair,
                         one_torch_thread)  # noqa: F401

ARCHS = ["olmo-1b", "paligemma-3b", "hubert-xlarge"]
#: the families whose training goes through the grouped matmul (MoE) or the
#: selective scan (ssm, hybrid)
MOE_SSM = ["qwen3-moe-30b-a3b", "falcon-mamba-7b", "hymba-1.5b"]
B, S = 4, 16          # paligemma's smoke config: 8 image tokens + 8 text
LR = 1e-3
OPT_KW = dict(lr=LR, warmup_steps=2, total_steps=10)
TOL = dict(atol=1e-5, rtol=1e-5)


def cfgs(arch):
    kw = dict(compute_dtype="float32")
    return (JC.get_smoke_config(arch).replace(**kw),
            TC.get_smoke_config(arch).replace(**kw))


@functools.lru_cache(maxsize=None)
def jax_state(arch, seed=0):
    jcfg, _ = cfgs(arch)
    return jax.tree.map(np.asarray,
                        JST.init_train_state(jcfg, jax.random.PRNGKey(seed)))


def port_state(arch, seed=0):
    return train_state_from_jax(cfgs(arch)[1], jax_state(arch, seed), "cpu")


def batch_np(arch, step, batch=B):
    return synthetic_batch(cfgs(arch)[1], DataConfig(batch=batch, seq_len=S),
                           step)


def to_t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def jax_step(arch, num_micro):
    jcfg, _ = cfgs(arch)
    fn, _ = JST.make_train_step(jcfg, None, JShape("t", S, B, "train"),
                                num_micro=num_micro, donate=False,
                                opt_cfg=JOPT.AdamWConfig(**OPT_KW))
    return fn


def port_step(arch, num_micro):
    return ST.make_train_step(cfgs(arch)[1], ShapeSpec("t", S, B, "train"),
                              num_micro=num_micro,
                              opt_cfg=OPT.AdamWConfig(**OPT_KW))


def jax_run(arch, state, steps, num_micro=1):
    fn = jax_step(arch, num_micro)
    metrics = []
    for s in range(int(np.asarray(state["step"])), steps):
        state, m = fn(state, {k: jnp.asarray(v)
                              for k, v in batch_np(arch, s).items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree.map(np.asarray, state), metrics


def port_run(arch, state, steps, num_micro=1):
    fn = port_step(arch, num_micro)
    metrics = []
    for s in range(state["step"], steps):
        state, m = fn(state, batch_np(arch, s))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def flat(state):
    """A train state's tensors by JAX keystr name, as numpy."""
    out = {}
    for name, v in CKPT._flatten(state):
        out[name] = np.asarray(v) if not isinstance(v, torch.Tensor) \
            else v.detach().numpy()
    return out


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


def assert_metrics_close(mine, theirs):
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)


# -------------------------- forward, loss, gradients --------------------------
def test_param_specs_and_count_match_jax():
    for arch in ARCHS + MOE_SSM + ["yi-6b"]:
        jcfg, tcfg = cfgs(arch)
        js = JMDL.param_specs(jcfg)
        ts = param_specs(tcfg)
        jflat = {n: (tuple(s.shape), str(s.dtype))
                 for n, s in CKPT._flatten(js)}
        tflat = {n: (tuple(s[0]), str(s[1]).replace("torch.", ""))
                 for n, s in CKPT._flatten(ts)}
        assert jflat == tflat, arch
        st = port_state(arch) if arch in ARCHS + MOE_SSM else None
        if st is not None:
            assert MDL.param_count_actual(st["params"]) == \
                JMDL.param_count_actual(jax_state(arch)["params"])


@pytest.mark.parametrize("arch", ARCHS + MOE_SSM)
def test_train_forward_loss_and_grads_match_jax(arch):
    jcfg, tcfg = cfgs(arch)
    params_j = jax_state(arch)["params"]
    batch = batch_np(arch, 0)

    def jloss(p):
        logits, _ = JMDL.forward(jcfg, p, {k: jnp.asarray(v)
                                           for k, v in batch.items()},
                                 mode="train")
        return JMDL.lm_loss(jcfg, logits, jnp.asarray(batch["labels"]),
                            jnp.asarray(batch["mask"])), logits
    (loss_j, logits_j), grads_j = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, params_j))

    params = port_state(arch)["params"]
    leaves = OPT.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tb = to_t(batch)
    logits, _ = MDL.forward(tcfg, params, tb, mode="train")
    loss = MDL.lm_loss(tcfg, logits, tb["labels"], tb["mask"])
    grads = torch.autograd.grad(loss, leaves)
    assert logits.shape == (B, S, tcfg.padded_vocab)
    torch.testing.assert_close(logits.detach(), torch.from_numpy(
        np.array(logits_j)), **TOL)
    torch.testing.assert_close(loss.detach(), torch.tensor(float(loss_j)),
                               **TOL)
    gj = [np.asarray(x) for x in jax.tree.leaves(grads_j)]
    assert len(gj) == len(grads)
    for name_g, got, want in zip([n for n, _ in CKPT._flatten(params)],
                                 grads, gj):
        scale = max(float(np.abs(want).max()), 1e-3)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * scale,
                                   rtol=0, err_msg=name_g)


@pytest.mark.parametrize("arch", ARCHS + MOE_SSM)
def test_train_steps_match_jax(arch):
    """One step (num_micro 1), then 5 more with 2 micro-batches."""
    state, m1 = port_run(arch, port_state(arch), 1)
    js, j1 = jax_run(arch, jax_state(arch), 1)
    assert_metrics_close(m1, j1)
    assert_states_close(state, js)
    state, m5 = port_run(arch, state, 6, num_micro=2)
    js, j5 = jax_run(arch, js, 6, num_micro=2)
    assert_metrics_close(m5, j5)
    assert_states_close(state, js)
    assert state["step"] == 6


def test_train_step_frees_its_gradients(monkeypatch):
    """A step's fp32 gradients are freed when it returns, without waiting
    for the garbage collector (a reference cycle that kept them alive
    until its next pass made the cut MoE config run out of the card)."""
    import gc
    import weakref
    refs = []
    update = OPT.adamw_update

    def spy(cfg, params, grads, opt, step):
        refs.extend(weakref.ref(g) for g in OPT.leaves(grads))
        return update(cfg, params, grads, opt, step)
    monkeypatch.setattr(OPT, "adamw_update", spy)
    state = port_state("qwen3-moe-30b-a3b")
    fn = port_step("qwen3-moe-30b-a3b", 1)
    gc.disable()
    try:
        state, _ = fn(state, batch_np("qwen3-moe-30b-a3b", 0))
        assert refs and not any(r() is not None for r in refs)
    finally:
        gc.enable()


def test_moe_train_step_in_two_groups_matches_jax():
    """qwen3-moe at B 16 x 512 = 8192 tokens a micro-batch: the JAX step
    and the port's route it in pick_num_groups = 2 capacity groups."""
    arch, b, s = "qwen3-moe-30b-a3b", 16, 512
    jcfg, tcfg = cfgs(arch)
    from repro_torch.models.moe import pick_num_groups
    assert pick_num_groups(b * s, 1) == 2
    batch = synthetic_batch(tcfg, DataConfig(batch=b, seq_len=s), 0)
    jfn, _ = JST.make_train_step(jcfg, None, JShape("t", s, b, "train"),
                                 donate=False,
                                 opt_cfg=JOPT.AdamWConfig(**OPT_KW))
    js, jm = jfn(jax_state(arch), {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    fn = ST.make_train_step(tcfg, ShapeSpec("t", s, b, "train"),
                            opt_cfg=OPT.AdamWConfig(**OPT_KW))
    state, m = fn(port_state(arch), batch)
    assert_metrics_close([{k: float(v) for k, v in m.items()}],
                         [{k: float(v) for k, v in jm.items()}])
    assert_states_close(state, jax.tree.map(np.asarray, js))


def test_vlm_prefill_and_decode_with_prefix_embeds_match_jax():
    """paligemma's prefill over [image prefix ++ text] and a decode step
    (positions past the prefix), against the JAX model (test_models.py's
    prefill/decode check, here held against JAX itself)."""
    jcfg, tcfg = cfgs("paligemma-3b")
    params_j = jax_state("paligemma-3b")["params"]
    from repro_torch.models.params import params_from_jax
    params = params_from_jax(tcfg, params_j, "cpu")
    rng = np.random.default_rng(4)
    P, T = tcfg.num_prefix_tokens, 12
    toks = rng.integers(0, tcfg.vocab_size, (2, T)).astype(np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32), (2, 1))
    pre = rng.standard_normal((2, P, tcfg.d_model)).astype(np.float32)
    jcache = JMDL.init_cache(jcfg, 2, P + T + 4)
    lj, jcache = JMDL.forward(jcfg, params_j, {
        "tokens": jnp.asarray(toks[:, :-1]),
        "positions": jnp.asarray(pos[:, :-1]),
        "prefix_embeds": jnp.asarray(pre)}, mode="prefill", cache=jcache)
    dj, _ = JMDL.forward(jcfg, params_j, {
        "tokens": jnp.asarray(toks[:, -1:]),
        "positions": jnp.asarray(pos[:, -1:] + P)}, mode="decode",
        cache=jcache)
    cache = MDL.init_cache(tcfg, 2, P + T + 4)
    lt, cache = MDL.forward(tcfg, params, {
        "tokens": torch.from_numpy(toks[:, :-1]),
        "positions": torch.from_numpy(pos[:, :-1]),
        "prefix_embeds": torch.from_numpy(pre)}, mode="prefill", cache=cache)
    assert cache["idx"] == P + T - 1
    dt, _ = MDL.forward(tcfg, params, {
        "tokens": torch.from_numpy(toks[:, -1:]),
        "positions": torch.from_numpy(pos[:, -1:] + P)}, mode="decode",
        cache=cache)
    torch.testing.assert_close(lt, torch.from_numpy(np.array(lj)), **TOL)
    torch.testing.assert_close(dt, torch.from_numpy(np.array(dj)), **TOL)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_vlm_generate_matches_jax(layout):
    """The VLM family is served as the JAX engine serves it (no image
    prefix: the text decoder with prefix-LM masking of its first
    positions): grammar-constrained, sampled texts and GenStats equal."""
    je, te = engine_pair("paligemma-3b", kv_layout=layout)
    jg, tg = grammar_pair()
    prompts = ["row: item42", "row: b", "row: a longer third row"]
    a = je.generate(prompts, grammar=jg, max_new_tokens=30, temperature=0.7)
    b = te.generate(prompts, grammar=tg, max_new_tokens=30, temperature=0.7)
    assert b.texts == a.texts
    assert gen_stats(b.stats) == gen_stats(a.stats)


# --------------------------------- checkpoints ---------------------------------
def test_checkpoint_roundtrip_sharded(tmp_path):
    state = port_state("olmo-1b")
    CKPT.save(str(tmp_path), 7, state, num_shards=4)
    assert CKPT.latest_step(str(tmp_path)) == 7
    back = CKPT.restore(str(tmp_path), 7,
                        ST.train_state_specs(cfgs("olmo-1b")[1]))
    assert back["step"] == 0 and isinstance(back["step"], int)
    ok, where = ST.state_equal(state, back)
    assert ok, where


def test_checkpoint_retention_and_atomicity(tmp_path):
    state = port_state("olmo-1b")
    for s in (10, 20, 30, 40):
        CKPT.save(str(tmp_path), s, state, keep_last=2)
    steps = sorted(p.name for p in Path(tmp_path).glob("step_*"))
    assert steps == ["step_00000030", "step_00000040"]
    # a step directory without its manifest (a crash mid-write) is ignored
    (Path(tmp_path) / "step_00000050").mkdir()
    assert CKPT.latest_step(str(tmp_path)) == 40
    assert not list(Path(tmp_path).glob(".tmp_step_*"))


def test_checkpoint_leaf_names_are_jax_keystr(tmp_path):
    CKPT.save(str(tmp_path / "t"), 1, port_state("hubert-xlarge"))
    JCKPT.save(str(tmp_path / "j"), 1, jax_state("hubert-xlarge"))
    import json
    names = [[leaf["name"] for leaf in json.loads(
        (tmp_path / d / "step_00000001" / "manifest.json").read_text()
    )["leaves"]] for d in ("t", "j")]
    assert names[0] == names[1]
    assert "['params']['layers']['attn.wq']" in names[0]
    assert "['params']['embed']" not in names[0]        # the encoder's


@pytest.mark.parametrize("arch", ["olmo-1b", "paligemma-3b"] + MOE_SSM)
def test_checkpoint_from_jax_restores_and_steps_in_the_port(arch, tmp_path):
    js, _ = jax_run(arch, jax_state(arch), 2)
    JCKPT.save(str(tmp_path), 2, js)
    state = CKPT.restore(str(tmp_path), 2,
                         ST.train_state_specs(cfgs(arch)[1]))
    assert state["step"] == 2
    state, mine = port_run(arch, state, 4)
    js, theirs = jax_run(arch, js, 4)
    assert_metrics_close(mine, theirs)
    assert_states_close(state, js)


@pytest.mark.parametrize("arch", ["olmo-1b", "hubert-xlarge"] + MOE_SSM)
def test_checkpoint_from_the_port_restores_and_steps_in_jax(arch, tmp_path):
    state, _ = port_run(arch, port_state(arch), 2)
    CKPT.save(str(tmp_path), 2, state)
    js = JCKPT.restore(str(tmp_path), 2,
                       JST.train_state_specs(cfgs(arch)[0]))
    assert int(js["step"]) == 2
    js, theirs = jax_run(arch, js, 4)
    state, mine = port_run(arch, state, 4)
    assert_metrics_close(mine, theirs)
    assert_states_close(state, js)


def test_resume_is_bit_exact(tmp_path):
    cont, _ = port_run("olmo-1b", port_state("olmo-1b"), 8)
    half, _ = port_run("olmo-1b", port_state("olmo-1b"), 4)
    CKPT.save(str(tmp_path), 4, half)
    back = CKPT.restore(str(tmp_path), 4,
                        ST.train_state_specs(cfgs("olmo-1b")[1]))
    resumed, _ = port_run("olmo-1b", back, 8)
    ok, where = ST.state_equal(cont, resumed)
    assert ok, where


def test_loss_decreases():
    """test_training.py's convergence check through the port's step."""
    cfg = TC.get_smoke_config("olmo-1b")
    fn = ST.make_train_step(cfg, ShapeSpec("t", 64, 4, "train"), num_micro=2,
                            opt_cfg=OPT.AdamWConfig(lr=3e-3, warmup_steps=5,
                                                    total_steps=60))
    state = ST.init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    losses = []
    for step in range(30):
        state, m = fn(state, synthetic_batch(cfg, DataConfig(batch=4,
                                                             seq_len=64),
                                             step))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses[::10]


def test_data_pipeline_matches_jax():
    for arch in ARCHS:
        a = synthetic_batch(cfgs(arch)[1], DataConfig(batch=4, seq_len=16), 3)
        b = jax_batch(cfgs(arch)[0], JData(batch=4, seq_len=16), 3)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


# ------------------------------------ driver -----------------------------------
def test_driver_simulated_failure_then_resume(tmp_path):
    args = ["--device", "cpu", "--smoke", "--arch", "olmo-1b", "--steps",
            "8", "--batch", "2", "--seq-len", "16", "--ckpt-every", "3",
            "--log-every", "100"]
    ref_run = TR.train(args + ["--ckpt-dir", str(tmp_path / "ref")])
    d = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="simulated node failure at step 5"):
        TR.main(args + ["--ckpt-dir", d, "--simulate-failure", "5"])
    assert CKPT.latest_step(d) == 3
    assert TR.main(args + ["--ckpt-dir", d, "--resume"]) == 0
    assert CKPT.latest_step(d) == 8
    like = ST.train_state_specs(TC.get_smoke_config("olmo-1b"))
    ok, where = ST.state_equal(CKPT.restore(d, 8, like),
                               CKPT.restore(str(tmp_path / "ref"), 8, like))
    assert ok, where
    ok, where = ST.state_equal(CKPT.restore(d, 8, like), ref_run["state"])
    assert ok, where


@pytest.mark.parametrize("workspace", [None, ":16:8"])
def test_driver_deterministic_restores_settings(monkeypatch, workspace):
    """--deterministic holds for the run only: the deterministic flag and
    CUBLAS_WORKSPACE_CONFIG are as they were after it."""
    if workspace is None:
        monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    else:
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", workspace)
    assert not torch.are_deterministic_algorithms_enabled()
    TR.train(["--device", "cpu", "--smoke", "--arch", "olmo-1b", "--steps",
              "1", "--batch", "2", "--seq-len", "16", "--deterministic"])
    assert not torch.are_deterministic_algorithms_enabled()
    assert os.environ.get("CUBLAS_WORKSPACE_CONFIG") == workspace


# ----------------------------------- refusals ----------------------------------
def test_forward_only_wrappers_refuse_differentiation():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 16, generator=g, requires_grad=True)
    kc = torch.randn(2, 8, 2, 16, generator=g)
    spos = torch.arange(8, dtype=torch.int32).repeat(2, 1)
    qpos = torch.tensor([7, 7], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="decode_attention"):
        ops.decode_attention(q, kc, kc, spos, qpos)
    logits = torch.randn(2, 10, generator=g, requires_grad=True)
    with pytest.raises(NotImplementedError, match="constrained_sample"):
        ops.constrained_sample(logits, torch.ones(2, 10, dtype=torch.int8))
    # without grad the same calls run (the serving path)
    with torch.no_grad():
        assert ops.decode_attention(q, kc, kc, spos, qpos).shape == (2, 4, 16)
