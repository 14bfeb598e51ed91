"""The serving step builders of repro_torch on meshes of spawned ranks (gloo
on the CPU), against the port's one-device step and JAX's own sharded
steps (tests/torch_serve_cases.py holds the configs and rank functions):

* every family (dense with heads over `model` and with 16 kv heads, EP and
  TP MoE, ssm, hybrid, VLM, encoder) on (data 2, model 2) and (pod 2, data
  2, model 1): the prefill variants (default, ``fsdp=False``,
  ``seq_parallel``, ``banded`` for the sliding-window config) and, from
  the default prefill's cache resharded into each decode layout, three
  decode steps in each mode (hd, lc with per_row_write, kv, resident),
  against the one-device step on the same weights, batches and capacity
  groups: logits and caches;
* batches that do not split over the data axes (1 and 3, JAX's long_500k
  decode layout): every family that decodes on both meshes, the default
  prefill of a prompt that wraps the windowed configs' ring and three
  decode steps in each mode, against the one-device step.  Every data rank
  holds every row; the cache splits its slots over the data axes (with
  head_dim over `model` in hd: kernel (b) over the rank's slot range, its
  lse merged over the data axes; with `model` in lc; alone in kv and
  resident: kernel (a)), the conv and SSM states are whole over them;
* on a 1 x 1 mesh, every variant equal to the bit to the one-device step,
  and no collective byte;
* the sequence-parallel prefill of the VLM (each `model` rank a chunk of
  the joined image + text sequence) and of the encoder on (data 1, model
  4) at 8 positions, where the VLM's 4-position image prefix spans two
  ranks;
* dense hd decode, lc + per_row_write decode, TP MoE decode and the
  sequence-parallel prefill (dense, TP MoE, VLM, encoder) against
  ``repro.launch.steps``' sharded steps on a (2, 2) mesh of 4 host devices,
  in a subprocess whose XLA_FLAGS alone give it 4 devices; at batch 1 the
  dense prefill, dense hd decode (slots over `data`, head_dim over
  `model`), TP MoE lc + per_row_write decode (slots over `data` and
  `model`) and hybrid hd decode (its head_dim 8 does not split: slots over
  `data`, heads over `model`) the same way, where JAX's prefill step is
  jitted again with its decode step's rule for the logits' rows and its
  lc rule's specs flattened (``torch_serve_cases._jax_unsplit``);
* the MoE capacity groups of a sequence-parallel prefill and of a decode
  batch whose single group spans the data ranks are JAX's (the one-device
  step in those groups is the reference above);
* the VLM's cache after a sequence-parallel prefill equal to JAX's slot
  for slot (its slot positions equal, not merely close);
* the refusals: ``calibrate=True``; a joined length that does not split
  over `model` in the sequence-parallel prefill (ValueError).

The ranks run in the background while this process computes the
one-device references and a subprocess JAX's steps.  Tolerances (float32,
sums in another order): logits and caches 1e-4 absolute (values of order
1 to 10; measured within 1e-5).
"""
import concurrent.futures
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_serve_cases as T
from repro_torch.launch import dist as D
from torch_cases import one_torch_thread  # noqa: F401

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
RANKS_TIMEOUT = 240.0
TOL = 1e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=f"{SRC}{os.pathsep}{TESTS}")
    jax_out = root / "jax.npz"
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", "import torch_serve_cases as T; "
         f"T.jax_reference({str(jax_out)!r})"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    try:
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            kw = dict(device_type="cpu", timeout_s=RANKS_TIMEOUT,
                      workdir=str(root))
            ranks = pool.submit(D.run_ranks, T.serve_ranks, 4, **kw)
            unsplit = pool.submit(D.run_ranks, T.unsplit_ranks, 4, **kw)
            one = pool.submit(D.run_ranks, T.one_by_one_ranks, 1, **kw)
            refusing = pool.submit(D.run_ranks, T.refusing_ranks, 2, **kw)
            refs = {}
            for mk, shp in T.MESHES.items():
                ds = shp["data"] * shp.get("pod", 1)
                for case in T.CASES:
                    for key, val in T.one_device(case, ds).items():
                        refs[(mk, case) + key] = val
                for case in T.unsplit_cases():
                    for b in T.UNSPLIT:
                        for key, val in T.one_device(
                                case, ds, b, T.S_UNSPLIT,
                                ["default"]).items():
                            refs[(mk, case, b) + key] = val
            for mk in T.SEQ_MESH:
                for case in T.SEQ_CASES:
                    for key, val in T.one_device(case, 1, T.B, T.S_SEQ,
                                                 ["seq_parallel"],
                                                 []).items():
                        refs[(mk, case) + key] = val
            out["refs"] = refs
            out["mesh"] = ranks.result()[0]
            out["unsplit"] = unsplit.result()[0]
            out["one_by_one"] = one.result()[0]
            out["refusing"] = dict(refusing.result()[0])
        log, _ = jax_proc.communicate(timeout=RANKS_TIMEOUT)
        assert jax_proc.returncode == 0, log[-4000:]
        with np.load(jax_out) as z:
            out["jax"] = dict(z)
        yield out
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()


def assert_cache_close(got, want, what):
    assert set(got) == set(want), what
    for k, w in want.items():
        if isinstance(w, torch.Tensor):
            np.testing.assert_allclose(np.asarray(got[k], dtype=np.float64),
                                       w.double().numpy(), atol=TOL, rtol=0,
                                       err_msg=f"{what} {k}")
        else:
            assert int(got[k]) == int(w), (what, k)


VARIANTS = [(mk, case, "prefill", k) for mk in T.MESHES for case in T.CASES
            for k in T.prefill_variants(case)] + \
    [(mk, case, "decode", k) for mk in T.MESHES for case in T.CASES
     for k in T.decode_variants(case)]


@pytest.mark.parametrize("mk,case,kind,variant", VARIANTS,
                         ids=["-".join(v) for v in VARIANTS])
def test_mesh_step_matches_one_device(runs, mk, case, kind, variant):
    key = (mk, case, kind, variant)
    got, want = runs["mesh"][key], runs["refs"][key]
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=TOL,
                               rtol=0, err_msg=str(key))
    if want[1] is not None:
        assert_cache_close(got[1], want[1], key)
    if kind == "decode" and mk == "2x2":
        assert sum(got[2].values()) > 0, got[2]


UNSPLIT = [(mk, case, b, kind, k) for mk in T.MESHES
           for case in T.unsplit_cases() for b in T.UNSPLIT
           for kind, ks in (("prefill", ["default"]),
                            ("decode", T.decode_variants(case)))
           for k in ks]


@pytest.mark.parametrize("mk,case,b,kind,variant", UNSPLIT,
                         ids=["-".join(map(str, v)) for v in UNSPLIT])
def test_unsplit_batch_matches_one_device(runs, mk, case, b, kind, variant):
    key = (mk, case, b, kind, variant)
    got, want = runs["unsplit"][key], runs["refs"][key]
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=TOL,
                               rtol=0, err_msg=str(key))
    assert_cache_close(got[1], want[1], key)
    if kind == "decode" and mk == "2x2":
        assert sum(got[2].values()) > 0, got[2]


ONE = [(case, kind, k) for case in T.CASES
       for kind, ks in (("prefill", T.prefill_variants(case)),
                        ("decode", T.decode_variants(case))) for k in ks]


@pytest.mark.parametrize("case,kind,variant", ONE,
                         ids=["-".join(v) for v in ONE])
def test_one_by_one_mesh_equals_one_device_to_the_bit(runs, case, kind,
                                                      variant):
    same, moved = runs["one_by_one"][(case, kind, variant)]
    assert same
    assert moved == 0


@pytest.mark.parametrize("case", list(T.CASES))
def test_one_device_builder_is_the_reference(runs, case):
    assert runs["one_by_one"][(case, "builder")][0]


JAXS = [(T.B, c, "prefill", k) for c, k in T.JAX_PREFILL] + \
    [(T.B, c, "decode", k) for c, k in T.JAX_DECODE] + \
    [(1, c, "prefill", k) for c, k in T.UNSPLIT_JAX_PREFILL] + \
    [(1, c, "decode", k) for c, k in T.UNSPLIT_JAX_DECODE]


@pytest.mark.parametrize("b,case,kind,variant", JAXS,
                         ids=["-".join(map(str, v)) for v in JAXS])
def test_mesh_step_matches_jax_sharded_step(runs, b, case, kind, variant):
    z = runs["jax"]
    pre = f"{case}|{kind}|{variant}|" if b == T.B else \
        f"b{b}|{case}|{kind}|{variant}|"
    want = {k[len(pre):]: v for k, v in z.items() if k.startswith(pre)}
    logits, cache = runs["mesh"][("2x2", case, kind, variant)][:2] \
        if b == T.B else runs["unsplit"][("2x2", case, b, kind, variant)][:2]
    np.testing.assert_allclose(logits.numpy(), want.pop("logits"),
                               atol=TOL, rtol=0, err_msg=pre)
    cache = cache or {}                 # the encoder returns no cache
    assert set(cache) == set(want), (set(cache), set(want))
    for k, w in want.items():
        np.testing.assert_allclose(np.asarray(cache[k], dtype=np.float64),
                                   w.astype(np.float64), atol=TOL, rtol=0,
                                   err_msg=pre + k)


SEQ = [(mk, case) for mk in T.SEQ_MESH for case in T.SEQ_CASES]


@pytest.mark.parametrize("mk,case", SEQ, ids=["-".join(v) for v in SEQ])
def test_seq_parallel_prefill_across_ranks(runs, mk, case):
    """Two positions a rank on (data 1, model 4): the VLM's image prefix
    lies on ranks 0 and 1, its text on ranks 2 and 3."""
    key = (mk, case, "prefill", "seq_parallel")
    got, want = runs["mesh"][key], runs["refs"][key]
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=TOL,
                               rtol=0, err_msg=str(key))
    if want[1] is not None:
        assert_cache_close(got[1], want[1], key)


def test_vlm_seq_parallel_cache_equals_jax_slot_for_slot(runs):
    """Every slot of the VLM's cache after JAX's and the port's
    sequence-parallel prefill on (2, 2): the same position (equal, not
    close) and the same K and V rows, the image prefix's slots first."""
    pre = "vlm|prefill|seq_parallel|"
    want = {k[len(pre):]: v for k, v in runs["jax"].items()
            if k.startswith(pre)}
    cache = runs["mesh"][("2x2", "vlm", "prefill", "seq_parallel")][1]
    np.testing.assert_array_equal(cache["slot_pos"].numpy(),
                                  want["slot_pos"])
    P = T.cfg_of("vlm").num_prefix_tokens
    np.testing.assert_array_equal(cache["slot_pos"][:, :T.S].numpy(),
                                  np.tile(np.arange(T.S), (T.B, 1)))
    assert (cache["slot_pos"][:, T.S:] == -1).all()
    assert int(cache["idx"]) == int(want["idx"]) == T.S
    for name in ("k", "v"):
        got, w = cache[name].double().numpy(), want[name].astype(np.float64)
        for slot in range(T.S):
            np.testing.assert_allclose(
                got[:, :, slot], w[:, :, slot], atol=TOL, rtol=0,
                err_msg=f"{name} slot {slot} ({'image' if slot < P else 'text'})")
        assert not got[:, :, T.S:].any() and not w[:, :, T.S:].any()


@pytest.mark.parametrize("case,s", T.UNEVEN,
                         ids=[f"{c}-{s}" for c, s in T.UNEVEN])
def test_seq_parallel_refuses_a_length_that_does_not_split(runs, case, s):
    got = runs["refusing"][f"uneven {case} {s}"]
    assert got is not None, "the step was built"
    kind, msg = got
    assert kind == "ValueError" and f"sequence {s} does not split" in msg, got


@pytest.mark.parametrize("what,match", [
    ("calibrate", "cost-analysis compile")])
def test_mesh_steps_refuse(runs, what, match):
    got = runs["refusing"][what]
    assert got is not None and match in got[1], got
