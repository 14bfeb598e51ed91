"""repro_torch's paged KV layout against the JAX package's.

Kernel functions: the plain versions behind ``ops.decode_attention_paged``
(A), ``ops.decode_attention_paged_quant`` (B) and
``ops.flash_attention_prefix`` (C) — what the wrappers run for CPU tensors —
against the Pallas kernels in interpret mode, ``repro.kernels.ref`` and the
jnp functions of ``repro.models.layers``, on the same numpy inputs.  The JAX
pools pad head_dim to 128 lanes; the port's do not.  Tolerance 2e-5
(float32; the two sides sum in different orders).

Engine: the olmo-1b smoke config (vocab 259) in float32 on the same weights
(``params_from_jax``) and sampling seed, page sizes 16 and 64.  Texts and
every GenStats counter (wall time aside) must be equal through paged
``generate`` (radix and exact prefix modes, with and without a shared
prefix).  The paged batcher, forks and int8 pages are in
``test_torch_radix.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.models import layers as JL
from repro_torch.kernels import ops
from repro_torch.serving.engine import PageAllocator
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_cases import (assert_pool_baseline, engine_pair, gen_stats,
                         grammar_pair, paged_case, prefix_case, quantize_pool,
                         t as _t)

TOL = 2e-5
PREFIX = "SHARED INSTRUCTION BLOCK: extract the field from the row. " * 3
KERNEL_CASES = {
    "ps16": dict(B=3, H=4, KV=2, D=32, ps=16, NB=4, P=16, shared=1),
    "ps64": dict(B=4, H=4, KV=4, D=16, ps=64, NB=3, P=12, shared=1),
    "no_shared": dict(B=2, H=8, KV=2, D=16, ps=16, NB=5, P=12, shared=0),
}


def _pad(pool, dp=128):
    """The JAX pool layout: head_dim zero-padded to the 128-lane width."""
    return np.pad(pool, [(0, 0)] * (pool.ndim - 1)
                  + [(0, dp - pool.shape[-1])])


def _jax_quant(q8k, q8v, ks, vs, flags):
    return {"kq": jnp.asarray(_pad(q8k)), "vq": jnp.asarray(_pad(q8v)),
            "kscale": jnp.asarray(ks), "vscale": jnp.asarray(vs),
            "flags": jnp.asarray(flags)}


def _torch_quant(q8k, q8v, ks, vs, flags):
    return {"kq": _t(q8k), "vq": _t(q8v), "kscale": _t(ks),
            "vscale": _t(vs), "flags": _t(flags)}


def _folded(q, kp, vp, table, qpos):
    """repro.kernels.ref's folded layout: q (B·KV, G, D), pools (KV·P, ps,
    D), tables offset per kv head, active block counts."""
    B, H, D = q.shape
    KV, P = kp.shape[:2]
    qf = q.reshape(B, KV, H // KV, D).reshape(B * KV, H // KV, D)
    btf = (np.clip(table, 0, P - 1)[:, None, :]
           + np.arange(KV)[None, :, None] * P).reshape(B * KV, -1)
    nact = np.repeat(qpos // kp.shape[2] + 1, KV)
    qposf = np.repeat(qpos[:, None], KV, axis=0)
    return qf, btf, nact, qposf


# ------------------------------ kernel A --------------------------------------
@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_decode_attention_paged_plain_matches_jax(case):
    """Ragged fills, shared prefix pages, and past each row's fill either
    allocated decode pages (odd rows) or -1 entries (even rows)."""
    q, kp, vp, table, qpos = paged_case(1, **KERNEL_CASES[case])
    out = ops.decode_attention_paged(_t(q), _t(kp), _t(vp), _t(table),
                                     _t(qpos)).numpy()
    D = q.shape[-1]
    jargs = (jnp.asarray(q), jnp.asarray(_pad(kp)), jnp.asarray(_pad(vp)),
             jnp.asarray(table), jnp.asarray(qpos))
    pallas = JOPS.decode_attention_paged(*jargs, head_dim=D, interpret=True)
    jnp_fn = JL.decode_attention_paged(*jargs, head_dim=D)
    np.testing.assert_allclose(out, np.asarray(pallas), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(out, np.asarray(jnp_fn), atol=TOL, rtol=TOL)


def test_decode_attention_paged_hole_below_fill_follows_jnp():
    """A -1 entry below a row's fill is masked, as the jnp function the SQL
    engine runs does (the Pallas wrapper instead computes over the row's
    last active page there; ROADMAP queue 3)."""
    q, kp, vp, table, qpos = paged_case(2, **KERNEL_CASES["ps16"])
    b = int(np.argmax(qpos))
    assert qpos[b] >= 2 * 16
    table[b, 1] = -1
    out = ops.decode_attention_paged(_t(q), _t(kp), _t(vp), _t(table),
                                     _t(qpos)).numpy()
    r = JL.decode_attention_paged(jnp.asarray(q), jnp.asarray(_pad(kp)),
                                  jnp.asarray(_pad(vp)), jnp.asarray(table),
                                  jnp.asarray(qpos), head_dim=q.shape[-1])
    np.testing.assert_allclose(out, np.asarray(r), atol=TOL, rtol=TOL)


# ------------------------------ kernel B --------------------------------------
@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_decode_attention_paged_quant_plain_matches_jax(case):
    """Even pages frozen into int8 shadows with per-(kv-head, page) scales,
    odd pages live in fp: the port against the JAX oracle, the jnp quant
    path and the Pallas dequantizing kernel."""
    q, kp, vp, table, qpos = paged_case(3, **KERNEL_CASES[case])
    q8k, ks, flags = quantize_pool(kp)
    q8v, vs, _ = quantize_pool(vp)
    out = ops.decode_attention_paged_quant(
        _t(q), _t(kp), _t(vp), _t(table), _t(qpos),
        _torch_quant(q8k, q8v, ks, vs, flags)).numpy()
    B, H, D = q.shape
    KV, P, ps, _ = kp.shape
    qf, btf, nact, qposf = _folded(q, kp, vp, table, qpos)
    r = JREF.decode_attention_paged_quant_ref(
        qf, kp.reshape(KV * P, ps, D), vp.reshape(KV * P, ps, D),
        q8k.reshape(KV * P, ps, D), q8v.reshape(KV * P, ps, D),
        ks.reshape(KV * P, 1), vs.reshape(KV * P, 1),
        np.tile(flags.astype(np.int32)[None], (KV, 1)).reshape(KV * P, 1),
        btf, nact, qposf)
    np.testing.assert_allclose(out, np.asarray(r).reshape(B, H, D),
                               atol=TOL, rtol=TOL)
    jq = _jax_quant(q8k, q8v, ks, vs, flags)
    jargs = (jnp.asarray(q), jnp.asarray(_pad(kp)), jnp.asarray(_pad(vp)),
             jnp.asarray(table), jnp.asarray(qpos))
    for fn, kw in ((JL.decode_attention_paged, {}),
                   (JOPS.decode_attention_paged, {"interpret": True})):
        r = fn(*jargs, head_dim=D, quant=jq, **kw)
        np.testing.assert_allclose(out, np.asarray(r), atol=TOL, rtol=TOL)


# ------------------------------ kernel C --------------------------------------
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("B,S,H,KV,D,ps,P,npre,plen", [
    (2, 40, 4, 2, 16, 16, 8, 3, None),
    (3, 24, 4, 4, 32, 64, 4, 2, 100),            # a partial last page
    (2, 33, 8, 2, 16, 16, 4, 0, None),           # Lp = 0
], ids=["ps16", "ps64_partial", "no_prefix"])
def test_flash_attention_prefix_plain_matches_jax(B, S, H, KV, D, ps, P,
                                                  npre, plen, quant):
    q, k, v, pos, kp, vp, ptab, plen = prefix_case(4, B, S, H, KV, D, ps, P,
                                                   npre, plen)
    tq = None
    kread, vread = kp, vp
    if quant:       # what the model gathers: frozen pages dequantized
        q8k, ks, flags = quantize_pool(kp)
        q8v, vs, _ = quantize_pool(vp)
        tq = _torch_quant(q8k, q8v, ks, vs, flags)
        fr = (flags > 0)[None, :, None, None]
        kread = np.where(fr, q8k.astype(np.float32) * ks[..., None, None], kp)
        vread = np.where(fr, q8v.astype(np.float32) * vs[..., None, None], vp)
    out = ops.flash_attention_prefix(_t(q), _t(k), _t(v), _t(pos), _t(kp),
                                     _t(vp), _t(ptab), plen, tq).numpy()
    kpre = kread[:, ptab].transpose(1, 2, 0, 3).reshape(-1, KV, D)
    vpre = vread[:, ptab].transpose(1, 2, 0, 3).reshape(-1, KV, D)
    r = JL.prefix_suffix_attention(jnp.asarray(q), jnp.asarray(kpre),
                                   jnp.asarray(vpre), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(pos),
                                   jnp.int32(plen))
    valid = pos >= 0             # pad rows have no valid key: never read
    np.testing.assert_allclose(out[valid], np.asarray(r)[valid], atol=TOL,
                               rtol=TOL)


# ------------------------------ page allocator --------------------------------
def test_page_allocator_alloc_free_refcount():
    """Mirror of test_paged_kv.py's allocator tests on the port's."""
    a = PageAllocator(6)
    p1 = a.alloc(2)
    p2 = a.alloc(3)
    assert (p1, p2) == ([0, 1], [2, 3, 4])
    assert a.in_use == 5 and a.free_pages == 1
    assert a.resident_pages == a.in_use == 5
    assert a.high_water == a.peak_in_use == 5
    a.retain(p1)                 # second reference (shared prefix)
    a.release(p1)
    assert a.in_use == 5         # still referenced
    a.release(p1)
    assert a.in_use == 3         # now freed
    a.release(p2)
    assert a.in_use == 0 and a.free_pages == 6
    assert a.peak_in_use == 5    # high-water survives frees
    with pytest.raises(RuntimeError):
        a.alloc(7)
    a.grow(4)
    assert a.free_pages == 10
    assert len(set(a.alloc(10))) == 10
    b = PageAllocator(2)
    p = b.alloc(1)
    b.release(p)
    with pytest.raises(AssertionError):
        b.release(p)


# ------------------------------ engines ---------------------------------------
@pytest.mark.parametrize("ps", [16, 64])
@pytest.mark.parametrize("prefix", ["", PREFIX], ids=["no_prefix", "prefix"])
@pytest.mark.parametrize("mode", ["radix", "exact"])
def test_generate_paged_matches_jax(mode, prefix, ps):
    je, te = engine_pair(page_size=ps, prefix_cache_mode=mode)
    jg, tg = grammar_pair()
    rows = [f"row {i}: " + "detail " * (i % 3) + f"value {i * 7}"
            for i in range(3)]
    for extra in ("", "", " extended"):   # repeat, then partial overlap
        a = je.generate([r + extra for r in rows], grammar=jg,
                        shared_prefix=prefix, max_new_tokens=24,
                        temperature=0.7)
        b = te.generate([r + extra for r in rows], grammar=tg,
                        shared_prefix=prefix, max_new_tokens=24,
                        temperature=0.7)
        assert b.texts == a.texts
        assert gen_stats(b.stats) == gen_stats(a.stats)
    assert gen_stats(te.total) == gen_stats(je.total)
    if prefix:                   # the repeats reuse the prefix pages
        assert te.total.prefix_hits > 0
        assert te._alloc.in_use > 0
    assert_pool_baseline(te)


@pytest.mark.parametrize("S", [1, 8], ids=["decode", "prefill"])
def test_paged_writes_drop_what_the_jax_model_drops(S):
    """The write indices the engine builds on the host put each new token
    where the JAX model's page scatter does, and leave out what its
    mode="drop" drops: pads, -1 table entries, blocks past the table."""
    _, te = engine_pair(page_size=16)
    te._ensure_pool(1)
    ps, NB, B = 16, 3, 4
    P = te._pool["k"].shape[2]
    rng = np.random.default_rng(S)
    table = rng.permutation(P)[:B * NB].reshape(B, NB).astype(np.int32)
    table[1, 1] = table[2, 2] = -1
    pos = np.stack([rng.choice(np.arange(-4, (NB + 1) * ps), S, replace=False)
                    for _ in range(B)]).astype(np.int32)
    pos[1, 0], pos[2, 0] = ps + 3, 2 * ps + 1      # on the -1 entries
    rows, toks, pages, offs = te._paged_cache(table, pos)["writes"].numpy()
    vals = np.arange(1, B * S + 1, dtype=np.float32).reshape(B, S)
    got = np.zeros((P, ps), np.float32)
    got[pages, offs] = vals[rows, toks]
    # the JAX model's scatter (repro/models/model.py, paged branches)
    blk = jnp.clip(pos, 0, None) // ps
    entry = jnp.take_along_axis(jnp.asarray(table), jnp.clip(blk, 0, NB - 1),
                                axis=1)
    page = jnp.where((pos >= 0) & (blk < NB) & (entry >= 0), entry, P)
    want = jnp.zeros((P, ps), jnp.float32).at[
        page, jnp.clip(pos, 0, None) % ps].set(vals, mode="drop")
    np.testing.assert_array_equal(got, np.asarray(want))
    assert 0 < len(rows) < B * S        # some written, some dropped


# ------------------------------ prefix memo -----------------------------------
def test_prefix_memo_lru_cap_and_touch_on_get():
    je, te = engine_pair(kv_layout="dense", prefix_memo_entries=2)
    jg, tg = grammar_pair()
    for eng, g in ((je, jg), (te, tg)):
        def gen(prefix, eng=eng, g=g):
            return eng.generate(["row a"], grammar=g, shared_prefix=prefix,
                                max_new_tokens=12)
        gen("prefix one ")
        gen("prefix two ")
        assert len(eng._prefix_kv) == 2
        # touch "one" (hit), then insert a third: "two" must be the evictee
        assert gen("prefix one ").stats.prefix_hits == 1
        gen("prefix three ")
        assert [k[0] for k in eng._prefix_kv] == ["prefix one ",
                                                   "prefix three "]
        r2 = gen("prefix two ")
        assert r2.stats.prefix_hits == 0 and r2.stats.prefill_tokens > 0
    assert gen_stats(te.total) == gen_stats(je.total)


def test_prefix_memo_eviction_releases_pages():
    je, te = engine_pair(page_size=16, prefix_memo_entries=1,
                   prefix_cache_mode="exact")
    jg, tg = grammar_pair()
    for eng, g in ((je, jg), (te, tg)):
        eng.generate(["row"], grammar=g, shared_prefix=PREFIX,
                     max_new_tokens=8)
        assert eng._alloc.in_use > 0   # prefix pages stay resident
        eng.generate(["row"], grammar=g, shared_prefix="OTHER " + PREFIX,
                     max_new_tokens=8)
        # cap 1: the first prefix's residency was dropped for the second
        ents = list(eng._prefix_kv.values())
        assert len(ents) == 1
        assert eng._alloc.in_use == len(ents[0].pages)
    assert gen_stats(te.total) == gen_stats(je.total)
