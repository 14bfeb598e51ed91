"""The one-device serving step builders of repro_torch against the JAX
package's, and the plain versions of the distribution layer's decode
kernels (a) and (b) against the JAX decode attention.

Same weights (the JAX initializer's, through ``params_from_jax``) and the
same numpy batches, float32 on the CPU:

* ``make_prefill_step(cfg, None, shape)`` against ``repro.launch.steps.
  make_prefill_step(mesh=None)`` for every family that decodes (dense with
  and without q/k/v biases, EP and TP MoE -- mixtral with its sliding
  window 16, which the 24-token prompt overflows --, ssm, hybrid, VLM) and
  the encoder's prefill (no cache): last-position logits and every cache
  tensor; then three ``make_decode_step`` steps from that cache, against
  JAX's decode step, logits and caches after each;
* ``per_row_write`` with ragged ``row_idx`` (each row's own write slot) and
  ``donate_cache=False`` (the caller's cache is left as it was);
* ``banded``: the port runs kernel 1, which skips every tile outside the
  window, so the banded step equals the plain one; against JAX's banded
  step where JAX's band covers every visible key (prompt positions
  ``arange``, a prompt of 2100 tokens: three kv blocks of 1024, the band
  two); and the difference from the reference (ROADMAP queue 3): where a
  row's left pads exceed the band's slack, JAX's band drops visible keys,
  and the port's attention equals JAX's unbanded one;
* kernels (a) and (b)'s plain versions against
  ``repro.models.layers.decode_attention`` (a row with no valid slot
  included: the mean of V), and the lse combine of a cache split over its
  length into four ranks' slot ranges (a row with no valid slot in any
  range too);
* the builders' refusals: ``calibrate=True``, a decode step for the
  encoder;
* ``params_from_jax(specs=, mesh=)``: a rank's shards of the JAX tree, as
  ``mesh.shard_tree`` cuts the whole tree;
* ``launch/dryrun.py``'s serving variant flags: a serving cell's bytes a
  device are the local shapes (``mesh.local_shape``) of the specs that the
  step builders take under the variant.

Tolerances: logits and caches 1e-4 (values of order 1 to 10, sums in
another order; measured within 1e-5), attention 1e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.launch import steps as JST
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.config import ShapeSpec as JShape
from repro_torch.configs import common as CC
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as DRY
from repro_torch.launch import mesh as MS
from repro_torch.launch import steps as ST
from repro_torch.models import model as TM
from repro_torch.models import params as PRM
from repro_torch.models.config import ShapeSpec
from repro_torch.models.params import params_from_jax
from torch_cases import decode_case, t
from torch_cases import one_torch_thread  # noqa: F401

TOL = 1e-4
ATT_TOL = 1e-5
B, S, EXTRA = 4, 24, 8
ARCHS = ("olmo-1b", "qwen2-7b", "qwen3-moe-30b-a3b", "mixtral-8x22b",
         "falcon-mamba-7b", "hymba-1.5b", "paligemma-3b", "hubert-xlarge")


def configs(arch):
    return (JC.get_smoke_config(arch).replace(compute_dtype="float32"),
            TC.get_smoke_config(arch).replace(compute_dtype="float32"))


def prompt(cfg, seed=0, npad=0):
    """The prefill batch of `cfg`: random tokens (or embeddings), positions
    ``arange``, the first `npad` positions of row 0 left pads (-1)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shape, _) in CC.prefill_batch_specs(cfg, B, S).items():
        if k == "tokens":
            out[k] = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        elif k == "positions":
            out[k] = np.broadcast_to(np.arange(shape[1], dtype=np.int32),
                                     shape).copy()
            out[k][0, :npad] = -1
            out[k][0, npad:] -= npad
        else:
            out[k] = rng.standard_normal(shape).astype(np.float32)
    return out


def next_token(cfg, step, positions):
    rng = np.random.default_rng(50 + step)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32),
            "positions": positions.astype(np.int32)[:, None]}


def jnp_tree(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def assert_cache(got, want, what):
    assert set(got) == set(want), (what, set(got), set(want))
    for k, w in want.items():
        g = got[k]
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g.astype(np.float64),
                                   np.asarray(w, np.float64), atol=TOL,
                                   rtol=0, err_msg=f"{what} {k}")


DECODING = ARCHS[:-1]


@functools.lru_cache(maxsize=None)
def pair(arch):
    jcfg, cfg = configs(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
    return arch, jcfg, cfg, jp, params_from_jax(
        cfg, jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_jax(arch):
    arch, jcfg, cfg, jp, tp = pair(arch)
    batch = prompt(cfg, npad=3)
    jfn, (jspecs, jbatch) = JST.make_prefill_step(
        jcfg, None, JShape("p", S, B, "prefill"), cache_len=S + EXTRA)
    fn, (specs, bspecs) = ST.make_prefill_step(
        cfg, None, ShapeSpec("p", S, B, "prefill"), cache_len=S + EXTRA,
        device="cpu")
    assert set(bspecs) == set(jbatch)
    assert set(specs["layers"]) == set(jspecs["layers"])
    jl, jc = jfn(jp, jnp_tree(batch))
    tl, tc = fn(tp, batch)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    if jc is None:
        assert tc is None and not cfg.supports_decode
    else:
        assert_cache(tc, jc, arch)


def test_encoder_has_no_decode_step():
    _, cfg = configs("hubert-xlarge")
    with pytest.raises(ValueError, match="no decode step"):
        ST.make_decode_step(cfg, None, ShapeSpec("d", S, B, "decode"),
                            device="cpu")


@pytest.mark.parametrize("arch", DECODING)
def test_prefill_then_decode_chain_matches_jax(arch):
    arch, jcfg, cfg, jp, tp = pair(arch)
    batch = prompt(cfg, npad=3)
    jpre, _ = JST.make_prefill_step(jcfg, None, JShape("p", S, B, "prefill"),
                                    cache_len=S + EXTRA)
    pre, _ = ST.make_prefill_step(cfg, None, ShapeSpec("p", S, B, "prefill"),
                                  cache_len=S + EXTRA, device="cpu")
    _, jc = jpre(jp, jnp_tree(batch))
    _, tc = pre(tp, batch)
    jdec, (_, _, jcs) = JST.make_decode_step(
        jcfg, None, JShape("d", S + EXTRA, B, "decode"))
    dec, (_, _, cs) = ST.make_decode_step(
        cfg, None, ShapeSpec("d", S + EXTRA, B, "decode"), device="cpu")
    assert set(cs) | {"idx"} == set(jcs)
    pos = batch["positions"][:, -1] + 1
    if cfg.family == "vlm":
        pos = pos + cfg.num_prefix_tokens
    for step in range(3):
        b = next_token(cfg, step, pos + step)
        jl, jc = jdec(jp, jnp_tree(b), jc)
        tl, tc = dec(tp, b, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=0, err_msg=f"{arch} step {step}")
        assert_cache(tc, jc, f"{arch} step {step}")


@pytest.mark.parametrize("arch", DECODING)
def test_per_row_write_ragged_rows_match_jax(arch):
    """Each row writes its own slot (row_idx % lc): rows at fills 5, 9, 14
    and 20 of a 32-slot cache (mixtral's 16-slot window ring wraps)."""
    arch, jcfg, cfg, jp, tp = pair(arch)
    L = S + EXTRA
    jcache = jax.tree.map(np.asarray, JM.init_cache(jcfg, B, L,
                                                    include_row_idx=True))
    rng = np.random.default_rng(7)
    fills = np.array([5, 9, 14, 20], np.int32)
    for k in ("k", "v", "conv", "h"):
        if k in jcache:
            jcache[k] = rng.standard_normal(jcache[k].shape).astype(
                jcache[k].dtype)
    if "slot_pos" in jcache:           # a ring of lc slots: p at p % lc
        lc = jcache["slot_pos"].shape[1]
        sp = np.full((B, lc), -1, np.int32)
        for b, fill in enumerate(fills):
            for p in range(max(0, fill - lc), fill):
                sp[b, p % lc] = p
        jcache["slot_pos"] = sp
    jcache["row_idx"] = fills
    jcache["idx"] = np.int32(0)
    cache = {k: v if k == "idx" else torch.from_numpy(np.array(v))
             for k, v in jcache.items()}
    cache["idx"] = 0
    jdec, _ = JST.make_decode_step(jcfg, None, JShape("d", L, B, "decode"),
                                   per_row_write=True)
    dec, (_, _, cs) = ST.make_decode_step(
        cfg, None, ShapeSpec("d", L, B, "decode"), per_row_write=True,
        device="cpu")
    assert "row_idx" in cs
    for step in range(2):
        b = next_token(cfg, step, fills + step)
        jl, jcache = jdec(jp, jnp_tree(b), jcache)
        tl, cache = dec(tp, b, cache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=0)
        assert_cache(cache, jcache, f"{arch} per-row step {step}")
    np.testing.assert_array_equal(cache["row_idx"].numpy(), fills + 2)


@pytest.mark.parametrize("arch", DECODING)
def test_donate_cache_false_leaves_the_cache(arch):
    arch, jcfg, cfg, jp, tp = pair(arch)
    pre, _ = ST.make_prefill_step(cfg, None, ShapeSpec("p", S, B, "prefill"),
                                  cache_len=S + EXTRA, device="cpu")
    _, cache = pre(tp, prompt(cfg))
    before = {k: v.clone() if isinstance(v, torch.Tensor) else v
              for k, v in cache.items()}
    kept, _ = ST.make_decode_step(cfg, None, ShapeSpec("d", S + EXTRA, B,
                                                       "decode"),
                                  donate_cache=False, device="cpu")
    donated, _ = ST.make_decode_step(cfg, None, ShapeSpec("d", S + EXTRA, B,
                                                          "decode"),
                                     device="cpu")
    b = next_token(cfg, 0, prompt(cfg)["positions"][:, -1] + 1
                   + cfg.num_prefix_tokens)
    l1, c1 = kept(tp, b, cache)
    for k, v in before.items():
        assert (torch.equal(cache[k], v) if isinstance(v, torch.Tensor)
                else cache[k] == v), k
    l2, c2 = donated(tp, b, cache)
    assert torch.equal(l1, l2)
    assert c2["idx"] == c1["idx"] == before["idx"] + 1
    if "k" in c2:
        assert c2["k"] is cache["k"]          # written in place
        assert not torch.equal(cache["k"], before["k"])


def test_calibrate_is_refused():
    _, cfg = configs("olmo-1b")
    for build in (ST.make_prefill_step, ST.make_decode_step):
        with pytest.raises(NotImplementedError, match="cost-analysis"):
            build(cfg, None, ShapeSpec("x", S, B, "prefill"), calibrate=True,
                  device="cpu")


# ---------------------------------- banded ------------------------------------
BAND_S = 2100


def test_banded_prefill_matches_jax_banded_where_the_band_covers():
    """mixtral's smoke config (window 16) over a 2100-token prompt, B 2,
    one layer: JAX's band runs 2 of the 3 kv blocks of each q block, the
    port's kernel skips the out-of-window tiles; positions arange."""
    jcfg, cfg = configs("mixtral-8x22b")
    jcfg, cfg = (c.replace(num_layers=1) for c in (jcfg, cfg))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(5))
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, BAND_S)).astype(
        np.int32), "positions": np.tile(np.arange(BAND_S, dtype=np.int32),
                                        (2, 1))}
    out = {}
    for banded in (False, True):
        jfn, _ = JST.make_prefill_step(jcfg, None,
                                       JShape("p", BAND_S, 2, "prefill"),
                                       banded=banded)
        fn, _ = ST.make_prefill_step(cfg, None,
                                     ShapeSpec("p", BAND_S, 2, "prefill"),
                                     banded=banded, device="cpu")
        out[banded] = (jfn(jp, jnp_tree(batch)), fn(tp, batch))
    (jl, jc), (tl, tc) = out[True]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    assert_cache(tc, jc, "banded")
    assert torch.equal(out[False][1][0], tl)


def _band_case(npad):
    """q/k/v of 2 rows of 2560 tokens, 1 head of 8, window 16; row 0 has
    `npad` left pads."""
    rng = np.random.default_rng(4)
    n = 2560
    q, k, v = (rng.standard_normal((2, n, 1, 8)).astype(np.float32)
               for _ in range(3))
    pos = np.tile(np.arange(n, dtype=np.int32), (2, 1))
    pos[0, :npad] = -1
    pos[0, npad:] -= npad
    return q, k, v, pos


def test_jax_band_drops_visible_keys_past_a_kv_block_of_pads():
    """ROADMAP queue 3: JAX's band starts at the least query position of a
    512-query block over the whole batch and runs ceil((window + 512) /
    1024) + 1 = 2 kv blocks of 1024.  With 1100 left pads in row 0, the
    last query block's least position is 948: the band is keys 0..2047,
    and row 1's queries 2048..2559 lose every key they can see.  The
    port's attention (what its banded step runs) equals JAX's unbanded
    one; JAX's banded one is off by the measured gap."""
    q, k, v, pos = _band_case(1100)
    want = np.asarray(JL.flash_attention(*map(jnp.asarray, (q, k, v, pos,
                                                             pos)),
                                         window=16))
    band = np.asarray(JL.flash_attention(*map(jnp.asarray, (q, k, v, pos,
                                                             pos)),
                                         window=16, banded=True))
    mine = ops.flash_attention(*map(torch.from_numpy, (q, k, v, pos, pos)),
                               window=16).numpy()
    np.testing.assert_allclose(mine, want, atol=ATT_TOL, rtol=0)
    gap = np.abs(band - want)
    assert gap[1, 2048:].min() > 0 and gap[1, 2048:].max() > 0.5
    np.testing.assert_allclose(band[1, :2048], want[1, :2048], atol=ATT_TOL)
    # without pads JAX's band covers every visible key
    q, k, v, pos = _band_case(0)
    np.testing.assert_allclose(
        np.asarray(JL.flash_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                      window=16, banded=True)),
        np.asarray(JL.flash_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                      window=16)), atol=ATT_TOL)


# ----------------------------- kernels (a) and (b) -----------------------------
RANK_CASES = {"gqa6": (4, 48, 8, 16, 40), "gqa1": (3, 4, 4, 16, 33),
              "gqa16": (2, 16, 1, 32, 64)}


def _case(name, seed):
    B_, H, KV, D, L = RANK_CASES[name]
    q, kc, vc, spos, qpos = decode_case(seed, B_, H, KV, D, L)
    spos[-1] = -1                          # a row with no valid slot
    return q, kc, vc, spos, qpos


def _jax_decode(q, kc, vc, spos, qpos):
    return np.asarray(JL.decode_attention(*map(jnp.asarray,
                                               (q, kc, vc, spos, qpos))))


@pytest.mark.parametrize("name", list(RANK_CASES))
def test_decode_lse_plain_matches_jax(name):
    q, kc, vc, spos, qpos = _case(name, 11)
    out, lse = ops.decode_attention_lse(*map(t, (q, kc, vc, spos, qpos)))
    np.testing.assert_allclose(out.numpy(), _jax_decode(q, kc, vc, spos,
                                                        qpos),
                               atol=ATT_TOL, rtol=0)
    Bq, H, D = q.shape
    KV = kc.shape[2]
    s = jnp.einsum("bkgd,blkd->bkgl",
                   jnp.asarray(q).reshape(Bq, KV, H // KV, D) / np.sqrt(D),
                   jnp.asarray(kc))
    ok = (spos >= 0) & (spos <= qpos[:, None])
    want = jax.nn.logsumexp(jnp.where(jnp.asarray(ok)[:, None, None], s,
                                      -jnp.inf), axis=-1).reshape(Bq, H)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-6)
    assert np.isneginf(lse[-1].numpy()).all()


def _hd_split(q, kc, vc, spos, qpos, cols, slots):
    """Kernel (b)'s plain versions over head_dim slices `cols` and slot
    ranges `slots`: each range's partial scores summed over the slices;
    with one range (b)'s output launch on each slice, else each range's
    output with its lse (the output launch's second result), merged over
    the ranges by the lse combine; the slices concatenated."""
    D = q.shape[-1]

    def part(x, sl, c):
        return t(np.ascontiguousarray(x[:, sl][..., c]))
    outs = []
    for c in cols:
        parts = []
        for sl in slots:
            scores = sum(ops.decode_attention_hd_scores(
                t(np.ascontiguousarray(q[..., cc])), part(kc, sl, cc),
                1 / np.sqrt(D)) for cc in cols)
            args = (scores, part(vc, sl, c),
                    t(np.ascontiguousarray(spos[:, sl])), t(qpos))
            parts.append(ops.decode_attention_hd_out(*args))
        outs.append(parts[0][0] if len(slots) == 1 else
                    TM._combine_slot_splits(_Slots(parts), *parts[0]))
    return torch.cat(outs, -1)


@pytest.mark.parametrize("name", list(RANK_CASES))
@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("slot_ranks", [1, 2])
def test_decode_hd_plain_matches_jax(name, ranks, slot_ranks):
    """The head_dim split over `ranks`: each rank's partial scores, their
    sum, each rank's softmax and P.V columns, concatenated; with
    `slot_ranks` 2 the slots split too (JAX's batch-1 hd layout: slots
    over `data`, head_dim over `model`), each slot range's output and lse
    merged.  Row -1 has no valid slot on any rank."""
    q, kc, vc, spos, qpos = _case(name, 12)
    D, L = q.shape[-1], kc.shape[1] // slot_ranks * slot_ranks
    kc, vc, spos = kc[:, :L], vc[:, :L], spos[:, :L]
    n, m = D // ranks, L // slot_ranks
    out = _hd_split(q, kc, vc, spos, qpos,
                    [slice(r * n, (r + 1) * n) for r in range(ranks)],
                    [slice(r * m, (r + 1) * m) for r in range(slot_ranks)])
    np.testing.assert_allclose(out.numpy(), _jax_decode(q, kc, vc, spos,
                                                        qpos),
                               atol=ATT_TOL, rtol=0)


class _Slots:
    """A stand-in for ServeShards' slot split over `n` ranks: all_gather
    returns every rank's part, as the mesh's would."""

    def __init__(self, parts):
        self.slot_axes = ("model",)
        self.parts = parts
        self.mesh = self

    def all_gather(self, x, dim, axes):
        i = 0 if x.dim() == 4 else 1
        return torch.stack([p[i] for p in self.parts])


@pytest.mark.parametrize("name", list(RANK_CASES))
@pytest.mark.parametrize("kernel", ["a", "b"])
def test_slot_split_combine_matches_jax(name, kernel):
    """A cache of L slots over 4 ranks' ranges (L rounded down to a
    multiple of 4): each range through kernel (a)'s plain version, or
    through (b)'s over two head_dim slices (the output launch with each
    head's lse, whose lse is JAX's log-sum-exp of the range's scores),
    merged by the lse combine; row -1 has no valid slot anywhere (the mean
    of V over every slot), and a rank whose range has no valid slot weighs
    0."""
    q, kc, vc, spos, qpos = _case(name, 13)
    L = kc.shape[1] // 4 * 4
    kc, vc, spos = kc[:, :L], vc[:, :L], spos[:, :L]
    n = L // 4
    ranges = [slice(r * n, (r + 1) * n) for r in range(4)]
    if kernel == "a":
        parts = [ops.decode_attention_lse(
            t(q), t(np.ascontiguousarray(kc[:, sl])),
            t(np.ascontiguousarray(vc[:, sl])),
            t(np.ascontiguousarray(spos[:, sl])), t(qpos)) for sl in ranges]
        out = TM._combine_slot_splits(_Slots(parts), *parts[0])
    else:
        D = q.shape[-1]
        out = _hd_split(q, kc, vc, spos, qpos,
                        [slice(0, D // 2), slice(D // 2, D)], ranges)
        Bq, H, _ = q.shape
        KV = kc.shape[2]
        for sl in ranges:
            scores = ops.decode_attention_hd_scores(
                t(q), t(np.ascontiguousarray(kc[:, sl])), 1 / np.sqrt(D))
            _, lse = ops.decode_attention_hd_out(
                scores, t(np.ascontiguousarray(vc[:, sl])),
                t(np.ascontiguousarray(spos[:, sl])), t(qpos))
            s = jnp.einsum("bkgd,blkd->bkgl", jnp.asarray(q).reshape(
                Bq, KV, H // KV, D) / np.sqrt(D), jnp.asarray(kc[:, sl]))
            ok = (spos[:, sl] >= 0) & (spos[:, sl] <= qpos[:, None])
            want = jax.nn.logsumexp(jnp.where(jnp.asarray(ok)[:, None, None],
                                              s, -jnp.inf), axis=-1)
            np.testing.assert_allclose(lse.numpy(),
                                       np.asarray(want).reshape(Bq, H),
                                       atol=1e-5, rtol=1e-6)
            assert np.isneginf(lse[-1].numpy()).all()
    np.testing.assert_allclose(out.numpy(), _jax_decode(q, kc, vc, spos,
                                                        qpos),
                               atol=ATT_TOL, rtol=0)


# ------------------------------- shards, dry run -------------------------------
class _Rank:
    """A rank of a (data 2, model 2) mesh, as the rules and local_shard
    read one."""

    def __init__(self, coords):
        self.shape = {"data": 2, "model": 2}
        self.axis_names = ("data", "model")
        self.coords = coords
        self.device = torch.device("cpu")

    def local(self, full, spec):
        return MS.local_shard(full, spec, self, self.coords).clone()


@pytest.mark.parametrize("coords", [{"data": 0, "model": 1},
                                    {"data": 1, "model": 0}])
def test_params_from_jax_gives_a_rank_its_shards(coords):
    jcfg, cfg = configs("mixtral-8x22b")
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(9)))
    rank = _Rank(coords)
    specs = MS.param_pspecs(cfg, rank, attn_mode="hd", resident=True,
                            fsdp=False)
    mine = params_from_jax(cfg, tree, "cpu", specs=specs, mesh=rank)
    want = MS.shard_tree(rank, params_from_jax(cfg, tree, "cpu"), specs)
    for name, leaf in want["layers"].items():
        assert torch.equal(mine["layers"][name], leaf), name
    for name in ("embed", "lm_head", "final_norm.scale"):
        assert torch.equal(mine[name], want[name]), name


DRY_VARIANTS = [dict(cache_shard="lc", per_row_write=True),
                dict(cache_shard="kv"), dict(cache_shard="none"),
                dict(resident=True), dict(resident=True, cache_shard="lc"),
                dict(seq_parallel=True), dict(no_fsdp=True),
                dict(serve_bf16=True, banded=True)]


@pytest.mark.parametrize("variant", DRY_VARIANTS,
                         ids=["-".join(f"{k}={v}" for k, v in d.items())
                              for d in DRY_VARIANTS])
def test_dryrun_serving_variants_are_the_local_shards(variant):
    mesh = MS.make_production_mesh()
    v = dict(DRY.VARIANT, **variant)
    moved = 0
    for arch, shape, _, _ in TC.cells():
        if shape.kind == "train":
            continue
        cfg = TC.get_config(arch)
        if shape.kind == "prefill":
            pspecs = MS.param_pspecs_zero3(cfg, mesh) if v["seq_parallel"] \
                else MS.param_pspecs(cfg, mesh, fsdp=not v["no_fsdp"])
            mode, prw = "hd", False
        else:
            mode, prw = v["cache_shard"], v["per_row_write"]
            pspecs = MS.param_pspecs(
                cfg, mesh, fsdp=not v["resident"],
                attn_mode=ST.decode_attn_mode(cfg, mode),
                resident=v["resident"])
        want = 0
        for name, (shp, _) in [*PRM.param_specs(cfg)["layers"].items(),
                               *((k, x) for k, x in
                                 PRM.param_specs(cfg).items()
                                 if k != "layers")]:
            spec = pspecs["layers"][name] if name in pspecs["layers"] \
                else pspecs[name]
            want += int(np.prod(MS.local_shape(shp, spec, mesh))) * \
                PRM._dtype(cfg, name).itemsize
        if cfg.supports_decode:
            cache = TM.cache_specs(cfg, shape.global_batch, shape.seq_len,
                                   include_row_idx=prw)
            cps = MS.cache_pspecs(cfg, mesh, cache, shard_mode=mode)
            want += sum(int(np.prod(MS.local_shape(s, cps[k], mesh)))
                        * dt.itemsize for k, (s, dt) in cache.items())
        rec = DRY.cell(arch, shape.name, mesh, variant)
        assert rec["bytes_per_device"] == want, (arch, shape.name)
        assert rec["variant"] == v
        moved += rec["bytes_per_device"] != DRY.cell(
            arch, shape.name, mesh)["bytes_per_device"]
    # the weight layouts that differ from the default move bytes
    if any(variant.get(k) for k in ("resident", "seq_parallel", "no_fsdp")):
        assert moved > 0
