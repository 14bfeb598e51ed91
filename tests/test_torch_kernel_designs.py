"""The arithmetic of two Hopper kernel designs, written out as plain torch
and held against the JAX package on the same numpy inputs (float32, CPU).

* ``chunked_scan``: the prefill of ``kernels/csrc/selective_scan.cu`` --
  time cut into T chunks; pass 1 scans each chunk from a zero state (chunk
  0 from h0, writing y) and keeps its end state and its sum of dt; the
  carries combine in order as H_k = exp(A * sum dt_k) * H_{k-1} + h_k; pass
  2 reruns each chunk k >= 1 from H_{k-1} and writes y.  Held against the
  Pallas kernel in interpret mode (from zeros, at shapes its asserts take)
  and the sequential oracle from a non-zero state at ragged lengths.
  Tolerance 1e-5: the chunk carry takes one exponential of a sum where the
  oracle multiplies per-step exponentials, and exp2 of a pre-scaled A.
* ``split_paged_decode``: the paged decode of
  ``kernels/csrc/decode_attention_paged.cu``, A (fp pages) and B (int8
  frozen pages) -- each row's slots cut into 32-slot tiles, S splits
  owning contiguous tile ranges computed from the row's qpos, each split's
  tiles with a valid slot dealt to W warps in list order (A's two-stage
  ring loads a warp's next tile early but computes its tiles in the same
  order), each warp's online softmax (m, l, acc) over its tiles, the
  warps' partials merged per split and the splits' in rank order; a row
  with no valid token makes every slot of its table (clamped to the pool)
  score 0.  Held against the Pallas kernels in interpret mode (on rows
  without a -1 below the fill and with a valid token: its wrapper rewrites
  the others, ROADMAP queue 3) and against the jnp function the SQL engine
  runs and the port's plain version, with such holes and with idle rows.
  Tolerance 2e-5 (sums in another order), as tests/test_torch_paged.py.
* ``split_heads_dkdv``: the dK/dV launch of
  ``kernels/csrc/flash_attention_bwd.cu`` -- a kv head's G query heads
  split over S blocks of a cluster, block r summing the partial dk and dv
  of heads [r G / S, (r + 1) G / S), the partials added in rank order.
  Held against ``jax.vjp`` of the JAX package's ``flash_attention`` with
  left pads (rows with no visible key), prefix-LM, window and kv longer
  than q, for S 1 to 8 and G up to 8.  Tolerance 2e-5, as
  tests/test_torch_flash_bwd.py.
* ``tile_class``: the same kernel's classes of a (query tile, key tile)
  pair from the tiles' position ranges -- dead (skipped), full (no mask)
  or partial -- held against ``layers._block_mask`` on random positions
  with pads, offsets, windows and prefixes: every pair of a full tile is
  visible, and a dead tile has no visible pair and no row without a
  visible key.
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JOPS
from repro.kernels.selective_scan import selective_scan_pallas
from repro.models import layers as JL
from repro.models import mamba as JMB
from repro_torch.kernels import ref
from test_torch_cuda import paged_scenario
from test_torch_flash_bwd import jax_vjp
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_cases import (MASKS, paged_case, prefill_case, quantize_pool,
                         scan_case, t as _t)

LOG2E = 1.4426950408889634
SCAN_TOL = 1e-5
PAGED_TOL = 2e-5
TILE = 32


# ------------------------------- selective scan -------------------------------
def chunked_scan(u, dt, A, B, C, D, h0, T):
    """selective_scan.cu's prefill over T chunks of ceil(S / T) steps."""
    Bz, S, Di = u.shape
    L = -(-S // T)
    a2 = A * LOG2E
    bounds = [(min(S, k * L), min(S, k * L + L)) for k in range(T)]
    y = torch.zeros(Bz, S, Di)
    scratch = torch.zeros(Bz, S, Di)

    def steps(h, t0, t1, out):
        dsum = torch.zeros(Bz, Di)
        for t in range(t0, t1):
            h = (torch.exp2(dt[:, t, :, None] * a2) * h
                 + (dt[:, t] * u[:, t])[..., None] * B[:, t, None, :])
            out[:, t] = (h * C[:, t, None, :]).sum(-1) + D * u[:, t]
            dsum = dsum + dt[:, t]
        return h, dsum

    zero = torch.zeros(Bz, Di, A.shape[1])
    h_first, _ = steps(zero if h0 is None else h0, *bounds[0], y)   # pass 1
    carries = [steps(zero, *bounds[k], scratch) for k in range(1, T - 1)]
    H = [h_first]                                                   # combine
    for hk, sk in carries:
        H.append(torch.exp2(a2 * sk[..., None]) * H[-1] + hk)
    final = h_first
    for k in range(1, T):                                           # pass 2
        final, _ = steps(H[k - 1], *bounds[k], y)
    return y, final


@pytest.mark.parametrize("T", [1, 2, 4, 8])
def test_chunked_scan_matches_pallas_from_zeros(T):
    u, dt, A, B, C, D, _ = scan_case(40 + T, 2, 48, 16, 8)
    y, h = chunked_scan(*map(_t, (u, dt, A, B, C, D)), None, T)
    py, ph = selective_scan_pallas(*(jnp.asarray(a) for a in
                                     (u, dt, A, B, C, D)),
                                   chunk=16, block_d=8, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(py), atol=SCAN_TOL,
                               rtol=SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(ph), atol=SCAN_TOL,
                               rtol=SCAN_TOL)


@pytest.mark.parametrize("T", [1, 2, 4, 8])
@pytest.mark.parametrize("S", [5, 33, 64])
def test_chunked_scan_from_a_state_matches_jax_oracle(S, T):
    """Ragged lengths (S = 5 at T = 8 leaves the last chunks empty)."""
    u, dt, A, B, C, D, h0 = scan_case(50 + S + T, 2, S, 24, 16)
    y, h = chunked_scan(*map(_t, (u, dt, A, B, C, D, h0)), T)
    wy, wh = JMB.selective_scan_ref(*(jnp.asarray(a) for a in
                                      (u, dt, A, B, C, D, h0)))
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=SCAN_TOL,
                               rtol=SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(wh), atol=SCAN_TOL,
                               rtol=SCAN_TOL)


# ------------------------------ int8 paged decode -----------------------------
def _merge(states):
    """(m, l, acc) partials, merged in order; an empty one (m = -inf) has
    weight 0."""
    M = torch.stack([m for m, _, _ in states]).amax(0)
    lt = torch.zeros_like(M)
    x = torch.zeros_like(states[0][2])
    for m, l, acc in states:
        w = torch.where(m == -math.inf, torch.zeros_like(m),
                        torch.exp(m - M))
        lt = lt + l * w
        x = x + acc * w[:, None]
    return M, lt, x


def split_paged_decode(q, kp, vp, table, qpos, quant, S, W=4):
    """decode_attention_paged.cu's kernel with S splits of W warps: A when
    `quant` is None, else B over its int8 frozen pages."""
    Bn, H, D = q.shape
    KV, P, ps, _ = kp.shape
    NB = table.shape[1]
    G = H // KV
    kd, vd = kp, vp
    if quant is not None:
        fr = (quant["flags"] > 0)[None, :, None, None]
        kd = torch.where(fr, quant["kq"].float()
                         * quant["kscale"][..., None, None], kp)
        vd = torch.where(fr, quant["vq"].float()
                         * quant["vscale"][..., None, None], vp)
    out = torch.empty(Bn, H, D)
    for b in range(Bn):
        qp = int(qpos[b])
        nblk = 0 if qp < 0 else min(NB, qp // ps + 1)
        row = table[b].long()
        uniform = not bool(((row[:nblk] >= 0) & (row[:nblk] < P)).any())
        if uniform:
            row = row.clamp(0, P - 1)
        nslots = NB * ps if uniform else min(NB * ps, qp + 1)
        slot = torch.arange(nslots)
        page = row[slot // ps]
        valid = (page >= 0) & (page < P)
        pg = page.clamp(0, P - 1)
        K = torch.where(valid[None, :, None], kd[:, pg, slot % ps], 0.0)
        V = torch.where(valid[None, :, None], vd[:, pg, slot % ps], 0.0)
        row_tiles = -(-nslots // TILE)
        tps = -(-row_tiles // S)
        for kv in range(KV):
            qg = q[b, kv * G:(kv + 1) * G]
            splits = []
            for rank in range(S):
                lo = min(row_tiles, rank * tps)
                hi = min(row_tiles, lo + tps)
                live = [t for t in range(lo, hi)
                        if valid[t * TILE:(t + 1) * TILE].any()]
                warps = []
                for w in range(W):
                    m = torch.full((G,), -math.inf)
                    l, acc = torch.zeros(G), torch.zeros(G, D)
                    for t in live[w::W]:
                        sl = slice(t * TILE, min(nslots, (t + 1) * TILE))
                        s = (torch.zeros(G, sl.stop - sl.start) if uniform
                             else qg @ K[kv, sl].T / math.sqrt(D))
                        s = torch.where(valid[sl][None], s, -math.inf)
                        m_new = torch.maximum(m, s.amax(-1))
                        p = torch.exp(s - m_new[:, None])
                        corr = torch.exp(m - m_new)
                        l = l * corr + p.sum(-1)
                        acc = acc * corr[:, None] + p @ V[kv, sl]
                        m = m_new
                    warps.append((m, l, acc))
                splits.append(_merge(warps))
            _, lt, x = _merge(splits)
            out[b, kv * G:(kv + 1) * G] = x / lt[:, None]
    return out


def _quant(kp, vp, frozen_every):
    kq, ks, flags = quantize_pool(kp, frozen_every or 1)
    vq, vs, _ = quantize_pool(vp, frozen_every or 1)
    if frozen_every is None:
        flags[:] = 0
    return kq, vq, ks, vs, flags


def _pad(pool, dp=128):
    """The JAX pool layout: head_dim zero-padded to the 128-lane width."""
    return np.pad(pool, [(0, 0)] * (pool.ndim - 1)
                  + [(0, dp - pool.shape[-1])])


def _jax_args(q, kp, vp, table, qpos, kq, vq, ks, vs, flags):
    args = (jnp.asarray(q), jnp.asarray(_pad(kp)), jnp.asarray(_pad(vp)),
            jnp.asarray(table), jnp.asarray(qpos))
    jq = {"kq": jnp.asarray(_pad(kq)), "vq": jnp.asarray(_pad(vq)),
          "kscale": jnp.asarray(ks), "vscale": jnp.asarray(vs),
          "flags": jnp.asarray(flags)}
    return args, jq


FROZEN = {"none": None, "mixed": 2, "all": 1}


@pytest.mark.parametrize("frozen", list(FROZEN))
@pytest.mark.parametrize("S", [1, 8])
def test_split_paged_decode_matches_pallas(S, frozen):
    """Ragged fills, a shared prefix page, decode pages allocated ahead or
    -1 past the fill; pages of 16, so a 32-slot tile spans two pages."""
    q, kp, vp, table, qpos = paged_case(60 + S, B=4, H=8, KV=2, D=32, ps=16,
                                        NB=6, P=30, shared=1)
    kq, vq, ks, vs, flags = _quant(kp, vp, FROZEN[frozen])
    quant = {"kq": _t(kq), "vq": _t(vq), "kscale": _t(ks),
             "vscale": _t(vs), "flags": _t(flags)}
    out = split_paged_decode(*map(_t, (q, kp, vp, table, qpos)), quant, S)
    args, jq = _jax_args(q, kp, vp, table, qpos, kq, vq, ks, vs, flags)
    pallas = JOPS.decode_attention_paged(*args, head_dim=32, quant=jq,
                                         interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas),
                               atol=PAGED_TOL, rtol=PAGED_TOL)


@pytest.mark.parametrize("frozen", list(FROZEN))
@pytest.mark.parametrize("S", [1, 2, 4, 8])
@pytest.mark.parametrize("layout", ["rows", "wide"])
def test_split_paged_decode_holes_and_idle_rows(layout, S, frozen):
    """paged_scenario's rows (an idle row, page-edge fills, a hole below
    the fill, qpos -1 over real pages; pages of 128 split 8 ways) against
    the jnp function of the SQL path and the port's plain version."""
    q, kp, vp, table, qpos = paged_scenario(70, 8, 2, 32, layout)
    kq, vq, ks, vs, flags = _quant(kp, vp, FROZEN[frozen])
    quant = {"kq": _t(kq), "vq": _t(vq), "kscale": _t(ks),
             "vscale": _t(vs), "flags": _t(flags)}
    tq, tkp, tvp, ttab, tqpos = map(_t, (q, kp, vp, table, qpos))
    out = split_paged_decode(tq, tkp, tvp, ttab, tqpos, quant, S)
    args, jq = _jax_args(q, kp, vp, table, qpos, kq, vq, ks, vs, flags)
    jnp_out = JL.decode_attention_paged(*args, head_dim=32, quant=jq)
    np.testing.assert_allclose(out.numpy(), np.asarray(jnp_out),
                               atol=PAGED_TOL, rtol=PAGED_TOL)
    plain = ref.decode_attention_paged_ref(tq, tkp, tvp, ttab, tqpos, quant)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=PAGED_TOL,
                               rtol=PAGED_TOL)


# ------------------------------- fp paged decode -------------------------------
def _pallas_rows(table, qpos, ps):
    """The rows the Pallas wrapper takes as they are: a valid token, and no
    -1 entry below the fill."""
    nblk = np.where(qpos < 0, 0, np.minimum(table.shape[1], qpos // ps + 1))
    return np.array([q >= 0 and (table[b, :n] >= 0).all()
                     for b, (q, n) in enumerate(zip(qpos, nblk))])


@functools.lru_cache(maxsize=None)
def _fp_scenario(layout):
    """paged_scenario's case with the JAX package's three answers: the jnp
    function of the SQL path, the Pallas kernel in interpret mode and the
    port's plain version."""
    q, kp, vp, table, qpos = paged_scenario(80, 8, 2, 32, layout)
    args = (jnp.asarray(q), jnp.asarray(_pad(kp)), jnp.asarray(_pad(vp)),
            jnp.asarray(table), jnp.asarray(qpos))
    jnp_out = np.asarray(JL.decode_attention_paged(*args, head_dim=32))
    pallas = np.asarray(JOPS.decode_attention_paged(*args, head_dim=32,
                                                    interpret=True))
    plain = ref.decode_attention_paged_ref(
        *map(_t, (q, kp, vp, table, qpos))).numpy()
    return (q, kp, vp, table, qpos), jnp_out, pallas, plain


@pytest.mark.parametrize("W", [1, 3, 4])
@pytest.mark.parametrize("S", [1, 2, 4, 8])
@pytest.mark.parametrize("layout", ["rows", "wide"])
def test_split_paged_decode_fp_matches_jax(layout, S, W):
    """Kernel A's split (W 3 is its choice at olmo-1b's shapes) over
    paged_scenario's rows: an idle row, page-edge fills, a hole below the
    fill, qpos -1 over real pages; pages of 128 split 8 ways."""
    case, jnp_out, pallas, plain = _fp_scenario(layout)
    out = split_paged_decode(*map(_t, case), None, S, W).numpy()
    np.testing.assert_allclose(out, jnp_out, atol=PAGED_TOL, rtol=PAGED_TOL)
    np.testing.assert_allclose(out, plain, atol=PAGED_TOL, rtol=PAGED_TOL)
    rows = _pallas_rows(case[3], case[4], case[1].shape[2])
    assert rows.sum() >= 2
    np.testing.assert_allclose(out[rows], pallas[rows], atol=PAGED_TOL,
                               rtol=PAGED_TOL)


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_split_paged_decode_fp_ragged_matches_pallas(S):
    """Ragged fills over a shared prefix page, pages of 16 (a 32-slot tile
    spans two pages), decode pages allocated ahead or -1 past the fill:
    every row as the Pallas kernel computes it."""
    q, kp, vp, table, qpos = paged_case(90 + S, B=4, H=8, KV=2, D=32, ps=16,
                                        NB=6, P=30, shared=1)
    out = split_paged_decode(*map(_t, (q, kp, vp, table, qpos)), None, S, 3)
    args = (jnp.asarray(q), jnp.asarray(_pad(kp)), jnp.asarray(_pad(vp)),
            jnp.asarray(table), jnp.asarray(qpos))
    pallas = JOPS.decode_attention_paged(*args, head_dim=32, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas),
                               atol=PAGED_TOL, rtol=PAGED_TOL)


# ------------------------------- flash backward -------------------------------
BWD_TOL = 2e-5
NEG = -1e30


def visible(qp, kp, causal, window, prefix_len):
    """flash_attention_bwd.cu's visible() over broadcast position tensors."""
    present = kp >= 0
    if not causal:
        return present & (qp == qp)
    ok = present & (kp <= qp)
    if window > 0:
        ok = ok & (kp > qp - window)
    if prefix_len > 0:
        ok = ok | (present & (kp < prefix_len))
    return ok


def split_heads_dkdv(q, k, v, qpos, kpos, out, lse, g, S, causal=True,
                     window=0, prefix_len=0):
    """The dK/dV launch over S splits of each kv head's G query heads: P =
    exp(S scale - lse) with masked scores -1e30, dS = P (dP - delta), each
    split's partial dk = dS^T (q scale) and dv = P^T dO summed over its
    heads, the S partials added in rank order."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    ok = visible(qpos[:, :, None], kpos[:, None, :], causal, window,
                 prefix_len)[:, None]                        # (B, 1, Sq, Skv)
    delta = (g * out).sum(-1)                                # (B, Sq, H)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for rank in range(S):
        pk, pv = torch.zeros_like(k), torch.zeros_like(v)
        for gh in range(rank * G // S, (rank + 1) * G // S):
            hs = [kv * G + gh for kv in range(KV)]           # one head a kv head
            qh, gh_ = q[:, :, hs], g[:, :, hs]
            s = torch.einsum("bqkd,bjkd->bkqj", qh, k) * scale
            s = torch.where(ok, s, torch.full_like(s, NEG))
            p = torch.exp(s - lse[:, :, hs].permute(0, 2, 1)[..., None])
            dp = torch.einsum("bqkd,bjkd->bkqj", gh_, v)
            ds = p * (dp - delta[:, :, hs].permute(0, 2, 1)[..., None])
            pk = pk + torch.einsum("bkqj,bqkd->bjkd", ds, qh * scale)
            pv = pv + torch.einsum("bkqj,bqkd->bjkd", p, gh_)
        dk, dv = dk + pk, dv + pv                            # rank order
    return dk, dv


#: G 8 on one and on two kv heads, G 5 (uneven splits); left pads, and kv
#: longer than q (an extend-offset prefix of cached keys)
SPLIT_CASES = {
    "g8_pads": dict(B=2, S=24, H=8, KV=1, D=16, npad=5),
    "g8_kv2_prefix": dict(B=1, S=20, H=16, KV=2, D=8, npad=3, prefix=12),
    "g5_pads": dict(B=1, S=18, H=5, KV=1, D=8, npad=4),
}


@functools.lru_cache(maxsize=None)
def _split_case(case, mask):
    q, k, v, qpos, kpos = prefill_case(60, **SPLIT_CASES[case])
    g = np.random.default_rng(61).standard_normal(q.shape, np.float32)
    _, _, _, dk_j, dv_j = jax_vjp(q, k, v, qpos, kpos, g, **MASKS[mask])
    return (q, k, v, qpos, kpos, g), (dk_j, dv_j)


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("case,S", [
    (c, S) for c, sh in SPLIT_CASES.items() for S in (1, 2, 4, 8)
    if S <= sh["H"] // sh["KV"]])   # at most G splits (split::pick_splits)
def test_split_heads_dkdv_matches_jax_vjp(case, S, mask):
    (q, k, v, qpos, kpos, g), (dk_j, dv_j) = _split_case(case, mask)
    q, k, v, qpos, kpos, g = map(_t, (q, k, v, qpos, kpos, g))
    out, lse = ref.flash_attention_fwd_ref(q, k, v, qpos, kpos, **MASKS[mask])
    dk, dv = split_heads_dkdv(q, k, v, qpos, kpos, out, lse, g, S,
                              **MASKS[mask])
    np.testing.assert_allclose(dk.numpy(), dk_j, atol=BWD_TOL, rtol=BWD_TOL)
    np.testing.assert_allclose(dv.numpy(), dv_j, atol=BWD_TOL, rtol=BWD_TOL)


def tile_class(qp, kp, qall, kall, empty, causal, window, prefix_len):
    """flash_attention_bwd.cu's classify(): qp, the positions of a query
    tile's rows in range; kp, the positions of a key tile's keys in range;
    qall / kall, whether the tile is whole (and, for keys, all present);
    empty, whether a row of the query tile has no visible key."""
    qlo, qhi = int(qp.min()), int(qp.max())
    present = kp[kp >= 0]
    kmin = int(present.min()) if len(present) else 2 ** 31 - 1
    kmax = int(kp.max()) if len(kp) else -1
    live = kmax >= 0                                  # tile_live()
    if causal:
        live = live and kmin <= qhi
        if window > 0:
            live = live and kmax > qlo - window
        if prefix_len > 0:
            live = live or (kmax >= 0 and kmin < prefix_len)
    if not (live or empty):
        return "dead"
    if not (qall and kall):
        return "partial"
    full = True
    if causal:
        full = kmax <= qlo and (window <= 0 or kmin > qhi - window)
        if prefix_len > 0:
            full = full or kmax < prefix_len
    return "full" if full else "partial"


TILE_MASKS = {**MASKS, "window_prefix": dict(causal=True, window=5,
                                             prefix_len=6)}


@pytest.mark.parametrize("mask", list(TILE_MASKS))
@pytest.mark.parametrize("seed", range(4))
def test_tile_classes_are_sound(seed, mask):
    """Random positions: left pads and absent keys (-1), an offset, shuffled
    or sorted order, 4-row tiles over ragged lengths."""
    rng = np.random.default_rng(70 + seed)
    T, kw = 4, TILE_MASKS[mask]
    seen = set()
    for _ in range(6):
        Sq, Skv = rng.integers(9, 40), rng.integers(9, 48)
        off = int(rng.integers(0, 12))
        qpos = np.arange(Sq) + off + Skv - Sq
        kpos = np.arange(Skv) + off
        qpos[:rng.integers(0, 6)] = -1
        kpos[rng.random(Skv) < rng.choice([0.0, 0.15])] = -1
        if rng.random() < 0.5:
            rng.shuffle(qpos)
            rng.shuffle(kpos)
        ok = np.asarray(JL._block_mask(jnp.asarray(qpos), jnp.asarray(kpos),
                                       kw["causal"], kw.get("window", 0),
                                       kw.get("prefix_len", 0)))
        empty_row = ~ok.any(1)
        for q0 in range(0, Sq, T):
            for k0 in range(0, Skv, T):
                qs, ks = slice(q0, q0 + T), slice(k0, k0 + T)
                cls = tile_class(qpos[qs], kpos[ks], q0 + T <= Sq,
                                 k0 + T <= Skv and (kpos[ks] >= 0).all(),
                                 bool(empty_row[qs].any()), kw["causal"],
                                 kw.get("window", 0), kw.get("prefix_len", 0))
                seen.add(cls)
                if cls == "full":
                    assert ok[qs, ks].all()
                if cls == "dead":
                    assert not ok[qs, ks].any() and not empty_row[qs].any()
    assert "partial" in seen and len(seen) >= 2  # a skipped or unmasked tile too
