"""The arithmetic of the Hopper kernel designs, written out as plain torch
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
* ``split_decode_lse`` and ``split_hd_out``: kernels (a) and (b)'s second
  launch in ``kernels/csrc/decode_attention.cu`` (kernel 2's body) -- a
  (row, kv head)'s slots cut into S contiguous splits of whole 32-slot
  tiles, each split's tiles with a valid slot dealt to W warps, each warp's
  online softmax for the group's heads (8 at most; more take another
  group) over q . K / sqrt(D) for (a) or the scores summed over the ranks
  for (b), the warps merged per split and the splits in rank order; a row
  with no valid slot in the whole range runs every slot with uniform
  weights (the mean of V) and (a)'s lse is -inf.  Held against JAX's
  ``decode_attention`` over the whole head_dim (b's two ranks' columns put
  together) and over the whole ring (a's two ranks' halves combined by
  ``_combine_slot_splits``' formula), and each rank against the port's
  plain version: S 1 to 8, G 1 to 12, L under a tile and no multiple of
  32, wrapped rings, an empty row and a batch with no valid slot.
  Tolerance 2e-5, as the paged models.  At D 256 the launch runs each row
  over C chunks (one-block clusters) whose records a second launch merges
  (``_merge_chunks``: warp w sums chunks w, w + 8, ... in order, the warps
  added in order): held against the Pallas kernel in interpret mode and
  the plain version at C 2 to 16 (chunks with no tile, a wrapped ring, a
  row with no valid slot).
* ``ws_flash``: kernel 1's warp-specialised body in
  ``kernels/csrc/flash_attention.cu`` (namespace ws) -- 128-row query tiles
  in two 64-row halves, 64-key kv tiles (128 in one case), each (half,
  tile) dead, full or partial from position ranges (``ws_tile_walk``), the
  loader's list of tiles live for either half, each half's online softmax
  in exp2 over its live tiles; a row with no visible key the sum of V over
  empty_div.  Held against the Pallas kernel in interpret mode (blocks of
  128, on rows with a visible key) and the plain forward with its lse, at
  D 256 (8 heads on 1, paligemma-3b's) and D 80 (hubert-xlarge's), causal,
  window, prefix-LM and bidirectional, left pads and a sequence-parallel
  rank's queries.  Tolerance 2e-5; ``test_ws_tile_walk_is_sound`` holds
  the classes to ``layers._block_mask`` as ``tile_class`` below.
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
* ``gmm_bwd_tiles``: the grouped matmul's backward on wgmma in
  ``kernels/csrc/gmm.cu`` -- dx in 128-row tiles of one group (a group
  over 128 rows takes more tiles) by 256 columns of M, the contraction
  over N in 64-deep stages; dw one owner tile of 128 rows of M by 256
  columns of N per expert, the group's rows in order in 64-row stages
  (zeros past the group), an empty expert one stage of zeros; fp32 sums,
  each output rounded once.  Held against ``jax.vjp`` of the JAX block's
  capacity-buffer einsums (``repro/models/moe.py:90-92``): an empty
  expert, a group over the capacity (its dropped rows past the kept ones),
  groups of 1, 127, 128 and 129 rows, M and N past a whole tile.
  Tolerance 1e-5 of each gradient's largest |value| (fp32 sums in another
  order), as tests/test_torch_moe_scan_bwd.py.
* ``chunked_scan_bwd``: the selective scan's backward in
  ``kernels/csrc/selective_scan_bwd.cu`` -- J chunks of ceil(S / J) steps
  from the carries of kernel 7's training launch (``chunked_scan`` with J:
  the state before every chunk's first step, written by whichever pass of
  the forward's own T chunks runs that step from the right state); a
  forward sweep of each chunk keeping P = prod a_t, gamma = sum_t P_t dy_t
  C_t and the state entering each 4-step sub-chunk; the adjoints combined
  in reverse chunk order (Gamma_{j-1} = gamma_j + P_j Gamma_j); each
  chunk's sub-chunks in reverse, their states and decays recomputed from
  the checkpoint and reused by the reverse steps; dA and dD summed over
  (row, chunk) partials in order.  Held against ``jax.vjp`` of
  ``repro.models.mamba.selective_scan`` (the JAX train step's scan) at
  several chunk counts, lengths that are not a multiple of the chunk, and
  N 4 and 16.  Tolerance 1e-5 of each gradient's largest |value|.
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from repro.kernels import ops as JOPS
from repro.kernels.selective_scan import selective_scan_pallas
from repro.models import layers as JL
from repro.models import mamba as JMB
from repro_torch.kernels import ref
from test_torch_cuda import _wrapped_ring, paged_scenario
from test_torch_flash_bwd import jax_vjp
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_cases import (MASKS, decode_case, paged_case, prefill_case,
                         quantize_pool, scan_case, t as _t)

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
SCAN_TOL = 1e-5
PAGED_TOL = 2e-5
TILE = 32


# ------------------------------- selective scan -------------------------------
def chunked_scan(u, dt, A, B, C, D, h0, T, J=None):
    """selective_scan.cu's prefill over T chunks of ceil(S / T) steps; with
    J, its training launch, which also returns the carries (Bz, J, Di, N):
    the state entering each of J chunks of ceil(S / J) steps, taken by the
    passes that write y (the final state for a chunk past S)."""
    Bz, S, Di = u.shape
    L = -(-S // T)
    a2 = A * LOG2E
    bounds = [(min(S, k * L), min(S, k * L + L)) for k in range(T)]
    y = torch.zeros(Bz, S, Di)
    scratch = torch.zeros(Bz, S, Di)
    Lc = -(-S // J) if J else 0
    entering = {}                   # carry chunk -> the state entering it

    def steps(h, t0, t1, out):
        dsum = torch.zeros(Bz, Di)
        for t in range(t0, t1):
            if J and out is y and t % Lc == 0:
                entering[t // Lc] = h
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
    if not J:
        return y, final
    return y, final, torch.stack([entering.get(j, final) for j in range(J)],
                                 dim=1)


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


def chunked_scan_bwd(u, dt, A, B, C, D, carries, dy, sub=4):
    """selective_scan_bwd.cu's four launches over the J chunks of the
    carries: the sweep, the combine, the reverse and the ordered sums."""
    Bz, S, Di = u.shape
    J = carries.shape[1]
    Lc = -(-S // J)
    a2 = A * LOG2E
    dtu = dt * u
    bounds = [(min(S, j * Lc), min(S, j * Lc + Lc)) for j in range(J)]

    def decay(t):
        return torch.exp2(dt[:, t, :, None] * a2)

    def step(h, a, t):
        return a * h + dtu[:, t, :, None] * B[:, t, None, :]

    gam, P, ck = [], [], []                                 # 1. sweep
    for j, (t0, t1) in enumerate(bounds):
        h, p = carries[:, j], torch.ones_like(carries[:, j])
        g = torch.zeros_like(h)
        ck.append({})
        for t in range(t0, t1):
            if (t - t0) % sub == 0:
                ck[j][(t - t0) // sub] = h
            a = decay(t)
            h = step(h, a, t)
            p = p * a
            g = g + p * (dy[:, t, :, None] * C[:, t, None, :])
        gam.append(g)
        P.append(p)
    Gam, G = [None] * J, torch.zeros_like(carries[:, 0])   # 2. combine
    for j in reversed(range(J)):
        Gam[j] = G
        G = gam[j] + P[j] * G
    du, ddt = torch.zeros_like(u), torch.zeros_like(dt)     # 3. reverse
    dB, dC = torch.zeros_like(B), torch.zeros_like(C)
    part_a = torch.zeros(Bz, J, *A.shape)
    part_d = torch.zeros(Bz, J, Di)
    for j, (t0, t1) in enumerate(bounds):
        G = Gam[j]
        for s in reversed(range(-(-(t1 - t0) // sub))):
            ts = t0 + s * sub
            hs, av = [ck[j][s]], []
            for t in range(ts, min(t1, ts + sub)):          # recompute
                av.append(decay(t))
                hs.append(step(hs[-1], av[-1], t))
            for r in reversed(range(len(av))):              # reverse steps
                t = ts + r
                g = dy[:, t, :, None] * C[:, t, None, :] + G
                dB[:, t] = (g * dtu[:, t, :, None]).sum(1)
                dC[:, t] = (dy[:, t, :, None] * hs[r + 1]).sum(1)
                s1 = (g * B[:, t, None, :]).sum(-1)
                gha = g * hs[r] * av[r]
                du[:, t] = dt[:, t] * s1 + D * dy[:, t]
                ddt[:, t] = u[:, t] * s1 + (gha * a2).sum(-1) * LN2
                part_a[:, j] += gha * dt[:, t, :, None]
                part_d[:, j] += dy[:, t] * u[:, t]
                G = av[r] * g
    dA, dD = torch.zeros_like(A), torch.zeros_like(D)       # 4. sums
    for b in range(Bz):
        for j in range(J):
            dA, dD = dA + part_a[b, j], dD + part_d[b, j]
    return du, ddt, dA, dB, dC, dD


@functools.lru_cache(maxsize=None)
def _scan_bwd_case(S, N):
    u, dt, A, B, C, D, _ = scan_case(70 + S + N, 2, S, 6, N, h0=False)
    dy = np.random.default_rng(71 + S).standard_normal((2, S, 6)).astype(
        np.float32)
    h0 = jnp.zeros((2, 6, N), jnp.float32)

    def jscan(u, dt, A, B, C, D):
        return JMB.selective_scan(u, dt, A, B, C, D, h0, chunk=16)[0]
    _, vjp = jax.vjp(jscan, *map(jnp.asarray, (u, dt, A, B, C, D)))
    return (u, dt, A, B, C, D, dy), tuple(map(np.asarray,
                                              vjp(jnp.asarray(dy))))


@pytest.mark.parametrize("J", [1, 3, 5, 16])
@pytest.mark.parametrize("S,N", [(37, 4), (37, 16), (64, 16)])
def test_chunked_scan_bwd_matches_jax_vjp(S, N, J):
    """The backward from the training forward's carries at J chunks (the
    forward itself over 4 chunks of its own); S = 37 is no multiple of
    the chunk, and at J = 16 it leaves the last chunks empty."""
    (u, dt, A, B, C, D, dy), want = _scan_bwd_case(S, N)
    args = tuple(map(_t, (u, dt, A, B, C, D)))
    y, h, carries = chunked_scan(*args, None, 4, J)
    _, _, plain = ref.selective_scan_fwd_ref(*args, chunks=J)
    np.testing.assert_allclose(carries.numpy(), plain.numpy(),
                               atol=SCAN_TOL, rtol=SCAN_TOL)
    got = chunked_scan_bwd(*args, carries, _t(dy))
    for name, g, w in zip(("du", "ddt", "dA", "dB", "dC", "dD"), got, want):
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(g.numpy(), w, atol=SCAN_TOL * scale,
                                   rtol=0, err_msg=name)


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


def _merge_chunks(chunks, warps=8):
    """decode_merge_kernel's merge of a row's chunk records (m, l, acc):
    M over them all, warp w's sums of chunks w, w + warps, ... in order,
    then the warps' sums added in warp order."""
    M = torch.stack([m for m, _, _ in chunks]).amax(0)
    lt, x = torch.zeros_like(M), torch.zeros_like(chunks[0][2])
    for w in range(warps):
        lw, xw = torch.zeros_like(M), torch.zeros_like(chunks[0][2])
        for m, l, acc in chunks[w::warps]:
            wt = torch.where(m == -math.inf, torch.zeros_like(m),
                             torch.exp(m - M))
            lw = lw + l * wt
            xw = xw + acc * wt[:, None]
        lt, x = lt + lw, x + xw
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


# ----------------------- the serving mesh's decode: (a), (b) -----------------------
def _split_softmax(score_of, G, V, valid, S, W, C=1):
    """decode_attention.cu's split body over one (row, group of <= 8 query
    heads): L slots of V (L, D) cut into 32-slot tiles, C chunks (the D 256
    launch's clusters of a row; 1 elsewhere) of S splits each, split r of
    chunk c owning the ceil(tiles / (S C)) contiguous tiles from (c S + r)
    times that, each split's tiles with a valid slot dealt to W warps in
    list order, each warp's online softmax over its tiles, the warps merged
    per split, the splits in rank order into their chunk's record (through
    distributed shared memory), the records by _merge_chunks (the merge
    launch; with C = 1 the cluster writes out itself).  score_of(slots)
    gives the group's scaled scores there.  When no slot of the row is
    valid, every slot is, scoring 0 (the uniform softmax: the mean of V),
    and the lse is -inf.  Returns (out (G, D), lse (G,))."""
    L, D = V.shape
    uniform = not bool(valid.any())
    if uniform:
        valid = torch.ones(L, dtype=torch.bool)
    ntiles = -(-L // TILE)
    tps = -(-ntiles // (S * C))
    chunks = []
    for chunk in range(C):
        splits = []
        for rank in range(S):
            first = (chunk * S + rank) * tps
            tiles = range(min(ntiles, first), min(ntiles, first + tps))
            live = [t for t in tiles if valid[t * TILE:(t + 1) * TILE].any()]
            warps = []
            for w in range(W):
                m = torch.full((G,), -math.inf)
                l, acc = torch.zeros(G), torch.zeros(G, D)
                for t in live[w::W]:
                    sl = slice(t * TILE, min(L, (t + 1) * TILE))
                    s = (torch.zeros(G, sl.stop - sl.start) if uniform
                         else score_of(sl))
                    s = torch.where(valid[sl][None], s, -math.inf)
                    m_new = torch.maximum(m, s.amax(-1))
                    p = torch.exp(s - m_new[:, None])
                    corr = torch.exp(m - m_new)
                    l = l * corr + p.sum(-1)
                    acc = acc * corr[:, None] + p @ V[sl]
                    m = m_new
                warps.append((m, l, acc))
            splits.append(_merge(warps))
        chunks.append(_merge(splits))
    M, lt, x = _merge_chunks(chunks) if C > 1 else chunks[0]
    lse = torch.full((G,), -math.inf) if uniform else M + torch.log(lt)
    return x / lt[:, None], lse


def _split_rows(score_of, B, H, KV, V, spos, qpos, S, W, C=1):
    """_split_softmax for every (row, kv head, group of kHeads = 8 query
    heads); score_of(b, heads, kv, slots).  Returns (out (B, H, D), lse)."""
    G, D = H // KV, V.shape[-1]
    out, lse = torch.empty(B, H, D), torch.empty(B, H)
    for b in range(B):
        valid = (spos[b] >= 0) & (spos[b] <= qpos[b])
        for kv in range(KV):
            for g0 in range(0, G, 8):
                h = slice(kv * G + g0, kv * G + min(G, g0 + 8))
                out[b, h], lse[b, h] = _split_softmax(
                    functools.partial(score_of, b, h, kv), h.stop - h.start,
                    V[b, :, kv], valid, S, W, C)
    return out, lse


def split_decode_lse(q, k, v, spos, qpos, S, W=4, C=1):
    """Kernel (a): kernel 2's split body over a rank's slot range, scores
    q . k / sqrt(D), with each head's lse (kernel 2: the same without it),
    each row over C chunks of S splits.  Returns (out, lse)."""
    B, H, D = q.shape
    return _split_rows(lambda b, h, kv, sl: q[b, h] @ k[b, sl, kv].T
                       / math.sqrt(D), B, H, k.shape[2], v, spos, qpos, S, W,
                       C)


def split_hd_out(scores, v, spos, qpos, S, W=8):
    """Kernel (b)'s launch 2: the same body over the scores summed over the
    ranks (B, H, L), already scaled, and the rank's columns of V."""
    B, H, _ = scores.shape
    return _split_rows(lambda b, h, kv, sl: scores[b, h, sl], B, H,
                       v.shape[2], v, spos, qpos, S, W)[0]


def combine_slot_splits(outs, lses):
    """repro_torch.models.model._combine_slot_splits' formula over the
    ranks' (out, lse): sum_r e^(lse_r - max) out_r / sum_r e^(lse_r - max),
    a rank with lse -inf weighing 0; where every rank's is -inf, the mean."""
    os_, ls = torch.stack(outs), torch.stack(lses)
    top = ls.max(0).values
    w = torch.where(torch.isneginf(ls), 0.0, torch.exp(ls - top))
    w = torch.where(torch.isneginf(top)[None], 1.0, w)
    return (w[..., None] * os_).sum(0) / w.sum(0)[..., None]


#: (B, H, KV, D, L, layout): the ring as decode_case lays it out or
#: wrapped; the last row of B > 2 has no valid slot.  G 1, 6 (mixtral's), 8
#: and 12 (two head groups); L of 20 (< one tile), 77, 130 and 300 (no
#: multiple of 32); D splits over 2 ranks for (b), L for (a)
RANK_CASES = {
    "g6_L300": (3, 12, 2, 16, 300, None),
    "g1_L78": (2, 4, 4, 16, 78, None),
    "g8_wrapped": (3, 16, 2, 16, 130, "wrapped"),
    "g12_wrapped": (3, 24, 2, 16, 100, "wrapped"),
    "L20": (3, 8, 2, 16, 20, None),
    "all_empty": (2, 12, 2, 16, 70, "empty"),
}


@functools.lru_cache(maxsize=None)
def _rank_case(case):
    """The case's numpy inputs and JAX's decode_attention over them."""
    B, H, KV, D, L, layout = RANK_CASES[case]
    q, k, v, spos, qpos = decode_case(40 + len(case), B, H, KV, D, L)
    if layout == "wrapped":
        q, k, v, spos, qpos = _wrapped_ring(q, k, v, spos, qpos)
    if layout == "empty":
        spos[:] = -1
    elif B > 2:
        spos[-1] = -1
    arrays = tuple(np.ascontiguousarray(a) for a in (q, k, v, spos, qpos))
    want = np.asarray(JL.decode_attention(*map(jnp.asarray, arrays)))
    return arrays, want


@pytest.mark.parametrize("S", [1, 2, 4, 8])
@pytest.mark.parametrize("case", list(RANK_CASES))
def test_split_hd_out_matches_jax(case, S):
    """Kernel (b) on 2 ranks of head_dim: the partial scores summed, then
    each rank's split softmax and P.V over its columns; the columns put
    together are JAX's decode_attention over the whole head_dim, and each
    rank's the port's plain version."""
    arrays, want = _rank_case(case)
    q, k, v, spos, qpos = map(_t, arrays)
    D = q.shape[-1]
    cols = [slice(0, D // 2), slice(D // 2, D)]
    scores = sum(ref.decode_attention_hd_scores_ref(
        q[..., c].contiguous(), k[..., c].contiguous(), 1 / math.sqrt(D))
        for c in cols)
    outs = []
    for c in cols:
        vr = v[..., c].contiguous()
        out = split_hd_out(scores, vr, spos, qpos, S)
        np.testing.assert_allclose(
            out.numpy(), ref.decode_attention_hd_out_ref(
                scores, vr, spos, qpos)[0].numpy(), atol=PAGED_TOL,
            rtol=PAGED_TOL)
        outs.append(out)
    np.testing.assert_allclose(torch.cat(outs, -1).numpy(), want,
                               atol=PAGED_TOL, rtol=PAGED_TOL)


@pytest.mark.parametrize("S", [1, 2, 4, 8])
@pytest.mark.parametrize("case", list(RANK_CASES))
def test_split_decode_lse_matches_jax(case, S):
    """Kernel (a) on 2 ranks of the slots: each rank's split body over its
    half of the ring (an empty half: lse -inf, the mean of its V) is the
    port's plain version, and the halves combined by _combine_slot_splits'
    formula are JAX's decode_attention over the whole ring."""
    arrays, want = _rank_case(case)
    q, k, v, spos, qpos = map(_t, arrays)
    L = k.shape[1]
    outs, lses = [], []
    for sl in (slice(0, L // 2), slice(L // 2, L)):
        part = (q, k[:, sl].contiguous(), v[:, sl].contiguous(),
                spos[:, sl].contiguous(), qpos)
        out, lse = split_decode_lse(*part, S)
        r_out, r_lse = ref.decode_attention_lse_ref(*part)
        np.testing.assert_allclose(out.numpy(), r_out.numpy(),
                                   atol=PAGED_TOL, rtol=PAGED_TOL)
        np.testing.assert_allclose(lse.numpy(), r_lse.numpy(),
                                   atol=PAGED_TOL, rtol=PAGED_TOL)
        outs.append(out)
        lses.append(lse)
    np.testing.assert_allclose(combine_slot_splits(outs, lses).numpy(), want,
                               atol=PAGED_TOL, rtol=PAGED_TOL)


#: kernel 2 and (a) at D 256 (the chunked launch): ragged fills, a wrapped
#: ring, the last row with no valid slot; L 300 is 10 tiles, so 16 chunks
#: leave chunks with no tile and a short fill leaves chunks with no live one
CHUNK_CASES = {
    "filled": (3, 8, 1, 256, 300, None),
    "wrapped": (3, 8, 1, 256, 300, "wrapped"),
    "gqa_two_groups": (2, 24, 2, 256, 140, None),
}


@functools.lru_cache(maxsize=None)
def _chunk_case(case):
    """The case's numpy inputs, the last row of B > 2 without a valid slot,
    and the Pallas kernel's output in interpret mode."""
    B, H, KV, D, L, layout = CHUNK_CASES[case]
    q, k, v, spos, qpos = decode_case(90 + len(case), B, H, KV, D, L)
    if layout == "wrapped":
        q, k, v, spos, qpos = _wrapped_ring(q, k, v, spos, qpos)
    if B > 2:
        spos[-1] = -1
    arrays = tuple(np.ascontiguousarray(a) for a in (q, k, v, spos, qpos))
    pallas = np.asarray(JOPS.decode_attention(*map(jnp.asarray, arrays),
                                              interpret=True))
    return arrays, pallas


@pytest.mark.parametrize("S,W,C", [(1, 4, 3), (1, 4, 16), (1, 2, 7),
                                   (2, 4, 5), (8, 1, 2)])
@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_split_decode_chunks_match_pallas(case, S, W, C):
    """Kernel 2 and (a) with each row over C chunks of S splits (the D 256
    launch takes C ~ 65 clusters of one block at paligemma-3b's shapes):
    every row with a valid slot as the Pallas kernel computes it; every
    row, the one with no valid slot too (the mean of V, lse -inf), as the
    port's plain version; the chunk count changes only the order of the
    sums."""
    (q, k, v, spos, qpos), pallas = _chunk_case(case)
    tq, tk, tv, tspos, tqpos = map(_t, (q, k, v, spos, qpos))
    out, lse = split_decode_lse(tq, tk, tv, tspos, tqpos, S, W, C)
    rows = (spos >= 0).any(1)
    np.testing.assert_allclose(out.numpy()[rows], pallas[rows],
                               atol=PAGED_TOL, rtol=PAGED_TOL)
    r_out, r_lse = ref.decode_attention_lse_ref(tq, tk, tv, tspos, tqpos)
    np.testing.assert_allclose(out.numpy(), r_out.numpy(), atol=PAGED_TOL,
                               rtol=PAGED_TOL)
    np.testing.assert_allclose(lse.numpy(), r_lse.numpy(), atol=PAGED_TOL,
                               rtol=PAGED_TOL)
    one, one_lse = split_decode_lse(tq, tk, tv, tspos, tqpos, 8, 4, 1)
    np.testing.assert_allclose(out.numpy(), one.numpy(), atol=PAGED_TOL,
                               rtol=PAGED_TOL)
    np.testing.assert_allclose(lse.numpy(), one_lse.numpy(), atol=PAGED_TOL,
                               rtol=PAGED_TOL)
    if case != "gqa_two_groups":
        assert not rows[-1] and np.isneginf(lse.numpy()[-1]).all()


# --------------------- flash forward: the warp-specialised body ---------------------
FLASH_TOL = 2e-5


def ws_tile_walk(qpos, kpos, causal, window, prefix_len, rows=128, keys=64):
    """flash_attention.cu's ws body over one row's positions: for each
    query tile of `rows` rows (q0), its halves of rows / 2 rows in range
    (r0, r1), each kv tile's class for each half (ws::classify, the
    backward's rules: the half's range over its rows in range, whole if
    rows / 2 of them; the tile's over its present keys, whole if `keys`
    keys, all present; a row with no visible key at all makes every tile
    live for its half) and the tiles live for either half, in order (what
    the loader loads).  Yields (q0, halves, classes, live)."""
    Sq, Skv = len(qpos), len(kpos)
    ok = visible(torch.as_tensor(qpos)[:, None], torch.as_tensor(kpos)[None],
                 causal, window, prefix_len).numpy()
    empty = ~ok.any(1)
    half = rows // 2
    for q0 in range(0, Sq, rows):
        halves = [(r0, min(Sq, r0 + half)) for r0 in (q0, q0 + half)
                  if r0 < Sq]
        classes = []
        for r0, r1 in halves:
            classes.append([tile_class(
                qpos[r0:r1], kpos[k0:k0 + keys], r1 - r0 == half,
                k0 + keys <= Skv and (kpos[k0:k0 + keys] >= 0).all(),
                bool(empty[r0:r1].any()), causal, window, prefix_len)
                for k0 in range(0, Skv, keys)])
        live = [t for t in range(len(classes[0]))
                if any(c[t] != "dead" for c in classes)]
        yield q0, halves, classes, live


def ws_flash(q, k, v, qpos, kpos, causal=True, window=0, prefix_len=0,
             empty_div=None, rows=128, keys=64):
    """The ws body in float32 (bf16's P split aside: exact here): for each
    (b, h) and ws_tile_walk's query tile, each half walks the live list in
    order, skipping its dead tiles; S = Q K^T scaled by scale log2 e,
    masked pairs -1e30 on a partial tile (a full one reads no position),
    the online softmax in exp2, O += P V; out = O / l, or the sum of V over
    the Skv keys / empty_div for a row with no visible key (lse -1e30),
    lse = m ln 2 + log l.  Returns (out, lse)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    empty_div = Skv if empty_div is None else empty_div
    scale2 = LOG2E / math.sqrt(D)
    out, lse = torch.zeros(B, Sq, H, D), torch.zeros(B, Sq, H)
    for b in range(B):
        ok = visible(qpos[b][:, None], kpos[b][None], causal, window,
                     prefix_len)
        empty = ~ok.any(1)
        walk = list(ws_tile_walk(qpos[b].numpy(), kpos[b].numpy(), causal,
                                 window, prefix_len, rows, keys))
        for h in range(H):
            kh, vh = k[b, :, h // G], v[b, :, h // G]
            for _, halves, classes, live in walk:
                for (r0, r1), cls in zip(halves, classes):
                    m = torch.full((r1 - r0,), NEG)
                    l, acc = torch.zeros(r1 - r0), torch.zeros(r1 - r0, D)
                    for t in live:
                        if cls[t] == "dead":
                            continue
                        ks = slice(t * keys, min(Skv, (t + 1) * keys))
                        sc = q[b, r0:r1, h] @ kh[ks].T * scale2
                        if cls[t] == "partial":
                            sc = torch.where(ok[r0:r1, ks], sc,
                                             torch.full_like(sc, NEG))
                        m_new = torch.maximum(m, sc.amax(-1))
                        p = torch.exp2(sc - m_new[:, None])
                        corr = torch.exp2(m - m_new)
                        l = l * corr + p.sum(-1)
                        acc = acc * corr[:, None] + p @ vh[ks]
                        m = m_new
                    e = empty[r0:r1]
                    div = torch.where(e, torch.full_like(l, empty_div), l)
                    out[b, r0:r1, h] = acc / div[:, None]
                    lse[b, r0:r1, h] = torch.where(
                        e, torch.full_like(l, NEG), m * LN2 + torch.log(l))
    return out, lse


#: B 2 rows, 8 heads on 1 kv head of 256 (paligemma-3b's) or 4 on 2 of 80
#: (hubert-xlarge's); left pads; q_lo: a sequence-parallel rank's queries
#: (the last Sq of the S keys); a 64-key kv tile, or 128
WS_CASES = {
    "d256": dict(B=2, S=256, H=8, KV=1, D=256, npad=0),
    "d256_pads": dict(B=2, S=384, H=8, KV=1, D=256, npad=40),
    "d256_rank": dict(B=2, S=512, H=8, KV=1, D=256, npad=0, q_lo=256),
    "d80_pads": dict(B=2, S=256, H=4, KV=2, D=80, npad=21),
    "d80_keys128": dict(B=1, S=256, H=4, KV=2, D=80, npad=3, keys=128),
}
WS_MASKS = {"causal": dict(causal=True), "window": dict(causal=True, window=100),
            "prefix_lm": dict(causal=True, prefix_len=32),
            "bidirectional": dict(causal=False)}


@functools.lru_cache(maxsize=None)
def _ws_case(case, mask):
    """The case's inputs (queries from q_lo on) and the Pallas kernel's
    output in interpret mode (blocks of 128)."""
    c = dict(WS_CASES[case])
    lo, _ = c.pop("q_lo", 0), c.pop("keys", 64)
    q, k, v, qpos, kpos = prefill_case(110 + len(case), **c)
    q, qpos = np.ascontiguousarray(q[:, lo:]), np.ascontiguousarray(qpos[:, lo:])
    pallas = np.asarray(JOPS.flash_attention(
        *map(jnp.asarray, (q, k, v, qpos, kpos)), block_q=128, block_kv=128,
        interpret=True, **WS_MASKS[mask]))
    return (q, k, v, qpos, kpos), pallas


@pytest.mark.parametrize("mask", list(WS_MASKS))
@pytest.mark.parametrize("case", list(WS_CASES))
def test_ws_flash_matches_pallas(case, mask):
    """Kernel 1's ws tile walk: each row with a visible key as the Pallas
    kernel computes it; every row (left pads: the sum of V over the keys /
    empty_div) and its lse as the port's plain version."""
    (q, k, v, qpos, kpos), pallas = _ws_case(case, mask)
    kw = WS_MASKS[mask]
    tq, tk, tv, tqpos, tkpos = map(_t, (q, k, v, qpos, kpos))
    div = ref.empty_row_divisor(k.shape[1], ref.FLASH_KV_BLOCK)
    out, lse = ws_flash(tq, tk, tv, tqpos, tkpos, empty_div=div,
                        keys=WS_CASES[case].get("keys", 64), **kw)
    ok = visible(tqpos[:, :, None], tkpos[:, None, :], kw["causal"],
                 kw.get("window", 0), kw.get("prefix_len", 0)).any(-1).numpy()
    np.testing.assert_allclose(out.numpy()[ok], pallas[ok], atol=FLASH_TOL,
                               rtol=FLASH_TOL)
    r_out, r_lse = ref.flash_attention_fwd_ref(tq, tk, tv, tqpos, tkpos, **kw)
    np.testing.assert_allclose(out.numpy(), r_out.numpy(), atol=FLASH_TOL,
                               rtol=FLASH_TOL)
    np.testing.assert_allclose(lse.numpy(), r_lse.numpy(), atol=FLASH_TOL,
                               rtol=FLASH_TOL)


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


@pytest.mark.parametrize("mask", list(TILE_MASKS))
@pytest.mark.parametrize("seed", range(4))
def test_ws_tile_walk_is_sound(seed, mask):
    """Kernel 1's ws walk on random positions (left pads, absent keys, an
    offset, shuffled or sorted; 8-row query tiles in halves of 4, 4-key
    tiles, ragged lengths): a full (half, tile) has every pair visible, a
    dead one no visible pair and no row without a visible key, and a tile
    missing from the live list is dead for both halves."""
    rng = np.random.default_rng(90 + seed)
    kw = TILE_MASKS[mask]
    args = (kw["causal"], kw.get("window", 0), kw.get("prefix_len", 0))
    seen = set()
    for _ in range(6):
        Sq, Skv = int(rng.integers(9, 40)), int(rng.integers(9, 48))
        off = int(rng.integers(0, 12))
        qpos = np.arange(Sq) + off + Skv - Sq
        kpos = np.arange(Skv) + off
        qpos[:rng.integers(0, 6)] = -1
        kpos[rng.random(Skv) < rng.choice([0.0, 0.15])] = -1
        if rng.random() < 0.5:
            rng.shuffle(qpos)
            rng.shuffle(kpos)
        ok = np.asarray(JL._block_mask(jnp.asarray(qpos), jnp.asarray(kpos),
                                       *args))
        empty_row = ~ok.any(1)
        for _, halves, classes, live in ws_tile_walk(qpos, kpos, *args,
                                                     rows=8, keys=4):
            for (r0, r1), cls in zip(halves, classes):
                for t, c in enumerate(cls):
                    ks = slice(4 * t, 4 * t + 4)
                    seen.add(c)
                    if c == "full":
                        assert ok[r0:r1, ks].all()
                    if c == "dead":
                        assert not ok[r0:r1, ks].any()
                        assert not empty_row[r0:r1].any()
            for t in set(range(len(classes[0]))) - set(live):
                assert all(cls[t] == "dead" for cls in classes)
    assert "partial" in seen and len(seen) >= 2


# ---------------------------- grouped matmul backward ----------------------------
GMM_TOL = 1e-5


def gmm_bwd_tiles(x, w, gs, dy, rows=128, cols=256, depth=64):
    """gmm.cu's wgmma bodies: dx in `rows`-row tiles of one group by `cols`
    columns of M, contracted over N `depth` at a time; dw one owner tile of
    `rows` rows of M by `cols` columns of N per expert, the group's rows in
    order `depth` at a time (zeros past the group; an empty expert one
    stage of zeros).  fp32 sums, each output rounded once to its dtype."""
    T, M = x.shape
    E, _, N = w.shape
    dx = torch.zeros_like(x)
    dw = torch.empty_like(w)
    starts = [0] + torch.cumsum(gs, 0).tolist()
    for e in range(E):
        r0, n = starts[e], starts[e + 1] - starts[e]
        for t0 in range(0, n, rows):                        # dx
            t1 = min(n, t0 + rows)
            for c0 in range(0, M, cols):
                acc = torch.zeros(t1 - t0, min(cols, M - c0))
                for k0 in range(0, N, depth):
                    acc += (dy[r0 + t0:r0 + t1, k0:k0 + depth].float()
                            @ w[e, c0:c0 + cols, k0:k0 + depth].float().t())
                dx[r0 + t0:r0 + t1, c0:c0 + cols] = acc.to(x.dtype)
        for m0 in range(0, M, rows):                        # dw
            for c0 in range(0, N, cols):
                acc = torch.zeros(min(rows, M - m0), min(cols, N - c0))
                for k0 in range(0, max(n, 1), depth):
                    xs = torch.zeros(depth, acc.shape[0])
                    ds = torch.zeros(depth, acc.shape[1])
                    k1 = min(n, k0 + depth)
                    xs[:k1 - k0] = x[r0 + k0:r0 + k1, m0:m0 + rows].float()
                    ds[:k1 - k0] = dy[r0 + k0:r0 + k1, c0:c0 + cols].float()
                    acc += xs.t() @ ds
                dw[e, m0:m0 + rows, c0:c0 + cols] = acc.to(w.dtype)
    return dx, dw


#: the choices routed to each expert and the capacity: an empty expert,
#: one over the capacity (its dropped choices past the kept rows), groups
#: on both sides of the 128-row tile; M and N past a whole tile
GMM_BWD_CASES = {
    "tiles": dict(M=136, N=264, C=130, counts=[1, 127, 0, 128, 129, 150]),
    "small": dict(M=24, N=40, C=8, counts=[0, 0, 1, 11, 3]),
}


@pytest.mark.parametrize("case", list(GMM_BWD_CASES))
def test_gmm_bwd_tiles_match_jax_vjp(case):
    """The port's rows: each expert's kept choices (at most C) in order,
    the dropped ones after all of them; the JAX block's (E, C, .) capacity
    buffers hold the kept ones, and their einsum's vjp gives dw and each
    kept row's dx (a dropped row gets none)."""
    c = GMM_BWD_CASES[case]
    M, N, C, counts = c["M"], c["N"], c["C"], c["counts"]
    E = len(counts)
    gs = [min(n, C) for n in counts]
    kept, T = sum(gs), sum(counts)
    rng = np.random.default_rng(80 + M)
    x = rng.standard_normal((T, M)).astype(np.float32)
    w = (rng.standard_normal((E, M, N)) / M ** 0.5).astype(np.float32)
    dy = rng.standard_normal((T, N)).astype(np.float32)
    xb = np.zeros((E, C, M), np.float32)
    db = np.zeros((E, C, N), np.float32)
    for e, (a, g) in enumerate(zip(np.cumsum([0] + gs[:-1]), gs)):
        xb[e, :g], db[e, :g] = x[a:a + g], dy[a:a + g]
    _, vjp = jax.vjp(lambda a, b: jnp.einsum("ecm,emn->ecn", a, b),
                     jnp.asarray(xb), jnp.asarray(w))
    jdxb, jdw = map(np.asarray, vjp(jnp.asarray(db)))
    jdx = np.zeros_like(x)
    for e, (a, g) in enumerate(zip(np.cumsum([0] + gs[:-1]), gs)):
        jdx[a:a + g] = jdxb[e, :g]
    dx, dw = gmm_bwd_tiles(_t(x), _t(w), torch.tensor(gs), _t(dy))
    for name, g, want in (("dx", dx, jdx), ("dw", dw, jdw)):
        scale = max(float(np.abs(want).max()), 1e-6)
        np.testing.assert_allclose(g.numpy(), want, atol=GMM_TOL * scale,
                                   rtol=0, err_msg=name)
    assert not dx[kept:].any()
    assert not dw[torch.tensor(gs) == 0].any()

