"""Seeded numpy inputs shared by the repro_torch kernel tests (CPU parity in
test_torch_kernels.py and test_torch_paged.py, on-card checks in
test_torch_cuda.py), and the JAX/torch engine pairs of the parity tests.
Imports no jax at module level, so the on-card tests run where jax is not
installed."""
import dataclasses

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Import into a test module to run its torch ops on one thread: the
    smoke-size tensors gain nothing from intra-op threads, and with several
    pytest workers on one machine those threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def prefill_case(seed, B, S, H, KV, D, npad=0, prefix=0):
    """q/k/v and positions for a prefill: `npad` left-pad rows (position -1)
    per sequence; `prefix` > 0 prepends a cached prefix of that many kv
    slots (extend-offset prefill: kv = prefix ++ new tokens)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D), np.float32)
    k = rng.standard_normal((B, prefix + S, KV, D), np.float32)
    v = rng.standard_normal((B, prefix + S, KV, D), np.float32)
    qpos = np.tile(np.arange(S, dtype=np.int32) - npad + prefix, (B, 1))
    qpos[:, :npad] = -1
    kpos = np.concatenate([np.tile(np.arange(prefix, dtype=np.int32), (B, 1)),
                           qpos], axis=1)
    return q, k, v, qpos, kpos


FLASH_CASES = {
    "mha": dict(B=1, S=40, H=4, KV=4, D=16),
    "gqa": dict(B=2, S=33, H=8, KV=2, D=32),
    "pad_rows": dict(B=2, S=48, H=4, KV=2, D=16, npad=13),
    "extend_offset": dict(B=2, S=24, H=4, KV=2, D=16, npad=5, prefix=32),
}
MASKS = {"causal": dict(causal=True), "window": dict(causal=True, window=9),
         "prefix_lm": dict(causal=True, prefix_len=7),
         "bidirectional": dict(causal=False)}


def decode_case(seed, B, H, KV, D, L):
    """Ragged ring-cache fills: row b holds fill_b tokens, slots past the
    fill are empty (-1); the query sits at position fill_b - 1."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D), np.float32)
    kc = rng.standard_normal((B, L, KV, D), np.float32)
    vc = rng.standard_normal((B, L, KV, D), np.float32)
    fills = rng.integers(1, L + 1, size=B)
    spos = np.tile(np.arange(L, dtype=np.int32), (B, 1))
    spos[spos >= fills[:, None]] = -1
    qpos = (fills - 1).astype(np.int32)
    return q, kc, vc, spos, qpos


def sample_case(seed, B, V, ties):
    rng = np.random.default_rng(seed)
    if ties:     # few distinct values: many exact ties inside every row
        logits = rng.integers(-3, 4, size=(B, V)).astype(np.float32)
    else:
        logits = rng.standard_normal((B, V)).astype(np.float32)
    mask = (rng.uniform(size=(B, V)) < 0.6).astype(np.int8)
    mask[:, 0] = 1
    return logits, mask, rng


def paged_case(seed, B, H, KV, D, ps, NB, P, shared=0):
    """A page pool (KV, P, ps, D) and block tables (B, NB) with ragged
    fills: row b holds fill_b tokens (at least one past the `shared`
    prefix pages, which every row lists first); its other pages are drawn
    without replacement.  Past the fill, odd rows keep pages (decode
    capacity the engine allocates ahead) and even rows -1."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D), np.float32)
    kp = rng.standard_normal((KV, P, ps, D), np.float32)
    vp = rng.standard_normal((KV, P, ps, D), np.float32)
    perm = iter(rng.permutation(P))
    pre = [next(perm) for _ in range(shared)]
    fills = rng.integers(shared * ps + 1, NB * ps + 1, size=B)
    table = np.full((B, NB), -1, np.int32)
    for b, f in enumerate(fills):
        table[b, :shared] = pre
        upto = NB if b % 2 else -(-int(f) // ps)
        for j in range(shared, upto):
            table[b, j] = next(perm)
    qpos = (fills - 1).astype(np.int32)
    return q, kp, vp, table, qpos


def quantize_pool(pool, frozen_every=2):
    """int8 shadow of a (KV, P, ps, D) float32 pool, symmetric per
    (kv-head, page) with scale = abs-max / 127 and round-half-to-even (the
    engine's _quantize_pages), and flags (P,) freezing every
    `frozen_every`-th page."""
    amax = np.abs(pool).max(axis=(2, 3))
    scale = (np.maximum(amax, 1e-8) / 127.0).astype(np.float32)
    q8 = np.clip(np.rint(pool / scale[..., None, None]), -127,
                 127).astype(np.int8)
    flags = (np.arange(pool.shape[1]) % frozen_every == 0).astype(np.int8)
    return q8, scale, flags


def prefix_case(seed, B, S, H, KV, D, ps, P, npre, plen=None):
    """Suffix q/k/v (B, S, ...) with ragged left padding, positions
    starting at the prefix length, and a (KV, P, ps, D) pool whose pages
    `prefix_table` (npre,) hold the shared prefix (first `plen` tokens
    valid; default all of them)."""
    rng = np.random.default_rng(seed)
    plen = npre * ps if plen is None else plen
    q = rng.standard_normal((B, S, H, D), np.float32)
    k = rng.standard_normal((B, S, KV, D), np.float32)
    v = rng.standard_normal((B, S, KV, D), np.float32)
    kp = rng.standard_normal((KV, P, ps, D), np.float32)
    vp = rng.standard_normal((KV, P, ps, D), np.float32)
    pos = np.zeros((B, S), np.int32)
    for b in range(B):
        pad = int(rng.integers(0, S // 2))
        pos[b] = np.arange(S) - pad + plen
        pos[b, :pad] = -1
    ptab = rng.permutation(P)[:npre].astype(np.int32)
    return q, k, v, pos, kp, vp, ptab, plen



def scan_case(seed, Bz, S, Di, N, h0=True):
    """Selective-scan inputs as the Mamba mixer makes them: u (Bz, S, Di);
    dt = softplus of a normal (positive, about 0.05 to 3); A = -exp(A_log)
    with A_log = log(1..N) plus noise, as the initializer sets it; B, C
    (Bz, S, N); D (Di,); h0 (Bz, Di, N), or None for a scan from zeros."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((Bz, S, Di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(-1.0, 1.0, (Bz, S, Di)))).astype(
        np.float32)
    A = -np.exp(np.log(np.arange(1, N + 1, dtype=np.float32))[None]
                + 0.1 * rng.standard_normal((Di, N))).astype(np.float32)
    B = rng.standard_normal((Bz, S, N)).astype(np.float32)
    C = rng.standard_normal((Bz, S, N)).astype(np.float32)
    D = rng.standard_normal(Di).astype(np.float32)
    h = rng.standard_normal((Bz, Di, N)).astype(np.float32) if h0 else None
    return u, dt, A, B, C, D, h

# -- JAX/torch engine pairs (the parity tests; jax is imported on first use,
# so this module stays importable where jax is not installed) --------------
_PAIRS = {}


def engine_pair(arch="olmo-1b", config=(), **kw):
    """A JAX and a torch InferenceEngine of `arch`'s smoke config (vocab
    259, float32, max_len 256, paged unless kv_layout says otherwise; the
    (field, value) pairs of `config` replaced in it) on the same weights,
    put back to a fresh state: sampling seed, prefix memo, totals and page
    pool.  One pair per arch, config and option set, so the JAX compile
    caches are reused across tests."""
    key = (arch, tuple(config)) + tuple(sorted(kw.items()))
    if key not in _PAIRS:
        import jax

        import repro.configs as JC
        import repro_torch.configs as TC
        from repro.serving.engine import InferenceEngine as JaxEngine
        from repro_torch.models.params import params_from_jax
        from repro_torch.serving.engine import InferenceEngine as TorchEngine
        kw = dict(kw)
        layout = kw.pop("kv_layout", "paged")
        jcfg = JC.get_smoke_config(arch).replace(
            vocab_size=259, compute_dtype="float32", **dict(config))
        tcfg = TC.get_smoke_config(arch).replace(
            vocab_size=259, compute_dtype="float32", **dict(config))
        je = JaxEngine(jcfg, max_len=256, seed=0, kv_layout=layout, **kw)
        te = TorchEngine(tcfg, params_from_jax(
            tcfg, jax.tree.map(np.asarray, je.params), "cpu"),
            max_len=256, seed=0, kv_layout=layout, device="cpu", **kw)
        _PAIRS[key] = (je, te)
    je, te = _PAIRS[key]
    for eng in (je, te):
        eng._rng = np.random.default_rng(0)
        eng._prefix_kv.clear()
        eng.total = type(eng.total)()
        eng._pool = eng._alloc = eng._radix = eng._quant_flags = None
        eng.kv_peak_bytes = 0
    te._quant_flags_dev = None
    return je, te


def gen_stats(s):
    """GenStats as a dict without the wall time."""
    d = dataclasses.asdict(s)
    d.pop("wall_s")
    return d


def grammar_pair(fields=(("v", "INTEGER"), ("tag", "VARCHAR")), max_str=8):
    """The same JSON grammar from the JAX package and from the port."""
    from repro.serving import grammar as JG
    from repro_torch.serving import grammar as TG
    return (JG.JsonGrammar([JG.Field(n, t) for n, t in fields],
                           max_str=max_str),
            TG.JsonGrammar([TG.Field(n, t) for n, t in fields],
                           max_str=max_str))


def assert_pool_baseline(eng):
    """After a run, the only live page references are cache residencies
    (prefix-memo entries and radix-tree nodes), one reference each."""
    if eng._alloc is None:
        return
    resident = [p for e in eng._prefix_kv.values()
                if e.pages is not None for p in e.pages]
    if eng._radix is not None:
        resident += eng._radix.resident_page_ids()
    assert eng._alloc.in_use == len(resident)
    assert all(eng._alloc.refs(p) == 1 for p in resident)
