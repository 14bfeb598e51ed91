"""Seeded numpy inputs shared by the repro_torch kernel tests (CPU parity in
test_torch_kernels.py, on-card checks in test_torch_cuda.py).  Imports no
jax, so the on-card tests run where jax is not installed."""
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
