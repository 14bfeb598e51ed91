"""The plain reference against the port at the configurations' small sizes
on the CPU (this test imports both; the reference imports nothing of the
port)."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ipdb_bench.harness import weights
from ipdb_bench.reference import grammar, judge, models
from repro_torch.models import model as MDL
from repro_torch.serving.grammar import Field, JsonGrammar

BENCH = Path(__file__).resolve().parent
SMALL = {
    "olmo-1b": dict(num_layers=2, d_model=64, vocab_size=288, num_heads=4,
                    num_kv_heads=4, head_dim=16, d_ff=96),
    "falcon-mamba-7b": dict(num_layers=2, d_model=64, vocab_size=288,
                            ssm_state=8),
}


def _small(name: str, dtype: str):
    f = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    model = {**f["model"], **SMALL[name], "compute_dtype": dtype}
    return model, weights.model_config({"model": model})


@pytest.mark.parametrize("name", sorted(SMALL))
def test_reference_logits_equal_the_ports_forward(name):
    model, cfg = _small(name, "float32")
    W = weights.make_weights(cfg, 2**31 + 5, torch.device("cpu"))
    ids = grammar.encode("a review of the burger #visit1234567: " * 4)
    toks = torch.tensor([ids])
    pos = torch.arange(len(ids))[None]
    got, _ = MDL.forward(cfg, W, {"tokens": toks, "positions": pos},
                         mode="train", remat=False)
    want = models.logits_batch(model, W, [ids], [range(len(ids))])[0]
    assert torch.allclose(got[0, :, :want.shape[1]].float(), want,
                          atol=2e-4, rtol=2e-4)


def test_chunked_scan_equals_the_recurrence():
    g = torch.Generator().manual_seed(3)
    T, Di, N = 77, 6, 4

    def randn(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64)
    u, dt = randn(T, Di), torch.nn.functional.softplus(randn(T, Di))
    A = -torch.exp(randn(Di, N))
    Bm, Cm, Dv = randn(T, N), randn(T, N), randn(Di)
    h = torch.zeros(Di, N, dtype=torch.float64)
    want = []
    for t in range(T):
        h = torch.exp(dt[t, :, None] * A) * h + (dt[t] * u[t])[:, None] * Bm[t]
        want.append(h @ Cm[t] + Dv * u[t])
    for chunk in (1, 8, 16, 100):
        got = models.selective_scan(u[None], dt[None], A, Bm[None], Cm[None],
                                    Dv, chunk=chunk)[0]
        assert torch.allclose(got, torch.stack(want), atol=1e-12, rtol=1e-12)


def test_a_batch_reads_what_each_sequence_reads_alone():
    """Right padding does not move a causal model's logits."""
    for name in sorted(SMALL):
        model, cfg = _small(name, "float32")
        W = weights.make_weights(cfg, 3, torch.device("cpu"))
        seqs = [grammar.encode("x" * n) for n in (5, 17, 11)]
        ats = [[len(s) - 1, len(s) - 2] for s in seqs]
        got = models.logits_batch(model, W, seqs, ats)
        for s, at, g in zip(seqs, ats, got):
            assert torch.allclose(g, models.logits_batch(model, W, [s],
                                                         [at])[0],
                                  atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("num_rows", [1, 3])
def test_grammar_allows_what_the_ports_grammar_masks(num_rows):
    """Along random walks through the schema, the reference's allowed set
    equals the byte tokens of the port's mask at every step."""
    rng = np.random.default_rng(num_rows)
    port = JsonGrammar([Field("topic", "VARCHAR"), Field("tag", "VARCHAR")],
                       num_rows=num_rows, max_str=5)
    for _ in range(20):
        st, served, masks = port.init_state(), [], []
        while True:
            m = port.mask(st)
            masks.append(set(np.flatnonzero(m).tolist()))
            tok = int(rng.choice(sorted(masks[-1])))
            served.append(tok)
            st = port.advance(st, tok)
            if tok == grammar.EOS:
                break
        steps = list(grammar.walk(["topic", "tag"], num_rows, 5, served))
        assert [a for a, _ in steps] == masks
        assert all(t in a for a, t in steps)


def test_gap_reads_an_off_best_token():
    """A served answer that takes the reference's best allowed token at
    every step reads a gap of 0; one with a token changed reads that
    token's distance below the best."""
    model, cfg = _small("olmo-1b", "float32")
    W = weights.make_weights(cfg, 11, torch.device("cpu"))
    fields = [("topic", "VARCHAR")]
    prompt = 'Input: {"review": "the fries were cold #visit1"}'
    ids = grammar.encode(prompt)
    served, lgs = [], []
    while not served or served[-1] != grammar.EOS:
        allowed = list(grammar.walk(["topic"], 1, 3, served + [-1]))[-1][0]
        lg = models.logits_batch(model, W, [ids + served],
                                 [[len(ids) + len(served) - 1]])[0][0]
        served.append(max(sorted(allowed), key=lambda a: lg[a].item()))
        lgs.append((lg, allowed))
    text = bytes(served[:-1]).decode()
    def gap(answer):
        return judge.check_logits(model, W, [(prompt, answer, None)], [0],
                                  fields, 3)["logit_gap"]
    assert gap(text) < 1e-5
    j = text.index(': "') + 3                # the value's first byte
    lg, allowed = lgs[j]
    other = min(sorted(allowed - {ord('"')}), key=lambda a: lg[a].item())
    bad = text[:j] + chr(other) + text[j + 1:]
    want = (max(lg[a] for a in allowed) - lg[other]).item()
    assert gap(bad) >= want - 1e-4 and gap(bad) > 0.1
