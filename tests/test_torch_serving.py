"""repro_torch serving engine and continuous batcher against the JAX ones.

Both engines run the olmo-1b smoke config (vocab 259) in float32 on the same
weights (``params_from_jax``) and the same sampling seed; the port draws its
Gumbel noise from the same numpy generator with the same shapes.  Texts and
every GenStats counter must be equal (wall time aside), at temperature 0
and 0.7, with and without a shared prefix, through ``generate`` and through
the dense ``ContinuousBatcher``.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest

import repro.configs as JC
import repro_torch.configs as TC
from repro.serving import grammar as JG
from repro.serving import scheduler as JS
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.models.params import params_from_jax
from repro_torch.serving import grammar as TG
from repro_torch.serving import scheduler as TS
from repro_torch.serving.engine import InferenceEngine as TorchEngine
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

PREFIX = "INSTRUCTIONS: extract the number and a short tag.\n"


@pytest.fixture(scope="module")
def _engine_pair():
    jcfg = JC.get_smoke_config("olmo-1b").replace(vocab_size=259,
                                                 compute_dtype="float32")
    tcfg = TC.get_smoke_config("olmo-1b").replace(vocab_size=259,
                                                 compute_dtype="float32")
    je = JaxEngine(jcfg, max_len=256, seed=0)
    te = TorchEngine(tcfg, params_from_jax(tcfg, jax.tree.map(np.asarray,
                                                              je.params),
                                           "cpu"),
                     max_len=256, seed=0, device="cpu")
    return je, te


@pytest.fixture
def engines(_engine_pair):
    """The module's engine pair (one JAX compile cache for all tests), put
    back to a fresh state: sampling seed, prefix memo and totals."""
    for eng in _engine_pair:
        eng._rng = np.random.default_rng(0)
        eng._prefix_kv.clear()
        eng.total = type(eng.total)()
    return _engine_pair


def _stats(s):
    d = dataclasses.asdict(s)
    d.pop("wall_s")
    return d


def _grammars(max_str=8):
    fields = [("v", "INTEGER"), ("tag", "VARCHAR")]
    return (JG.JsonGrammar([JG.Field(n, t) for n, t in fields],
                           max_str=max_str),
            TG.JsonGrammar([TG.Field(n, t) for n, t in fields],
                           max_str=max_str))


@pytest.mark.parametrize("prefix", ["", PREFIX], ids=["no_prefix", "prefix"])
@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_generate_matches_jax(engines, temperature, prefix):
    je, te = engines
    jg, tg = _grammars()
    prompts = ["row: item42", "row: b", "row: a longer third row"]
    for _ in range(2):                   # the second call hits the prefix memo
        a = je.generate(prompts, grammar=jg, shared_prefix=prefix,
                        max_new_tokens=40, temperature=temperature)
        b = te.generate(prompts, grammar=tg, shared_prefix=prefix,
                        max_new_tokens=40, temperature=temperature)
        assert b.texts == a.texts
        assert _stats(b.stats) == _stats(a.stats)
    assert _stats(te.total) == _stats(je.total)


def _run_batcher(eng, sched, grammar, n, *, slots, budget=48, short=None,
                 n_samples=1, temperature=0.0):
    reqs = [sched.Request(prompt=f"item {i} " + "x" * (i % 3), grammar=grammar,
                          max_new_tokens=budget, n_samples=n_samples)
            for i in range(n)]
    if short is not None:
        reqs[short].max_new_tokens = 2   # cannot finish the JSON grammar
    cb = sched.ContinuousBatcher(eng, num_slots=slots)
    done = cb.run(reqs, temperature=temperature)
    return done, cb.stats


@pytest.mark.parametrize("slots", [2, 8])
def test_batcher_matches_jax(engines, slots):
    je, te = engines
    jg, tg = _grammars()
    a, sa = _run_batcher(je, JS, jg, 7, slots=slots, temperature=0.7)
    b, sb = _run_batcher(te, TS, tg, 7, slots=slots, temperature=0.7)
    assert [(r.text, r.error) for r in b] == [(r.text, r.error) for r in a]
    assert _stats(sb) == _stats(sa)
    assert [r.rid for r in b] == list(range(7))


def test_batcher_token_budget_eviction_matches_jax(engines):
    je, te = engines
    jg, tg = _grammars()
    a, sa = _run_batcher(je, JS, jg, 4, slots=2, short=1)
    b, sb = _run_batcher(te, TS, tg, 4, slots=2, short=1)
    assert b[1].error and "budget" in b[1].error and b[1].text is not None
    for i in (0, 2, 3):
        assert b[i].error is None
        json.loads(b[i].text)
    assert [(r.text, r.error) for r in b] == [(r.text, r.error) for r in a]
    assert _stats(sb) == _stats(sa)


def test_batcher_n_samples_vote_matches_jax(engines):
    """Dense layout: n_samples streams run as independent jobs, majority
    voted per request."""
    je, te = engines
    jg, tg = _grammars(max_str=3)
    a, sa = _run_batcher(je, JS, jg, 3, slots=4, n_samples=3,
                         temperature=0.7)
    b, sb = _run_batcher(te, TS, tg, 3, slots=4, n_samples=3,
                         temperature=0.7)
    assert [r.samples for r in b] == [r.samples for r in a]
    assert all(len(r.samples) == 3 for r in b)
    assert [r.text for r in b] == [r.text for r in a]
    assert _stats(sb) == _stats(sa)

