"""The port's DecodeEngine (dense ragged mode, on the CPU) against the JAX
engine: one queue of mixed prompt lengths and budgets, more requests than
slots so that rows retire and refill in-wave.

Held: the same tokens per uid, equal waves / segments / tokens /
padded_tokens (the host-side logic is the reference's), the drain equals
the port's own solo ``generate`` per request, and ``submit`` rejects what
the reference rejects with the same exception types.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.launch.engine import DecodeEngine as JaxEngine
from repro.models import model as JM
from repro_torch.checkpoint.from_jax import from_jax
from repro_torch.configs.base import get_config
from repro_torch.core.adapter_bank import AdapterBank
from repro_torch.launch.engine import DecodeEngine
from repro_torch.models import model as M

LENS = [5, 9, 12, 7, 10, 3, 6]
GENS = [4, 2, 6, 3, 5, 7, 1]


@pytest.fixture(scope="module")
def served():
    kw = dict(n_kv_heads=2, dtype="float32")
    jcfg = jax_config("qwen2-7b").reduced().with_(**kw)
    tcfg = get_config("qwen2-7b").reduced().with_(**kw)
    tree = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(4)))
    rng = np.random.default_rng(4)
    for t in tree["adapters"]["stack"]["g0"]["s0"]["lora"].values():
        t["b"] = (0.1 * rng.standard_normal(t["b"].shape)).astype(np.float32)
    jparams, tparams = jax.tree.map(jnp.asarray, tree), from_jax(tree)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32)
               for n in LENS]
    jeng = JaxEngine(jcfg, slots=3)
    teng = DecodeEngine(tcfg, slots=3, device="cpu")
    juids = [jeng.submit(p, g) for p, g in zip(prompts, GENS)]
    tuids = [teng.submit(p, g) for p, g in zip(prompts, GENS)]
    jcomps, jstats = jeng.run(jparams)
    tcomps, tstats = teng.run(tparams)
    return dict(tcfg=tcfg, tparams=tparams, prompts=prompts,
                jtoks={u: c.tokens for u, c in
                       zip(juids, sorted(jcomps, key=lambda c: c.uid))},
                ttoks={u: c.tokens for u, c in
                       zip(tuids, sorted(tcomps, key=lambda c: c.uid))},
                jstats=jstats, tstats=tstats, tcomps=tcomps)


def test_drain_tokens_match_jax_engine(served):
    assert served["ttoks"].keys() == served["jtoks"].keys()
    for uid, toks in served["jtoks"].items():
        np.testing.assert_array_equal(served["ttoks"][uid], toks)
        assert len(toks) == GENS[uid]


@pytest.mark.parametrize("field", ["requests", "waves", "segments", "tokens",
                                   "padded_tokens", "timed_out"])
def test_drain_stats_match_jax_engine(served, field):
    assert getattr(served["tstats"], field) == \
        getattr(served["jstats"], field)
    assert served["tstats"].waves > 1            # in-wave refill happened


def test_drain_equals_solo_generate(served):
    cfg, params = served["tcfg"], served["tparams"]
    for uid, (p, g) in enumerate(zip(served["prompts"], GENS)):
        solo = M.generate(params, cfg, torch.from_numpy(p)[None], gen=g)
        np.testing.assert_array_equal(served["ttoks"][uid], solo[0].numpy())


def test_latency_histograms_and_completions(served):
    st = served["tstats"]
    assert st.ttft_hist["count"] == len(LENS)
    assert st.tok_latency_hist["count"] == sum(GENS)
    assert all(c.ttft_s is not None and c.latency_s >= c.ttft_s
               for c in served["tcomps"])
    assert 0 < st.utilization <= 1


BAD_SUBMITS = [
    dict(tokens=[], max_new_tokens=2),
    dict(tokens=[[1, 2]], max_new_tokens=2),
    dict(tokens=[1, 2], max_new_tokens=0),
    dict(tokens=[1, 2], max_new_tokens=2, deadline_s=-1.0),
    dict(tokens=[1, 2], max_new_tokens=2, domain="flowers"),   # no bank
]


@pytest.mark.parametrize("kw", BAD_SUBMITS)
def test_submit_rejects_what_the_reference_rejects(kw):
    jcfg = jax_config("qwen2-7b").reduced()
    tcfg = get_config("qwen2-7b").reduced()
    with pytest.raises(ValueError) as jerr:
        JaxEngine(jcfg, slots=2).submit(**kw)
    with pytest.raises(type(jerr.value)):
        DecodeEngine(tcfg, slots=2, device="cpu").submit(**kw)


def test_deadline_retires_with_partial_tokens():
    cfg = get_config("qwen2-7b").reduced()
    params = M.init(cfg, 0, device="cpu")
    eng = DecodeEngine(cfg, slots=2, device="cpu")
    eng.submit(np.arange(4), 8, deadline_s=0.0, sla="gold")
    eng.submit(np.arange(3), 2)
    comps, stats = eng.run(params)
    assert stats.timed_out == 1 and stats.requests == 2
    assert stats.sla_stats["gold"]["deadline_miss"] == 1


def test_engine_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine(get_config("qwen2-7b").reduced(), slots=2)


@pytest.mark.parametrize("kw", [dict(spec=object()), dict(paged=object()),
                                dict(mesh=object())])
def test_unported_engine_modes_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DecodeEngine(get_config("qwen2-7b").reduced(), device="cpu", **kw)


@pytest.mark.parametrize("make", ["init", "create"])
def test_slot_sharded_adapter_bank_raises(make):
    """The bank is ported; its slot sharding over a mesh is not yet."""
    cfg = get_config("qwen2-7b").reduced()
    adapters = M.init(cfg, 0, device="cpu")["adapters"]
    with pytest.raises(NotImplementedError,
                       match="ROADMAP: later, multi-GPU sharding"):
        if make == "init":
            AdapterBank(["a"], adapters, mesh=object())
        else:
            AdapterBank.create({"a": adapters}, mesh=object())
