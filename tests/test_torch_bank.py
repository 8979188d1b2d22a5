"""Multi-tenant serving in the port (AdapterBank, per-row ``adapter_ids``,
the engine's ``bank=`` mode) against the JAX package, in f32 on the CPU.

Both packages get the same numpy weights: one backbone and one adapter
set per domain, with LoRA ``b`` made nonzero (it inits to zeros, which
would make adapter selection untestable). Held:

- the port's bank layout equals the bridged JAX bank leaf for leaf;
- publish / snapshot / validate / rollback behave as the reference's;
- a mixed-domain drain gives the JAX bank drain's tokens and stats, and
  equals per-domain single-tenant drains within the port;
- ``generate`` and ``classify`` with ``adapter_ids`` match JAX;
- ``submit(domain=)`` and ``serve(domains=)`` reject what the reference
  rejects, with the same exception types.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.core.adapter_bank import AdapterBank as JaxBank
from repro.launch.engine import DecodeEngine as JaxEngine
from repro.models import model as JM
from repro_torch.checkpoint.from_jax import from_jax, to_numpy
from repro_torch.configs.base import get_config
from repro_torch.core import telemetry
from repro_torch.core.adapter_bank import AdapterBank
from repro_torch.launch.engine import DecodeEngine
from repro_torch.models import model as M

DOMAINS = ["nlp", "vision", "speech"]
LENS = [5, 9, 12, 7, 10, 3, 6]
GENS = [4, 2, 6, 3, 5, 7, 1]
DOMS = ["vision", "nlp", "speech", "speech", "nlp", "vision", "nlp"]
LOGIT_TOL = dict(atol=2e-5, rtol=2e-5)


def configs(arch="qwen2-7b", **kw):
    kw = dict(kw, dtype="float32")
    return (jax_config(arch).reduced().with_(**kw),
            get_config(arch).reduced().with_(**kw))


def numpy_adapters(jcfg, seed):
    """One domain's reference adapters as numpy, LoRA b made nonzero."""
    tree = jax.tree.map(np.asarray,
                        JM.init(jcfg, jax.random.PRNGKey(seed))["adapters"])
    rng = np.random.default_rng(seed)
    for t in tree["stack"]["g0"]["s0"]["lora"].values():
        t["b"] = (0.1 * rng.standard_normal(t["b"].shape)).astype(np.float32)
    return tree


def make_pair(arch="qwen2-7b", **kw):
    jcfg, tcfg = configs(arch, **kw)
    backbone = jax.tree.map(
        np.asarray, JM.init(jcfg, jax.random.PRNGKey(99))["backbone"])
    adapters = {d: numpy_adapters(jcfg, 10 + i)
                for i, d in enumerate(DOMAINS)}
    jbank = JaxBank.create({d: jax.tree.map(jnp.asarray, a)
                            for d, a in adapters.items()})
    tbank = AdapterBank.create({d: from_jax(a) for d, a in adapters.items()})
    jback = jax.tree.map(jnp.asarray, backbone)
    tback = from_jax({"backbone": backbone})["backbone"]
    return dict(jcfg=jcfg, tcfg=tcfg, adapters=adapters, jbank=jbank,
                tbank=tbank, jback=jback, tback=tback)


@pytest.fixture(scope="module")
def pair():
    return make_pair(n_kv_heads=2)


@contextlib.contextmanager
def recording():
    """The port's global telemetry switched on for the block."""
    tel = telemetry.enable()
    try:
        yield tel
    finally:
        telemetry.disable()


def walk(a, b, path=""):
    """Assert two port trees have one structure and equal leaves."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            walk(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            walk(x, y, f"{path}/{i}")
    else:
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert torch.equal(a, b), path


def prompts(cfg, seed=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in LENS]


# ---------------------------------------------------------------------------
# Bank mechanics
# ---------------------------------------------------------------------------

def test_bank_layout_equals_the_bridged_jax_bank(pair):
    """Per-layer leaves (n_slots, ...) — the port's form of the reference's
    (L, n_slots, ...) — and a slot-leading head, leaf for leaf."""
    got = pair["tbank"].serving_params(pair["tback"])
    want = from_jax(jax.tree.map(
        np.asarray, pair["jbank"].serving_params(pair["jback"])))
    walk(got, want)
    lay = got["adapters"]["stack"]["g0"]
    assert len(lay) == pair["tcfg"].n_layers
    assert lay[0]["s0"]["lora"]["q"]["a"].shape[0] == len(DOMAINS)
    assert pair["tbank"].n_slots == len(DOMAINS)


def test_publish_snapshot_roundtrip(pair):
    tcfg, adapters = pair["tcfg"], pair["adapters"]
    bank = AdapterBank.create({d: from_jax(a) for d, a in adapters.items()})
    for d in DOMAINS:                       # create == publish of each input
        walk(bank.snapshot(d), from_jax(adapters[d]))
    before = bank.snapshot("vision")
    other = bank.snapshot("nlp")
    new = from_jax(numpy_adapters(pair["jcfg"], 77))
    assert bank.version("vision") == 0
    bank.publish("vision", new)
    assert bank.version("vision") == 1
    walk(bank.snapshot("vision"), new)
    walk(before, from_jax(adapters["vision"]))   # the snapshot is a copy
    walk(bank.snapshot("nlp"), other)            # other slots untouched
    with pytest.raises(KeyError, match="no adapter slot"):
        bank.slot("unknown")
    assert bank.adapter_ids(["speech", "nlp"]).tolist() == [2, 0]
    assert bank.adapter_ids(["nlp"]).dtype == torch.int32
    assert tcfg.n_layers == 2


def _bad_payload(kind, good):
    bad = dict(good)
    if kind == "missing subtree":
        del bad["stack"]
    elif kind == "missing leaf":
        layers = [dict(l) for l in good["stack"]["g0"]]
        layers[0] = {"s0": {k: v for k, v in layers[0]["s0"].items()
                            if k != "prefix"}}
        bad["stack"] = {"g0": layers}
    elif kind == "bad shape":             # one prefix slot short
        layers = []
        for lay in good["stack"]["g0"]:
            s0 = dict(lay["s0"])
            s0["prefix"] = {"k": s0["prefix"]["k"][:-1],
                            "v": s0["prefix"]["v"]}
            layers.append({"s0": s0})
        bad["stack"] = {"g0": layers}
    else:                                   # a NaN in one leaf
        layers = [dict(l) for l in good["stack"]["g0"]]
        s0 = dict(layers[0]["s0"])
        lora = {t: dict(v) for t, v in s0["lora"].items()}
        b = lora["q"]["b"].clone()
        b.view(-1)[3] = float("nan")
        lora["q"]["b"] = b
        s0["lora"] = lora
        layers[0] = {"s0": s0}
        bad["stack"] = {"g0": layers}
    return bad


def _to_jax_payload(tree):
    """Port payload -> the reference's tree (numpy, stacked layers)."""
    return jax.tree.map(jnp.asarray, to_numpy(tree))


@pytest.mark.parametrize("kind", ["missing subtree", "missing leaf",
                                  "bad shape", "nan"])
def test_validate_rejects_what_the_reference_rejects(pair, kind):
    adapters = pair["adapters"]
    good = from_jax(numpy_adapters(pair["jcfg"], 5))
    bad = _bad_payload(kind, good)
    jbank = JaxBank.create({d: jax.tree.map(jnp.asarray, a)
                            for d, a in adapters.items()})
    payload = _to_jax_payload(bad)
    with pytest.raises(Exception) as jerr:
        jbank.publish("nlp", payload)
    assert "publish('nlp')" in str(jerr.value)
    bank = AdapterBank.create({d: from_jax(a) for d, a in adapters.items()})
    with recording() as tel, pytest.raises(type(jerr.value)):
        bank.publish("nlp", bad)
    assert tel.counters.get("bank.publish_rejects") == 1
    assert bank.version("nlp") == 0 and bank.last_known_good_version(
        "nlp") is None
    walk(bank.snapshot("nlp"), from_jax(adapters["nlp"]))   # still serving


def test_rollback_restores_the_last_known_good(pair):
    adapters = pair["adapters"]
    bank = AdapterBank.create({d: from_jax(a) for d, a in adapters.items()})
    with pytest.raises(ValueError, match="no last-known-good"):
        bank.rollback("speech")
    new = from_jax(numpy_adapters(pair["jcfg"], 31))
    bank.publish("speech", new)
    assert bank.last_known_good_version("speech") == 0
    assert bank.rollback("speech") == 0
    walk(bank.snapshot("speech"), from_jax(adapters["speech"]))
    assert bank.rollback("speech") == 0         # idempotent
    walk(bank.snapshot("speech"), from_jax(adapters["speech"]))
    assert bank.rollbacks["speech"] == 2 and bank.version("speech") == 3


def test_bank_telemetry_matches_the_reference_names(pair):
    bank = AdapterBank.create({d: from_jax(a)
                               for d, a in pair["adapters"].items()})
    with recording() as tel:
        bank.publish("nlp", bank.snapshot("vision"))
        bank.rollback("nlp")
    assert {s.name for s in tel.spans} == {"bank.publish", "bank.snapshot",
                                           "bank.rollback"}
    assert tel.counters == {"bank.snapshots": 2, "bank.publishes": 2,
                            "bank.rollbacks": 1}


# ---------------------------------------------------------------------------
# Mixed-domain serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def drained(pair):
    jcfg, tcfg = pair["jcfg"], pair["tcfg"]
    ps = prompts(tcfg)
    jeng = JaxEngine(jcfg, slots=3, bank=pair["jbank"])
    teng = DecodeEngine(tcfg, slots=3, bank=pair["tbank"], device="cpu")
    juids = [jeng.submit(p, g, domain=d) for p, g, d in zip(ps, GENS, DOMS)]
    tuids = [teng.submit(p, g, domain=d) for p, g, d in zip(ps, GENS, DOMS)]
    jcomps, jstats = jeng.run(pair["jbank"].serving_params(pair["jback"]))
    tcomps, tstats = teng.run(pair["tbank"].serving_params(pair["tback"]))
    jby = {c.uid: c.tokens for c in jcomps}
    tby = {c.uid: c.tokens for c in tcomps}
    return dict(prompts=ps, jtoks=[jby[u] for u in juids],
                ttoks=[tby[u] for u in tuids], jstats=jstats, tstats=tstats)


def test_mixed_drain_tokens_match_jax_bank_drain(drained):
    for i, (got, want) in enumerate(zip(drained["ttoks"],
                                        drained["jtoks"])):
        np.testing.assert_array_equal(got, want)
        assert len(got) == GENS[i]


@pytest.mark.parametrize("field", ["requests", "waves", "segments", "tokens",
                                   "padded_tokens"])
def test_mixed_drain_stats_match_jax_bank_drain(drained, field):
    assert getattr(drained["tstats"], field) == \
        getattr(drained["jstats"], field)
    assert drained["tstats"].waves > 1            # in-wave refill happened


def test_mixed_drain_equals_per_domain_drains(pair, drained):
    tcfg = pair["tcfg"]
    for i, (p, g, d) in enumerate(zip(drained["prompts"], GENS, DOMS)):
        solo = {"backbone": pair["tback"],
                "adapters": pair["tbank"].snapshot(d)}
        want, _ = DecodeEngine(tcfg, slots=3, device="cpu").serve(
            solo, p[None], gen=g)
        np.testing.assert_array_equal(drained["ttoks"][i], want[0])


def test_domains_give_different_tokens(pair):
    """Adapter selection is visible: one prompt, three domains."""
    p = prompts(pair["tcfg"])[2]
    params = pair["tbank"].serving_params(pair["tback"])
    out = M.generate(params, pair["tcfg"],
                     torch.from_numpy(np.stack([p] * 3)), gen=6,
                     adapter_ids=pair["tbank"].adapter_ids(DOMAINS))
    assert len({tuple(r) for r in out.tolist()}) > 1


def test_publish_serves_next_wave(pair):
    tcfg = pair["tcfg"]
    bank = AdapterBank.create({d: from_jax(a)
                               for d, a in pair["adapters"].items()})
    eng = DecodeEngine(tcfg, slots=2, bank=bank, device="cpu")
    ps = np.random.default_rng(9).integers(
        0, tcfg.vocab_size, (2, 10)).astype(np.int32)
    params = bank.serving_params(pair["tback"])
    served0, _ = eng.serve(params, ps, gen=4, domains=["nlp", "vision"])
    new = from_jax(numpy_adapters(pair["jcfg"], 123))
    bank.publish("vision", new)
    served1, _ = eng.serve(params, ps, gen=4, domains=["nlp", "vision"])
    want, _ = DecodeEngine(tcfg, slots=2, device="cpu").serve(
        {"backbone": pair["tback"], "adapters": new}, ps[1:], gen=4)
    np.testing.assert_array_equal(served1[1], want[0])    # fresh read
    np.testing.assert_array_equal(served1[0], served0[0])  # nlp untouched


@pytest.mark.parametrize("ragged", [False, True])
def test_generate_adapter_ids_matches_jax_generate_scan(pair, ragged):
    jcfg, tcfg = pair["jcfg"], pair["tcfg"]
    toks = np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (4, 9)).astype(np.int32)
    lens = np.array([9, 4, 6, 2], np.int32) if ragged else None
    order = ["speech", "nlp", "speech", "vision"]
    want = JM.generate_scan(pair["jbank"].serving_params(pair["jback"]),
                            jcfg, jnp.asarray(toks), gen=5,
                            adapter_ids=pair["jbank"].adapter_ids(order),
                            prompt_lens=lens)
    got = M.generate(pair["tbank"].serving_params(pair["tback"]), tcfg,
                     torch.from_numpy(toks), gen=5,
                     adapter_ids=pair["tbank"].adapter_ids(order),
                     prompt_lens=None if lens is None
                     else torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_forward_adapter_ids_matches_jax(pair):
    jcfg, tcfg = pair["jcfg"], pair["tcfg"]
    toks = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (3, 10)).astype(np.int32)
    order = ["vision", "speech", "nlp"]
    want = JM.forward(pair["jbank"].serving_params(pair["jback"]),
                      {"tokens": jnp.asarray(toks)}, jcfg, mode="eval",
                      adapter_ids=pair["jbank"].adapter_ids(order))["logits"]
    got = M.forward(pair["tbank"].serving_params(pair["tback"]),
                    {"tokens": torch.from_numpy(toks)}, tcfg,
                    adapter_ids=pair["tbank"].adapter_ids(order))["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mixed", [False, True])
def test_classify_matches_jax(mixed):
    """vit-edge (the paper's case-study backbone, with its 5-way head):
    per-row gathered heads with ``adapter_ids``, the plain head without."""
    p = make_pair("vit-edge")
    jcfg, tcfg = p["jcfg"], p["tcfg"]
    toks = np.random.default_rng(6).integers(
        0, tcfg.vocab_size, (4, 12)).astype(np.int32)
    if mixed:
        order = ["speech", "nlp", "vision", "nlp"]
        want = JM.classify(p["jbank"].serving_params(p["jback"]),
                           {"tokens": jnp.asarray(toks)}, jcfg,
                           adapter_ids=p["jbank"].adapter_ids(order))
        got = M.classify(p["tbank"].serving_params(p["tback"]),
                         {"tokens": torch.from_numpy(toks)}, tcfg,
                         adapter_ids=p["tbank"].adapter_ids(order))
    else:
        jp = {"backbone": p["jback"],
              "adapters": jax.tree.map(jnp.asarray, p["adapters"]["nlp"])}
        want = JM.classify(jp, {"tokens": jnp.asarray(toks)}, jcfg)
        got = M.classify({"backbone": p["tback"],
                          "adapters": from_jax(p["adapters"]["nlp"])},
                         {"tokens": torch.from_numpy(toks)}, tcfg)
    assert got.shape == (4, tcfg.peft.head_dim_out) and \
        got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_mixed_classify_equals_per_domain_classify():
    p = make_pair("vit-edge")
    tcfg = p["tcfg"]
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, tcfg.vocab_size, (3, 12)).astype(np.int32))
    got = M.classify(p["tbank"].serving_params(p["tback"]), {"tokens": toks},
                     tcfg, adapter_ids=p["tbank"].adapter_ids(DOMAINS))
    for i, d in enumerate(DOMAINS):
        want = M.classify({"backbone": p["tback"],
                           "adapters": p["tbank"].snapshot(d)},
                          {"tokens": toks[i:i + 1]}, tcfg)
        np.testing.assert_allclose(got[i:i + 1].numpy(), want.numpy(),
                                   **LOGIT_TOL)


# ---------------------------------------------------------------------------
# submit(domain=) / serve(domains=) validation, as the reference
# ---------------------------------------------------------------------------

def _engines(pair):
    return (JaxEngine(pair["jcfg"], slots=2, bank=pair["jbank"]),
            DecodeEngine(pair["tcfg"], slots=2, bank=pair["tbank"],
                         device="cpu"))


def _same_error(jfn, tfn):
    with pytest.raises(Exception) as jerr:
        jfn()
    with pytest.raises(type(jerr.value)):
        tfn()
    return jerr.value


@pytest.mark.parametrize("case", ["unknown domain", "tenant-less after",
                                  "other length after", "domain after"])
def test_submit_rejects_what_the_reference_rejects(pair, case):
    z8, z12 = np.zeros(8, np.int32), np.zeros(12, np.int32)
    engines = _engines(pair)
    if case == "domain after":            # tenant-less first, then a domain
        for e in engines:
            e.submit(z8, 2)
        err = _same_error(lambda: engines[0].submit(z8, 2, domain="nlp"),
                          lambda: engines[1].submit(z8, 2, domain="nlp"))
    elif case == "unknown domain":
        err = _same_error(lambda: engines[0].submit(z8, 2, domain="nope"),
                          lambda: engines[1].submit(z8, 2, domain="nope"))
    else:
        for e in engines:
            e.submit(z8, 2, domain="nlp")
        p = z8 if case == "tenant-less after" else z12
        err = _same_error(lambda: engines[0].submit(p, 2),
                          lambda: engines[1].submit(p, 2))
    assert isinstance(err, ValueError)
    assert engines[1].pending() == engines[0].pending()   # queue intact


def test_serve_rejects_domains_that_do_not_cover_every_prompt(pair):
    jeng, teng = _engines(pair)
    z = np.zeros((2, 8), np.int32)
    _same_error(
        lambda: jeng.serve(pair["jbank"].serving_params(pair["jback"]), z,
                           gen=2, domains=["nlp"]),
        lambda: teng.serve(pair["tbank"].serving_params(pair["tback"]), z,
                           gen=2, domains=["nlp"]))
    assert teng.pending() == 0


def test_domain_without_a_bank_is_rejected_as_the_reference(pair):
    _same_error(
        lambda: JaxEngine(pair["jcfg"], slots=2).submit(
            np.zeros(8, np.int32), 2, domain="nlp"),
        lambda: DecodeEngine(pair["tcfg"], slots=2, device="cpu").submit(
            np.zeros(8, np.int32), 2, domain="nlp"))


def test_tenancy_check_leaves_the_queue_serving(pair):
    """A rejected submit does not poison the drain (reference semantics)."""
    eng = DecodeEngine(pair["tcfg"], slots=2, bank=pair["tbank"],
                       device="cpu")
    eng.submit(np.arange(1, 9, dtype=np.int32), 2, domain="nlp")
    with pytest.raises(ValueError, match="carry a domain"):
        eng.submit(np.zeros(8, np.int32), 2)
    assert eng.pending() == 1
    comps, stats = eng.run(pair["tbank"].serving_params(pair["tback"]))
    assert len(comps) == 1 and stats.tokens == 2

