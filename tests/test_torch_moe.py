"""The port's moe family against the JAX package, on the CPU.

``moe_apply`` (y and the aux loss, 3-D and 2-D inputs, at the default
capacity factor, at a small one and with no dropping) and its gradients
against ``jax.vjp``; the model's logits and aux, greedy generation, engine,
paged and bank drains, an HFSL round from bridged JAX state, the SL chain
and ``spec_generate`` against the reference; the weight bridge; the
determinism of the dispatch and its backward; top-k's tie rule.

Two configs, in f32: reduced granite-moe-1b-a400m (2 layers, d_model 128,
4 / 2 heads of 32, 8 experts top-2 with d_ff_expert 64, vocab 64) and
reduced kimi-k2-1t-a32b (d_model 128, 4 / 4 heads of 32, 4 experts top-2
and the shared expert, d_ff_expert 64), the one config whose shared
expert runs. LoRA ``b`` inits to zeros in both packages, so it is set to
seeded values first. Each module's JAX side runs once, in fixtures.

Capacity is part of the semantics: a ragged or padded wave drops other
assignments than a solo run, so every drain-against-``generate`` claim
runs with ``capacity_factor=-1`` (no dropping), as
tests/test_decode_consistency.py does; the default factor is held only
against the reference on the same batch.

Tolerances are those of tests/test_kernels.py: f32 2e-5; greedy tokens
identical; an HFSL round's adapters as in tests/test_torch_hfsl.py (sgd
1e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.core import hfsl as jhfsl
from repro.core import sl_pipeline as jsl
from repro.core import spec_decode as JSD
from repro.core.adapter_bank import AdapterBank as JaxBank
from repro.core.paged import PagedSpec as JaxPagedSpec
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.launch.engine import DecodeEngine as JaxEngine
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.optim import optimizers as jopt
from repro_torch.checkpoint.from_jax import (from_jax, hfsl_state_from_jax,
                                             hfsl_state_to_numpy, to_numpy)
from repro_torch.configs.base import get_config
from repro_torch.core import hfsl, sl_pipeline
from repro_torch.core import spec_decode as SD
from repro_torch.core.adapter_bank import AdapterBank
from repro_torch.core.paged import PagedSpec
from repro_torch.data import pipeline, synthetic
from repro_torch.launch.engine import DecodeEngine
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.params import tree_leaves, tree_paths
from repro_torch.models.transformer import groups_for, paged_subs
from repro_torch.optim import optimizers as topt

TOL = dict(atol=2e-5, rtol=2e-5)
SGD_TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = ["granite-moe-1b-a400m", "kimi-k2-1t-a32b"]
LENS = [5, 9, 12, 7, 10, 3, 6]
GENS = [4, 2, 6, 3, 5, 7, 1]
DOMAINS = ["nlp", "vision", "speech"]
DOMS = ["vision", "nlp", "speech", "nlp", "vision", "speech", "nlp"]


def narrow(cfg, factor=None, **kw):
    """The reduced config at d_model 128, heads of 32, vocab 64, f32, a
    5-class head; granite keeps GQA group 2 and gets 8 experts."""
    c = cfg.reduced()
    m = dict(d_ff_expert=64)
    if cfg.name == "granite-moe-1b-a400m":
        kw.setdefault("n_kv_heads", 2)
        m["n_experts"] = 8
    if factor is not None:
        m["capacity_factor"] = factor
    return c.with_(d_model=128, head_dim=32, vocab_size=64, dtype="float32",
                   moe=dataclasses.replace(c.moe, **m),
                   peft=dataclasses.replace(c.peft, head_dim_out=5), **kw)


def configs(arch="granite-moe-1b-a400m", factor=None, **kw):
    return (narrow(jax_config(arch), factor, **kw),
            narrow(get_config(arch), factor, **kw))


def numpy_params(jcfg, seed=0):
    tree = jax.tree.map(np.asarray, jax.jit(JM.init, static_argnums=0)(
        jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for t in tree["adapters"]["stack"]["g0"]["s0"]["lora"].values():
        t["b"] = (0.1 * rng.standard_normal(t["b"].shape)).astype(
            t["b"].dtype)
    return tree


def make(arch="granite-moe-1b-a400m", factor=None, seed=0, **kw):
    jcfg, tcfg = configs(arch, factor, **kw)
    tree = numpy_params(jcfg, seed)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), from_jax(tree)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    return make(request.param)


@pytest.fixture(scope="module")
def nodrop():
    """Reduced granite with ``capacity_factor=-1``."""
    return make(factor=-1, seed=1)


def tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def layer_moe(jp, tp, l=0):
    jl = jax.tree.map(lambda a: a[l],
                      jp["backbone"]["layers"]["g0"]["s0"]["moe"])
    return jl, tp["backbone"]["layers"]["g0"][l]["s0"]["moe"]


def hidden(cfg, shape, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("factor", [1.25, 0.5, 0.0, -1.0])
def test_capacity_matches_jax(factor):
    for arch in ARCHS:
        for jcfg, tcfg in (configs(arch), (jax_config(arch),
                                           get_config(arch))):
            for T in (1, 7, 8, 64, 100, 4096):
                assert moe.capacity(T, tcfg, factor) == \
                    jmoe.capacity(T, jcfg, factor), (arch, T)
                assert moe.capacity(T, tcfg) == jmoe.capacity(T, jcfg)
    assert moe.capacity(8, get_config("granite-moe-1b-a400m"), 1.25) == 8
    assert moe.capacity(4096, get_config("granite-moe-1b-a400m")) == 1280


@pytest.mark.parametrize("factor", [None, 0.25, -1])
@pytest.mark.parametrize("shape", [(3, 11), (13,)])
def test_moe_apply_matches_jax(setup, shape, factor):
    jcfg, tcfg, jp, tp = setup
    jl, tl = layer_moe(jp, tp)
    x = hidden(tcfg, shape)
    jy, jaux = jax.jit(jmoe.moe_apply, static_argnums=(2, 3))(
        jl, jnp.asarray(x), jcfg, factor)
    ty, taux = moe.moe_apply(tl, torch.from_numpy(x), tcfg,
                             capacity_factor=factor)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    if factor == 0.25 and len(shape) == 2:
        # the small factor drops assignments: some tokens lose experts
        T, m = x.size // tcfg.d_model, tcfg.moe
        assert moe.capacity(T, tcfg, factor) * m.n_experts < T * m.top_k


def test_moe_apply_gradients_match_jax_vjp(setup):
    jcfg, tcfg, jp, tp = setup
    jl, tl = layer_moe(jp, tp)
    x = hidden(tcfg, (2, 9), seed=3)
    g = hidden(tcfg, (2, 9), seed=4)
    @jax.jit
    def vjps(x, g):
        (y, _), vjp = jax.vjp(lambda x: jmoe.moe_apply(jl, x, jcfg), x)
        return (vjp((g, jnp.zeros((), jnp.float32)))[0],
                vjp((jnp.zeros_like(y), jnp.ones((), jnp.float32)))[0])
    jdx, jdx_aux = vjps(jnp.asarray(x), jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    ty, taux = moe.moe_apply(tl, xt, tcfg)
    (dx,) = torch.autograd.grad((ty * torch.from_numpy(g)).sum(), xt,
                                retain_graph=True)
    (dx_aux,) = torch.autograd.grad(taux, xt)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(dx_aux.numpy(), np.asarray(jdx_aux),
                               atol=1e-7, rtol=2e-5)
    assert all(not p.requires_grad for p in tree_leaves(tl))


def test_two_runs_give_equal_bits(setup):
    """The forward and its backward take no atomic accumulation: equal
    inputs give equal bits, the gradients included."""
    _, tcfg, _, tp = setup
    tl = tp["backbone"]["layers"]["g0"][0]["s0"]["moe"]
    x = hidden(tcfg, (4, 16), seed=5)
    g = torch.from_numpy(hidden(tcfg, (4, 16), seed=6))
    runs = []
    for _ in range(2):
        xt = torch.from_numpy(x).requires_grad_(True)
        y, aux = moe.moe_apply(tl, xt, tcfg)
        ((y * g).sum() + aux).backward()
        runs.append((y.detach(), aux.detach(), xt.grad))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_top_k_breaks_ties_as_jax():
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = moe.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_equal_router_columns_route_to_the_lower_expert():
    """Two equal router columns above the rest: top-1 takes the lower
    expert for every token, as the reference does."""
    jcfg, tcfg = configs()
    tree = numpy_params(jcfg)
    jcfg, tcfg = (c.with_(moe=dataclasses.replace(c.moe, top_k=1))
                  for c in (jcfg, tcfg))
    jl = jax.tree.map(lambda a: np.array(a[0]),
                      tree["backbone"]["layers"]["g0"]["s0"]["moe"])
    col = np.abs(np.random.default_rng(7).standard_normal(
        tcfg.d_model)).astype(np.float32)
    jl["router"][:] = -1.0
    jl["router"][:, 5] = jl["router"][:, 3] = col
    x = np.abs(hidden(tcfg, (10,), seed=8))
    jy, _ = jax.jit(jmoe.moe_apply, static_argnums=2)(
        jax.tree.map(jnp.asarray, jl), jnp.asarray(x), jcfg)
    tl = from_jax(jl)
    ty, _ = moe.moe_apply(tl, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    probs = torch.softmax(torch.from_numpy(x) @ tl["router"], -1)
    assert torch.equal(moe.top_k(probs, 1)[1][:, 0],
                       torch.full((10,), 3, dtype=torch.long))
    # expert 5 (an unequal weight) would have given another output
    tl5 = {**tl, "gate": tl["gate"].clone()}
    tl5["gate"][3] = tl["gate"][5]
    other, _ = moe.moe_apply(tl5, torch.from_numpy(x), tcfg)
    assert not torch.allclose(other, ty)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def test_groups_spec_and_published_sizes():
    _, tcfg = configs()
    assert groups_for(tcfg) == [("g0", ("moe",), 2)]
    assert paged_subs(tcfg) == [("g0", "s0")]
    cfg = get_config("granite-moe-1b-a400m")
    spec = M.backbone_spec(cfg)
    n = sum(int(np.prod(s.shape)) for s in tree_leaves(spec))
    assert n == cfg.param_count() == 1_334_628_352
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim_, cfg.moe.n_experts, cfg.moe.top_k,
            cfg.moe.d_ff_expert, cfg.vocab_size, cfg.tie_embeddings) == \
        (24, 1024, 16, 8, 64, 32, 8, 512, 49155, True)
    layer = spec["layers"]["g0"][0]["s0"]["moe"]
    assert layer["router"].shape == (1024, 32)
    assert layer["router"].dtype == torch.float32
    assert layer["down"].shape == (32, 512, 1024)
    assert "shared" not in layer
    kimi = M.backbone_spec(get_config("kimi-k2-1t-a32b"))
    assert kimi["layers"]["g0"][60]["s0"]["moe"]["shared"]["gate"].shape \
        == (7168, 2048)


def test_init_scales_the_stacked_experts_by_their_fan_in():
    """``scaled`` leaves of three dims take the second-last as fan-in, as
    the reference's ``init_from_spec``: d for gate/up, d_ff_expert for
    down."""
    _, tcfg = configs()
    p = M.init(tcfg, 0, device="cpu")["backbone"]["layers"]["g0"][0]["s0"]
    for name, fan_in in (("gate", 128), ("up", 128), ("down", 64),
                         ("router", 128)):
        std = float(p["moe"][name].float().std())
        assert abs(std * fan_in ** 0.5 - 1.0) < 0.05, (name, std)


def test_bridge_round_trips_the_moe_leaves_bit_for_bit(setup):
    jcfg, tcfg, jp, tp = setup
    back = to_numpy(tp)
    want = jax.tree.map(np.asarray, jp)
    leaves_w = jax.tree_util.tree_leaves_with_path(want)
    leaves_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(leaves_w) == len(leaves_b)
    for path, w in leaves_w:
        np.testing.assert_array_equal(leaves_b[path], w)
    stacked = want["backbone"]["layers"]["g0"]["s0"]["moe"]
    assert stacked["router"].shape == (2, 128, tcfg.moe.n_experts)
    assert stacked["gate"].shape == (2, tcfg.moe.n_experts, 128, 64)
    assert ("shared" in stacked) == bool(tcfg.moe.n_shared_experts)
    layout = {p: (tuple(a.shape), a.dtype)
              for p, a in tree_paths(M.init(tcfg, 0, device="cpu"))}
    assert layout == {p: (tuple(a.shape), a.dtype)
                      for p, a in tree_paths(tp)}


def test_forward_logits_and_aux_match(setup):
    jcfg, tcfg, jp, tp = setup
    toks = tokens(tcfg, 2, 11)
    want = jax.jit(lambda p, t: JM.forward(p, {"tokens": t}, jcfg,
                                           mode="eval"))(
        jp, jnp.asarray(toks))
    got = M.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    np.testing.assert_allclose(got["logits"].detach().numpy(),
                               np.asarray(want["logits"]), **TOL)
    np.testing.assert_allclose(float(got["aux"]), float(want["aux"]), **TOL)
    assert float(got["aux"]) > 0.0
    # lm_loss adds it; classify_loss does not, as in the reference
    batch = {"tokens": toks, "labels": tokens(tcfg, 2, 11, seed=1)}
    jl, _ = jax.jit(lambda p, b: JM.lm_loss(p, b, jcfg))(
        jp, jax.tree.map(jnp.asarray, batch))
    tl, aux = M.lm_loss(tp, {k: torch.from_numpy(v)
                             for k, v in batch.items()}, tcfg)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    np.testing.assert_allclose(float(aux["aux"]), float(want["aux"]), **TOL)


@pytest.fixture(scope="module")
def scans(setup):
    """The reference's greedy generations, plain and ragged."""
    jcfg, tcfg, jp, _ = setup
    toks = tokens(tcfg, 3, 12, seed=2)
    out = {}
    for ragged in (False, True):
        lens = np.array([12, 4, 7], np.int32) if ragged else None
        out[ragged] = (toks, lens, np.asarray(JM.generate_scan(
            jp, jcfg, jnp.asarray(toks), gen=10, prompt_lens=lens)))
    return out


@pytest.mark.parametrize("ragged", [False, True])
def test_greedy_generate_matches_generate_scan(setup, scans, ragged):
    _, tcfg, _, tp = setup
    toks, lens, want = scans[ragged]
    got = M.generate(tp, tcfg, torch.from_numpy(toks), gen=10,
                     prompt_lens=None if lens is None
                     else torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# Serving: engine, paged and bank drains (no dropping)
# ---------------------------------------------------------------------------

def queue(cfg, seed=4, system=0):
    """LENS prompts; with ``system`` every prompt opens with the same
    ``system`` tokens."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, cfg.vocab_size, system).astype(np.int32)
    return [np.concatenate([head, rng.integers(0, cfg.vocab_size, n)
                            .astype(np.int32)]) for n in LENS]


def drain(eng, params, prompts, domains=None):
    uids = [eng.submit(p, g, domain=None if domains is None else domains[i])
            for i, (p, g) in enumerate(zip(prompts, GENS))]
    comps, stats = eng.run(params)
    by = {c.uid: c.tokens for c in comps}
    return [by[u] for u in uids], stats


STATS = ["requests", "waves", "segments", "tokens", "padded_tokens"]
PAGED = dict(n_blocks=48, block_size=4, share_prefix=True)


@pytest.fixture(scope="module")
def drained(nodrop):
    jcfg, tcfg, jp, tp = nodrop
    prompts = queue(tcfg, system=8)
    out = dict(prompts=prompts)
    out["jt"], out["js"] = drain(JaxEngine(jcfg, slots=3), jp, prompts)
    out["tt"], out["ts"] = drain(DecodeEngine(tcfg, slots=3, device="cpu"),
                                 tp, prompts)
    out["jpt"], out["jps"] = drain(
        JaxEngine(jcfg, slots=3, paged=JaxPagedSpec(**PAGED)), jp, prompts)
    out["tpt"], out["tps"] = drain(
        DecodeEngine(tcfg, slots=3, device="cpu", paged=PagedSpec(**PAGED)),
        tp, prompts)
    return out


def test_engine_drain_matches_jax_and_solo_generate(nodrop, drained):
    _, tcfg, _, tp = nodrop
    for a, b in zip(drained["tt"], drained["jt"]):
        np.testing.assert_array_equal(a, b)
    for f in STATS:
        assert getattr(drained["ts"], f) == getattr(drained["js"], f), f
    assert drained["ts"].waves > 1
    for p, g, toks in zip(drained["prompts"], GENS, drained["tt"]):
        solo = M.generate(tp, tcfg, torch.from_numpy(p)[None], gen=g)
        np.testing.assert_array_equal(toks, solo[0].numpy())


def test_paged_drain_with_prefix_sharing_matches_jax_and_dense(drained):
    for a, b, c in zip(drained["tpt"], drained["jpt"], drained["tt"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert drained["tps"].prefix_hits > 0
    for f in STATS + ["pool_blocks_alloc", "pool_peak_blocks",
                      "cache_tokens", "prefix_hits", "prefix_hit_tokens"]:
        assert getattr(drained["tps"], f) == getattr(drained["jps"], f), f


@pytest.fixture(scope="module")
def bank_drained(nodrop):
    jcfg, tcfg, jp, tp = nodrop
    ads = {d: numpy_params(jcfg, 10 + n)["adapters"]
           for n, d in enumerate(DOMAINS)}
    jbank = JaxBank.create({d: jax.tree.map(jnp.asarray, a)
                            for d, a in ads.items()})
    tbank = AdapterBank.create({d: from_jax(a) for d, a in ads.items()})
    prompts = queue(tcfg, seed=6)
    jt, js = drain(JaxEngine(jcfg, slots=3, bank=jbank),
                   jbank.serving_params(jp["backbone"]), prompts, DOMS)
    tt, ts = drain(DecodeEngine(tcfg, slots=3, bank=tbank, device="cpu"),
                   tbank.serving_params(tp["backbone"]), prompts, DOMS)
    return dict(prompts=prompts, jt=jt, js=js, tt=tt, ts=ts, tbank=tbank)


def test_bank_drain_matches_jax_and_per_domain_drains(nodrop, bank_drained):
    _, tcfg, _, tp = nodrop
    for a, b in zip(bank_drained["tt"], bank_drained["jt"]):
        np.testing.assert_array_equal(a, b)
    for f in STATS:
        assert getattr(bank_drained["ts"], f) == \
            getattr(bank_drained["js"], f), f
    tbank, prompts = bank_drained["tbank"], bank_drained["prompts"]
    for d in DOMAINS:
        idx = [i for i, x in enumerate(DOMS) if x == d]
        eng = DecodeEngine(tcfg, slots=3, device="cpu")
        for i in idx:
            eng.submit(prompts[i], GENS[i])
        comps, _ = eng.run({"backbone": tp["backbone"],
                            "adapters": tbank.snapshot(d)})
        for i, c in zip(idx, sorted(comps, key=lambda c: c.uid)):
            np.testing.assert_array_equal(bank_drained["tt"][i], c.tokens)
    assert len({tuple(t) for t in bank_drained["tt"]}) > 1


def test_spec_generate_matches_jax_and_plain(nodrop):
    jcfg, tcfg, jp, tp = nodrop
    jspec = JSD.SpecDecoder.init(jcfg, jax.random.PRNGKey(5), k=3)
    tspec = SD.SpecDecoder(SD.drafter_config(tcfg),
                           from_jax(jax.tree.map(np.asarray, jspec.params)),
                           k=3)
    toks = tokens(tcfg, 3, 9, seed=7)
    lens = np.array([9, 4, 6], np.int32)
    rows = np.array([True, False, True])
    want, wstats = JSD.spec_generate(jp, jcfg, jspec, jnp.asarray(toks),
                                     gen=9, prompt_lens=lens, spec_rows=rows)
    got, stats = SD.spec_generate(tp, tcfg, tspec, torch.from_numpy(toks),
                                  gen=9, prompt_lens=lens, spec_rows=rows)
    plain = M.generate(tp, tcfg, torch.from_numpy(toks), gen=9,
                       prompt_lens=torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    assert (stats.drafted, stats.accepted) == (wstats.drafted,
                                               wstats.accepted)


# ---------------------------------------------------------------------------
# Training and split learning
# ---------------------------------------------------------------------------

def test_hfsl_lm_round_matches_jax():
    """One lm_loss round of granite (its aux included, the layers
    re-materialised) of 2 clusters and 2 sgd steps from bridged JAX
    state."""
    jcfg, tcfg = configs()
    n, steps, batch, seq = 2, 2, 2, 8
    st = jhfsl.init_hfsl_state(jax.random.PRNGKey(0), jcfg, n,
                               jopt.sgd(0.1),
                               jax.jit(JM.init, static_argnums=0))
    tree = jax.tree.map(np.asarray, st)
    rng = np.random.default_rng(0)
    for t in tree["adapters_c"]["stack"]["g0"]["s0"]["lora"].values():
        t["b"] = (0.1 * rng.standard_normal(t["b"].shape)).astype(np.float32)

    def gen(its, stack):
        while True:
            bs = [next(i) for i in its]
            yield {k: stack([b[k] for b in bs]) for k in bs[0]}

    jb = jpipe.BatchBank.from_iterator(gen(
        [iter(jsyn.LMStream(64, batch, seq, seed=i)) for i in range(n)],
        jnp.stack), steps)
    tb = pipeline.BatchBank.from_iterator(gen(
        [iter(synthetic.LMStream(64, batch, seq, seed=i)) for i in range(n)],
        np.stack), steps, device="cpu")
    js, jm = jhfsl.make_hfsl_round(jcfg, jopt.sgd(0.1), JM.lm_loss,
                                   steps=steps, remat=True)(
        jax.tree.map(jnp.asarray, tree), jb.arrays, 0)
    ts, tm = hfsl.make_hfsl_round(tcfg, topt.sgd(0.1), M.lm_loss,
                                  steps=steps, remat=True)(
        hfsl_state_from_jax(tree, "cpu"), tb.arrays, 0)
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               **SGD_TOL)
    back = hfsl_state_to_numpy(ts)
    got = jax.tree.leaves(back["adapters_c"])
    want = jax.tree.leaves(jax.tree.map(np.asarray, js["adapters_c"]))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **SGD_TOL)
    moved = max(float(np.abs(g - w).max()) for g, w in zip(
        got, jax.tree.leaves(tree["adapters_c"])))
    assert moved > 0.0


def test_pipeline_classify_matches_the_one_stage_chain(setup):
    """The port's 2-stage chain against the reference's pipeline on a
    1-stage mesh, both at 2 microbatches and the default capacity (each
    microbatch routes on its own, in both packages)."""
    jcfg, tcfg, jp, tp = setup
    toks = tokens(tcfg, 4, 10, seed=11)
    mesh = jax.make_mesh((1,), ("stage",))
    want = np.asarray(jax.jit(
        lambda p, s, t: jsl.pipeline_classify(p, s, t, jcfg, mesh,
                                              n_microbatches=2))(
        jp, jsl.split_for_stages(jp, jcfg, 1), jnp.asarray(toks)))
    got = sl_pipeline.pipeline_classify(
        tp, sl_pipeline.split_for_stages(tp, tcfg, 2),
        torch.from_numpy(toks), tcfg, n_microbatches=2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
