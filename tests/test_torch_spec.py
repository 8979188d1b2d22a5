"""Speculative decoding in the port (``core/spec_decode.py``, the engine's
``spec=`` mode, ``IntegratedRuntime(spec_k=)``) against the JAX package,
on the CPU.

Both packages get the same target weights and the same drafter weights
(the reference draws its drafter from a ``jax.random`` key; the bridge
carries its params across). Held: ``spec_generate`` gives the JAX
``spec_generate``'s tokens and ``SpecStats`` and the port's plain
``generate``'s tokens, for a dense target (reduced qwen2-7b) and an ssm
target (reduced falcon-mamba-7b), ragged and with rows opted out; a
drafter equal to the target accepts every draft and a rigged one none;
the verify pass, the drafter's kept states and ``rollback_caches`` match
the reference's; ``DecodeEngine(spec=)`` drains give the JAX engine's
tokens, ``drafted`` and ``accepted``; a bridged
``IntegratedRuntime(spec_k=2)`` gives the reference's actions and
``RoundCost`` fields. All in f32; logits 1e-4, caches 2e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.core import spec_decode as JSD
from repro.core.integrated import IntegratedRuntime as JaxRuntime
from repro.data.synthetic import ClassificationTask as JaxTask
from repro.launch.engine import DecodeEngine as JaxEngine
from repro.models import attention as jattn
from repro.models import model as JM
from repro_torch.checkpoint.from_jax import (caches_from_jax, from_jax,
                                             integrated_from_jax)
from repro_torch.configs.base import get_config
from repro_torch.core import spec_decode as SD
from repro_torch.core.integrated import IntegratedRuntime
from repro_torch.data.synthetic import ClassificationTask
from repro_torch.launch import serve
from repro_torch.launch.engine import DecodeEngine
from repro_torch.models import attention as attn
from repro_torch.models import model as M

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=2e-5, rtol=2e-5)
K = 3
TARGETS = {
    "dense": ("qwen2-7b", dict(n_kv_heads=2, dtype="float32")),
    "ssm": ("falcon-mamba-7b", dict(d_model=64, vocab_size=64,
                                    dtype="float32")),
    "sliding": ("qwen2-7b", dict(n_kv_heads=2, dtype="float32",
                                 attn_variant="sliding", sliding_window=8)),
}
LENS = [5, 9, 12, 7, 10, 3, 6]
GENS = [4, 2, 6, 3, 5, 7, 1]


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def make(kind, seed=1):
    """(jcfg, tcfg, jax params, port params, jax drafter, port drafter)
    with the same weights on both sides."""
    arch, kw = TARGETS[kind]
    jcfg = jax_config(arch).reduced().with_(**kw)
    tcfg = get_config(arch).reduced().with_(**kw)
    tree = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    if kind == "ssm":
        s0 = tree["adapters"]["stack"]["g0"]["s0"]
        s0["state0"] = (0.3 * rng.standard_normal(s0["state0"].shape)) \
            .astype(np.float32)
    else:
        for t in tree["adapters"]["stack"]["g0"]["s0"]["lora"].values():
            t["b"] = (0.1 * rng.standard_normal(t["b"].shape)).astype(
                np.float32)
    jspec = JSD.SpecDecoder.init(jcfg, jax.random.PRNGKey(5), k=K)
    tspec = SD.SpecDecoder(SD.drafter_config(tcfg),
                           from_jax(jax.tree.map(np.asarray, jspec.params)),
                           k=K)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree), from_jax(tree),
            jspec, tspec)


@pytest.fixture(scope="module", params=["dense", "ssm"])
def pair(request):
    return (request.param,) + make(request.param)


def prompts(cfg, B=3, S=9, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# spec_generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ragged", [False, True])
def test_spec_generate_matches_jax_and_plain(pair, ragged):
    _, jcfg, tcfg, jp, tp, jspec, tspec = pair
    toks = prompts(tcfg)
    lens = np.array([9, 4, 6], np.int32) if ragged else None
    rows = np.array([True, False, True]) if ragged else None
    want, wstats = JSD.spec_generate(jp, jcfg, jspec, jnp.asarray(toks),
                                     gen=11, prompt_lens=lens,
                                     spec_rows=rows)
    got, stats = SD.spec_generate(tp, tcfg, tspec, torch.from_numpy(toks),
                                  gen=11, prompt_lens=lens, spec_rows=rows)
    plain = M.generate(tp, tcfg, torch.from_numpy(toks), gen=11,
                       prompt_lens=None if lens is None
                       else torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    assert (stats.drafted, stats.accepted) == (wstats.drafted,
                                               wstats.accepted)
    assert stats.drafted > 0 and 0 <= stats.accepted <= stats.drafted


def test_identical_drafter_accepts_every_draft():
    """The ssm target as its own drafter: every proposal is accepted
    (gen is a whole number of k+1 chunks, so no chunk is cut short by a
    row's budget)."""
    jcfg, tcfg, jp, tp, _, _ = make("ssm")
    spec = SD.SpecDecoder(tcfg, tp, k=K)
    toks = torch.from_numpy(prompts(tcfg, 2, 8, seed=3))
    gen = 2 * (K + 1)
    out, stats = SD.spec_generate(tp, tcfg, spec, toks, gen=gen)
    np.testing.assert_array_equal(out.numpy(),
                                  M.generate(tp, tcfg, toks, gen=gen).numpy())
    assert stats.accepted == stats.drafted > 0
    assert stats.acceptance_rate == 1.0


def test_forced_disagreement_accepts_nothing():
    """A zeroed target (argmax always 0) against a drafter rigged to
    propose tok+1: every chunk commits only the verified carry, and the
    drafted count is exactly k per chunk per row."""
    cfg = get_config("vit-edge").reduced().with_(dtype="float32",
                                                 vocab_size=64)
    params = M.init(cfg, 0, device="cpu")
    params = {k: _zeros(v) for k, v in params.items()}
    dcfg = SD.drafter_config(cfg)
    dp = _zeros(M.init(dcfg, 1, device="cpu"))
    eye = torch.eye(64)
    dp["backbone"]["embed"]["table"] = 5.0 * eye
    dp["backbone"]["final_norm"]["scale"] = torch.ones(64)
    dp["backbone"]["lm_head"]["table"] = 5.0 * torch.roll(eye, 1, 0)
    spec = SD.SpecDecoder(dcfg, dp, k=K)
    B, gen = 2, 6
    toks = torch.from_numpy(prompts(cfg, B, 5, seed=4) % 50 + 1)
    out, stats = SD.spec_generate(params, cfg, spec, toks, gen=gen)
    assert (out.numpy() == 0).all()
    np.testing.assert_array_equal(out.numpy(),
                                  M.generate(params, cfg, toks,
                                             gen=gen).numpy())
    assert stats.accepted == 0 and stats.acceptance_rate == 0.0
    assert stats.drafted == B * gen * K


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros(v) for v in tree]
    return torch.zeros_like(tree)


# ---------------------------------------------------------------------------
# verify, drafter states, rollback
# ---------------------------------------------------------------------------

def _prefilled(jcfg, tcfg, jp, tp, lens, cap=24):
    toks = prompts(tcfg, 3, 12, seed=6)
    _, jc, _ = JM._prefill_state(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                 cap, None, jnp.asarray(lens))
    tc = caches_from_jax(jax.tree.map(np.asarray, jc))
    return jc, tc


@pytest.mark.parametrize("kind", ["dense", "ssm", "sliding"])
def test_verify_and_rollback_match_jax(kind):
    """One chunk per row from the same caches: verify logits, then a
    rollback to per-row commits with one row inactive, against the
    reference's ``verify_step`` + ``rollback_caches``."""
    _, jcfg, tcfg, jp, tp, _, _ = (kind,) + make(kind)
    lens = np.array([12, 5, 7], np.int32)
    jc, tc = _prefilled(jcfg, tcfg, jp, tp, lens)
    chunk = prompts(tcfg, 3, K + 1, seed=8)
    active = np.array([True, True, False])
    jl, jnew, jsnaps = JM.verify_step(jp, jnp.asarray(chunk), jc,
                                      jnp.asarray(lens), jcfg,
                                      active=jnp.asarray(active))
    tl, tc, tsnaps = M.verify(tp, tcfg, torch.from_numpy(chunk), tc,
                              torch.from_numpy(lens),
                              torch.from_numpy(active))
    np.testing.assert_allclose(tl.numpy(), f32(jl), **LOGIT_TOL)
    commit = np.array([2, 4, 0], np.int32)
    want = JSD.rollback_caches(jcfg, jc, jnew, jsnaps,
                               pos=jnp.asarray(lens),
                               commit=jnp.asarray(commit),
                               active=jnp.asarray(active), k=K)
    got = SD.rollback_caches(tcfg, tc, tsnaps, pos=torch.from_numpy(lens),
                             commit=torch.from_numpy(commit),
                             active=torch.from_numpy(active), k=K)
    for leaf, w in want["g0"]["s0"].items():
        np.testing.assert_allclose(f32(got["g0"]["s0"][leaf]), f32(w),
                                   **CACHE_TOL)


def test_drafter_states_match_the_reference_scan(pair):
    """k+1 drafter steps keep the reference's per-step recurrent states."""
    _, jcfg, tcfg, jp, tp, jspec, tspec = pair
    lens = np.array([12, 5, 7], np.int32)
    toks = prompts(tcfg, 3, 12, seed=6)
    jtok, jdc, jpos = JM._prefill_state(
        jspec.params, {"tokens": jnp.asarray(toks)}, jspec.cfg, 24, None,
        jnp.asarray(lens))
    tdc = caches_from_jax(jax.tree.map(np.asarray, jdc))
    active = np.array([True, False, True])
    tok = np.array(jtok)
    jd, jcaches, jsn = JSD.draft_chunk(jspec.params, jspec.cfg, K,
                                       jnp.asarray(tok), jdc, jpos,
                                       jnp.asarray(active))
    td, tcaches, tsn = M.draft(tspec.params, tspec.cfg, K,
                               torch.from_numpy(tok), tdc,
                               torch.from_numpy(lens),
                               torch.from_numpy(active))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    for leaf in ("h", "conv"):
        np.testing.assert_allclose(f32(tsn["g0"]["s0"][leaf]),
                                   f32(jsn["g0"]["s0"][leaf]), **CACHE_TOL)
        np.testing.assert_allclose(f32(tcaches["g0"]["s0"][leaf]),
                                   f32(jcaches["g0"]["s0"][leaf]),
                                   **CACHE_TOL)


def test_chunk_slots_match_the_reference():
    qpos = np.array([[3, 4, 5], [14, 15, 16]], np.int32)
    active = np.array([True, False])
    for window in (0, 8):
        want = jattn.chunk_slots(jnp.asarray(qpos), window, 16,
                                 jnp.asarray(active))
        got = attn.chunk_slots(torch.from_numpy(qpos), window, 16,
                               torch.from_numpy(active))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# The engine's spec mode
# ---------------------------------------------------------------------------

def _queue(cfg, seed=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in LENS]


def _drain(eng, params, reqs, spec_flags):
    uids = [eng.submit(p, g, speculative=f)
            for p, g, f in zip(reqs, GENS, spec_flags)]
    comps, stats = eng.run(params)
    by = {c.uid: c.tokens for c in comps}
    return [by[u] for u in uids], stats


@pytest.mark.parametrize("mixed", [False, True])
def test_engine_spec_drain_matches_jax_engine(pair, mixed):
    """More requests than slots (in-wave refill of target and drafter);
    with ``mixed`` every third request opts out of drafting."""
    _, jcfg, tcfg, jp, tp, jspec, tspec = pair
    reqs = _queue(tcfg)
    flags = [not (mixed and i % 3 == 1) for i in range(len(reqs))]
    jt, js = _drain(JaxEngine(jcfg, slots=3, spec=jspec), jp, reqs, flags)
    tt, ts = _drain(DecodeEngine(tcfg, slots=3, spec=tspec, device="cpu"),
                    tp, reqs, flags)
    pt, _ = _drain(DecodeEngine(tcfg, slots=3, device="cpu"), tp, reqs,
                   flags)
    for a, b, c in zip(tt, jt, pt):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    for f in ("requests", "waves", "segments", "tokens", "padded_tokens",
              "drafted", "accepted"):
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.drafted > 0 and ts.waves > 1
    assert ts.acceptance_rate == js.acceptance_rate


def test_engine_spec_segment_span_carries_the_counts():
    _, tcfg, _, tp, _, tspec = make("ssm")
    from repro_torch.core.telemetry import Telemetry
    tel = Telemetry()
    eng = DecodeEngine(tcfg, slots=2, spec=tspec, tel=tel, device="cpu")
    _drain(eng, tp, _queue(tcfg)[:3], [True] * 3)
    segs = [s for s in tel.spans if s.name == "engine.segment"]
    assert segs and all(s.args["speculative"] for s in segs)
    assert sum(s.args["drafted"] for s in segs) > 0
    assert all("accepted" in s.args for s in segs)


def test_engine_spec_refusals():
    _, tcfg, _, _, _, tspec = make("ssm")
    with pytest.raises(ValueError, match="greedy-only"):
        DecodeEngine(tcfg, slots=2, greedy=False, spec=tspec, device="cpu")
    with pytest.raises(ValueError, match="paged serving composes"):
        from repro_torch.core.paged import PagedSpec
        DecodeEngine(tcfg, slots=2, spec=tspec, paged=PagedSpec(8, 4),
                     device="cpu")
    assert tspec.place(None) is tspec
    # on a mesh the drafter is replicated (drafter_rules), values as they
    # were
    from torch.distributed.tensor import Replicate

    from repro_torch.launch.mesh import single_process_mesh
    from repro_torch.models.params import tree_leaves
    with single_process_mesh("cpu") as mesh:
        placed = tspec.place(mesh)
        for got, want in zip(tree_leaves(placed.params),
                             tree_leaves(tspec.params)):
            assert tuple(got.placements) == (Replicate(), Replicate())
            assert torch.equal(got.full_tensor(), want)


def test_validate_target_guards():
    jcfg, tcfg, _, _, jspec, tspec = make("dense")
    for spec, cfg in ((jspec, jcfg), (tspec, tcfg)):
        with pytest.raises(ValueError, match="vocab"):
            spec.validate_target(cfg.with_(vocab_size=cfg.vocab_size + 1))
        narrow = cfg.with_(attn_variant="sliding", sliding_window=K)
        with pytest.raises(ValueError, match="sliding window"):
            spec.validate_target(narrow)
    for get in (jax_config, get_config):
        with pytest.raises(NotImplementedError):
            (JSD if get is jax_config else SD).SpecDecoder(
                get("qwen2-7b").reduced(), {}, k=2).validate_target(
                get("whisper-small").reduced())
    with pytest.raises(ValueError, match="must be >= 1"):
        SD.SpecDecoder(tcfg, {}, k=0)


def test_drafter_init_is_seeded():
    cfg = get_config("qwen2-7b").reduced()
    a = SD.SpecDecoder.init(cfg, 3, device="cpu", k=2)
    b = SD.SpecDecoder.init(cfg, 3, device="cpu", k=2)
    assert a.cfg.family == "ssm" and a.cfg.vocab_size == cfg.vocab_size
    assert a.cfg.n_layers == 2 and a.cfg.d_model == 64
    la = a.params["backbone"]["layers"]["g0"][0]["s0"]["mix"]["in_proj"]
    lb = b.params["backbone"]["layers"]["g0"][0]["s0"]["mix"]["in_proj"]
    assert torch.equal(la, lb)


def test_serve_cli_spec_prints_the_engines_tokens(capsys):
    argv = ["--arch", "falcon-mamba-7b", "--reduced", "--device", "cpu",
            "--batch", "2", "--gen", "5", "--requests", "1"]
    serve.main(argv + ["--impl", "engine"])
    plain = capsys.readouterr().out
    serve.main(argv + ["--impl", "spec", "--draft-k", "2"])
    spec = capsys.readouterr().out
    row = plain.split("first row:")[1].split("\n")[0]
    assert "acceptance" in spec and spec.split("first row:")[1].split(
        "\n")[0] == row


# ---------------------------------------------------------------------------
# IntegratedRuntime(spec_k=)
# ---------------------------------------------------------------------------

DEMAND = ["nlp", "cv", "nlp", "nlp", "cv"]
RT_KW = dict(n_clusters=2, steps_per_upgrade=3, serve_batch=8, seed=0,
             upgrade_cost=10.0, spec_k=2)
INT_FIELDS = ["tokens", "padded_tokens", "examples", "comm_bytes",
              "drafted_tokens", "accepted_tokens", "timed_out"]


def _rt_cfg(get):
    cfg = get("vit-edge").reduced().with_(dtype="float32", vocab_size=64)
    return cfg.with_(peft=dataclasses.replace(cfg.peft, head_dim_out=5))


def _tasks(Task):
    return {"nlp": Task(5, 64, 48, class_strength=0.6, seed=0),
            "cv": Task(5, 64, 48, class_strength=0.6, seed=7)}


def test_spec_runtime_matches_jax():
    jrt = JaxRuntime(_rt_cfg(jax_config), _tasks(JaxTask), **RT_KW)
    trt = IntegratedRuntime(_rt_cfg(get_config), _tasks(ClassificationTask),
                            device="cpu", **RT_KW)
    assert trt.engine.spec is trt.spec and trt.spec.k == 2
    doms = {n: {"adapters_c": d.adapters_c, "opt": d.opt_state,
                "step": d.step, "level": d.level,
                "offset": jrt._banks[n].offset,
                "bank_version": jrt.versions_of(n)}
            for n, d in jrt.domains.items()}
    integrated_from_jax(trt, jax.tree.map(np.asarray, {
        "backbone": jrt.backbone, "domains": doms,
        "drafter": jrt.spec.params}))
    jrec = jrt.run(DEMAND)
    trec = trt.run(DEMAND)
    assert [(r.action, r.domain) for r in trec] == \
        [(r.action, r.domain) for r in jrec]
    assert any(r.action == "produce" for r in trec)
    for j, t in zip(jrec, trec):
        for f in INT_FIELDS:
            assert getattr(t.cost, f) == getattr(j.cost, f), (t.round, f)
        assert abs(t.accuracy - j.accuracy) <= 1 / 150 + 1e-6
    assert sum(r.cost.drafted_tokens for r in trec) > 0


def test_spec_runtime_excludes_paged():
    from repro_torch.core.paged import PagedSpec
    with pytest.raises(ValueError, match="paged serving composes"):
        IntegratedRuntime(_rt_cfg(get_config), _tasks(ClassificationTask),
                          device="cpu", paged=PagedSpec(64, 16), **RT_KW)
