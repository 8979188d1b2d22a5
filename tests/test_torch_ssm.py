"""The port's ssm family (falcon-mamba) against the JAX package, on the CPU.

The selective scan's plain version against ``repro.kernels.ref`` and the
Pallas kernel in interpret mode on the reference's own case list; the
decode step; ``ssm_seq`` / ``ssm_decode`` / ``ssm_verify``; forward
logits, greedy generation, engine drains (single-tenant, from an
AdapterBank whose domains differ in ``state0``, and paged) against the
JAX package with bridged weights. Model tests run reduced falcon-mamba-7b
in f32 with d_model 64 and vocab 64; ``state0`` inits to zeros in both
packages, so it is set to seeded random values first.

Tolerances are those of tests/test_kernels.py: f32 2e-5, bf16 2e-2, scan
state 1e-3; logits 1e-4 (two frameworks sum in different orders); greedy
tokens identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.core.adapter_bank import AdapterBank as JaxBank
from repro.core.paged import PagedSpec as JaxPagedSpec
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch.engine import DecodeEngine as JaxEngine
from repro.models import model as JM
from repro.models import ssm as jssm
from repro_torch.checkpoint.from_jax import caches_from_jax, from_jax
from repro_torch.configs.base import get_config
from repro_torch.core import hfsl
from repro_torch.core.adapter_bank import AdapterBank
from repro_torch.core.paged import PagedSpec
from repro_torch.data.pipeline import BatchBank
from repro_torch.data.synthetic import ClassificationTask, LMStream
from repro_torch.kernels import ops, ref
from repro_torch.kernels import selective_scan as ss
from repro_torch.launch.engine import DecodeEngine
from repro_torch.models import model as M
from repro_torch.models import ssm
from repro_torch.models.params import tree_leaves, tree_paths
from repro_torch.optim.optimizers import adamw

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
STATE_TOL = dict(atol=1e-3, rtol=1e-3)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
LENS = [5, 9, 12, 7, 10, 3, 6]
GENS = [4, 2, 6, 3, 5, 7, 1]
DOMAINS = ["nlp", "vision", "speech"]
DOMS = ["vision", "nlp", "speech", "speech", "nlp", "vision", "nlp"]


def tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bf16" \
        else dict(atol=2e-5, rtol=2e-5)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# The scan
# ---------------------------------------------------------------------------

def scan_inputs(B, S, Di, N, seed=0, with_h0=True):
    """numpy inputs shaped as the reference's kernel tests draw them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, Di)) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, S, Di)))) * 0.1
    A = -np.exp(rng.standard_normal((Di, N)) * 0.3)
    Bm = rng.standard_normal((B, S, N)) * 0.5
    C = rng.standard_normal((B, S, N)) * 0.5
    D = np.ones(Di) + 0.1 * rng.standard_normal(Di)
    h0 = rng.standard_normal((B, Di, N)) * 0.1 if with_h0 else None
    return [a if a is None else a.astype(np.float32)
            for a in (x, dt, A, Bm, C, D, h0)]


def both(arrs, name):
    """(jax operands, torch operands): x, dt, B, C in the dtype; A, D, h0
    f32."""
    jd, td = DTYPES[name]
    j, t = [], []
    for i, a in enumerate(arrs):
        if a is None:
            j.append(None)
            t.append(None)
            continue
        low = i in (0, 1, 3, 4)
        j.append(jnp.asarray(a, jd if low else jnp.float32))
        t.append(torch.from_numpy(np.array(j[-1], np.float32)).to(
            td if low else torch.float32))
    return j, t


@pytest.mark.parametrize("B,S,Di,N", [(1, 32, 128, 8), (2, 64, 256, 16),
                                      (2, 128, 512, 16)])
@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_selective_scan_matches_oracle_and_pallas(B, S, Di, N, name,
                                                  with_h0):
    j, t = both(scan_inputs(B, S, Di, N, with_h0=with_h0), name)
    y, h = ops.selective_scan(*t)
    assert y.dtype == t[0].dtype and h.dtype == torch.float32
    for want_y, want_h in (jref.selective_scan(*j),
                           jops.selective_scan(*j, backend="interpret")):
        np.testing.assert_allclose(f32(y), f32(want_y), **tol(name))
        np.testing.assert_allclose(h.numpy(), f32(want_h), **STATE_TOL)
    # the port's own oracle is the reference's
    ry, rh = ref.selective_scan(*t)
    np.testing.assert_allclose(f32(ry), f32(jref.selective_scan(*j)[0]),
                               **tol(name))
    np.testing.assert_allclose(rh.numpy(), f32(jref.selective_scan(*j)[1]),
                               **STATE_TOL)


def test_selective_scan_takes_strided_b_c_and_a_shared_state():
    """B and C as column views of one x_proj-like output, and one (Di, N)
    state for every row: the same values as contiguous per-row inputs."""
    x, dt, A, Bm, C, D, h0 = (torch.from_numpy(a) for a in
                              scan_inputs(2, 9, 24, 16))
    xdbc = torch.cat([torch.randn(2, 9, 5), Bm, C], dim=-1)
    Bv, Cv = xdbc[..., 5:21], xdbc[..., 21:]
    assert not Bv.is_contiguous()
    got = ops.selective_scan(x, dt, A, Bv, Cv, D, h0[0].expand(2, 24, 16))
    want = ops.selective_scan(x, dt, A, Bm, C, D,
                              h0[0][None].repeat(2, 1, 1))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    shared = ops.selective_scan(x, dt, A, Bm, C, D, h0[0])
    assert torch.equal(shared[1], want[1])


def test_padded_row_state_is_bitwise_the_solo_rows():
    """dt = 0 on a right-padded row's tail leaves the state bit for bit
    where the row's last valid step put it (the reference's claim)."""
    x, dt, A, Bm, C, D, h0 = (torch.from_numpy(a) for a in
                              scan_inputs(3, 20, 32, 16))
    lens = [20, 7, 13]
    dtp = dt.clone()
    for b, n in enumerate(lens):
        dtp[b, n:] = 0
    _, h = ops.selective_scan(x, dtp, A, Bm, C, D, h0)
    for b, n in enumerate(lens):
        _, hb = ops.selective_scan(x[b:b + 1, :n], dt[b:b + 1, :n], A,
                                   Bm[b:b + 1, :n], C[b:b + 1, :n], D,
                                   h0[b:b + 1])
        assert torch.equal(h[b], hb[0]), b


def test_selective_scan_step_matches_jax_and_telescopes():
    x, dt, A, Bm, C, D, _ = scan_inputs(2, 8, 64, 8, seed=3)
    dt = dt * 2
    j, t = both([x, dt, A, Bm, C, D, None], "f32")
    h = torch.zeros(2, 64, 8)
    jh = jnp.zeros((2, 64, 8))
    ys = []
    for s in range(8):
        y, h = ops.selective_scan_step(t[0][:, s], t[1][:, s], t[2],
                                       t[3][:, s], t[4][:, s], t[5], h)
        jy, jh = jops.selective_scan_step(j[0][:, s], j[1][:, s], j[2],
                                          j[3][:, s], j[4][:, s], j[5], jh)
        np.testing.assert_allclose(y.numpy(), f32(jy), atol=1e-5, rtol=1e-5)
        ys.append(y)
    yr, hr = ref.selective_scan(*t[:6])
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), yr.numpy(),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(h.numpy(), hr.numpy(), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# The ssm layer and model
# ---------------------------------------------------------------------------

def configs(dtype="float32"):
    kw = dict(d_model=64, vocab_size=64, dtype=dtype)
    return (jax_config("falcon-mamba-7b").reduced().with_(**kw),
            get_config("falcon-mamba-7b").reduced().with_(**kw))


def numpy_params(jcfg, seed=0):
    """Reference init as numpy, with the state prompts made nonzero."""
    tree = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    s0 = tree["adapters"]["stack"]["g0"]["s0"]
    s0["state0"] = (0.3 * rng.standard_normal(s0["state0"].shape)).astype(
        np.float32)
    return tree


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs()
    tree = numpy_params(jcfg)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), from_jax(tree)


def tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def layer(jp, tp, l=0):
    """Layer l's ssm params and adapters in both packages."""
    jl = jax.tree.map(lambda a: a[l], jp["backbone"]["layers"]["g0"]["s0"])
    ja = jax.tree.map(lambda a: a[l], jp["adapters"]["stack"]["g0"]["s0"])
    return (jl["mix"], ja, tp["backbone"]["layers"]["g0"][l]["s0"]["mix"],
            tp["adapters"]["stack"]["g0"][l]["s0"])


@pytest.mark.parametrize("ragged", [False, True])
def test_ssm_seq_matches_jax(setup, ragged):
    jcfg, tcfg, jp, tp = setup
    jmix, ja, tmix, ta = layer(jp, tp)
    x = np.random.default_rng(1).standard_normal((3, 10, 64)).astype(
        np.float32)
    lens = np.array([10, 2, 6], np.int32) if ragged else None
    jy, jc = jssm.ssm_seq(jmix, ja, jnp.asarray(x), jcfg, make_cache=True,
                          lengths=None if lens is None else jnp.asarray(lens))
    ty, tc = ssm.ssm_seq(tmix, ta, torch.from_numpy(x), tcfg,
                         make_cache=True,
                         lengths=None if lens is None
                         else torch.from_numpy(lens))
    np.testing.assert_allclose(ty.numpy(), f32(jy), **tol("f32"))
    np.testing.assert_allclose(tc["h"].numpy(), f32(jc["h"]), **tol("f32"))
    np.testing.assert_array_equal(tc["conv"].numpy(), f32(jc["conv"]))


def test_ssm_decode_and_verify_match_jax(setup):
    jcfg, tcfg, jp, tp = setup
    jmix, ja, tmix, ta = layer(jp, tp, 1)
    rng = np.random.default_rng(2)
    cache = {"h": (0.2 * rng.standard_normal((3, 128, 16))).astype(
        np.float32),
        "conv": rng.standard_normal((3, 3, 128)).astype(np.float32)}
    x = rng.standard_normal((3, 4, 64)).astype(np.float32)
    jcache, tcache = jax.tree.map(jnp.asarray, cache), caches_from_jax(cache)
    jy, jn = jssm.ssm_decode(jmix, ja, jnp.asarray(x[:, :1]), jcache, jcfg)
    ty, tn = ssm.ssm_decode(tmix, ta, torch.from_numpy(x[:, :1]), tcache,
                            tcfg)
    np.testing.assert_allclose(ty.numpy(), f32(jy), **tol("f32"))
    for leaf in ("h", "conv"):
        np.testing.assert_allclose(tn[leaf].numpy(), f32(jn[leaf]),
                                   **tol("f32"))
    assert np.array_equal(tcache["h"].numpy(), cache["h"])   # not modified
    jy, js = jssm.ssm_verify(jmix, ja, jnp.asarray(x), jcache, jcfg)
    ty, ts = ssm.ssm_verify(tmix, ta, torch.from_numpy(x), tcache, tcfg)
    np.testing.assert_allclose(ty.numpy(), f32(jy), **tol("f32"))
    for leaf in ("h", "conv"):
        assert ts[leaf].shape == js[leaf].shape
        np.testing.assert_allclose(ts[leaf].numpy(), f32(js[leaf]),
                                   **tol("f32"))


def test_forward_logits_match(setup):
    jcfg, tcfg, jp, tp = setup
    toks = tokens(tcfg, 2, 11)
    want = JM.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                      mode="eval")["logits"]
    got = M.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)["logits"]
    np.testing.assert_allclose(got.numpy(), f32(want), **LOGIT_TOL)


@pytest.mark.parametrize("ragged", [False, True])
def test_greedy_generate_matches_generate_scan(setup, ragged):
    jcfg, tcfg, jp, tp = setup
    toks = tokens(tcfg, 3, 9, seed=2)
    lens = np.array([9, 4, 6], np.int32) if ragged else None
    want = JM.generate_scan(jp, jcfg, jnp.asarray(toks), gen=7,
                            prompt_lens=lens)
    got = M.generate(tp, tcfg, torch.from_numpy(toks), gen=7,
                     prompt_lens=None if lens is None
                     else torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_and_decode_caches_match(setup):
    """Ragged prefill caches against the reference's, then decode steps
    with one row retired: the retired row's state stays as it was."""
    jcfg, tcfg, jp, tp = setup
    toks = tokens(tcfg, 3, 12, seed=4)
    lens = np.array([12, 7, 3], np.int32)
    jl, jc = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                        prompt_lens=jnp.asarray(lens))
    tl, tc = M.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                       prompt_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), f32(jl), **LOGIT_TOL)
    spec = M.cache_spec(tcfg, 3, 16)["g0"]["s0"]
    assert {k: (tuple(v.shape), v.dtype) for k, v in
            tc["g0"]["s0"].items()} == \
        {k: (s.shape, s.dtype) for k, s in spec.items()}
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    active = np.array([True, False, True])
    before = tc["g0"]["s0"]["h"][:, 1].clone()
    jl, jc = JM.decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(lens),
                            jcfg, active=jnp.asarray(active))
    tl, tc = M.decode_step(tp, torch.from_numpy(nxt), tc,
                           torch.from_numpy(lens), tcfg,
                           active=torch.from_numpy(active))
    np.testing.assert_allclose(tl.numpy(), f32(jl), **LOGIT_TOL)
    for leaf in ("h", "conv"):
        np.testing.assert_allclose(tc["g0"]["s0"][leaf].numpy(),
                                   f32(jc["g0"]["s0"][leaf]), **LOGIT_TOL)
    assert torch.equal(tc["g0"]["s0"]["h"][:, 1], before)


def test_ragged_prefill_state_equals_solo_prefill(setup):
    """A ragged wave's recurrent caches are each row's own solo caches."""
    _, tcfg, _, tp = setup
    toks = tokens(tcfg, 3, 12, seed=5)
    lens = [12, 5, 8]
    _, wave = M.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                        prompt_lens=torch.tensor(lens))
    for b, n in enumerate(lens):
        _, solo = M.prefill(tp, {"tokens": torch.from_numpy(
            toks[b:b + 1, :n])}, tcfg)
        for leaf in ("h", "conv"):
            np.testing.assert_allclose(wave["g0"]["s0"][leaf][:, b].numpy(),
                                       solo["g0"]["s0"][leaf][:, 0].numpy(),
                                       atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_keeps_the_f32_leaves(dtype):
    jcfg, tcfg = configs(dtype)
    tree = numpy_params(jcfg)
    tp = from_jax(tree)
    mix = tp["backbone"]["layers"]["g0"][0]["s0"]["mix"]
    for name in ("A_log", "D", "dt_proj_b"):
        assert mix[name].dtype == torch.float32
    assert mix["in_proj"].dtype == getattr(torch, dtype)
    assert tp["adapters"]["stack"]["g0"][1]["s0"]["state0"].dtype == \
        torch.float32
    spec = M.init(tcfg, 0, device="cpu")
    def layout(t):
        return {p: (tuple(a.shape), a.dtype) for p, a in tree_paths(t)}
    assert layout(spec) == layout(tp)


def test_falcon_mamba_7b_spec_is_the_published_size():
    """``param_count`` gives 7,272,140,800 at the published widths; the
    spec (counted, nothing allocated) holds that plus the conv biases,
    which the analytic count leaves out (64 x 8192)."""
    cfg = get_config("falcon-mamba-7b")
    spec = M.backbone_spec(cfg)
    n = sum(int(np.prod(s.shape)) for s in tree_leaves(spec))
    assert cfg.param_count() == 7_272_140_800
    assert n == cfg.param_count() + cfg.n_layers * cfg.d_inner
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm.d_state,
            cfg.ssm.d_conv, cfg.dt_rank, cfg.vocab_size) == \
        (64, 4096, 8192, 16, 4, 256, 65024)
    assert "lm_head" in spec and M.adapter_spec(cfg)["stack"]["g0"][0] == \
        {"s0": {"state0": M.adapter_spec(cfg)["stack"]["g0"][0]["s0"]
                ["state0"]}}


def test_ssm_training_is_not_ported():
    """Once refused: an HFSL round and a step of the ssm family now run
    (2 clusters, 2 steps, lm_loss) with finite losses; the round's
    parity with the reference is in tests/test_torch_scan_train.py."""
    _, tcfg = configs()
    opt = adamw(1e-3)
    state = hfsl.init_hfsl_state(0, tcfg, 2, opt, M.init, device="cpu")
    streams = [iter(LMStream(tcfg.vocab_size, 2, 8, seed=i))
               for i in range(2)]
    bank = BatchBank.from_iterator(
        ({k: np.stack([b[k] for b in bs]) for k in bs[0]}
         for bs in zip(*streams)), 2, device="cpu")
    out, m = hfsl.make_hfsl_round(tcfg, opt, M.lm_loss, steps=2)(
        state, bank.arrays, 0)
    assert np.isfinite(m["loss"].numpy()).all() and int(out["step"]) == 2
    _, m = hfsl.make_hfsl_step(tcfg, opt, M.lm_loss)(
        out, {k: v[0] for k, v in bank.arrays.items()})
    assert torch.isfinite(m["loss"]).all()


def test_scan_refuses_autograd_on_the_card_path(monkeypatch):
    """Once refused: the card route (``backend="cuda"``) with a tensor
    that needs a gradient now goes through the autograd Function, whose
    backward launches the backward kernel (here two stand-ins for the
    launches, the plain versions, since a CPU has no kernel)."""
    calls = []

    def stand_in(fn, name):
        def launch(*a, **k):
            calls.append(name)
            k.pop("h_final_out", None)
            return fn(*a, **k)
        return launch

    x, dt, A, Bm, C, D, h0 = (torch.from_numpy(a) for a in
                              scan_inputs(1, 3, 8, 4))
    monkeypatch.setattr(ss, "_launch",
                        stand_in(ss.selective_scan_torch, "fwd"))
    monkeypatch.setattr(ss, "_launch_bwd",
                        stand_in(ss.selective_scan_bwd_torch, "bwd"))
    xg, s0 = x.clone().requires_grad_(True), h0[0].clone() \
        .requires_grad_(True)
    y, hT = ss.selective_scan(xg, dt, A, Bm, C, D, s0, backend="cuda")
    assert type(y.grad_fn).__name__ == "_SelectiveScanBackward"
    (y.sum() + hT.sum()).backward()
    assert calls == ["fwd", "bwd"]
    xw, sw = x.clone().requires_grad_(True), h0[0].clone() \
        .requires_grad_(True)
    yw, hw = ref.selective_scan(xw, dt, A, Bm, C, D, sw[None].expand(1, 8, 4))
    (yw.sum() + hw.sum()).backward()
    torch.testing.assert_close(xg.grad, xw.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(s0.grad, sw.grad, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Serving: engine drains, the bank, paged
# ---------------------------------------------------------------------------

def queue(cfg, seed=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in LENS]


def drain(eng, params, prompts, domains=None):
    uids = [eng.submit(p, g, domain=None if domains is None else domains[i])
            for i, (p, g) in enumerate(zip(prompts, GENS))]
    comps, stats = eng.run(params)
    by = {c.uid: c.tokens for c in comps}
    return [by[u] for u in uids], stats


STATS = ["requests", "waves", "segments", "tokens", "padded_tokens"]


@pytest.fixture(scope="module")
def drained(setup):
    jcfg, tcfg, jp, tp = setup
    prompts = queue(tcfg)
    jt, js = drain(JaxEngine(jcfg, slots=3), jp, prompts)
    tt, ts = drain(DecodeEngine(tcfg, slots=3, device="cpu"), tp, prompts)
    return dict(prompts=prompts, jt=jt, js=js, tt=tt, ts=ts)


def test_engine_drain_matches_jax_engine(drained):
    for a, b in zip(drained["tt"], drained["jt"]):
        np.testing.assert_array_equal(a, b)
    for f in STATS:
        assert getattr(drained["ts"], f) == getattr(drained["js"], f), f
    assert drained["ts"].waves > 1


def test_engine_drain_equals_solo_generate(setup, drained):
    _, tcfg, _, tp = setup
    for p, g, toks in zip(drained["prompts"], GENS, drained["tt"]):
        solo = M.generate(tp, tcfg, torch.from_numpy(p)[None], gen=g)
        np.testing.assert_array_equal(toks, solo[0].numpy())


def test_paged_engine_serves_the_ssm_family_as_the_reference(setup,
                                                             drained):
    """No sub-layer is paged, so the pool commits nothing: the drain gives
    the dense drain's tokens and the reference's pool statistics."""
    jcfg, tcfg, jp, tp = setup
    prompts = drained["prompts"]
    jt, js = drain(JaxEngine(jcfg, slots=3,
                             paged=JaxPagedSpec(n_blocks=32, block_size=8)),
                   jp, prompts)
    tt, ts = drain(DecodeEngine(tcfg, slots=3, device="cpu",
                                paged=PagedSpec(n_blocks=32, block_size=8)),
                   tp, prompts)
    for a, b, c in zip(tt, jt, drained["tt"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    for f in STATS + ["pool_blocks_alloc", "pool_peak_blocks",
                      "cache_tokens"]:
        assert getattr(ts, f) == getattr(js, f), f


def bank_pair(setup):
    """Three domains that differ in their state prompts alone. A state
    prompt acts on a sequence's first tokens: with these random weights
    (A = -e, dt near 1.3) each step scales the state by about exp(-3.5),
    so the prompts are drawn large."""
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(7)
    ads = {}
    for d in DOMAINS:
        a = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(3))
                         ["adapters"])
        s0 = a["stack"]["g0"]["s0"]
        s0["state0"] = (3.0 * rng.standard_normal(s0["state0"].shape)) \
            .astype(np.float32)
        ads[d] = a
    jbank = JaxBank.create({d: jax.tree.map(jnp.asarray, a)
                            for d, a in ads.items()})
    tbank = AdapterBank.create({d: from_jax(a) for d, a in ads.items()})
    return jbank, tbank, ads


@pytest.fixture(scope="module")
def bank_drained(setup):
    jcfg, tcfg, jp, tp = setup
    jbank, tbank, ads = bank_pair(setup)
    prompts = queue(tcfg, seed=6)
    jt, js = drain(JaxEngine(jcfg, slots=3, bank=jbank),
                   jbank.serving_params(jp["backbone"]), prompts, DOMS)
    tt, ts = drain(DecodeEngine(tcfg, slots=3, bank=tbank, device="cpu"),
                   tbank.serving_params(tp["backbone"]), prompts, DOMS)
    return dict(prompts=prompts, jt=jt, js=js, tt=tt, ts=ts, tbank=tbank,
                ads=ads)


def test_bank_layout_holds_state0_per_domain(setup, bank_drained):
    tbank = bank_drained["tbank"]
    s0 = tbank.stacked["stack"]["g0"][1]["s0"]["state0"]
    assert s0.shape == (len(DOMAINS), 128, 16) and s0.dtype == torch.float32
    for i, d in enumerate(DOMAINS):
        np.testing.assert_array_equal(
            s0[i].numpy(), bank_drained["ads"][d]["stack"]["g0"]["s0"]
            ["state0"][1])
    assert set(tbank.stacked) == {"stack"}          # no head, no LoRA


def test_bank_drain_matches_jax_bank_drain(bank_drained):
    for a, b in zip(bank_drained["tt"], bank_drained["jt"]):
        np.testing.assert_array_equal(a, b)
    for f in STATS:
        assert getattr(bank_drained["ts"], f) == \
            getattr(bank_drained["js"], f), f


def test_bank_drain_equals_per_domain_drains(setup, bank_drained):
    _, tcfg, _, tp = setup
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


def test_domains_give_different_tokens(setup, bank_drained):
    _, tcfg, _, tp = setup
    tbank = bank_drained["tbank"]
    # a one-token prompt: the state prompts act on the first steps
    p = torch.from_numpy(tokens(tcfg, 1, 1, seed=9)).expand(3, 1)
    out = M.generate(tbank.serving_params(tp["backbone"]), tcfg, p, gen=6,
                     adapter_ids=tbank.adapter_ids(DOMAINS))
    assert len({tuple(r) for r in out.numpy()}) > 1


def test_ssm_bank_publishes_validates_and_rolls_back(setup, bank_drained):
    tbank = bank_drained["tbank"]
    snap = tbank.snapshot("nlp")
    bad = {"stack": {"g0": [{"s0": {"state0": torch.full_like(
        l["s0"]["state0"], float("nan"))}} for l in snap["stack"]["g0"]]}}
    with pytest.raises(ValueError, match="non-finite"):
        tbank.publish("nlp", bad)
    new = {"stack": {"g0": [{"s0": {"state0": l["s0"]["state0"] + 1}}
                            for l in snap["stack"]["g0"]]}}
    v = tbank.version("nlp")
    tbank.publish("nlp", new)
    assert tbank.version("nlp") == v + 1
    assert torch.equal(tbank.snapshot("nlp")["stack"]["g0"][0]["s0"]
                       ["state0"], new["stack"]["g0"][0]["s0"]["state0"])
    tbank.rollback("nlp")
    assert torch.equal(tbank.snapshot("nlp")["stack"]["g0"][0]["s0"]
                       ["state0"], snap["stack"]["g0"][0]["s0"]["state0"])


def test_stacked_state0_without_ids_is_refused(setup, bank_drained):
    _, tcfg, _, tp = setup
    tbank = bank_drained["tbank"]
    with pytest.raises(ValueError, match="gathered by adapter_ids"):
        M.prefill(tbank.serving_params(tp["backbone"]),
                  {"tokens": torch.zeros(2, 4, dtype=torch.int32)}, tcfg)


def test_classification_task_runs_the_ssm_classify_path(setup):
    """A head on the ssm family: ``classify`` pools the ssm stack's hidden
    states (the bank path's per-row heads are shared with the dense
    family)."""
    _, tcfg, _, _ = setup
    cfg = tcfg.with_(peft=dataclasses.replace(tcfg.peft, head_dim_out=3))
    params = M.init(cfg, 1, device="cpu")
    data = ClassificationTask(3, cfg.vocab_size, 10, seed=0).dataset(4,
                                                                     seed=1)
    logits = M.classify(params, {"tokens": torch.as_tensor(
        data["tokens"])}, cfg)
    assert logits.shape == (4, 3) and torch.isfinite(logits).all()
