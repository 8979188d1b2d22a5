"""The port's hybrid family (recurrentgemma) against the JAX package, on the
CPU.

The RG-LRU's plain version against ``repro.kernels.ref`` and the Pallas
kernel in interpret mode at the reference's own shapes; the decode step;
``rglru_seq`` / ``rglru_decode`` / ``rglru_verify``; forward logits,
prefill and decode caches, greedy generation, engine drains
(single-tenant and from an AdapterBank whose domains differ in prefix,
LoRA and ``state0``) and ``spec_generate`` against the JAX package with
bridged weights. Model tests run reduced recurrentgemma-2b
(``configs/base.py::reduced``: 3 layers, one ``(rglru, rglru, attn)``
group, window 32) in f32 with d_model 64, lru_width 64 and vocab 64, and a
5-layer config that keeps the ``tail`` group, which ``reduced`` drops.
``state0`` and LoRA ``b`` init to zeros in both packages, so they are set
to seeded random values first. Each module's JAX side runs once, in
fixtures.

Tolerances are those of tests/test_kernels.py: f32 2e-5, bf16 2e-2,
final state 1e-3; logits 1e-4 (two frameworks sum in different orders);
greedy tokens identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.core import spec_decode as JSD
from repro.core.adapter_bank import AdapterBank as JaxBank
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch.engine import DecodeEngine as JaxEngine
from repro.models import model as JM
from repro.models import rglru as jrglru
from repro_torch.checkpoint.from_jax import caches_from_jax, from_jax
from repro_torch.configs.base import get_config
from repro_torch.core import hfsl
from repro_torch.core import spec_decode as SD
from repro_torch.core.adapter_bank import AdapterBank
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as rg
from repro_torch.data.pipeline import BatchBank
from repro_torch.data.synthetic import LMStream
from repro_torch.launch import serve
from repro_torch.launch.engine import DecodeEngine
from repro_torch.models import model as M
from repro_torch.models import rglru
from repro_torch.models.params import tree_leaves, tree_paths
from repro_torch.models.transformer import groups_for, paged_subs
from repro_torch.optim.optimizers import adamw

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
STATE_TOL = dict(atol=1e-3, rtol=1e-3)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
LENS = [5, 9, 12, 7, 10, 3, 6]
GENS = [4, 2, 6, 3, 5, 7, 1]
DOMAINS = ["nlp", "vision", "speech", "audio"]
DOMS = ["vision", "nlp", "speech", "audio", "nlp", "vision", "audio"]
K = 3


def tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bf16" \
        else dict(atol=2e-5, rtol=2e-5)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# The recurrence
# ---------------------------------------------------------------------------

def lru_inputs(B, S, W, seed=0):
    """numpy inputs shaped as the reference's kernel tests draw them."""
    rng = np.random.default_rng(seed)
    return [a.astype(np.float32) for a in (
        rng.standard_normal((B, S, W)) * 0.5, rng.standard_normal((B, S, W)),
        rng.standard_normal((B, S, W)), rng.standard_normal(W),
        rng.standard_normal((B, W)) * 0.1)]


def both(arrs, name):
    """(jax operands, torch operands): x, r, i in the dtype; a_param, h0
    f32."""
    jd, td = DTYPES[name]
    j, t = [], []
    for n, a in enumerate(arrs):
        low = n < 3
        j.append(jnp.asarray(a, jd if low else jnp.float32))
        t.append(torch.from_numpy(np.array(j[-1], np.float32)).to(
            td if low else torch.float32))
    return j, t


@pytest.mark.parametrize("B,S,W", [(1, 32, 128), (2, 64, 256), (2, 96, 512)])
@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_rglru_matches_oracle_and_pallas(B, S, W, name):
    j, t = both(lru_inputs(B, S, W), name)
    hs, hT = ops.rglru(*t)
    assert hs.dtype == t[0].dtype and hT.dtype == torch.float32
    for want_hs, want_hT in (jref.rglru(*j),
                             jops.rglru(*j, backend="interpret")):
        np.testing.assert_allclose(f32(hs), f32(want_hs), **tol(name))
        np.testing.assert_allclose(hT.numpy(), f32(want_hT), **STATE_TOL)
    # the port's own oracle is the reference's
    rhs, rhT = ref.rglru(*t)
    jhs, jhT = jref.rglru(*j)
    np.testing.assert_allclose(f32(rhs), f32(jhs), **tol(name))
    np.testing.assert_allclose(rhT.numpy(), f32(jhT), **STATE_TOL)


def test_rglru_takes_no_state_and_a_shared_state():
    """h0 absent is h0 = 0; one (W,) state is that state in every row."""
    x, r, i, a, h0 = (torch.from_numpy(v) for v in lru_inputs(2, 9, 24))
    none = ops.rglru(x, r, i, a)
    zero = ops.rglru(x, r, i, a, torch.zeros(2, 24))
    assert torch.equal(none[0], zero[0]) and torch.equal(none[1], zero[1])
    shared = ops.rglru(x, r, i, a, h0[0])
    rows = ops.rglru(x, r, i, a, h0[0][None].repeat(2, 1))
    assert torch.equal(shared[0], rows[0])
    assert torch.equal(shared[1], rows[1])
    want = jref.rglru(*(jnp.asarray(v.numpy()) for v in (x, r, i, a)),
                      jnp.broadcast_to(jnp.asarray(h0[0].numpy()), (2, 24)))
    np.testing.assert_allclose(shared[0].numpy(), f32(want[0]),
                               **tol("f32"))


def test_padded_row_state_is_bitwise_the_solo_rows():
    """r_gate = -1e9 on a right-padded row's tail leaves the state bit for
    bit where the row's last valid step put it (the reference's claim)."""
    x, r, i, a, h0 = (torch.from_numpy(v) for v in lru_inputs(3, 20, 32))
    lens = [20, 7, 13]
    rp = r.clone()
    for b, n in enumerate(lens):
        rp[b, n:] = -1e9
    _, h = ops.rglru(x, rp, i, a, h0)
    for b, n in enumerate(lens):
        _, hb = ops.rglru(x[b:b + 1, :n], r[b:b + 1, :n], i[b:b + 1, :n], a,
                          h0[b:b + 1])
        assert torch.equal(h[b], hb[0]), b


def test_rglru_step_matches_jax_and_telescopes():
    x, r, i, a, _ = lru_inputs(2, 12, 64, seed=3)
    j, t = both([x, r, i, a, np.zeros((2, 64), np.float32)], "f32")
    h, jh = t[4], j[4]
    ys = []
    for s in range(12):
        y, h = ops.rglru_step(t[0][:, s], t[1][:, s], t[2][:, s], t[3], h)
        jy, jh = jops.rglru_step(j[0][:, s], j[1][:, s], j[2][:, s], j[3],
                                 jh)
        np.testing.assert_allclose(y.numpy(), f32(jy), atol=1e-5, rtol=1e-5)
        ys.append(y)
    hs, hT = ref.rglru(*t[:4])
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), hs.numpy(),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(h.numpy(), hT.numpy(), atol=1e-5, rtol=1e-5)


def test_rglru_refuses_autograd_on_the_card_path(monkeypatch):
    """Once refused: the card route (``backend="cuda"``) with a tensor
    that needs a gradient now goes through the autograd Function, whose
    backward launches the backward kernel (here two stand-ins for the
    launches, the plain versions, since a CPU has no kernel); a shared
    (W,) state gets its rows' gradients summed."""
    calls = []

    def stand_in(fn, name):
        def launch(*a, **k):
            calls.append(name)
            k.pop("h_final_out", None)
            return fn(*a, **k)
        return launch

    x, r, i, a, h0 = (torch.from_numpy(v) for v in lru_inputs(2, 3, 8))
    monkeypatch.setattr(rg, "_launch", stand_in(rg.rglru_torch, "fwd"))
    monkeypatch.setattr(rg, "_launch_bwd", stand_in(rg.rglru_bwd_torch,
                                                    "bwd"))
    xg, s0 = x.clone().requires_grad_(True), h0[0].clone() \
        .requires_grad_(True)
    hs, hT = rg.rglru(xg, r, i, a, s0, backend="cuda")
    assert type(hs.grad_fn).__name__ == "_RGLRUBackward"
    (hs.sum() + hT.sum()).backward()
    assert calls == ["fwd", "bwd"]
    xw, sw = x.clone().requires_grad_(True), h0[0].clone() \
        .requires_grad_(True)
    hw, hTw = ref.rglru(xw, r, i, a, sw.expand(2, 8))
    (hw.sum() + hTw.sum()).backward()
    torch.testing.assert_close(xg.grad, xw.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(s0.grad, sw.grad, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The rglru layer and the model
# ---------------------------------------------------------------------------

def narrow(cfg, dtype="float32", **kw):
    """Reduced recurrentgemma at d_model 64, lru_width 64, vocab 64."""
    return cfg.reduced().with_(
        d_model=64, vocab_size=64, dtype=dtype,
        hybrid=dataclasses.replace(cfg.reduced().hybrid, lru_width=64), **kw)


def configs(dtype="float32", tail=False):
    """(jax config, port config); ``tail`` gives 5 layers: one
    ``(rglru, rglru, attn)`` group and the ``(rglru, rglru)`` tail."""
    out = []
    for c in (jax_config("recurrentgemma-2b"),
              get_config("recurrentgemma-2b")):
        c = narrow(c, dtype)
        if tail:
            c = c.with_(n_layers=5, hybrid=dataclasses.replace(
                c.hybrid, tail=("rglru", "rglru")))
        out.append(c)
    return tuple(out)


def seed_adapters(tree, rng, s0_scale=0.3):
    """Nonzero state prompts and LoRA b (both init to zeros)."""
    for grp in tree["adapters"]["stack"].values():
        for sub in grp.values():
            if "state0" in sub:
                sub["state0"] = (s0_scale * rng.standard_normal(
                    sub["state0"].shape)).astype(np.float32)
            for t in sub.get("lora", {}).values():
                t["b"] = (0.1 * rng.standard_normal(t["b"].shape)).astype(
                    t["b"].dtype)
    return tree


def numpy_params(jcfg, seed=0):
    tree = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(seed)))
    return seed_adapters(tree, np.random.default_rng(seed))


def make(tail=False, seed=0):
    jcfg, tcfg = configs(tail=tail)
    tree = numpy_params(jcfg, seed)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), from_jax(tree)


@pytest.fixture(scope="module")
def setup():
    return make()


@pytest.fixture(scope="module")
def tailed():
    return make(tail=True, seed=1)


def tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def layer(jp, tp, sub="s0", l=0):
    """Layer l's rglru params and adapters of g0 in both packages."""
    jl = jax.tree.map(lambda a: a[l], jp["backbone"]["layers"]["g0"][sub])
    ja = jax.tree.map(lambda a: a[l], jp["adapters"]["stack"]["g0"][sub])
    return (jl["mix"], ja, tp["backbone"]["layers"]["g0"][l][sub]["mix"],
            tp["adapters"]["stack"]["g0"][l][sub])


def test_groups_and_windows():
    _, tcfg = configs()
    assert groups_for(tcfg) == [("g0", ("rglru", "rglru", "attn"), 1)]
    _, tt = configs(tail=True)
    assert groups_for(tt) == [("g0", ("rglru", "rglru", "attn"), 1),
                              ("tail", ("rglru", "rglru"), 1)]
    full = get_config("recurrentgemma-2b")
    assert groups_for(full) == [("g0", ("rglru", "rglru", "attn"), 8),
                                ("tail", ("rglru", "rglru"), 1)]
    assert paged_subs(full) == [] and paged_subs(tt) == []


@pytest.mark.parametrize("ragged", [False, True])
def test_rglru_seq_matches_jax(setup, ragged):
    jcfg, tcfg, jp, tp = setup
    jmix, ja, tmix, ta = layer(jp, tp)
    x = np.random.default_rng(1).standard_normal((3, 10, 64)).astype(
        np.float32)
    lens = np.array([10, 2, 6], np.int32) if ragged else None
    jy, jc = jrglru.rglru_seq(jmix, ja, jnp.asarray(x), jcfg,
                              make_cache=True,
                              lengths=None if lens is None
                              else jnp.asarray(lens))
    ty, tc = rglru.rglru_seq(tmix, ta, torch.from_numpy(x), tcfg,
                             make_cache=True,
                             lengths=None if lens is None
                             else torch.from_numpy(lens))
    np.testing.assert_allclose(ty.numpy(), f32(jy), **tol("f32"))
    np.testing.assert_allclose(tc["h"].numpy(), f32(jc["h"]), **tol("f32"))
    np.testing.assert_array_equal(tc["conv"].numpy(), f32(jc["conv"]))


def test_rglru_seq_refuses_an_ungathered_bank_leaf(setup):
    _, tcfg, _, tp = setup
    tmix = tp["backbone"]["layers"]["g0"][0]["s0"]["mix"]
    ta = tp["adapters"]["stack"]["g0"][0]["s0"]
    bank_leaf = {"state0": ta["state0"][None].repeat(4, 1)}
    with pytest.raises(ValueError, match="gathered by adapter_ids"):
        rglru.rglru_seq(tmix, bank_leaf, torch.zeros(2, 3, 64), tcfg)


def test_rglru_decode_and_verify_match_jax(setup):
    jcfg, tcfg, jp, tp = setup
    jmix, ja, tmix, ta = layer(jp, tp, "s1")
    rng = np.random.default_rng(2)
    cache = {"h": (0.2 * rng.standard_normal((3, 64))).astype(np.float32),
             "conv": rng.standard_normal((3, 3, 64)).astype(np.float32)}
    x = rng.standard_normal((3, 4, 64)).astype(np.float32)
    jcache, tcache = jax.tree.map(jnp.asarray, cache), caches_from_jax(cache)
    jy, jn = jrglru.rglru_decode(jmix, ja, jnp.asarray(x[:, :1]), jcache,
                                 jcfg)
    ty, tn = rglru.rglru_decode(tmix, ta, torch.from_numpy(x[:, :1]),
                                tcache, tcfg)
    np.testing.assert_allclose(ty.numpy(), f32(jy), **tol("f32"))
    for leaf in ("h", "conv"):
        np.testing.assert_allclose(tn[leaf].numpy(), f32(jn[leaf]),
                                   **tol("f32"))
    assert np.array_equal(tcache["h"].numpy(), cache["h"])   # not modified
    jy, js = jrglru.rglru_verify(jmix, ja, jnp.asarray(x), jcache, jcfg)
    ty, ts = rglru.rglru_verify(tmix, ta, torch.from_numpy(x), tcache, tcfg)
    np.testing.assert_allclose(ty.numpy(), f32(jy), **tol("f32"))
    for leaf in ("h", "conv"):
        assert ts[leaf].shape == js[leaf].shape
        np.testing.assert_allclose(ts[leaf].numpy(), f32(js[leaf]),
                                   **tol("f32"))


@pytest.mark.parametrize("which", ["reduced", "tail"])
def test_forward_logits_match(setup, tailed, which):
    jcfg, tcfg, jp, tp = setup if which == "reduced" else tailed
    toks = tokens(tcfg, 2, 11)
    want = JM.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                      mode="eval")["logits"]
    got = M.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)["logits"]
    np.testing.assert_allclose(got.numpy(), f32(want), **LOGIT_TOL)


@pytest.fixture(scope="module")
def scans(setup, tailed):
    """The reference's greedy generations, once per module: plain and
    ragged prompts, for the reduced and the tailed config. The ragged
    prompts run past the window (12 + 40 > 32), so the rolling buffer
    wraps."""
    out = {}
    for which, (jcfg, tcfg, jp, _) in (("reduced", setup), ("tail", tailed)):
        toks = tokens(tcfg, 3, 12, seed=2)
        for ragged in (False, True):
            lens = np.array([12, 4, 7], np.int32) if ragged else None
            out[which, ragged] = (toks, lens, np.asarray(JM.generate_scan(
                jp, jcfg, jnp.asarray(toks), gen=40, prompt_lens=lens)))
    return out


@pytest.mark.parametrize("which", ["reduced", "tail"])
@pytest.mark.parametrize("ragged", [False, True])
def test_greedy_generate_matches_generate_scan(setup, tailed, scans, which,
                                               ragged):
    _, tcfg, _, tp = setup if which == "reduced" else tailed
    toks, lens, want = scans[which, ragged]
    got = M.generate(tp, tcfg, torch.from_numpy(toks), gen=40,
                     prompt_lens=None if lens is None
                     else torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("which", ["reduced", "tail"])
def test_prefill_and_decode_caches_match(setup, tailed, which):
    """Ragged prefill caches (recurrent and rolling attention) against the
    reference's, then a decode step with one row retired: the retired
    row's caches stay as they were."""
    jcfg, tcfg, jp, tp = setup if which == "reduced" else tailed
    toks = tokens(tcfg, 3, 12, seed=4)
    lens = np.array([12, 7, 3], np.int32)
    jl, jc = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                        max_len=20, prompt_lens=jnp.asarray(lens))
    tl, tc = M.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                       max_len=20, prompt_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), f32(jl), **LOGIT_TOL)
    spec = M.cache_spec(tcfg, 3, 20)
    assert {g: {s: {k: (tuple(v.shape), v.dtype) for k, v in c.items()}
                for s, c in grp.items()} for g, grp in tc.items()} == \
        {g: {s: {k: (p.shape, p.dtype) for k, p in c.items()}
             for s, c in grp.items()} for g, grp in spec.items()}
    for (path, got) in tree_paths(tc):
        want = jc
        for k in path:
            want = want[k]
        np.testing.assert_allclose(f32(got), f32(want), **LOGIT_TOL)
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    active = np.array([True, False, True])
    before = tree_paths(tc)
    before = {p: t[:, 1].clone() for p, t in before}
    jl, jc = JM.decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(lens),
                            jcfg, active=jnp.asarray(active))
    tl, tc = M.decode_step(tp, torch.from_numpy(nxt), tc,
                           torch.from_numpy(lens), tcfg,
                           active=torch.from_numpy(active))
    np.testing.assert_allclose(tl.numpy(), f32(jl), **LOGIT_TOL)
    for (path, got) in tree_paths(tc):
        want = jc
        for k in path:
            want = want[k]
        np.testing.assert_allclose(f32(got), f32(want), **LOGIT_TOL)
        assert torch.equal(got[:, 1], before[path]), path


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
        for sub in ("s0", "s1"):
            for leaf in ("h", "conv"):
                np.testing.assert_allclose(
                    wave["g0"][sub][leaf][:, b].numpy(),
                    solo["g0"][sub][leaf][:, 0].numpy(), atol=1e-6,
                    rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_keeps_the_f32_leaves_and_both_groups(dtype):
    jcfg, tcfg = configs(dtype, tail=True)
    tree = numpy_params(jcfg)
    tp = from_jax(tree)
    layers = tp["backbone"]["layers"]
    assert len(layers["g0"]) == 1 and len(layers["tail"]) == 1
    assert set(layers["g0"][0]) == {"s0", "s1", "s2"}
    assert set(layers["tail"][0]) == {"s0", "s1"}
    for mix in (layers["g0"][0]["s1"]["mix"], layers["tail"][0]["s0"]["mix"]):
        assert mix["a_param"].dtype == torch.float32
        assert mix["in_x"].dtype == getattr(torch, dtype)
    st = tp["adapters"]["stack"]
    assert st["tail"][0]["s1"]["state0"].dtype == torch.float32
    assert st["g0"][0]["s2"]["lora"]["q"]["a"].dtype == getattr(torch, dtype)
    spec = M.init(tcfg, 0, device="cpu")

    def layout(t):
        return {p: (tuple(a.shape), a.dtype) for p, a in tree_paths(t)}
    assert layout(spec) == layout(tp)


def test_recurrentgemma_2b_spec_is_the_published_size():
    """``param_count`` gives 2,894,666,240 at the published widths. The
    spec (counted, nothing allocated; the reference's layout) holds 4 W
    fewer per rglru layer: the analytic count takes the conv taps twice
    (8 W) and a diagonal input gate the block does not have (W), and leaves
    out the conv bias (W): 10 W against the spec's conv_w, conv_b and
    a_param (6 W)."""
    cfg = get_config("recurrentgemma-2b")
    spec = M.backbone_spec(cfg)
    n = sum(int(np.prod(s.shape)) for s in tree_leaves(spec))
    n_rglru = sum(kinds.count("rglru") * reps
                  for _, kinds, reps in groups_for(cfg))
    assert cfg.param_count() == 2_894_666_240 and n_rglru == 18
    assert n == cfg.param_count() - 4 * cfg.lru_width * n_rglru
    assert (cfg.n_layers, cfg.d_model, cfg.lru_width, cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim_, cfg.d_ff, cfg.vocab_size,
            cfg.hybrid.window, cfg.tie_embeddings) == \
        (26, 2560, 2560, 10, 1, 256, 7680, 256000, 2048, True)
    assert "lm_head" not in spec
    ad = M.adapter_spec(cfg)["stack"]
    assert ad["tail"][0]["s1"]["state0"].shape == (2560,)
    assert ad["g0"][7]["s2"]["prefix"]["k"].shape == (cfg.peft.n_prefix, 1,
                                                      256)


def test_hybrid_training_is_not_ported():
    """Once refused: an HFSL round and a step of the hybrid family now run
    (2 clusters, 2 steps, lm_loss) with finite losses, and the attention
    layers' LoRA and the recurrent layers' state prompts both move; the
    round's parity with the reference is in
    tests/test_torch_scan_train.py."""
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
    moved = {p: (a - b).abs().max().item() for p, a, b in zip(
        [p for p, _ in tree_paths(out["adapters_c"])],
        tree_leaves(out["adapters_c"]), tree_leaves(state["adapters_c"]))}
    assert any(v > 0 for p, v in moved.items() if "state0" in p), moved
    assert any(v > 0 for p, v in moved.items() if "lora" in p), moved
    _, m = hfsl.make_hfsl_step(tcfg, opt, M.lm_loss)(
        out, {k: v[0] for k, v in bank.arrays.items()})
    assert torch.isfinite(m["loss"]).all()


# ---------------------------------------------------------------------------
# Serving: engine drains, the bank, speculative decoding
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


@pytest.fixture(scope="module")
def bank_drained(setup):
    """Four domains that differ in prefix slots, LoRA and state0 (each
    domain's adapters from its own key and rng)."""
    jcfg, tcfg, jp, tp = setup
    ads = {}
    for n, d in enumerate(DOMAINS):
        a = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(
            10 + n))["adapters"])
        ads[d] = seed_adapters({"adapters": a}, np.random.default_rng(n),
                               s0_scale=3.0)["adapters"]
    jbank = JaxBank.create({d: jax.tree.map(jnp.asarray, a)
                            for d, a in ads.items()})
    tbank = AdapterBank.create({d: from_jax(a) for d, a in ads.items()})
    prompts = queue(tcfg, seed=6)
    jt, js = drain(JaxEngine(jcfg, slots=3, bank=jbank),
                   jbank.serving_params(jp["backbone"]), prompts, DOMS)
    tt, ts = drain(DecodeEngine(tcfg, slots=3, bank=tbank, device="cpu"),
                   tbank.serving_params(tp["backbone"]), prompts, DOMS)
    return dict(prompts=prompts, jt=jt, js=js, tt=tt, ts=ts, tbank=tbank,
                ads=ads)


def test_bank_layout_holds_each_domains_adapters(bank_drained):
    tbank = bank_drained["tbank"]
    s0 = tbank.stacked["stack"]["g0"][0]["s1"]["state0"]
    assert s0.shape == (len(DOMAINS), 64) and s0.dtype == torch.float32
    for i, d in enumerate(DOMAINS):
        ad = bank_drained["ads"][d]["stack"]["g0"]
        np.testing.assert_array_equal(s0[i].numpy(), ad["s1"]["state0"][0])
        np.testing.assert_array_equal(
            tbank.stacked["stack"]["g0"][0]["s2"]["prefix"]["k"][i].numpy(),
            ad["s2"]["prefix"]["k"][0])


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
    p = torch.from_numpy(tokens(tcfg, 1, 2, seed=9)).expand(4, 2)
    out = M.generate(tbank.serving_params(tp["backbone"]), tcfg, p, gen=6,
                     adapter_ids=tbank.adapter_ids(DOMAINS))
    assert len({tuple(r) for r in out.numpy()}) > 1


@pytest.mark.parametrize("ragged", [False, True])
def test_spec_generate_matches_jax_and_plain(setup, ragged):
    """The default ssm drafter, bridged from the reference's, on a hybrid
    target; the generation stays inside the window (12 + 11 < 32), where
    speculative verify equals plain decoding (ROADMAP §3)."""
    jcfg, tcfg, jp, tp = setup
    jspec = JSD.SpecDecoder.init(jcfg, jax.random.PRNGKey(5), k=K)
    tspec = SD.SpecDecoder(SD.drafter_config(tcfg),
                           from_jax(jax.tree.map(np.asarray, jspec.params)),
                           k=K)
    toks = tokens(tcfg, 3, 12, seed=7)
    lens = np.array([12, 4, 6], np.int32) if ragged else None
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
    assert stats.drafted > 0


def test_self_drafter_accepts_every_draft(setup):
    """The target as its own drafter: every draft is the target's token."""
    _, tcfg, _, tp = setup
    toks = torch.from_numpy(tokens(tcfg, 2, 10, seed=8))
    out, stats = SD.spec_generate(tp, tcfg, SD.SpecDecoder(tcfg, tp, k=K),
                                  toks, gen=2 * (K + 1))
    want = M.generate(tp, tcfg, toks, gen=2 * (K + 1))
    assert torch.equal(out, want.to(out.dtype))
    assert stats.drafted > 0 and stats.acceptance_rate == 1.0


def test_serve_cli_runs_the_hybrid_family(capsys):
    serve.main(["--arch", "recurrentgemma-2b", "--reduced", "--device",
                "cpu", "--impl", "engine", "--batch", "2", "--prompt-len",
                "6", "--gen", "3", "--requests", "1"])
    out = capsys.readouterr().out
    assert "[serve] round 0: 2 requests, 6 tokens" in out
