"""The port's audio family (whisper-small's encoder-decoder) against the
JAX package, in f32 on the CPU.

Reduced whisper-small: 2 encoder and 2 decoder layers, d_model 256, 4 / 4
heads of 64, 32 frames, vocab 512, 4 prefix slots and rank-4 LoRA on the
encoder's attention and the decoder's self-attention. Both packages get
the same weights through the bridge and the same numpy-made tokens and
frames (seeded normal x 0.1); LoRA ``b`` inits to zeros in both, so it is
set to seeded values first. The JAX side of the drains runs once, in a
module fixture.

The two kernel modes this family adds, non-causal attention and cross
attention (queries S != keys T), are held at the plain versions' level
against ``repro/kernels/ref.py``; the kernels themselves are held on the
card by their twins in tests/test_torch_cuda.py.

Tolerances: logits ``LOGIT_TOL`` of tests/test_torch_model.py (1e-4);
encoder states, caches and kernels f32 2e-5 (tests/test_kernels.py);
greedy tokens identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.kernels import ref as jref
from repro.launch import serve as jserve
from repro.launch.engine import DecodeEngine as JaxEngine
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models import model as JM
from repro_torch.checkpoint.from_jax import (caches_from_jax, from_jax,
                                             to_numpy)
from repro_torch.configs.base import get_config
from repro_torch.core import spec_decode as SD
from repro_torch.core.paged import PagedSpec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.launch import serve
from repro_torch.launch.engine import DecodeEngine
from repro_torch.models import encdec, layers
from repro_torch.models import model as M

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
TOL = dict(atol=2e-5, rtol=2e-5)
ARCH = "whisper-small"
LENS = [5, 9, 12, 7, 10, 3]
GENS = [4, 2, 6, 3, 5, 7]


def configs(dtype="float32"):
    return (jax_config(ARCH).reduced().with_(dtype=dtype),
            get_config(ARCH).reduced().with_(dtype=dtype))


def numpy_params(jcfg, seed=0):
    tree = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for part in ("enc", "dec"):
        for t in tree["adapters"]["stack"][part]["lora"].values():
            t["b"] = (0.1 * rng.standard_normal(t["b"].shape)).astype(
                t["b"].dtype)
    return tree


def frames(cfg, B, seed=0):
    return (0.1 * np.random.default_rng(100 + seed).standard_normal(
        (B, cfg.audio.n_audio_frames, cfg.d_model))).astype(np.float32)


def tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs()
    tree = numpy_params(jcfg)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), from_jax(tree)


def stacks(p):
    """(backbone encdec tree, adapter stack) of a param tree."""
    return p["backbone"]["encdec"], p["adapters"]["stack"]


def close_trees(got: dict, want: dict, **tol):
    """Leaf by leaf: float leaves within ``tol``, integer leaves equal."""
    want = caches_from_jax(jax.tree.map(np.asarray, want))
    assert {k: set(v) for k, v in got.items()} == \
        {k: set(v) for k, v in want.items()}
    for a, b in ((got[p][l], want[p][l]) for p in got for l in got[p]):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.is_floating_point():
            np.testing.assert_allclose(a.numpy(), b.numpy(), **tol)
        else:
            assert torch.equal(a, b)


def test_layernorm_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 5, 48)).astype(
        np.float32) * 3 + 1
    rng = np.random.default_rng(1)
    p = {"scale": rng.standard_normal(48).astype(np.float32),
         "bias": rng.standard_normal(48).astype(np.float32)}
    want = jlayers.layernorm(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = layers.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    spec = layers.layernorm_spec(48)
    assert spec["scale"].init == "ones" and spec["bias"].init == "zeros"


def test_encode_matches_jax(setup):
    jcfg, tcfg, jp, tp = setup
    fr = frames(tcfg, 2)
    want = jencdec.encode(*stacks(jp), jnp.asarray(fr), jcfg)
    got = encdec.encode(*stacks(tp), torch.from_numpy(fr), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ragged_decode_seq_and_decode_step_match_jax(setup):
    jcfg, tcfg, jp, tp = setup
    S, T = 8, 3
    toks = tokens(tcfg, 2, S + T, seed=1)
    lens = np.array([S, 5], np.int32)
    enc = np.array(jencdec.encode(*stacks(jp), jnp.asarray(frames(tcfg, 2)),
                                  jcfg))
    emb = np.asarray(jp["backbone"]["embed"]["table"])[toks]
    jx, jc = jencdec.decode_seq(*stacks(jp), jnp.asarray(emb[:, :S]),
                                jnp.asarray(enc), jcfg, make_cache=True,
                                cache_len=S + T, lengths=jnp.asarray(lens))
    tx, tc = encdec.decode_seq(*stacks(tp), torch.from_numpy(emb[:, :S]),
                               torch.from_numpy(enc), tcfg, make_cache=True,
                               cache_len=S + T,
                               lengths=torch.from_numpy(lens))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    close_trees(tc, jc, **TOL)
    assert tc["cross"]["pos"].shape == (tcfg.n_layers, 2,
                                        tcfg.audio.n_audio_frames)
    for t in range(T):
        e = emb[:, S + t:S + t + 1]
        pos = lens + t
        jx, jc = jencdec.decode_step(*stacks(jp), jnp.asarray(e), jc, jcfg,
                                     pos=jnp.asarray(pos))
        tx, tc = encdec.decode_step(*stacks(tp), torch.from_numpy(e), tc,
                                    tcfg, pos=torch.from_numpy(pos))
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    close_trees(tc, jc, **TOL)


def test_cache_spec_shapes_match_jax():
    jcfg, tcfg = configs("bfloat16")
    want = jax.tree.map(lambda s: (tuple(s.shape), np.dtype(s.dtype).name),
                        JM.cache_spec(jcfg, 3, 24),
                        is_leaf=lambda s: hasattr(s, "shape"))
    got = M.cache_spec(tcfg, 3, 24)
    got = {part: {leaf: (s.shape, str(s.dtype)[6:])
                  for leaf, s in sub.items()} for part, sub in got.items()}
    assert got == want


def test_forward_and_prefill_match_jax(setup):
    jcfg, tcfg, jp, tp = setup
    toks = tokens(tcfg, 2, 9, seed=2)
    fr = frames(tcfg, 2, seed=2)
    jb = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(fr)}
    tb = {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(fr)}
    want = JM.forward(jp, jb, jcfg, mode="eval", remat=False)["logits"]
    got = M.forward(tp, tb, tcfg, mode="eval")["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    lens = np.array([9, 4], np.int32)
    jl, jc = JM.prefill(jp, jb, jcfg, max_len=16,
                        prompt_lens=jnp.asarray(lens))
    tl, tc = M.prefill(tp, tb, tcfg, max_len=16,
                       prompt_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    close_trees(tc, jc, **TOL)


@pytest.mark.parametrize("ragged", [False, True])
def test_generate_matches_generate_scan(setup, ragged):
    jcfg, tcfg, jp, tp = setup
    toks = tokens(tcfg, 3, 10, seed=3)
    fr = frames(tcfg, 3, seed=3)
    lens = np.array([10, 4, 7], np.int32) if ragged else None
    want = JM.generate_scan(jp, jcfg, jnp.asarray(toks), gen=8,
                            extra_batch={"frames": jnp.asarray(fr)},
                            prompt_lens=lens)
    got = M.generate(tp, tcfg, torch.from_numpy(toks), gen=8,
                     extra_batch={"frames": torch.from_numpy(fr)},
                     prompt_lens=None if lens is None
                     else torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def drain(eng, params, prompts, fr):
    uids = [eng.submit(p, g, extras={"frames": fr[i]})
            for i, (p, g) in enumerate(zip(prompts, GENS))]
    comps, stats = eng.run(params)
    by = {c.uid: c.tokens for c in comps}
    return [by[u] for u in uids], stats


def test_engine_drain_with_frames_matches_jax_and_solo(setup):
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32)
               for n in LENS]
    fr = frames(tcfg, len(LENS), seed=4)
    jt, js = drain(JaxEngine(jcfg, slots=2), jp, prompts, fr)
    tt, ts = drain(DecodeEngine(tcfg, slots=2, device="cpu"), tp, prompts,
                   torch.from_numpy(fr))
    for f in ("requests", "waves", "segments", "tokens", "padded_tokens"):
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.waves > 1
    for i, (a, b) in enumerate(zip(tt, jt)):
        np.testing.assert_array_equal(a, b)
        solo = M.generate(tp, tcfg, torch.from_numpy(prompts[i][None]),
                          gen=GENS[i],
                          extra_batch={"frames": torch.from_numpy(
                              fr[i:i + 1])})
        np.testing.assert_array_equal(a, solo[0].numpy())


@pytest.mark.parametrize("n_p", [0, 4])
def test_plain_non_causal_attention_matches_the_oracle(n_p):
    """Non-causal attention as the encoder (S = T, prefix slots) and the
    cross attention (S != T, none) run it, with a sentinel key."""
    rng = np.random.default_rng(n_p)
    for S, F in ((37, 37), (5, 70)):
        q = rng.standard_normal((2, S, 4, 16)).astype(np.float32)
        k = rng.standard_normal((2, n_p + F, 2, 16)).astype(np.float32)
        v = rng.standard_normal((2, n_p + F, 2, 16)).astype(np.float32)
        qp = np.arange(S, dtype=np.int32)
        kp = np.concatenate([np.full(n_p, -1, np.int32),
                             np.arange(F, dtype=np.int32)])
        kp[-1] = 10 ** 9
        want = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              q_pos=jnp.asarray(qp), kv_pos=jnp.asarray(kp),
                              causal=False)
        got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                 q_pos=torch.from_numpy(qp),
                                 kv_pos=torch.from_numpy(kp), causal=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_non_causal_decode_matches_the_oracle():
    """The cross-attention decode: one query a row against 70 encoder keys
    at per-row positions, not causal (every row's q_pos lies below most
    keys), no window."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((3, 4, 16)).astype(np.float32)
    k = rng.standard_normal((3, 70, 4, 16)).astype(np.float32)
    v = rng.standard_normal((3, 70, 4, 16)).astype(np.float32)
    qp = np.array([0, 3, 9], np.int32)
    kp = np.broadcast_to(np.arange(70, dtype=np.int32), (3, 70)).copy()
    want = jref.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), q_pos=jnp.asarray(qp),
                                 kv_pos=jnp.asarray(kp), causal=False)
    got = fd.flash_decode(*map(torch.from_numpy, (q, k, v)),
                          q_pos=torch.from_numpy(qp),
                          kv_pos=torch.from_numpy(kp), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trips_the_encdec_params_and_caches(dtype):
    jcfg, tcfg = configs(dtype)
    tree = numpy_params(jcfg, seed=6)
    params = from_jax(tree)
    ed = params["backbone"]["encdec"]
    assert len(ed["enc"]) == jcfg.audio.n_enc_layers
    assert len(ed["dec"]) == jcfg.n_layers
    assert ed["dec"][0]["cross"]["wq"].dtype == getattr(torch, dtype)
    assert len(params["adapters"]["stack"]["enc"]) == jcfg.audio.n_enc_layers
    back = to_numpy(params)
    flat = jax.tree.leaves(jax.tree.map(
        lambda a, b: bool(np.array_equal(np.asarray(a, np.float32),
                                         np.asarray(b, np.float32))),
        back, tree))
    assert all(flat)
    assert jax.tree.map(np.shape, back) == jax.tree.map(
        np.shape, to_numpy(M.init(tcfg, 0, device="cpu")))
    jc = JM.prefill(jax.tree.map(jnp.asarray, tree),
                    {"tokens": jnp.asarray(tokens(tcfg, 2, 4)),
                     "frames": jnp.asarray(frames(tcfg, 2), jcfg.dtype)},
                    jcfg, max_len=8)[1]
    caches = caches_from_jax(jax.tree.map(np.asarray, jc))
    assert caches["self"]["k"].dtype == getattr(torch, dtype)
    assert caches["cross"]["pos"].dtype == torch.int32
    for p in ("self", "cross"):
        for leaf in ("k", "v", "pos"):
            assert np.array_equal(caches[p][leaf].float().numpy(),
                                  np.asarray(jc[p][leaf]).astype(np.float32))


def test_refusals(setup):
    _, tcfg, _, tp = setup
    tb = {"tokens": torch.zeros((2, 4), dtype=torch.int32),
          "frames": torch.from_numpy(frames(tcfg, 2))}
    ids = torch.zeros(2, dtype=torch.int32)
    for fn in (lambda: M.forward(tp, tb, tcfg, adapter_ids=ids),
               lambda: M.prefill(tp, tb, tcfg, adapter_ids=ids)):
        with pytest.raises(NotImplementedError, match="adapter_ids"):
            fn()
    with pytest.raises(ValueError, match="paged serving"):
        DecodeEngine(tcfg, slots=2, device="cpu",
                     paged=PagedSpec(n_blocks=16, block_size=8))
    spec = SD.SpecDecoder.init(get_config("qwen2-7b").reduced().with_(
        vocab_size=tcfg.vocab_size), 0, device="cpu", k=2)
    with pytest.raises(NotImplementedError, match="audio"):
        DecodeEngine(tcfg, slots=2, device="cpu", spec=spec)
    with pytest.raises(NotImplementedError, match="audio"):
        M.verify_step(tp, torch.zeros((2, 3), dtype=torch.int32), {},
                      torch.zeros(2, dtype=torch.int32), tcfg)
    with pytest.raises(ValueError, match="leading dim"):
        DecodeEngine(tcfg, slots=2, device="cpu").serve(
            tp, np.zeros((3, 4), np.int32), gen=2,
            extra_batch={"frames": frames(tcfg, 1)})


def test_cli_prints_the_jax_models_tokens(capsys):
    """``--arch whisper-small`` serves zero frames, as the reference's CLI
    does; its rows are the JAX model's tokens on the same weights and
    prompts (scan, loop and engine alike)."""
    jcfg, tcfg = configs("bfloat16")
    cli = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
           "--prompt-len", "6", "--gen", "3", "--requests", "1"]
    rows = {}
    for impl in ("scan", "loop", "engine"):
        serve.main(cli + ["--impl", impl])
        rows[impl] = [ln.split("first row: ")[1]
                      for ln in capsys.readouterr().out.splitlines()
                      if "first row: " in ln]
    jp = jax.tree.map(lambda a, r: jnp.asarray(a, r.dtype),
                      to_numpy(M.init(tcfg, 0, device="cpu")),
                      JM.init(jcfg, jax.random.PRNGKey(0)))
    prompts = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 6),
                                                dtype=np.int32)
    extra = {"frames": jnp.zeros(
        (2, jcfg.audio.n_audio_frames, jcfg.d_model), jnp.bfloat16)}
    want = np.asarray(jserve.generate(jp, jcfg, jnp.asarray(prompts), gen=3,
                                      extra_batch=extra))
    assert rows["scan"] == rows["loop"] == rows["engine"] \
        == [str(want[0][:8])]
