"""The port's dense model against the JAX package, in f32 on the CPU.

Both packages get the same weights through the bridge
(``repro_torch.checkpoint.from_jax``) and the same numpy-made inputs.
LoRA ``b`` and the QKV biases init to zeros in both packages, which would
leave the fused kernel's LoRA and bias branches untested, so they are set
to seeded random values first.

Logits tolerance: 1e-4 absolute and relative (f32; the two frameworks sum
in different orders). Greedy tokens must be identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.models import model as JM
from repro_torch.checkpoint.from_jax import from_jax, to_numpy
from repro_torch.configs.base import get_config
from repro_torch.models import model as M

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)

# qwen2-shaped reduced configs: reduced() gives g = 1, so also g = 2 and a
# sliding-window variant (rolling-buffer cache)
VARIANTS = {
    "g1": {},
    "g2": {"n_kv_heads": 2},
    "sliding": {"n_kv_heads": 2, "attn_variant": "sliding",
                "sliding_window": 8},
}


def configs(variant, dtype="float32"):
    kw = dict(VARIANTS[variant], dtype=dtype)
    return (jax_config("qwen2-7b").reduced().with_(**kw),
            get_config("qwen2-7b").reduced().with_(**kw))


def numpy_params(jcfg, seed=0):
    """Reference init as numpy, with LoRA b and biases made nonzero."""
    tree = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    stack = tree["backbone"]["layers"]["g0"]["s0"]["attn"]
    for name in ("bq", "bk", "bv"):
        stack[name] = (0.1 * rng.standard_normal(stack[name].shape)).astype(
            stack[name].dtype)
    for t in tree["adapters"]["stack"]["g0"]["s0"]["lora"].values():
        t["b"] = (0.1 * rng.standard_normal(t["b"].shape)).astype(
            t["b"].dtype)
    return tree


@pytest.fixture(scope="module", params=list(VARIANTS))
def setup(request):
    jcfg, tcfg = configs(request.param)
    tree = numpy_params(jcfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jcfg, tcfg, jparams, from_jax(tree)


def tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trips(dtype):
    jcfg, tcfg = configs("g2", dtype)
    tree = numpy_params(jcfg)
    params = from_jax(tree)
    lay = params["backbone"]["layers"]["g0"]
    assert len(lay) == jcfg.n_layers
    assert lay[0]["s0"]["attn"]["wq"].dtype == getattr(torch, dtype)
    spec_shapes = jax.tree.map(np.shape, to_numpy(
        M.init(tcfg, 0, device="cpu")))
    back = to_numpy(params)
    assert jax.tree.map(np.shape, back) == spec_shapes
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a, np.float32), b), tree, back)


def test_forward_logits_match(setup):
    jcfg, tcfg, jparams, tparams = setup
    toks = tokens(tcfg, 2, 11)
    want = JM.forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                      mode="eval")["logits"]
    got = M.forward(tparams, {"tokens": torch.from_numpy(toks)}, tcfg)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want),
                               **LOGIT_TOL)


def test_prefill_and_decode_step_match(setup):
    """Ragged prefill (per-row prompt_lens): last-token logits and every
    cache leaf; then two decode steps with per-row positions, one row
    retired (active=False) on the second."""
    jcfg, tcfg, jparams, tparams = setup
    toks = tokens(tcfg, 3, 12, seed=1)
    lens = np.array([12, 7, 3], np.int32)
    jl, jc = JM.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                        max_len=20, prompt_lens=jnp.asarray(lens))
    tl, tc = M.prefill(tparams, {"tokens": torch.from_numpy(toks)}, tcfg,
                       max_len=20, prompt_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for leaf in ("k", "v", "pos"):
        np.testing.assert_allclose(tc["g0"]["s0"][leaf].numpy(),
                                   np.asarray(jc["g0"]["s0"][leaf]),
                                   atol=1e-5, rtol=1e-5)
    pos = lens.copy()
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    for active in (np.array([True, True, True]),
                   np.array([True, False, True])):
        jl, jc = JM.decode_step(jparams, jnp.asarray(nxt), jc,
                                jnp.asarray(pos), jcfg,
                                active=jnp.asarray(active))
        tl, tc = M.decode_step(tparams, torch.from_numpy(nxt), tc,
                               torch.from_numpy(pos), tcfg,
                               active=torch.from_numpy(active))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        np.testing.assert_array_equal(tc["g0"]["s0"]["pos"].numpy(),
                                      np.asarray(jc["g0"]["s0"]["pos"]))
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        pos = pos + active


def test_cache_spec_matches_the_caches_prefill_builds(setup):
    """Full and sliding-window (rolling buffer) layouts alike."""
    _, tcfg, _, tparams = setup
    toks = torch.from_numpy(tokens(tcfg, 2, 10))
    _, caches = M.prefill(tparams, {"tokens": toks}, tcfg, max_len=16)
    spec = M.cache_spec(tcfg, 2, 16)["g0"]["s0"]
    assert {k: (tuple(v.shape), v.dtype)
            for k, v in caches["g0"]["s0"].items()} == \
        {k: (s.shape, s.dtype) for k, s in spec.items()}


@pytest.mark.parametrize("ragged", [False, True])
def test_greedy_generate_matches_generate_scan(setup, ragged):
    jcfg, tcfg, jparams, tparams = setup
    toks = tokens(tcfg, 3, 9, seed=2)
    lens = np.array([9, 4, 6], np.int32) if ragged else None
    want = JM.generate_scan(jparams, jcfg, jnp.asarray(toks), gen=6,
                            prompt_lens=lens)
    got = M.generate(tparams, tcfg, torch.from_numpy(toks), gen=6,
                     prompt_lens=None if lens is None
                     else torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_generate_is_seeded():
    _, tcfg = configs("g1")
    params = M.init(tcfg, 3, device="cpu")
    toks = torch.from_numpy(tokens(tcfg, 2, 5))
    runs = [M.generate(params, tcfg, toks, gen=4, greedy=False,
                       generator=torch.Generator().manual_seed(9))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert runs[0].shape == (2, 4)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b",
                                  "granite-moe-1b-a400m",
                                  "llava-next-mistral-7b", "whisper-small"])
def test_unported_families_raise_naming_the_roadmap_item(arch):
    cfg = get_config(arch).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.init(cfg, 0, device="cpu")


def test_init_is_deterministic_and_matches_the_spec():
    _, tcfg = configs("g2")
    a = M.init(tcfg, 5, device="cpu")
    b = M.init(tcfg, 5, device="cpu")
    la, lb = (p["backbone"]["layers"]["g0"] for p in (a, b))
    assert torch.equal(la[1]["s0"]["attn"]["wq"], lb[1]["s0"]["attn"]["wq"])
    assert not torch.equal(la[0]["s0"]["attn"]["wq"],
                           la[1]["s0"]["attn"]["wq"])
    assert tcfg.n_kv_heads == 2
    assert la[0]["s0"]["attn"]["wk"].shape == (tcfg.d_model,
                                               2 * tcfg.head_dim_)
