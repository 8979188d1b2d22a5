"""The port's vlm family (llava-next-mistral-7b) against the JAX package,
in f32 on the CPU.

Reduced llava-next-mistral-7b: 2 layers, d_model 256, 4 / 2 heads of 64
(GQA group 2), 16 vision rows, a 64-token sliding window. Both packages
get the same weights through the bridge and the same numpy-made tokens
and vision rows (seeded normal x 0.1); LoRA ``b`` inits to zeros in both,
so it is set to seeded values first. Each test's JAX side runs once, in
module fixtures.

Tolerances: logits ``LOGIT_TOL`` of tests/test_torch_model.py (1e-4);
caches f32 2e-5 (tests/test_kernels.py); greedy tokens identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.core.adapter_bank import AdapterBank as JaxBank
from repro.launch import serve as jserve
from repro.launch.engine import DecodeEngine as JaxEngine
from repro.models import model as JM
from repro_torch.checkpoint.from_jax import (caches_from_jax, from_jax,
                                             to_numpy)
from repro_torch.configs.base import get_config
from repro_torch.core import spec_decode as SD
from repro_torch.core.adapter_bank import AdapterBank
from repro_torch.core.paged import PagedSpec
from repro_torch.launch import serve
from repro_torch.launch.engine import DecodeEngine
from repro_torch.models import model as M

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
TOL = dict(atol=2e-5, rtol=2e-5)
ARCH = "llava-next-mistral-7b"
LENS = [5, 9, 12, 7, 10, 3]
GENS = [4, 2, 6, 3, 5, 7]
DOMAINS = ["nlp", "vision", "speech", "code"]
DOMS = ["vision", "nlp", "code", "speech", "vision", "nlp"]


def configs(**kw):
    kw = dict(dtype="float32", n_kv_heads=2, **kw)
    return (jax_config(ARCH).reduced().with_(**kw),
            get_config(ARCH).reduced().with_(**kw))


def numpy_params(jcfg, seed=0):
    tree = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for t in tree["adapters"]["stack"]["g0"]["s0"]["lora"].values():
        t["b"] = (0.1 * rng.standard_normal(t["b"].shape)).astype(
            t["b"].dtype)
    return tree


def vision(cfg, B, seed=0, n_vis=None):
    n = cfg.vlm.n_vis_tokens if n_vis is None else n_vis
    return (0.1 * np.random.default_rng(100 + seed).standard_normal(
        (B, n, cfg.d_model))).astype(np.float32)


def tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs()
    tree = numpy_params(jcfg)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), from_jax(tree)


def both(batch: dict):
    """The same numpy batch as JAX arrays and as torch tensors."""
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def test_forward_logits_and_text_only_loss_match_jax(setup):
    jcfg, tcfg, jp, tp = setup
    toks = tokens(tcfg, 2, 9)
    jb, tb = both({"tokens": toks, "labels": np.roll(toks, -1, 1),
                   "vision_embeds": vision(tcfg, 2)})
    want = JM.forward(jp, jb, jcfg, mode="eval", remat=False)["logits"]
    got = M.forward(tp, tb, tcfg, mode="eval")["logits"]
    assert got.shape == (2, tcfg.vlm.n_vis_tokens + 9, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    jl, _ = JM.lm_loss(jp, jb, jcfg, remat=False)
    tl, _ = M.lm_loss(tp, tb, tcfg, remat=False)
    np.testing.assert_allclose(tl.item(), float(jl), **LOGIT_TOL)
    # the loss is on the text only: labels the width of the text
    text = M.forward(tp, tb, tcfg, mode="eval")["logits"][:, -9:]
    assert abs(tl.item() - torch.nn.functional.cross_entropy(
        text.reshape(-1, text.shape[-1]),
        tb["labels"].reshape(-1).long()).item()) < 1e-5


def test_prefill_and_decode_steps_match_jax_with_the_vision_offset(setup):
    jcfg, tcfg, jp, tp = setup
    n_vis, S, T = tcfg.vlm.n_vis_tokens, 7, 4
    toks = tokens(tcfg, 2, S + T, seed=1)
    lens = np.array([S, 4], np.int32)
    jb, tb = both({"tokens": toks[:, :S], "vision_embeds": vision(tcfg, 2)})
    jl, jc = JM.prefill(jp, jb, jcfg, max_len=S + n_vis + T,
                        prompt_lens=jnp.asarray(lens))
    tl, tc = M.prefill(tp, tb, tcfg, max_len=S + n_vis + T,
                       prompt_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    jcn = caches_from_jax(jax.tree.map(np.asarray, jc))
    for leaf in ("k", "v"):
        np.testing.assert_allclose(tc["g0"]["s0"][leaf].numpy(),
                                   jcn["g0"]["s0"][leaf].numpy(), **TOL)
    assert torch.equal(tc["g0"]["s0"]["pos"], jcn["g0"]["s0"]["pos"])
    pos = lens + n_vis
    for t in range(T):
        tok = toks[:, S + t:S + t + 1]
        jl, jc = JM.decode_step(jp, jnp.asarray(tok), jc,
                                jnp.asarray(pos + t), jcfg)
        tl, tc = M.decode_step(tp, torch.from_numpy(tok), tc,
                               torch.from_numpy(pos + t), tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


def test_sliding_window_rolls_over_behind_the_vision_rows():
    """Decode past an 8-token window behind 4 vision rows: the rolling
    cache gives the full forward's logits, in both packages alike."""
    jcfg, tcfg = configs(sliding_window=8)
    jcfg = jcfg.with_(vlm=dataclasses.replace(jcfg.vlm, n_vis_tokens=4))
    tcfg = tcfg.with_(vlm=dataclasses.replace(tcfg.vlm, n_vis_tokens=4))
    tree = numpy_params(jcfg, seed=3)
    jp, tp = jax.tree.map(jnp.asarray, tree), from_jax(tree)
    S, T, n_vis = 12, 6, 4
    toks = tokens(tcfg, 2, S + T, seed=3)
    vis = vision(tcfg, 2, seed=3, n_vis=n_vis)
    _, jb = both({"tokens": toks, "vision_embeds": vis})
    full = M.forward(tp, jb, tcfg, mode="eval")["logits"]
    jc = JM.prefill(jp, {"tokens": jnp.asarray(toks[:, :S]),
                         "vision_embeds": jnp.asarray(vis)}, jcfg)[1]
    _, tc = M.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S]),
                           "vision_embeds": torch.from_numpy(vis)}, tcfg)
    assert tc["g0"]["s0"]["k"].shape[2] == 8
    for t in range(T):
        tok = toks[:, S + t:S + t + 1]
        p = S + t + n_vis
        jl, jc = JM.decode_step(jp, jnp.asarray(tok), jc,
                                jnp.asarray(p, jnp.int32), jcfg)
        tl, tc = M.decode_step(tp, torch.from_numpy(tok), tc,
                               torch.tensor(p), tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        np.testing.assert_allclose(tl.numpy(), full[:, p:p + 1].numpy(),
                                   atol=3e-4, rtol=3e-4)


@pytest.mark.parametrize("ragged", [False, True])
def test_generate_with_extra_batch_matches_generate_scan(setup, ragged):
    jcfg, tcfg, jp, tp = setup
    toks = tokens(tcfg, 3, 10, seed=2)
    vis = vision(tcfg, 3, seed=2)
    lens = np.array([10, 4, 7], np.int32) if ragged else None
    want = JM.generate_scan(jp, jcfg, jnp.asarray(toks), gen=8,
                            extra_batch={"vision_embeds": jnp.asarray(vis)},
                            prompt_lens=lens)
    got = M.generate(tp, tcfg, torch.from_numpy(toks), gen=8,
                     extra_batch={"vision_embeds": torch.from_numpy(vis)},
                     prompt_lens=None if lens is None
                     else torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def queue(cfg, seed=4):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in LENS]
    return prompts, vision(cfg, len(LENS), seed=seed)


def drain(eng, params, prompts, vis, domains=None):
    uids = [eng.submit(p, g, extras={"vision_embeds": vis[i]},
                       domain=None if domains is None else domains[i])
            for i, (p, g) in enumerate(zip(prompts, GENS))]
    comps, stats = eng.run(params)
    by = {c.uid: c.tokens for c in comps}
    return [by[u] for u in uids], stats


STATS = ["requests", "waves", "segments", "tokens", "padded_tokens"]


@pytest.fixture(scope="module")
def drained(setup):
    """An interleaved-length drain of 6 requests, each with its own vision
    row, through 2 slots (in-wave refill), in both packages, and each
    request alone through ``generate_scan``."""
    jcfg, tcfg, jp, tp = setup
    prompts, vis = queue(tcfg)
    jt, js = drain(JaxEngine(jcfg, slots=2), jp, prompts, vis)
    tt, ts = drain(DecodeEngine(tcfg, slots=2, device="cpu"), tp, prompts,
                   torch.from_numpy(vis))
    solo = [np.asarray(JM.generate_scan(
        jp, jcfg, jnp.asarray(p[None]), gen=g,
        extra_batch={"vision_embeds": jnp.asarray(vis[i][None])}))[0]
        for i, (p, g) in enumerate(zip(prompts, GENS))]
    return dict(jt=jt, js=js, tt=tt, ts=ts, solo=solo)


def test_engine_drain_matches_jax_and_solo_generate_scan(drained):
    for a, b, c in zip(drained["tt"], drained["jt"], drained["solo"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    for f in STATS:
        assert getattr(drained["ts"], f) == getattr(drained["js"], f), f
    assert drained["ts"].waves > 1


def test_engine_extras_stay_bound_to_their_requests(setup, drained):
    """The same queue with numpy rows: the vision rows ride their requests
    through packing and refill (swapping two requests' prompts and rows
    swaps their tokens; the budgets stay with the queue positions)."""
    _, tcfg, _, tp = setup
    prompts, vis = queue(tcfg)
    got, _ = drain(DecodeEngine(tcfg, slots=2, device="cpu"), tp, prompts,
                   vis)
    for a, b in zip(got, drained["tt"]):
        np.testing.assert_array_equal(a, b)
    swapped = vis.copy()
    swapped[[0, 2]] = vis[[2, 0]]
    other, _ = drain(DecodeEngine(tcfg, slots=2, device="cpu"), tp,
                     [prompts[2], prompts[1], prompts[0]] + prompts[3:],
                     swapped)
    np.testing.assert_array_equal(other[0], got[2][:GENS[0]])
    np.testing.assert_array_equal(other[2][:GENS[0]], got[0])


def test_bank_drain_with_vision_rows_matches_jax(setup):
    jcfg, tcfg, jp, tp = setup
    ads = {d: numpy_params(jcfg, 10 + n)["adapters"]
           for n, d in enumerate(DOMAINS)}
    jbank = JaxBank.create({d: jax.tree.map(jnp.asarray, a)
                            for d, a in ads.items()})
    tbank = AdapterBank.create({d: from_jax(a) for d, a in ads.items()})
    prompts, vis = queue(tcfg, seed=6)
    jt, js = drain(JaxEngine(jcfg, slots=3, bank=jbank),
                   jbank.serving_params(jp["backbone"]), prompts, vis, DOMS)
    tt, ts = drain(DecodeEngine(tcfg, slots=3, bank=tbank, device="cpu"),
                   tbank.serving_params(tp["backbone"]), prompts, vis, DOMS)
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a, b)
    for f in STATS:
        assert getattr(ts, f) == getattr(js, f), f
    assert len({tuple(t) for t in tt}) > 1


def test_extras_validation_and_refusals(setup):
    _, tcfg, _, tp = setup
    eng = DecodeEngine(tcfg, slots=2, device="cpu")
    row = vision(tcfg, 1)[0]
    eng.submit(np.zeros(6, np.int32), 2, extras={"vision_embeds": row})
    eng.submit(np.zeros(6, np.int32), 2)
    with pytest.raises(ValueError, match="extras keys"):
        eng.run(tp)
    with pytest.raises(ValueError, match="leading dim"):
        DecodeEngine(tcfg, slots=2, device="cpu").serve(
            tp, np.zeros((3, 6), np.int32), gen=2,
            extra_batch={"vision_embeds": vision(tcfg, 2)})
    with pytest.raises(ValueError, match="paged serving"):
        DecodeEngine(tcfg, slots=2, device="cpu",
                     paged=PagedSpec(n_blocks=16, block_size=8))
    spec = SD.SpecDecoder.init(get_config("qwen2-7b").reduced(), 0,
                               device="cpu", k=2)
    with pytest.raises(NotImplementedError, match="vlm"):
        DecodeEngine(tcfg, slots=2, device="cpu", spec=spec)
    with pytest.raises(NotImplementedError, match="vlm"):
        M.verify_step(tp, torch.zeros((2, 3), dtype=torch.int32), {},
                      torch.zeros(2, dtype=torch.int32), tcfg)


def test_cli_prints_the_jax_models_tokens(setup, capsys):
    """``--arch llava-next-mistral-7b`` serves zero vision rows, as the
    reference's CLI does; its rows are the JAX model's tokens on the same
    weights and prompts (scan, loop and engine alike)."""
    jcfg = jax_config(ARCH).reduced()
    tcfg = get_config(ARCH).reduced()
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
    extra = {"vision_embeds": jnp.zeros(
        (2, jcfg.vlm.n_vis_tokens, jcfg.d_model), jnp.bfloat16)}
    want = np.asarray(jserve.generate(jp, jcfg, jnp.asarray(prompts), gen=3,
                                      extra_batch=extra))
    assert rows["scan"] == rows["loop"] == rows["engine"] \
        == [str(want[0][:8])]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", [ARCH, "whisper-small", "qwen2-7b"])
def test_input_specs_match_jax(arch, kind):
    from repro.configs.base import InputShape as JaxShape
    from repro_torch.configs.base import InputShape
    want = JM.input_specs(jax_config(arch).reduced(), JaxShape(
        "s", 64, 2, kind))
    got = M.input_specs(get_config(arch).reduced(), InputShape(
        "s", 64, 2, kind))
    assert {k: (tuple(v.shape), np.dtype(v.dtype).name)
            for k, v in want.items()} == \
        {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in got.items()}
    assert all(v.device.type == "meta" for v in got.values())
