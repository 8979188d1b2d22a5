"""The port's split-learning pipeline, ``sl_round_cost`` and the serving
CLI's loop, adapter and telemetry options, against the JAX package on the
CPU.

The port runs the SL chain serially on one device; the reference runs it
as a ``shard_map`` over a ``stage`` mesh. A 1-stage mesh runs in this
process (the reference's 4-device form needs forced host devices and is
its ``slow`` test), so the port's chain at S = 1, 2, 4 stages is held to
the reference's monolithic ``classify`` (1e-4, the reference's own bound)
and to the reference's pipeline on a 1-stage mesh (2e-5, the f32 bound of
tests/test_kernels.py). Reduced vit-edge with 4 layers and reduced
falcon-mamba-7b with 4 layers, in f32, adapters perturbed so that LoRA b
is not zero. Fine-tuning steps use sgd: adamw's first step turns the
frameworks' rounding in near-zero gradients into updates of +-lr.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.configs.base import list_configs as jax_list_configs
from repro.core import comm as jcomm
from repro.core import sl_pipeline as jsl
from repro.models import model as JM
from repro.optim import optimizers as jopt
from repro_torch.checkpoint import io as tio
from repro_torch.checkpoint.from_jax import from_jax
from repro_torch.configs.base import get_config, list_configs
from repro_torch.core import comm, sl_pipeline
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.models.params import tree_leaves
from repro_torch.optim import optimizers as topt

B, SEQ = 8, 12


def _cfgs(arch, n_layers=4):
    def one(get):
        cfg = get(arch).reduced().with_(dtype="float32", vocab_size=64,
                                        n_layers=n_layers)
        return cfg.with_(peft=dataclasses.replace(cfg.peft, head_dim_out=5))
    return one(jax_config), one(get_config)


@pytest.fixture(scope="module", params=["vit-edge", "falcon-mamba-7b"])
def model(request):
    """(jax cfg, port cfg, jax params, port params, tokens, labels)."""
    jcfg, tcfg = _cfgs(request.param)
    params = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    params["adapters"] = jax.tree.map(
        lambda x: x + 0.05 * rng.standard_normal(x.shape).astype(x.dtype),
        params["adapters"])
    toks = rng.integers(0, jcfg.vocab_size, (B, SEQ)).astype(np.int32)
    labels = rng.integers(0, 5, (B,)).astype(np.int32)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, params),
            from_jax(params), toks, labels)


@pytest.fixture(scope="module")
def jax_logits(model):
    """The reference's monolithic classify and its 1-stage pipeline at
    M = 1, 2, 4."""
    jcfg, _, jp, _, toks, _ = model
    mono = np.asarray(jax.jit(lambda p, t: JM.classify(p, {"tokens": t},
                                                       jcfg))(
        jp, jnp.asarray(toks)))
    mesh = jax.make_mesh((1,), ("stage",))
    st = jsl.split_for_stages(jp, jcfg, 1)
    pipe = {m: np.asarray(jax.jit(
        lambda p, s, t, m=m: jsl.pipeline_classify(p, s, t, jcfg, mesh,
                                                   n_microbatches=m))(
        jp, st, jnp.asarray(toks))) for m in (1, 2, 4)}
    return mono, pipe


# ---------------------------------------------------------------------------
# the device-free simulator and its cost
# ---------------------------------------------------------------------------

def test_catalog_matches():
    assert list_configs() == jax_list_configs()


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("n_clients", [1, 2, 4, 8])
def test_simulate_sl_and_round_cost_match_jax(n_clients, training):
    for name in list_configs():
        jcfg, tcfg = jax_config(name), get_config(name)
        want = jsl.simulate_sl(jcfg, 8, 32, n_clients, training=training)
        got = sl_pipeline.simulate_sl(tcfg, 8, 32, n_clients,
                                      training=training)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        for kw in ({}, {"model_delivery_bytes": 12345, "upload_bytes": 678}):
            w = jcomm.sl_round_cost(want, jcomm.CostModel(), **kw)
            g = comm.sl_round_cost(got, comm.CostModel(), **kw)
            assert dataclasses.asdict(g) == dataclasses.asdict(w), name


# ---------------------------------------------------------------------------
# validation (tests/test_sl_pipeline.py::TestValidation on the port)
# ---------------------------------------------------------------------------

def test_multi_group_stack_rejected():
    cfg = get_config("vit-edge")
    params = {"backbone": {"layers": {"g0": [{"w": torch.zeros(2)}] * 4,
                                      "g1": [{"w": torch.zeros(2)}] * 4}},
              "adapters": {"stack": {}}}
    with pytest.raises(ValueError, match="single-group"):
        sl_pipeline.split_for_stages(params, cfg, 2)


def test_hybrid_with_a_tail_rejected():
    cfg = get_config("recurrentgemma-2b")
    small = cfg.reduced().with_(n_layers=5, hybrid=dataclasses.replace(
        cfg.reduced().hybrid, tail=("rglru", "rglru")))
    params = M.init(small, 0, device="cpu")
    with pytest.raises(ValueError, match="single-group"):
        sl_pipeline.split_for_stages(params, small, 1)


def test_indivisible_layers_rejected():
    cfg = get_config("vit-edge")
    params = {"backbone": {"layers": {"g0": [{"w": torch.zeros(2)}] * 3}},
              "adapters": {"stack": {}}}
    with pytest.raises(ValueError, match="not divisible by n_stages"):
        sl_pipeline.split_for_stages(params, cfg, 2)


def test_indivisible_microbatches_rejected():
    cfg = get_config("vit-edge")
    toks = torch.zeros((5, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="n_microbatches"):
        sl_pipeline.pipeline_classify({}, {}, toks, cfg, n_microbatches=4)


def test_mesh_is_unported():
    """Once refused: ``pipeline_classify(mesh=)`` and
    ``make_sl_finetune_step(mesh=)`` on a 1-stage `stage` mesh (one gloo
    rank in this process) give the mesh-less chain's logits and sgd step
    bit for bit (reduced vit-edge, 4 f32 layers; the 4-stage mesh against
    the JAX package is ``tests/test_torch_sl_mesh.py``)."""
    from repro_torch.launch.mesh import single_process_mesh
    _, tcfg = _cfgs("vit-edge")
    tp = M.init(tcfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(4)
    for x in tree_leaves(tp["adapters"]):
        x.add_(0.05 * torch.randn(x.shape, generator=gen))
    toks = torch.randint(0, tcfg.vocab_size, (B, SEQ), generator=gen)
    batch = {"tokens": toks, "label": torch.randint(0, 5, (B,),
                                                    generator=gen)}
    st = sl_pipeline.split_for_stages(tp, tcfg, 1)
    head = tp["adapters"]["head"]
    opt = topt.sgd(0.1)
    state = opt.init({"a": st["adapters"], "h": head})
    outs = []
    with single_process_mesh(device="cpu", stage=True) as mesh:
        for m in (None, mesh):
            logits = sl_pipeline.pipeline_classify(
                tp, st, toks, tcfg, n_microbatches=2, mesh=m)
            step = sl_pipeline.make_sl_finetune_step(
                tp, tcfg, opt, n_microbatches=2, mesh=m)
            new, nh, _, loss = step(st, head, state, batch)
            outs.append([logits, loss] + tree_leaves([new["adapters"], nh]))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert not torch.equal(outs[0][2], tree_leaves(st["adapters"])[0])


@pytest.mark.parametrize("n_stages,n_micro", [(2, 2), (4, 4)])
def test_moe_chain_matches_classify(n_stages, n_micro):
    """Once refused: the moe family's chain (reduced granite-moe-1b-a400m,
    4 layers, no dropping: a microbatch routes on its own, so only
    ``capacity_factor=-1`` makes the chain's routing the monolithic
    call's) against the port's and the reference's monolithic
    ``classify``."""
    jcfg, tcfg = (c.with_(moe=dataclasses.replace(c.moe, capacity_factor=-1))
                  for c in _cfgs("granite-moe-1b-a400m"))
    params = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(2)))
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (B, SEQ)).astype(np.int32)
    want = np.asarray(jax.jit(lambda p, t: JM.classify(p, {"tokens": t},
                                                       jcfg))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(toks)))
    tp = from_jax(params)
    mono = M.classify(tp, {"tokens": torch.as_tensor(toks)}, tcfg).numpy()
    got = sl_pipeline.pipeline_classify(
        tp, sl_pipeline.split_for_stages(tp, tcfg, n_stages),
        torch.as_tensor(toks), tcfg, n_microbatches=n_micro).numpy()
    np.testing.assert_allclose(got, mono, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# the chain against the reference
# ---------------------------------------------------------------------------

def test_split_layout(model):
    _, tcfg, _, tp, _, _ = model
    st = sl_pipeline.split_for_stages(tp, tcfg, 2)
    assert [len(s) for s in st["layers"]] == [2, 2]
    assert st["layers"][1][0] is tp["backbone"]["layers"]["g0"][2]
    assert st["adapters"][1][1] is tp["adapters"]["stack"]["g0"][3]


@pytest.mark.parametrize("n_micro", [1, 2, 4])
@pytest.mark.parametrize("n_stages", [1, 2, 4])
def test_pipeline_classify_matches_jax(model, jax_logits, n_stages,
                                       n_micro):
    _, tcfg, _, tp, toks, _ = model
    mono, pipe = jax_logits
    st = sl_pipeline.split_for_stages(tp, tcfg, n_stages)
    got = sl_pipeline.pipeline_classify(
        tp, st, torch.as_tensor(toks), tcfg,
        n_microbatches=n_micro).numpy()
    assert got.shape == mono.shape
    np.testing.assert_allclose(got, mono, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, pipe[n_micro], atol=2e-5, rtol=0)


def test_sl_finetune_step_matches_jax(model):
    """One SGD step of the 4-stage chain against the reference's step on a
    1-stage mesh: loss, stage adapters and head within 1e-5."""
    jcfg, tcfg, jp, tp, toks, labels = model
    mesh = jax.make_mesh((1,), ("stage",))
    jst = jsl.split_for_stages(jp, jcfg, 1)
    jopt_ = jopt.sgd(0.1)
    jstep = jsl.make_sl_finetune_step(jp, jcfg, mesh, jopt_,
                                      n_microbatches=2)
    jhead = jp["adapters"]["head"]
    jstate = jopt_.init({"a": jst["adapters"], "h": jhead})
    jbatch = {"tokens": jnp.asarray(toks), "label": jnp.asarray(labels)}
    jnew, jnh, _, jloss = jax.jit(jstep)(jst, jhead, jstate, jbatch)

    topt_ = topt.sgd(0.1)
    tst = sl_pipeline.split_for_stages(tp, tcfg, 4)
    tstep = sl_pipeline.make_sl_finetune_step(tp, tcfg, topt_,
                                              n_microbatches=2)
    thead = tp["adapters"]["head"]
    before = [x.clone() for x in tree_leaves(tp["adapters"])]
    tstate = topt_.init({"a": tst["adapters"], "h": thead})
    tbatch = {"tokens": torch.as_tensor(toks),
              "label": torch.as_tensor(labels)}
    tnew, tnh, tstate2, tloss = tstep(tst, thead, tstate, tbatch)

    assert abs(float(tloss) - float(jloss)) <= 1e-5
    assert int(tstate2["step"]) == 1
    want_stack = jax.tree.map(lambda x: np.asarray(x)[0], jnew["adapters"])
    want = from_jax({"adapters": {"stack": {"g0": want_stack},
                                  "head": jax.tree.map(np.asarray, jnh)}})
    got_layers = [layer for stage in tnew["adapters"] for layer in stage]
    for g, w in zip(tree_leaves([got_layers, tnh]),
                    tree_leaves([want["adapters"]["stack"]["g0"],
                                 want["adapters"]["head"]])):
        assert torch.allclose(g, w, atol=1e-5, rtol=0), \
            (g - w).abs().max().item()
    # the step moved the adapters, and left the caller's tree as it was
    moved = max((a - b).abs().max().item() for a, b in zip(
        tree_leaves(got_layers), tree_leaves(tp["adapters"]["stack"])))
    assert moved > 0.0
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(tp["adapters"]), before))


# ---------------------------------------------------------------------------
# serving CLI parity: --impl loop, --adapters, --trace-out / --metrics-out
# ---------------------------------------------------------------------------

CLI = ["--arch", "qwen2-7b", "--reduced", "--device", "cpu", "--batch", "2",
       "--prompt-len", "6", "--gen", "4", "--requests", "2"]


def _rows(out: str) -> list[str]:
    return [ln.split("first row: ")[1] for ln in out.splitlines()
            if "first row: " in ln]


def test_cli_loop_prints_the_scan_rows(capsys):
    serve.main(CLI + ["--impl", "scan"])
    scan = _rows(capsys.readouterr().out)
    serve.main(CLI + ["--impl", "loop"])
    loop = _rows(capsys.readouterr().out)
    assert len(scan) == 2 and loop == scan


def test_generate_loop_matches_generate():
    cfg = get_config("qwen2-7b").reduced()
    params = M.init(cfg, 0, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (3, 7),
                            generator=torch.Generator().manual_seed(2))
    want = M.generate(params, cfg, prompts, gen=6)
    got = serve.generate_loop(params, cfg, prompts, gen=6)
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_cli_adapters_round_trip(tmp_path, capsys):
    cfg = get_config("qwen2-7b").reduced()
    ad = M.init(cfg, 7, device="cpu")["adapters"]
    gen = torch.Generator().manual_seed(7)
    for layer in ad["stack"]["g0"]:
        for t in layer["s0"]["lora"].values():
            t["b"] = torch.randn(t["b"].shape, generator=gen).to(t["b"].dtype)
    path = str(tmp_path / "ad.npz")
    tio.save_adapters(path, {"adapters": ad})
    serve.main(CLI + ["--impl", "loop", "--adapters", path])
    out = capsys.readouterr().out
    assert f"loaded adapters from {path}" in out
    params = {**M.init(cfg, 0, device="cpu"), "adapters": ad}
    rng = np.random.default_rng(0)
    want = []
    for _ in range(2):
        prompts = rng.integers(0, cfg.vocab_size, (2, 6), dtype=np.int32)
        toks = M.generate(params, cfg, torch.as_tensor(prompts), gen=4)
        want.append(str(toks.numpy()[0][:8]))
    assert _rows(out) == want
    serve.main(CLI + ["--impl", "loop"])
    assert _rows(capsys.readouterr().out) != want


def test_cli_trace_and_metrics_are_json(tmp_path, capsys):
    import json

    from repro_torch.core import telemetry
    tr, mt = tmp_path / "trace.json", tmp_path / "metrics.json"
    try:
        serve.main(CLI + ["--impl", "loop", "--trace-out", str(tr),
                          "--metrics-out", str(mt)])
    finally:
        telemetry.disable()
    out = capsys.readouterr().out
    trace = json.loads(tr.read_text())
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in spans] == ["serve.request"] * 2
    assert spans[0]["args"]["impl"] == "loop"
    metrics = json.loads(mt.read_text())
    assert metrics["enabled"] is True and metrics["spans"] == 2
    assert "telemetry: 2 spans" in out
