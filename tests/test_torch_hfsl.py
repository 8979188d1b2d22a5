"""The port's HFSL fine-tuning slice against the JAX package, on the CPU:
data generators and the batch bank (bit for bit), optimizers and
schedules, the HFSL round from bridged JAX state against
``repro.core.hfsl.make_hfsl_round``, the faulted body, LoRA merge, the
state bridge, and the port's own round invariants.

Reduced vit-edge in f32 (vocab 64, head 5), N=3 clusters, K=6 steps,
batch 4, seq 16, as in tests/test_hfsl_round.py. The reference's training
differentiates attention through XLA (``flash_attention_pallas`` has no
VJP), so the JAX rounds run on the default ``xla`` backend.

Tolerances: 1e-5 with sgd, 1e-4 with adamw (Adam's ``m/√v`` magnifies the
f32 differences between the frameworks where a gradient is near zero).
LoRA ``b`` inits to zeros in both packages, which makes ``dA`` exactly
zero; the round tests set it to seeded values first.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.core import hfsl as jhfsl
from repro.core import peft as jpeft
from repro.data import noniid as jnoniid
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.models import model as JM
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch.checkpoint.from_jax import (from_jax, hfsl_state_from_jax,
                                             hfsl_state_to_numpy)
from repro_torch.configs.base import get_config
from repro_torch.core import hfsl, peft, telemetry
from repro_torch.data import noniid, pipeline, synthetic
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.models import model as M
from repro_torch.models.params import tree_leaves
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched

N, K, BATCH, SEQ = 3, 6, 4, 16
SGD_TOL = dict(atol=1e-5, rtol=1e-5)
ADAM_TOL = dict(atol=1e-4, rtol=1e-4)


def _small(get):
    cfg = get("vit-edge").reduced().with_(dtype="float32", vocab_size=64)
    return cfg.with_(peft=dataclasses.replace(cfg.peft, head_dim_out=5))


JCFG, TCFG = _small(jax_config), _small(get_config)

OPTS = {
    "adamw": (lambda: jopt.adamw(5e-3), lambda: topt.adamw(5e-3), ADAM_TOL),
    "sgd_momentum": (lambda: jopt.sgd(0.1, momentum=0.9),
                     lambda: topt.sgd(0.1, momentum=0.9), SGD_TOL),
}


def classify_data(seed=0):
    task = jsyn.ClassificationTask(5, 64, SEQ, seed=seed)
    data = task.dataset(40 * N, seed=seed + 1)
    return data, jnoniid.partition_by_classes(data["label"], N, 3, seed=seed)


@pytest.fixture(scope="module")
def banks():
    """The same classify epoch as a JAX bank and a port bank."""
    data, parts = classify_data()
    return (jpipe.BatchBank.pack(data, parts, BATCH, seed=0),
            pipeline.BatchBank.pack(data, parts, BATCH, seed=0,
                                    device="cpu"))


def lm_banks(seed=0):
    jits = [iter(jsyn.LMStream(64, BATCH, SEQ, seed=seed + i))
            for i in range(N)]
    tits = [iter(synthetic.LMStream(64, BATCH, SEQ, seed=seed + i))
            for i in range(N)]

    def gen(its, stack):
        while True:
            bs = [next(i) for i in its]
            yield {k: stack([b[k] for b in bs]) for k in bs[0]}

    return (jpipe.BatchBank.from_iterator(gen(jits, jnp.stack), K),
            pipeline.BatchBank.from_iterator(gen(tits, np.stack), K,
                                             device="cpu"))


def jax_state(opt, seed=0):
    """Reference init (numpy leaves) with seeded nonzero LoRA b."""
    st = jhfsl.init_hfsl_state(jax.random.PRNGKey(seed), JCFG, N, opt,
                               JM.init)
    tree = jax.tree.map(np.asarray, st)
    rng = np.random.default_rng(seed)
    for t in tree["adapters_c"]["stack"]["g0"]["s0"]["lora"].values():
        t["b"] = (0.1 * rng.standard_normal(t["b"].shape)).astype(np.float32)
    return tree


def assert_state_close(port_state, jax_tree, **tol):
    back = hfsl_state_to_numpy(port_state)
    for key in ("adapters_c", "opt"):
        got, want = jax.tree.leaves(back[key]), jax.tree.leaves(
            jax.tree.map(np.asarray, jax_tree[key]))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.astype(np.float32),
                                       w.astype(np.float32), **tol)
    assert int(back["step"]) == int(np.asarray(jax_tree["step"]))


def max_spread(state):
    return max(float((x.float().amax(0) - x.float().amin(0)).abs().max())
               for x in tree_leaves(state["adapters_c"]))


# ---------------------------------------------------------------------------
# Data: the same arrays as the JAX package, bit for bit
# ---------------------------------------------------------------------------

def test_classification_task_and_partition_match_jax():
    jt = jsyn.ClassificationTask(5, 64, SEQ, seed=3)
    tt = synthetic.ClassificationTask(5, 64, SEQ, seed=3)
    jd, td = jt.dataset(90, seed=4), tt.dataset(90, seed=4)
    for k in ("tokens", "label"):
        assert td[k].dtype == jd[k].dtype
        np.testing.assert_array_equal(td[k], jd[k])
    js, ts = jt.sample(7), tt.sample(7)              # the task's own stream
    for k in ("tokens", "label"):
        np.testing.assert_array_equal(ts[k], np.asarray(js[k]))
    for cpc in (1, 3):
        jp = jnoniid.partition_by_classes(jd["label"], N, cpc, seed=2)
        tp = noniid.partition_by_classes(td["label"], N, cpc, seed=2)
        for a, b in zip(jp, tp):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(jnoniid.dirichlet_partition(jd["label"], N, seed=1),
                    noniid.dirichlet_partition(td["label"], N, seed=1)):
        np.testing.assert_array_equal(a, b)


def test_lm_stream_matches_jax():
    jit_ = iter(jsyn.LMStream(64, 3, 10, seed=5))
    tit = iter(synthetic.LMStream(64, 3, 10, seed=5))
    for _ in range(2):
        j, t = next(jit_), next(tit)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(t[k], np.asarray(j[k]))


def test_batch_bank_matches_jax(banks):
    jb, tb = banks
    assert (tb.steps, tb.n_clusters) == (jb.steps, jb.n_clusters)
    for k in jb.arrays:
        assert tb.arrays[k].device.type == "cpu"
        np.testing.assert_array_equal(tb.arrays[k].numpy(),
                                      np.asarray(jb.arrays[k]))
    jl, tl = lm_banks()
    for k in jl.arrays:
        np.testing.assert_array_equal(tl.arrays[k].numpy(),
                                      np.asarray(jl.arrays[k]))
    E = tb.steps
    bank = pipeline.BatchBank(tb.arrays)
    assert bank.advance(E - 1) == 0 and bank.advance(2) == E - 1
    assert bank.offset == 1


def test_cluster_batches_and_bank_rules():
    data, parts = classify_data()
    it = pipeline.cluster_batches(data, parts, BATCH, seed=0, device="cpu")
    jit_ = jpipe.cluster_batches(data, parts, BATCH, seed=0)
    for _ in range(2):
        t, j = next(it), next(jit_)
        for k in j:
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
    tiny = {"tokens": np.zeros((8, 4), np.int32),
            "label": np.zeros((8,), np.int32)}
    with pytest.raises(ValueError):
        pipeline.BatchBank.pack(tiny, [np.arange(6), np.arange(6, 8)], 4,
                                device="cpu")
    # cluster-sharded over a mesh (1x1 gloo here; 2x2 in test_torch_mesh)
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import single_process_mesh
    plain = pipeline.BatchBank.pack(data, parts, BATCH, seed=3, device="cpu")
    with single_process_mesh("cpu") as mesh:
        placed = pipeline.BatchBank.pack(data, parts, BATCH, seed=3,
                                         mesh=mesh, device="cpu")
        for k, v in placed.arrays.items():
            assert tuple(v.placements) == (Shard(1), Replicate())
            assert torch.equal(v.full_tensor(), plain.arrays[k])


# ---------------------------------------------------------------------------
# Optimizers and schedules
# ---------------------------------------------------------------------------

def _opt_tree(rng):
    return {"a": [rng.standard_normal((4, 3)).astype(np.float32),
                  rng.standard_normal((5,)).astype(np.float32)],
            "b": {"w": rng.standard_normal((2, 6)).astype(np.float32)}}


def _as_torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


@pytest.mark.parametrize("kind", ["sgd", "sgd_momentum", "adamw",
                                  "adamw_wd_cosine", "clipped"])
def test_optimizer_matches_jax(kind):
    rng = np.random.default_rng(0)
    params = _opt_tree(rng)
    if kind == "sgd":
        jo, to = jopt.sgd(0.1), topt.sgd(0.1)
    elif kind == "sgd_momentum":
        jo, to = jopt.sgd(0.1, momentum=0.9), topt.sgd(0.1, momentum=0.9)
    elif kind == "adamw_wd_cosine":
        jo = jopt.adamw(jsched.warmup_cosine(1e-2, 2, 5), weight_decay=0.1)
        to = topt.adamw(tsched.warmup_cosine(1e-2, 2, 5), weight_decay=0.1)
    else:
        jo, to = jopt.adamw(5e-3), topt.adamw(5e-3)
    jp, tp = params, _as_torch(params)
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(4):
        g = _opt_tree(rng)
        jg, tg = g, _as_torch(g)
        if kind == "clipped":
            jg, jn = jopt.clip_by_global_norm(jg, 0.5)
            tg, tn = topt.clip_by_global_norm(tg, 0.5)
            np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
        ju, js = jo.update(jg, js, jp)
        tu, ts = to.update(tg, ts, tp)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 4
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6,
                                   rtol=1e-6)
    for key in ("m", "v", "mu"):
        if ts.get(key) is not None:
            for a, b in zip(jax.tree.leaves(js[key]), tree_leaves(ts[key])):
                assert b.dtype == torch.float32
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           atol=1e-7, rtol=1e-6)


def test_schedules_match_jax():
    steps = np.arange(0, 12, dtype=np.int32)
    js, ts = jnp.asarray(steps), torch.from_numpy(steps)
    for jf, tf in ((jsched.constant(3e-3), tsched.constant(3e-3)),
                   (jsched.warmup_cosine(1e-2, 3, 10, floor=1e-4),
                    tsched.warmup_cosine(1e-2, 3, 10, floor=1e-4)),
                   (jsched.linear_decay(1e-2, 8, floor=1e-3),
                    tsched.linear_decay(1e-2, 8, floor=1e-3))):
        want = np.broadcast_to(np.asarray(jf(js)), steps.shape)
        got = tf(ts).expand(steps.shape).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_global_norm_matches_jax():
    tree = _opt_tree(np.random.default_rng(3))
    np.testing.assert_allclose(topt.global_norm(_as_torch(tree)).numpy(),
                               np.asarray(jopt.global_norm(tree)), rtol=1e-6)


# ---------------------------------------------------------------------------
# The HFSL round from bridged JAX state against the reference round
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt_name,sync_every", [("adamw", 3),
                                                 ("sgd_momentum", 3),
                                                 ("adamw", 1)])
def test_classify_round_matches_jax(banks, opt_name, sync_every):
    jmake, tmake, tol = OPTS[opt_name]
    jb, tb = banks
    tree = jax_state(jmake())
    jrnd = jhfsl.make_hfsl_round(JCFG, jmake(), JM.classify_loss, steps=K,
                                 sync_every=sync_every)
    js, jm = jrnd(jax.tree.map(jnp.asarray, tree), jb.arrays, 0)
    state = hfsl_state_from_jax(tree, "cpu")
    trnd = hfsl.make_hfsl_round(TCFG, tmake(), M.classify_loss, steps=K,
                                sync_every=sync_every)
    ts, tm = trnd(state, tb.arrays, 0)
    assert_state_close(ts, js, **tol)
    for k in ("loss", "loss_per_cluster", "acc"):
        assert tm[k].shape[0] == K
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), **tol)


def test_lm_round_matches_jax_and_remat_matches_plain():
    """lm_loss rounds: the port's plain round against the reference's, and
    the port's remat round against its plain one (the checkpointed layers
    recompute the same forward)."""
    jb, tb = lm_banks()
    tree = jax_state(jopt.sgd(0.1))
    jrnd = jhfsl.make_hfsl_round(JCFG, jopt.sgd(0.1), JM.lm_loss, steps=2,
                                 remat=False)
    js, jm = jrnd(jax.tree.map(jnp.asarray, tree), jb.arrays, 0)
    state = hfsl_state_from_jax(tree, "cpu")
    plain = hfsl.make_hfsl_round(TCFG, topt.sgd(0.1), M.lm_loss, steps=2,
                                 remat=False)
    remat = hfsl.make_hfsl_round(TCFG, topt.sgd(0.1), M.lm_loss, steps=2,
                                 remat=True)
    sp, mp = plain(state, tb.arrays, 0)
    sr, mr = remat(state, tb.arrays, 0)
    assert_state_close(sp, js, **SGD_TOL)
    np.testing.assert_allclose(mp["loss"].numpy(), np.asarray(jm["loss"]),
                               **SGD_TOL)
    for a, b in zip(tree_leaves(sp["adapters_c"]),
                    tree_leaves(sr["adapters_c"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **SGD_TOL)
    np.testing.assert_allclose(mp["loss"].numpy(), mr["loss"].numpy(),
                               **SGD_TOL)


def test_faulted_round_matches_jax(banks):
    """An explicit participation mask (cluster 1 dropped) and a corruption
    flag (cluster 2) through the faulted body, against the reference."""
    jb, tb = banks
    tree = jax_state(jopt.adamw(5e-3))
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    corrupt = np.array([False, False, True])
    jrnd = jhfsl.make_hfsl_round(JCFG, jopt.adamw(5e-3), JM.classify_loss,
                                 steps=3, sync_every=2)
    js, jm = jrnd(jax.tree.map(jnp.asarray, tree), jb.arrays, 1, mask=mask,
                  corrupt=corrupt)
    state = hfsl_state_from_jax(tree, "cpu")
    tel = telemetry.enable()
    trnd = hfsl.make_hfsl_round(TCFG, topt.adamw(5e-3), M.classify_loss,
                                steps=3, sync_every=2)
    ts, tm = trnd(state, tb.arrays, 1, mask=mask, corrupt=corrupt)
    counters = tel.snapshot()["counters"]
    telemetry.disable()
    assert counters["hfsl.faulted_rounds"] == 1
    assert counters["hfsl.steps"] == 3
    assert_state_close(ts, js, **ADAM_TOL)
    for k in ("participating", "skipped", "dropped"):
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]))
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               **ADAM_TOL)
    # the dropped cluster's replica passed through every step unchanged
    for a, b in zip(tree_leaves(ts["adapters_c"]),
                    tree_leaves(state["adapters_c"])):
        assert torch.equal(a[1], b[1])


def test_faulted_body_without_faults_equals_plain_body(banks):
    """All-ones mask and no corruption: the faulted body selects the plain
    arithmetic, bit for bit."""
    _, tb = banks
    state = hfsl_state_from_jax(jax_state(jopt.adamw(5e-3)), "cpu")
    batch = {k: v[0] for k, v in tb.arrays.items()}
    kw = dict(sync_every=2, clip_norm=0.0, always_sync=False,
              microbatches=1)
    plain = hfsl._make_step_body(TCFG, topt.adamw(5e-3), M.classify_loss,
                                 **kw)
    faulted = hfsl._make_step_body(TCFG, topt.adamw(5e-3), M.classify_loss,
                                   faulted=True, **kw)
    sp, mp = plain(state, batch)
    sf, mf = faulted(state, batch, torch.ones(N), torch.zeros(N,
                                                              dtype=bool))
    for a, b in zip(tree_leaves({"a": sp["adapters_c"], "o": sp["opt"]}),
                    tree_leaves({"a": sf["adapters_c"], "o": sf["opt"]})):
        assert torch.equal(a, b)
    assert torch.equal(mp["loss"], mf["loss"])


def test_fedavg_masked_matches_jax():
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((N, 4, 3)).astype(np.float32),
            "b": [rng.standard_normal((N, 5)).astype(np.float32)]}
    for mask in ([1, 1, 1], [1, 0, 1], [0, 0, 0]):
        m = np.asarray(mask, np.float32)
        want = jhfsl.fedavg_masked(tree, jnp.asarray(m))
        got = hfsl.fedavg_masked(_as_torch(tree), torch.from_numpy(m))
        for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-7)
    full = hfsl.fedavg_masked(_as_torch(tree), torch.ones(N))
    for a, b in zip(tree_leaves(full), tree_leaves(hfsl.fedavg(
            _as_torch(tree)))):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The port's own round invariants
# ---------------------------------------------------------------------------

def port_state(opt, seed=0):
    return hfsl_state_from_jax(jax_state(opt, seed), "cpu")


def run_steps(opt, state, bank, steps, **kw):
    step = hfsl.make_hfsl_step(TCFG, opt, M.classify_loss, **kw)
    losses = []
    for i in range(steps):
        batch = {k: v[i % bank.steps] for k, v in bank.arrays.items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return state, losses


def test_round_equals_k_legacy_steps(banks):
    _, tb = banks
    opt = topt.adamw(5e-3)
    state = port_state(jopt.adamw(5e-3))
    s_loop, losses = run_steps(opt, state, tb, K, sync_every=3)
    s_rnd, ms = hfsl.make_hfsl_round(TCFG, opt, M.classify_loss, steps=K,
                                     sync_every=3)(state, tb.arrays, 0)
    assert int(s_rnd["step"]) == K
    for a, b in zip(tree_leaves({"a": s_loop["adapters_c"],
                                 "o": s_loop["opt"]}),
                    tree_leaves({"a": s_rnd["adapters_c"],
                                 "o": s_rnd["opt"]})):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(np.float32(losses), ms["loss"].numpy())


def test_two_rounds_with_carried_step_equal_one_long_run(banks):
    _, tb = banks
    opt = topt.sgd(0.1)
    state = port_state(jopt.sgd(0.1))
    s_loop, _ = run_steps(opt, state, tb, 2 * K, sync_every=4)
    rnd = hfsl.make_hfsl_round(TCFG, opt, M.classify_loss, steps=K,
                               sync_every=4)
    bank = pipeline.BatchBank(tb.arrays)
    s1, _ = rnd(state, bank.arrays, bank.advance(K))
    s2, _ = rnd(s1, bank.arrays, bank.advance(K))
    assert int(s2["step"]) == 2 * K
    for a, b in zip(tree_leaves(s_loop["adapters_c"]),
                    tree_leaves(s2["adapters_c"])):
        assert torch.equal(a, b)


def test_microbatch_accumulation_matches_full_batch(banks):
    _, tb = banks
    opt = topt.adamw(5e-3)
    state = port_state(jopt.adamw(5e-3))
    full = hfsl.make_hfsl_round(TCFG, opt, M.classify_loss, steps=K,
                                sync_every=3)
    accum = hfsl.make_hfsl_round(TCFG, opt, M.classify_loss, steps=K,
                                 sync_every=3, microbatches=2)
    s_full, m_full = full(state, tb.arrays, 0)
    s_acc, m_acc = accum(state, tb.arrays, 0)
    for a, b in zip(tree_leaves(s_full["adapters_c"]),
                    tree_leaves(s_acc["adapters_c"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4,
                                   rtol=1e-4)
    np.testing.assert_allclose(m_full["loss"].numpy(), m_acc["loss"].numpy(),
                               atol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        hfsl.make_hfsl_round(TCFG, opt, M.classify_loss, steps=1,
                             microbatches=3)(state, tb.arrays, 0)


def test_fedavg_fires_exactly_at_sync_boundaries(banks):
    """Replicas are equal right after steps 3 and 6 and differ between."""
    _, tb = banks
    rnd = hfsl.make_hfsl_round(TCFG, topt.sgd(0.1), M.classify_loss,
                               steps=1, sync_every=3)
    state = port_state(jopt.sgd(0.1))
    for i in range(K):
        state, _ = rnd(state, tb.arrays, i % tb.steps)
        spread = max_spread(state)
        if (i + 1) % 3 == 0:
            assert spread < 1e-6, (i + 1, spread)
        else:
            assert spread > 1e-7, (i + 1, spread)


def test_round_leaves_input_state_unless_donated(banks):
    _, tb = banks
    state = port_state(jopt.adamw(5e-3))
    before = [t.clone() for t in tree_leaves(
        {k: state[k] for k in ("adapters_c", "opt", "step")})]
    out, _ = hfsl.make_hfsl_round(TCFG, topt.adamw(5e-3), M.classify_loss,
                                  steps=2)(state, tb.arrays, 0)
    after = tree_leaves({k: state[k] for k in ("adapters_c", "opt", "step")})
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    donated, _ = hfsl.make_hfsl_round(TCFG, topt.adamw(5e-3),
                                      M.classify_loss, steps=2,
                                      donate=True)(state, tb.arrays, 0)
    assert donated["adapters_c"]["head"]["w"] is state["adapters_c"]["head"]["w"]
    for a, b in zip(tree_leaves(out["adapters_c"]),
                    tree_leaves(donated["adapters_c"])):
        assert torch.equal(a, b)
    assert donated["backbone"] is state["backbone"]


def test_cpu_round_launches_no_kernel_and_counts_telemetry(banks):
    _, tb = banks
    tel = telemetry.enable()
    ops.reset_launch_counts()
    hfsl.make_hfsl_round(TCFG, topt.sgd(0.1), M.classify_loss, steps=2)(
        port_state(jopt.sgd(0.1)), tb.arrays, 0)
    snap = tel.snapshot()
    telemetry.disable()
    assert all(v == 0 for v in ops.launch_counts().values())
    assert snap["counters"]["hfsl.rounds"] == 1
    assert snap["counters"]["hfsl.steps"] == 2
    assert "hfsl.faulted_rounds" not in snap["counters"]


def test_unported_round_options_raise():
    """The mesh round is ported for every family: it needs the state spec
    (as the reference's), a recurrent family's round is made like the
    dense one's (its rounds are ``tests/test_torch_mesh_train.py``'s), and
    ``rules`` and ``state_spec`` alone change nothing."""
    with pytest.raises(ValueError, match="requires state_spec"):
        hfsl.make_hfsl_round(TCFG, topt.sgd(0.1), M.classify_loss, steps=1,
                             mesh=object())
    ssm = get_config("falcon-mamba-7b").reduced()
    assert callable(hfsl.make_hfsl_round(ssm, topt.sgd(0.1), M.lm_loss,
                                         steps=1, mesh=object(),
                                         state_spec={}))
    for kw in ({"rules": {}}, {"state_spec": {}}):
        assert callable(hfsl.make_hfsl_round(TCFG, topt.sgd(0.1),
                                             M.classify_loss, steps=1, **kw))


def test_init_state_consensus_and_sync_bytes():
    opt = topt.adamw(1e-3)
    st = hfsl.init_hfsl_state(0, TCFG, N, opt, M.init, device="cpu")
    assert st["opt"]["step"].shape == (N,)
    assert st["opt"]["step"].dtype == torch.int32
    jst = jhfsl.init_hfsl_state(jax.random.PRNGKey(0), JCFG, N,
                                jopt.adamw(1e-3), JM.init)
    back = hfsl_state_to_numpy(st)
    assert jax.tree.map(np.shape, back["adapters_c"]) == \
        jax.tree.map(np.shape, jax.tree.map(np.asarray, jst["adapters_c"]))
    assert jax.tree.map(np.shape, back["opt"]) == \
        jax.tree.map(np.shape, jax.tree.map(np.asarray, jst["opt"]))
    assert hfsl.sync_bytes(st["adapters_c"]) == \
        jhfsl.sync_bytes(jst["adapters_c"])
    cons = hfsl.consensus_params(st)       # mean of identical replicas
    for a, b in zip(tree_leaves(cons["adapters"]),
                    tree_leaves(st["adapters_c"])):
        np.testing.assert_allclose(a.numpy(), b[0].numpy(), rtol=1e-6,
                                   atol=1e-9)


# ---------------------------------------------------------------------------
# PEFT helpers and the state bridge
# ---------------------------------------------------------------------------

def test_merge_lora_and_trainable_fraction_match_jax():
    tree = jax.tree.map(np.asarray, JM.init(JCFG, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(1)
    for t in tree["adapters"]["stack"]["g0"]["s0"]["lora"].values():
        t["b"] = (0.05 * rng.standard_normal(t["b"].shape)).astype(
            np.float32)
    params = from_jax(tree)
    assert peft.trainable_fraction(params) == pytest.approx(
        jpeft.trainable_fraction(tree), rel=1e-12)
    assert peft.tree_bytes(params["adapters"]) == \
        jpeft.tree_bytes(tree["adapters"])
    want = jax.tree.map(np.asarray, jpeft.merge_lora_into_backbone(
        jax.tree.map(jnp.asarray, tree), JCFG))
    got = peft.merge_lora_into_backbone(params, TCFG)
    for a, b in zip(tree_leaves(from_jax(want)), tree_leaves(got)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6)
    # the input params are unchanged and merged classify equals unmerged
    assert not all(bool((t["b"] == 0).all()) for t in
                   params["adapters"]["stack"]["g0"][0]["s0"]["lora"]
                   .values())
    batch = {"tokens": torch.ones((2, 8), dtype=torch.int32)}
    np.testing.assert_allclose(M.classify(got, batch, TCFG).numpy(),
                               M.classify(params, batch, TCFG).numpy(),
                               atol=2e-4, rtol=2e-4)


def test_peft_value_and_grad_grads_only_the_trainable_subtree():
    params = M.init(TCFG, 0, device="cpu")
    batch = {"tokens": torch.randint(0, 64, (2, 8)),
             "label": torch.tensor([0, 3])}
    (loss, aux), g = peft.peft_value_and_grad(
        lambda p, b: M.classify_loss(p, b, TCFG))(params, batch)
    assert set(g) == {"adapters"} and "acc" in aux
    assert not any(t.requires_grad for t in tree_leaves(params))
    assert len(tree_leaves(g)) == len(tree_leaves(params["adapters"]))
    (loss_all, _), g_all = peft.peft_value_and_grad(
        lambda p, b: M.classify_loss(p, b, TCFG), "all")(params, batch)
    assert set(g_all) == {"adapters", "backbone"}
    assert torch.equal(loss, loss_all)
    wq = g_all["backbone"]["layers"]["g0"][0]["s0"]["attn"]["wq"]
    assert wq.shape == params["backbone"]["layers"]["g0"][0]["s0"]["attn"][
        "wq"].shape and float(wq.abs().sum()) > 0


@pytest.mark.parametrize("opt_name", ["adamw", "sgd_momentum", "sgd"])
def test_hfsl_state_bridge_round_trips(opt_name):
    jo = {"adamw": jopt.adamw(1e-3), "sgd": jopt.sgd(0.1),
          "sgd_momentum": jopt.sgd(0.1, momentum=0.9)}[opt_name]
    tree = jax_state(jo)
    state = hfsl_state_from_jax(tree, "cpu")
    lora = state["adapters_c"]["stack"]["g0"][1]["s0"]["lora"]["q"]["b"]
    assert lora.shape == (N, *tree["adapters_c"]["stack"]["g0"]["s0"][
        "lora"]["q"]["b"].shape[2:]) and lora.is_contiguous()
    np.testing.assert_array_equal(
        lora.numpy(), tree["adapters_c"]["stack"]["g0"]["s0"]["lora"]["q"][
            "b"][:, 1])
    back = hfsl_state_to_numpy(state)
    assert jax.tree.map(np.shape, back) == jax.tree.map(np.shape, tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["scan", "loop"])
def test_train_cli_runs_on_cpu(impl, capsys):
    state = train.main(["--arch", "vit-edge", "--reduced", "--clusters", "2",
                        "--steps", "4", "--batch", "4", "--seq", "8",
                        "--log-every", "2", "--sync-every", "2",
                        "--impl", impl, "--device", "cpu"])
    assert int(state["step"]) == 4
    assert max_spread(state) < 1e-6                # synced at step 4
    assert "fedavg bytes/sync" in capsys.readouterr().out


def test_train_cli_scan_equals_loop_and_rejects_ckpt(tmp_path):
    """Scan and loop give the same adapters; ``--ckpt`` writes the
    consensus adapters, which load back into the same tree."""
    from repro_torch.checkpoint import io as ckpt_io
    args = ["--arch", "vit-edge", "--reduced", "--task", "lm", "--clusters",
            "2", "--steps", "2", "--batch", "2", "--seq", "8",
            "--log-every", "2", "--device", "cpu"]
    a = train.main(args + ["--impl", "scan"])
    b = train.main(args + ["--impl", "loop",
                           "--ckpt", str(tmp_path / "ad.npz")])
    for x, y in zip(tree_leaves(a["adapters_c"]), tree_leaves(b["adapters_c"])):
        assert torch.equal(x, y)
    params = hfsl.consensus_params(b)
    back = ckpt_io.load_adapters(str(tmp_path / "ad.npz"), params)
    for x, y in zip(tree_leaves(back["adapters"]),
                    tree_leaves(params["adapters"])):
        assert torch.equal(x, y)
