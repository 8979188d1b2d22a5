"""The paper's integrated loop in the port (``core/integrated.py`` with the
modules it runs on: scheduler, comm, faults, checkpoint io) against the
JAX package, on the CPU.

A port ``IntegratedRuntime(paged=...)`` takes a JAX runtime's state
through ``checkpoint/from_jax.py::integrated_from_jax`` and both run one
demand (reduced vit-edge in f32, vocab 64, a 5-class head, 2 domains,
3 steps per upgrade, 8 requests per produce round). Held: the same
actions, the same integer ``RoundCost`` fields and flops, accuracy within
one eval example (1/150; a produce round's profit within one served row,
100/8), and adapters within 1e-4 (AdamW; tests/test_torch_hfsl.py). The
same with a ``FaultPlan``, whose schedules equal the reference's bit for
bit. ``save`` / ``restore`` resume step for step; the scheduler's
policies, the cost model and the checkpoint files are held on their own.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.configs.base import get_config as jax_config
from repro.core import comm as jcomm
from repro.core import faults as jfaults
from repro.core import scheduler as jsched
from repro.core.integrated import IntegratedRuntime as JaxRuntime
from repro.core.paged import PagedSpec as JaxPagedSpec
from repro.data.synthetic import ClassificationTask as JaxTask
from repro_torch.checkpoint import io
from repro_torch.checkpoint.from_jax import (hfsl_state_to_numpy,
                                             integrated_from_jax)
from repro_torch.configs.base import get_config
from repro_torch.core import comm, faults, scheduler
from repro_torch.core.integrated import GaisNet, IntegratedRuntime
from repro_torch.core.paged import PagedSpec
from repro_torch.data.synthetic import ClassificationTask
from repro_torch.launch import train
from repro_torch.models.params import tree_leaves, tree_map, tree_paths

DEMAND = ["nlp", "cv", "nlp", "nlp", "cv", "nlp"]
RT_KW = dict(n_clusters=2, steps_per_upgrade=3, serve_batch=8, seed=0,
             upgrade_cost=10.0)
INT_FIELDS = ["tokens", "padded_tokens", "examples", "comm_bytes",
              "memory_bytes", "dropped_clusters", "skipped_updates",
              "timed_out"]
FAULTS = dict(seed=3, dropout=0.4, grad_nan=0.3)


def _cfg(get):
    cfg = get("vit-edge").reduced().with_(dtype="float32", vocab_size=64)
    return cfg.with_(peft=dataclasses.replace(cfg.peft, head_dim_out=5))


def _tasks(Task):
    return {"nlp": Task(5, 64, 48, class_strength=0.6, seed=0),
            "cv": Task(5, 64, 48, class_strength=0.6, seed=7)}


def port_runtime(**kw):
    return IntegratedRuntime(_cfg(get_config), _tasks(ClassificationTask),
                             device="cpu", **{**RT_KW, **kw})


def jax_tree(jrt) -> dict:
    """A JAX runtime's state as numpy leaves, the bridge's input."""
    doms = {n: {"adapters_c": d.adapters_c, "opt": d.opt_state,
                "step": d.step, "level": d.level,
                "offset": jrt._banks[n].offset,
                "bank_version": jrt.versions_of(n)}
            for n, d in jrt.domains.items()}
    return jax.tree.map(np.asarray, {"backbone": jrt.backbone,
                                     "domains": doms})


def run_pair(policy=None, faults_kw=None):
    """A JAX runtime and a port runtime bridged from it, both run on
    DEMAND. Returns (jax runtime, port runtime, jax records, port
    records)."""
    jkw, tkw = {}, {}
    if faults_kw is not None:
        jkw["faults"] = jfaults.FaultPlan(**faults_kw)
        tkw["faults"] = faults.FaultPlan(**faults_kw)
    jrt = JaxRuntime(_cfg(jax_config), _tasks(JaxTask), **RT_KW,
                     paged=JaxPagedSpec(n_blocks=64, block_size=16), **jkw)
    trt = port_runtime(paged=PagedSpec(n_blocks=64, block_size=16), **tkw)
    integrated_from_jax(trt, jax_tree(jrt))
    for n in trt.domains:
        assert abs(trt.domains[n].accuracy - jrt.domains[n].accuracy) \
            <= 1 / 150 + 1e-6
    jrec = jrt.run(DEMAND, policy=policy)
    trec = trt.run(DEMAND, policy=policy)
    return jrt, trt, jrec, trec


@pytest.fixture(scope="module")
def pair():
    return run_pair()


@pytest.fixture(scope="module")
def faulted_pair():
    # upgrade nlp twice, cv once, then serve: every round draws schedules
    plan = {0: 0, 1: 1, 2: 0}
    return run_pair(policy=lambda r, levels: plan.get(r, 2),
                    faults_kw=FAULTS)


def check_records(jrec, trec):
    assert [(r.action, r.domain) for r in trec] == \
        [(r.action, r.domain) for r in jrec]
    for j, t in zip(jrec, trec):
        for f in INT_FIELDS:
            assert getattr(t.cost, f) == getattr(j.cost, f), (t.round, f)
        assert t.cost.compute_flops == j.cost.compute_flops
        assert abs(t.accuracy - j.accuracy) <= 1 / 150 + 1e-6
        if t.action == "produce":
            assert abs(t.profit - j.profit) <= 100 / 8 + 1e-6
        else:
            assert t.profit == j.profit
        assert t.cost.latency_s > 0


def check_state(jrt, trt):
    for n, d in trt.domains.items():
        jd = jrt.domains[n]
        assert d.level == jd.level and int(d.step) == int(jd.step)
        assert trt.versions_of(n) == jrt.versions_of(n)
        assert trt._banks[n].offset == jrt._banks[n].offset
        back = hfsl_state_to_numpy({"backbone": {}, "adapters_c":
                                    d.adapters_c, "opt": d.opt_state,
                                    "step": d.step})
        want = jax.tree.map(np.asarray, {"adapters_c": jd.adapters_c,
                                         "opt": jd.opt_state})
        for key in ("adapters_c", "opt"):
            got, exp = jax.tree.leaves(back[key]), jax.tree.leaves(want[key])
            assert len(got) == len(exp) > 0
            for g, w in zip(got, exp):
                np.testing.assert_allclose(g.astype(np.float32),
                                           w.astype(np.float32), atol=1e-4,
                                           rtol=1e-4)


def test_runtime_runs_the_reference_loop(pair):
    jrt, trt, jrec, trec = pair
    actions = {r.action for r in trec}
    assert actions == {"upgrade", "produce"}
    check_records(jrec, trec)
    assert trt.total_profit() == pytest.approx(sum(r.profit for r in trec))


def test_runtime_state_after_the_loop_matches_jax(pair):
    check_state(pair[0], pair[1])


def test_paged_produce_rounds_serve_through_the_pool(pair):
    trt = pair[1]
    assert trt.engine.paged is not None
    assert trt.engine._alloc.used_blocks == 0
    trt.engine._alloc.check()
    produce = [r for r in pair[3] if r.action == "produce"]
    assert all(r.cost.tokens == 8 * trt.serve_gen for r in produce)


def test_faulted_runtime_matches_jax(faulted_pair):
    jrt, trt, jrec, trec = faulted_pair
    check_records(jrec, trec)
    check_state(jrt, trt)
    ups = [r for r in trec if r.action == "upgrade"]
    assert len(ups) == 3
    assert sum(r.cost.dropped_clusters + r.cost.skipped_updates
               for r in ups) > 0                  # the plan fired
    assert trt._fault_round == jrt._fault_round == 3


@pytest.mark.parametrize("n", [1, 2, 5])
def test_fault_schedules_equal_the_reference(n):
    mine, theirs = faults.FaultPlan(**FAULTS, straggler=0.2, link_loss=0.3,
                                    payload_corrupt=0.2), \
        jfaults.FaultPlan(**FAULTS, straggler=0.2, link_loss=0.3,
                          payload_corrupt=0.2)
    for r in range(12):
        for a, b in zip(mine.participation(r, n), theirs.participation(r, n)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(mine.corrupt_mask(r, n),
                                      theirs.corrupt_mask(r, n))
        for att in range(3):
            assert mine.link_drops(r, att) == theirs.link_drops(r, att)
            assert mine.payload_corrupted(r, att) == \
                theirs.payload_corrupted(r, att)
            assert mine.retry_jitter(r, att) == theirs.retry_jitter(r, att)
    assert not faults.NO_FAULTS.active and mine.active
    with pytest.raises(ValueError):
        faults.FaultPlan(dropout=1.0)


def test_payload_checksums_catch_a_corrupted_delivery():
    tree = {"a": [torch.arange(6, dtype=torch.float32).reshape(2, 3),
                  torch.ones(4, dtype=torch.bfloat16)],
            "b": torch.zeros(3, dtype=torch.int32)}
    plan = faults.FaultPlan(seed=1, payload_corrupt=0.5)
    c0, leaves0 = faults.payload_checksum(tree), faults.leaf_checksums(tree)
    for att in range(4):
        wire = plan.corrupt_payload(tree, 7, att)
        assert faults.payload_checksum(wire) != c0
        diff = [i for i, (x, y) in enumerate(
            zip(faults.leaf_checksums(wire), leaves0)) if x != y]
        assert len(diff) == 1
    assert faults.payload_checksum(tree) == c0     # the sender's tree intact
    # the structure counts: the same leaves under other keys differ
    assert faults.payload_checksum({"c": tree["a"], "b": tree["b"]}) != c0


def test_save_restore_resumes_step_for_step(pair, tmp_path):
    trt = pair[1]
    path = str(tmp_path / "rt.npz")
    nbytes = trt.save(path)
    assert nbytes > 0 and list(tmp_path.iterdir()) == [tmp_path / "rt.npz"]
    fresh = port_runtime(paged=PagedSpec(n_blocks=64, block_size=16))
    fresh.backbone = trt.backbone                  # same-config runtime
    fresh.restore(path)
    for n, d in trt.domains.items():
        f = fresh.domains[n]
        assert (f.level, int(f.step), fresh.versions_of(n),
                fresh._banks[n].offset) == \
            (d.level, int(d.step), trt.versions_of(n), trt._banks[n].offset)
        assert f.accuracy == pytest.approx(d.accuracy, abs=1e-6)   # f32
        # by path: the bridged runtime's dicts keep the reference's key order
        got = dict(tree_paths([f.adapters_c, f.opt_state]))
        want = dict(tree_paths([d.adapters_c, d.opt_state]))
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in got)
    assert fresh._record_base == len(trt.records)
    # one more upgrade on each: the same round, counters continuing
    trt.upgrade("cv")
    fresh.upgrade("cv")
    d, f = trt.domains["cv"], fresh.domains["cv"]
    assert int(f.step) == int(d.step) and f.level == d.level
    assert fresh.versions_of("cv") == trt.versions_of("cv")
    got, want = dict(tree_paths(f.adapters_c)), dict(tree_paths(d.adapters_c))
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_runtime_entry_points():
    """``GaisNet(mesh=...)`` builds on a mesh (1x1 gloo here; the 2x2 mesh
    is ``tests/test_torch_mesh.py``'s) with both sides placed, and serves
    the same as the runtime without one."""
    from torch.distributed.tensor import Shard

    from repro_torch.launch.mesh import single_process_mesh
    assert GaisNet is IntegratedRuntime
    plain = port_runtime(steps_per_upgrade=2)
    with single_process_mesh("cpu") as mesh:
        rt = port_runtime(mesh=mesh, steps_per_upgrade=2)
        assert tree_leaves(rt.bank.stacked)[0].placements[0] == Shard(0)
        assert tree_leaves(rt.domains["nlp"].adapters_c)[0] \
            .placements[0] == Shard(0)
        assert rt._banks["cv"].arrays["tokens"].placements[0] == Shard(1)
        assert {n: d.accuracy for n, d in rt.domains.items()} == \
            {n: d.accuracy for n, d in plain.domains.items()}
        assert rt.produce("nlp")[0] == plain.produce("nlp")[0]


def test_runtime_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IntegratedRuntime(_cfg(get_config), _tasks(ClassificationTask))


# ---------------------------------------------------------------------------
# scheduler, cost model, checkpoint files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["mlcp", "msip", "rs0", "rs3", "vi"])
def test_scheduler_policies_give_the_reference_actions(policy):
    def make(mod):
        env = mod.paper_env()
        if policy == "mlcp":
            return env, mod.mlcp_policy(env)
        if policy == "msip":
            return env, mod.msip_policy(env)
        if policy == "vi":
            return env, mod.mlcp_value_iteration(env, [0.2, 0.1, 0.7])
        return env, mod.rs_policy(env, seed=int(policy[2:]))

    mine = scheduler.run_policy(*make(scheduler))
    theirs = jsched.run_policy(*make(jsched))
    assert [dataclasses.astuple(r) for r in mine] == \
        [dataclasses.astuple(r) for r in theirs]
    assert scheduler.total_profit(mine) == jsched.total_profit(theirs)
    assert dataclasses.asdict(scheduler.paper_env()) == \
        dataclasses.asdict(jsched.paper_env())


def test_cost_model_matches_the_reference():
    kw = dict(latency_s=0.5, compute_flops=3e9, energy_j=0.1, comm_bytes=64,
              memory_bytes=10, tokens=12, padded_tokens=4, examples=3,
              drafted_tokens=5, accepted_tokens=2)
    a, b = comm.RoundCost(**kw), comm.RoundCost(**{**kw, "memory_bytes": 30})
    ja, jb = jcomm.RoundCost(**kw), jcomm.RoundCost(**{**kw,
                                                       "memory_bytes": 30})
    assert [f.name for f in dataclasses.fields(a)] == \
        [f.name for f in dataclasses.fields(ja)]
    for x, y in ((a, ja), (a + b, ja + jb)):
        assert dataclasses.asdict(x) == dataclasses.asdict(y)
        for p in ("tok_per_s", "ex_per_s", "utilization", "acceptance_rate"):
            assert getattr(x, p) == getattr(y, p)
    cm, jcm = comm.CostModel(), jcomm.CostModel()
    for link in ("d2d", "cs", "backhaul"):
        assert dataclasses.asdict(getattr(cm, link)) == \
            dataclasses.asdict(getattr(jcm, link))
        assert dataclasses.asdict(comm.transfer_cost(
            1000, getattr(cm, link))) == dataclasses.asdict(
            jcomm.transfer_cost(1000, getattr(jcm, link)))
    assert not hasattr(comm.CostModel, "tpu")


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"w": [torch.randn(3, 4, generator=g),
                  torch.randn(2, generator=g).to(torch.bfloat16)],
            "step": torch.tensor(7, dtype=torch.int32),
            "head": {"b": torch.zeros(5)}}


def test_checkpoint_round_trips_and_rejects_another_shape(tmp_path):
    tree = _tree()
    path = str(tmp_path / "ck")
    assert io.save(path, tree) > 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ck.npz"]
    back = io.load(path, like=tree)
    for a, b in zip(tree_leaves(back), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    flat = io.load(path)
    assert set(flat) == {"w", "step", "head"} and torch.equal(
        flat["w"]["1"], tree["w"][1])
    wrong = {**tree, "head": {"b": torch.zeros(6)}}
    with pytest.raises(ValueError, match="shape"):
        io.load(path, like=wrong)
    with pytest.raises(KeyError):
        io.load(path, like={**tree, "extra": torch.zeros(1)})
    # the reference's reader takes the port's file (bf16 as raw bits)
    j = jio.load(path)
    np.testing.assert_array_equal(np.asarray(j["w"]["0"]),
                                  tree["w"][0].numpy())
    assert io.tree_bytes(tree) == 12 * 4 + 2 * 2 + 4 + 5 * 4


def test_adapter_checkpoints_and_the_train_cli(tmp_path):
    path = str(tmp_path / "adapters.npz")
    state = train.main(["--arch", "vit-edge", "--reduced", "--clusters", "2",
                        "--steps", "2", "--batch", "2", "--seq", "8",
                        "--log-every", "2", "--device", "cpu",
                        "--ckpt", path])
    from repro_torch.core import hfsl
    params = hfsl.consensus_params(state)
    zeroed = {**params, "adapters": tree_map(torch.zeros_like,
                                             params["adapters"])}
    loaded = io.load_adapters(path, zeroed)
    for a, b in zip(tree_leaves(loaded["adapters"]),
                    tree_leaves(params["adapters"])):
        assert torch.equal(a, b)
    assert io.save_adapters(str(tmp_path / "again"), params) > 0
