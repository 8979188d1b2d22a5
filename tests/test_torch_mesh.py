"""The port's device-mesh layer (``repro_torch/sharding``,
``launch/mesh.py``) against the JAX package's, on the CPU.

Two layers, as in the reference's ``tests/test_mesh_sharding.py``:

- in process: the rule sets equal the reference's dict for dict;
  ``_resolve`` and ``fit_spec`` give the reference's ``PartitionSpec`` over
  a table of logical-axis tuples, shapes and mesh shapes (the reference's
  functions read only ``axis_names`` and ``shape``, so a stand-in mesh
  serves); ``placements`` turns each into the DTensor list; every
  ``ParamSpec`` of every config carries the reference's axes; the
  ``ParamSpec`` and too-few-devices ``ValueError``s;
- one module fixture: 4 rank subprocesses (``torch.distributed``, gloo)
  form a 2x2 (`data`, `model`) mesh and run the reference script's
  workload: reduced vit-edge in f32 with vocab 64, a 4-domain slot-sharded
  bank, the 8 ragged requests, a 4-step HFSL round (4 clusters, batch 4,
  ``sync_every=2``), train-to-serve and the runtime wiring. The JAX
  package's unsharded results are computed once in this process and the
  weights reach the ranks through an ``.npz`` and
  ``checkpoint/from_jax.py``; the ranks also run the unsharded port.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs.base import get_config as jax_config
from repro.configs.base import list_configs
from repro.core import hfsl as jhfsl
from repro.core.adapter_bank import AdapterBank as JaxBank
from repro.data.noniid import partition_by_classes
from repro.data.pipeline import BatchBank as JaxBatchBank
from repro.data.synthetic import ClassificationTask
from repro.launch.engine import DecodeEngine as JaxEngine
from repro.models import model as JM
from repro.optim.optimizers import adamw as jadamw
from repro.sharding import rules as JR
from repro_torch.configs.base import get_config
from repro_torch.models import model as M
from repro_torch.models.params import ParamSpec, tree_paths
from repro_torch.sharding import rules as R

REPO = Path(__file__).resolve().parents[1]
ADAM_TOL = dict(atol=1e-4, rtol=1e-4)          # test_torch_hfsl.py's
RANKS = 4
DOMS = ["d0", "d1", "d2", "d3"]
C, BATCH, STEPS = 4, 4, 4


# ---------------------------------------------------------------------------
# Rule sets, specs and placements (in process)
# ---------------------------------------------------------------------------

RULE_SETS = ["DEFAULT_RULES", "long_decode_rules", "moe_serving_rules",
             "serving_rules", "drafter_rules", "train_rules:dense",
             "train_rules:ssm", "train_rules:hybrid",
             "hfsl_round_rules:dense", "hfsl_round_rules:ssm"]


def _rules(mod, name):
    fn, _, arg = name.partition(":")
    obj = getattr(mod, fn)
    return obj if isinstance(obj, dict) else (obj(arg) if arg else obj())


@pytest.mark.parametrize("name", RULE_SETS)
def test_rule_sets_equal_the_reference(name):
    assert _rules(R, name) == _rules(JR, name)


def test_serving_rules_shape():
    r = R.serving_rules()
    assert r["batch"] == ("pod", "data")      # wave batch over data
    assert r["heads"] == "model"              # TP attention
    assert r["kv_seq"] is None                # per-row writes stay local
    assert r["slots"] == ("pod", "data")      # bank slot parallelism


def test_hfsl_round_rules_disable_sequence_parallelism():
    r = R.hfsl_round_rules("dense")
    assert r["seq"] is None and r["cluster"] == ("pod", "data")
    assert R.hfsl_round_rules("ssm")["batch"] == "model"


class StandIn:
    """What the reference's ``_resolve`` / ``fit_spec`` read of a mesh
    (``axis_names``, ``shape``), and what the port's read of a
    ``DeviceMesh`` (``mesh_dim_names``, ``shape``)."""

    def __init__(self, shape, names):
        self.axis_names = self.mesh_dim_names = tuple(names)
        self.shape = dict(zip(names, shape))


MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# (logical axes, shape): weights, activations and caches of the dense path
CASES = [
    (("fsdp", "heads"), (3584, 3584)),
    (("fsdp", "kv_heads"), (3584, 512)),
    (("heads", "fsdp"), (3584, 3584)),
    (("vocab", "fsdp"), (152064, 3584)),
    (("fsdp", "d_ff"), (3584, 18944)),
    (("d_ff", "fsdp"), (18944, 3584)),
    (("prefix", "kv_heads", "head_dim"), (16, 4, 128)),
    (("fsdp", "lora_rank"), (3584, 8)),
    (("lora_rank", None), (8, 3584)),
    (("cluster", "prefix", "kv_heads", "head_dim"), (4, 16, 4, 128)),
    (("cluster", None, "lora_rank"), (3, 3584, 8)),
    (("batch", "seq", "d_model"), (8, 512, 3584)),
    (("batch", "attn_seq", "heads", "head_dim"), (8, 512, 28, 128)),
    (("batch", "attn_seq", "kv_heads", "head_dim"), (8, 512, 4, 128)),
    ((None, "batch", "kv_seq", "kv_heads", "head_dim"), (28, 8, 640, 4, 128)),
    (("batch", "seq", "vocab"), (8, 1, 152064)),
    (("batch", "seq", "heads"), (1, 1, 28)),
    (("seq", "heads"), (512, 32)),
    (("slots",), (3,)),
    (("d_model",), (3584,)),
]


def _ref_spec(axes, shape, mesh, rules):
    return tuple(JR.fit_spec(JR._resolve(axes, rules, mesh), shape, mesh))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("rules_name", ["DEFAULT_RULES", "serving_rules",
                                        "hfsl_round_rules:dense",
                                        "long_decode_rules"])
def test_resolve_and_fit_spec_equal_the_reference(mesh_name, rules_name):
    mesh = StandIn(*MESHES[mesh_name])
    rules, jrules = _rules(R, rules_name), _rules(JR, rules_name)
    for axes, shape in CASES:
        assert tuple(R._resolve(axes, rules, mesh)) == \
            tuple(JR._resolve(axes, jrules, mesh)), axes
        assert tuple(R.fit_spec(R._resolve(axes, rules, mesh), shape,
                                mesh)) == \
            _ref_spec(axes, shape, mesh, jrules), (axes, shape)


AXIS_NAMES = sorted(R.DEFAULT_RULES) + [None]


@settings(max_examples=150, deadline=None)
@given(axes=st.lists(st.sampled_from(AXIS_NAMES), min_size=1, max_size=5),
       dims=st.lists(st.sampled_from([1, 2, 3, 4, 6, 16, 32, 48, 512]),
                     min_size=5, max_size=5),
       mesh_name=st.sampled_from(list(MESHES)))
def test_fit_spec_equals_the_reference_on_drawn_axes(axes, dims, mesh_name):
    mesh = StandIn(*MESHES[mesh_name])
    shape = tuple(dims[:len(axes)])
    got = R.fit_spec(R._resolve(axes, R.DEFAULT_RULES, mesh), shape, mesh)
    assert tuple(got) == _ref_spec(axes, shape, mesh, JR.DEFAULT_RULES)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_placements_follow_the_spec(mesh_name):
    from torch.distributed.tensor import Replicate, Shard
    mesh = StandIn(*MESHES[mesh_name])
    names = mesh.mesh_dim_names
    for axes, shape in CASES:
        spec = R.fit_spec(R._resolve(axes, R.serving_rules(), mesh), shape,
                          mesh)
        want = [Replicate()] * len(names)
        for i, e in enumerate(spec):
            for a in ((e,) if isinstance(e, str) else (e or ())):
                want[names.index(a)] = Shard(i)
        assert R.placements(spec, mesh) == want, (axes, spec)
    # the tuple entry ('pod', 'data') splits one dim over two mesh dims
    if "pod" in names:
        assert R.placements(R.P(("pod", "data")), mesh) == \
            [Shard(0), Shard(0), Replicate()]


def test_dim_sharding_divisibility_fallback():
    mesh = StandIn(*MESHES["2x2"])
    assert R.dim_sharding(mesh, 4, "slots", index=1) == R.P(None, "data")
    assert R.dim_sharding(mesh, 3, "slots", index=1) == R.P()
    assert R.dim_sharding(mesh, 4, "nonexistent") == R.P()


@pytest.mark.parametrize("arch", list_configs())
def test_param_axes_equal_the_reference(arch):
    """Every leaf of the port's spec carries the reference's logical axes
    (a per-layer leaf: the reference's stacked leaf's axes after its
    leading layer dim); the spec's bytes are the reference's."""
    assert R.param_bytes(M.model_spec(get_config(arch))) == \
        JR.param_bytes(JM.model_spec(jax_config(arch)))
    mesh = StandIn(*MESHES["2x16x16"])
    assert tuple(R.spec_for(("batch", "heads"), mesh)) == \
        tuple(JR.spec_for(("batch", "heads"), mesh))
    js, ts = JM.model_spec(jax_config(arch)), M.model_spec(get_config(arch))
    for path, s in tree_paths(ts):
        node, stacked = js, False
        for k in path:
            if isinstance(k, int):
                stacked = True
                continue
            node = node[k]
        want = node.axes[1:] if stacked else node.axes
        assert tuple(s.axes) == tuple(want), (arch, path)


def test_param_spec_mismatch_raises_value_error():
    with pytest.raises(ValueError, match="logical axis per dim"):
        ParamSpec((4, 4), axes=("batch",))
    ParamSpec((4, 4), axes=("batch", None))
    ParamSpec((4, 4))


def test_mesh_too_few_devices_raises_value_error():
    from repro_torch.launch.mesh import _mesh
    with pytest.raises(ValueError, match="need 262144 devices, have"):
        _mesh((512, 512), ("data", "model"), device="cpu")


def test_shard_is_the_identity_without_a_mesh():
    import torch
    x = torch.arange(6.0).reshape(2, 3)
    assert R.shard(x, "batch", "d_model") is x
    with R.use_rules(None, R.serving_rules()):
        assert R.shard(x, "batch", "d_model") is x


# ---------------------------------------------------------------------------
# The 2x2 gloo mesh against the JAX package (one module fixture)
# ---------------------------------------------------------------------------

def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _requests(cfg):
    key = jax.random.PRNGKey(5)
    short = np.asarray(jax.random.randint(key, (4, 8), 0, cfg.vocab_size))
    long = np.asarray(jax.random.randint(key, (4, 12), 0, cfg.vocab_size))
    return [(short[0], "d0", 4), (long[0], "d1", 3), (short[1], "d2", 5),
            (long[1], "d3", 4), (short[2], "d0", 2), (long[2], "d1", 6),
            (short[3], "d2", 3), (long[3], "d3", 4)]


def _jax_side(path):
    """The reference's workload, unsharded, in JAX; its weights and data
    go to ``path`` (.npz) for the ranks. Returns the JAX results."""
    cfg = jax_config("vit-edge").reduced().with_(dtype="float32",
                                                 vocab_size=64)
    ks = jax.random.split(jax.random.PRNGKey(0), len(DOMS) + 1)
    adapters = {d: M_jax_adapters(cfg, ks[i]) for i, d in enumerate(DOMS)}
    backbone = JM.init(cfg, ks[-1])["backbone"]
    reqs = _requests(cfg)
    bank = JaxBank.create(adapters)
    eng = JaxEngine(cfg, slots=4, bank=bank)
    uids = [eng.submit(t, g, domain=d) for t, d, g in reqs]
    comps, _ = eng.run(bank.serving_params(backbone))
    by = {c.uid: c.tokens for c in comps}
    drain = [np.asarray(by[u]).tolist() for u in uids]

    opt = jadamw(5e-3)
    task = ClassificationTask(5, 64, 24, class_strength=0.6, seed=0)
    data = task.dataset(40 * C, seed=11)
    parts = partition_by_classes(data["label"], C, cfg.peft.head_dim_out,
                                 seed=1)
    state0 = jhfsl.init_hfsl_state(jax.random.PRNGKey(3), cfg, C, opt,
                                   JM.init)
    bb = JaxBatchBank.pack(data, parts, BATCH, seed=2)
    rnd = jhfsl.make_hfsl_round(cfg, opt, JM.classify_loss, steps=STEPS,
                                sync_every=2)
    su, mu = rnd(state0, bb.arrays, 0)
    cons = jhfsl.consensus_params({"backbone": backbone,
                                   "adapters_c": su["adapters_c"]})
    bank.publish("d1", cons["adapters"])
    p = np.asarray(jax.random.randint(jax.random.PRNGKey(5), (2, 9), 0,
                                      cfg.vocab_size))
    t2s, _ = JaxEngine(cfg, slots=2, bank=bank).serve(
        bank.serving_params(backbone), p, gen=4, domains=["d1", "d1"])

    arrays = {}
    arrays.update(_flatten(jax.tree.map(np.asarray, backbone), "backbone/"))
    for d in DOMS:
        arrays.update(_flatten(jax.tree.map(np.asarray, adapters[d]),
                               f"adapters/{d}/"))
    arrays.update(_flatten(jax.tree.map(np.asarray, state0), "state0/"))
    arrays.update(_flatten({k: np.asarray(v) for k, v in bb.arrays.items()},
                           "bank/"))
    for i, (t, d, g) in enumerate(reqs):
        arrays[f"req/{i}"] = np.asarray(t)
    arrays["t2s_prompts"] = p
    np.savez(path, **arrays)
    return {"drain": drain, "loss": np.asarray(mu["loss"]),
            "adapters_c": jax.tree.map(np.asarray, su["adapters_c"]),
            "t2s": np.asarray(t2s).tolist(),
            "reqs": [(d, g) for _, d, g in reqs]}


def M_jax_adapters(cfg, key):
    return JM.init(cfg, key)["adapters"]


RANK_SCRIPT = textwrap.dedent('''
    import datetime, json, os, sys
    sys.path.insert(0, os.environ["PORT_SRC"])
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group(
        "gloo", init_method="tcp://localhost:" + os.environ["MASTER_PORT"],
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=240))

    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.checkpoint.from_jax import (from_jax,
                                                 hfsl_state_from_jax)
    from repro_torch.configs.base import get_config
    from repro_torch.core import hfsl
    from repro_torch.core.adapter_bank import AdapterBank
    from repro_torch.core.integrated import GaisNet
    from repro_torch.data.pipeline import BatchBank
    from repro_torch.data.synthetic import ClassificationTask
    from repro_torch.launch.engine import DecodeEngine
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim.optimizers import adamw
    from repro_torch.sharding import rules as R

    def unflatten(z, prefix):
        out = {}
        for k in z.files:
            if not k.startswith(prefix):
                continue
            node, parts = out, k[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[k]
        return out

    z = np.load(os.environ["MESH_NPZ"])
    C, BATCH, STEPS = 4, 4, 4
    DOMS = ["d0", "d1", "d2", "d3"]
    res = {}
    mesh = make_test_mesh(2, 2, device="cpu")
    cfg = get_config("vit-edge").reduced().with_(dtype="float32",
                                                 vocab_size=64)
    backbone = from_jax({"backbone": unflatten(z, "backbone/")})["backbone"]
    adapters = {d: from_jax(unflatten(z, "adapters/" + d + "/"))
                for d in DOMS}
    doms = json.loads(os.environ["MESH_REQS"])
    reqs = [(z["req/%d" % i], d, g) for i, (d, g) in enumerate(doms)]

    def drain(bank, bb, mesh_):
        eng = DecodeEngine(cfg, slots=4, bank=bank, mesh=mesh_, device="cpu")
        uids = [eng.submit(t, g, domain=d) for t, d, g in reqs]
        comps, stats = eng.run(bank.serving_params(bb))
        by = {c.uid: c.tokens.tolist() for c in comps}
        return [by[u] for u in uids], stats

    # --- mixed-domain ragged drain, unsharded and on the mesh
    bank_u = AdapterBank.create(adapters)
    res["drain_port"], _ = drain(bank_u, backbone, None)
    bank_s = AdapterBank.create(adapters, mesh=mesh)
    bb_s = M.place_params({"backbone": backbone}, cfg, mesh)["backbone"]
    res["drain_mesh"], stats = drain(bank_s, bb_s, mesh)
    res["drain_requests"] = stats.requests
    stack_leaf = tree_leaves(bank_s.stacked["stack"])[0]
    res["bank_stack_placements"] = repr(tuple(stack_leaf.placements))
    res["bank_head_placements"] = repr(tuple(
        bank_s.stacked["head"]["w"].placements))
    wq = bb_s["layers"]["g0"][0]["s0"]["attn"]["wq"]
    res["wq_placements"] = repr(tuple(wq.placements))

    # --- the K-step HFSL round, unsharded and on the mesh
    opt = adamw(5e-3)
    state0 = hfsl_state_from_jax(unflatten(z, "state0/"), "cpu")
    arrays = {k: torch.from_numpy(np.asarray(v))
              for k, v in unflatten(z, "bank/").items()}
    rows = [{k: v[i] for k, v in arrays.items()} for i in range(STEPS)]
    round_u = hfsl.make_hfsl_round(cfg, opt, M.classify_loss, steps=STEPS,
                                   sync_every=2)
    su, mu = round_u(state0, arrays, 0)
    rules = R.hfsl_round_rules(cfg.family)
    spec = hfsl.hfsl_state_spec(cfg, C, opt, M.model_spec)
    sh = hfsl.hfsl_state_shardings(cfg, C, opt, M.model_spec, mesh, rules)
    state_s = R.distribute_tree(state0, sh, mesh)
    bank_st = BatchBank.from_iterator(iter(rows), STEPS, mesh=mesh,
                                      rules=rules, device="cpu")
    res["batch_bank_placements"] = sorted({
        repr(tuple(v.placements)) for v in bank_st.arrays.values()})
    round_s = hfsl.make_hfsl_round(cfg, opt, M.classify_loss, steps=STEPS,
                                   sync_every=2, mesh=mesh, rules=rules,
                                   state_spec=spec, donate=True)
    ss, ms = round_s(state_s, bank_st.arrays, 0)
    res["loss_port"] = mu["loss"].tolist()
    res["loss_mesh"] = ms["loss"].tolist()
    res["round_step"] = int(ss["step"].full_tensor())
    a_leaf = tree_leaves(ss["adapters_c"])[0]
    res["adapters_c_placements"] = repr(tuple(a_leaf.placements))
    # a faulted round (a dropped and a corrupted cluster), both ways
    fault = dict(mask=np.array([1, 0, 1, 1], np.float32),
                 corrupt=np.array([0, 0, 1, 0], bool))
    rf_u = hfsl.make_hfsl_round(cfg, opt, M.classify_loss, steps=2,
                                sync_every=2)
    rf_s = hfsl.make_hfsl_round(cfg, opt, M.classify_loss, steps=2,
                                sync_every=2, mesh=mesh, rules=rules,
                                state_spec=spec)
    _, fu = rf_u(state0, arrays, 0, **fault)
    _, fs = rf_s(R.distribute_tree(state0, sh, mesh), bank_st.arrays, 0,
                 **fault)
    res["faulted"] = {k: [fu[k].tolist(), fs[k].tolist()]
                      for k in ("loss", "skipped", "dropped")}

    import repro_torch.models.params as P
    mesh_c = P.tree_map(lambda x: x.full_tensor(), ss["adapters_c"])
    if rank == 0:
        np.savez(os.environ["MESH_OUT"] + ".npz",
                 **{"mesh/" + "/".join(map(str, p)): x.numpy()
                    for p, x in P.tree_paths(mesh_c)},
                 **{"port/" + "/".join(map(str, p)): x.numpy()
                    for p, x in P.tree_paths(su["adapters_c"])})

    # --- train-to-serve: publish the round's consensus, serve it
    cons_s = hfsl.consensus_params({"backbone": bb_s,
                                    "adapters_c": ss["adapters_c"]})
    cons_u = hfsl.consensus_params({"backbone": backbone,
                                    "adapters_c": su["adapters_c"]})
    bank_s.publish("d1", cons_s["adapters"])
    bank_u.publish("d1", cons_u["adapters"])
    res["bank_stack_placements_after_publish"] = repr(tuple(
        tree_leaves(bank_s.stacked["stack"])[0].placements))
    p = z["t2s_prompts"]
    got, _ = DecodeEngine(cfg, slots=2, bank=bank_s, mesh=mesh,
                          device="cpu").serve(bank_s.serving_params(bb_s), p,
                                              gen=4, domains=["d1", "d1"])
    want, _ = DecodeEngine(cfg, slots=2, bank=bank_u, device="cpu").serve(
        bank_u.serving_params(backbone), p, gen=4, domains=["d1", "d1"])
    res["t2s_mesh"], res["t2s_port"] = np.asarray(got).tolist(), \\
        np.asarray(want).tolist()

    # --- GaisNet(mesh=...): the runtime wires both sides itself
    import dataclasses
    icfg = cfg.with_(peft=dataclasses.replace(cfg.peft, head_dim_out=5))
    tasks = {n: ClassificationTask(5, 64, 24, class_strength=0.6, seed=s)
             for n, s in [("nlp", 0), ("cv", 7)]}
    rt = GaisNet(icfg, tasks, mesh=mesh, n_clusters=2, steps_per_upgrade=2,
                 serve_batch=4, serve_gen=3, serve_slots=4, seed=0,
                 device="cpu")
    res["rt_bank"] = repr(tuple(
        tree_leaves(rt.bank.stacked["stack"])[0].placements))
    res["rt_batch_bank"] = repr(tuple(rt._banks["cv"].arrays["tokens"]
                                      .placements))
    res["rt_adapters_c"] = repr(tuple(
        tree_leaves(rt.domains["nlp"].adapters_c)[0].placements))
    profit, cost = rt.produce(["nlp", "cv"])
    res["rt_produce"] = [profit, cost.tokens, rt.profit_scale]
    v0 = rt.bank.version("nlp")
    rt.upgrade("nlp")
    res["rt_version_step"] = rt.bank.version("nlp") - v0
    res["rt_adapters_c_after"] = repr(tuple(
        tree_leaves(rt.domains["nlp"].adapters_c)[0].placements))
    profit2, cost2 = rt.produce("nlp")
    res["rt_produce2"] = [profit2, cost2.tokens]
    with open(os.environ["MESH_OUT"] + ".%d.json" % rank, "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
''')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    want = _jax_side(tmp / "weights.npz")
    script = tmp / "rank.py"
    script.write_text(RANK_SCRIPT)
    out = str(tmp / "out")
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_"))}
    env.update(PORT_SRC=str(REPO / "src"), MESH_NPZ=str(tmp / "weights.npz"),
               MESH_OUT=out, MASTER_ADDR="localhost", MASTER_PORT=port,
               WORLD_SIZE=str(RANKS), OMP_NUM_THREADS="1",
               MESH_REQS=json.dumps(want["reqs"]))
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(RANKS)]
    procs = [subprocess.Popen([sys.executable, str(script)],
                              env={**env, "RANK": str(r)}, cwd=str(tmp),
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(RANKS)]
    try:
        rcs = [p.wait(timeout=400) for p in procs]
    finally:
        for p in procs:                  # a failed or hung rank takes all
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    tails = "\n".join((tmp / f"rank{r}.log").read_text()[-3000:]
                      for r in range(RANKS))
    assert rcs == [0] * RANKS, tails
    got = [json.loads(Path(f"{out}.{r}.json").read_text())
           for r in range(RANKS)]
    with np.load(out + ".npz") as z:
        adapters = {k: z[k] for k in z.files}
    return want, got, adapters


def test_mesh_drain_equals_jax(mesh_run):
    want, got, _ = mesh_run
    for res in got:                      # every rank returns every request
        assert res["drain_mesh"] == want["drain"]
        assert res["drain_port"] == want["drain"]
        assert res["drain_requests"] == len(want["drain"])


def test_mesh_placements(mesh_run):
    _, got, _ = mesh_run
    r = got[0]
    # the port's per-layer stack leaf is (n_slots, ...): its slot dim (the
    # reference's dim 1 of (L, n_slots, ...)) on `data`
    assert r["bank_stack_placements"] == "(Shard(dim=0), Replicate())"
    assert r["bank_stack_placements_after_publish"] == \
        r["bank_stack_placements"]
    assert r["bank_head_placements"].startswith("(Shard(dim=0),")
    assert r["wq_placements"] == "(Shard(dim=0), Shard(dim=1))"
    assert r["batch_bank_placements"] == ["(Shard(dim=1), Replicate())"]
    assert r["adapters_c_placements"].startswith("(Shard(dim=0),")


def test_mesh_round_equals_jax(mesh_run):
    want, got, adapters = mesh_run
    for res in got:
        np.testing.assert_allclose(res["loss_mesh"], want["loss"],
                                   **ADAM_TOL)
        np.testing.assert_allclose(res["loss_mesh"], res["loss_port"],
                                   rtol=2e-5, atol=1e-6)
        assert res["round_step"] == STEPS
        loss_u, loss_s = res["faulted"]["loss"]
        np.testing.assert_allclose(loss_s, loss_u, rtol=2e-5, atol=1e-6)
        assert res["faulted"]["skipped"][0] == res["faulted"]["skipped"][1]
        assert res["faulted"]["dropped"] == [[1, 1], [1, 1]]
    from repro_torch.checkpoint.from_jax import _swap_stack
    ref = _flatten(_swap_stack(want["adapters_c"],
                               lambda a: np.swapaxes(a, 0, 1)))
    n = 0
    for key, mesh_leaf in adapters.items():
        if not key.startswith("mesh/"):
            continue
        path = key[len("mesh/"):].split("/")
        port_leaf = adapters["port/" + "/".join(path)]
        np.testing.assert_allclose(mesh_leaf, port_leaf, rtol=1e-3,
                                   atol=3e-5)
        # the reference's (n, L, ...) leaf, swapped to (L, n, ...) -> the
        # per-layer (n, ...) leaf at the port's layer index
        if "stack" in path:
            i = path.index("stack") + 2
            ref_leaf = ref["/".join(path[:i] + path[i + 1:])][int(path[i])]
        else:
            ref_leaf = ref["/".join(path)]
        np.testing.assert_allclose(mesh_leaf, ref_leaf, **ADAM_TOL)
        n += 1
    assert n >= 5


def test_mesh_train_to_serve_equals_jax(mesh_run):
    want, got, _ = mesh_run
    for res in got:
        assert res["t2s_mesh"] == want["t2s"]
        assert res["t2s_port"] == want["t2s"]


def test_gaisnet_mesh_wiring(mesh_run):
    _, got, _ = mesh_run
    for res in got:
        assert res["rt_bank"] == "(Shard(dim=0), Replicate())"
        assert res["rt_batch_bank"] == "(Shard(dim=1), Replicate())"
        assert res["rt_adapters_c"].startswith("(Shard(dim=0),")
        assert res["rt_adapters_c_after"] == res["rt_adapters_c"]
        profit, tokens, scale = res["rt_produce"]
        assert 0.0 <= profit <= scale and tokens == 4 * 3
        assert res["rt_version_step"] == 1
        assert 0.0 <= res["rt_produce2"][0] <= scale
    # every rank took the same actions and saw the same results
    assert all(r["rt_produce"] == got[0]["rt_produce"] for r in got)
