"""The port's knowledge relay and int8 adapter transport against the JAX
package, on the CPU.

Both packages get the same adapters (numpy trees from the reference's
``init`` plus seeded perturbations, bridged with
``checkpoint/from_jax.py``) and run the same sequence: deliver to two
domains, ``edge_deliver(d0, 4)``, absorb four cluster trees, aggregate.
Under each fault plan the ledgers, the RoundCosts and the telemetry
counters must be equal, and the final edges and cloud within 1e-6 of the
reference's. Reduced vit-edge in f32 and reduced qwen2-7b in bf16, whose
stacked bf16 leaves are what the wire checksums and the int8 scales see.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.configs.base import get_config as jax_config
from repro.core import faults as jfaults
from repro.core import relay as jrelay
from repro.core import telemetry as jtel
from repro.models import model as JM
from repro_torch.checkpoint import io as tio
from repro_torch.checkpoint.from_jax import from_jax
from repro_torch.configs.base import get_config
from repro_torch.core import faults, relay, telemetry
from repro_torch.core.adapter_bank import AdapterBank
from repro_torch.models import model as M
from repro_torch.models.params import tree_leaves, tree_map

DOMAINS = ["d0", "d1"]
N_CLUSTERS = 4
PLANS = {
    "none": lambda f: None,
    "no_faults": lambda f: f.NO_FAULTS,
    "link_loss": lambda f: f.FaultPlan(seed=3, link_loss=0.5),
    "corrupt": lambda f: f.FaultPlan(seed=4, payload_corrupt=0.6),
    "both": lambda f: f.FaultPlan(seed=5, link_loss=0.5,
                                  payload_corrupt=0.6),
}


def _cfgs(arch, dtype):
    def one(get):
        cfg = get(arch).reduced().with_(dtype=dtype, vocab_size=64)
        return cfg.with_(peft=dataclasses.replace(cfg.peft, head_dim_out=5))
    return one(jax_config), one(get_config)


def _perturb(tree, rng, s):
    return jax.tree.map(
        lambda x: (x.astype(np.float32)
                   + s * rng.standard_normal(x.shape).astype(np.float32)
                   ).astype(x.dtype), tree)


@pytest.fixture(scope="module", params=[("vit-edge", "float32"),
                                        ("qwen2-7b", "bfloat16")],
                ids=["vit-edge-f32", "qwen2-7b-bf16"])
def trees(request):
    """(cloud, [cluster trees]) as numpy trees in the reference's layout,
    and the configs."""
    jcfg, tcfg = _cfgs(*request.param)
    cloud = jax.tree.map(np.asarray,
                         JM.init(jcfg, jax.random.PRNGKey(0))["adapters"])
    rng = np.random.default_rng(1)
    cloud = _perturb(cloud, rng, 0.05)       # LoRA b inits to zeros
    ups = [_perturb(cloud, rng, 0.1) for _ in range(N_CLUSTERS)]
    return jcfg, tcfg, cloud, ups


def _port(tree):
    return from_jax({"adapters": tree})["adapters"]


def _run(mod, cloud, ups, plan, tel):
    tel.enable()
    try:
        r = mod.KnowledgeRelay(cloud, DOMAINS, faults=plan, max_retries=50,
                               backoff_s=0.01, backoff_cap_s=0.05)
        for d in DOMAINS:
            r.cloud_deliver(d)
        r.edge_deliver("d0", N_CLUSTERS)
        r.edge_absorb("d0", ups)
        r.cloud_aggregate()
        snap = tel.get().snapshot()
    finally:
        tel.disable()
    return r, snap


def _close(port_tree, ref_tree, atol):
    want = _port(jax.tree.map(np.asarray, ref_tree))
    for g, w in zip(tree_leaves(port_tree), tree_leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.allclose(g.float(), w.float(), atol=atol, rtol=0), \
            (g.float() - w.float()).abs().max().item()


@pytest.mark.parametrize("plan", list(PLANS))
def test_ledger_cost_and_counters_match_jax(trees, plan):
    _, _, cloud, ups = trees
    jr, jsnap = _run(jrelay, jax.tree.map(jnp.asarray, cloud),
                     [jax.tree.map(jnp.asarray, u) for u in ups],
                     PLANS[plan](jfaults), jtel)
    tr, tsnap = _run(relay, _port(cloud), [_port(u) for u in ups],
                     PLANS[plan](faults), telemetry)
    assert dataclasses.asdict(tr.ledger) == dataclasses.asdict(jr.ledger)
    assert dataclasses.asdict(tr.cost) == dataclasses.asdict(jr.cost)
    assert tsnap["counters"] == jsnap["counters"]
    assert tsnap["histograms"].keys() == jsnap["histograms"].keys()
    assert tr.edge_versions == jr.edge_versions
    assert tr.cloud_version == jr.cloud_version
    if plan in ("link_loss", "corrupt", "both"):
        assert tr.ledger.retries > 0
    if plan in ("corrupt", "both"):
        # a corrupted leaf is re-sent alone: some retransmit is smaller
        # than the whole tree
        assert tsnap["counters"]["relay.corrupt_leaves"] > 0
    for d in DOMAINS:
        _close(tr.edges[d], jr.edges[d], 1e-6)
    _close(tr.cloud, jr.cloud, 1e-6)


def test_wire_leaf_checksums_match_jax(trees):
    _, _, cloud, _ = trees
    got = faults.leaf_checksums(tree_leaves(tio.wire_tree(_port(cloud))))
    want = jfaults.leaf_checksums(jax.tree.map(jnp.asarray, cloud))
    assert got == want
    leaves = tree_leaves(tio.wire_tree(_port(cloud)))
    assert [tuple(x.shape) for x in leaves] == \
        [x.shape for x in jax.tree.leaves(cloud)]


def test_faulted_relay_equals_clean_relay_bit_for_bit(trees):
    _, _, cloud, ups = trees
    clean, _ = _run(relay, _port(cloud), [_port(u) for u in ups], None,
                    telemetry)
    lossy, _ = _run(relay, _port(cloud), [_port(u) for u in ups],
                    PLANS["both"](faults), telemetry)
    assert lossy.ledger.total() == clean.ledger.total() + \
        lossy.ledger.retransmit_bytes
    for a, b in zip(tree_leaves([lossy.cloud, lossy.edges]),
                    tree_leaves([clean.cloud, clean.edges])):
        assert torch.equal(a, b)


def test_exhausted_retry_budget_raises():
    r = relay.KnowledgeRelay({"w": torch.arange(8.0).reshape(2, 4)}, ["a"],
                             faults=faults.FaultPlan(seed=0, link_loss=0.99),
                             max_retries=2, backoff_s=0.0)
    with pytest.raises(relay.RelayTransferError, match="giving up"):
        for _ in range(50):
            r.cloud_deliver("a")


@pytest.fixture(scope="module")
def bank_setup():
    _, tcfg = _cfgs("vit-edge", "float32")
    adapters = {d: M.init(tcfg, i, device="cpu")["adapters"]
                for i, d in enumerate(["nlp", "vision", "speech"])}
    return adapters


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def test_relay_routes_through_bank(bank_setup):
    """tests/test_adapter_bank.py::test_relay_routes_through_bank on the
    port: attach seeds every slot, absorb and deliver publish, the relay's
    versions stay the logical ones."""
    adapters = bank_setup
    doms = list(adapters)
    bank = AdapterBank.create(adapters)
    r = relay.KnowledgeRelay(adapters["nlp"], doms, bank=bank)
    for d in doms:
        assert _equal(bank.snapshot(d), r.edges[d])
        assert bank.version(d) == 1              # the attach-time seed
    ups = [tree_map(lambda x: x + 1.0, adapters["nlp"]),
           tree_map(lambda x: x + 3.0, adapters["nlp"])]
    agg = r.edge_absorb("vision", ups)
    assert r.edge_versions["vision"] == 1
    assert bank.version("vision") == 2
    assert _equal(bank.snapshot("vision"), agg)
    nb0 = r.ledger.total()
    r.cloud_deliver("speech")
    assert r.ledger.total() > nb0
    assert bank.version("speech") == 2
    assert _equal(bank.snapshot("speech"), r.cloud)


def test_missing_bank_slot_raises(bank_setup):
    bank = AdapterBank.create({"nlp": bank_setup["nlp"]})
    with pytest.raises(KeyError, match="no slot"):
        relay.KnowledgeRelay(bank_setup["nlp"], ["nlp", "vision"],
                             bank=bank)


def test_delivered_tree_does_not_alias_the_cloud(bank_setup):
    cloud = bank_setup["nlp"]
    before = tree_map(torch.clone, cloud)
    r = relay.KnowledgeRelay(cloud, ["a", "b"])
    got = r.cloud_deliver("a")
    for x in tree_leaves(got):
        x.add_(1.0)                      # an in-place step on the edge
    assert _equal(r.cloud, before)
    assert _equal(r.edges["b"], before)
    assert _equal(cloud, before)
    for x in tree_leaves(r.edges["b"]):
        x.mul_(0.0)
    assert _equal(r.cloud, before)


# each public method of the relay that hands back an adapter tree, called
# on a relay of three domains attached to a bank
RETURNS_A_TREE = {
    "cloud_deliver": lambda r, ups: r.cloud_deliver("vision"),
    "edge_deliver": lambda r, ups: r.edge_deliver("vision", 3),
    "edge_absorb": lambda r, ups: r.edge_absorb("vision", ups),
    "cloud_aggregate": lambda r, ups: r.cloud_aggregate(),
}


@pytest.mark.parametrize("plan", ["none", "both"])
@pytest.mark.parametrize("method", sorted(RETURNS_A_TREE))
def test_returned_tree_does_not_alias_the_relay(bank_setup, method, plan):
    """An in-place step on the tree a relay method returns leaves the
    relay's edges and cloud, its versions and the bank's slots as they
    were, with and without a lossy link."""
    adapters = bank_setup
    doms = list(adapters)
    bank = AdapterBank.create(adapters)
    r = relay.KnowledgeRelay(adapters["nlp"], doms, bank=bank,
                             faults=PLANS[plan](faults), max_retries=64)
    ups = [tree_map(lambda x: x + 1.0, adapters["nlp"]),
           tree_map(lambda x: x + 3.0, adapters["nlp"])]
    got = RETURNS_A_TREE[method](r, ups)
    edges = {d: tree_map(torch.clone, e) for d, e in r.edges.items()}
    cloud = tree_map(torch.clone, r.cloud)
    versions = (dict(r.edge_versions), r.cloud_version,
                {d: bank.version(d) for d in doms})
    slots = {d: bank.snapshot(d) for d in doms}
    returned = tree_map(torch.clone, got)
    for x in tree_leaves(got):
        x.add_(1.0)
    assert all(_equal(r.edges[d], edges[d]) for d in doms)
    assert _equal(r.cloud, cloud)
    assert versions == (dict(r.edge_versions), r.cloud_version,
                        {d: bank.version(d) for d in doms})
    assert all(_equal(bank.snapshot(d), slots[d]) for d in doms)
    # and the tree was the relay's result before the step
    want = r.cloud if method == "cloud_aggregate" else r.edges["vision"]
    assert _equal(returned, want)


# ---------------------------------------------------------------------------
# int8 adapter transport
# ---------------------------------------------------------------------------

def test_quantized_arrays_bit_equal_to_jax(trees, tmp_path):
    _, _, cloud, _ = trees
    jio.save_adapters_quantized(str(tmp_path / "j"),
                                {"adapters": jax.tree.map(jnp.asarray,
                                                          cloud)})
    tio.save_adapters_quantized(str(tmp_path / "t"),
                                {"adapters": _port(cloud)})
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            assert j[k].dtype == t[k].dtype and j[k].shape == t[k].shape, k
            assert np.array_equal(j[k], t[k]), k


def test_quantized_files_cross_load(trees, tmp_path):
    _, _, cloud, _ = trees
    jp = {"adapters": jax.tree.map(jnp.asarray, cloud)}
    tp = {"adapters": _port(cloud)}
    jio.save_adapters_quantized(str(tmp_path / "j"), jp)
    tio.save_adapters_quantized(str(tmp_path / "t"), tp)
    for f in ("j", "t"):
        want = jio.load_adapters_quantized(str(tmp_path / f), jp)
        got = tio.load_adapters_quantized(str(tmp_path / f), tp)
        _close(got["adapters"], want["adapters"], 0.0)
    # each package reads the other's file as it reads its own
    _close(tio.load_adapters_quantized(str(tmp_path / "j"), tp)["adapters"],
           jio.load_adapters_quantized(str(tmp_path / "t"), jp)["adapters"],
           0.0)


def test_quantized_smaller_than_fp(tmp_path):
    _, tcfg = _cfgs("vit-edge", "float32")
    params = M.init(tcfg, 0, device="cpu")
    fp = tio.save_adapters(str(tmp_path / "fp"), params)
    q8 = tio.save_adapters_quantized(str(tmp_path / "q8"), params)
    assert q8 < fp * 0.6, (q8, fp)


def test_quantized_roundtrip_preserves_predictions(tmp_path):
    """tests/test_quantized_transport.py on the port: each element within
    one int8 step of its row's scale, and classify's argmax agreement at
    least 0.75."""
    _, tcfg = _cfgs("vit-edge", "float32")
    params = M.init(tcfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    params["adapters"] = tree_map(
        lambda x: x + 0.05 * torch.randn(x.shape, generator=gen),
        params["adapters"])
    p = str(tmp_path / "q8")
    tio.save_adapters_quantized(p, params)
    restored = tio.load_adapters_quantized(p, params)
    for a, b in zip(tree_leaves(params["adapters"]),
                    tree_leaves(restored["adapters"])):
        step = a.abs().max().item() / 127.0 + 1e-12
        assert (a - b).abs().max().item() <= step + 1e-6
    toks = torch.randint(0, tcfg.vocab_size, (8, 16), generator=gen)
    la = M.classify(params, {"tokens": toks}, tcfg)
    lb = M.classify(restored, {"tokens": toks}, tcfg)
    agree = (la.argmax(-1) == lb.argmax(-1)).float().mean().item()
    assert agree >= 0.75, agree
