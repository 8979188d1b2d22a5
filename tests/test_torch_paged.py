"""The port's paged serving slice against the JAX package, on the CPU: the
paged decode kernel's plain version, the block allocator, and paged drains
(single-tenant and from an AdapterBank) from bridged weights.

Held:

- the plain ``flash_decode_paged`` against ``repro.kernels.ref
  .paged_decode_attention`` and the Pallas kernel in interpret mode (the
  case list of tests/test_kernels.py, f32 2e-5, bf16 2e-2), with a prefix
  bank against the reference's ``ops.flash_decode_paged(backend="xla")``,
  and bit for bit against the port's dense plain path in f32;
- ``block_hashes`` and the allocator step for step against the
  reference's, and the allocator's random walk conserves the pool;
- paged drains give the JAX paged drains' tokens and pool statistics in
  the scenarios of tests/test_ragged.py (refill, same-drain sharing,
  sharing across drains, ``serve_trace`` with SLA classes, the
  rejections), and equal the port's dense drains and solo generation.

Weights: reduced qwen2-7b in f32 (vocab 64), LoRA ``b`` made nonzero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.core import paged as jpaged
from repro.core.adapter_bank import AdapterBank as JaxBank
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch.engine import DecodeEngine as JaxEngine
from repro.models import model as JM
from repro_torch.checkpoint.from_jax import from_jax
from repro_torch.configs.base import get_config
from repro_torch.core import paged
from repro_torch.core.adapter_bank import AdapterBank
from repro_torch.core.paged import BlockAllocator, PagedSpec
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops, ref
from repro_torch.launch.engine import DecodeEngine
from repro_torch.models import model as M

TOL = {np.float32: dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return TOL[np.float32] if dtype == "float32" else TOL["bfloat16"]


# ---------------------------------------------------------------------------
# the kernel's plain version
# ---------------------------------------------------------------------------

def paged_operands(B, maxb, bs, Hq, Hkv, D, n_p=0, per_row=False, seed=0):
    """numpy f32 operands: a pool, per-row tables of distinct blocks (one
    row's tail set to the n_blocks sentinel), ragged q_pos, a prefix."""
    rng = np.random.default_rng(seed)
    nb = maxb * B + 3
    ops_ = dict(q=rng.standard_normal((B, Hq, D)),
                k_pool=rng.standard_normal((nb, bs, Hkv, D)),
                v_pool=rng.standard_normal((nb, bs, Hkv, D)))
    table = np.stack([rng.choice(nb, maxb, replace=False)
                      for _ in range(B)]).astype(np.int32)
    q_pos = np.asarray([(maxb * bs - 1 - 3 * i) % (maxb * bs)
                        for i in range(B)], np.int32)
    table[-1, q_pos[-1] // bs + 1:] = nb         # unwritten: sentinel
    if n_p:
        shape = (B, n_p, Hkv, D) if per_row else (n_p, Hkv, D)
        ops_["prefix_k"] = rng.standard_normal(shape)
        ops_["prefix_v"] = rng.standard_normal(shape)
    return ({k: v.astype(np.float32) for k, v in ops_.items()}, table,
            q_pos)


def as_jax(arrs, dtype):
    return {k: jnp.asarray(v, DT[dtype][0]) for k, v in arrs.items()}


def as_torch(arrs, dtype):
    return {k: torch.from_numpy(v).to(DT[dtype][1]) for k, v in arrs.items()}


CASES = [(1, 2, 16, 1, 1, 8), (2, 4, 8, 4, 2, 32), (3, 3, 16, 2, 1, 16)]


@pytest.mark.parametrize("B,maxb,bs,Hq,Hkv,D", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("oracle", ["ref", "interpret"])
def test_plain_paged_decode_matches_the_reference(B, maxb, bs, Hq, Hkv, D,
                                                  dtype, oracle):
    arrs, table, q_pos = paged_operands(B, maxb, bs, Hq, Hkv, D)
    j = as_jax(arrs, dtype)
    if oracle == "ref":
        want = jref.paged_decode_attention(
            j["q"], j["k_pool"], j["v_pool"], jnp.asarray(table),
            q_pos=jnp.asarray(q_pos))
    else:                                          # the Pallas kernel
        want = jops.flash_decode_paged(
            j["q"], j["k_pool"], j["v_pool"], jnp.asarray(table),
            q_pos=jnp.asarray(q_pos), backend="interpret")
    t = as_torch(arrs, dtype)
    got = ops.flash_decode_paged(t["q"], t["k_pool"], t["v_pool"],
                                 torch.from_numpy(table),
                                 q_pos=torch.from_numpy(q_pos))
    assert got.dtype == DT[dtype][1] and fd.paged_launches == 0
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_paged_decode_with_prefix_matches_the_reference(per_row,
                                                              dtype):
    arrs, table, q_pos = paged_operands(3, 4, 8, 4, 2, 32, n_p=5,
                                        per_row=per_row, seed=1)
    j, t = as_jax(arrs, dtype), as_torch(arrs, dtype)
    want = jops.flash_decode_paged(
        j["q"], j["k_pool"], j["v_pool"], jnp.asarray(table),
        q_pos=jnp.asarray(q_pos), prefix_k=j["prefix_k"],
        prefix_v=j["prefix_v"], backend="xla")
    got = ops.flash_decode_paged(
        t["q"], t["k_pool"], t["v_pool"], torch.from_numpy(table),
        q_pos=torch.from_numpy(q_pos), prefix_k=t["prefix_k"],
        prefix_v=t["prefix_v"])
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))
    # the port's own naive oracle agrees too
    oracle = ref.paged_decode_attention(
        t["q"], t["k_pool"], t["v_pool"], torch.from_numpy(table),
        q_pos=torch.from_numpy(q_pos), prefix_k=t["prefix_k"],
        prefix_v=t["prefix_v"])
    np.testing.assert_allclose(got.float().numpy(), oracle.float().numpy(),
                               **_tol(dtype))


@pytest.mark.parametrize("n_p,per_row", [(0, False), (6, False), (6, True)])
def test_paged_plain_path_equals_dense_plain_path_bitwise(n_p, per_row):
    """f32: the pool gathered through the table and run through the dense
    path (what a dense drain computes) gives the same bits."""
    arrs, table, q_pos = paged_operands(2, 4, 8, 4, 2, 32, n_p=n_p,
                                        per_row=per_row, seed=2)
    t = as_torch(arrs, "float32")
    pk, pv = t.get("prefix_k"), t.get("prefix_v")
    paged_out = ops.flash_decode_paged(
        t["q"], t["k_pool"], t["v_pool"], torch.from_numpy(table),
        q_pos=torch.from_numpy(q_pos), prefix_k=pk, prefix_v=pv)
    k, v = fd.gather_pool(t["k_pool"], t["v_pool"], torch.from_numpy(table))
    dense = ops.flash_decode(t["q"], k, v, q_pos=torch.from_numpy(q_pos),
                             kv_pos=torch.arange(k.shape[1]), prefix_k=pk,
                             prefix_v=pv)
    assert torch.equal(paged_out, dense)


def test_paged_write_drops_without_an_extra_block():
    """A dropped write (keep false) leaves the pool as it was, whatever
    slot its index names, and the kept writes land."""
    pool = torch.arange(2 * 4 * 1 * 2, dtype=torch.float32).reshape(2, 4, 1,
                                                                    2)
    before = pool.clone()
    from repro_torch.models.attention import paged_write
    new = torch.full((3, 1, 2), -1.0)
    paged_write(pool, torch.tensor([1, 0, 9]), torch.tensor([2, 1, 3]), new,
                torch.tensor([False, True, False]))
    want = before.clone()
    want[0, 1] = -1.0
    assert torch.equal(pool, want)
    paged_write(pool, torch.tensor([1, 1]), torch.tensor([0, 3]),
                torch.full((2, 1, 2), 5.0), torch.tensor([False, False]))
    assert torch.equal(pool, want)


# ---------------------------------------------------------------------------
# the allocator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bs", [1, 4, 16])
def test_block_hashes_equal_the_reference(bs):
    rng = np.random.default_rng(bs)
    for n in (0, bs - 1, bs, 3 * bs + 2, 50):
        toks = rng.integers(0, 152064, max(n, 0)).astype(np.int32)
        assert paged.block_hashes(toks, bs) == jpaged.block_hashes(toks, bs)


def test_paged_spec_validates_like_the_reference():
    for kw in (dict(block_size=12), dict(block_size=0), dict(n_blocks=0)):
        with pytest.raises(ValueError):
            jpaged.PagedSpec(**kw)
        with pytest.raises(ValueError):
            PagedSpec(**kw)


def test_allocator_walk_matches_the_reference_and_conserves_the_pool():
    """A seeded alloc / free / acquire / register / match walk on both
    allocators: the same returns and books at every step; the pool is
    conserved, refcounts never go negative, a double free raises."""
    rng = np.random.default_rng(5)
    mine, theirs = BlockAllocator(24, 4), jpaged.BlockAllocator(24, 4)
    prompts = [rng.integers(0, 64, int(n)).astype(np.int32)
               for n in rng.integers(4, 20, 6)]
    live: list[list[int]] = []
    for _ in range(400):
        op = int(rng.integers(5))
        if op == 0:
            n = int(rng.integers(1, 5))
            got = mine.alloc(n)
            assert got == theirs.alloc(n)
            if got is not None:
                live.append(got)
        elif op == 1 and live:
            ids = live.pop(int(rng.integers(len(live))))
            mine.free(ids)
            theirs.free(ids)
        elif op == 2 and live:
            bid = live[int(rng.integers(len(live)))][0]
            for a in (mine, theirs):
                a.acquire(bid)
                a.free([bid])
        elif op == 3 and live:
            p = prompts[int(rng.integers(len(prompts)))]
            ids = live[int(rng.integers(len(live)))]
            mine.register(p, ids)
            theirs.register(p, ids)
        elif op == 4:
            p = prompts[int(rng.integers(len(prompts)))]
            assert mine.match_prefix(p) == theirs.match_prefix(p)
        assert mine.refcount == theirs.refcount
        assert list(mine._free) == list(theirs._free)
        assert mine.free_blocks + mine.used_blocks == 24
        mine.check()
    for attr in ("allocated", "freed", "shared_acquires", "hash_hits"):
        assert getattr(mine, attr) == getattr(theirs, attr)
    ids = live.pop() if live else mine.alloc(2)
    mine.free(ids)
    with pytest.raises(RuntimeError):
        mine.free(ids)


# ---------------------------------------------------------------------------
# paged drains against the JAX engine
# ---------------------------------------------------------------------------

STATS = ["requests", "waves", "segments", "tokens", "padded_tokens",
         "pool_block_size", "pool_peak_blocks", "pool_blocks_alloc",
         "cache_tokens", "prefix_hits", "prefix_hit_tokens"]


def _cfgs():
    kw = dict(dtype="float32", vocab_size=64)
    return (jax_config("qwen2-7b").reduced().with_(**kw),
            get_config("qwen2-7b").reduced().with_(**kw))


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs()
    tree = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(4)))
    rng = np.random.default_rng(4)
    for t in tree["adapters"]["stack"]["g0"]["s0"]["lora"].values():
        t["b"] = (0.1 * rng.standard_normal(t["b"].shape)).astype(np.float32)
    return dict(jcfg=jcfg, tcfg=tcfg, tree=tree,
                jparams=jax.tree.map(jnp.asarray, tree),
                tparams=from_jax(tree))


def ragged(n=7, seed=3):
    rng = np.random.default_rng(seed)
    lens = [5, 9, 12, 7, 10, 3, 6][:n]
    gens = [4, 2, 6, 3, 5, 7, 1][:n]
    return [rng.integers(0, 64, l).astype(np.int32) for l in lens], gens


def prefix_rows(bs, n_hits=2, prefix_blocks=2, seed=11):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 64, prefix_blocks * bs).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(0, 64, 3).astype(np.int32)])
            for _ in range(1 + n_hits)]


def both_drain(w, rows, gens, *, slots, spec, drains=1):
    """Drain the same queue through a JAX and a port paged engine (a second
    drain per entry of ``drains`` beyond the first re-submits rows[1]).
    Returns [(jax tokens, port tokens, jax stats, port stats)] per drain
    and the two engines."""
    jeng = JaxEngine(w["jcfg"], slots=slots,
                     paged=jpaged.PagedSpec(spec.n_blocks, spec.block_size,
                                            spec.share_prefix))
    teng = DecodeEngine(w["tcfg"], slots=slots, paged=spec, device="cpu")
    out = []
    for d in range(drains):
        batch = (list(zip(rows, gens)) if d == 0 else [(rows[1], gens[1])])
        ju = [jeng.submit(r, g) for r, g in batch]
        tu = [teng.submit(r, g) for r, g in batch]
        jc, js = jeng.run(w["jparams"])
        tc, ts = teng.run(w["tparams"])
        jb, tb = {c.uid: c.tokens for c in jc}, {c.uid: c.tokens for c in tc}
        out.append(([jb[u] for u in ju], [tb[u] for u in tu], js, ts))
    return out, jeng, teng


def assert_same(drains):
    for jt, tt, js, ts in drains:
        for a, b in zip(jt, tt):
            np.testing.assert_array_equal(b, a)
        for f in STATS:
            assert getattr(ts, f) == getattr(js, f), f


@pytest.fixture(scope="module")
def refill_drain(weights):
    rows, gens = ragged()
    drains, _, teng = both_drain(weights, rows, gens, slots=3,
                                 spec=PagedSpec(n_blocks=32, block_size=8))
    return rows, gens, drains, teng


def test_paged_refill_drain_matches_jax(refill_drain):
    rows, gens, drains, teng = refill_drain
    assert_same(drains)
    assert drains[0][3].waves > 1                 # in-wave refill happened
    assert teng._alloc.used_blocks == 0
    teng._alloc.check()


def test_paged_drain_equals_dense_drain_and_solo(weights, refill_drain):
    rows, gens, drains, _ = refill_drain
    dense = DecodeEngine(weights["tcfg"], slots=3, device="cpu")
    uids = [dense.submit(r, g) for r, g in zip(rows, gens)]
    comps, _ = dense.run(weights["tparams"])
    by = {c.uid: c.tokens for c in comps}
    for i, (r, g) in enumerate(zip(rows, gens)):
        np.testing.assert_array_equal(drains[0][1][i], by[uids[i]])
        solo = M.generate(weights["tparams"], weights["tcfg"],
                          torch.from_numpy(r)[None], gen=g)[0].numpy()
        np.testing.assert_array_equal(drains[0][1][i], solo)


def test_paged_prefix_sharing_in_one_drain_matches_jax(weights):
    bs = 4
    rows = prefix_rows(bs)
    drains, jeng, teng = both_drain(
        weights, rows, [3] * len(rows), slots=4,
        spec=PagedSpec(n_blocks=32, block_size=bs, share_prefix=True))
    assert_same(drains)
    ts = drains[0][3]
    assert ts.prefix_hits == 2 and ts.prefix_hit_tokens == 2 * 2 * bs
    for attr in ("allocated", "shared_acquires", "hash_hits"):
        assert getattr(teng._alloc, attr) == getattr(jeng._alloc, attr)
    assert teng._alloc.used_blocks == 0
    teng._alloc.check()


def test_paged_prefix_sharing_across_drains_and_refill_matches_jax(weights):
    bs = 4
    rows = prefix_rows(bs)
    drains, jeng, teng = both_drain(
        weights, rows, [3] * len(rows), slots=2,
        spec=PagedSpec(n_blocks=32, block_size=bs, share_prefix=True),
        drains=2)
    assert_same(drains)
    assert drains[0][3].prefix_hits == 2          # refill-path admissions
    assert drains[1][3].prefix_hits == 1          # revived off the free list
    assert teng._alloc.used_blocks == 0
    teng._alloc.check()


def test_paged_serve_trace_matches_jax_and_solo(weights):
    rows, gens = ragged(n=3)
    trace = [(0.00, rows[0], gens[0], {"sla": "gold"}),
             (0.01, rows[1], gens[1], {"sla": "best_effort"}),
             (0.02, rows[2], gens[2])]
    jeng = JaxEngine(weights["jcfg"], slots=2,
                     paged=jpaged.PagedSpec(n_blocks=32, block_size=8))
    teng = DecodeEngine(weights["tcfg"], slots=2, device="cpu",
                        paged=PagedSpec(n_blocks=32, block_size=8))
    jc, js = jeng.serve_trace(weights["jparams"], trace)
    tc, ts = teng.serve_trace(weights["tparams"], trace)
    assert ts.requests == js.requests == 3
    jb, tb = {c.uid: c.tokens for c in jc}, {c.uid: c.tokens for c in tc}
    for uid, (_, r, g, *_) in zip(sorted(tb), trace):
        np.testing.assert_array_equal(tb[uid], jb[uid])
        solo = M.generate(weights["tparams"], weights["tcfg"],
                          torch.from_numpy(r)[None], gen=g)[0].numpy()
        np.testing.assert_array_equal(tb[uid], solo)
    assert set(ts.sla_stats) == set(js.sla_stats) == {"gold",
                                                      "best_effort"}
    assert ts.sla_stats["gold"]["requests"] == 1
    assert ts.sla_stats["gold"]["deadline_miss"] == 0


def test_dense_serve_trace_admits_by_arrival(weights):
    rows, gens = ragged(n=3)
    trace = [(0.0, rows[0], gens[0]), (0.03, rows[1], gens[1]),
             (0.0, rows[2], gens[2], {"sla": "gold"})]
    eng = DecodeEngine(weights["tcfg"], slots=2, device="cpu")
    comps, stats = eng.serve_trace(weights["tparams"], trace)
    assert stats.requests == 3 and eng.pending() == 0
    # submission follows the arrival order: uids 0, 1, 2 are rows 0, 2, 1
    by = {c.uid: c.tokens for c in comps}
    for uid, i in ((0, 0), (1, 2), (2, 1)):
        solo = M.generate(weights["tparams"], weights["tcfg"],
                          torch.from_numpy(rows[i])[None],
                          gen=gens[i])[0].numpy()
        np.testing.assert_array_equal(by[uid], solo)
    assert stats.sla_stats["gold"]["requests"] == 1


class _FakeSpec:
    def validate_target(self, cfg):
        pass


@pytest.mark.parametrize("case", ["spec", "share_prefix", "too_big"])
def test_paged_engine_rejects_what_the_reference_rejects(weights, case):
    jcfg, tcfg = weights["jcfg"], weights["tcfg"]
    if case == "spec":
        with pytest.raises(ValueError, match="paged serving composes"):
            JaxEngine(jcfg, slots=2, spec=_FakeSpec(),
                      paged=jpaged.PagedSpec(n_blocks=8, block_size=4))
        with pytest.raises(ValueError, match="paged serving composes"):
            DecodeEngine(tcfg, slots=2, spec=_FakeSpec(), device="cpu",
                         paged=PagedSpec(n_blocks=8, block_size=4))
    elif case == "share_prefix":                  # no full-window layer
        kw = dict(attn_variant="sliding", sliding_window=8)
        with pytest.raises(ValueError, match="fully paged stack"):
            JaxEngine(jcfg.with_(**kw), slots=2,
                      paged=jpaged.PagedSpec(8, 4, share_prefix=True))
        with pytest.raises(ValueError, match="fully paged stack"):
            DecodeEngine(tcfg.with_(**kw), slots=2, device="cpu",
                         paged=PagedSpec(8, 4, share_prefix=True))
    else:
        for eng in (JaxEngine(jcfg, slots=2,
                              paged=jpaged.PagedSpec(4, 4)),
                    DecodeEngine(tcfg, slots=2, device="cpu",
                                 paged=PagedSpec(4, 4))):
            with pytest.raises(ValueError, match="could never be admitted"):
                eng.submit(np.arange(15, dtype=np.int32) % 64, 8)


def test_paged_bank_drain_matches_jax_bank_drain(weights):
    """A mixed-domain paged drain with prefix sharing from an AdapterBank:
    the JAX bank drain's tokens and pool statistics."""
    jcfg, tcfg, tree = weights["jcfg"], weights["tcfg"], weights["tree"]
    doms = ["nlp", "vision", "speech"]
    adapters = {}
    for i, d in enumerate(doms):
        a = jax.tree.map(np.asarray,
                         JM.init(jcfg, jax.random.PRNGKey(10 + i))["adapters"])
        rng = np.random.default_rng(10 + i)
        for t in a["stack"]["g0"]["s0"]["lora"].values():
            t["b"] = (0.1 * rng.standard_normal(t["b"].shape)).astype(
                np.float32)
        adapters[d] = a
    jbank = JaxBank.create({d: jax.tree.map(jnp.asarray, a)
                            for d, a in adapters.items()})
    tbank = AdapterBank.create({d: from_jax(a) for d, a in adapters.items()})
    bs = 4
    # each domain's requests share that domain's own prompt prefix (the
    # block hash names tokens only, so a prefix is shared within a domain)
    rows = (prefix_rows(bs, n_hits=2, seed=11)
            + prefix_rows(bs, n_hits=1, seed=21) + ragged(n=3, seed=7)[0])
    gens = [3, 2, 4, 1, 3, 2, 5, 3]
    who = ["vision"] * 3 + ["nlp"] * 2 + ["speech", "nlp", "vision"]
    spec = PagedSpec(n_blocks=48, block_size=bs, share_prefix=True)
    jeng = JaxEngine(jcfg, slots=3, bank=jbank,
                     paged=jpaged.PagedSpec(48, bs, True))
    teng = DecodeEngine(tcfg, slots=3, bank=tbank, paged=spec, device="cpu")
    ju = [jeng.submit(r, g, domain=d) for r, g, d in zip(rows, gens, who)]
    tu = [teng.submit(r, g, domain=d) for r, g, d in zip(rows, gens, who)]
    jc, js = jeng.run(jbank.serving_params(
        jax.tree.map(jnp.asarray, tree["backbone"])))
    tc, ts = teng.run(tbank.serving_params(
        from_jax({"backbone": tree["backbone"]})["backbone"]))
    jb, tb = {c.uid: c.tokens for c in jc}, {c.uid: c.tokens for c in tc}
    for a, b in zip(ju, tu):
        np.testing.assert_array_equal(tb[b], jb[a])
    for f in STATS:
        assert getattr(ts, f) == getattr(js, f), f
    assert ts.prefix_hits > 0
    teng._alloc.check()
