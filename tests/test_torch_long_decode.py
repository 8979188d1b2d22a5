"""Batch-1 long decode with the KV cache split over `data`
(``long_decode_rules``) and moe serving with experts on `data`
(``moe_serving_rules``), against the JAX package on the CPU.

- in process: the plain decode's partial mode (``return_lse``): two
  halves of a cache merged by ``flash_decode.combine`` give the whole
  call, a half that sees no key gives ``lse = -inf`` and adds nothing,
  and the whole call equals the reference's ``ops.flash_decode`` (xla);
- one module fixture: the JAX package's decode loops and moe prefills
  computed once in this process without sharding (a mesh changes only
  the order of summation), the weights written to an ``.npz``, and 4
  ``gloo`` rank subprocesses forming a 2x2 (`data`, `model`) mesh, built
  as ``tests/test_torch_mesh_serve.py``'s. Each rank bridges the weights
  (``checkpoint/from_jax.py``) and runs:
  - (a) reduced qwen2-7b, f32, 16 prefix slots, under
    ``long_decode_rules``: (i) a full cache of 32 slots, a 5-token prompt
    and 20 greedy steps (the second `data` shard sees no key at first);
    (ii) ``sliding_window=16`` (8 slots a rank), a 10-token prompt and 24
    steps, the ring wrapping across both shards, also through
    ``generate``;
  - (b) a prefill of reduced granite-moe-1b-a400m under
    ``moe_serving_rules`` (4 experts, 2 a `data` rank, d_model over
    `model`) at the default capacity factor (which drops on the JAX side)
    and at ``capacity_factor=-1``.
Logits within ``LOGIT_TOL`` (``tests/test_torch_mesh_serve.py``'s), the
JAX package's greedy tokens, each rank's cache T / 2 slots, the expert
weights placed and cut as the reference's ``fit_spec`` gives them. Each
rank's log is ``rank<r>.log`` in the fixture's tmp dir.
"""
import dataclasses
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
import torch

from repro.configs.base import get_config as jax_config
from repro.kernels import ops as jops
from repro.models import model as JM
from repro.sharding import rules as JR
from repro_torch.kernels import flash_decode as fd
from repro_torch.sharding import rules as R

REPO = Path(__file__).resolve().parents[1]
RANKS = 4
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
SENT = 10 ** 9

# ---------------------------------------------------------------------------
# the plain version's partial mode
# ---------------------------------------------------------------------------


def _cache(rng, B=3, T=40, Hq=4, Hkv=2, D=16, n_p=4):
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    q_pos = np.array([5, 17, 39][:B], np.int32)
    kv_pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    kv_pos[kv_pos > q_pos[:, None]] = SENT
    pk = rng.standard_normal((n_p, Hkv, D)).astype(np.float32)
    pv = rng.standard_normal((n_p, Hkv, D)).astype(np.float32)
    return q, k, v, q_pos, kv_pos, pk, pv


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("window", [0, 12])
def test_two_halves_merge_to_the_whole_call(window):
    """The prefix bank goes with the first half (it counts once); rows at
    q_pos 5 see nothing of the second half."""
    q, k, v, qp, kp, pk, pv = _t(*_cache(np.random.default_rng(window)))
    whole, lse = fd.flash_decode_torch(q, k, v, q_pos=qp, kv_pos=kp,
                                       window=window, prefix_k=pk,
                                       prefix_v=pv, return_lse=True)
    assert torch.equal(whole, fd.flash_decode_torch(
        q, k, v, q_pos=qp, kv_pos=kp, window=window, prefix_k=pk,
        prefix_v=pv))
    h = k.shape[1] // 2
    a = fd.flash_decode_torch(q, k[:, :h], v[:, :h], q_pos=qp,
                              kv_pos=kp[:, :h], window=window, prefix_k=pk,
                              prefix_v=pv, return_lse=True)
    b = fd.flash_decode_torch(q, k[:, h:], v[:, h:], q_pos=qp,
                              kv_pos=kp[:, h:], window=window,
                              return_lse=True)
    assert torch.isinf(b[1][0]).all() and (b[0][0] == 0).all()
    o, star = fd.combine([a[0], b[0]], [a[1], b[1]])
    torch.testing.assert_close(o, whole, atol=1e-6, rtol=0)
    torch.testing.assert_close(star, lse, atol=1e-6, rtol=0)


def test_a_blind_part_adds_nothing():
    q, k, v, qp, kp, _, _ = _t(*_cache(np.random.default_rng(3)))
    blind = kp.clone().fill_(SENT)
    whole = fd.flash_decode_torch(q, k, v, q_pos=qp, kv_pos=kp,
                                  return_lse=True)
    none = fd.flash_decode_torch(q, k, v, q_pos=qp, kv_pos=blind,
                                 return_lse=True)
    assert torch.isneginf(none[1]).all() and (none[0] == 0).all()
    # without return_lse a blind row averages its keys, as the reference
    avg = fd.flash_decode_torch(q, k, v, q_pos=qp, kv_pos=blind)
    assert (avg != 0).any()
    o, star = fd.combine([whole[0], none[0]], [whole[1], none[1]])
    assert torch.equal(o, whole[0]) and torch.equal(star, whole[1])


def test_the_whole_call_equals_the_reference_xla():
    q, k, v, qp, kp, pk, pv = _cache(np.random.default_rng(5))
    got, _ = fd.flash_decode_torch(*_t(q, k, v), q_pos=torch.from_numpy(qp),
                                   kv_pos=torch.from_numpy(kp),
                                   prefix_k=torch.from_numpy(pk),
                                   prefix_v=torch.from_numpy(pv),
                                   return_lse=True)
    want = jops.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             q_pos=jnp.asarray(qp), kv_pos=jnp.asarray(kp),
                             prefix_k=jnp.asarray(pk),
                             prefix_v=jnp.asarray(pv), backend="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


# ---------------------------------------------------------------------------
# the 2x2 gloo mesh against the JAX package (one module fixture)
# ---------------------------------------------------------------------------

# case -> (arch, config overrides, moe overrides, n_prefix); f32, vocab 64
CASES = {
    "full": ("qwen2-7b", dict(d_model=64, head_dim=16, n_kv_heads=2), {},
             16),
    "sliding": ("qwen2-7b", dict(d_model=64, head_dim=16, n_kv_heads=2,
                                 attn_variant="sliding", sliding_window=16),
                {}, 16),
    "moe": ("granite-moe-1b-a400m", dict(d_model=64, head_dim=16,
                                         n_kv_heads=2),
            {"d_ff_expert": 32}, 4),
}
# decode case -> (cache slots T, prompt length, greedy steps)
DECODE = {"full": (32, 5, 20), "sliding": (16, 10, 24)}


def config(get, case, capacity_factor=None):
    arch, kw, moe, n_p = CASES[case]
    c = get(arch).reduced()
    kw = dict(kw, dtype="float32", vocab_size=64,
              peft=dataclasses.replace(c.peft, n_prefix=n_p))
    if moe or capacity_factor is not None:
        kw["moe"] = dataclasses.replace(c.moe, **moe)
        if capacity_factor is not None:
            kw["moe"] = dataclasses.replace(kw["moe"],
                                            capacity_factor=capacity_factor)
    return c.with_(**kw)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _jax_side(path):
    """Each case's JAX result, unsharded; weights and tokens go to
    ``path`` for the ranks."""
    arrays, want = {}, {}
    for ci, case in enumerate(CASES):
        jcfg = config(jax_config, case)
        rng = np.random.default_rng(ci)
        tree = jax.tree.map(np.array, JM.init(jcfg, jax.random.PRNGKey(ci)))
        tree["adapters"] = jax.tree.map(
            lambda x: x + 0.1 * rng.standard_normal(x.shape).astype(x.dtype),
            tree["adapters"])
        params = jax.tree.map(jnp.asarray, tree)
        arrays.update(_flatten(tree, f"{case}/params/"))
        if case in DECODE:
            T, P, G = DECODE[case]
            toks = rng.integers(0, jcfg.vocab_size, (1, P)).astype(np.int32)
            arrays[f"{case}/tokens"] = toks
            logits, caches = jax.jit(
                lambda p, t: JM.prefill(p, {"tokens": t}, jcfg, max_len=T))(
                params, jnp.asarray(toks))
            step = jax.jit(lambda p, t, c, pos: JM.decode_step(p, t, c, pos,
                                                               jcfg))
            tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
            got, steps = [int(tok[0, 0])], []
            for i in range(G):
                logits, caches = step(params, tok, caches,
                                      jnp.asarray(P + i, jnp.int32))
                steps.append(np.asarray(logits[:, -1]))
                tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(
                    jnp.int32)
                got.append(int(tok[0, 0]))
            want[case] = {"tokens": got, "logits": np.stack(steps)}
        else:
            toks = rng.integers(0, jcfg.vocab_size, (4, 12)).astype(np.int32)
            arrays[f"{case}/tokens"] = toks
            want[case] = {}
            for cf in (None, -1):
                c = config(jax_config, case, cf)
                lg, _ = jax.jit(lambda p, t: JM.prefill(p, {"tokens": t},
                                                        c))(
                    params, jnp.asarray(toks))
                want[case][str(cf)] = np.asarray(lg)
            want[case]["dropped"] = not np.allclose(
                want[case]["None"], want[case]["-1"], atol=1e-3)
    np.savez(path, **arrays)
    return want


RANK_SCRIPT = textwrap.dedent('''
    import dataclasses, datetime, json, os, sys
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

    from repro_torch.checkpoint.from_jax import from_jax
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_leaves
    from repro_torch.sharding import rules as R

    CASES = json.loads(os.environ["LD_CASES"])
    DECODE = json.loads(os.environ["LD_DECODE"])

    def config(case, capacity_factor=None):
        arch, kw, moe, n_p = CASES[case]
        c = get_config(arch).reduced()
        kw = dict(kw, dtype="float32", vocab_size=64,
                  peft=dataclasses.replace(c.peft, n_prefix=n_p))
        if moe or capacity_factor is not None:
            kw["moe"] = dataclasses.replace(c.moe, **moe)
            if capacity_factor is not None:
                kw["moe"] = dataclasses.replace(
                    kw["moe"], capacity_factor=capacity_factor)
        return c.with_(**kw)

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

    z = np.load(os.environ["LD_NPZ"])
    mesh = make_test_mesh(2, 2, device="cpu")
    res = {}
    for case in DECODE:
        cfg = config(case)
        T, P, G = DECODE[case]
        toks = torch.as_tensor(z[case + "/tokens"])
        rules = R.long_decode_rules()
        params = M.place_params(from_jax(unflatten(z, case + "/params/")),
                                cfg, mesh, rules)
        with R.use_rules(mesh, rules):
            logits, caches = M.prefill(params, {"tokens": toks}, cfg,
                                       max_len=T)
            caches = M.place_caches(caches, cfg, 1, T)
            tok = logits.full_tensor()[:, -1].argmax(-1, keepdim=True)
            got, steps = [int(tok[0, 0])], []
            for i in range(G):
                logits, caches = M.decode_step(params, tok, caches,
                                               torch.tensor([P + i]), cfg)
                lg = logits.full_tensor()[:, -1]
                steps.append(lg.tolist())
                tok = lg.argmax(-1, keepdim=True)
                got.append(int(tok[0, 0]))
            out = {"tokens": got, "logits": steps,
                   "slots": sorted({t.to_local().shape[2]
                                    for t in tree_leaves(caches)}),
                   "placements": sorted({repr(tuple(t.placements))
                                         for t in tree_leaves(caches)})}
            if case == "sliding":
                out["generate"] = M.generate(params, cfg, toks,
                                             gen=G + 1).tolist()[0]
        res[case] = out

    cfg = config("moe")
    toks = torch.as_tensor(z["moe/tokens"])
    res["moe"] = {}
    for cf in (None, -1):
        c = config("moe", cf)
        params = M.place_params(from_jax(unflatten(z, "moe/params/")), c,
                                mesh, R.moe_serving_rules())
        with R.use_rules(mesh, R.moe_serving_rules()):
            lg, _ = M.prefill(params, {"tokens": toks}, c)
        res["moe"][str(cf)] = lg.full_tensor().tolist()
    layer = params["backbone"]["layers"]["g0"][0]["s0"]["moe"]
    res["moe"]["experts"] = {
        k: [repr(tuple(layer[k].placements)),
            list(layer[k].to_local().shape)]
        for k in ("router", "gate", "up", "down")}
    with open(os.environ["LD_OUT"] + ".%d.json" % rank, "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
''')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ld_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("long_decode")
    want = _jax_side(tmp / "weights.npz")
    script = tmp / "rank.py"
    script.write_text(RANK_SCRIPT)
    out = str(tmp / "out")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_"))}
    env.update(PORT_SRC=str(REPO / "src"), LD_NPZ=str(tmp / "weights.npz"),
               LD_OUT=out, MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(RANKS),
               OMP_NUM_THREADS="1", LD_CASES=json.dumps(CASES),
               LD_DECODE=json.dumps(DECODE))
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(RANKS)]
    procs = [subprocess.Popen([sys.executable, str(script)],
                              env={**env, "RANK": str(r)}, cwd=str(tmp),
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(RANKS)]
    try:
        rcs = [p.wait(timeout=300) for p in procs]
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
    return want, got


@pytest.mark.parametrize("case", list(DECODE))
def test_long_decode_equals_jax(ld_run, case):
    """Every step's logits within LOGIT_TOL of the JAX package's decode
    loop and its greedy tokens, on every rank; ``generate`` under the
    rules gives them too (the sliding case, whose cache splits)."""
    want, got = ld_run
    for res in got:
        r = res[case]
        np.testing.assert_allclose(np.asarray(r["logits"])[:, 0],
                                   want[case]["logits"][:, 0], **LOGIT_TOL)
        assert r["tokens"] == want[case]["tokens"]
        if case == "sliding":
            assert r["generate"] == want[case]["tokens"]
    assert len(set(want[case]["tokens"])) > 3


@pytest.mark.parametrize("case", list(DECODE))
def test_each_rank_holds_half_the_cache(ld_run, case):
    """kv_seq on `data` (Shard(2) of the layer-stacked leaves), kv heads
    on `model`: no rank holds more than T / 2 slots."""
    _, got = ld_run
    T = DECODE[case][0]
    for res in got:
        assert res[case]["slots"] == [T // 2]
        assert res[case]["placements"] == [
            "(Shard(dim=2), Replicate())", "(Shard(dim=2), Shard(dim=3))"]


@pytest.mark.parametrize("cf", ["None", "-1"])
def test_moe_serving_prefill_equals_jax(ld_run, cf):
    want, got = ld_run
    for res in got:
        np.testing.assert_allclose(res["moe"][cf], want["moe"][cf],
                                   **LOGIT_TOL)
    if cf == "None":
        assert want["moe"]["dropped"]


class StandIn:
    axis_names = mesh_dim_names = ("data", "model")
    shape = {"data": 2, "model": 2}


def test_moe_serving_experts_placed_as_the_reference(ld_run):
    """Each expert weight's placement and local shape on the ranks follow
    the reference's ``fit_spec`` under ``moe_serving_rules`` (experts on
    `data`, the expert d_model dim on `model`; a per-layer leaf: the
    stacked leaf's spec without its layer dim)."""
    _, got = ld_run
    js = JM.model_spec(config(jax_config, "moe"))
    moe = js["backbone"]["layers"]["g0"]["s0"]["moe"]
    sizes = StandIn.shape
    for k, (pl, local) in got[0]["moe"]["experts"].items():
        spec = tuple(JR.fit_spec(JR._resolve(
            moe[k].axes, JR.moe_serving_rules(), StandIn()), moe[k].shape,
            StandIn()))[1:]
        assert pl == repr(tuple(R.placements(R.P(*spec), StandIn()))), k
        shape = list(moe[k].shape[1:])
        for i, e in enumerate(spec):
            for a in ((e,) if isinstance(e, str) else (e or ())):
                shape[i] //= sizes[a]
        assert local == shape, k
    assert got[0]["moe"]["experts"]["gate"] == [
        "(Shard(dim=0), Shard(dim=1))", [2, 32, 32]]
