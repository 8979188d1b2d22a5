"""Every serving mode and every family on a device mesh, against the JAX
package, on the CPU.

One module fixture computes the JAX package's unsharded drains once in
this process, writes their weights, requests and extras to an ``.npz``,
and starts 4 ``gloo`` rank subprocesses that form a 2x2 (`data`,
`model`) mesh. Each rank bridges the weights (``checkpoint/from_jax.py``)
and runs every drain on the mesh (rank 0 also without one):

- (a) qwen2-7b paged with prefix sharing, from a slot-sharded 4-domain
  bank; rows on both `data` ranks name one shared prefix block;
- (b) qwen2-7b speculative with the recurrent drafter on the 3-2 layout
  (``sliding_window=8``, 9-token prompts, k = 3), where the reference's
  speculative tokens are not plain decoding's;
- (c) granite-moe-1b-a400m at its default capacity factor, its prefill
  dropping assignments (held on the JAX side);
- (d) falcon-mamba-7b from a 4-domain bank of state prompts;
- (e) recurrentgemma-2b with its ``tail`` group;
- (f) llava-next-mistral-7b with vision rows;
- (g) whisper-small with audio frames.

Tokens equal the JAX package's; engine stats equal the mesh-less port's.
The ranks also record the placements of the pool, the recurrent caches
and the expert weights (held against the reference's ``fit_spec``), and
run one produce round of ``IntegratedRuntime(mesh=, spec_k=)`` and
``(mesh=, paged=)`` on vit-edge. Each rank's log is ``rank<r>.log`` in
the fixture's tmp dir.
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

from repro.configs.base import get_config as jax_config
from repro.core import spec_decode as JSD
from repro.core.adapter_bank import AdapterBank as JaxBank
from repro.core.paged import PagedSpec as JaxPaged
from repro.launch.engine import DecodeEngine as JaxEngine
from repro.models import model as JM
from repro.sharding import rules as JR
from repro_torch.sharding import rules as R

REPO = Path(__file__).resolve().parents[1]
RANKS = 4
DOMS = ["d0", "d1", "d2", "d3"]
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
STAT_KEYS = ["requests", "waves", "segments", "tokens", "padded_tokens",
             "drafted", "accepted", "prefix_hits", "prefix_hit_tokens",
             "pool_peak_blocks", "pool_blocks_alloc", "cache_tokens",
             "pool_occupancy"]

# case -> (arch, config overrides, moe / hybrid overrides); every width
# divides by 2, f32, vocab 64
CASES = {
    "paged": ("qwen2-7b", dict(d_model=64, head_dim=16, n_kv_heads=2), {}),
    "spec": ("qwen2-7b", dict(d_model=64, head_dim=16, n_kv_heads=2,
                              attn_variant="sliding", sliding_window=8), {}),
    "moe": ("granite-moe-1b-a400m", dict(d_model=64, head_dim=16,
                                         n_kv_heads=2),
            {"moe": dict(d_ff_expert=32)}),
    "ssm": ("falcon-mamba-7b", dict(d_model=64), {}),
    "hybrid": ("recurrentgemma-2b", dict(d_model=64, n_layers=5),
               {"hybrid": dict(lru_width=64, tail=("rglru", "rglru"))}),
    "vlm": ("llava-next-mistral-7b", dict(d_model=64, head_dim=16), {}),
    "audio": ("whisper-small", dict(d_model=64, head_dim=16), {}),
}
BANKED = {"paged", "ssm"}          # served from a 4-domain bank


def config(get, case):
    arch, kw, sub = CASES[case]
    c = get(arch).reduced()
    kw = dict(kw, dtype="float32", vocab_size=64)
    for field, over in sub.items():
        kw[field] = dataclasses.replace(getattr(c, field), **over)
    return c.with_(**kw)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _seeded(tree, rng):
    """Nonzero LoRA b and state prompts (both init to zeros), in place."""
    if isinstance(tree, dict):
        if "state0" in tree:
            tree["state0"] = (0.3 * rng.standard_normal(
                tree["state0"].shape)).astype(np.float32)
        for t in tree.get("lora", {}).values():
            t["b"] = (0.1 * rng.standard_normal(t["b"].shape)).astype(
                np.float32)
        for k, v in tree.items():
            if k not in ("state0", "lora"):
                _seeded(v, rng)
    return tree


def _requests(case, cfg):
    """[(prompt, gen, domain, extras)]: 7 ragged requests on 4 slots (the
    in-wave refill runs); the paged queue puts two domains' system
    prompts (two blocks each) in front of every prompt."""
    rng = np.random.default_rng(7)
    lens, gens = [9, 13, 9, 5, 11, 9, 7], [4, 3, 5, 2, 6, 3, 4]
    if case == "spec":
        lens = [9] * 7
    doms = [DOMS[i % 4] if case in BANKED else None for i in range(7)]
    if case == "paged":
        sys_p = {d: rng.integers(0, cfg.vocab_size, 16) for d in DOMS[:2]}
        doms = ["d0", "d1", "d0", "d1", "d0", "d0", "d1"]
    out = []
    for i, (n, g) in enumerate(zip(lens, gens)):
        p = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        if case == "paged":
            p = np.concatenate([sys_p[doms[i]], p[:n - 6]]).astype(np.int32)
        ex = None
        if case == "vlm":
            ex = {"vision_embeds": rng.standard_normal(
                (cfg.vlm.n_vis_tokens, cfg.d_model)).astype(np.float32)}
        if case == "audio":
            ex = {"frames": rng.standard_normal(
                (cfg.audio.n_audio_frames, cfg.d_model)).astype(np.float32)}
        out.append((p, g, doms[i], ex))
    return out


def _drain(eng, params, reqs):
    uids = [eng.submit(p, g, domain=d, extras=ex) for p, g, d, ex in reqs]
    comps, stats = eng.run(params)
    by = {c.uid: np.asarray(c.tokens).tolist() for c in comps}
    return [by[u] for u in uids], stats


def _jax_side(path):
    """Every case's JAX drain, unsharded; weights, requests and extras go
    to ``path`` for the ranks."""
    arrays, want = {}, {}
    for ci, case in enumerate(CASES):
        jcfg = config(jax_config, case)
        key = jax.random.PRNGKey(ci)
        rng = np.random.default_rng(ci)
        tree = jax.tree.map(np.array, JM.init(jcfg, key))
        if case == "moe":
            # experts 2 and 3 tie at logit 0, expert 1 mirrors expert 0: every
            # token's top 2 hold expert 2 (ties go to the lower index), which
            # overflows in every prefill
            r = tree["backbone"]["layers"]["g0"]["s0"]["moe"]["router"]
            r[..., 1], r[..., 2:] = -r[..., 0], 0.0
        reqs = _requests(case, jcfg)
        kw = {}
        if case in BANKED:
            ks = jax.random.split(key, len(DOMS))
            adapters = {d: _seeded(jax.tree.map(
                np.array, JM.init(jcfg, ks[i])["adapters"]), rng)
                for i, d in enumerate(DOMS)}
            bank = JaxBank.create(adapters)
            params = bank.serving_params(tree["backbone"])
            kw["bank"] = bank
            for d in DOMS:
                arrays.update(_flatten(adapters[d], f"{case}/adapters/{d}/"))
        else:
            tree["adapters"] = _seeded(tree["adapters"], rng)
            params = jax.tree.map(jnp.asarray, tree)
            arrays.update(_flatten(tree["adapters"], f"{case}/adapters/"))
        arrays.update(_flatten(tree["backbone"], f"{case}/backbone/"))
        if case == "paged":
            kw["paged"] = JaxPaged(n_blocks=32, block_size=8,
                                   share_prefix=True)
        if case == "spec":
            jspec = JSD.SpecDecoder.init(jcfg, jax.random.PRNGKey(50), k=3)
            kw["spec"] = jspec
            arrays.update(_flatten(jax.tree.map(np.asarray, jspec.params),
                                   f"{case}/drafter/"))
        toks, stats = _drain(JaxEngine(jcfg, slots=4, **kw), params, reqs)
        want[case] = {"tokens": toks, "drafted": stats.drafted,
                      "prefix_hits": stats.prefix_hits}
        for i, (p, g, d, ex) in enumerate(reqs):
            arrays[f"{case}/req/{i}"] = p
            for k, v in (ex or {}).items():
                arrays[f"{case}/extras/{i}/{k}"] = v
        want[case]["meta"] = [(g, d) for _, g, d, _ in reqs]
        if case == "moe":
            # the prefill of the whole queue drops assignments: it differs
            # from the same prefill with no capacity limit
            batch = np.stack([np.resize(r[0], 12) for r in reqs[:4]])
            logits, _ = JM.prefill(params, {"tokens": jnp.asarray(batch)},
                                   jcfg)
            nodrop = jcfg.with_(moe=dataclasses.replace(
                jcfg.moe, capacity_factor=-1))
            free, _ = JM.prefill(params, {"tokens": jnp.asarray(batch)},
                                 nodrop)
            want[case]["dropped"] = not np.allclose(
                np.asarray(logits), np.asarray(free), atol=1e-3)
            want[case]["prefill_logits"] = np.asarray(logits)
            arrays[f"{case}/prefill_tokens"] = batch
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
    from repro_torch.core.adapter_bank import AdapterBank
    from repro_torch.core.integrated import IntegratedRuntime
    from repro_torch.core.paged import PagedSpec
    from repro_torch.core.spec_decode import SpecDecoder, drafter_config
    from repro_torch.data.synthetic import ClassificationTask
    from repro_torch.launch.engine import DecodeEngine
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_leaves
    from repro_torch.sharding import rules as R

    CASES = json.loads(os.environ["MESH_CASES"])
    META = json.loads(os.environ["MESH_META"])
    BANKED, DOMS = {"paged", "ssm"}, ["d0", "d1", "d2", "d3"]
    STAT_KEYS = json.loads(os.environ["MESH_STATS"])

    def config(case):
        arch, kw, sub = CASES[case]
        c = get_config(arch).reduced()
        kw = dict(kw, dtype="float32", vocab_size=64)
        for field, over in sub.items():
            if "tail" in over:
                over = dict(over, tail=tuple(over["tail"]))
            kw[field] = dataclasses.replace(getattr(c, field), **over)
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

    def pl(x):
        return repr(tuple(x.placements))

    z = np.load(os.environ["MESH_NPZ"])
    mesh = make_test_mesh(2, 2, device="cpu")
    res = {}
    for case in CASES:
        cfg = config(case)
        backbone = from_jax({"backbone": unflatten(z, case + "/backbone/")}
                            )["backbone"]
        reqs = []
        for i, (g, d) in enumerate(META[case]):
            ex = unflatten(z, "%s/extras/%d/" % (case, i)) or None
            reqs.append((z["%s/req/%d" % (case, i)], g, d, ex))

        def drain(mesh_):
            kw = {}
            if case in BANKED:
                ad = {d: from_jax(unflatten(z, "%s/adapters/%s/" % (case, d)))
                      for d in DOMS}
                bank = AdapterBank.create(ad, mesh=mesh_)
                bb = backbone if mesh_ is None else M.place_params(
                    {"backbone": backbone}, cfg, mesh_)["backbone"]
                params, kw["bank"] = bank.serving_params(bb), bank
            else:
                params = {"backbone": backbone, "adapters": from_jax(
                    unflatten(z, case + "/adapters/"))}
                if mesh_ is not None:
                    params = M.place_params(params, cfg, mesh_)
            if case == "paged":
                kw["paged"] = PagedSpec(n_blocks=32, block_size=8,
                                        share_prefix=True)
            if case == "spec":
                kw["spec"] = SpecDecoder(drafter_config(cfg), from_jax(
                    unflatten(z, case + "/drafter/")), k=3)
            eng = DecodeEngine(cfg, slots=4, mesh=mesh_, device="cpu", **kw)
            uids = [eng.submit(p, g, domain=d, extras=ex)
                    for p, g, d, ex in reqs]
            comps, st = eng.run(params)
            by = {c.uid: c.tokens.tolist() for c in comps}
            return [by[u] for u in uids], {k: getattr(st, k)
                                           for k in STAT_KEYS}, eng, params

        # the mesh-less port once, on rank 0 (it makes no collective call)
        out = {} if rank else dict(zip(("port", "stats_port"),
                                       drain(None)[:2]))
        out["mesh"], out["stats_mesh"], eng, params = drain(mesh)
        if case == "paged":
            out["pool"] = pl(eng._pool["g0"]["s0"]["k"])
        if case in ("ssm", "hybrid"):
            # the caches of a wave prefill on the mesh
            toks = torch.as_tensor(np.stack([np.resize(r[0], 8)
                                             for r in reqs[:4]]))
            ids = None if case not in BANKED else \\
                eng.bank.adapter_ids(["d0", "d1", "d2", "d3"])
            with R.use_rules(mesh, R.serving_rules()):
                _, caches, _ = M.wave_prefill(
                    params, cfg, 16, {"tokens": toks},
                    torch.full((4,), 8, dtype=torch.int32), ids)
            out["caches"] = {g + "/" + s + "/" + leaf: pl(t)
                             for g, grp in caches.items()
                             for s, c in grp.items()
                             for leaf, t in c.items()}
        if case == "moe":
            layer = params["backbone"]["layers"]["g0"][0]["s0"]["moe"]
            out["experts"] = {k: pl(layer[k])
                              for k in ("router", "gate", "up", "down")}
            with R.use_rules(mesh, R.serving_rules()):
                lg, _ = M.prefill(params, {"tokens": torch.as_tensor(
                    z["moe/prefill_tokens"])}, cfg)
            out["prefill_logits"] = lg.full_tensor().tolist()
        res[case] = out

    # IntegratedRuntime(mesh=) with spec_k and with paged: one produce round
    icfg = get_config("vit-edge").reduced().with_(dtype="float32",
                                                  vocab_size=64)
    tasks = {n: ClassificationTask(5, 64, 24, class_strength=0.6, seed=s)
             for n, s in [("nlp", 0), ("cv", 7)]}
    for name, kw in (("rt_spec", dict(spec_k=2)),
                     ("rt_paged", dict(paged=PagedSpec(32, 8)))):
        got = []
        for m_ in ((None, mesh) if rank == 0 else (mesh,)):
            rt = IntegratedRuntime(icfg, tasks, mesh=m_, n_clusters=2,
                                   steps_per_upgrade=2, serve_batch=4,
                                   serve_gen=3, serve_slots=4, seed=0,
                                   device="cpu", **kw)
            profit, cost = rt.produce(["nlp", "cv"])
            got.append([profit, cost.tokens, cost.padded_tokens,
                        cost.drafted_tokens, cost.accepted_tokens])
        res[name] = got
    with open(os.environ["MESH_OUT"] + ".%d.json" % rank, "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
''')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def serve_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_serve")
    want = _jax_side(tmp / "weights.npz")
    script = tmp / "rank.py"
    script.write_text(RANK_SCRIPT)
    out = str(tmp / "out")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_"))}
    env.update(PORT_SRC=str(REPO / "src"), MESH_NPZ=str(tmp / "weights.npz"),
               MESH_OUT=out, MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(RANKS),
               OMP_NUM_THREADS="1", MESH_CASES=json.dumps(CASES),
               MESH_STATS=json.dumps(STAT_KEYS),
               MESH_META=json.dumps({c: w["meta"] for c, w in want.items()}))
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
    return want, got


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_drain_equals_jax(serve_run, case):
    """Every rank returns every request's tokens, the JAX package's; the
    mesh drain's engine stats are the mesh-less port's (run on rank 0)."""
    want, got = serve_run
    assert got[0][case]["port"] == want[case]["tokens"]
    for res in got:
        r = res[case]
        assert r["mesh"] == want[case]["tokens"]
        assert r["stats_mesh"] == got[0][case]["stats_port"]
    s = got[0][case]["stats_mesh"]
    assert s["requests"] == 7 and s["waves"] > 1


def test_paged_drain_shares_a_prefix_block_across_data_ranks(serve_run):
    """Slots 0 and 2 (on `data` ranks 0 and 1) hold d0 requests of one
    system prompt: the second is a prefix hit on the first's blocks, in
    the first wave. The pool's blocks ride `data`, its kv heads
    `model`."""
    want, got = serve_run
    s = got[0]["paged"]["stats_mesh"]
    assert s["prefix_hits"] == want["paged"]["prefix_hits"] >= 3
    assert s["pool_peak_blocks"] > 0 and 0 < s["pool_occupancy"] <= 1
    assert got[0]["paged"]["pool"] == "(Shard(dim=1), Shard(dim=3))"


def test_spec_drain_counts_and_the_3_2_layout(serve_run):
    """Drafted and accepted counts equal on the mesh; on the sliding
    window of 8 the reference's speculative tokens (3-2) are what the
    mesh gives."""
    want, got = serve_run
    s = got[0]["spec"]
    assert s["stats_mesh"]["drafted"] == want["spec"]["drafted"] > 0
    assert s["stats_mesh"]["accepted"] == s["stats_port"]["accepted"]


def test_moe_prefill_drops_and_equals_jax(serve_run):
    want, got = serve_run
    assert want["moe"]["dropped"]
    for res in got:
        np.testing.assert_allclose(res["moe"]["prefill_logits"],
                                   want["moe"]["prefill_logits"],
                                   **LOGIT_TOL)


class StandIn:
    axis_names = mesh_dim_names = ("data", "model")
    shape = {"data": 2, "model": 2}


def _ref_placements(axes, shape, layer_dim=False):
    """The reference's placement of a leaf under ``serving_rules`` on the
    2x2 mesh (a per-layer leaf: the stacked leaf's without its layer
    dim)."""
    spec = tuple(JR.fit_spec(JR._resolve(axes, JR.serving_rules(),
                                         StandIn()), shape, StandIn()))
    if layer_dim:
        spec = spec[1:]
    return repr(tuple(R.placements(R.P(*spec), StandIn())))


def test_mesh_placements_equal_the_reference(serve_run):
    from repro.models import attention as JA
    from repro.models import transformer as JT
    _, got = serve_run
    r = got[0]
    pool = JA.cache_spec(config(jax_config, "paged"), 4, 16, paged=(32, 8),
                         layers=2)["k"]
    assert r["paged"]["pool"] == _ref_placements(pool.axes, pool.shape)
    for case in ("ssm", "hybrid"):
        jc = JT.cache_group_spec(config(jax_config, case), 4, 16)
        for key, p in r[case]["caches"].items():
            g, s, leaf = key.split("/")
            sp = jc[g][s][leaf]
            assert p == _ref_placements(sp.axes, sp.shape), (case, key)
    js = JM.model_spec(config(jax_config, "moe"))
    moe = js["backbone"]["layers"]["g0"]["s0"]["moe"]
    for k, p in r["moe"]["experts"].items():
        assert p == _ref_placements(moe[k].axes, moe[k].shape, True), k
    assert r["moe"]["experts"]["gate"] == "(Shard(dim=1), Shard(dim=0))"


@pytest.mark.parametrize("name", ["rt_spec", "rt_paged"])
def test_integrated_runtime_on_a_mesh(serve_run, name):
    """One produce round of the vit-edge runtime on the mesh books what
    the mesh-less one does (profit, tokens, drafted and accepted)."""
    _, got = serve_run
    port = got[0][name][0]                 # rank 0: (mesh-less, mesh)
    for res in got:
        mesh = res[name][-1]
        assert mesh == port
        assert mesh[1] == 4 * 3
    if name == "rt_spec":
        assert port[3] > 0
