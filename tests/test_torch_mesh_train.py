"""``make_hfsl_round(mesh=)`` for the moe, ssm, hybrid, vlm and audio
families against the JAX package's unsharded round, on the CPU.

One module fixture runs the JAX package's round of each family once in
this process (4 clusters, batch 4, 2 ``lm_loss`` steps of AdamW,
``sync_every=2``) from a seeded state (nonzero LoRA b and state
prompts), and writes the state, the batches and the reference's output
adapters to an ``.npz``. 4 ``gloo`` rank subprocesses form a 2x2
(`data`, `model`) mesh and run each family's round from the bridged
state on it under ``hfsl_round_rules`` (rank 0 also without a mesh): the
moe, vlm and audio rounds split each cluster's backbone over `model`
(a moe's experts on their ranks), the ssm and hybrid rounds split each
cluster's batch over `model`. The losses and the adapters equal the
reference's within ``ADAM_TOL``, and the output state keeps the input's
placements. Each rank's log is ``rank<r>.log`` in the fixture's tmp
dir. The mesh-less port runs once, on rank 0.
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
import numpy as np
import pytest

from repro.configs.base import get_config as jax_config
from repro.core import hfsl as jhfsl
from repro.models import model as JM
from repro.optim.optimizers import adamw as jadamw

REPO = Path(__file__).resolve().parents[1]
ADAM_TOL = dict(atol=1e-4, rtol=1e-4)          # test_torch_hfsl.py's
RANKS = 4
C, BATCH, SEQ, STEPS = 4, 4, 8, 2

# family -> (arch, config overrides, sub-config overrides); f32, vocab 64
FAMILIES = {
    "moe": ("granite-moe-1b-a400m", dict(d_model=64, head_dim=16,
                                         n_kv_heads=2),
            {"moe": dict(d_ff_expert=32)}),
    "ssm": ("falcon-mamba-7b", dict(d_model=64), {}),
    "hybrid": ("recurrentgemma-2b", dict(d_model=64, n_layers=5),
               {"hybrid": dict(lru_width=64, tail=("rglru", "rglru"))}),
    "vlm": ("llava-next-mistral-7b", dict(d_model=64, head_dim=16), {}),
    "audio": ("whisper-small", dict(d_model=64, head_dim=16), {}),
}


def config(get, fam):
    arch, kw, sub = FAMILIES[fam]
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


def _batches(cfg, rng):
    """(STEPS, C, BATCH, ...) lm batches with the family's modality rows."""
    t = rng.integers(0, cfg.vocab_size, (STEPS, C, BATCH, SEQ + 1))
    out = {"tokens": t[..., :-1].astype(np.int32),
           "labels": t[..., 1:].astype(np.int32)}
    if cfg.family == "vlm":
        out["vision_embeds"] = rng.standard_normal(
            (STEPS, C, BATCH, cfg.vlm.n_vis_tokens, cfg.d_model)) \
            .astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (STEPS, C, BATCH, cfg.audio.n_audio_frames, cfg.d_model)) \
            .astype(np.float32)
    return out


def _jax_side(path):
    arrays, want = {}, {}
    for i, fam in enumerate(FAMILIES):
        jcfg = config(jax_config, fam)
        rng = np.random.default_rng(i)
        opt = jadamw(5e-3)
        st = jax.tree.map(np.array, jhfsl.init_hfsl_state(
            jax.random.PRNGKey(i), jcfg, C, opt, JM.init))
        _seeded(st["adapters_c"], rng)
        bank = _batches(jcfg, rng)
        rnd = jhfsl.make_hfsl_round(jcfg, opt, JM.lm_loss, steps=STEPS,
                                    sync_every=2)
        su, mu = rnd(st, bank, 0)
        arrays.update(_flatten(st, f"{fam}/state0/"))
        arrays.update(_flatten(bank, f"{fam}/bank/"))
        arrays.update(_flatten(jax.tree.map(np.asarray, su["adapters_c"]),
                               f"{fam}/want/"))
        moved = max(float(np.abs(np.asarray(a) - b).max()) for a, b in zip(
            jax.tree.leaves(su["adapters_c"]),
            jax.tree.leaves(st["adapters_c"])))
        want[fam] = {"loss": np.asarray(mu["loss"]).tolist(),
                     "moved": moved}
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

    from repro_torch.checkpoint.from_jax import (_clustered_from_jax,
                                                 hfsl_state_from_jax)
    from repro_torch.configs.base import get_config
    from repro_torch.core import hfsl
    from repro_torch.data.pipeline import BatchBank
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim.optimizers import adamw
    from repro_torch.sharding import rules as R

    FAMILIES = json.loads(os.environ["MESH_FAMILIES"])
    C, STEPS = 4, 2
    TOL = 1e-4

    def config(fam):
        arch, kw, sub = FAMILIES[fam]
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

    def placements(tree):
        return [repr(tuple(x.placements)) for x in tree_leaves(tree)]

    def excess(got, want):
        """max over leaves of |got - want| - (TOL + TOL |want|): <= 0 is
        within ADAM_TOL."""
        return max(float((g - w).abs().sub(TOL + TOL * w.abs()).max())
                   for g, w in zip(got, want))

    z = np.load(os.environ["MESH_NPZ"])
    mesh = make_test_mesh(2, 2, device="cpu")
    res = {}
    for fam in FAMILIES:
        cfg = config(fam)
        opt = adamw(5e-3)
        state0 = hfsl_state_from_jax(unflatten(z, fam + "/state0/"), "cpu")
        want = tree_leaves(_clustered_from_jax(unflatten(z, fam + "/want/"),
                                               "cpu"))
        arrays = {k: torch.from_numpy(np.asarray(v))
                  for k, v in unflatten(z, fam + "/bank/").items()}
        rows = [{k: v[i] for k, v in arrays.items()} for i in range(STEPS)]
        res[fam] = {}
        if rank == 0:       # the mesh-less port once (no collective call)
            su, mu = hfsl.make_hfsl_round(cfg, opt, M.lm_loss, steps=STEPS,
                                          sync_every=2)(state0, arrays, 0)
            res[fam].update(loss_port=mu["loss"].tolist(),
                            excess_port=excess(
                                tree_leaves(su["adapters_c"]), want))
        rules = R.hfsl_round_rules(cfg.family)
        spec = hfsl.hfsl_state_spec(cfg, C, opt, M.model_spec)
        sh = hfsl.hfsl_state_shardings(cfg, C, opt, M.model_spec, mesh,
                                       rules)
        state_s = R.distribute_tree(state0, sh, mesh)
        bank = BatchBank.from_iterator(iter(rows), STEPS, mesh=mesh,
                                       rules=rules, device="cpu")
        rnd = hfsl.make_hfsl_round(cfg, opt, M.lm_loss, steps=STEPS,
                                   sync_every=2, mesh=mesh, rules=rules,
                                   state_spec=spec)
        ss, ms = rnd(state_s, bank.arrays, 0)
        got = [x.full_tensor() for x in tree_leaves(ss["adapters_c"])]
        res[fam].update({
            "loss_mesh": ms["loss"].tolist(),
            "excess_mesh": excess(got, want),
            "n_leaves": [len(got), len(want)],
            "placements_in": placements(state_s["adapters_c"]) +
            placements(state_s["opt"]),
            "placements_out": placements(ss["adapters_c"]) +
            placements(ss["opt"]),
            "model_split": any("Shard" in p.split(",")[-1] for p in
                               placements(ss["adapters_c"])),
            "step": int(ss["step"].full_tensor())})
    with open(os.environ["MESH_OUT"] + ".%d.json" % rank, "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
''')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def train_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    want = _jax_side(tmp / "weights.npz")
    script = tmp / "rank.py"
    script.write_text(RANK_SCRIPT)
    out = str(tmp / "out")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_"))}
    env.update(PORT_SRC=str(REPO / "src"), MESH_NPZ=str(tmp / "weights.npz"),
               MESH_OUT=out, MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(RANKS),
               OMP_NUM_THREADS="1", MESH_FAMILIES=json.dumps(FAMILIES))
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


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_mesh_round_equals_jax(train_run, fam):
    """The mesh round's losses and adapters are the reference's within
    ADAM_TOL on every rank (and the mesh-less port's, run on rank 0, are
    too); the adapters moved."""
    want, got = train_run
    assert want[fam]["moved"] > 1e-3
    np.testing.assert_allclose(got[0][fam]["loss_port"], want[fam]["loss"],
                               **ADAM_TOL)
    assert got[0][fam]["excess_port"] <= 0.0, got[0][fam]["excess_port"]
    for res in got:
        r = res[fam]
        np.testing.assert_allclose(r["loss_mesh"], want[fam]["loss"],
                                   **ADAM_TOL)
        assert r["n_leaves"][0] == r["n_leaves"][1] > 0
        assert r["excess_mesh"] <= 0.0, r["excess_mesh"]
        assert r["step"] == STEPS


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_mesh_round_keeps_the_placements(train_run, fam):
    """The output state's adapters and moments keep the input's
    placements: clusters on `data`, and the state prompts' ``d_inner`` /
    ``lru`` channels or the LoRA's columns on `model` where they split."""
    _, got = train_run
    r = got[0][fam]
    assert r["placements_out"] == r["placements_in"]
    assert all(p.startswith("(Shard(dim=0),") for p in r["placements_out"])
    assert r["model_split"]
