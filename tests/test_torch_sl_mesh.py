"""The SL chain on a (`stage`,) mesh against the JAX package, on the CPU.

The reference's case (``tests/test_sl_pipeline.py::
test_pipeline_matches_monolithic_subprocess``): reduced vit-edge, 4 f32
layers, ``head_dim_out=5``, tokens (16, 24), 4 microbatches, one stage a
rank. One module fixture computes the JAX package's monolithic
``classify`` and ``jax.grad`` of its loss once in this process (the
reference's chain gives the monolithic values, its gradient included, and
its gradient costs minutes on the CPU, so it is not run here) and starts
4 ``gloo`` rank subprocesses that form a 4-stage mesh
(``launch/mesh.py::make_stage_mesh``). Each rank bridges the weights
(``checkpoint/from_jax.py``), runs ``pipeline_classify(mesh=)`` and the
mesh-less chain, and one ``make_sl_finetune_step(mesh=)`` step with
``sgd(1.0)``, whose update is minus the gradient. Each rank's log is
``rank<r>.log`` in the fixture's tmp dir.
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
from repro.models import model as JM
from repro.models.layers import cross_entropy as jce
from repro_torch.checkpoint.from_jax import from_jax
from repro_torch.models.params import tree_leaves

REPO = Path(__file__).resolve().parents[1]
RANKS = 4
B, SEQ, MICRO = 16, 24, 4


def _cfg(get):
    cfg = get("vit-edge").reduced().with_(dtype="float32", vocab_size=64,
                                          n_layers=4)
    return cfg.with_(peft=dataclasses.replace(cfg.peft, head_dim_out=5))


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _jax_side(path):
    """The reference's monolithic logits, loss and gradients; weights and
    the batch go to ``path`` for the ranks."""
    jcfg = _cfg(jax_config)
    params = jax.tree.map(np.asarray, JM.init(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    params["adapters"] = jax.tree.map(
        lambda x: x + 0.05 * rng.standard_normal(x.shape).astype(x.dtype),
        params["adapters"])
    toks = rng.integers(0, jcfg.vocab_size, (B, SEQ)).astype(np.int32)
    labels = rng.integers(0, 5, (B,)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, params)

    def loss_fn(adapters):
        p = {"backbone": jp["backbone"], "adapters": adapters}
        return jce(JM.classify(p, {"tokens": jnp.asarray(toks)}, jcfg),
                   jnp.asarray(labels))

    logits = jax.jit(lambda p: JM.classify(p, {"tokens": jnp.asarray(toks)},
                                           jcfg))(jp)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jp["adapters"])
    arrays = _flatten(params, "params/")
    arrays.update(tokens=toks, labels=labels)
    np.savez(path, **arrays)
    g = from_jax({"adapters": jax.tree.map(np.asarray, grads)})["adapters"]
    per = jcfg.n_layers // RANKS
    return {"logits": np.asarray(logits), "loss": float(loss),
            "head": [x.numpy() for x in tree_leaves(g["head"])],
            "stages": [[x.numpy() for x in tree_leaves(
                g["stack"]["g0"][s * per:(s + 1) * per])]
                for s in range(RANKS)]}


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
    from repro_torch.core import sl_pipeline as sl
    from repro_torch.launch.mesh import make_stage_mesh
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import optimizers as topt

    cfg = get_config("vit-edge").reduced().with_(dtype="float32",
                                                 vocab_size=64, n_layers=4)
    cfg = cfg.with_(peft=dataclasses.replace(cfg.peft, head_dim_out=5))
    z = np.load(os.environ["SL_NPZ"])
    tree = {}
    for k in z.files:
        if k.startswith("params/"):
            node, parts = tree, k[len("params/"):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[k]
    params = from_jax(tree)
    toks = torch.as_tensor(z["tokens"])
    labels = torch.as_tensor(z["labels"])
    micro = int(os.environ["SL_MICRO"])
    mesh = make_stage_mesh(world, device="cpu")
    st = sl.split_for_stages(params, cfg, world)
    got = sl.pipeline_classify(params, st, toks, cfg, n_microbatches=micro,
                               mesh=mesh)
    serial = sl.pipeline_classify(params, st, toks, cfg,
                                  n_microbatches=micro)
    opt = topt.sgd(1.0)
    head = params["adapters"]["head"]
    state = opt.init({"a": st["adapters"], "h": head})
    step = sl.make_sl_finetune_step(params, cfg, opt, n_microbatches=micro,
                                    mesh=mesh)
    new, nh, _, loss = step(st, head, state, {"tokens": toks,
                                               "label": labels})
    def minus(a, b):
        return [(x - y).tolist() for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b))]
    others = all(torch.equal(x, y) for s in range(world) if s != rank
                 for x, y in zip(tree_leaves(new["adapters"][s]),
                                 tree_leaves(st["adapters"][s])))
    res = {"logits": got.tolist(), "serial": serial.tolist(),
           "loss": float(loss), "head_grad": minus(head, nh),
           "head": [x.tolist() for x in tree_leaves(nh)],
           "stage_grad": minus(st["adapters"][rank], new["adapters"][rank]),
           "others_unchanged": others}
    with open(os.environ["SL_OUT"] + ".%d.json" % rank, "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
''')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def sl_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sl_mesh")
    want = _jax_side(tmp / "weights.npz")
    script = tmp / "rank.py"
    script.write_text(RANK_SCRIPT)
    out = str(tmp / "out")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_"))}
    env.update(PORT_SRC=str(REPO / "src"), SL_NPZ=str(tmp / "weights.npz"),
               SL_OUT=out, SL_MICRO=str(MICRO), MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(RANKS),
               OMP_NUM_THREADS="1")
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


def test_stage_mesh_logits_equal_classify_and_the_chain(sl_run):
    """Every rank returns the logits: within 1e-4 of the JAX package's
    monolithic ``classify`` and 1e-5 of the port's mesh-less chain."""
    want, got = sl_run
    for r in got:
        assert np.asarray(r["logits"]).shape == (B, 5)
        np.testing.assert_allclose(r["logits"], want["logits"], atol=1e-4,
                                   rtol=0)
        np.testing.assert_allclose(r["logits"], r["serial"], atol=1e-5,
                                   rtol=0)


def test_stage_mesh_step_equals_the_monolithic_gradient(sl_run):
    """One step: the loss, the head's gradient (on every rank, shared
    from the end stage) and each stage's adapter gradient (on its own
    rank) within 1e-4 of ``jax.grad`` of the monolithic loss, once and
    not S times; finite and non-zero; every rank's head equal; a rank
    leaves the other stages' adapters as they were."""
    want, got = sl_run
    for s, r in enumerate(got):
        assert abs(r["loss"] - want["loss"]) <= 1e-4
        for g, w in zip(r["head_grad"], want["head"]):
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
        assert len(r["stage_grad"]) == len(want["stages"][s])
        for g, w in zip(r["stage_grad"], want["stages"][s]):
            g = np.asarray(g)
            assert np.isfinite(g).all()
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
        assert sum(np.abs(np.asarray(g)).sum() for g in r["stage_grad"]) > 0
        assert r["head"] == got[0]["head"]
        assert r["others_unchanged"]
