"""ssm- and hybrid-family training in the port against the JAX package, on
the CPU: the plain backwards of the two recurrences
(``selective_scan_bwd_torch``, ``rglru_bwd_torch``, the kernels' order)
against ``jax.vjp`` of the reference's scans (its XLA gradient: no TPU
kernel has a backward) and against autograd through the port's oracles;
a ragged row's gradients against the row run alone; the RG-LRU's
saturated-gate trait; HFSL rounds of reduced falcon-mamba-7b and
recurrentgemma-2b from bridged JAX state against
``repro.core.hfsl.make_hfsl_round``; the training CLI on both families.

Inputs are seeded numpy arrays handed to both packages, f32. Tolerances:
the plain backwards against the reference rtol 1e-5, atol 1e-6 (two f32
algorithms, sums in other orders; measured at most 6e-7 of the largest
gradient), against autograd through the oracles 1e-6; rounds at the HFSL
tests' SGD tolerance 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.core import hfsl as jhfsl
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.kernels import ops as jops
from repro.models import model as JM
from repro.optim import optimizers as jopt
from repro_torch.checkpoint.from_jax import (hfsl_state_from_jax,
                                             hfsl_state_to_numpy)
from repro_torch.configs.base import get_config
from repro_torch.core import hfsl
from repro_torch.data import pipeline, synthetic
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import selective_scan as ss
from repro_torch.launch import train
from repro_torch.models import model as M
from repro_torch.models.params import tree_leaves
from repro_torch.optim import optimizers as topt

VJP_TOL = dict(rtol=1e-5, atol=1e-6)
ORACLE_TOL = dict(rtol=1e-6, atol=1e-6)
SGD_TOL = dict(atol=1e-5, rtol=1e-5)
B, S = 2, 40            # S: not a multiple of either checkpoint interval
DI, N, W = 16, 4, 16
SS_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")
LRU_GRADS = ("dx", "dr", "di", "da_param", "dh0")


def scan_inputs(seed, h0_kind):
    """x, dt, A, the x_proj-shaped output holding B and C, D, h0, dy,
    dh_final."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = (0.5 * rng.standard_normal((B, S, DI))).astype(f)
    dt = (0.1 * np.log1p(np.exp(rng.standard_normal((B, S, DI))))).astype(f)
    A = -np.exp(0.3 * rng.standard_normal((DI, N))).astype(f)
    xdbc = (0.5 * rng.standard_normal((B, S, 3 + 2 * N))).astype(f)
    D = rng.standard_normal(DI).astype(f)
    h0 = {"none": None,
          "row": (0.1 * rng.standard_normal((B, DI, N))).astype(f),
          "shared": (0.1 * rng.standard_normal((DI, N))).astype(f)}[h0_kind]
    dy = rng.standard_normal((B, S, DI)).astype(f)
    dh = rng.standard_normal((B, DI, N)).astype(f)
    return x, dt, A, xdbc, D, h0, dy, dh


def lru_inputs(seed, h0_kind):
    """x, r_gate, i_gate, a_param, h0, dhs, dh_final."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = (0.5 * rng.standard_normal((B, S, W))).astype(f)
    r, i = (rng.standard_normal((B, S, W)).astype(f) for _ in range(2))
    a = rng.standard_normal(W).astype(f)
    h0 = {"none": None,
          "row": (0.1 * rng.standard_normal((B, W))).astype(f),
          "shared": (0.1 * rng.standard_normal(W)).astype(f)}[h0_kind]
    dhs = rng.standard_normal((B, S, W)).astype(f)
    dh = rng.standard_normal((B, W)).astype(f)
    return x, r, i, a, h0, dhs, dh


def bc(xdbc):
    """B and C as the ssm layer makes them: column views of x_proj's
    output."""
    return xdbc[..., 3:3 + N], xdbc[..., 3 + N:]


def jax_scan_vjp(fn, args, h0, cot, expand):
    """Gradients of ``fn(*args, h0)`` against the cotangents ``cot``; a
    shared h0 is broadcast over the rows inside the differentiated
    function, so its gradient is the rows' sum."""
    def f(*a):
        *a, s0 = a
        if s0 is not None and expand:
            s0 = jnp.broadcast_to(s0, expand)
        return fn(*a, s0)
    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in args),
                     None if h0 is None else jnp.asarray(h0))
    return [None if g is None else np.asarray(g)
            for g in vjp(tuple(jnp.asarray(c) for c in cot))]


# the reference's two XLA algorithms: the naive step loop and the chunked
# associative scan (chunk 8: 5 chunks of S 40)
SCAN_REFS = {
    "xla": lambda *a: jops.selective_scan(*a, backend="xla"),
    "assoc": lambda x, dt, A, Bm, C, D, h0: jops._selective_scan_assoc(
        x, dt, A, Bm, C, D, h0, chunk=8)}
LRU_REFS = {
    "xla": lambda *a: jops.rglru(*a, backend="xla"),
    "assoc": lambda x, r, i, a, h0: jops._rglru_assoc(x, r, i, a, h0,
                                                      chunk=8)}
H0_KINDS = ("none", "row", "shared")
# (h0, reference algorithm): every h0 through the step loop, one through
# the associative scan
CASES = [(h, "xla") for h in H0_KINDS] + [("row", "assoc")]


@pytest.fixture(scope="module")
def jax_grads():
    """The reference's gradients of every case, computed once."""
    out = {}
    for h0_kind, name in CASES:
        k = H0_KINDS.index(h0_kind)
        x, dt, A, xdbc, D, h0, dy, dh = scan_inputs(k, h0_kind)
        out["scan", h0_kind, name] = jax_scan_vjp(
            SCAN_REFS[name], (x, dt, A, *bc(xdbc), D), h0, (dy, dh),
            (B, DI, N) if h0_kind == "shared" else None)
        x, r, i, a, h0, dhs, dh = lru_inputs(k, h0_kind)
        out["lru", h0_kind, name] = jax_scan_vjp(
            LRU_REFS[name], (x, r, i, a), h0, (dhs, dh),
            (B, W) if h0_kind == "shared" else None)
    return out


def tt(*arrs):
    return [None if a is None else torch.from_numpy(a) for a in arrs]


def plain_scan_grads(h0_kind, seed):
    x, dt, A, xdbc, D, h0, dy, dh = scan_inputs(seed, h0_kind)
    x, dt, A, xdbc, D, h0, dy, dh = tt(x, dt, A, xdbc, D, h0, dy, dh)
    Bm, C = bc(xdbc)
    if h0 is not None and h0.dim() == 2:
        h0 = h0.expand(B, DI, N)
    g = list(ss.selective_scan_bwd_torch(x, dt, A, Bm, C, D, h0, dy, dh))
    if h0_kind == "shared":
        g[6] = g[6].sum(0)                   # the broadcast's VJP
    elif h0_kind == "none":
        g[6] = None
    return g


def plain_lru_grads(h0_kind, seed):
    x, r, i, a, h0, dhs, dh = tt(*lru_inputs(seed, h0_kind))
    if h0 is not None and h0.dim() == 1:
        h0 = h0.expand(B, W)
    g = list(rg.rglru_bwd_torch(x, r, i, a, h0, dhs, dh))
    if h0_kind == "shared":
        g[4] = g[4].sum(0)
    elif h0_kind == "none":
        g[4] = None
    return g


@pytest.mark.parametrize("h0_kind,ref_name", CASES)
def test_selective_scan_bwd_matches_jax_vjp(jax_grads, h0_kind, ref_name):
    want = jax_grads["scan", h0_kind, ref_name]
    got = plain_scan_grads(h0_kind, H0_KINDS.index(h0_kind))
    # jax's order (x, dt, A, B, C, D, h0); the plain backward's (dx, ddt,
    # dA, dB, dC, dD, dh0)
    for name, g, w in zip(SS_GRADS, got, want):
        if w is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(g.numpy(), w, **VJP_TOL, err_msg=name)


@pytest.mark.parametrize("h0_kind,ref_name", CASES)
def test_rglru_bwd_matches_jax_vjp(jax_grads, h0_kind, ref_name):
    want = jax_grads["lru", h0_kind, ref_name]
    got = plain_lru_grads(h0_kind, H0_KINDS.index(h0_kind))
    for name, g, w in zip(LRU_GRADS, got, want):
        if w is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(g.numpy(), w, **VJP_TOL, err_msg=name)


def autograd(fn, args, cot):
    """Gradients of every tensor in ``args`` through ``fn`` against the
    cotangents ``cot``."""
    leaves = [None if a is None else a.clone().requires_grad_(True)
              for a in args]
    out = fn(*leaves)
    sum((o * c).sum() for o, c in zip(out, cot)).backward()
    return [None if a is None else a.grad for a in leaves]


@pytest.mark.parametrize("h0_kind", H0_KINDS)
def test_scan_function_matches_autograd_through_the_oracles(h0_kind):
    """The port's differentiable ``selective_scan`` and ``rglru`` (the
    autograd Functions, the plain backwards on the CPU) against autograd
    through ``kernels/ref.py``, with B and C as views of one leaf."""
    x, dt, A, xdbc, D, h0, dy, dh = tt(*scan_inputs(5, h0_kind))

    def port(x, dt, A, xdbc, D, h0):
        return ops.selective_scan(x, dt, A, *bc(xdbc), D, h0)

    def oracle(x, dt, A, xdbc, D, h0):
        if h0 is not None and h0.dim() == 2:
            h0 = h0.expand(B, DI, N)
        return ref.selective_scan(x, dt, A, *bc(xdbc), D, h0)

    args = (x, dt, A, xdbc, D, h0)
    for g, w in zip(autograd(port, args, (dy, dh)),
                    autograd(oracle, args, (dy, dh))):
        if w is None:
            assert g is None
            continue
        torch.testing.assert_close(g, w, **ORACLE_TOL)

    x, r, i, a, h0, dhs, dh = tt(*lru_inputs(5, h0_kind))

    def lru_oracle(x, r, i, a, h0):
        return ref.rglru(x, r, i, a, None if h0 is None
                         else h0.expand(B, W))

    args = (x, r, i, a, h0)
    for g, w in zip(autograd(ops.rglru, args, (dhs, dh)),
                    autograd(lru_oracle, args, (dhs, dh))):
        if w is None:
            assert g is None
            continue
        torch.testing.assert_close(g, w, **ORACLE_TOL)


def test_bwd_rerun_ends_in_the_forward_states():
    """The plain backwards' rerun of the forward (checkpoints, then each
    chunk recomputed) gives the plain forwards' states bit for bit, seen
    through gradients that expose them: dC at the last step with a
    one-hot dy is h_final's row of that channel; dr_gate at the last step
    with a one-hot dhs holds h_{S-2}."""
    x, dt, A, xdbc, D, h0, _, _ = tt(*scan_inputs(7, "row"))
    Bm, C = bc(xdbc)
    _, hT = ss.selective_scan_torch(x, dt, A, Bm, C, D, h0)
    for d in (0, DI - 1):
        dy = torch.zeros_like(x)
        dy[:, -1, d] = 1.0
        g = ss.selective_scan_bwd_torch(x, dt, A, Bm, C, D, h0, dy)
        assert torch.equal(g[4][:, -1], hT[:, d])
    x, r, i, a, h0, _, _ = tt(*lru_inputs(7, "row"))
    hs, _ = rg.rglru_torch(x, r, i, a, h0)
    dhs = torch.zeros_like(x)
    dhs[:, -1] = 1.0
    dr = rg.rglru_bwd_torch(x, r, i, a, h0, dhs)[1][:, -1]
    at, _ = rg.gates(x, r, i, a)
    at, sr, si = at[:, -1], torch.sigmoid(r[:, -1]), torch.sigmoid(i[:, -1])
    dsda = -at / torch.sqrt(torch.clamp(1.0 - at * at, min=0.0))
    da = hs[:, -2] + (si * x[:, -1]) * dsda
    log_a = -8.0 * torch.nn.functional.softplus(-a)
    assert torch.equal(dr, da * at * log_a * (sr * (1 - sr)))


@pytest.mark.parametrize("family", ["scan", "lru"])
def test_ragged_row_gradients_equal_the_row_run_alone(family):
    """A right-padded row (dt = 0, or r_gate = -1e9, over its tail, and no
    cotangent there) gets, on its valid part, the gradients of the row
    run alone: bit for bit for the scan; within 1e-6 for the RG-LRU,
    whose gates' exp and sigmoid PyTorch takes on the CPU in vector lanes
    or in a scalar tail, which may differ in the last bit, by where an
    element falls (the kernel's are bit for bit, tests/test_torch_cuda.py)."""
    lens = [S, 9, 23]
    if family == "scan":
        x, dt, A, xdbc, D, _, dy, dh = tt(*scan_inputs(3, "none"))
        x, dt, xdbc, dy = (t.repeat(2, 1, 1)[:3] for t in (x, dt, xdbc, dy))
        dh = dh.repeat(2, 1, 1)[:3]
        h0 = torch.from_numpy(np.random.default_rng(4).standard_normal(
            (3, DI, N)).astype(np.float32))
        dtp, dyp = dt.clone(), dy.clone()
        for b, n in enumerate(lens):
            dtp[b, n:] = 0
            dyp[b, n:] = 0
        Bm, C = bc(xdbc)
        pad = ss.selective_scan_bwd_torch(x, dtp, A, Bm, C, D, h0, dyp, dh)
        for b, n in enumerate(lens):
            solo = ss.selective_scan_bwd_torch(
                x[b:b + 1, :n], dt[b:b + 1, :n], A, Bm[b:b + 1, :n],
                C[b:b + 1, :n], D, h0[b:b + 1], dy[b:b + 1, :n],
                dh[b:b + 1], need_A=False, need_D=False)
            for k in (0, 1, 3, 4):                 # dx, ddt, dB, dC
                assert torch.equal(pad[k][b, :n], solo[k][0]), (b, k)
            assert torch.equal(pad[6][b], solo[6][0]), b
    else:
        x, r, i, a, _, dhs, dh = tt(*lru_inputs(3, "none"))
        x, r, i, dhs = (t.repeat(2, 1, 1)[:3] for t in (x, r, i, dhs))
        dh = dh.repeat(2, 1)[:3]
        h0 = torch.from_numpy(np.random.default_rng(4).standard_normal(
            (3, W)).astype(np.float32))
        rp, dhp = r.clone(), dhs.clone()
        for b, n in enumerate(lens):
            rp[b, n:] = -1e9
            dhp[b, n:] = 0
        pad = rg.rglru_bwd_torch(x, rp, i, a, h0, dhp, dh, need_a=False)
        for b, n in enumerate(lens):
            solo = rg.rglru_bwd_torch(
                x[b:b + 1, :n], r[b:b + 1, :n], i[b:b + 1, :n], a,
                h0[b:b + 1], dhs[b:b + 1, :n], dh[b:b + 1], need_a=False)
            for k in range(3):                     # dx, dr, di
                torch.testing.assert_close(pad[k][b, :n], solo[k][0],
                                           rtol=1e-6, atol=1e-7)
            torch.testing.assert_close(pad[4][b], solo[4][0], rtol=1e-6,
                                       atol=1e-7)


def test_saturated_gate_is_not_finite_where_the_reference_is_not():
    """r_gate = -1e9 (a ragged row's padding): a_t = 1 and sqrt(1 - a_t²)
    has an infinite slope, so dr_gate and da_param are not finite there,
    in the port as in the reference; everything else agrees, and dx, di
    and dh0 stay finite."""
    x, r, i, a, h0, dhs, dh = lru_inputs(9, "row")
    r = r.copy()
    r[1, 30:] = -1e9                          # 10 steps x 16 channels
    want = jax_scan_vjp(LRU_REFS["xla"], (x, r, i, a), h0, (dhs, dh), None)
    got = rg.rglru_bwd_torch(*tt(x, r, i, a, h0, dhs, dh))
    for name, g, w in zip(LRU_GRADS, got, want):
        g = g.numpy()
        bad = ~np.isfinite(w)
        np.testing.assert_array_equal(~np.isfinite(g), bad, err_msg=name)
        np.testing.assert_allclose(g[~bad], w[~bad], rtol=1e-5, atol=1e-5,
                                   err_msg=name)
        if name == "dr":
            assert bad.sum() == 10 * W and bad[1, 30:].all()
        elif name == "da_param":
            assert bad.all()
        else:
            assert not bad.any(), name


# ---------------------------------------------------------------------------
# HFSL rounds from bridged JAX state
# ---------------------------------------------------------------------------

NC, BATCH, SEQ = 2, 2, 12


def small(get, arch):
    cfg = get(arch).reduced().with_(dtype="float32", vocab_size=64,
                                    d_model=64)
    if cfg.family == "hybrid":
        cfg = cfg.with_(hybrid=dataclasses.replace(cfg.hybrid, lru_width=64))
    return cfg


def seeded_state(jcfg, opt, seed=0):
    """Reference HFSL state (numpy leaves) with seeded state prompts and
    LoRA b (both init to zeros, which would zero their gradients'
    partners)."""
    st = jhfsl.init_hfsl_state(jax.random.PRNGKey(seed), jcfg, NC, opt,
                               JM.init)
    tree = jax.tree.map(np.asarray, st)
    rng = np.random.default_rng(seed)

    def fill(node):
        for k, v in node.items():
            if isinstance(v, dict):
                if k == "lora":
                    for t in v.values():
                        t["b"] = (0.1 * rng.standard_normal(
                            t["b"].shape)).astype(np.float32)
                else:
                    fill(v)
            elif k == "state0":
                node[k] = (0.3 * rng.standard_normal(v.shape)).astype(
                    np.float32)
    fill(tree["adapters_c"]["stack"])
    return tree


def lm_bank(make, stack, device):
    its = [iter(make(64, BATCH, SEQ, seed=i)) for i in range(NC)]

    def gen():
        while True:
            bs = [next(i) for i in its]
            yield {k: stack([b[k] for b in bs]) for k in bs[0]}
    if device is None:
        return jpipe.BatchBank.from_iterator(gen(), 2)
    return pipeline.BatchBank.from_iterator(gen(), 2, device=device)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b"])
def test_round_matches_jax(arch):
    """2 clusters, 2 SGD steps of lm_loss: the port's round (remat off
    and on, through the scans' autograd Functions) against the
    reference's round from the same bridged state; the adapters moved."""
    jcfg, tcfg = small(jax_config, arch), small(get_config, arch)
    assert tcfg.family in ("ssm", "hybrid")
    tree = seeded_state(jcfg, jopt.sgd(0.1))
    jrnd = jhfsl.make_hfsl_round(jcfg, jopt.sgd(0.1), JM.lm_loss, steps=2,
                                 sync_every=2, remat=False)
    js, jm = jrnd(jax.tree.map(jnp.asarray, tree),
                  lm_bank(jsyn.LMStream, jnp.stack, None).arrays, 0)
    tb = lm_bank(synthetic.LMStream, np.stack, "cpu")
    want = [np.asarray(v) for v in jax.tree.leaves(js["adapters_c"])]
    before = [np.asarray(v) for v in jax.tree.leaves(tree["adapters_c"])]
    moved = max(np.abs(w - b).max() for w, b in zip(want, before))
    assert moved > 1e-3
    for remat in (False, True):
        state = hfsl_state_from_jax(tree, "cpu")
        rnd = hfsl.make_hfsl_round(tcfg, topt.sgd(0.1), M.lm_loss, steps=2,
                                   sync_every=2, remat=remat)
        ts, tm = rnd(state, tb.arrays, 0)
        got = jax.tree.leaves(hfsl_state_to_numpy(ts)["adapters_c"])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **SGD_TOL)
        assert np.isfinite(tm["loss"].numpy()).all()
        np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                                   **SGD_TOL)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b"])
def test_train_cli_runs_the_family(arch, capsys):
    train.main(["--arch", arch, "--reduced", "--device", "cpu",
                "--clusters", "2", "--steps", "2", "--batch", "2", "--seq",
                "8", "--log-every", "2"])
    out = capsys.readouterr().out
    assert arch in out and "loss" in out


def test_hfsl_step_runs_both_families():
    """``make_hfsl_step`` (one step a call) on both families: finite
    losses, adapters moved, each leaf's gradient reached (state prompts
    and, in the hybrid, the attention layers' LoRA)."""
    for arch in ("falcon-mamba-7b", "recurrentgemma-2b"):
        cfg = small(get_config, arch)
        opt = topt.sgd(0.1)
        state = hfsl.init_hfsl_state(0, cfg, NC, opt, M.init, device="cpu")
        for leaf in tree_leaves(state["adapters_c"]):
            leaf.copy_(torch.randn(leaf.shape, generator=torch.Generator()
                                   .manual_seed(leaf.numel())) * 0.1)
        step = hfsl.make_hfsl_step(cfg, opt, M.lm_loss)
        bank = lm_bank(synthetic.LMStream, np.stack, "cpu")
        batch = {k: v[0] for k, v in bank.arrays.items()}
        out, metrics = step(state, batch)
        assert torch.isfinite(metrics["loss"]).all()
        for a, b in zip(tree_leaves(out["adapters_c"]),
                        tree_leaves(state["adapters_c"])):
            assert (a - b).abs().max() > 0, arch
