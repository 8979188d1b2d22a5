"""The port's tools against the reference's, on the CPU:
``repro_torch.launch.roofline`` (the step count, the kernels' bounds, the
roofline and model flops) and ``repro_torch.launch.dryrun``.

- ``model_flops_for`` equals the reference's for every config x shape.
- ``count_costs`` of a reduced qwen2-7b step (the dry-run's smoke shape:
  one data row of 16 x 128 tokens) against
  ``repro.launch.roofline.analyze_hlo_text`` of the reference's step,
  compiled for one CPU device. The two sides count attention differently:
  XLA computes the full S x T score square, ``kernel_costs`` counts the
  visible (query, key) pairs and the port's plain attention backward its
  own products. So each side's attention term is taken out (the
  reference's: its dots over the T keys; the port's: the
  ``flash_attention`` and ``attention_bwd`` regions) and the rest is
  compared. The prefill's rest agrees exactly. The train step's rest
  agrees exactly without remat once one structural term is added: the
  reference scans its layers, and the backward of a scan computes the
  first layer's input gradient (its q, k and v products and the LoRA
  terms), which nothing reads and the port's per-layer autograd skips.
  With remat the two recompute different parts of each layer (torch's
  checkpoint stops its recompute once the backward has every tensor it
  saved; XLA's remat keeps what its dead-code pass keeps): within 5 %,
  the largest difference measured being 3.2 %.
- The dry-run's argument bytes equal the reference compile's
  ``memory_analysis().argument_size_in_bytes`` (the reference's dry-run
  and profile modules set ``XLA_FLAGS`` when imported, so the reference
  step is compiled here with the same calls, not through them).
- ``kernel_costs`` reproduces the printed bound of each row of PERF.md's
  kernel table at its main-path shape.
- The count is the same on ``meta`` as on the CPU, where the plain
  versions run.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.configs.base import InputShape as JInputShape
from repro.configs.base import get_config as jax_config
from repro.core import hfsl as jhfsl
from repro.launch import roofline as jrl
from repro.models import model as JM
from repro.optim.optimizers import adamw as jadamw
from repro.sharding import rules as R
from repro_torch.configs.base import INPUT_SHAPES, get_config, list_configs
from repro_torch.core.peft import value_and_grad
from repro_torch.kernels import ref
from repro_torch.launch import dryrun, roofline as rl
from repro_torch.models import model as M
from repro_torch.models.params import tree_leaves


@pytest.mark.parametrize("name", list_configs())
def test_model_flops_for_equals_the_reference(name):
    for shape in INPUT_SHAPES:
        assert rl.model_flops_for(get_config(name), INPUT_SHAPES[shape]) \
            == jrl.model_flops_for(jax_config(name), J_SHAPES[shape])


# ---------------------------------------------------------------------------
# count_costs against the reference's HLO count
# ---------------------------------------------------------------------------

def _reference_step(arch: str, shape_name: str, remat: bool):
    """The reference's step at the dry-run's reduced shape for one data
    row, compiled for one CPU device; its config."""
    _, _, meta = dryrun.build_step(arch, shape_name, reduced=True)
    row = meta["shape_obj"]
    cfg = dryrun.variant_for(jax_config(arch).reduced(), shape_name) \
        .with_(sliding_window=64)
    shape = JInputShape(row.name, row.seq_len, row.global_batch, row.kind)
    if row.kind == "prefill":
        args = (R.shape_structs(JM.model_spec(cfg)),
                JM.input_specs(cfg, shape))
        fn = jax.jit(lambda p, b: JM.prefill(p, b, cfg))
    elif row.kind == "train":
        opt = jadamw(1e-4)
        args = (R.shape_structs(jhfsl.hfsl_state_spec(cfg, 1, opt,
                                                      JM.model_spec)),
                jax.tree.map(lambda v: jax.ShapeDtypeStruct(
                    (1,) + v.shape, v.dtype), JM.input_specs(cfg, shape)))
        fn = jax.jit(jhfsl.make_hfsl_step(
            cfg, opt, lambda p, b, c: JM.lm_loss(p, b, c, remat=remat),
            always_sync=True))
    else:
        window = cfg.sliding_window if cfg.attn_variant == "sliding" else 0
        cache_len = min(window, shape.seq_len) if window else shape.seq_len
        args = (R.shape_structs(JM.model_spec(cfg)),
                JM.input_specs(cfg, shape)["token"],
                R.shape_structs(JM.cache_spec(cfg, shape.global_batch,
                                              cache_len)),
                jax.ShapeDtypeStruct((), np.int32))
        fn = jax.jit(lambda p, t, c, pos: JM.decode_step(p, t, c, pos, cfg))
    return fn.lower(*args).compile(), cfg


def _reference_attention_flops(text: str, T: int) -> float:
    """Flops of the reference's dots that produce or contract over the T
    keys (its attention's scores and products), trip counts applied."""
    comps, entry = jrl.parse_hlo(text)
    total = 0.0

    def walk(name, mult):
        nonlocal total
        if name not in comps:
            return
        for op in comps[name].ops:
            if op.opcode == "while":
                trip = jrl._trip_count(op)
                for b in jrl._called(op, "body"):
                    walk(b, mult * trip)
            elif op.opcode in ("fusion", "call"):
                for c in jrl._called(op, "calls") + jrl._called(op,
                                                                "to_apply"):
                    walk(c, mult)
            elif op.opcode == "dot":
                comp = comps[name]
                shapes = [op.type_str] + [
                    comp.by_name[o].type_str
                    for o in jrl._operand_names(op) if o in comp.by_name]
                if any(f",{T}]" in s or f"[{T}," in s or f",{T}," in s
                       for s in shapes):
                    total += mult * jrl._dot_flops(op, comp)

    walk(entry, 1.0)
    return total


def _port(shape_name: str, remat: bool = True):
    fn, args, meta = dryrun.build_step("qwen2-7b", shape_name, reduced=True,
                                       remat=remat)
    c = rl.count_costs(fn, *args)
    attn = c.op_flops.get("flash_attention", 0.0) + c.op_flops.get(
        "attention_bwd", 0.0)
    return c, c.flops - attn, meta["cfg"]


def _keys(cfg) -> int:
    """Keys of the reduced step's attention: the prefix slots and the 128
    tokens."""
    return cfg.peft.n_prefix + 128


def test_count_costs_of_a_prefill_matches_the_reference_hlo_count():
    port, port_rest, cfg = _port("prefill_32k")
    comp, _ = _reference_step("qwen2-7b", "prefill_32k", remat=True)
    text = comp.as_text()
    ref_costs = jrl.analyze_hlo_text(text)
    ref_attn = _reference_attention_flops(text, _keys(cfg))
    # the reference's attention is the full S x T square: 4 D flops a
    # score, every query row against every key
    assert ref_attn == 4 * cfg.head_dim_ * cfg.n_heads * 128 * _keys(cfg) \
        * cfg.n_layers
    assert port_rest == ref_costs.flops - ref_attn
    # the port's counts the visible pairs: the prefix and the causal half
    vis = 128 * cfg.peft.n_prefix + 128 * 129 // 2
    assert port.op_flops["flash_attention"] == \
        4 * cfg.head_dim_ * cfg.n_heads * vis * cfg.n_layers


def _first_layer_input_grad(cfg) -> float:
    """The reference scan's backward of layer 0's input: dx of the q, k
    and v products (M tokens) and the LoRA terms of q and v."""
    M_, d, r = 128, cfg.d_model, cfg.peft.lora_rank
    nq, nkv = cfg.n_heads * cfg.head_dim_, cfg.n_kv_heads * cfg.head_dim_
    lora = sum(2 * M_ * r * (d + n) for n in (nq, nkv))
    return 2 * M_ * d * (nq + 2 * nkv) + lora


def test_count_costs_of_a_train_step_matches_the_reference_hlo_count():
    port, port_rest, cfg = _port("train_4k", remat=False)
    comp, _ = _reference_step("qwen2-7b", "train_4k", remat=False)
    text = comp.as_text()
    ref_rest = jrl.analyze_hlo_text(text).flops \
        - _reference_attention_flops(text, _keys(cfg))
    assert port_rest + _first_layer_input_grad(cfg) == ref_rest
    assert port.kernel_calls["lora_matmul_bwd"] == 2 * cfg.n_layers

    _, port_rest, _ = _port("train_4k", remat=True)
    comp, _ = _reference_step("qwen2-7b", "train_4k", remat=True)
    text = comp.as_text()
    ref_rest = jrl.analyze_hlo_text(text).flops \
        - _reference_attention_flops(text, _keys(cfg))
    assert abs(port_rest / ref_rest - 1) < 0.05


@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
def test_dryrun_argument_bytes_equal_the_reference_memory_analysis(shape):
    comp, _ = _reference_step("qwen2-7b", shape, remat=True)
    r = dryrun.run_one("qwen2-7b", shape, reduced=True, verbose=False)
    assert r["memory_analysis"]["argument_size_in_bytes"] == \
        comp.memory_analysis().argument_size_in_bytes


# ---------------------------------------------------------------------------
# kernel_costs: PERF.md's bounds
# ---------------------------------------------------------------------------

# (row, kernel, dims, printed bound ms, printed bounding term); the decode
# rows' visible keys are those of chip_smoke.py phase 3's seeded draw
# (its record's ``visible_keys``, less the 8 x 16 prefix keys)
PERF_ROWS = [
    ("1", "lora_matmul", dict(M=8, K=3584, N=3584, r=8), "0.0077", "bytes"),
    ("1b", "lora_matmul", dict(M=4096, K=3584, N=3584, r=8), "0.107",
     "operations"),
    ("2", "flash_attention", dict(B=8, S=512, T=528, Hq=28, Hkv=4, D=128,
                                  visible=512 * 16 + 512 * 513 // 2),
     "0.020", "bytes"),
    ("2b", "flash_attention", dict(B=8, S=512, T=528, Hq=10, Hkv=1, D=256,
                                   visible=512 * 16 + 512 * 513 // 2),
     "0.014", "bytes"),
    ("3", "flash_decode", dict(B=8, Hq=28, Hkv=4, D=128, Tc=1024, keys=5148,
                               n_p=16, n_read=1), "0.0032", "bytes"),
    ("3b", "flash_decode", dict(B=8, Hq=10, Hkv=1, D=256, Tc=2048,
                                keys=8 * 2048, n_p=16, n_read=1), "0.0051",
     "bytes"),
    ("4", "flash_decode_paged", dict(B=8, Hq=28, Hkv=4, D=128, maxb=64,
                                     keys=4986), "0.0031", "bytes"),
    ("5", "lora_matmul_bwd", dict(M=1024, K=3584, N=3584, r=8), "0.0045",
     "bytes"),
    ("6", "lora_bgmv_rows", dict(M=8, K=3584, N=3584, r=8, slots=4, ids=8),
     "0.0078", "bytes"),
    ("7", "lora_bgmv_seq", dict(M=8 * 512, K=3584, N=3584, r=8, slots=4,
                                ids=8), "0.107", "operations"),
    ("8", "selective_scan", dict(B=8, S=512, Di=8192, N=16, h0=True),
     "0.128", "operations"),
    ("9", "rglru_scan", dict(B=8, S=512, W=2560, h0=True), "0.0251",
     "bytes"),
    ("10", "selective_scan_bwd", dict(B=4, S=256, Di=8192, N=16, h0=True),
     "0.0361", "operations"),
    ("11", "rglru_scan_bwd", dict(B=4, S=256, W=2560, h0="shared"),
     "0.0110", "bytes"),
    # one 2x2 rank's shapes (phase 53; 4c's keys from run 2's draw)
    ("4c", "flash_decode_paged", dict(B=4, Hq=14, Hkv=2, D=128, maxb=64,
                                      keys=2499), "0.00077", "bytes"),
    ("8d", "selective_scan", dict(B=4, S=512, Di=4096, N=16, h0=True),
     "0.0321", "operations"),
    ("8e", "selective_scan", dict(B=2, S=256, Di=8192, N=16, h0=True),
     "0.0160", "operations"),
    ("9e", "rglru_scan", dict(B=4, S=512, W=1280, h0=True), "0.0063",
     "bytes"),
    ("9f", "rglru_scan", dict(B=2, S=256, W=2560, h0=True), "0.0031",
     "bytes"),
    ("10b", "selective_scan_bwd", dict(B=2, S=256, Di=8192, N=16, h0=True),
     "0.0180", "operations"),
    ("11b", "rglru_scan_bwd", dict(B=2, S=256, W=2560, h0="row"), "0.0055",
     "bytes"),
    # one of 2 `data` shards of decode_32k's cache in the partial mode
    # (phase 54)
    ("3h", "flash_decode", dict(B=1, Hq=28, Hkv=4, D=128, Tc=16384,
                                keys=16384, n_p=16, n_read=1, lse=True),
     "0.0100", "bytes"),
]


@pytest.mark.parametrize("row,kernel,dims,printed,by", PERF_ROWS,
                         ids=[r[0] for r in PERF_ROWS])
def test_kernel_costs_reproduce_the_perf_table_bounds(row, kernel, dims,
                                                      printed, by):
    ms, bound_by = rl.kernel_costs(kernel, torch.bfloat16, **dims).bound()
    digits = len(printed.split(".")[1])
    assert f"{ms:.{digits}f}" == printed, (row, ms)
    assert bound_by == by


def test_kernel_costs_of_a_call_read_its_shapes_and_visible_keys():
    """A region's count from the call's own arguments is the table's rule
    with the call's dimensions: decode's visible keys from its positions,
    a bank's distinct ids."""
    B, T, Hq, Hkv, D = 3, 40, 4, 2, 16
    q_pos = torch.tensor([5, 17, 39], dtype=torch.int32)
    kv_pos = torch.where(torch.arange(T)[None] <= q_pos[:, None],
                         torch.arange(T)[None], 10 ** 9).to(torch.int32)
    a = dict(q=torch.zeros(B, Hq, D), k=torch.zeros(B, T, Hkv, D),
             q_pos=q_pos, kv_pos=kv_pos, window=8, causal=True,
             prefix_k=torch.zeros(4, 6, Hkv, D), prefix_ids=torch.tensor(
                 [1, 3, 1], dtype=torch.int32))
    got = rl._call_cost("flash_decode", a, lambda t: t)
    want = rl.kernel_costs("flash_decode", torch.float32, B=B, Hq=Hq,
                           Hkv=Hkv, D=D, Tc=T, keys=6 + 8 + 8, n_p=6,
                           n_read=2, ids=True)
    assert got == want


def test_visible_pairs_equals_the_visibility_mask():
    g = np.random.default_rng(0)
    for _ in range(60):
        S, T = g.integers(1, 30, 2)
        qp = torch.as_tensor(g.integers(-2, 40, S))
        kp = torch.as_tensor(g.integers(-2, 40, T))
        kp[torch.as_tensor(g.random(T) < 0.2)] = 10 ** 9
        for window in (0, 1, 7):
            for causal in (True, False):
                assert rl.visible_pairs(qp, kp, window, causal) == int(
                    ref.visibility_mask(qp, kp, window, causal).sum())


# ---------------------------------------------------------------------------
# the count on meta and on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", [
    ("qwen2-7b", "prefill_32k"), ("qwen2-7b", "decode_32k"),
    ("qwen2-7b", "train_4k"), ("recurrentgemma-2b", "train_4k"),
    ("falcon-mamba-7b", "prefill_32k"), ("granite-moe-1b-a400m", "decode_32k"),
    ("whisper-small", "prefill_32k"),
    ("llava-next-mistral-7b", "long_500k")])
def test_the_count_is_the_same_on_meta_and_on_the_cpu(arch, shape):
    counts = []
    for device in ("meta", "cpu"):
        fn, args, _ = dryrun.build_step(arch, shape, reduced=True,
                                        device=device)
        counts.append(rl.count_costs(fn, *args).asdict())
    assert counts[0] == counts[1]
    assert counts[0]["flops"] > 0 and counts[0]["peak_live_bytes"] > 0


def test_count_costs_leaves_the_kernels_unpatched_and_returns_values():
    from repro_torch.kernels import lora_matmul as lm
    before = lm.lora_matmul
    x, w = torch.randn(4, 8), torch.randn(8, 6)
    a, b = torch.randn(8, 2), torch.randn(2, 6)
    c = rl.count_costs(lambda *t: lm.lora_matmul(*t, 2.0), x, w, a, b)
    assert lm.lora_matmul is before
    assert c.kernel_calls == {"lora_matmul": 1}
    assert c.flops == rl.kernel_costs("lora_matmul", torch.float32, M=4,
                                      K=8, N=6, r=2, bias=False).flops
    assert c.output_bytes == 4 * 6 * 4


def test_every_kernel_of_the_dispatch_table_is_a_counted_region():
    """The count's regions cover ``ops._KERNELS`` (which R5 holds to the
    CUDA sources): a kernel missing here would be counted op by op, and
    on ``meta`` its plain body would run. Each region names a function of
    its module."""
    from repro_torch.kernels import ops
    regions = rl._regions()
    assert {name for *_, name in regions} == set(ops._KERNELS) \
        | {"attention_bwd"}
    for mod, attr, name in regions:
        assert callable(getattr(mod, attr)), (mod.__name__, attr)


def test_roofline_terms_on_one_card():
    c = rl.StepCosts(flops=989e12, bytes_accessed=3.35e12 * 2)
    c.flops_by_dtype["bfloat16"] = 989e12
    roof = rl.Roofline.from_costs(c, arch="a", shape="s", mesh="1", chips=1,
                                  model_flops=989e12 / 2)
    assert (roof.compute_s, roof.memory_s, roof.collective_s) == (1.0, 2.0,
                                                                  0.0)
    assert roof.bottleneck == "memory" and roof.step_s() == 2.0
    assert roof.useful_ratio == 0.5
    assert rl.mfu(989e12, 2.0) == 0.5


# ---------------------------------------------------------------------------
# the dry-run's entry point
# ---------------------------------------------------------------------------

def test_dryrun_reports_each_pair_ok_or_skipped(tmp_path, capsys):
    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "whisper-small", "--shape", "long_500k",
                        "--json", str(out)]) == 0
    assert "skipped" in out.read_text()
    r = dryrun.run_one("qwen2-7b", "decode_32k", verbose=False)
    assert r["status"] == "ok" and r["batch"] == 128 // 16
    assert r["fits_one_h100"] and r["roofline"]["bottleneck"] == "memory"
    assert r["roofline"]["collective_s"] == 0
    assert r["kernel_calls"] == {"lora_matmul": 56, "flash_decode": 28}
    assert r["mesh"] == "1 (one data row of the 16x16 mesh)"
    # --multi-pod: one card is one of the 2x16x16 mesh's 32 data rows
    m = dryrun.run_one("qwen2-7b", "decode_32k", verbose=False,
                       multi_pod=True)
    assert m["status"] == "ok" and m["batch"] == 128 // 32
    assert m["data_rows"] == 32
    assert m["mesh"] == "1 (one data row of the 2x16x16 mesh)"
    assert dryrun.run_one("qwen2-7b", "long_500k", verbose=False,
                          multi_pod=True)["batch"] == 1
    assert dryrun.main(["--multi-pod", "--arch", "qwen2-7b", "--shape",
                        "decode_32k"]) == 0


class _Production:
    """The reference's production mesh's names and sizes (all that its
    ``fit_spec`` reads)."""

    def __init__(self, multi_pod):
        self.axis_names = ("pod", "data", "model") if multi_pod else \
            ("data", "model")
        self.shape = dict(zip(self.axis_names,
                              (2, 16, 16) if multi_pod else (16, 16)))


@pytest.mark.parametrize("arch,multi_pod", [
    ("qwen2-7b", False), ("qwen2-7b", True), ("recurrentgemma-2b", False)])
def test_dryrun_counts_one_cards_share_of_the_long_decode_cache(arch,
                                                                multi_pod):
    """long_500k decodes a batch of 1 under the reference's
    ``long_decode_rules``, which put the cache's kv_seq on the data rows:
    on ``meta`` each attention cache leaf counts 1/16 of the unsplit
    cache's slots (1/32 with ``--multi-pod``), as the reference's
    ``fit_spec`` splits it; the recurrent states and the weights are
    unchanged, and the record's mesh field says so."""
    from repro_torch.models.params import tree_paths
    _, args, meta = dryrun.build_step(arch, "long_500k",
                                      multi_pod=multi_pod)
    rows = 32 if multi_pod else 16
    jcfg = dryrun.variant_for(jax_config(arch), "long_500k")
    window = jcfg.sliding_window if jcfg.attn_variant == "sliding" else 0
    whole = JM.cache_spec(jcfg, 1, min(window, 524288) if window
                          else 524288)
    lay = _Production(multi_pod)
    jleaves = dict(tree_paths(whole))
    split = 0
    for path, t in tree_paths(args[2]):
        sp = jleaves[path]
        p = R.fit_spec(R.spec_for(sp.axes, lay, R.long_decode_rules()),
                       sp.shape, lay)
        want = list(sp.shape)
        for i, e in enumerate(p):
            for a in ((e,) if isinstance(e, str) else (e or ())):
                if a != "model":         # one card is one data row
                    want[i] //= lay.shape[a]
        assert list(t.shape) == want, path
        split += want != list(sp.shape)
        if "kv_seq" in sp.axes:
            assert t.shape[2] * rows == sp.shape[2], path
    assert split > 0
    assert [tuple(x.shape) for x in tree_leaves(args[0])] == \
        [tuple(s.shape) for s in tree_leaves(M.model_spec(meta["cfg"]))]
    assert meta["mesh"].endswith(f"1/{rows} of its slots a card)")
    if arch == "qwen2-7b":
        assert args[2]["g0"]["s0"]["k"].shape[2] == 4096 // rows


def test_remat_through_a_hybrid_with_a_tail_group():
    """Each remat body recomputes its own group's sub-layers (the kinds
    are bound when the body is made, not when the backward runs it)."""
    base = get_config("recurrentgemma-2b").reduced()
    cfg = base.with_(n_layers=5, dtype="float32", hybrid=dataclasses.replace(
        base.hybrid, tail=("rglru", "rglru")))
    params = M.init(cfg, 0, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)))
    batch = {"tokens": toks, "labels": toks}
    grads = []
    for remat in (False, True):
        (_, _), g = value_and_grad(
            lambda a, b: M.lm_loss({"backbone": params["backbone"],
                                    "adapters": a}, b, cfg, remat=remat),
            params["adapters"], batch)
        grads.append(tree_leaves(g))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
