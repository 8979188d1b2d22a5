"""Roofline terms of a step on one H100 (counterpart of
``repro/launch/roofline.py``).

The reference walks a compiled step's HLO text: flops of its ``dot`` and
``convolution`` ops, HBM bytes at fusion boundaries (a fusion's operands
and results; what stays inside it is taken to stay in registers), each
Pallas kernel one such boundary. The port runs eagerly, so its
counterpart counts the aten ops that a callable dispatches
(:func:`count_costs`):

- flops of products and convolutions from ``torch.utils.flop_counter``'s
  formulas, broken down by op in ``op_flops``;
- bytes by the reference's ``_op_bytes`` rules: a view is free; a slice,
  index, copy or cat moves twice its result (an update of a slice of a
  larger buffer, twice the update); any other op reads its operands and
  writes its result;
- every call of a hand-written kernel (the functions of ``kernels/`` that
  launch one or run its plain version), and of the attention's plain
  backward, is one fused region, as an XLA fusion is: its flops, bytes
  and exponentials come from :func:`kernel_costs`, an analytic count from
  the call's shapes, and nothing inside it is counted. So the count is
  the same whether the CUDA kernel ran, the plain version on the CPU, or
  nothing at all: on ``meta`` tensors a region returns its outputs'
  shapes without running its body;
- the live bytes: each result's storage counts from the op that made it
  until it is freed, and ``peak_live_bytes`` is their largest sum.

One card has no collectives: ``collective_bytes`` is 0 and the collective
term is reported as 0 (NVLink's rate is kept for a mesh).

:func:`kernel_costs` is also each kernel's bound in ``chip_smoke.py`` and
``PERF.md``: each input read once, each output written once, the visible
keys of an attention call, the bank slots a multi-LoRA call reads.
"""
from __future__ import annotations

import contextlib
import dataclasses
import heapq
import inspect
import weakref
from collections import defaultdict
from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakTensorKeyDictionary

# NVIDIA H100 SXM data sheet: dense rates (no sparsity) at the 700 W
# power limit; f32 outside the tensor cores
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float8_e4m3fn: 1979e12, torch.float8_e5m2: 1979e12,
              torch.int8: 1979e12, torch.float32: 67e12}
HBM_BW = 3.35e12                 # B/s, 80 GB of HBM3
NVLINK_BW = 450e9                # B/s each way to the other cards of a host
# the boost clock, and exponentials per second through the
# special-function units: 16 per clock per SM (compute capability 9.0) x
# 132 SMs
SM_CLOCK = 1.98e9
PEAK_EXP = 16 * 132 * SM_CLOCK
HBM_BYTES = 80e9                 # device memory of one card


def _peak(dtype) -> float:
    return PEAK_FLOPS.get(dtype, PEAK_FLOPS[torch.float32])


# ---------------------------------------------------------------------------
# The kernels: analytic counts from the call's shapes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KernelCost:
    """Bytes moved (each input read once, each output written once),
    operations (at ``flops_dtype``'s peak) and exponentials (through the
    special-function units) of one kernel call."""
    bytes: float
    flops: float
    exps: float = 0.0
    flops_dtype: torch.dtype = torch.bfloat16

    def terms(self) -> dict:
        """Each term's least time, ms."""
        return {"bytes": self.bytes / HBM_BW * 1e3,
                "flops": self.flops / _peak(self.flops_dtype) * 1e3,
                "exp": self.exps / PEAK_EXP * 1e3}

    def bound(self) -> tuple[float, str]:
        """The least time the card could take (ms), and what bounds it:
        ``"bytes"`` or ``"operations"``."""
        t = self.terms()
        ms = max(t.values())
        return ms, "bytes" if t["bytes"] >= ms else "operations"


def _elt(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def kernel_costs(name: str, dtype: torch.dtype = torch.bfloat16,
                 **d) -> KernelCost:
    """The count of one call of kernel ``name`` from its dimensions ``d``:

    - ``lora_matmul``: M, K, N, r, bias (default True);
    - ``lora_matmul_bwd``: M, K, N, r (dA and dB written in f32);
    - ``lora_bgmv_rows`` / ``lora_bgmv_seq``: M (rows in all), K, N, r,
      slots (bank slots the ids name), ids (their count), bias;
    - ``flash_attention``: B, S, T, Hq, Hkv, D, visible (visible (query,
      key) pairs of one row);
    - ``flash_decode``: B, Hq, Hkv, D, Tc (cache slots), keys (visible
      cache keys of all rows), n_p (bank slots a row sees), n_read (bank
      slots read: 1 shared, B per row, the distinct ids of a stacked
      bank), ids (bool: the rows' slot ids are read), lse (bool: the
      partial mode's (B, Hq) f32 log-sum-exp is written);
    - ``flash_decode_paged``: B, Hq, Hkv, D, maxb (table width), keys
      (visible keys of all rows, prefix slots included);
    - ``selective_scan``: B, S, Di, N, h0 (bool), ck (checkpoint bytes
      written, default 0);
    - ``rglru_scan``: B, S, W, h0 (bool), ck;
    - ``selective_scan_bwd``: B, S, Di, N, h0 (bool);
    - ``rglru_scan_bwd``: B, S, W, h0 ("none", "shared" or "row");
    - ``attention_bwd`` (the plain backward of ``flash_attention``, no
      kernel): B, S, T, Hq, Hkv, D.

    ``dtype`` is the call's working type (its activations)."""
    e = _elt(dtype)
    f32 = torch.float32
    if name in ("lora_matmul", "lora_bgmv_rows", "lora_bgmv_seq"):
        M, K, N, r = d["M"], d["K"], d["N"], d["r"]
        bias = N if d.get("bias", True) else 0
        if name == "lora_matmul":
            nbytes = e * (M * K + K * N + K * r + r * N + bias + M * N)
        else:
            nbytes = e * (M * K + K * N + d["slots"] * (K * r + r * N)
                          + bias + M * N) + 4 * d["ids"]
        return KernelCost(nbytes, 2 * M * N * K + 2 * M * r * (K + N),
                          flops_dtype=dtype)
    if name == "lora_matmul_bwd":
        M, K, N, r = d["M"], d["K"], d["N"], d["r"]
        return KernelCost(e * (M * K + M * N + K * r + r * N)
                          + 4 * (K * r + r * N), 4 * M * r * (K + N),
                          flops_dtype=dtype)
    if name == "flash_attention":
        B, S, T, Hq, Hkv, D = (d[k] for k in ("B", "S", "T", "Hq", "Hkv",
                                              "D"))
        return KernelCost(e * (2 * B * S * Hq * D + 2 * B * T * Hkv * D)
                          + 4 * (S + T),
                          4 * D * d["visible"] * B * Hq, flops_dtype=dtype)
    if name == "flash_decode":
        B, Hq, Hkv, D, n_p = d["B"], d["Hq"], d["Hkv"], d["D"], d["n_p"]
        keys = d["keys"]
        nbytes = e * (2 * B * Hq * D + 2 * (keys + d["n_read"] * n_p)
                      * Hkv * D) + 4 * (B + B * d["Tc"]) \
            + (4 * B if d.get("ids") else 0) \
            + (4 * B * Hq if d.get("lse") else 0)
        return KernelCost(nbytes, 4 * D * (keys + B * n_p) * Hq,
                          flops_dtype=dtype)
    if name == "flash_decode_paged":
        B, Hq, Hkv, D, keys = d["B"], d["Hq"], d["Hkv"], d["D"], d["keys"]
        return KernelCost(e * (2 * B * Hq * D + 2 * keys * Hkv * D)
                          + 4 * (B + B * d["maxb"]), 4 * D * keys * Hq,
                          flops_dtype=dtype)
    if name == "selective_scan":
        B, S, Di, N = d["B"], d["S"], d["Di"], d["N"]
        exps = B * S * Di * N
        nbytes = e * (3 * B * S * Di + 2 * B * S * N) + 4 * (
            Di * N + Di + B * Di * N * (2 if d["h0"] else 1)) \
            + d.get("ck", 0)
        # per (b, t, c, n): dt*A, h*dA + (dt x)*B, acc += h*C
        return KernelCost(nbytes, 6 * exps + 3 * B * S * Di, exps, f32)
    if name == "rglru_scan":
        B, S, W = d["B"], d["S"], d["W"]
        n = B * S * W
        nbytes = 4 * e * n + 4 * W + 4 * B * W * (2 if d["h0"] else 1) \
            + d.get("ck", 0)
        # per element: through the special-function units a power of 2
        # and a reciprocal for each sigmoid, a_t's power of 2, the square
        # root; on the f32 cores a product and an add for each sigmoid, r
        # log_a, a_t², 1 - a_t², its max with 0, two products, the chain
        return KernelCost(nbytes, 12 * n, 6 * n, f32)
    if name == "selective_scan_bwd":
        B, S, Di, N = d["B"], d["S"], d["Di"], d["N"]
        n, exps = B * S * Di, B * S * Di * N
        nbytes = e * (5 * n + 4 * B * S * N) + 4 * (
            Di * N + Di + B * Di * N * (2 if d["h0"] else 1))
        # per (b, t, c, n): the forward's step for the states and the
        # reverse step (g += dy C, g B, the ddt, dB and dC terms, g dA)
        return KernelCost(nbytes, 18 * exps, exps, f32)
    if name == "rglru_scan_bwd":
        B, S, W = d["B"], d["S"], d["W"]
        n = B * S * W
        h0 = {"none": 0, "shared": W, "row": B * W}[d["h0"]]
        # mufu: the two sigmoids (2 each), a_t, the square root, 1 / s;
        # f32: the gates (8), the chain (2), the reverse step (16)
        return KernelCost(7 * e * n + 4 * (W + h0 + B * W), 26 * n, 7 * n,
                          f32)
    if name == "attention_bwd":
        B, S, T, Hq, Hkv, D = (d[k] for k in ("B", "S", "T", "Hq", "Hkv",
                                              "D"))
        n_sc = B * Hq * S * T          # f32 scores, masked ones included
        # q, k, v, dout read and dq, dk, dv written once; the score-sized
        # f32 tensors of its chunks: 13 reads and 9 writes (scores, scale,
        # mask fill, where, softmax, dp, p dp, its sum, dp - sum, ds, and
        # the three products that read ds or p); 5 products of 2 D flops
        # a score
        return KernelCost(2 * e * (2 * B * S * Hq * D + 2 * B * T * Hkv * D)
                          + 4 * 22 * n_sc, 10 * D * n_sc, flops_dtype=f32)
    raise ValueError(f"kernel_costs: unknown kernel {name!r}")


# ---------------------------------------------------------------------------
# A kernel call's dimensions from its arguments
# ---------------------------------------------------------------------------

def _ids_read(ids, value) -> tuple[int, int]:
    """(distinct ids, their count) of a multi-LoRA call; all slots when
    the ids' values are not known (``meta``)."""
    v = value(ids)
    n = ids.numel()
    return (len(set(v.reshape(-1).tolist())) if v is not None else n), n


def visible_pairs(q_pos: torch.Tensor, kv_pos: torch.Tensor,
                  window: int = 0, causal: bool = True) -> int:
    """``ref.visibility_mask(q_pos, kv_pos, window, causal).sum()``
    without the (S, T) mask: each query's keys counted on the sorted
    positions."""
    q = q_pos.cpu().long().reshape(-1)
    k = kv_pos.cpu().long().reshape(-1)
    ks = k[k >= 0].sort().values

    def upto(x):                       # keys at positions 0..x
        return torch.searchsorted(ks, x, right=True)

    hi = upto(q) if causal else upto(torch.full_like(q, 10 ** 8 - 1))
    lo = upto(q - window) if window and window > 0 else 0
    return int((hi - lo).sum()) + int((k < 0).sum()) * q.numel()


def _attn_visible(a, value) -> int:
    """Visible (query, key) pairs of one row of a prefill call; with the
    positions unknown (``meta``), queries at the last S of the T keys,
    the prefill's layout."""
    S, T = a["q"].shape[1], a["k"].shape[1]
    qp, kp = value(a["q_pos"]), value(a["kv_pos"])
    if qp is None or kp is None:
        qp, kp = torch.arange(T - S, T), torch.arange(T)
    return visible_pairs(qp, kp, a["window"], a["causal"])


def _decode_keys(a, value) -> int:
    """Visible cache keys of a decode call, all rows (every slot but the
    sentinels when the positions are not known)."""
    B, Tc = a["k"].shape[0], a["k"].shape[1]
    qp, kp = value(a["q_pos"]), value(a["kv_pos"])
    if qp is None or kp is None:
        return B * Tc
    qp = qp.cpu().long().reshape(-1, 1).expand(B, 1)
    kp = kp.cpu().long().expand(B, Tc)
    vis = (kp <= qp) if a["causal"] else (kp < 10 ** 8)
    if a["window"]:
        vis &= qp - kp < a["window"]
    return int((vis | (kp < 0)).sum())


def _paged_keys(a, value) -> int:
    """Visible keys of a paged decode call, all rows, prefix slots
    included (every table slot when the positions are not known)."""
    B, n_p = a["q"].shape[0], 0
    pk = a["prefix_k"]
    if pk is not None:
        n_p = pk.shape[-3]
    maxb, bs = a["table"].shape[1], a["k_pool"].shape[1]
    qp = value(a["q_pos"])
    cache = B * maxb * bs if qp is None else int(
        (qp.cpu().long() + 1).clamp(0, maxb * bs).sum())
    return cache + B * n_p


def _call_cost(name: str, a: dict, value) -> KernelCost:
    """kernel_costs of one call, its dimensions read from the call's
    arguments ``a`` (by parameter name)."""
    if name == "lora_matmul":
        x, w, r = a["x"], a["w"], a["a"].shape[1]
        return kernel_costs(name, x.dtype, M=x.shape[0], K=x.shape[1],
                            N=w.shape[1], r=r, bias=a["bias"] is not None)
    if name == "lora_matmul_bwd":
        x, dy = a["x"], a["dy"]
        return kernel_costs(name, x.dtype, M=x.shape[0], K=x.shape[1],
                            N=dy.shape[1], r=a["a"].shape[1])
    if name in ("lora_bgmv_rows", "lora_bgmv_seq"):
        x, w = a["x"], a["w"]
        slots, n = _ids_read(a["adapter_ids"], value)
        return kernel_costs(name, x.dtype, M=x.numel() // x.shape[-1],
                            K=x.shape[-1], N=w.shape[1], r=a["a"].shape[2],
                            slots=slots, ids=n, bias=a["bias"] is not None)
    if name == "flash_attention":
        q, k = a["q"], a["k"]
        B, S, Hq, D = q.shape
        return kernel_costs(name, q.dtype, B=B, S=S, T=k.shape[1], Hq=Hq,
                            Hkv=k.shape[2], D=D,
                            visible=_attn_visible(a, value))
    if name == "attention_bwd":
        q, k = a["q"], a["k"]
        B, S, Hq, D = q.shape
        return kernel_costs(name, q.dtype, B=B, S=S, T=k.shape[1], Hq=Hq,
                            Hkv=k.shape[2], D=D)
    if name == "flash_decode":
        q, k, pk = a["q"], a["k"], a["prefix_k"]
        B, Hq, D = q.shape
        n_p = n_read = 0
        if pk is not None:
            n_p = pk.shape[-3]
            if a["prefix_ids"] is not None:
                n_read = _ids_read(a["prefix_ids"], value)[0]
            else:
                n_read = 1 if pk.dim() == 3 else B
        return kernel_costs(name, q.dtype, B=B, Hq=Hq, Hkv=k.shape[2], D=D,
                            Tc=k.shape[1], keys=_decode_keys(a, value),
                            n_p=n_p, n_read=n_read,
                            ids=a["prefix_ids"] is not None,
                            lse=a.get("return_lse", False))
    if name == "flash_decode_paged":
        q, kp = a["q"], a["k_pool"]
        B, Hq, D = q.shape
        return kernel_costs(name, q.dtype, B=B, Hq=Hq, Hkv=kp.shape[2], D=D,
                            maxb=a["table"].shape[1],
                            keys=_paged_keys(a, value))
    ck = a.get("ck")
    ck = 0 if ck is None else ck.numel() * ck.element_size()
    x = a["x"]
    if name in ("selective_scan", "selective_scan_bwd"):
        B, S, Di = x.shape
        extra = {} if name.endswith("bwd") else {"ck": ck}
        return kernel_costs(name, x.dtype, B=B, S=S, Di=Di,
                            N=a["A"].shape[-1], h0=a["h0"] is not None,
                            **extra)
    B, S, W = x.shape
    h0 = a["h0"]
    if name == "rglru_scan":
        return kernel_costs(name, x.dtype, B=B, S=S, W=W,
                            h0=h0 is not None, ck=ck)
    kind = "none" if h0 is None else "shared" if h0.dim() == 1 or \
        h0.stride(0) == 0 else "row"
    return kernel_costs(name, x.dtype, B=B, S=S, W=W, h0=kind)


def _empty(shape, dtype, like) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=like.device)


def _meta_out(name: str, a: dict):
    """A region's outputs on ``meta``: the shapes its body would return."""
    f32 = torch.float32
    if name == "lora_matmul":
        x, w = a["x"], a["w"]
        return _empty((x.shape[0], w.shape[1]), x.dtype, x)
    if name == "lora_matmul_bwd":
        x, dy, r = a["x"], a["dy"], a["a"].shape[1]
        return (_empty((x.shape[1], r), f32, x),
                _empty((r, dy.shape[1]), f32, x))
    if name in ("lora_bgmv_rows", "lora_bgmv_seq"):
        x = a["x"]
        return _empty((*x.shape[:-1], a["w"].shape[1]), x.dtype, x)
    if name == "flash_decode" and a.get("return_lse"):
        q = a["q"]
        return torch.empty_like(q), _empty(q.shape[:2], f32, q)
    if name in ("flash_attention", "flash_decode", "flash_decode_paged"):
        return torch.empty_like(a["q"])
    if name == "attention_bwd":
        return tuple(torch.empty_like(a[k]) for k in ("q", "k", "v"))
    x = a["x"]
    if name == "selective_scan":
        B, _, Di = x.shape
        return torch.empty_like(x), _empty((B, Di, a["A"].shape[-1]), f32,
                                           x)
    if name == "rglru_scan":
        return torch.empty_like(x), _empty((x.shape[0], x.shape[2]), f32, x)
    if name == "selective_scan_bwd":
        B, _, Di = x.shape
        N = a["A"].shape[-1]
        return (torch.empty_like(x), torch.empty_like(a["dt"]),
                _empty((Di, N), f32, x) if a["need_A"] else None,
                _empty(a["Bm"].shape, a["Bm"].dtype, x),
                _empty(a["C"].shape, a["C"].dtype, x),
                _empty((Di,), f32, x) if a["need_D"] else None,
                _empty((B, Di, N), f32, x))
    B, _, W = x.shape
    return (torch.empty_like(x), torch.empty_like(a["r_gate"]),
            torch.empty_like(a["i_gate"]),
            _empty((W,), f32, x) if a["need_a"] else None,
            _empty((B, W), f32, x))


def _regions() -> list:
    """(module, attribute, kernel): the functions that launch a kernel or
    run its plain version, and the attention's plain backward (its
    query-chunk loop, counted op by op, takes minutes on ``meta`` at 4k
    tokens); :func:`count_costs` makes each call of one a region."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import lora_bgmv as bg
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import selective_scan as ss
    return [(lm, "lora_matmul", "lora_matmul"),
            (lm, "lora_matmul_bwd", "lora_matmul_bwd"),
            (bg, "lora_bgmv_rows", "lora_bgmv_rows"),
            (bg, "lora_bgmv_seq", "lora_bgmv_seq"),
            (fa, "_forward", "flash_attention"),
            (fa, "attention_bwd", "attention_bwd"),
            (fd, "flash_decode", "flash_decode"),
            (fd, "flash_decode_paged", "flash_decode_paged"),
            (ss, "_launch", "selective_scan"),
            (ss, "selective_scan_torch", "selective_scan"),
            (ss, "_launch_bwd", "selective_scan_bwd"),
            (ss, "selective_scan_bwd_torch", "selective_scan_bwd"),
            (rg, "_launch", "rglru_scan"),
            (rg, "rglru_torch", "rglru_scan"),
            (rg, "_launch_bwd", "rglru_scan_bwd"),
            (rg, "rglru_bwd_torch", "rglru_scan_bwd")]


# ---------------------------------------------------------------------------
# Counting a step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepCosts:
    """What :func:`count_costs` counted (the reference's ``HloCosts``, and
    the memory the reference reads from ``memory_analysis``)."""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    exps: float = 0.0
    collectives: dict = dataclasses.field(default_factory=dict)
    op_flops: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    op_bytes: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    flops_by_dtype: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    kernel_calls: dict = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    top_ops: list = dataclasses.field(default_factory=list)
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_live_bytes: int = 0

    @property
    def compute_s(self) -> float:
        """Each dtype's operations at its peak, and the exponentials
        through the special-function units, summed."""
        return sum(f / _peak(getattr(torch, d)) for d, f in
                   self.flops_by_dtype.items()) + self.exps / PEAK_EXP

    @property
    def peak_bytes(self) -> int:
        """Arguments and the step's largest live set together."""
        return self.argument_bytes + self.peak_live_bytes

    def asdict(self) -> dict:
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed,
                "collective_bytes": self.collective_bytes,
                "exps": self.exps, "collectives": dict(self.collectives),
                "op_flops": dict(self.op_flops),
                "op_bytes": dict(self.op_bytes),
                "flops_by_dtype": dict(self.flops_by_dtype),
                "kernel_calls": dict(self.kernel_calls),
                "argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "peak_live_bytes": self.peak_live_bytes}


TOP_OPS = 64          # the single ops by bytes that a count keeps
_SHADOW_MAX = 1 << 20  # elements of an int tensor whose values meta keeps
# ops that move twice their result (the reference's slice, gather, copy,
# concatenate, pad); a view is free
_MOVES = frozenset({"clone", "copy_", "copy", "cat", "stack", "index",
                    "index_select", "gather", "embedding", "_unsafe_index",
                    "constant_pad_nd", "repeat", "expand_copy",
                    "masked_select"})
# ops that write a slice of a larger buffer (the reference's
# dynamic-update-slice): twice the update, not the buffer
_UPDATES = {"index_put_": 2, "index_put": 2, "index_copy_": 3,
            "index_copy": 3, "slice_scatter": 1, "select_scatter": 1,
            "scatter_": 3, "scatter": 3}
# free: allocations that write nothing, and views without an alias
# annotation
_FREE = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                   "new_empty_strided", "detach", "lift_fresh", "set_",
                   "resize_", "_local_scalar_dense", "_unsafe_view"})


def _tensors(tree) -> list:
    """The tensors of an op's arguments or results (tensors, and lists,
    tuples and dicts of them, nested)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    """Bytes an op reads of ``t``: its elements, at most its storage (a
    broadcast view reads its base once)."""
    n = t.numel() * t.element_size()
    return min(n, t.untyped_storage().nbytes()) if n else 0


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and rets[0].alias_info is not None \
        and not rets[0].alias_info.is_write


class _NoShadow(Exception):
    """An op's input has no known values."""


class _NotMeta(Exception):
    """An op's input is not on ``meta``."""


def _functional(func) -> bool:
    """An op that writes no argument and returns new tensors (not
    views): its results depend on its inputs' metadata alone on
    ``meta``."""
    sch, op = func._schema, func.overloadpacket.__name__
    return not sch.is_mutable and bool(sch.returns) \
        and all(r.alias_info is None for r in sch.returns) \
        and op not in _FREE


def _sig(x):
    """A hashable signature of an op's arguments: tensors by shape,
    strides, dtype and offset (``meta`` only), the rest as they are."""
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            raise _NotMeta
        return (tuple(x.shape), x.stride(), x.dtype, x.storage_offset())
    if isinstance(x, (list, tuple)):
        return tuple(_sig(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _sig(v)) for k, v in x.items())
    return x


class _Counter(TorchDispatchMode):
    """Counts every aten op it sees into a :class:`StepCosts`; ``quiet``
    > 0 inside a region, whose body is not counted."""

    def __init__(self, costs: StepCosts):
        super().__init__()
        self.c = costs
        self.quiet = 0
        self.live = 0
        self.storages: dict[int, weakref.ref] = {}
        self.shadow = WeakTensorKeyDictionary()
        self._top: list = []
        self._seq = 0
        self.known: dict = {}      # a meta op's signature -> its results

    # -- values of small int tensors on ``meta`` ---------------------------
    def value(self, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """``t``'s values (``t`` itself off ``meta``; on ``meta`` the
        values kept for a small int tensor made from known values; else
        None)."""
        if t is None or not t.is_meta:
            return t
        return self.shadow.get(t)

    def _shadow(self, func, args, kwargs, outs) -> None:
        """Compute the values of small meta int / bool results from
        known values on the CPU (positions, ids, masks built from
        ``arange``): a region's count can then read them."""
        if not outs or not all(o.is_meta and not o.is_floating_point()
                               and o.numel() <= _SHADOW_MAX for o in outs):
            return

        def sub(x):
            if isinstance(x, torch.Tensor):
                v = self.value(x)
                if v is None:
                    raise _NoShadow
                return v
            if isinstance(x, torch.device) and x.type == "meta":
                return torch.device("cpu")
            return x

        try:
            sargs, skw = pytree.tree_map(sub, (args, kwargs))
        except _NoShadow:
            for o in outs:                     # an in-place op made it stale
                self.shadow.pop(o, None)
            return
        if "device" in skw:
            skw["device"] = torch.device("cpu")
        for o, s in zip(outs, _tensors(func(*sargs, **skw))):
            self.shadow[o] = s

    # -- live bytes ----------------------------------------------------------
    def track(self, outs, ins) -> None:
        """Count the storages of ``outs`` that no input shares and no
        earlier op made, until each is freed."""
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self.storages:
                continue
            seen.add(key)
            n = st.nbytes()
            self.live += n
            self.c.peak_live_bytes = max(self.c.peak_live_bytes, self.live)
            self.storages[key] = weakref.ref(st, self._freed(key, n))

    def _freed(self, key: int, n: int):
        def cb(_):
            self.live -= n
            self.storages.pop(key, None)
        return cb

    # -- counting ------------------------------------------------------------
    def add(self, op: str, flops: float, nbytes: float, dtype,
            shapes) -> None:
        c = self.c
        c.flops += flops
        c.bytes_accessed += nbytes
        if flops:
            c.op_flops[op] += flops
            c.flops_by_dtype[str(dtype).removeprefix("torch.")] += flops
        if nbytes:
            c.op_bytes[op] += nbytes
            self._seq += 1
            item = (nbytes, self._seq, op, shapes)
            if len(self._top) < TOP_OPS:
                heapq.heappush(self._top, item)
            elif nbytes > self._top[0][0]:
                heapq.heapreplace(self._top, item)

    def _run(self, func, args, kwargs):
        """``func(*args, **kwargs)``; a functional op on ``meta`` inputs
        whose signature (op, shapes, strides, dtypes, other arguments)
        was seen before gets empty results of the shapes it gave then
        (PyTorch's shape functions are Python, and a step repeats them
        layer after layer)."""
        if not _functional(func):
            return func(*args, **kwargs)
        try:
            key = (func, _sig(args), _sig(kwargs))
            hash(key)
        except (TypeError, _NotMeta):
            return func(*args, **kwargs)
        metas = self.known.get(key)
        if metas is None:
            out = func(*args, **kwargs)
            outs = out if isinstance(out, (tuple, list)) else (out,)
            if all(isinstance(o, torch.Tensor) and o.is_meta for o in outs):
                self.known[key] = (isinstance(out, (tuple, list)),
                                   [(o.shape, o.stride(), o.dtype)
                                    for o in outs])
            return out
        multi, metas = metas
        outs = [torch.empty_strided(sh, st, dtype=dt, device="meta")
                for sh, st, dt in metas]
        return tuple(outs) if multi else outs[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        if self.quiet:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        self._shadow(func, args, kwargs, outs)
        self.track(outs, ins)
        op = func.overloadpacket.__name__
        if _is_view(func) or op in _FREE:
            return out
        flops = 0.0
        fl = flop_registry.get(func.overloadpacket)
        if fl is not None:
            flops = float(fl(*args, **kwargs, out_val=out))
        if op in _UPDATES:
            src = args[_UPDATES[op]] if len(args) > _UPDATES[op] else None
            src = src if isinstance(src, torch.Tensor) else outs[0]
            nbytes = 2 * _nbytes(src)
        elif op in _MOVES:
            nbytes = 2 * sum(o.numel() * o.element_size() for o in outs)
        else:
            nbytes = sum(_nbytes(t) for t in ins) \
                + sum(o.numel() * o.element_size() for o in outs)
        dtype = ins[0].dtype if ins else outs[0].dtype if outs else None
        self.add(op, flops, nbytes, dtype,
                 [tuple(t.shape) for t in (ins or outs)[:3]])
        return out

    def region(self, name: str, fn: Callable, sig: inspect.Signature):
        def run(*args, **kwargs):
            if self.quiet:
                return fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            a = bound.arguments
            ins = _tensors((args, kwargs))
            self.quiet += 1
            try:
                cost = _call_cost(name, a, self.value)
                if any(t.is_meta for t in ins):
                    out = _meta_out(name, a)
                else:
                    # contiguous, as a kernel writes it (a plain version
                    # may return a view), so later ops count the same
                    out = pytree.tree_map(
                        lambda t: t.contiguous()
                        if isinstance(t, torch.Tensor) else t,
                        fn(*args, **kwargs))
            finally:
                self.quiet -= 1
            self.track(_tensors(out), ins)
            self.c.exps += cost.exps
            self.c.kernel_calls[name] += 1
            self.add(name, cost.flops, cost.bytes, cost.flops_dtype,
                     [tuple(t.shape) for t in ins[:3]])
            return out
        return run


def _storage_bytes(tree) -> int:
    seen, n = set(), 0
    for t in _tensors(tree):
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            n += st.nbytes()
    return n


@contextlib.contextmanager
def _patched(counter: _Counter):
    """Every kernel function of :func:`_regions` a region of ``counter``
    (module attributes: the callers look them up at each call)."""
    saved = []
    try:
        for mod, attr, name in _regions():
            fn = getattr(mod, attr)
            saved.append((mod, attr, fn))
            setattr(mod, attr, counter.region(name, fn,
                                              inspect.signature(fn)))
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def count_costs(fn: Callable, *args, **kwargs) -> StepCosts:
    """Run ``fn(*args, **kwargs)`` once and count what it dispatches (see
    the module's docstring). Every tensor may be on ``meta``: then no
    value is computed, only shapes. ``argument_bytes`` are the storages
    of the arguments; ``output_bytes`` those of the results that the step
    made. Not thread-safe: the kernel functions are patched for the
    call."""
    costs = StepCosts(argument_bytes=_storage_bytes((args, kwargs)))
    counter = _Counter(costs)
    with _patched(counter), counter:
        out = fn(*args, **kwargs)
    outs = _tensors(out)
    costs.output_bytes = _storage_bytes(
        [t for t in outs if t.untyped_storage()._cdata in counter.storages])
    costs.top_ops = [(b, op, shapes) for b, _, op, shapes in
                     sorted(counter._top, reverse=True)]
    return costs


# ---------------------------------------------------------------------------
# Roofline report
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    useful_ratio: float
    bottleneck: str
    collectives: dict
    memory_analysis: Optional[dict] = None

    @staticmethod
    def from_costs(costs: StepCosts, *, arch: str, shape: str, mesh: str,
                   chips: int, model_flops: float,
                   memory_analysis: Optional[dict] = None) -> "Roofline":
        ct = costs.compute_s
        mt = costs.bytes_accessed / HBM_BW
        lt = costs.collective_bytes / NVLINK_BW
        terms = {"compute": ct, "memory": mt, "collective": lt}
        useful = model_flops / max(costs.flops * chips, 1.0)
        return Roofline(
            arch=arch, shape=shape, mesh=mesh, chips=chips,
            flops_per_device=costs.flops,
            bytes_per_device=costs.bytes_accessed,
            collective_bytes_per_device=costs.collective_bytes,
            compute_s=ct, memory_s=mt, collective_s=lt,
            model_flops=model_flops, useful_ratio=useful,
            bottleneck=max(terms, key=terms.get),
            collectives=dict(costs.collectives),
            memory_analysis=memory_analysis)

    def step_s(self) -> float:
        """The least time of the step: its largest term."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


def model_flops_for(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6·N_active·D (train) / 2·N_active per token."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch          # decode: one token per seq


def mfu(model_flops: float, step_s: float,
        dtype: torch.dtype = torch.bfloat16) -> float:
    """The share of the card's peak that ``model_flops`` in ``step_s``
    seconds is."""
    return model_flops / step_s / _peak(dtype)
