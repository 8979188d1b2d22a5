"""Kernel dispatch layer (counterpart of ``repro/kernels/ops.py``).

Each op has two implementations:

- ``cuda``  — the hand-written Hopper kernel (``csrc/*.cu``), taken for
  every CUDA tensor;
- ``torch`` — the kernel's plain PyTorch version, taken for CPU tensors,
  and on the card only when the caller asks for it by name
  (``backend="torch"`` per call, or :func:`backend` / :func:`set_backend`
  around a region, as ``chip_smoke.py`` does to compare the two). Nothing
  selects it automatically and nothing falls back to it.

Under a device mesh (``sharding/``), an op that meets DTensors runs its
kernel on the local shards (``sharding/dtensor.py::on_shards``) with
declared placements: the LoRA products column-parallel (W and B split by
output column over `model`, x and A replicated, output split) or
row-parallel (W and A split by input row, output ``Partial``: the ranks'
``(x_r A_r) B`` and ``x_r W_r`` sum exactly to the product), attention
with its heads on `model` and its batch rows where they are; a decode
cache split over its slots stays split, each rank's partial merged with
the others'. A weight split over the batch axes (FSDP) is gathered by
the redistribution.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import lora_bgmv as bg
from repro_torch.kernels import lora_matmul as lm
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import selective_scan as ss
from repro_torch.sharding import dtensor as dt
from repro_torch.sharding.dtensor import mesh_of

_BACKEND: Optional[str] = None          # None: by tensor device
# kernel name -> (module, attribute holding its launch count)
_KERNELS = {"lora_matmul": (lm, "launches"),
            "lora_matmul_bwd": (lm, "bwd_launches"),
            "flash_attention": (fa, "launches"),
            "flash_decode": (fd, "launches"),
            "flash_decode_paged": (fd, "paged_launches"),
            "lora_bgmv_rows": (bg, "rows_launches"),
            "lora_bgmv_seq": (bg, "seq_launches"),
            "selective_scan": (ss, "launches"),
            "rglru_scan": (rg, "launches"),
            "selective_scan_bwd": (ss, "bwd_launches"),
            "rglru_scan_bwd": (rg, "bwd_launches")}


def set_backend(name: Optional[str]) -> None:
    global _BACKEND
    if name not in (None, "cuda", "torch"):
        raise ValueError(f"unknown kernel backend {name!r}: expected "
                         "None, 'cuda' or 'torch'")
    _BACKEND = name


def get_backend() -> Optional[str]:
    return _BACKEND


@contextlib.contextmanager
def backend(name: Optional[str]):
    prev = get_backend()
    set_backend(name)
    try:
        yield
    finally:
        set_backend(prev)


def _pick(b: Optional[str]) -> Optional[str]:
    return b or _BACKEND


def launch_counts() -> dict[str, int]:
    """Kernel launches per op since the last :func:`reset_launch_counts`."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _KERNELS.values():
        setattr(mod, attr, 0)


# ---------------------------------------------------------------------------
# LoRA-fused matmul (differentiable: the reference's custom VJP)
# ---------------------------------------------------------------------------

def lora_matmul(x, w, a=None, b=None, scale: float = 1.0, bias=None, *,
                backend: Optional[str] = None):
    """y = x @ w (+ scale * (x@a)@b) (+ bias). Without an adapter this is a
    plain ``torch.matmul``; with one, x must be 2-D (M, K) and the fused
    kernel runs.

    Differentiable (:class:`_LoRAMatmul`, the reference's ``_lora_vjp``):
    the backward costs ``dx`` (the forward kernel again) and ``dA``/``dB``
    (the ``lora_matmul_bwd`` kernel); ``dW = xᵀ dy`` and ``dbias`` are
    formed only when ``w`` / ``bias`` require grad (full fine-tuning),
    never under PEFT."""
    if a is None:
        y = x @ w
        return (y + bias.to(y.dtype)) if bias is not None else y
    if dt.mesh_of(x, w, a, b) is not None:
        return _lora_matmul_mesh(x, w, a, b, float(scale), bias,
                                 _pick(backend))
    return _LoRAMatmul.apply(x, w, a, b, bias, float(scale),
                             _pick(backend))


class _LoRAMatmul(torch.autograd.Function):
    """Forward and backward rules of ``repro/kernels/ops.py::_lora_vjp``
    (``_lora_fwd_rule``, ``_lora_bwd_rule``), with the same cast points."""

    @staticmethod
    def forward(ctx, x, w, a, b, bias, scale, impl):
        ctx.save_for_backward(x, w, a, b)
        ctx.scale, ctx.impl = scale, impl
        ctx.bias_dtype = None if bias is None else bias.dtype
        return lm.lora_matmul(x, w, a, b, scale, bias, backend=impl)

    @staticmethod
    def backward(ctx, dy):
        x, w, a, b = ctx.saved_tensors
        need = ctx.needs_input_grad
        dy = dy.contiguous()
        dx = dw = da = db = dbias = None
        if need[0]:
            # dx = dy Wᵀ + s (dy Bᵀ) Aᵀ: the forward kernel with (W, A, B)
            # -> (Wᵀ, Bᵀ, Aᵀ); Wᵀ is a copy of the frozen weight per call
            dx = lm.lora_matmul(dy, w.t().contiguous(), b.t().contiguous(),
                                a.t().contiguous(), ctx.scale,
                                backend=ctx.impl).to(x.dtype)
        if need[2] or need[3]:
            da, db = lm.lora_matmul_bwd(x, dy, a, b, ctx.scale,
                                        backend=ctx.impl)
            da, db = da.to(a.dtype), db.to(b.dtype)
        if need[1]:                       # full fine-tuning only
            dw = (x.t() @ dy).to(w.dtype)
        if need[4]:
            dbias = dy.float().sum(0).to(ctx.bias_dtype)
        return dx, dw, da, db, dbias, None, None


def lora_bgmv(x, w, a, b, adapter_ids, scale: float = 1.0, bias=None, *,
              backend: Optional[str] = None):
    """Multi-tenant LoRA matmul: per-row adapter selection from a stacked
    bank (serving only, no backward).

    x: (M, K) with adapter_ids (M,), or (B, S, K) with adapter_ids (B,).
    a: (n_slots, K, r); b: (n_slots, r, N); ids in [0, n_slots). Row i gets
    ``x_i @ w + scale * (x_i @ a[id_i]) @ b[id_i]`` (+ bias), bit-identical
    to :func:`lora_matmul` with that row's adapter. 3-D x with S > 1 takes
    the seq kernel (one adapter per sequence); any other x the rows
    kernel."""
    if dt.mesh_of(x, w, a, b) is not None:
        return _lora_bgmv_mesh(x, w, a, b, adapter_ids, float(scale), bias,
                               _pick(backend))
    ids = torch.as_tensor(adapter_ids, device=x.device).to(torch.int32)
    # ids address x's leading dim: rows of 2-D x, whole sequences of 3-D x
    if tuple(ids.shape) != (x.shape[0],):
        raise ValueError(
            f"adapter_ids {tuple(ids.shape)} must be ({x.shape[0]},): one id "
            f"per {'sequence' if x.dim() == 3 else 'row'} of x "
            f"{tuple(x.shape)}")
    if x.dim() == 3 and x.shape[1] > 1:
        return bg.lora_bgmv_seq(x, w, a, b, ids, float(scale), bias,
                                backend=_pick(backend))
    shp = x.shape
    y = bg.lora_bgmv_rows(x.reshape(-1, shp[-1]), w, a, b, ids,
                          float(scale), bias, backend=_pick(backend))
    return y.reshape(*shp[:-1], w.shape[-1])


# ---------------------------------------------------------------------------
# Flash attention (GQA + prefix-KV + sliding window, position-based masking)
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, q_pos, kv_pos, window: int = 0,
                    causal: bool = True, scale: Optional[float] = None,
                    backend: Optional[str] = None):
    """Online-softmax attention. Shapes as in :func:`ref.attention`."""
    if dt.mesh_of(q, k, v) is not None:
        return _attention_mesh(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                               window=window, causal=causal, scale=scale,
                               backend=_pick(backend))
    return fa.flash_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                              window=window, causal=causal, scale=scale,
                              backend=_pick(backend))


# ---------------------------------------------------------------------------
# Flash decode (single-token attention against a padded KV cache)
# ---------------------------------------------------------------------------

def _int32(x, shape, device) -> torch.Tensor:
    """x (a scalar, a list or a tensor) as a contiguous int32 tensor on
    ``device``, broadcast to ``shape`` unless that is None; a tensor that
    is all of these already is returned as it is."""
    t = torch.as_tensor(x, device=device)
    if shape is not None and t.shape != shape:
        t = t.expand(shape)
    return fd.contiguous_as(t, torch.int32)


def flash_decode(q, k, v, *, q_pos, kv_pos, prefix_k=None, prefix_v=None,
                 prefix_ids=None, window: int = 0, causal: bool = True,
                 scale: Optional[float] = None,
                 backend: Optional[str] = None, return_lse: bool = False):
    """One decode token per sequence against a KV cache (+ prefix bank).

    q: (B, Hq, D); k, v: (B, T, Hkv, D); q_pos: scalar or (B,); kv_pos:
    (T,) or (B, T) (``+1e9`` sentinel marks unwritten slots). prefix_k/v:
    (n_p, Hkv, D) or (B, n_p, Hkv, D) always-visible slots at position -1
    in front, as the TPU kernel route's concatenation puts them
    (``repro/kernels/ops.py::flash_decode``), or a multi-tenant bank's
    stacked (n_slots, n_p, Hkv, D) slots with ``prefix_ids`` (B,) naming
    each row's slot: the bf16 kernel reads them in place, the f32 kernel
    and the plain version (the CPU path) after :func:`fd.with_prefix`
    concatenates them. Returns (B, Hq, D); with ``return_lse`` (no mesh)
    ``(out, lse)``, the partial that :func:`fd.combine` merges.

    On a mesh whose cache splits its slot dim (``long_decode_rules``:
    ``kv_seq`` on (`pod`, `data`)) each rank attends its own slots and the
    ranks merge their partials (:func:`_decode_mesh`)."""
    if dt.mesh_of(q, k, v, prefix_k, prefix_v) is not None:
        if return_lse:
            raise ValueError("flash_decode: return_lse takes local tensors, "
                             "not a mesh")
        return _decode_mesh(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                            prefix_k=prefix_k, prefix_v=prefix_v,
                            prefix_ids=prefix_ids, window=window,
                            causal=causal, scale=scale,
                            backend=_pick(backend))
    B, T = k.shape[0], k.shape[1]
    qp = _int32(q_pos, (B,), q.device)
    kp = _int32(kv_pos, (B, T), q.device)
    if prefix_k is not None:
        prefix_k = fd.contiguous_as(prefix_k, k.dtype)
        prefix_v = fd.contiguous_as(prefix_v, v.dtype)
    if prefix_ids is not None:
        prefix_ids = _int32(prefix_ids, (B,), q.device)
    return fd.flash_decode(q.contiguous(), k, v, q_pos=qp, kv_pos=kp,
                           window=window,
                           causal=causal, scale=scale, prefix_k=prefix_k,
                           prefix_v=prefix_v, prefix_ids=prefix_ids,
                           backend=_pick(backend), return_lse=return_lse)


def flash_decode_paged(q, k_pool, v_pool, table, *, q_pos, prefix_k=None,
                       prefix_v=None, prefix_ids=None,
                       scale: Optional[float] = None,
                       backend: Optional[str] = None):
    """One decode token per sequence against a paged block-pool cache.

    q: (B, Hq, D); k_pool, v_pool: (n_blocks, bs, Hkv, D); table:
    (B, max_blocks) int — row b's logical token ``t`` lives at
    ``pool[table[b, t // bs], t % bs]``, so positions are implicit and
    visibility is causal; entries >= n_blocks are the sentinel and clamp
    into the pool. prefix_k/v: (n_p, Hkv, D) or (B, n_p, Hkv, D)
    always-visible slots in front, or stacked (n_slots, n_p, Hkv, D) with
    ``prefix_ids`` (B,), as :func:`flash_decode` takes them. The same function as the reference's
    ``ops.flash_decode_paged`` with or without a prefix bank; for CUDA
    tensors it is always the paged kernel (no gather into a dense copy).
    Returns (B, Hq, D)."""
    if dt.mesh_of(q, k_pool, v_pool, prefix_k, prefix_v) is not None:
        return _paged_mesh(q, k_pool, v_pool, table, q_pos=q_pos,
                           prefix_k=prefix_k, prefix_v=prefix_v,
                           prefix_ids=prefix_ids, scale=scale,
                           backend=_pick(backend))
    B = q.shape[0]
    qp = _int32(q_pos, (B,), q.device)
    if prefix_k is not None:
        prefix_k = fd.contiguous_as(prefix_k, k_pool.dtype)
        prefix_v = fd.contiguous_as(prefix_v, v_pool.dtype)
    if prefix_ids is not None:
        prefix_ids = _int32(prefix_ids, (B,), q.device)
    return fd.flash_decode_paged(q.contiguous(), k_pool, v_pool,
                                 _int32(table, None, q.device),
                                 q_pos=qp, prefix_k=prefix_k,
                                 prefix_v=prefix_v, prefix_ids=prefix_ids,
                                 scale=scale, backend=_pick(backend))


# ---------------------------------------------------------------------------
# Under a device mesh: the kernels above on local shards
# ---------------------------------------------------------------------------

def _lora_layout(w, mesh):
    """How a LoRA product splits over `model`, read from W's placement:
    ``col`` (W by output column), ``row`` (by input row) or ``rep``."""
    from torch.distributed.tensor import Shard
    md = dt.model_dim(mesh)
    p = w.placements[md] if md is not None and dt.is_dt(w) else None
    if isinstance(p, Shard):
        return "row" if p.dim == 0 else "col"
    return "rep"


def _lora_placements(x, w, mesh, slot: int):
    """(x, w, a, b, bias, out) placements of a LoRA product and the
    gradient placements of (x, w, a, b, bias); ``slot`` is 1 for a bank's
    slot-leading A and B (multi-LoRA), else 0."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    R, S = Replicate(), Shard
    rows = dt.row_placements(x, mesh)
    # a weight's gradient sums over the batch ranks its rows were split on
    wgrad = [Partial() if isinstance(p, Shard) else R for p in rows]
    rep = [R] * mesh.ndim
    last = x.dim() - 1
    kind = _lora_layout(w, mesh)
    if kind == "col":
        m = {"x": R, "w": S(1), "a": R, "b": S(1 + slot), "bias": S(0),
             "out": S(last)}
        g = {"x": Partial(), "a": Partial(), "b": S(1 + slot), "w": S(1),
             "bias": S(0)}
    elif kind == "row":
        m = {"x": S(last), "w": S(0), "a": S(slot), "b": R, "bias": R,
             "out": Partial()}
        g = {"x": S(last), "a": S(slot), "b": Partial(), "w": S(0),
             "bias": Partial()}
    else:
        m = {k: R for k in ("x", "w", "a", "b", "bias", "out")}
        g = {k: R for k in ("x", "w", "a", "b", "bias")}
    pl = {k: dt.with_model(rows if k in ("x", "out") else rep, mesh, v)
          for k, v in m.items()}
    gp = {k: dt.with_model(rows if k == "x" else wgrad, mesh, v)
          for k, v in g.items()}
    return pl, gp, kind


def _lora_matmul_mesh(x, w, a, b, scale, bias, impl):
    mesh = dt.mesh_of(x, w, a, b)
    pl, gp, kind = _lora_placements(x, w, mesh, 0)
    args = [x, w, a, b] + ([bias] if bias is not None and kind != "row"
                           else [])
    names = ["x", "w", "a", "b", "bias"][:len(args)]

    def fn(x_, w_, a_, b_, bias_=None):
        return _LoRAMatmul.apply(x_, w_, a_, b_, bias_, scale, impl)

    y = dt.on_shards(fn, args, [pl[k] for k in names], pl["out"],
                     [gp[k] for k in names])
    return y + bias.to(y.dtype) if bias is not None and kind == "row" \
        else y


def _lora_bgmv_mesh(x, w, a, b, adapter_ids, scale, bias, impl):
    mesh = dt.mesh_of(x, w, a, b)
    pl, _, kind = _lora_placements(x, w, mesh, 1)
    ids = torch.as_tensor(dt.whole(adapter_ids), device=x.device) \
        .to(torch.int32)
    id_pl = dt.with_model(dt.row_placements(x, mesh), mesh,
                          dt.replicated(mesh)[0])
    args = [x, w, a, b, ids] + ([bias] if bias is not None and kind != "row"
                                else [])
    names = ["x", "w", "a", "b"]
    in_pl = [pl[k] for k in names] + [id_pl] + \
        ([pl["bias"]] if len(args) == 6 else [])

    def fn(x_, w_, a_, b_, ids_, bias_=None):
        return lora_bgmv(x_, w_, a_, b_, ids_, scale, bias_, backend=impl)

    y = dt.on_shards(fn, args, in_pl, pl["out"])
    return y + bias.to(y.dtype) if bias is not None and kind == "row" \
        else y


def _head_split(mesh, hq: int, hkv: int):
    """(q, kv) placements of the head dim over `model`: q's heads split
    when they divide; kv's when they divide too, else kv stays replicated
    and each rank slices the kv heads of its own q heads (:func:`_kv_of`)."""
    m = dt.model_size(mesh)
    q_split = hq % m == 0 and m > 1
    kv_split = q_split and hkv % m == 0
    return q_split, kv_split


def _kv_of(mesh, hq: int, hkv: int, hq_local: int, *kvs, dim: int):
    """The kv heads (at ``dim``) that this rank's ``hq_local`` q heads
    read, when the kv heads are replicated and the q heads split (GQA):
    q head ``h`` reads kv head ``h // (hq // hkv)``."""
    g = hq // hkv
    first = mesh.get_local_rank(dt.model_dim(mesh)) * hq_local
    last = first + hq_local - 1
    lo, hi = first // g, last // g + 1
    if hq_local % (hi - lo):
        raise ValueError(
            f"{hq_local} local q heads of {hq} do not share their kv heads "
            f"evenly ({hkv} kv heads): the head split is not a GQA split")
    return [None if t is None else t.narrow(dim, lo, hi - lo) for t in kvs]


def _attention_mesh(q, k, v, *, q_pos, kv_pos, window, causal, scale,
                    backend):
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = dt.mesh_of(q, k, v)
    hq, hkv = q.shape[2], k.shape[2]
    q_split, kv_split = _head_split(mesh, hq, hkv)
    rows = dt.row_placements(q, mesh)
    R = Replicate()
    qp = dt.with_model(rows, mesh, Shard(2) if q_split else R)
    kp = dt.with_model(rows, mesh, Shard(2) if kv_split else R)
    kg = dt.with_model(rows, mesh, Partial() if q_split and not kv_split
                       else (Shard(2) if kv_split else R))
    rep = dt.replicated(mesh)

    def fn(q_, k_, v_, qpos_, kvpos_):
        if q_split and not kv_split:
            k_, v_ = _kv_of(mesh, hq, hkv, q_.shape[2], k_, v_, dim=2)
        return fa.flash_attention(q_, k_, v_, q_pos=qpos_, kv_pos=kvpos_,
                                  window=window, causal=causal, scale=scale,
                                  backend=backend)

    return dt.on_shards(fn, [q, k, v, q_pos, kv_pos],
                        [qp, kp, kp, rep, rep], qp,
                        [qp, kg, kg, rep, rep])


def _prefix_args(mesh, rows, kv_split, B, dev, prefix_k, prefix_v,
                 prefix_ids):
    """(args, placements, kv-head dim) of a decode's prefix bank on a
    mesh: a bank's stacked slots with ``prefix_ids`` (each rank reads its
    rows' slots by id), one set per row (split like the rows) or one
    shared set; the kv heads split over `model` with the cache's."""
    from torch.distributed.tensor import Replicate, Shard
    R = Replicate()
    rep = dt.replicated(mesh)
    row_int = dt.with_model(rows, mesh, R)
    if prefix_k is None:
        return [], [], None
    if prefix_ids is not None:                      # a bank's stacked slots
        hd_dim, pre = 2, dt.with_model(rep, mesh, R)
        extra = [_int32(dt.whole(prefix_ids), (B,), dev)]
    elif prefix_k.dim() == 4:                       # one set per row
        hd_dim, pre, extra = 2, dt.with_model(rows, mesh, R), []
    else:                                           # one shared set
        hd_dim, pre, extra = 1, dt.with_model(rep, mesh, R), []
    ppl = dt.with_model(pre, mesh, Shard(hd_dim) if kv_split else R)
    return ([prefix_k, prefix_v] + extra,
            [ppl, ppl] + [row_int] * len(extra), hd_dim)


def _decode_mesh(q, k, v, *, q_pos, kv_pos, prefix_k, prefix_v, prefix_ids,
                 window, causal, scale, backend):
    """The dense decode kernel on this rank's rows and `model` heads. A
    cache whose slot dim is split (over `data`, and `pod`: the mesh dims
    where k is ``Shard(1)``) stays split: each rank attends its own
    slots, giving its partial (``return_lse``), and the ranks merge them
    (:func:`_merge_ranks`). The prefix bank, replicated, is read by the
    ranks at slot coordinate 0 only, so it counts once."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = dt.mesh_of(q, k, v, prefix_k, prefix_v)
    B, T = k.shape[0], k.shape[1]
    hq, hkv = q.shape[1], k.shape[2]
    q_split, kv_split = _head_split(mesh, hq, hkv)
    rows = dt.row_placements(q, mesh)
    R = Replicate()
    qp = dt.with_model(rows, mesh, Shard(1) if q_split else R)
    kp = dt.with_model(rows, mesh, Shard(2) if kv_split else R)
    row_int = dt.with_model(rows, mesh, R)
    kpos_pl = row_int
    slot_dims = dt.split_dims(k, 1)
    if slot_dims:
        kp = dt.with_dims(kp, slot_dims, Shard(1))
        kpos_pl = dt.with_dims(row_int, slot_dims, Shard(1))
    dev = q.device
    pargs, ppl, hd_dim = _prefix_args(mesh, rows, kv_split, B, dev,
                                      prefix_k, prefix_v, prefix_ids)
    args = [q, k, v, _int32(dt.whole(q_pos), (B,), dev),
            kv_pos if dt.is_dt(kv_pos) else _int32(kv_pos, (B, T), dev)] \
        + pargs
    in_pl = [qp, kp, kp, row_int, kpos_pl] + ppl
    groups = [mesh.get_group(i) for i in slot_dims]
    first = all(mesh.get_local_rank(i) == 0 for i in slot_dims)

    def fn(q_, k_, v_, qpos_, kvpos_, pk_=None, pv_=None, ids_=None):
        if q_split and not kv_split:
            k_, v_ = _kv_of(mesh, hq, hkv, q_.shape[1], k_, v_, dim=2)
            if pk_ is not None:
                pk_, pv_ = _kv_of(mesh, hq, hkv, q_.shape[1], pk_, pv_,
                                  dim=hd_dim)
        if not first:                           # the bank counts once
            pk_ = pv_ = ids_ = None
        out = flash_decode(q_, k_, v_, q_pos=qpos_, kv_pos=kvpos_,
                           prefix_k=pk_, prefix_v=pv_, prefix_ids=ids_,
                           window=window, causal=causal, scale=scale,
                           backend=backend, return_lse=bool(slot_dims))
        return _merge_ranks(*out, groups) if slot_dims else out

    return dt.on_shards(fn, args, in_pl, qp)


def _merge_ranks(out, lse, groups):
    """:func:`fd.combine` over the ranks of ``groups`` (each rank's
    partial of its own slots): ``lse* = log sum_r exp(lse_r)`` from an
    all-reduce of the max and one of the sum, then ``o = sum_r exp(lse_r
    - lse*) o_r`` (f32) by an all-reduce. Over one rank the weights are
    exactly 1 and the output is the partial's own bits."""
    import torch.distributed as dist

    def reduce(t, op):
        for g in groups:
            dist.all_reduce(t, op=op, group=g)
        return t

    m = reduce(lse.clone(), dist.ReduceOp.MAX)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    star = m + torch.log(reduce(torch.exp(lse - m), dist.ReduceOp.SUM))
    o = reduce(fd.merge_weights(lse, star)[..., None] * out.float(),
               dist.ReduceOp.SUM)
    return o.to(out.dtype)


def _paged_mesh(q, k_pool, v_pool, table, *, q_pos, prefix_k, prefix_v,
                prefix_ids, scale, backend):
    """The paged kernel on this rank's rows and `model` heads. A row's
    table may name any block of the pool, whose blocks are split over the
    batch axes, so the pool is gathered whole over them first (its kv
    heads stay split); the table and positions are cut to the rows."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = dt.mesh_of(q, k_pool, v_pool, prefix_k, prefix_v)
    B = q.shape[0]
    hq, hkv = q.shape[1], k_pool.shape[2]
    q_split, kv_split = _head_split(mesh, hq, hkv)
    rows = dt.row_placements(q, mesh)
    R = Replicate()
    qp = dt.with_model(rows, mesh, Shard(1) if q_split else R)
    poolp = dt.with_model(dt.replicated(mesh), mesh,
                          Shard(2) if kv_split else R)
    row_int = dt.with_model(rows, mesh, R)
    dev = q.device
    pargs, ppl, hd_dim = _prefix_args(mesh, rows, kv_split, B, dev,
                                      prefix_k, prefix_v, prefix_ids)
    tbl = table if dt.is_dt(table) else _int32(table, None, dev)
    args = [q, k_pool, v_pool, tbl,
            _int32(dt.whole(q_pos), (B,), dev)] + pargs
    in_pl = [qp, poolp, poolp, row_int, row_int] + ppl

    def fn(q_, kp_, vp_, tbl_, qpos_, pk_=None, pv_=None, ids_=None):
        if q_split and not kv_split:
            kp_, vp_ = _kv_of(mesh, hq, hkv, q_.shape[1], kp_, vp_, dim=2)
            if pk_ is not None:
                pk_, pv_ = _kv_of(mesh, hq, hkv, q_.shape[1], pk_, pv_,
                                  dim=hd_dim)
        return flash_decode_paged(q_, kp_, vp_, tbl_, q_pos=qpos_,
                                  prefix_k=pk_, prefix_v=pv_,
                                  prefix_ids=ids_, scale=scale,
                                  backend=backend)

    return dt.on_shards(fn, args, in_pl, qp)


def _scan_placements(x, mesh, chan_dim: int):
    """Placements of a scan's operands on a mesh, read from ``x`` (B, S,
    C): its rows split where x's are (the batch axes when serving, `model`
    too for a recurrent family's training), its channels over `model`
    where x's last dim is (serving). Returns a function of (kind, channel
    dim of that operand) -> (placements, gradient placements); kinds are
    ``rows`` (a per-row operand), ``chan`` (a per-channel one, shared by
    the rows) and ``both``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    md = dt.model_dim(mesh)
    R = Replicate()
    row = [dt.is_dt(x) and x.placements[i] == Shard(0)
           for i in range(mesh.ndim)]
    chan = (dt.is_dt(x) and md is not None and not row[md]
            and x.placements[md] == Shard(chan_dim))

    def pl(kind: str, cdim: Optional[int] = None):
        p, g = [], []
        for i in range(mesh.ndim):
            if row[i]:                         # rows split on this mesh dim
                p.append(Shard(0) if kind != "chan" else R)
                g.append(Shard(0) if kind != "chan" else Partial())
            elif i == md and chan:             # channels split on `model`
                if cdim is None:               # contracts the channels
                    p.append(R)
                    g.append(Partial())
                else:
                    p.append(Shard(cdim))
                    g.append(Shard(cdim))
            else:
                p.append(R)
                g.append(R)
        return tuple(p), tuple(g)
    return pl


def _scan_mesh(kernel, args: list, kinds: list, outs: list):
    """A scan kernel (``kernel(*local args)``) on this rank's rows and
    channels; ``kinds`` (kind, channel dim) per argument and ``outs`` per
    output as :func:`_scan_placements` takes them. Differentiable: each
    input's gradient lands where :func:`_scan_placements` says."""
    x = args[0]
    mesh = dt.mesh_of(*args)
    pl = _scan_placements(x, mesh, x.dim() - 1)
    in_pl = [pl(*k)[0] for k in kinds]
    g_pl = [pl(*k)[1] for k in kinds]
    out_pl = tuple(pl(*o)[0] for o in outs)
    return dt.on_shards(kernel, args, in_pl, out_pl, g_pl)


# ---------------------------------------------------------------------------
# Selective scan (Mamba-1)
# ---------------------------------------------------------------------------

def selective_scan(x, dt, A, Bm, C, D, h0=None, *,
                   backend: Optional[str] = None):
    """The Mamba-1 scan over a sequence (shapes as
    :func:`ref.selective_scan`). The reference's XLA-only algorithms
    (``_selective_scan_assoc``, ``set_ssm_xla_impl``) compute the same
    function and are covered by the plain version. Differentiable: the
    backward is the ``selective_scan_bwd`` kernel on the card (the
    reference differentiates the scan through XLA); its oracle is
    autograd through :func:`ref.selective_scan`.

    On a mesh the kernel runs on each rank's rows and channels
    (:func:`_scan_mesh`): serving splits the channels (``d_inner``) over
    `model`, which the scan keeps apart, and a recurrent family's
    training round splits the rows over `model`."""
    impl = _pick(backend)
    if mesh_of(x, A, Bm, h0) is not None:       # (`dt` is the step here)
        args = [x, dt, A, Bm, C, D] + ([] if h0 is None else [h0])
        kinds = [("both", 2), ("both", 2), ("chan", 0), ("rows", None),
                 ("rows", None), ("chan", 0)]
        if h0 is not None:
            kinds.append(("both", 1) if h0.dim() == 3 else ("chan", 0))
        return _scan_mesh(
            lambda *a: ss.selective_scan(*a, backend=impl), args, kinds,
            [("both", 2), ("both", 1)])
    return ss.selective_scan(x, dt, A, Bm, C, D, h0, backend=impl)


def selective_scan_step(x, dt, A, Bm, C, D, h):
    """One decode step, torch operations (the reference has no kernel for
    it). x, dt: (B, Di); Bm, C: (B, N); h: (B, Di, N). Returns (y (B, Di)
    in x.dtype, h f32)."""
    dtf, xf = dt.float(), x.float()
    dA = torch.exp(dtf[..., None] * A.float())
    dBx = dtf[..., None] * Bm.float()[:, None, :] * xf[..., None]
    h = h.float() * dA + dBx
    y = torch.einsum("bdn,bn->bd", h, C.float()) + D.float() * xf
    return y.to(x.dtype), h


# ---------------------------------------------------------------------------
# RG-LRU (recurrentgemma)
# ---------------------------------------------------------------------------

def rglru(x, r_gate, i_gate, a_param, h0=None, *, c: float = 8.0,
          backend: Optional[str] = None):
    """The RG-LRU recurrence over a sequence (shapes as :func:`ref.rglru`;
    h0 may also be one shared (W,) state). The reference's XLA-only
    ``_rglru_assoc`` computes the same function and is covered by the
    plain version. Differentiable: the backward is the ``rglru_scan_bwd``
    kernel on the card; its oracle is autograd through
    :func:`ref.rglru`. On a mesh the kernel runs on each rank's rows and
    channels (``lru``), as :func:`selective_scan` does."""
    impl = _pick(backend)
    if dt.mesh_of(x, r_gate, a_param, h0) is not None:
        args = [x, r_gate, i_gate, a_param] + ([] if h0 is None else [h0])
        kinds = [("both", 2), ("both", 2), ("both", 2), ("chan", 0)]
        if h0 is not None:
            kinds.append(("both", 1) if h0.dim() == 2 else ("chan", 0))
        return _scan_mesh(
            lambda *a: rg.rglru(*a, c=c, backend=impl), args, kinds,
            [("both", 2), ("both", 1)])
    return rg.rglru(x, r_gate, i_gate, a_param, h0, c=c, backend=impl)


def rglru_step(x, r_gate, i_gate, a_param, h, c: float = 8.0):
    """One decode step, torch operations (the reference has no kernel for
    it): the plain version's gates and one link of its chain; all (B, W).
    Returns (y (B, W) in x.dtype, h f32)."""
    a, u = rg.gates(x, r_gate, i_gate, a_param, c)
    h = a * h.float() + u
    return h.to(x.dtype), h
