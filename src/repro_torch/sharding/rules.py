"""Logical-axis sharding rules (counterpart of
``repro/sharding/rules.py``), in PyTorch's SPMD idiom.

Every parameter is declared once as a ``models/params.py::ParamSpec``
(shape, dtype, logical axis names). A rule set maps a logical axis name to
a mesh axis (str), a tuple of mesh axes, or ``None`` (replicated). From a
spec and a rule set come a partition spec (:func:`spec_for`,
:func:`fit_spec`: a tuple with one entry per tensor dim, each ``None``, a
mesh axis name or a tuple of them) and from that the DTensor placement
list of a ``torch.distributed.device_mesh.DeviceMesh`` (:func:`placements`:
``Shard(i)`` on each mesh dim that tensor dim ``i`` maps onto,
``Replicate()`` elsewhere). :func:`shard` is the reference's
``with_sharding_constraint``: a ``DTensor.redistribute`` by logical names
under :func:`use_rules`, and the identity without a mesh or on a plain
tensor, so single-card paths are untouched.

A mesh here only needs ``mesh_dim_names`` and ``shape`` (or the
reference's ``axis_names`` and a ``shape`` mapping): :func:`fit_spec` and
:func:`_resolve` read nothing else.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Optional, Sequence

import torch

from repro_torch.sharding.dtensor import is_dt

# ---------------------------------------------------------------------------
# Rule sets (verbatim copies of the reference's)
# ---------------------------------------------------------------------------

# Production rules for the ('pod', 'data', 'model') mesh. On the single-pod
# ('data', 'model') mesh, the 'pod' axis name is simply absent and is dropped
# when resolving (see _resolve).
DEFAULT_RULES: dict[str, Any] = {
    # activations
    "batch": ("pod", "data"),
    "cluster": ("pod", "data"),       # HFSL client-cluster axis (core/hfsl.py)
    "seq": None,
    "attn_seq": None,                 # seq dim *inside* mixers/MLPs: always
                                      # replicated so SP reshards at entry
    "kv_seq": "model",                # KV caches shard their seq dim (heads
                                      # rarely divide 16); long_500k decode
                                      # overrides to ('pod','data')
    "kv_blocks": ("pod", "data"),     # paged KV block pool: blocks over the
                                      # batch axes
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "d_model": None,
    "act_ff": "model",
    "act_experts": "model",
    # weights
    "fsdp": ("pod", "data"),          # second weight dim, ZeRO-3 style
    "moe_fsdp": ("pod", "data"),      # expert-weight d_model dim
    "d_ff": "model",
    "experts": "model",
    "vocab": "model",
    "d_inner": "model",
    "state": None,
    "conv": None,
    "lru": "model",
    "lora_rank": None,
    "prefix": None,
    "stage": "model",                 # SL pipeline stage axis
    "frames": None,
    "slots": ("pod", "data"),         # AdapterBank tenant-slot axis
}


def long_decode_rules() -> dict[str, Any]:
    """batch=1 decode: shard the KV-cache sequence dim instead of batch."""
    r = dict(DEFAULT_RULES)
    r["batch"] = None
    r["cluster"] = None
    r["kv_seq"] = ("pod", "data")
    return r


def moe_serving_rules() -> dict[str, Any]:
    """Inference-mode MoE sharding: static expert parallelism (experts over
    `data`, the expert d_model dim over `model`) instead of training's
    FSDP of the expert weights over (pod, data)."""
    r = dict(DEFAULT_RULES)
    r["experts"] = "data"
    r["moe_fsdp"] = "model"
    r["act_experts"] = "data"
    return r


def serving_rules() -> dict[str, Any]:
    """Engine-wave serving rules (``launch/engine.py`` mesh drains).

    The ragged continuous-batching wave shards its batch (slot) dim over
    (`pod`, `data`) and head/FF dims over `model`. Unlike DEFAULT_RULES the
    KV-cache seq dim stays replicated: the wave's per-row cache-slot write
    and the in-wave refill's row write address single positions along seq,
    and stay local to a `data` rank. AdapterBank slot dims ride `data`."""
    r = dict(DEFAULT_RULES)
    r["kv_seq"] = None
    return r


def drafter_rules() -> dict[str, Any]:
    """Speculative-decoding drafter rules: weights fully replicated; the
    batch dims keep the wave sharding over (`pod`, `data`)."""
    keep = {"batch", "cluster", "slots"}
    return {k: (DEFAULT_RULES[k] if k in keep else None)
            for k in DEFAULT_RULES}


def train_rules(family: str) -> dict[str, Any]:
    """Per-family training rules: sequence parallelism over `model` for the
    attention families, the per-cluster batch over `model` for the
    recurrent ones (ssm, hybrid); the inner `batch` rule is otherwise None
    (the leading `cluster` dim carries (pod, data))."""
    r = dict(DEFAULT_RULES)
    r["batch"] = None
    if family in ("ssm", "hybrid"):
        r["batch"] = "model"
    else:
        r["seq"] = "model"
    return r


def hfsl_round_rules(family: str) -> dict[str, Any]:
    """Rules of the executed HFSL round (``core/hfsl.py::make_hfsl_round``):
    :func:`train_rules` minus sequence parallelism; the cluster dim rides
    (`pod`, `data`) and tensor parallelism runs over `model` inside each
    cluster."""
    r = train_rules(family)
    r["seq"] = None
    return r


# ---------------------------------------------------------------------------
# Active context
# ---------------------------------------------------------------------------

_ctx = threading.local()


def _get() -> tuple[Any, Optional[dict]]:
    return getattr(_ctx, "mesh", None), getattr(_ctx, "rules", None)


def active() -> tuple[Any, Optional[dict]]:
    """(mesh, rules) of the innermost :func:`use_rules` (None, None
    outside one)."""
    return _get()


@contextlib.contextmanager
def use_rules(mesh, rules: Optional[dict] = None):
    """Activate (mesh, rules) for :func:`shard` inside model code. With a
    mesh, a plain tensor that meets a DTensor counts as replicated
    (DTensor's ``implicit_replication``): per-row host vectors and
    constants are the same on every rank."""
    prev = _get()
    _ctx.mesh, _ctx.rules = mesh, (rules or DEFAULT_RULES)
    try:
        # nested under another mesh's rules: already replicating (and
        # ``implicit_replication`` turns the mode off on exit, not back)
        if mesh is None or prev[0] is not None:
            yield
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield
    finally:
        _ctx.mesh, _ctx.rules = prev


# ---------------------------------------------------------------------------
# Partition specs
# ---------------------------------------------------------------------------

class P(tuple):
    """A partition spec: one entry per tensor dim (``None``, a mesh axis
    name, or a tuple of them); trailing ``None`` entries are dropped."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def _axis_size(mesh, name: str) -> int:
    shape = mesh.shape
    if isinstance(shape, dict) or hasattr(shape, "keys"):
        return int(shape[name])
    return int(tuple(shape)[_axis_names(mesh).index(name)])


def _resolve(axes: Sequence[Optional[str]], rules: dict, mesh) -> P:
    """Logical axis names -> partition spec. Mesh axes absent from the mesh
    are dropped; a mesh axis appears at most once per spec (earlier
    logical axes win)."""
    names = _axis_names(mesh)
    out = []
    used: set = set()
    for name in axes:
        tgt = rules.get(name) if name is not None else None
        if tgt is None:
            out.append(None)
            continue
        tgt_t = (tgt,) if isinstance(tgt, str) else tuple(tgt)
        tgt_t = tuple(a for a in tgt_t if a in names and a not in used)
        used.update(tgt_t)
        out.append(tgt_t if len(tgt_t) > 1 else (tgt_t[0] if tgt_t else None))
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def spec_for(axes: Sequence[Optional[str]], mesh,
             rules: Optional[dict] = None) -> P:
    return _resolve(axes, rules or DEFAULT_RULES, mesh)


def fit_spec(p: Sequence, shape: Sequence[int], mesh) -> P:
    """Drop mesh axes whose product does not divide the dim size (tuples
    degrade ('pod', 'data') -> ('pod',) -> None), so every placement is an
    even split and a layout never changes values."""
    out = []
    used: set = set()
    for i, entry in enumerate(p):
        if entry is None or i >= len(shape):
            out.append(None if i >= len(shape) else entry)
            continue
        axes = [entry] if isinstance(entry, str) else list(entry)
        axes = [a for a in axes if a not in used]   # an axis maps once

        def prod(a):
            n = 1
            for x in a:
                n *= _axis_size(mesh, x)
            return n
        while axes and shape[i] % prod(axes) != 0:
            axes.pop()
        used.update(axes)
        out.append(tuple(axes) if len(axes) > 1
                   else (axes[0] if axes else None))
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def partition_specs(tree, mesh, rules: Optional[dict] = None) -> Any:
    """ParamSpec tree -> partition-spec tree (non-dividing axes dropped per
    :func:`fit_spec`)."""
    from repro_torch.models.params import tree_map
    r = rules or DEFAULT_RULES
    return tree_map(lambda s: fit_spec(_resolve(s.axes, r, mesh), s.shape,
                                       mesh), tree)


def dim_sharding(mesh, size: int, logical: str, *, index: int = 0,
                 rules: Optional[dict] = None) -> P:
    """The spec placing ONE dim (at ``index``, of ``size``) on its logical
    axis, every other dim replicated; non-dividing mesh axes are dropped
    (3 tenant slots on a 2-way `data` axis stay replicated)."""
    p = _resolve((None,) * index + (logical,), rules or DEFAULT_RULES, mesh)
    return fit_spec(p, (1,) * index + (int(size),), mesh)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------

def placements(spec: Sequence, mesh) -> list:
    """Partition spec -> DTensor placement list, one per mesh dim:
    ``Shard(i)`` on each mesh dim that tensor dim ``i`` maps onto (for a
    tuple entry such as ('pod', 'data'), tensor dim ``i`` is split over
    those mesh dims in the tuple's order, major first), ``Replicate()``
    elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    names = _axis_names(mesh)
    out: list = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            out[names.index(a)] = Shard(i)
    return out


def distribute(x: torch.Tensor, mesh, spec: Sequence) -> torch.Tensor:
    """A tensor that every rank holds whole -> a DTensor laid out per
    ``spec`` (each rank keeps its own shard; no communication)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements(spec, mesh))
    return distribute_tensor(x.detach(), mesh, placements(spec, mesh))


def distribute_tree(tree, specs, mesh) -> Any:
    """:func:`distribute` every leaf of ``tree`` by the matching leaf of
    the partition-spec tree ``specs``."""
    from repro_torch.models.params import tree_map
    return tree_map(lambda x, p: distribute(x, mesh, p), tree, specs)


def param_bytes(tree) -> int:
    from repro_torch.models.params import tree_leaves
    n = 0
    for s in tree_leaves(tree):
        k = 1
        for d in s.shape:
            k *= int(d)
        n += k * torch.empty((), dtype=s.dtype).element_size()
    return n


def shard(x, *axes: Optional[str]):
    """Constrain ``x``'s layout by logical names (the reference's
    ``with_sharding_constraint``): the identity without an active mesh or
    on a plain tensor; on a DTensor, ``x.redistribute`` to the placements
    of ``fit_spec(_resolve(axes))`` (an even split only). A dim of size
    one stays whole: its split over one rank changes nothing, and DTensor
    refuses to reshape a split dim of size one away (a refill of one row
    on a one-rank `data` axis)."""
    mesh, rules = _get()
    if mesh is None or not is_dt(x):
        return x
    spec = fit_spec(_resolve(axes, rules, mesh), x.shape, mesh)
    spec = P(*(None if i < x.dim() and x.shape[i] == 1 else e
               for i, e in enumerate(spec)))
    want = placements(spec, mesh)
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)
