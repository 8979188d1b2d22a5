"""DTensor helpers of the mesh path.

The mesh path keeps parameters and activations as
``torch.distributed.tensor.DTensor`` and lets DTensor propagate their
placements through plain PyTorch operations. Three things step outside
that propagation, each through a helper here:

- the hand-written kernels run on the local shards of their inputs, under
  ``local_map`` with declared placements (:func:`on_shards`,
  ``kernels/ops.py``);
- per-row writes into a KV cache (a decode step's slot, a refill's rows)
  are local to a `data` rank, so they index the local shard
  (:func:`local_rows`, :func:`rows_like`);
- greedy sampling must see the whole vocabulary (:func:`whole`).

Per-row host vectors (positions, lengths, adapter ids) stay plain tensors
that every rank holds whole; :func:`as_replicated` lifts one into a
replicated DTensor where an operation meets a DTensor.
"""
from __future__ import annotations

import sys
from typing import Callable, Optional, Sequence

import torch


def is_dt(x) -> bool:
    """Whether ``x`` is a DTensor. Imports nothing: until some code has
    imported ``torch.distributed.tensor`` no DTensor can exist, so the
    paths without a mesh never pay for that import."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def mesh_of(*xs):
    """The device mesh of the first DTensor among ``xs`` (None if none)."""
    for x in xs:
        if is_dt(x):
            return x.device_mesh
    return None


def model_dim(mesh) -> Optional[int]:
    names = tuple(mesh.mesh_dim_names or ())
    return names.index("model") if "model" in names else None


def model_size(mesh) -> int:
    md = model_dim(mesh)
    return 1 if md is None else mesh.size(md)


def row_placements(x, mesh) -> list:
    """Per mesh dim, ``Shard(0)`` where ``x``'s leading (row) dim is split
    over that mesh dim, ``Replicate()`` elsewhere; the model dim is left
    to the caller (it is overwritten by :func:`with_model`)."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in range(mesh.ndim)]
    if is_dt(x):
        for i, p in enumerate(x.placements):
            if isinstance(p, Shard) and p.dim == 0:
                out[i] = Shard(0)
    return out


def with_model(rows: Sequence, mesh, p) -> tuple:
    """``rows`` with the model dim's placement set to ``p``."""
    out = list(rows)
    md = model_dim(mesh)
    if md is not None:
        out[md] = p
    return tuple(out)


def replicated(mesh) -> tuple:
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() for _ in range(mesh.ndim))


def as_replicated(x, mesh):
    """A plain tensor that every rank holds whole -> a replicated DTensor
    over ``mesh`` (no communication); a DTensor or a non-tensor is
    returned as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, torch.Tensor) or is_dt(x):
        return x
    return DTensor.from_local(x, mesh, replicated(mesh), run_check=False)


def on_shards(fn: Callable, args: Sequence, in_placements: Sequence,
              out_placements, grad_placements: Optional[Sequence] = None):
    """``fn`` on the local shards of ``args`` (``local_map`` with
    ``redistribute_inputs=True``): each tensor argument is first brought
    to its declared placements (a plain tensor counts as replicated), the
    result is a DTensor of ``out_placements``. ``grad_placements`` declares
    where an input's gradient lands (``Partial`` where the local products
    sum to it over ranks)."""
    from torch.distributed.tensor.experimental import local_map
    mesh = mesh_of(*args)
    args = [as_replicated(a, mesh) for a in args]
    f = local_map(fn, out_placements=list(out_placements),
                  in_placements=tuple(None if p is None else tuple(p)
                                      for p in in_placements),
                  in_grad_placements=None if grad_placements is None else
                  tuple(None if p is None else tuple(p)
                        for p in grad_placements),
                  device_mesh=mesh, redistribute_inputs=True)
    return f(*args)


def whole(x):
    """The whole tensor on every rank (an all-gather of a DTensor; a plain
    tensor as it is)."""
    return x.full_tensor() if is_dt(x) else x


def rows_like(v: torch.Tensor, like, dim: int = 0) -> torch.Tensor:
    """The local part of ``v`` (a plain tensor every rank holds whole,
    rows at ``dim``) that matches the rows of DTensor ``like`` held by
    this rank (``like``'s dim ``dim`` split like ``v``'s)."""
    from torch.distributed.tensor import Replicate, Shard
    if not is_dt(like):
        return v
    mesh = like.device_mesh
    pl = [Shard(dim) if isinstance(p, Shard) and p.dim == dim
          else Replicate() for p in like.placements]
    return as_replicated(v, mesh).redistribute(mesh, pl).to_local()


def local_rows(x, dim: int = 0):
    """(local tensor, first global row) of a DTensor split at ``dim``
    (a plain tensor: itself and 0). The local tensor is a view: writes
    into it land in ``x``."""
    if not is_dt(x):
        return x, 0
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    start, n = 0, x.shape[dim]
    for i, p in enumerate(x.placements):           # major mesh dim first
        if isinstance(p, Shard) and p.dim == dim:
            k = mesh.size(i)
            n //= k
            start += coord[i] * n
    return x.to_local(), start


def on_local(x, fn: Callable, *vecs):
    """``fn(x, *vecs)`` on the part of ``x`` this rank holds: a DTensor
    ``x`` runs ``fn`` on its local shard, with each plain per-row vector
    in ``vecs`` cut to the same rows (dim 0), and the result keeps ``x``'s
    placements, so ``fn`` may change only dims that are not split (a
    per-row gather along the sequence, a pad of it); a plain ``x`` runs
    ``fn`` as it is."""
    if not is_dt(x):
        return fn(x, *vecs)
    from torch.distributed.tensor import DTensor
    out = fn(x.to_local(), *(rows_like(v, x) for v in vecs))
    return DTensor.from_local(out, x.device_mesh, x.placements,
                              run_check=False)


def write_rows(old, new, src: Sequence[int], dst: Sequence[int],
               dim: int = 1) -> None:
    """``old[..., dst[i], ...] = new[..., src[i], ...]`` along ``dim`` for
    DTensor ``old`` (host row lists), in place: this rank writes only the
    rows it holds, from ``new`` gathered over the batch axes (its other
    splits brought to ``old``'s)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = old.device_mesh
    new = as_replicated(new, mesh).redistribute(
        mesh, [Replicate() if isinstance(p, Shard) and p.dim == dim else p
               for p in old.placements]).to_local()
    loc, start = local_rows(old, dim)
    pairs = [(s, d - start) for s, d in zip(src, dst)
             if start <= d < start + loc.shape[dim]]
    if pairs:
        dev = loc.device
        loc.index_copy_(dim, torch.tensor([d for _, d in pairs], device=dev),
                        new.index_select(dim, torch.tensor(
                            [s for s, _ in pairs], device=dev))
                        .to(loc.dtype))
