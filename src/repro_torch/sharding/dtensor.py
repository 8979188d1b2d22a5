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
  (:func:`local_rows`, :func:`rows_of`); a cache whose slot dim is split
  (``long_decode_rules``) is written by the rank that owns the slot
  (:func:`owned`);
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
    sum to it over ranks). A function of several outputs takes a tuple
    of placement lists, one per output."""
    from torch.distributed.tensor.experimental import local_map
    mesh = mesh_of(*args)
    args = [as_replicated(a, mesh) for a in args]
    several = isinstance(out_placements[0], (list, tuple))
    f = local_map(fn, out_placements=tuple(tuple(p) for p in out_placements)
                  if several else list(out_placements),
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


def local_as(x, placements) -> torch.Tensor:
    """This rank's part of DTensor ``x`` laid out as ``placements``: a
    ``redistribute`` where a mesh dim of more than one rank differs, else
    the local tensor itself (a split over one rank holds everything, so
    nothing is copied). A plain tensor is returned as it is."""
    if not is_dt(x):
        return x
    mesh, pl = x.device_mesh, tuple(placements)
    if any(mesh.size(i) > 1 and x.placements[i] != pl[i]
           for i in range(mesh.ndim)):
        x = x.redistribute(mesh, pl)
    return x.to_local()


def wrap(local: torch.Tensor, mesh, placements):
    """A local tensor that is this rank's part of ``placements`` -> the
    DTensor (no communication)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, tuple(placements),
                              run_check=False)


def rows_of(v: torch.Tensor, like, dim: int = 0) -> torch.Tensor:
    """The rows of ``v`` (a plain tensor every rank holds whole, rows at
    dim 0) that this rank holds of DTensor ``like``, whose rows are at
    ``dim``: a slice, no communication (a plain ``like``: ``v``)."""
    if not is_dt(like):
        return v
    loc, start = local_rows(like, dim)
    return v[start:start + loc.shape[dim]]


def split_dims(x, dim: int) -> list:
    """The mesh dims over which DTensor ``x``'s dim ``dim`` is split
    (major first; [] for a plain tensor)."""
    if not is_dt(x):
        return []
    from torch.distributed.tensor import Shard
    return [i for i, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim == dim]


def with_dims(placements: Sequence, dims: Sequence[int], p) -> tuple:
    """``placements`` with mesh dims ``dims`` set to ``p``."""
    out = list(placements)
    for i in dims:
        out[i] = p
    return tuple(out)


def owned(x, idx: torch.Tensor, keep: torch.Tensor, dim: int = 1):
    """A per-row write of global index ``idx[b]`` along ``x``'s dim
    ``dim`` (the rows at dim 0), on the rank that owns it: ``(local
    tensor, local index, keep)``, where this rank holds slots ``[start,
    start + n)`` of the split dim (:func:`local_rows`), the owner of slot
    ``s`` is the rank with ``start <= s < start + n`` (``s // n`` along
    the split), its local index is ``s - start``, and ``keep`` is
    cleared on every other rank. A dim that is not split: the local
    tensor with ``idx`` and ``keep`` as they are."""
    loc, start = local_rows(x, dim)
    if not split_dims(x, dim):
        return loc, idx, keep
    n = loc.shape[dim]
    keep = keep & (idx >= start) & (idx < start + n)
    return loc, (idx - start).clamp(0, n - 1), keep


class SumRanks(torch.autograd.Function):
    """Forward: the sum of ``x`` over the ranks of ``groups`` (a tuple of
    process groups, summed one after another); backward: the gradient as
    it is. Every rank's consumers of the sum hold the same values and so
    the same gradient, which each rank's term then takes once (a moe
    combine whose terms are zero but one rank's, the SL chain's end-stage
    logits)."""

    @staticmethod
    def forward(ctx, x, groups):
        import torch.distributed as dist
        y = x.clone()
        for g in groups:
            dist.all_reduce(y, group=g)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class Channels:
    """How a recurrent mixer's channel dim (``d_inner`` or ``lru``, of
    width ``width``) splits over the mesh's `model` dim: evenly when it
    divides (``split``), else every `model` rank holds every channel.
    ``lo``/``n`` name this rank's channels; :meth:`psum` sums a product
    that contracted the split channels over the `model` ranks (the
    identity when nothing is split)."""

    def __init__(self, mesh, width: int):
        self.mesh, self.md = mesh, model_dim(mesh)
        m = model_size(mesh)
        self.split = m > 1 and width % m == 0
        self.n = width // m if self.split else width
        self.lo = mesh.get_local_rank(self.md) * self.n if self.split else 0

    def placement(self, dim: int):
        """The `model` dim's placement of a tensor whose channel dim is
        ``dim``."""
        from torch.distributed.tensor import Replicate, Shard
        return Shard(dim) if self.split else Replicate()

    def weight(self, w, dim: int) -> torch.Tensor:
        """This rank's channels of weight ``w`` (channel dim ``dim``),
        gathered over every other mesh dim (its FSDP split)."""
        return local_as(w, with_model(replicated(self.mesh), self.mesh,
                                      self.placement(dim)))

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        if self.split:
            import torch.distributed as dist
            dist.all_reduce(t, group=self.mesh.get_group(self.md))
        return t


def split_like(v: torch.Tensor, like, dim: int = 0, vdim: int = 0):
    """A plain tensor every rank holds whole (rows at ``vdim``) -> a
    DTensor whose rows split as DTensor ``like``'s dim ``dim`` does, every
    other dim replicated (a slice, no communication); a plain ``like``:
    ``v``."""
    from torch.distributed.tensor import Replicate, Shard
    if not is_dt(like):
        return v
    mesh = like.device_mesh
    pl = [Shard(vdim) if isinstance(p, Shard) and p.dim == dim
          else Replicate() for p in like.placements]
    return as_replicated(v, mesh).redistribute(mesh, pl)


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
    out = fn(x.to_local(), *(rows_of(v, x) for v in vecs))
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
