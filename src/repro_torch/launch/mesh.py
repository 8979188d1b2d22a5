"""Device meshes (counterpart of ``repro/launch/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group (``nccl`` on the card, ``gloo`` on the CPU),
which the caller initialises: every rank calls these functions alike.
Defined as functions, never module-level constants: importing this module
touches no process group.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Union

import torch


def _mesh(shape, axes, device: Optional[Union[str, torch.device]] = None):
    """A ``shape`` mesh named ``axes`` over the first ``prod(shape)`` ranks
    of the default process group, on ``device`` (``None`` means ``cuda``:
    no quiet fallback to the CPU)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.device import resolve_device
    n = int(math.prod(shape))
    have = dist.get_world_size() if dist.is_initialized() else 0
    # a real error, not an assert: a too-small pool must fail loudly
    if have < n:
        raise ValueError(f"need {n} devices, have {have}")
    if have != n:
        raise ValueError(f"a {tuple(shape)} mesh spans the whole process "
                         f"group: need exactly {n} ranks, have {have}")
    dev = resolve_device(device)
    return init_device_mesh(dev.type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A mesh's shape and axis names without its devices (what
    :func:`data_parallel_size` and ``sharding/rules.py`` read)."""
    shape: tuple
    mesh_dim_names: tuple


def production_layout(*, multi_pod: bool = False) -> MeshLayout:
    """16x16 = 256 devices per pod; 2 pods = 512 multi-pod."""
    if multi_pod:
        return MeshLayout((2, 16, 16), ("pod", "data", "model"))
    return MeshLayout((16, 16), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The :func:`production_layout` mesh (256 or 512 ranks)."""
    lay = production_layout(multi_pod=multi_pod)
    return _mesh(lay.shape, lay.mesh_dim_names, device)


def make_test_mesh(n_data: int = 2, n_model: int = 2, device=None):
    """A small (`data`, `model`) mesh: 4 gloo ranks on the CPU for the
    tests, one NCCL rank (1x1) on the card."""
    return _mesh((n_data, n_model), ("data", "model"), device)


def make_stage_mesh(n_stages: int, device=None):
    """The SL chain's 1-D (`stage`,) mesh (``core/sl_pipeline.py``): S
    gloo ranks on the CPU, one NCCL rank on the card; rank s is stage
    s."""
    return _mesh((n_stages,), ("stage",), device)


def data_parallel_size(mesh) -> int:
    """Product of the cluster-carrying axes ('pod' x 'data')."""
    names = tuple(mesh.mesh_dim_names)
    shape = tuple(mesh.shape)
    n = 1
    for a in ("pod", "data"):
        if a in names:
            n *= int(shape[names.index(a)])
    return n


@contextlib.contextmanager
def single_process_mesh(device=None, stage: bool = False):
    """A 1x1 (`data`, `model`) mesh for one process (with ``stage``, a
    1-stage (`stage`,) mesh): a process group of one rank (``nccl`` on
    ``cuda``, the default, ``gloo`` on the CPU) at a free ``localhost``
    port, made here and destroyed on exit. The mesh path then runs as it
    would on a rank of a larger mesh, with every split of size one.
    Raises if a process group already exists."""
    import socket

    import torch.distributed as dist

    from repro_torch.core.device import resolve_device
    dev = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("single_process_mesh: a process group already "
                           "exists; make the mesh from it instead")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    if dev.type == "cuda":
        torch.cuda.set_device(torch.cuda.current_device()
                              if dev.index is None else dev.index)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        yield make_stage_mesh(1, device=dev) if stage else \
            make_test_mesh(1, 1, device=dev)
    finally:
        dist.destroy_process_group()
