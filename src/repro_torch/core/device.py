"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU: with no
GPU and no explicit ``"cpu"`` they raise instead of quietly falling back.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``; a CUDA device must exist for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev


def unported(what: str, item: str) -> NotImplementedError:
    """The error every not-yet-ported feature raises, naming the ROADMAP
    item that will port it: "later, multi-GPU sharding" (``ROADMAP.md``
    1-E2), the mesh modes still to come: paged and speculative serving on
    a mesh, the moe family's expert parallelism, the ssm and hybrid
    families' rules (and every family but dense in a mesh round),
    ``long_decode_rules`` and the SL chain's `stage` axis. Every model
    family and the dense main path on a mesh are ported."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP: {item})")
