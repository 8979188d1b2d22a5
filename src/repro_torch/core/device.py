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

