"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

The layout mirrors ``src/repro`` (``configs/``, ``core/``, ``data/``,
``kernels/``, ``models/``, ``optim/``, ``launch/``, ``checkpoint/``) so
each module's counterpart is
found under the same name. The port imports ``torch`` and numpy, never
``jax`` and nothing of ``repro``; what it needs from the reference it keeps
as its own copy. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
