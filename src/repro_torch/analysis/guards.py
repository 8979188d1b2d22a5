"""Runtime compile-count sentinel: the dynamic half of the port's
tracelint (counterpart of ``repro/analysis/guards.py``).

The reference counts XLA compilations. The port runs eagerly, and what
it compiles is its CUDA kernels: :func:`compile_guard` counts each
library that ``kernels/_build.py`` builds (an ``nvcc`` run) or that the
process loads for the first time, exports the total as a telemetry
counter, and raises :class:`CompileBudgetExceeded` past a budget listing
exactly what compiled. A warm drain loads and builds nothing:

    with compile_guard(max_compiles=0):        # warm path: no compiles
        engine.run(params)

    with compile_guard(match=r"lora") as log:
        first_drain()
    print(log.count, log.names)
"""
from __future__ import annotations

import contextlib
import re
from typing import Optional

from repro_torch.core import telemetry
from repro_torch.kernels import _build


class CompileBudgetExceeded(RuntimeError):
    """More kernel compilations than the guarded region budgeted for."""


class CompileLog:
    """Mutable view yielded by :func:`compile_guard`: one name a
    compilation (``"nvcc <kernel>"`` or ``"load <kernel>"``)."""

    def __init__(self) -> None:
        self.names: list[str] = []

    @property
    def count(self) -> int:
        return len(self.names)

    def __repr__(self) -> str:
        return f"CompileLog(count={self.count}, names={self.names!r})"


@contextlib.contextmanager
def compile_guard(max_compiles: Optional[int] = None, *,
                  match: Optional[str] = None,
                  counter: str = "analysis.compiles",
                  tel: Optional[telemetry.Telemetry] = None):
    """Count kernel compilations in the block; enforce a budget.

    - ``max_compiles=None`` only counts (and exports the counter);
      ``max_compiles=N`` raises :class:`CompileBudgetExceeded` when the
      block compiles more than N. ``max_compiles=0`` is the strongest
      form: the block must run on libraries built and loaded before it.
    - ``match`` restricts counting to names matching the regex.
    - counts are exported to ``tel`` (default: the global telemetry
      registry) as counter ``analysis.compiles`` plus
      ``analysis.compile_guard_trips`` on budget violations.

    Guards nest (each counts independently)."""
    log = CompileLog()
    pat = re.compile(match) if match else None

    def note(event: str) -> None:
        if pat is None or pat.search(event):
            log.names.append(event)

    _build.LISTENERS.append(note)
    try:
        yield log
    finally:
        _build.LISTENERS.remove(note)
        t = tel if tel is not None else telemetry.get()
        t.count(counter, log.count)
    if max_compiles is not None and log.count > max_compiles:
        t.count("analysis.compile_guard_trips")
        raise CompileBudgetExceeded(
            f"{log.count} kernel compilation(s) inside a "
            f"compile_guard(max_compiles={max_compiles}) region"
            + (f" (match={match!r})" if match else "")
            + f": {log.names}")
