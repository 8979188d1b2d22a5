"""tracelint for the port: static analysis + a runtime compile guard
(counterpart of ``repro/analysis``).

The port's serving and training paths rest on contracts that are
invisible to the type checker and easy to regress in review:

- the drain loop syncs the host once per segment — a stray ``.item()``,
  ``.cpu()`` or ``int(tensor)`` inside it turns a segment into a round
  trip per token (R2, on ``# tracelint: hot`` functions);
- hot-path clocks are ``time.perf_counter()``, never wall clocks (R3);
- library code raises real exceptions, not bare ``assert``s (R4);
- every CUDA kernel keeps its ``ops.py`` dispatch (counted in
  ``ops._KERNELS``, its plain version selectable through ``_pick``) and
  its ``ref.py`` oracle (R5);
- every ``lru_cache`` fused-fn factory declares its cache key (R1, as
  the reference has it).

``python -m repro_torch.analysis`` machine-checks them over
``src/repro_torch``, ``tests/test_torch_*.py``, ``chip_smoke.py`` and
``examples/torch_*.py`` and exits nonzero on any finding not in the
checked-in baseline (``scripts/lint_torch_baseline.txt``, empty).

The runtime half, :mod:`repro_torch.analysis.guards`, counts the CUDA
libraries ``kernels/_build.py`` builds or loads: :func:`compile_guard`
raises :class:`CompileBudgetExceeded` past a budget, so a warm drain can
be held to compile nothing.
"""
from repro_torch.analysis.base import Finding, SourceFile

__all__ = ["Finding", "SourceFile", "compile_guard", "CompileBudgetExceeded",
           "CompileLog"]


def __getattr__(name):
    # guards imports torch; keep the lint CLI import-light by loading the
    # runtime half only when asked for
    if name in ("compile_guard", "CompileBudgetExceeded", "CompileLog"):
        from repro_torch.analysis import guards
        return getattr(guards, name)
    raise AttributeError(name)
