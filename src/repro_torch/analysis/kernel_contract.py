"""R5 — the kernel / dispatch / oracle contract of the port's CUDA kernels
(counterpart of ``repro/analysis/kernel_contract.py``).

Every CUDA source ``kernels/csrc/*.cu`` that defines a ``__global__``
kernel registers its public contract with one or more

    // tracelint: kernel-op=<ops.py dispatch fn> oracle=<ref.py oracle fn>

lines. R5 then verifies, cross-file:

- the source has an entry in ``ops._KERNELS`` (its launches are counted);
- the named dispatch exists as a module-level def in ``ops.py``, takes a
  ``backend`` argument, and routes through the ``_pick`` backend resolver
  (the cuda|torch pair: the kernel, or its plain version by name);
- the named oracle exists as a module-level def in ``ref.py`` (the scans'
  backward kernels name the forward's oracle, whose autograd is their
  reference).

A kernel that loses its oracle loses its parity tests; a dispatch that
bypasses ``_pick`` cannot be run as its plain version to compare.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

from repro_torch.analysis.base import Finding, parse_annotation

_GLOBAL_RE = re.compile(r"^[ \t]*__global__\b", re.MULTILINE)


def _module_defs(tree: ast.Module) -> dict:
    return {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _has_backend_param(fn) -> bool:
    a = fn.args
    return any(p.arg == "backend"
               for p in a.posonlyargs + a.args + a.kwonlyargs)


def _routes_through_pick(fn) -> bool:
    for n in ast.walk(fn):
        if isinstance(n, ast.Call):
            f = n.func
            name = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else "")
            if name == "_pick":
                return True
    return False


def _registered_kernels(tree: ast.Module) -> set:
    """The keys of the module-level ``_KERNELS = {...}`` dict literal."""
    for n in tree.body:
        if isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "_KERNELS"
                for t in n.targets) and isinstance(n.value, ast.Dict):
            return {k.value for k in n.value.keys
                    if isinstance(k, ast.Constant)}
    return set()


def check_kernels(kernels_dir, *, rel_root=None) -> list:
    """Run R5 over one kernels directory (its ``csrc/*.cu``, ``ops.py``
    and ``ref.py``). ``rel_root`` controls how finding paths are rendered
    (repo-relative by default)."""
    kernels_dir = Path(kernels_dir)
    rel_root = Path(rel_root) if rel_root is not None else kernels_dir
    out: list = []

    def rel(p: Path) -> str:
        try:
            return p.relative_to(rel_root).as_posix()
        except ValueError:
            return p.as_posix()

    ops_path = kernels_dir / "ops.py"
    ref_path = kernels_dir / "ref.py"
    ops_tree = ast.parse(ops_path.read_text()) if ops_path.exists() \
        else None
    ops_defs = _module_defs(ops_tree) if ops_tree is not None else None
    counted = _registered_kernels(ops_tree) if ops_tree is not None \
        else set()
    ref_defs = _module_defs(ast.parse(ref_path.read_text())) \
        if ref_path.exists() else None

    for path in sorted((kernels_dir / "csrc").glob("*.cu")):
        text = path.read_text()
        m = _GLOBAL_RE.search(text)
        if m is None:
            continue
        src = rel(path)
        anns = []
        for i, line in enumerate(text.splitlines(), 1):
            if "//" in line and "tracelint:" in line:
                ann = parse_annotation(i, line.split("//", 1)[1])
                if ann is not None and ann.kind == "kernel-op":
                    anns.append(ann)
        if path.stem not in counted:
            out.append(Finding(
                src, 1, "R5",
                f"kernel source {path.stem} has no entry in ops._KERNELS "
                "(its launches are not counted)"))
        if not anns:
            out.append(Finding(
                src, text.count("\n", 0, m.start()) + 1, "R5",
                "__global__ kernel source has no `tracelint: "
                "kernel-op=... oracle=...` registration (every kernel "
                "needs its ref.py oracle and ops.py cuda|torch dispatch)"))
            continue
        for ann in anns:
            op, oracle = ann.fields["op"], ann.fields["oracle"]
            if not oracle:
                out.append(Finding(
                    src, ann.line, "R5",
                    f"kernel-op={op or '?'} registration is missing its "
                    "oracle= (ref.py parity target)"))
            if ops_defs is None:
                out.append(Finding(src, ann.line, "R5",
                                   "kernels/ops.py not found — no "
                                   "dispatch layer to register against"))
            elif op not in ops_defs:
                out.append(Finding(
                    src, ann.line, "R5",
                    f"registered dispatch ops.{op} does not exist"))
            else:
                fn = ops_defs[op]
                if not _has_backend_param(fn):
                    out.append(Finding(
                        src, ann.line, "R5",
                        f"ops.{op} has no backend= parameter — the "
                        "cuda|torch pair is not selectable"))
                elif not _routes_through_pick(fn):
                    out.append(Finding(
                        src, ann.line, "R5",
                        f"ops.{op} does not route through the _pick "
                        "backend resolver — its plain version cannot be "
                        "asked for by name"))
            if oracle and ref_defs is None:
                out.append(Finding(src, ann.line, "R5",
                                   "kernels/ref.py not found — no oracle "
                                   "layer to register against"))
            elif oracle and oracle not in ref_defs:
                out.append(Finding(
                    src, ann.line, "R5",
                    f"registered oracle ref.{oracle} does not exist"))
    return out
