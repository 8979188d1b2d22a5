"""tracelint CLI for the port: discovery, baseline, exit code
(counterpart of ``repro/analysis/cli.py``).

    python -m repro_torch.analysis [paths...] [--baseline FILE]
                                   [--write-baseline] [--no-baseline]

Default paths are the port's: ``src/repro_torch``, ``tests/test_torch_*.py``,
``chip_smoke.py`` and ``examples/torch_*.py`` under the repo root (the
nearest ancestor of cwd holding a ``pyproject.toml``). Findings print as
``file:line CODE message``; the process exits 1 iff any finding is not
covered by the checked-in baseline (``scripts/lint_torch_baseline.txt``).
Baseline entries key on (path, code, message) so they survive line
drift; stale entries are reported (and pruned on ``--write-baseline``)
but never fail the run.

The pass is pure-AST — no torch import, nothing runs — so the whole port
lints in about a second.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from repro_torch.analysis import kernel_contract, rules
from repro_torch.analysis.base import Finding, SourceFile

BASELINE_DEFAULT = "scripts/lint_torch_baseline.txt"


def repo_root(start=None) -> Path:
    cur = Path(start or Path.cwd()).resolve()
    for p in (cur, *cur.parents):
        if (p / "pyproject.toml").exists():
            return p
    return cur


def default_paths(root: Path) -> list:
    """The port's files: its package, its tests, its smoke script and its
    examples."""
    return [root / "src" / "repro_torch",
            *sorted((root / "tests").glob("test_torch_*.py")),
            root / "chip_smoke.py",
            *sorted((root / "examples").glob("torch_*.py"))]


def discover(paths) -> list:
    files: list = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(f for f in p.rglob("*.py")
                                if "__pycache__" not in f.parts))
        elif p.suffix == ".py" and p.exists():
            files.append(p)
    return files


def lint_text(text: str, path: str, *, library: bool = True) -> list:
    """Lint one source string (the unit tests' entry point)."""
    return rules.check_file(SourceFile(path, text), library=library)


def lint_paths(root: Path, paths) -> tuple:
    """-> (findings, n_files). The kernel contract (R5) runs once per
    ``kernels/`` directory seen among the files."""
    findings: list = []
    files = discover(paths)
    kernel_dirs = set()
    for f in files:
        rel = f.resolve()
        try:
            rel_s = rel.relative_to(root).as_posix()
        except ValueError:
            rel_s = rel.as_posix()
        library = rel_s.startswith("src/")
        try:
            sf = SourceFile(rel_s, f.read_text())
        except SyntaxError as e:
            findings.append(Finding(rel_s, e.lineno or 1, "R0",
                                    f"syntax error: {e.msg}"))
            continue
        findings.extend(rules.check_file(sf, library=library))
        if rel.parent.name == "kernels":
            kernel_dirs.add(rel.parent)
    for kd in sorted(kernel_dirs):
        findings.extend(kernel_contract.check_kernels(kd, rel_root=root))
    return findings, len(files)


def load_baseline(path: Path) -> set:
    if not path.exists():
        return set()
    keys = set()
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split("\t", 2)
        if len(parts) == 3:
            keys.add((parts[0], parts[1], parts[2]))
    return keys


def write_baseline(path: Path, findings) -> None:
    lines = ["# tracelint suppression baseline of the port — one",
             "# `path<TAB>CODE<TAB>message` per tolerated finding. Keep",
             "# this empty: fix or inline-`tracelint: ignore[...]` (with a",
             "# reason) instead, and reserve the baseline for staged",
             "# burn-downs.",
             "# Regenerate: python -m repro_torch.analysis --write-baseline"]
    for f in sorted(set(f.key for f in findings)):
        lines.append("\t".join(f))
    path.write_text("\n".join(lines) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="tracelint: static analysis of the port's serving and "
                    "training paths (rules R1-R5; see README).")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: the port's)")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default: {BASELINE_DEFAULT})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, baselined or not")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from current findings "
                         "and exit 0")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    root = repo_root()
    paths = [Path(p) for p in args.paths] if args.paths \
        else default_paths(root)
    findings, n_files = lint_paths(root, paths)

    baseline_path = Path(args.baseline) if args.baseline \
        else root / BASELINE_DEFAULT
    if args.write_baseline:
        write_baseline(baseline_path, findings)
        print(f"tracelint: wrote {len(set(f.key for f in findings))} "
              f"baseline entries to {baseline_path}")
        return 0

    baseline = set() if args.no_baseline else load_baseline(baseline_path)
    new = [f for f in findings if f.key not in baseline]
    known = len(findings) - len(new)
    stale = baseline - set(f.key for f in findings)

    for f in sorted(new):
        print(f.render())
    for key in sorted(stale):
        print(f"tracelint: stale baseline entry (fixed? prune it): "
              f"{key[0]} {key[1]} {key[2]}")
    dt = time.perf_counter() - t0
    print(f"tracelint: {len(new)} new finding(s), {known} baselined, "
          f"{len(stale)} stale baseline entr(ies) across {n_files} files "
          f"in {dt:.2f}s")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
