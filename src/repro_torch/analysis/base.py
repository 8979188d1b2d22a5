"""Shared lint plumbing: findings, ``# tracelint:`` comments, source model
(counterpart of ``repro/analysis/base.py``).

Annotation grammar (one per comment, anywhere a ``#`` comment is legal):

- ``# tracelint: keys=cfg,cap,mesh`` — declares the trace-shaping key
  tuple of the ``functools.lru_cache`` fused-fn factory it annotates
  (the def/decorator it immediately precedes or shares a line with).
  R1 checks the declaration against the factory signature BOTH ways.
- ``# tracelint: hot`` — marks a host-side function (e.g. the engine
  drain loop) as a hot path: the R2 host-sync checks apply to its whole
  lexical body.
- ``// tracelint: kernel-op=<ops fn> oracle=<ref fn>`` — in a CUDA
  source (``kernels/csrc/*.cu``), registers the kernel's public contract;
  R5 resolves both names.
- ``# tracelint: ignore[R2,R3] <reason>`` — suppresses those codes on
  that line (``ignore`` with no bracket suppresses every code). Use for
  the deliberate exceptions: the drain loop's one sync per segment,
  telemetry's wall-clock trace epoch.

Baselines key on ``(path, code, message)`` — line-number free, so a
baselined finding survives unrelated edits but a new instance of the
same defect elsewhere still fails the gate.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from typing import Optional

_ANN_RE = re.compile(r"tracelint:\s*(.+?)\s*$")
_IGNORE_RE = re.compile(r"ignore(?:\[([A-Z0-9,\s]+)\])?")

ALL_CODES = ("R1", "R2", "R3", "R4", "R5")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One lint finding, printed as ``path:line CODE message``."""
    path: str                          # repo-relative, posix separators
    line: int
    code: str                          # "R0".."R5"
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line} {self.code} {self.message}"

    @property
    def key(self) -> tuple:
        """Baseline identity: line numbers drift, messages don't."""
        return (self.path, self.code, self.message)


@dataclasses.dataclass(frozen=True)
class Annotation:
    line: int
    kind: str                          # 'keys' | 'hot' | 'kernel-op' | 'ignore'
    fields: dict


def parse_annotation(line: int, text: str) -> Optional[Annotation]:
    m = _ANN_RE.search(text)
    if not m:
        return None
    body = m.group(1)
    if body.startswith("ignore"):
        im = _IGNORE_RE.match(body)
        codes = frozenset(c.strip() for c in im.group(1).split(",")) \
            if im.group(1) else frozenset(ALL_CODES)
        return Annotation(line, "ignore", {"codes": codes})
    if body == "hot" or body.startswith("hot "):
        return Annotation(line, "hot", {})
    if body.startswith("keys="):
        raw = body[len("keys="):].split()[0] if body[len("keys="):] else ""
        keys = tuple(k.strip() for k in raw.split(",") if k.strip())
        return Annotation(line, "keys", {"keys": keys})
    if body.startswith("kernel-op="):
        fields = {}
        for part in body.split():
            if "=" in part:
                k, v = part.split("=", 1)
                fields[k] = v
        return Annotation(line, "kernel-op",
                          {"op": fields.get("kernel-op", ""),
                           "oracle": fields.get("oracle", "")})
    # unknown directive: surface it rather than silently ignoring a typo
    return Annotation(line, "unknown", {"text": body})


class SourceFile:
    """One parsed file: AST + tracelint comments, ready for rule passes."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.text = text
        self.tree = ast.parse(text)
        self.annotations: list[Annotation] = []
        self.ignores: dict[int, frozenset] = {}
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type != tokenize.COMMENT:
                continue
            ann = parse_annotation(tok.start[0], tok.string)
            if ann is None:
                continue
            if ann.kind == "ignore":
                self.ignores[ann.line] = ann.fields["codes"]
            else:
                self.annotations.append(ann)

    # -- annotation lookup --------------------------------------------------
    def annotation_for(self, node: ast.AST, kind: str) -> Optional[Annotation]:
        """The ``kind`` annotation attached to a def: on the def line, on a
        decorator line, or on its own line up to 2 lines above the first
        decorator (room for one explanatory comment line between)."""
        start = min([node.lineno]
                    + [d.lineno for d in getattr(node, "decorator_list", [])])
        lo, hi = start - 2, node.body[0].lineno if getattr(node, "body", None) \
            else node.lineno
        best = None
        for ann in self.annotations:
            if ann.kind == kind and lo <= ann.line <= hi:
                if best is None or ann.line > best.line:
                    best = ann
        return best

    def suppressed(self, line: int, code: str) -> bool:
        return code in self.ignores.get(line, frozenset())

    def finding(self, line: int, code: str, message: str
                ) -> Optional[Finding]:
        if self.suppressed(line, code):
            return None
        return Finding(self.path, line, code, message)
