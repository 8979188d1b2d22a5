"""AST rule passes R1-R4 of the port's tracelint (R5 lives in
kernel_contract.py); counterpart of ``repro/analysis/rules.py``.

- R1 — every module-level ``functools.lru_cache`` factory that jits
  declares its cache key (``# tracelint: keys=``) and its traced body
  captures nothing outside that key or module scope (carried as written).
- R2 — inside a ``# tracelint: hot`` function, a host sync: ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize``,
  ``np.asarray`` / ``np.array`` of a tensor, ``float`` / ``int`` /
  ``bool`` of one. PyTorch runs eagerly, so there is no traced body and
  R2 has no traced half. A value is a tensor when the latest assignment
  above the use, in the function, binds it from a call of ``torch`` or
  of a module of ``repro_torch`` (flow by line order, lexical only).
- R3 — the wall-clock half: ``time.time`` / ``datetime.now`` in library
  code (hot-path clocks are ``time.perf_counter()``).
- R4 — bare ``assert`` in library code.

Donation (the reference's R6) has no PyTorch counterpart: a tensor passed
to a call stays valid after it, so R6 is not carried.

All passes are lexical: call graphs are not followed. That keeps the
pass O(file) and the findings explainable; the runtime
``compile_guard`` covers what static lexical analysis cannot.
"""
from __future__ import annotations

import ast
import builtins

from repro_torch.analysis.base import SourceFile

_BUILTINS = frozenset(dir(builtins))

# host-sync method calls flagged inside hot functions (R2)
_SYNC_ATTRS = ("item", "tolist", "cpu", "numpy")
_NP_SYNC_FNS = ("asarray", "array", "ascontiguousarray")
_CASTS = ("float", "int", "bool")

_FN_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


# ---------------------------------------------------------------------------
# name-binding helpers
# ---------------------------------------------------------------------------

def _targets(node: ast.AST) -> set:
    return {n.id for n in ast.walk(node)
            if isinstance(n, ast.Name) and isinstance(n.ctx, (ast.Store,
                                                              ast.Del))}


def _params(fn) -> list:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def _walk_pruned(node, *, into_defs: bool = False):
    """Yield descendants of ``node`` without entering nested function or
    lambda bodies (unless ``into_defs``); ``node`` itself is not yielded."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if not into_defs and isinstance(n, _FN_NODES + (ast.Lambda,)):
            continue
        stack.extend(ast.iter_child_nodes(n))


def _bound_in_scope(fn) -> set:
    """Names bound in ``fn``'s own scope: params, assignments, imports,
    nested def/class names, loop/with/except targets, and (leniently —
    they are really their own scopes) comprehension/walrus targets.
    Flow-insensitive; does not descend into nested function bodies."""
    if isinstance(fn, ast.Lambda):
        return set(_params(fn))
    bound = set(_params(fn))
    for n in _walk_pruned(fn):
        if isinstance(n, _FN_NODES + (ast.ClassDef,)):
            bound.add(n.name)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            for al in n.names:
                bound.add((al.asname or al.name).split(".")[0])
        elif isinstance(n, ast.Assign):
            for t in n.targets:
                bound.update(_targets(t))
        elif isinstance(n, (ast.AnnAssign, ast.AugAssign)):
            bound.update(_targets(n.target))
        elif isinstance(n, (ast.For, ast.AsyncFor)):
            bound.update(_targets(n.target))
        elif isinstance(n, (ast.With, ast.AsyncWith)):
            for it in n.items:
                if it.optional_vars is not None:
                    bound.update(_targets(it.optional_vars))
        elif isinstance(n, ast.ExceptHandler) and n.name:
            bound.add(n.name)
        elif isinstance(n, ast.comprehension):
            bound.update(_targets(n.target))
        elif isinstance(n, ast.NamedExpr):
            bound.update(_targets(n.target))
    return bound


def module_bindings(tree: ast.Module) -> set:
    fake = ast.FunctionDef(
        name="<module>", body=tree.body, decorator_list=[],
        args=ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                           kw_defaults=[], defaults=[]))
    return _bound_in_scope(fake) | {"__name__", "__file__", "__doc__",
                                    "__package__", "__spec__"}


# ---------------------------------------------------------------------------
# import-alias resolution (numpy / torch / jax spelled however the file
# spells them)
# ---------------------------------------------------------------------------

class Aliases:
    def __init__(self, tree: ast.Module):
        self.numpy: set = set()            # names bound to the numpy module
        self.jax: set = set()
        self.torch: set = set()            # torch and its submodules
        self.port: set = set()             # modules of repro_torch
        self.time_mod: set = set()
        self.datetime_mod: set = set()
        self.datetime_cls: set = set()
        self.from_time: set = set()        # `from time import time [as t]`
        for n in ast.walk(tree):
            if isinstance(n, ast.Import):
                for al in n.names:
                    name, bind = al.name, al.asname or al.name.split(".")[0]
                    if name == "numpy":
                        self.numpy.add(bind)
                    elif name == "jax":
                        self.jax.add(bind)
                    elif name.split(".")[0] == "torch":
                        self.torch.add(bind)
                    elif name.split(".")[0] == "repro_torch":
                        self.port.add(bind)
                    elif name == "time":
                        self.time_mod.add(bind)
                    elif name == "datetime":
                        self.datetime_mod.add(bind)
            elif isinstance(n, ast.ImportFrom):
                mod = n.module or ""
                for al in n.names:
                    bind = al.asname or al.name
                    if mod == "time" and al.name == "time":
                        self.from_time.add(bind)
                    if mod == "datetime" and al.name == "datetime":
                        self.datetime_cls.add(bind)
                    if mod.split(".")[0] == "torch":
                        self.torch.add(bind)
                    if mod.split(".")[0] == "repro_torch":
                        self.port.add(bind)


def _dotted(node) -> str:
    """Dotted name of a Name/Attribute chain ('' otherwise)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _call_name(node: ast.Call) -> str:
    return _dotted(node.func)


def _is_jax_jit(name: str, al: Aliases) -> bool:
    if not name:
        return False
    head, _, tail = name.partition(".")
    return (head in al.jax and tail == "jit") or name == "jit"


# ---------------------------------------------------------------------------
# R1 — fused-fn cache-key completeness
# ---------------------------------------------------------------------------

def _is_lru_decorated(fn) -> bool:
    for d in fn.decorator_list:
        name = _dotted(d.func if isinstance(d, ast.Call) else d)
        if name.split(".")[-1] in ("lru_cache", "cache"):
            return True
    return False


def _check_factory(sf: SourceFile, fn, mod_bound: set, al: Aliases,
                   out: list) -> None:
    params = _params(fn)
    jits = any(isinstance(n, ast.Call)
               and _is_jax_jit(_call_name(n), al)
               for n in ast.walk(fn))

    def emit(line, msg):
        f = sf.finding(line, "R1", msg)
        if f:
            out.append(f)

    if jits:
        ann = sf.annotation_for(fn, "keys")
        if ann is None:
            emit(fn.lineno,
                 f"lru_cache fused-fn factory {fn.name} missing its "
                 "`tracelint: keys=` cache-key declaration")
        else:
            declared, actual = set(ann.fields["keys"]), set(params)
            for k in sorted(declared - actual):
                emit(fn.lineno,
                     f"{fn.name}: declared cache key '{k}' is missing "
                     "from the factory signature — the jit cache would "
                     "serve one specialization for another")
            for k in sorted(actual - declared):
                emit(fn.lineno,
                     f"{fn.name}: factory arg '{k}' is not in the "
                     "declared `tracelint: keys=` tuple — a spurious key "
                     "(forks identical jits) or an undeclared "
                     "trace-shaper")

    # closure-capture resolution: every name the traced body loads must
    # resolve to the cache key (factory params/locals), module scope, or
    # builtins — anything else shapes the trace without keying the cache.
    factory_bound = set(params) | _bound_in_scope(fn)

    def resolve(name_node, chain):
        nm = name_node.id
        if any(nm in scope for scope in chain):
            return
        if nm in factory_bound or nm in mod_bound or nm in _BUILTINS:
            return
        emit(name_node.lineno,
             f"{fn.name}: traced body uses '{nm}' which resolves to "
             "neither the factory cache key nor module scope — a "
             "closure-captured trace-shaper outside the key")

    def resolve_scope(node, chain):
        own = _bound_in_scope(node)
        inner = [own] + chain
        roots = [node.body] if isinstance(node, ast.Lambda) else node.body
        stack = list(roots) if isinstance(roots, list) else [roots]
        while stack:
            n = stack.pop()
            if isinstance(n, _FN_NODES + (ast.Lambda,)):
                resolve_scope(n, inner)
                continue
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
                resolve(n, inner)
            stack.extend(ast.iter_child_nodes(n))

    for n in _walk_pruned(fn):
        if isinstance(n, _FN_NODES + (ast.Lambda,)):
            resolve_scope(n, [])


# ---------------------------------------------------------------------------
# R2 — host syncs in hot functions
# ---------------------------------------------------------------------------

def _hot_roots(sf: SourceFile) -> list:
    return [n for n in ast.walk(sf.tree)
            if isinstance(n, _FN_NODES)
            and sf.annotation_for(n, "hot") is not None]


def _root(node) -> str:
    """The name an expression reads its value from: ``x`` of ``x``,
    ``x[i]``, ``x.attr``, ``x.sum()``."""
    while True:
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, (ast.Subscript, ast.Attribute, ast.Starred)):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        else:
            return ""


def _device_bindings(fn, al: Aliases) -> dict:
    """{name: [(line, is_tensor)]}: each assignment in ``fn`` and whether
    it binds a tensor (a call of torch or of a repro_torch module, or a
    method of a tensor that keeps it on the device)."""
    out: dict = {}

    def tensor_call(v) -> bool:
        if not isinstance(v, ast.Call):
            return False
        name = _call_name(v)
        head = name.split(".")[0]
        if head in al.torch or head in al.port:
            return True
        if isinstance(v.func, ast.Attribute) and \
                v.func.attr not in _SYNC_ATTRS + ("tolist",):
            return tensor_call(v.func.value) or _is_tensor_name(
                v.func.value)
        return False

    def _is_tensor_name(v) -> bool:
        return isinstance(v, ast.Name) and bool(out.get(v.id)) \
            and out[v.id][-1][1]

    for n in sorted((n for n in _walk_pruned(fn)
                     if isinstance(n, (ast.Assign, ast.AnnAssign))),
                    key=lambda n: n.lineno):
        targets = n.targets if isinstance(n, ast.Assign) else [n.target]
        dev = n.value is not None and tensor_call(n.value)
        for t in targets:
            for name in _targets(t):
                out.setdefault(name, []).append((n.lineno, dev))
    return out


def _is_device(name: str, line: int, bindings: dict) -> bool:
    last = [dev for ln, dev in bindings.get(name, []) if ln < line]
    return bool(last) and last[-1]


def _check_hot(sf: SourceFile, fn, al: Aliases, out: list) -> None:
    """R2 inside one ``# tracelint: hot`` function."""
    bindings = _device_bindings(fn, al)

    def emit(line, msg):
        f = sf.finding(line, "R2", msg)
        if f:
            out.append(f)

    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _SYNC_ATTRS and not node.args:
            emit(node.lineno, f".{node.func.attr}() forces a host sync "
                              "inside a hot path")
            continue
        name = _call_name(node)
        if not name:
            continue
        head, _, tail = name.partition(".")
        if head in al.torch and tail == "cuda.synchronize" or \
                name.endswith("cuda.synchronize"):
            emit(node.lineno, f"{name}() waits for the device inside a hot "
                              "path")
        elif head in al.numpy and tail in _NP_SYNC_FNS and node.args \
                and _is_device(_root(node.args[0]), node.lineno, bindings):
            emit(node.lineno, f"{name}() of a tensor inside a hot path "
                              "copies it to the host (device sync)")
        elif name in _CASTS and node.args and _is_device(
                _root(node.args[0]), node.lineno, bindings):
            emit(node.lineno, f"{name}() of a tensor inside a hot path "
                              "forces a host sync")


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------

def check_file(sf: SourceFile, *, library: bool) -> list:
    """All single-file rules. ``library=True`` for src/repro_torch files
    (R4 bare-assert and R3 wall-clock apply only there; pytest asserts and
    test/benchmark timers are idiomatic)."""
    out: list = []
    al = Aliases(sf.tree)
    mod_bound = module_bindings(sf.tree)

    # R1: module-level lru_cache factories only — a nested lru_cache is
    # recreated per enclosing call (e.g. scheduler.mlcp_policy's DP
    # table), so closure capture there is scoped by construction.
    for st in sf.tree.body:
        if isinstance(st, _FN_NODES) and _is_lru_decorated(st):
            _check_factory(sf, st, mod_bound, al, out)

    # R2 over every annotated host hot path.
    for root in _hot_roots(sf):
        _check_hot(sf, root, al, out)

    # R3 wall-clock: library-wide (hot-path clocks are time.perf_counter;
    # wall clocks step/slew and poison latency math).
    if library:
        for n in ast.walk(sf.tree):
            if not isinstance(n, ast.Call):
                continue
            name = _call_name(n)
            if not name:
                continue
            head, _, tail = name.partition(".")
            bad = (head in al.time_mod and tail in ("time", "clock")) \
                or name in al.from_time \
                or (head in al.datetime_mod
                    and tail in ("datetime.now", "datetime.utcnow")) \
                or (head in al.datetime_cls and tail in ("now", "utcnow"))
            if bad:
                f = sf.finding(
                    n.lineno, "R3",
                    f"wall-clock {name}() — hot-path timing must use "
                    "time.perf_counter() (monotonic); annotate "
                    "`tracelint: ignore[R3]` where wall time is the "
                    "point")
                if f:
                    out.append(f)

    # R4: bare asserts in library code vanish under `python -O` and
    # abort without an actionable error type.
    if library:
        for n in ast.walk(sf.tree):
            if isinstance(n, ast.Assert):
                f = sf.finding(
                    n.lineno, "R4",
                    "bare assert in library code — raise ValueError/"
                    "RuntimeError (asserts vanish under -O)")
                if f:
                    out.append(f)

    # unknown tracelint directive == a typo silently disabling a rule
    for ann in sf.annotations:
        if ann.kind == "unknown":
            f = sf.finding(ann.line, "R0",
                           "unrecognized tracelint directive "
                           f"{ann.fields['text']!r}")
            if f:
                out.append(f)

    # nested hot functions are walked twice — dedupe, keep source order
    seen, deduped = set(), []
    for f in sorted(out, key=lambda f: (f.line, f.code, f.message)):
        if (f.line, f.code, f.message) not in seen:
            seen.add((f.line, f.code, f.message))
            deduped.append(f)
    return deduped
