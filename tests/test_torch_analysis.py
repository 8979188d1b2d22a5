"""The port's tracelint (``repro_torch.analysis``), on the CPU: each rule
R1-R5 gets the cases ``tests/test_analysis.py`` gives the reference's (a
good fixture that lints clean, bad fixtures with the exact code and
line), R5 on ``tmp_path`` trees of CUDA sources (a ``.cu`` with no
dispatch, a dispatch with no ``backend=``, a missing oracle, a source
``ops._KERNELS`` does not count); suppression, the baseline and the CLI
exit codes; the shipped port lints clean; and ``compile_guard`` counting
a stubbed kernel build and load, 0 when warm.
"""
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import cli, kernel_contract
from repro_torch.analysis.guards import (CompileBudgetExceeded, CompileLog,
                                         compile_guard)
from repro_torch.core import telemetry
from repro_torch.kernels import _build

REPO = Path(__file__).resolve().parent.parent


def lint(src, *, library=True, path="src/repro_torch/fixture.py"):
    return cli.lint_text(textwrap.dedent(src), path, library=library)


def codes(findings):
    return [f.code for f in findings]


# ---------------------------------------------------------------------------
# R1 — cache-key completeness (carried as written)
# ---------------------------------------------------------------------------

GOOD_FACTORY = """
    import functools
    import jax

    # tracelint: keys=cfg,cap,mesh
    @functools.lru_cache(maxsize=8)
    def _fused_fn(cfg, cap, mesh=None):
        def impl(params, batch):
            return params, batch, cfg, cap, mesh
        return jax.jit(impl)
"""


def test_r1_good_factory_is_clean():
    assert lint(GOOD_FACTORY) == []


@pytest.mark.parametrize("src,line,words", [
    ("""
        import functools
        import jax

        @functools.lru_cache(maxsize=8)
        def _fused_fn(cfg, cap):
            def impl(x):
                return x, cfg, cap
            return jax.jit(impl)
    """, 6, ("missing its", "_fused_fn")),
    ("""
        import functools
        import jax

        # tracelint: keys=cfg,k
        @functools.lru_cache(maxsize=8)
        def _fused_fn(cfg):
            def impl(x):
                return x, cfg
            return jax.jit(impl)
    """, 7, ("declared cache key 'k' is missing",)),
    ("""
        import functools
        import jax

        # tracelint: keys=cfg
        @functools.lru_cache(maxsize=8)
        def _fused_fn(cfg, debug_tag):
            def impl(x):
                return x, cfg
            return jax.jit(impl)
    """, 7, ("'debug_tag'", "not in the declared")),
    ("""
        import functools
        import jax

        # tracelint: keys=cfg
        @functools.lru_cache(maxsize=8)
        def _fused_fn(cfg):
            def impl(x):
                return x[:steps], cfg
            return jax.jit(impl)
    """, 9, ("'steps'", "closure-captured")),
], ids=["missing-keys", "declared-key-gone", "spurious-arg", "closure"])
def test_r1_bad_factories(src, line, words):
    fs = lint(src)
    assert codes(fs) == ["R1"] and fs[0].line == line
    assert all(w in fs[0].message for w in words)


def test_r1_nested_factory_exempt():
    """The scheduler's DP-table pattern: a nested lru_cache is recreated
    per enclosing call, so its closure capture is scoped by construction
    (the port's ``core/scheduler.py`` has one)."""
    assert lint("""
        import functools

        def mlcp_policy(n):
            @functools.lru_cache(maxsize=None)
            def best(i):
                return i * n
            return best(0)
    """) == []
    src = (REPO / "src/repro_torch/core/scheduler.py").read_text()
    assert "functools.lru_cache" in src
    assert cli.lint_text(src, "src/repro_torch/core/scheduler.py") == []


# ---------------------------------------------------------------------------
# R2 — host syncs in hot functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("body,line,word", [
    ("y = model.step(x)\n    return y.item()", 8, ".item()"),
    ("return model.step(x).tolist()", 7, ".tolist()"),
    ("return model.step(x).cpu()", 7, ".cpu()"),
    ("return model.step(x).numpy()", 7, ".numpy()"),
    ("torch.cuda.synchronize()\n    return x", 7, "torch.cuda.synchronize"),
    ("y = torch.ones(3)\n    return np.asarray(y)", 8, "np.asarray"),
    ("n = model.step(x)\n    return int(n)", 8, "int()"),
    ("n = torch.ones(3).sum()\n    return float(n)", 8, "float()"),
    ("m = model.step(x)\n    return bool(m[0])", 8, "bool()"),
], ids=["item", "tolist", "cpu", "numpy", "synchronize", "np.asarray",
        "int", "float", "bool-of-subscript"])
def test_r2_host_syncs_in_a_hot_path(body, line, word):
    fs = cli.lint_text("\n".join([
        "import numpy as np", "import torch",
        "from repro_torch.models import model", "", "# tracelint: hot",
        "def drain(x):", "    " + body, ""]), "src/repro_torch/fixture.py")
    assert codes(fs) == ["R2"] and fs[0].line == line
    assert word in fs[0].message


def test_r2_host_values_and_rebound_names_are_not_tensors():
    """Casts of host bookkeeping (numpy arrays, lengths, a name rebound
    from ``.cpu().numpy()`` after its one sync) are legal."""
    fs = lint("""
        import numpy as np
        from repro_torch.models import model

        # tracelint: hot
        def drain(x, budget):
            left = np.array(budget)
            toks = model.step(x)
            toks = toks.cpu().numpy()    # tracelint: ignore[R2] the sync
            return int(left.sum()) + int(toks[0]) + int(len(budget))
    """)
    assert fs == []


def test_r2_only_in_hot_functions():
    assert lint("""
        import torch

        def summarize(x):
            return torch.ones(3).sum().item(), x.cpu()
    """) == []


def test_r2_inline_ignore_suppresses():
    assert lint("""
        import torch

        # tracelint: hot
        def drain(x):
            return torch.ones(3).cpu()    # tracelint: ignore[R2] the one sync
    """) == []


# ---------------------------------------------------------------------------
# R3 — wall clocks (library code)
# ---------------------------------------------------------------------------

def test_r3_wall_clock_in_library():
    fs = lint("""
        import time

        def measure(fn):
            t0 = time.time()
            fn()
            return time.time() - t0
    """)
    assert codes(fs) == ["R3", "R3"] and "perf_counter" in fs[0].message


def test_r3_wall_clock_ok_in_tests_and_with_ignore():
    src = """
        import time

        def measure(fn):
            t0 = time.time()
            fn()
            return time.time() - t0
    """
    assert lint(src, library=False, path="tests/fixture.py") == []
    assert lint("""
        import time

        def epoch():
            return time.time()    # tracelint: ignore[R3] wall time IS the point
    """) == []


def test_r3_datetime_now_and_perf_counter():
    fs = lint("""
        import time
        from datetime import datetime

        def stamp():
            t = time.perf_counter()
            return datetime.now(), t
    """)
    assert codes(fs) == ["R3"] and "datetime.now" in fs[0].message


# ---------------------------------------------------------------------------
# R4 — bare asserts in library code
# ---------------------------------------------------------------------------

def test_r4_bare_assert_library_only():
    src = """
        def check(x):
            assert x > 0, x
            return x
    """
    fs = lint(src)
    assert codes(fs) == ["R4"] and fs[0].line == 3
    assert lint(src, library=False, path="tests/fixture.py") == []


# ---------------------------------------------------------------------------
# R5 — the kernel / dispatch / oracle contract of the CUDA sources
# ---------------------------------------------------------------------------

OPS = """
_KERNELS = {"good": None, "nopick": None, "nobackend": None}

def _pick(b):
    return b

def myop(x, backend=None):
    return _pick(backend)

def nopick(x, backend=None):
    return x

def nobackend(x):
    return x
"""

REF = """
def myref(x):
    return x
"""

KERNEL = """// a CUDA kernel
{reg}
#include <cuda_runtime.h>

__global__ void good_kernel(float* y) {{ y[0] = 1.f; }}
"""


def _kernels_dir(tmp_path, registrations, *, stem="good"):
    kd = tmp_path / "kernels"
    (kd / "csrc").mkdir(parents=True)
    (kd / "ops.py").write_text(OPS)
    (kd / "ref.py").write_text(REF)
    (kd / "csrc" / f"{stem}.cu").write_text(KERNEL.format(
        reg="\n".join(f"// tracelint: {r}" for r in registrations)))
    (kd / "csrc" / "common.cuh").write_text(
        "__global__ void header_kernel() {}\n")
    return kd


def test_r5_good_registration(tmp_path):
    kd = _kernels_dir(tmp_path, ["kernel-op=myop oracle=myref"])
    assert kernel_contract.check_kernels(kd) == []


def test_r5_a_source_with_no_registered_dispatch(tmp_path):
    kd = _kernels_dir(tmp_path, [])
    fs = kernel_contract.check_kernels(kd)
    assert codes(fs) == ["R5"] and "no `tracelint:" in fs[0].message
    assert fs[0].line == 5                     # the __global__ line


def test_r5_missing_oracle(tmp_path):
    fs = kernel_contract.check_kernels(
        _kernels_dir(tmp_path, ["kernel-op=myop oracle=ghost"]))
    assert codes(fs) == ["R5"]
    assert "oracle ref.ghost does not exist" in fs[0].message
    fs = kernel_contract.check_kernels(
        _kernels_dir(tmp_path / "b", ["kernel-op=myop"]))
    assert "missing its oracle=" in fs[0].message


def test_r5_missing_dispatch_and_pair_violations(tmp_path):
    kd = _kernels_dir(tmp_path, ["kernel-op=ghost oracle=myref",
                                 "kernel-op=nobackend oracle=myref",
                                 "kernel-op=nopick oracle=myref"])
    msgs = " | ".join(f.message for f in kernel_contract.check_kernels(kd))
    assert "ops.ghost does not exist" in msgs
    assert "no backend= parameter" in msgs
    assert "does not route through the _pick" in msgs


def test_r5_a_source_ops_does_not_count(tmp_path):
    kd = _kernels_dir(tmp_path, ["kernel-op=myop oracle=myref"],
                      stem="uncounted")
    fs = kernel_contract.check_kernels(kd)
    assert codes(fs) == ["R5"] and "no entry in ops._KERNELS" in \
        fs[0].message


def test_r5_the_port_kernels_are_registered():
    kd = REPO / "src/repro_torch/kernels"
    assert kernel_contract.check_kernels(kd, rel_root=REPO) == []
    assert len(list((kd / "csrc").glob("*.cu"))) == 11


# ---------------------------------------------------------------------------
# R0, suppression, baseline, CLI
# ---------------------------------------------------------------------------

def test_r0_unknown_directive():
    fs = lint("""
        # tracelint: keyz=cfg
        def f():
            return 1
    """)
    assert codes(fs) == ["R0"] and "keyz=cfg" in fs[0].message


def _mk_repo(tmp_path):
    (tmp_path / "pyproject.toml").write_text("[project]\nname='fix'\n")
    (tmp_path / "src" / "repro_torch").mkdir(parents=True)
    (tmp_path / "tests").mkdir()
    (tmp_path / "scripts").mkdir()
    return tmp_path


def test_cli_exit_codes_and_baseline_roundtrip(tmp_path, monkeypatch,
                                               capsys):
    root = _mk_repo(tmp_path)
    bad = root / "src" / "repro_torch" / "mod.py"
    bad.write_text("def f(x):\n    assert x\n    return x\n")
    (root / "tests" / "test_torch_x.py").write_text(
        "import time\n\ndef test_x():\n    assert time.time()\n")
    monkeypatch.chdir(root)

    assert cli.main([]) == 1                   # new finding -> gate fails
    out = capsys.readouterr().out
    assert "src/repro_torch/mod.py:2 R4" in out
    assert "1 new finding(s)" in out           # tests may assert and time

    assert cli.main(["--write-baseline"]) == 0
    assert cli.main([]) == 0                   # baselined -> gate passes
    assert "0 new finding(s), 1 baselined" in capsys.readouterr().out
    assert cli.main(["--no-baseline"]) == 1    # still visible on demand

    bad.write_text("def f(x):\n    return x\n")
    assert cli.main([]) == 0                   # fixed -> stale entry noted
    assert "stale baseline entry" in capsys.readouterr().out


def test_cli_syntax_error_is_a_finding(tmp_path, monkeypatch, capsys):
    root = _mk_repo(tmp_path)
    (root / "src" / "repro_torch" / "mod.py").write_text("def f(:\n")
    monkeypatch.chdir(root)
    assert cli.main([]) == 1
    assert "R0 syntax error" in capsys.readouterr().out


def test_the_shipped_port_lints_clean(monkeypatch, capsys):
    """``python -m repro_torch.analysis`` exits 0 on the repo, with an
    empty baseline doing no work, over the port's package, tests, smoke
    script and examples."""
    monkeypatch.chdir(REPO)
    assert cli.load_baseline(REPO / cli.BASELINE_DEFAULT) == set()
    files = cli.discover(cli.default_paths(REPO))
    assert REPO / "chip_smoke.py" in files
    assert any(f.name.startswith("torch_") and f.parent.name == "examples"
               for f in files)
    assert cli.main([]) == 0
    assert "0 new finding(s), 0 baselined" in capsys.readouterr().out


def test_the_drain_loop_is_a_hot_path():
    """``DecodeEngine.run`` is marked hot: a stray sync added to it is a
    finding."""
    path = "src/repro_torch/launch/engine.py"
    src = (REPO / path).read_text()
    assert cli.lint_text(src, path) == []
    anchor = "        stats = EngineStats()\n"
    assert src.count(anchor) == 1
    bad = src.replace(anchor, anchor + "        torch.ones(1).item()\n")
    fs = cli.lint_text(bad, path)
    assert codes(fs) == ["R2"] and ".item()" in fs[0].message


# ---------------------------------------------------------------------------
# compile_guard — the runtime sentinel, on a stubbed kernel build
# ---------------------------------------------------------------------------

@pytest.fixture
def stubbed_build(monkeypatch):
    """``kernels/_build.py`` with nvcc and the loader stubbed: ``load``
    "builds" a library the first time a name is asked for."""
    built = set()
    monkeypatch.setattr(_build, "_LIBS", {})

    def start(name):
        if name in built:
            return None
        built.add(name)
        _build._report(f"nvcc {name}")
        return name

    monkeypatch.setattr(_build, "_start", start)
    monkeypatch.setattr(_build, "_finish", lambda name, job: "")
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    return built


def test_compile_guard_counts_a_build_and_is_zero_when_warm(stubbed_build):
    with compile_guard() as log:
        _build.load("lora_matmul")
    assert log.names == ["nvcc lora_matmul", "load lora_matmul"]
    with compile_guard(max_compiles=0) as warm:
        _build.load("lora_matmul")
    assert warm.count == 0 and warm.names == []


def test_compile_guard_budget_violation_names_the_culprit(stubbed_build):
    with pytest.raises(CompileBudgetExceeded, match="flash_decode"):
        with compile_guard(max_compiles=0):
            _build.load("flash_decode")


def test_compile_guard_match_filter_and_telemetry_counter(stubbed_build):
    tel = telemetry.Telemetry()
    with compile_guard(match=r"^load", tel=tel) as log:
        _build.load("rglru_scan")
    assert log.names == ["load rglru_scan"]
    assert tel.counters["analysis.compiles"] == 1
    tel2 = telemetry.Telemetry()
    with compile_guard(match=r"no_such_name", tel=tel2) as log2:
        _build.load("selective_scan")
    assert log2.count == 0 and tel2.counters["analysis.compiles"] == 0


def test_compile_guard_nests_and_detaches(stubbed_build):
    assert isinstance(CompileLog().count, int)
    with compile_guard() as outer:
        with compile_guard() as inner:
            _build.load("lora_bgmv_rows")
        assert inner.count == 2
    assert outer.count >= inner.count
    before = list(outer.names)
    _build.load("lora_bgmv_seq")               # outside any guard
    assert outer.names == before and _build.LISTENERS == []
