"""Import hygiene of the port: ``repro_torch``, ``chip_smoke.py`` and the
port's examples (``examples/torch_*.py``) import neither JAX nor anything
of the JAX package ``repro``, so that they run on a machine without
JAX."""
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"] + sorted((REPO / "examples").glob("torch_*.py"))
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)(?:\.|\s|$)",
                       re.MULTILINE)

PROBE = """
import importlib, pkgutil, sys
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", len([k for k in sys.modules if k.startswith("repro_torch")]))
print("BAD", bad)
"""


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = PROBE.format(src=str(REPO / "src"), root=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(REPO))
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
    n = int(res.stdout.split("LOADED")[1].split()[0])
    assert n >= 20                       # every module was imported


def test_no_port_file_imports_jax_or_repro():
    """Static guard: a later slice cannot reintroduce such an import."""
    assert len(PORT_FILES) > 20
    hits = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
            for p in PORT_FILES for m in FORBIDDEN.finditer(p.read_text())]
    assert hits == []


def test_the_static_guard_catches_each_forbidden_form():
    for line in ("import jax", "from jax import numpy", "import jax.numpy",
                 "from repro.models import model", "import repro.kernels",
                 "    from repro import configs"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.kernels import ops",
                 "import jaxtyping_like_name_is_not_jax"):
        assert not FORBIDDEN.search(line), line
