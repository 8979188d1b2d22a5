"""What the benchmark's process and its reference load."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PROBE = ("import sys, json; sys.path[:0] = [{root!r}, {src!r}]; "
         "import {mod}; "
         "print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))")


def _tops(mod: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(ROOT),
                                            src=str(ROOT / "src"), mod=mod)],
        capture_output=True, text=True, timeout=120, env=env, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_and_its_closure_load_no_jax():
    tops = _tops("portbench.run, portbench.drivers.open_loop, "
                 "portbench.drivers.drains, portbench.lib.probes, "
                 "repro_torch.launch.engine, repro_torch.core.adapter_bank")
    assert not tops & {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" in tops


def test_reference_loads_nothing_of_the_program():
    tops = _tops("portbench.reference.decoder")
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_run_without_a_card_prints_no_result():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "qwen2-7b.bank-chat", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120, env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""
