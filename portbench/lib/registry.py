"""Finding a cell, its configuration, its driver and a metric's reader
by name, from ``BENCHMARK.json`` and the files under ``portbench/``:

- ``workloads/<cell>.json``: the cell's driver kind and traffic;
- the configuration file that ``BENCHMARK.json`` names for the cell's
  ``config``;
- ``drivers/<kind>.py``: a module with ``run(ctx)``;
- ``metrics/<metric>.py``: a module with ``read(obs)``, which returns a
  number or None where it finds nothing to read; a metric named
  ``<base>.<part>`` (one quantity reported apart per kind of cell, such
  as ``idle_share.chat``) that has no file of its own is read by
  ``metrics/<base>.py``.

A later change adds a cell, a configuration, a driver or a metric by
adding files and entries, never by editing one."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent          # portbench/


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Registry:
    """Names resolved against ``BENCHMARK.json`` at ``root`` and the file
    trees ``homes`` (the first that holds a file wins; ``portbench/``
    last)."""

    def __init__(self, bench: dict, root: Path, home: Path = HERE):
        self.bench, self.root = bench, root
        self.homes = [home] + ([HERE] if Path(home) != HERE else [])

    def _file(self, sub: str, fname: str) -> Path:
        for h in self.homes:
            p = Path(h) / sub / fname
            if p.is_file():
                return p
        raise FileNotFoundError(f"no {sub}/{fname} under {self.homes}")

    @classmethod
    def at(cls, root: Path, home: Path = HERE) -> "Registry":
        return cls(load_json(root / "BENCHMARK.json"), root, home)

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> dict:
        return load_json(self._file("workloads", f"{name}.json"))

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return load_json(self.root / c["file"])
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def driver(self, kind: str):
        return module(self._file("drivers", f"{kind}.py"),
                      f"portbench_driver_{kind}")

    def metrics(self, cell: str, traced: bool) -> list[dict]:
        """The metric entries this cell reports in this kind of run."""
        key = "per_layer" if traced else "end_to_end"
        return [m for m in self.bench[key]
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str):
        base = metric.split(".")[0]
        try:
            path = self._file("metrics", f"{metric}.py")
        except FileNotFoundError:
            if base == metric:
                raise
            path = self._file("metrics", f"{base}.py")
        return module(path, "portbench_metric_" + metric.replace(".", "_"))
