"""The program's spans as the benchmark reads them (``lib/program.py``, the
four readers of the model step's and the engine's spans, and
``spans.py``): launches, syncs and idle gaps inside the program's ranges
of a profiler trace, host and self times from the span records the
drains name in ``EngineStats.tel``, and a traced tiny cell on the CPU.
"""
import dataclasses
import json

import pytest
import torch

from portbench import run
from portbench.lib import program, registry
from portbench.tests import tiny
from repro_torch.core.telemetry import SpanRecord, Telemetry
from repro_torch.launch.engine import EngineStats

NEW = ("step_host_ms", "attn_host_share", "ffn_host_share", "refill_ms")


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def _kernel(ts, dur):
    return _x("kernel", "k", ts, dur, tid=7)


def test_read_trace_counts_inside_steps_and_names_gaps(tmp_path):
    ev = [_x("user_annotation", "hb:model.decode_step", 0, 100),
          _x("user_annotation", "model.decode_step", 2, 96),
          _x("user_annotation", "layer.attn", 5, 40),
          _x("user_annotation", "pb:0", 10, 10),
          _x("user_annotation", "layer.ffn", 50, 40),
          _x("user_annotation", "moe.route", 55, 20),
          _x("cuda_runtime", "cudaLaunchKernel", 12, 1),
          _x("cuda_driver", "cuLaunchKernelEx", 30, 1),
          _x("cuda_runtime", "cudaMemcpyAsync", 60, 1),
          _x("cuda_runtime", "cudaStreamSynchronize", 61, 2),
          _x("cuda_runtime", "cudaEventRecord", 70, 1),
          _x("cuda_runtime", "cudaLaunchKernel", 80, 1, tid=2),   # thread
          _x("cuda_runtime", "cudaLaunchKernel", 99, 1),  # after the step
          _x("user_annotation", "hb:model.refill", 100, 60),
          _x("user_annotation", "engine.refill", 101, 49),
          _x("user_annotation", "layer.attn", 110, 30),
          _x("user_annotation", "model.decode_step", 180, 30),
          _x("cuda_runtime", "cudaLaunchKernel", 205, 1),
          _kernel(0, 6), _kernel(20, 5),     # gap 6-20: layer.attn
          _kernel(60, 5),                    # gap 25-60: layer.attn (42.5)
          _kernel(75, 5),                    # gap 65-75: moe.route
          _kernel(97, 4),                    # gap 80-97: layer.ffn (88.5)
          _kernel(101, 1),                   # touches the last: no gap
          _kernel(130, 2),                   # gap 102-130: the refill's attn
          _kernel(170, 2),                   # gap 132-170: hb:model.refill
          _kernel(203, 1),                   # gap 172-203: model.decode_step
          _kernel(215, 1),                   # gap 204-215: model.decode_step
          _kernel(240, 1)]                   # gap 216-240: outside
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    pt = program.read_trace(str(p))
    assert p.exists()                        # lib/trace.py reads it next
    assert pt["steps"] == 2
    assert pt["launches"] == 4 and pt["syncs"] == 1
    want = {"model.decode_step > layer.attn": 14 + 35,
            "model.decode_step > moe.route": 10,
            "model.decode_step > layer.ffn": 17,
            "engine.refill > layer.attn": 28, "hb:model.refill": 38,
            "model.decode_step": 31 + 11, "outside": 24}
    assert set(pt["gaps_s"]) == set(want)
    for k, v in want.items():
        assert abs(pt["gaps_s"][k] - v * 1e-6) < 1e-12, k
    notes = program.notes({"stats": [EngineStats()], "window": (0.0, 1.0)},
                          pt)
    assert notes == {"idle_gaps_by_span": pt["gaps_s"], "syncs_per_step": 0.5,
                     "launches_per_step": 2.0}


def test_read_trace_without_program_ranges(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": [
        _x("user_annotation", "hb:model.decode_step", 0, 100),
        _x("cuda_runtime", "cudaLaunchKernel", 12, 1), _kernel(20, 5)]}))
    assert program.read_trace(str(p)) is None
    assert program.read_trace(str(tmp_path / "gone.json")) is None


def _tel(records) -> Telemetry:
    """A telemetry holding ``records`` (name, start, dur, parent[, args])
    at epoch 0."""
    tel = Telemetry()
    tel._epoch = 0.0
    for name, t0, dur, parent, *args in records:
        tel.spans.append(SpanRecord(name, t0, dur, 1, 0,
                                    args[0] if args else {}, parent))
    return tel


RECORDS = [("engine.segment", 0.0, 1.0, -1),                  # 0
           ("model.decode_step", 0.1, 0.4, 0),                # 1
           ("layer.attn", 0.1, 0.1, 1),                       # 2
           ("layer.ffn", 0.2, 0.2, 1),                        # 3
           ("moe.route", 0.2, 0.05, 3),                       # 4
           ("model.head", 0.4, 0.02, 1),                      # 5
           ("model.sample", 0.5, 0.01, 0),                    # 6
           ("model.decode_step", 0.6, 0.2, 0),                # 7
           ("layer.attn", 0.6, 0.05, 7),                      # 8
           ("layer.ffn", 0.65, 0.1, 7),                       # 9
           ("model.decode_step", 2.0, 0.3, -1),               # 10: later
           ("layer.attn", 2.0, 0.3, 10),                      # 11
           ("engine.refill", 0.55, 0.01, -1, {"device_ms": 4.0}),
           ("engine.refill", 0.58, 0.01, -1, {"device_ms": 6.0}),
           ("engine.refill", 2.5, 0.01, -1, {"device_ms": 9.0}),
           ("engine.refill", 0.59, 0.01, -1)]        # no device time read


def _read(name, obs):
    return registry.Registry.at(run.ROOT).reader(name).read(obs)


def test_spans_and_readers_on_hand_made_spans():
    tel = _tel(RECORDS)
    sp = program.spans(tel, 0.0, 1.0)
    assert sp["steps"] == [0.4, 0.2]
    assert sp["total"]["layer.attn"] == pytest.approx(0.15)
    assert sp["self"]["model.decode_step"] == pytest.approx(
        0.4 - 0.1 - 0.2 - 0.02 + 0.2 - 0.05 - 0.1)
    assert sp["self"]["layer.ffn"] == pytest.approx(0.25)
    assert sp["self"]["moe.route"] == pytest.approx(0.05)
    assert "model.sample" not in sp["total"]          # outside the steps
    obs = {"stats": [EngineStats(), EngineStats(tel=tel)],
           "window": (0.0, 1.0)}
    assert program.telemetry(obs) is tel
    for cell in ("chat", "batch"):
        assert _read(f"step_host_ms.{cell}", obs) == pytest.approx(300.0)
        assert _read(f"attn_host_share.{cell}", obs) == pytest.approx(25.0)
        assert _read(f"ffn_host_share.{cell}", obs) == pytest.approx(50.0)
        assert _read(f"refill_ms.{cell}", obs) == pytest.approx(5.0)
    notes = program.notes(obs, {"steps": 4, "launches": 6000, "syncs": 0,
                                "gaps_s": {}})
    assert notes["launches_per_step"] == 1500.0
    assert notes["step_host_ms_by_span"]["layer.ffn"] == pytest.approx(125)
    assert notes["syncs_per_step"] == 0.0


def test_readers_find_nothing_in_a_program_without_the_spans():
    """The parent program: stats that name no telemetry, or no step spans,
    records with no ``parent``, refills with no ``device_ms``; no trace."""
    class Old:                                   # a record of that version
        def __init__(self, name, t0, dur, args):
            self.name, self.t0, self.dur, self.args = name, t0, dur, args
    tel = Telemetry()
    tel._epoch = 0.0
    tel.spans += [Old("engine.segment", 0.0, 1.0, {"seg": 4}),
                  Old("engine.refill", 0.2, 0.1, {"rows": 1})]
    class OldStats:                              # EngineStats of that version
        tokens = padded_tokens = 0
    for stats in ([EngineStats(tel=tel)], [EngineStats()], [OldStats()], []):
        obs = {"stats": stats, "window": (0.0, 1.0)}
        for base in NEW:
            assert _read(f"{base}.chat", obs) is None
        assert program.notes(obs) == {}


def test_traced_tiny_cell_reports_the_span_metrics(tmp_path, monkeypatch):
    """Each new metric comes out of a traced CPU run, ``spans.py`` adds the
    span notes (the launch count needs the device's trace), and every
    existing reader gives the value it gives without the telemetry the
    drains name."""
    seen = {}
    orig = registry.Registry.reader

    def reader(self, metric):
        mod = orig(self, metric)

        class Spy:
            @staticmethod
            def read(obs):
                seen["obs"] = obs
                return mod.read(obs)
        return Spy
    monkeypatch.setattr(registry.Registry, "reader", reader)
    monkeypatch.syspath_prepend(str(run.ROOT / "portbench"))
    import spans
    # one thread, so that test workers sharing the cores leave the tiny
    # cells' windows holding steps and refills
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for cell, secs in (("tiny-dense.chat", 3.0),
                           ("tiny-moe.batch", 3.0)):
            _check_tiny_cell(tmp_path, cell, secs, seen, orig, spans)
    finally:
        torch.set_num_threads(threads)


def _check_tiny_cell(tmp_path, cell, secs, seen, orig, spans):
    root = tiny.checkout(tmp_path / cell)
    reg = registry.Registry.at(root, home=root)
    out = spans.traced(root, cell, 2 ** 33 + 1, secs, 0.0, device="cpu",
                       home=root)
    part = cell.split(".")[1]
    got = out["metrics"]
    for base in NEW:
        assert got[f"{base}.{part}"]["value"] > 0, base
    assert set(out["notes"]["step_host_ms_by_span"]) >= {
        "model.decode_step", "layer.attn", "layer.ffn", "model.head"}
    bare = {**seen["obs"], "stats": [dataclasses.replace(st, tel=None)
                                     for st in seen["obs"]["stats"]]}
    for m in reg.metrics(cell, True):
        if m["name"].split(".")[0] in NEW:
            continue
        v = orig(reg, m["name"]).read(bare)
        if v is None:
            assert m["name"] not in got
        else:
            assert got[m["name"]]["value"] == float(v), m["name"]
