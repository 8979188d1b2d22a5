"""The port's spans on the device trace's clock (``core/telemetry.py``)
and at the serving path's layer boundaries (``models/``,
``launch/engine.py``), on the CPU.

Held: an enabled span is a ``torch.profiler`` range of its own name,
nested as the spans are, and records its enclosing span; a disabled one
is the shared no-op and opens no range; ``telemetry.current()`` is the
engine's telemetry for the length of a drain; a drain records one
``model.decode_step`` per step run with the layers' spans inside it, and
serves the same tokens with telemetry on and off; ``serve_trace`` counts
a request's wait from its due time.
"""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import get_config
from repro_torch.core import telemetry
from repro_torch.core.paged import PagedSpec
from repro_torch.core.telemetry import _NOOP_SPAN, Telemetry
from repro_torch.launch.engine import DecodeEngine
from repro_torch.models import model as M

LENS = [5, 9, 12, 7, 10, 3]
GENS = [4, 2, 6, 3, 5, 7]


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny models on one thread: test workers share the cores, and
    many threads each make their steps slower by far."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ranges(prof, tmp_path) -> list[dict]:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = json.loads(path.read_text())["traceEvents"]
    return [e for e in ev if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]


def test_enabled_span_is_a_profiler_range_nested_as_the_spans(tmp_path):
    tel = Telemetry()
    with tel.span("before"):                 # opened with no profiler
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with tel.span("outer", rows=3):
                with tel.span("inner"):
                    torch.ones(4).add_(1)
    rng = {e["name"]: e for e in _ranges(prof, tmp_path)}
    assert {"outer", "inner"} <= set(rng) and "before" not in rng
    o, i = rng["outer"], rng["inner"]
    assert o["tid"] == i["tid"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    names = [s.name for s in tel.spans]
    assert names == ["before", "outer", "inner"]
    before, outer, inner = tel.spans
    assert (before.parent, outer.parent, inner.parent) == (-1, 0, 1)
    assert (before.depth, outer.depth, inner.depth) == (0, 1, 2)
    assert outer.args == {"rows": 3}
    assert before.dur >= outer.dur >= inner.dur > 0


def test_disabled_span_is_the_noop_and_opens_no_range(tmp_path):
    tel = Telemetry(enabled=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sp = tel.span("off")
        with sp:
            torch.ones(4).add_(1)
    assert sp is _NOOP_SPAN
    assert tel.spans == []
    assert "off" not in {e["name"] for e in _ranges(prof, tmp_path)}


def _tiny(arch: str):
    cfg = get_config(arch).reduced().with_(dtype="float32")
    return cfg, M.init(cfg, 3, device="cpu")


@pytest.fixture(scope="module", params=["qwen2-7b", "granite-moe-1b-a400m"])
def model(request):
    cfg, params = _tiny(request.param)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in LENS]
    return cfg, params, prompts


def _drain(model, tel):
    cfg, params, prompts = model
    eng = DecodeEngine(cfg, slots=3, device="cpu", tel=tel)
    uids = [eng.submit(p, g) for p, g in zip(prompts, GENS)]
    comps, stats = eng.run(params)
    by = {c.uid: c.tokens for c in comps}
    return [by[u] for u in uids], stats


def test_current_follows_the_engines_tel_for_one_drain(model, monkeypatch):
    seen = []
    orig = M.segment

    def segment(*a, **kw):
        seen.append(telemetry.current())
        return orig(*a, **kw)
    monkeypatch.setattr(M, "segment", segment)
    off = telemetry.current()
    assert not off.enabled
    mine, outer = Telemetry(), Telemetry()
    _drain(model, mine)
    assert seen and all(t is mine for t in seen)
    assert telemetry.current() is off
    seen.clear()
    with telemetry.using(outer):
        _drain(model, None)                  # no tel=: the global one
        assert telemetry.current() is outer
    assert seen and all(t is telemetry.get() for t in seen)
    assert telemetry.current() is off


def test_drain_records_the_layer_spans_inside_each_step(model):
    cfg = model[0]
    tel = Telemetry()
    _drain(model, tel)
    spans = tel.spans
    steps = [i for i, s in enumerate(spans) if s.name == "model.decode_step"]
    run = sum(s.args["seg"] for s in spans if s.name == "engine.segment")
    assert len(steps) == run > 0
    kids: dict = {i: [] for i in steps}
    for s in spans:
        if s.parent in kids:
            kids[s.parent].append(s.name)
    for i in steps:
        assert spans[i].args == {"rows": 3}
        assert sorted(kids[i]) == sorted(["layer.attn"] * cfg.n_layers
                                         + ["layer.ffn"] * cfg.n_layers
                                         + ["model.head"])
    moe = [s for s in spans if s.name.startswith("moe.")]
    if cfg.family == "moe":
        ffn = {i for i, s in enumerate(spans) if s.name == "layer.ffn"}
        assert moe and all(s.parent in ffn for s in moe)
        in_steps = [s.name for s in moe
                    if spans[spans[s.parent].parent].name
                    == "model.decode_step"]
        assert sorted(in_steps) == sorted(
            ["moe.route", "moe.experts", "moe.combine"]
            * cfg.n_layers * len(steps))
    else:
        assert moe == []
    samples = [s for s in spans if s.name == "model.sample"]
    assert len(samples) == len(steps)
    # prefill and refill spans carry their device time (host clock on CPU)
    waves = [s for s in spans if s.name in ("engine.prefill",
                                            "engine.refill")]
    assert any(s.name == "engine.refill" for s in waves)
    assert all(s.args["device_ms"] >= 0 for s in waves)


def test_tokens_are_bit_equal_with_telemetry_on_and_off(model):
    on, st_on = _drain(model, Telemetry())
    off, st_off = _drain(model, Telemetry(enabled=False))
    assert st_on.tokens == st_off.tokens
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)


def test_engine_stats_name_the_telemetry_the_drain_recorded_into(model):
    tel = Telemetry()
    _, st_on = _drain(model, tel)
    _, st_off = _drain(model, Telemetry(enabled=False))
    assert st_on.tel is tel and st_off.tel is None


def test_serve_trace_counts_the_queue_wait_from_the_due_time():
    """The second arrival falls due while the first one's segment runs:
    its queue time counts from its due time, not from the poll after the
    segment that admitted it."""
    cfg, params = _tiny("qwen2-7b")
    rng = np.random.default_rng(7)
    first = rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
    second = rng.integers(0, cfg.vocab_size, 5).astype(np.int32)
    tel = Telemetry()
    eng = DecodeEngine(cfg, slots=2, device="cpu", tel=tel)
    due = 0.1
    comps, _ = eng.serve_trace(params, [(0.0, first, 200), (due, second, 3)])
    by = {c.uid: c for c in comps}
    seg = next(s for s in tel.spans if s.name == "engine.segment")
    seg_end = tel._epoch + seg.t0 + seg.dur
    t_due = eng._trace_t0 + due
    assert by[1].wave == 1 and seg_end > t_due
    assert by[1].queue_s >= seg_end - t_due
    assert by[1].ttft_s >= by[1].queue_s
    solo = M.generate(params, cfg, torch.from_numpy(second)[None], gen=3)
    np.testing.assert_array_equal(by[1].tokens, solo[0].numpy())


def test_paged_drain_times_its_prefill_and_refills(model):
    cfg, params, prompts = model
    tel = Telemetry()
    eng = DecodeEngine(cfg, slots=3, device="cpu", tel=tel,
                       paged=PagedSpec(n_blocks=32, block_size=8))
    for p, g in zip(prompts, GENS):
        eng.submit(p, g)
    eng.run(params)
    waves = [s for s in tel.spans if s.name in ("engine.prefill",
                                                "engine.refill")]
    assert {s.name for s in waves} == {"engine.prefill", "engine.refill"}
    assert all(s.args["paged"] and s.args["device_ms"] >= 0 for s in waves)
    steps = [s for s in tel.spans if s.name == "model.decode_step"]
    assert len(steps) == sum(s.args["seg"] for s in tel.spans
                             if s.name == "engine.segment")
