"""A configuration, a cell and a metric added as files are found by name,
and BENCHMARK.json keeps to the contract's shape."""
import json
import re
from pathlib import Path

import pytest

from portbench import run
from portbench.lib import registry
from portbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_added_files_are_found_by_name(tmp_path):
    root = tiny.checkout(tmp_path)
    (root / "metrics").mkdir()
    (root / "metrics" / "tokens_out.extra.py").write_text(
        "def read(obs):\n    return sum(r['n_out'] for r in "
        "obs['requests'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "tokens_out.extra", "unit": "tokens",
                               "better": "higher", "source": "host_clock",
                               "layer": "engine", "moves": "serve_tok_s",
                               "workloads": ["tiny-moe.batch"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    reg = registry.Registry.at(root, home=root)
    assert reg.cell("tiny-dense.chat")["driver"] == "open_loop"
    assert reg.config("tiny-moe")["sizes"]["n_experts"] == 4
    assert reg.driver("drains").run                 # the real one
    assert reg.reader("tokens_out.extra").read(
        {"requests": [{"n_out": 3}, {"n_out": 4}]}) == 7
    out = run.run_cell(root, "tiny-moe.batch", 11, 0.3, True, device="cpu",
                       t_start=0.0, reg=reg)
    assert out["metrics"]["tokens_out.extra"]["value"] > 0
    assert list(out)[-1] == "checks"


def test_a_metric_without_a_file_of_its_own_is_read_by_its_base(tmp_path):
    root = tiny.checkout(tmp_path)
    (root / "metrics").mkdir()
    (root / "metrics" / "tokens_out.py").write_text(
        "def read(obs):\n    return 1\n")
    (root / "metrics" / "tokens_out.chat.py").write_text(
        "def read(obs):\n    return 2\n")
    reg = registry.Registry.at(root, home=root)
    assert reg.reader("tokens_out.batch").read({}) == 1
    assert reg.reader("tokens_out.chat").read({}) == 2
    assert reg.reader("tokens_out").read({}) == 1
    with pytest.raises(FileNotFoundError):
        reg.reader("no_such_metric.chat")


def test_benchmark_json_shape():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    reg = registry.Registry.at(ROOT)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    cells = {w["name"]: w for w in b["workloads"]}
    assert "setup_s" in e2e and 1 <= b["run_seconds"] <= 51
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert reg.reader(m["name"]).read
        for w in m.get("workloads", []):
            assert w in cells
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            mv = e2e[m["moves"]]
            assert "workloads" not in mv or w in mv["workloads"]
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        reported = [m for m in b["end_to_end"]
                    if "workloads" not in m or w["name"] in m["workloads"]]
        assert len(reported) >= 2
        assert any(w["name"] in m["workloads"] for m in b["per_layer"])
        cell = reg.cell(w["name"])
        assert cell["config"] == w["config"] and reg.driver(cell["driver"])
    from repro_torch.configs.base import get_config
    for c in b["configs"]:
        conf = reg.config(c["name"])
        assert conf["reduced"] == c["reduced"]
        cfg = run.configure(get_config(conf["registry"]),
                            conf.get("override", {}))
        run.agree(cfg, conf["sizes"])


@pytest.mark.parametrize("name", ["qwen2-7b", "granite-moe-1b-a400m"])
def test_config_files_hold_the_published_sizes(name):
    conf = registry.Registry.at(ROOT).config(name)
    pub, sz = conf["published"], conf["sizes"]
    assert pub["hidden_size"] == sz["d_model"]
    assert pub["num_hidden_layers"] == sz["n_layers"]
    assert pub["num_attention_heads"] == sz["n_heads"]
    assert pub["num_key_value_heads"] == sz["n_kv_heads"]
    assert pub["vocab_size"] == sz["vocab_size"]
    assert pub["tie_word_embeddings"] == sz["tie_embeddings"]
    assert pub["rope_theta"] == sz["rope_theta"]
    if "num_local_experts" in pub:
        assert pub["num_local_experts"] == sz["n_experts"]
        assert pub["num_experts_per_tok"] == sz["top_k"]
        assert pub["intermediate_size"] == sz["d_ff_expert"]
        assert sz["capacity_factor"] <= 0          # dropless
    else:
        assert pub["intermediate_size"] == sz["d_ff"]
