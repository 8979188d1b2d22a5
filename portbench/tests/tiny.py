"""A throwaway checkout for CPU runs of the harness: a ``BENCHMARK.json``
and tiny configuration and cell files in a temporary directory, found by
name like the real ones (the real drivers, metrics and reference)."""
from __future__ import annotations

import json
from pathlib import Path

DENSE = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 16, "d_ff": 128, "vocab_size": 256, "qkv_bias": True,
         "rope_theta": 1000000.0, "rms_norm_eps": 1e-06,
         "tie_embeddings": False, "dtype": "float32", "n_prefix": 4,
         "lora_rank": 4, "lora_alpha": 16.0, "lora_targets": ["q", "v"]}
MOE = {**DENSE, "qkv_bias": False, "rope_theta": 10000.0,
       "tie_embeddings": True, "d_ff": 32, "n_experts": 4, "top_k": 2,
       "d_ff_expert": 32, "capacity_factor": 0.0}


def _override(sz: dict) -> dict:
    o = {k: sz[k] for k in ("n_layers", "d_model", "n_heads", "n_kv_heads",
                            "head_dim", "d_ff", "vocab_size", "dtype")}
    o["peft"] = {"n_prefix": sz["n_prefix"], "lora_rank": sz["lora_rank"]}
    if "n_experts" in sz:
        o["moe"] = {k: sz[k] for k in ("n_experts", "top_k", "d_ff_expert",
                                       "capacity_factor")}
    return o


def checkout(tmp: Path, *, limit: float = 1e-3, mean_limit: float = 1e-4,
             rate: float = 40.0) -> Path:
    """Write the files; returns the root to hand to ``run.run_cell``."""
    tmp = Path(tmp)
    for d in ("configs", "workloads"):
        (tmp / d).mkdir(parents=True, exist_ok=True)
    confs = {"tiny-dense": ("qwen2-7b", DENSE),
             "tiny-moe": ("granite-moe-1b-a400m", MOE)}
    for name, (reg, sz) in confs.items():
        (tmp / "configs" / f"{name}.json").write_text(json.dumps({
            "name": name, "source": "test", "registry": reg,
            "override": _override(sz), "reference": "decoder",
            "reduced": [], "sizes": sz}))
    # each tiny cell compares the number its real cell compares
    chat_check = {"tokens": 400, "requests": 16, "number": "logit_gap",
                  "limit": limit}
    batch_check = {**chat_check, "number": "logit_gap_mean",
                   "limit": mean_limit}
    cells = {
        "tiny-dense.chat": {
            "config": "tiny-dense", "driver": "open_loop", "slots": 4,
            "burst": 6, "lead_in_s": 0.3,
            "traffic": {"rate": rate, "domains": 3, "zipf_s": 1.1,
                        "prompt": {"median": 12, "sigma": 0.8, "min": 4,
                                   "max": 32},
                        "output": {"median": 6, "sigma": 0.8, "min": 2,
                                   "max": 16}},
            "trace": {"offset_s": 0.1, "seconds": 0.2},
            "check": chat_check},
        "tiny-moe.batch": {
            "config": "tiny-moe", "driver": "drains", "slots": 4,
            "drain_requests": 8, "warm": {"drains": 1, "gen": 3},
            "traffic": {"domains": 3, "zipf_s": 1.1,
                        "prompt": {"median": 12, "sigma": 0.8, "min": 4,
                                   "max": 32},
                        "output": {"median": 6, "sigma": 0.8, "min": 2,
                                   "max": 16}},
            "trace": {"offset_s": 0.1, "seconds": 0.2},
            "check": batch_check}}
    for name, c in cells.items():
        (tmp / "workloads" / f"{name}.json").write_text(json.dumps(c))
    real = json.loads((Path(__file__).resolve().parents[2]
                       / "BENCHMARK.json").read_text())
    chat, batch = "tiny-dense.chat", "tiny-moe.batch"
    ren = {"qwen2-7b.bank-chat": chat,
           "granite-moe-1b-a400m.bank-batch": batch}

    def cells_of(m):
        return [ren.get(w, w) for w in m.get("workloads", [])]
    bench = {
        "configs": [{"name": n, "file": f"configs/{n}.json"}
                    for n in confs],
        "workloads": [{"name": chat, "config": "tiny-dense", "chips": 1},
                      {"name": batch, "config": "tiny-moe", "chips": 1}],
        "end_to_end": [{**m, **({"workloads": cells_of(m)}
                                if "workloads" in m else {})}
                       for m in real["end_to_end"]],
        "per_layer": [{**m, "workloads": cells_of(m)}
                      for m in real["per_layer"]]}
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
