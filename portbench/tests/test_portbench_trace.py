"""Reading a profiler trace: busy time, kernels attributed to the probe
range their launch ran in, idle gaps by host range, roofline shares."""
import json

from portbench.lib import trace


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def test_read_attributes_kernels_to_probe_ranges(tmp_path):
    ev = [_x("user_annotation", "hb:model.segment", 0, 100),
          _x("user_annotation", "pb:0", 10, 5),
          _x("cuda_runtime", "cudaLaunchKernel", 11, 1, correlation=1),
          _x("kernel", "decode_split_kernel", 20, 10, tid=7, correlation=1),
          _x("user_annotation", "pb:1", 30, 5),
          _x("cuda_runtime", "cudaLaunchKernel", 31, 1, correlation=2),
          _x("kernel", "lora_tile", 32, 4, tid=7, correlation=2),
          _x("cuda_runtime", "cudaLaunchKernel", 50, 1, correlation=3),
          _x("kernel", "nvjet_gemm", 60, 20, tid=7, correlation=3),
          _x("gpu_memcpy", "Memcpy HtoD", 85, 5, tid=7, correlation=4)]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    tr = trace.read(str(p), 100e-6)
    assert not p.exists()
    assert abs(tr["busy_s"] - 39e-6) < 1e-12
    assert tr["probe_s"] == {0: 10e-6, 1: 4e-6}
    assert set(tr["kernels_s"]) == {"decode_split_kernel", "lora_tile",
                                    "nvjet_gemm"}
    assert abs(tr["gaps_s"]["model.segment"] - (2 + 24 + 5) * 1e-6) < 1e-12
    bounds = [("flash_decode", 0.005), ("lora_bgmv_rows", 0.002)]
    groups = {"flash_decode": "attn", "lora_bgmv_rows": "lora"}
    assert abs(trace.roofline_share(bounds, tr["probe_s"], groups, "attn")
               - 50.0) < 1e-9
    assert trace.roofline_share(bounds, {}, groups, "attn") is None
    assert abs(tr["groups_s"]["GEMM (cuBLAS)"] - 20e-6) < 1e-12
    assert abs(tr["groups_s"]["port kernels"] - 14e-6) < 1e-12
    bd = trace.breakdown(tr)
    assert bd["device_ops"][0][0] == "nvjet_gemm"


def test_group_and_busy():
    assert trace.group("attn_wgmma_kernel<128>") == "port kernels"
    assert trace.group("nvjet_tst_128x64") == "GEMM (cuBLAS)"
    assert trace.busy_us([(0, 2), (1, 3), (5, 6)]) == 4
