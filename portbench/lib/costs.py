"""The card's peaks and each kernel's operations and bytes: a frozen copy
of the port's ``launch/roofline.py`` (``PEAK_FLOPS``, ``HBM_BW``,
``PEAK_EXP``, ``KernelCost``, ``kernel_costs``) at the time the benchmark
was defined, so that a later change to the program cannot move the
yardstick a kernel is held to. Bounds are from the NVIDIA H100 SXM data
sheet (dense rates, 700 W)."""
from __future__ import annotations

import dataclasses

import torch

# NVIDIA H100 SXM data sheet: dense rates (no sparsity) at the 700 W
# power limit; f32 outside the tensor cores
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float8_e4m3fn: 1979e12, torch.float8_e5m2: 1979e12,
              torch.int8: 1979e12, torch.float32: 67e12}
HBM_BW = 3.35e12                 # B/s, 80 GB of HBM3
# the boost clock, and exponentials per second through the
# special-function units: 16 per clock per SM (compute capability 9.0) x
# 132 SMs
SM_CLOCK = 1.98e9
PEAK_EXP = 16 * 132 * SM_CLOCK
HBM_BYTES = 80e9                 # device memory of one card


def _peak(dtype) -> float:
    return PEAK_FLOPS.get(dtype, PEAK_FLOPS[torch.float32])


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """Bytes moved (each input read once, each output written once),
    operations (at ``flops_dtype``'s peak) and exponentials (through the
    special-function units) of one kernel call."""
    bytes: float
    flops: float
    exps: float = 0.0
    flops_dtype: torch.dtype = torch.bfloat16

    def terms(self) -> dict:
        """Each term's least time, ms."""
        return {"bytes": self.bytes / HBM_BW * 1e3,
                "flops": self.flops / _peak(self.flops_dtype) * 1e3,
                "exp": self.exps / PEAK_EXP * 1e3}

    def bound(self) -> tuple[float, str]:
        """The least time the card could take (ms), and what bounds it:
        ``"bytes"`` or ``"operations"``."""
        t = self.terms()
        ms = max(t.values())
        return ms, "bytes" if t["bytes"] >= ms else "operations"


def _elt(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def kernel_costs(name: str, dtype: torch.dtype = torch.bfloat16,
                 **d) -> KernelCost:
    """The count of one call of kernel ``name`` from its dimensions ``d``:

    - ``lora_matmul``: M, K, N, r, bias (default True);
    - ``lora_matmul_bwd``: M, K, N, r (dA and dB written in f32);
    - ``lora_bgmv_rows`` / ``lora_bgmv_seq``: M (rows in all), K, N, r,
      slots (bank slots the ids name), ids (their count), bias;
    - ``flash_attention``: B, S, T, Hq, Hkv, D, visible (visible (query,
      key) pairs of one row);
    - ``flash_decode``: B, Hq, Hkv, D, Tc (cache slots), keys (visible
      cache keys of all rows), n_p (bank slots a row sees), n_read (bank
      slots read: 1 shared, B per row, the distinct ids of a stacked
      bank), ids (bool: the rows' slot ids are read), lse (bool: the
      partial mode's (B, Hq) f32 log-sum-exp is written);
    - ``flash_decode_paged``: B, Hq, Hkv, D, maxb (table width), keys
      (visible keys of all rows, prefix slots included);
    - ``selective_scan``: B, S, Di, N, h0 (bool), ck (checkpoint bytes
      written, default 0);
    - ``rglru_scan``: B, S, W, h0 (bool), ck;
    - ``selective_scan_bwd``: B, S, Di, N, h0 (bool);
    - ``rglru_scan_bwd``: B, S, W, h0 ("none", "shared" or "row");
    - ``attention_bwd`` (the plain backward of ``flash_attention``, no
      kernel): B, S, T, Hq, Hkv, D.

    ``dtype`` is the call's working type (its activations)."""
    e = _elt(dtype)
    f32 = torch.float32
    if name in ("lora_matmul", "lora_bgmv_rows", "lora_bgmv_seq"):
        M, K, N, r = d["M"], d["K"], d["N"], d["r"]
        bias = N if d.get("bias", True) else 0
        if name == "lora_matmul":
            nbytes = e * (M * K + K * N + K * r + r * N + bias + M * N)
        else:
            nbytes = e * (M * K + K * N + d["slots"] * (K * r + r * N)
                          + bias + M * N) + 4 * d["ids"]
        return KernelCost(nbytes, 2 * M * N * K + 2 * M * r * (K + N),
                          flops_dtype=dtype)
    if name == "lora_matmul_bwd":
        M, K, N, r = d["M"], d["K"], d["N"], d["r"]
        return KernelCost(e * (M * K + M * N + K * r + r * N)
                          + 4 * (K * r + r * N), 4 * M * r * (K + N),
                          flops_dtype=dtype)
    if name == "flash_attention":
        B, S, T, Hq, Hkv, D = (d[k] for k in ("B", "S", "T", "Hq", "Hkv",
                                              "D"))
        return KernelCost(e * (2 * B * S * Hq * D + 2 * B * T * Hkv * D)
                          + 4 * (S + T),
                          4 * D * d["visible"] * B * Hq, flops_dtype=dtype)
    if name == "flash_decode":
        B, Hq, Hkv, D, n_p = d["B"], d["Hq"], d["Hkv"], d["D"], d["n_p"]
        keys = d["keys"]
        nbytes = e * (2 * B * Hq * D + 2 * (keys + d["n_read"] * n_p)
                      * Hkv * D) + 4 * (B + B * d["Tc"]) \
            + (4 * B if d.get("ids") else 0) \
            + (4 * B * Hq if d.get("lse") else 0)
        return KernelCost(nbytes, 4 * D * (keys + B * n_p) * Hq,
                          flops_dtype=dtype)
    if name == "flash_decode_paged":
        B, Hq, Hkv, D, keys = d["B"], d["Hq"], d["Hkv"], d["D"], d["keys"]
        return KernelCost(e * (2 * B * Hq * D + 2 * keys * Hkv * D)
                          + 4 * (B + B * d["maxb"]), 4 * D * keys * Hq,
                          flops_dtype=dtype)
    if name == "selective_scan":
        B, S, Di, N = d["B"], d["S"], d["Di"], d["N"]
        exps = B * S * Di * N
        nbytes = e * (3 * B * S * Di + 2 * B * S * N) + 4 * (
            Di * N + Di + B * Di * N * (2 if d["h0"] else 1)) \
            + d.get("ck", 0)
        # per (b, t, c, n): dt*A, h*dA + (dt x)*B, acc += h*C
        return KernelCost(nbytes, 6 * exps + 3 * B * S * Di, exps, f32)
    if name == "rglru_scan":
        B, S, W = d["B"], d["S"], d["W"]
        n = B * S * W
        nbytes = 4 * e * n + 4 * W + 4 * B * W * (2 if d["h0"] else 1) \
            + d.get("ck", 0)
        # per element: through the special-function units a power of 2
        # and a reciprocal for each sigmoid, a_t's power of 2, the square
        # root; on the f32 cores a product and an add for each sigmoid, r
        # log_a, a_t², 1 - a_t², its max with 0, two products, the chain
        return KernelCost(nbytes, 12 * n, 6 * n, f32)
    if name == "selective_scan_bwd":
        B, S, Di, N = d["B"], d["S"], d["Di"], d["N"]
        n, exps = B * S * Di, B * S * Di * N
        nbytes = e * (5 * n + 4 * B * S * N) + 4 * (
            Di * N + Di + B * Di * N * (2 if d["h0"] else 1))
        # per (b, t, c, n): the forward's step for the states and the
        # reverse step (g += dy C, g B, the ddt, dB and dC terms, g dA)
        return KernelCost(nbytes, 18 * exps, exps, f32)
    if name == "rglru_scan_bwd":
        B, S, W = d["B"], d["S"], d["W"]
        n = B * S * W
        h0 = {"none": 0, "shared": W, "row": B * W}[d["h0"]]
        # mufu: the two sigmoids (2 each), a_t, the square root, 1 / s;
        # f32: the gates (8), the chain (2), the reverse step (16)
        return KernelCost(7 * e * n + 4 * (W + h0 + B * W), 26 * n, 7 * n,
                          f32)
    if name == "attention_bwd":
        B, S, T, Hq, Hkv, D = (d[k] for k in ("B", "S", "T", "Hq", "Hkv",
                                              "D"))
        n_sc = B * Hq * S * T          # f32 scores, masked ones included
        # q, k, v, dout read and dq, dk, dv written once; the score-sized
        # f32 tensors of its chunks: 13 reads and 9 writes (scores, scale,
        # mask fill, where, softmax, dp, p dp, its sum, dp - sum, ds, and
        # the three products that read ds or p); 5 products of 2 D flops
        # a score
        return KernelCost(2 * e * (2 * B * S * Hq * D + 2 * B * T * Hkv * D)
                          + 4 * 22 * n_sc, 10 * D * n_sc, flops_dtype=f32)
    raise ValueError(f"kernel_costs: unknown kernel {name!r}")
