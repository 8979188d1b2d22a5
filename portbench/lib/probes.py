"""Kernel-call probes for the traced run.

:func:`install` wraps the port's kernel entry points (the functions of
``repro_torch.kernels.{lora_matmul, lora_bgmv, flash_attention,
flash_decode}`` that ``kernels/ops.py`` dispatches to, and that the
LoRA product's backward calls) at run time, without editing the
program. While :attr:`Probes.active`, each call:

- records its logical dimensions as :func:`costs.kernel_costs` takes
  them; those that depend on values (visible keys, distinct adapter
  slots) are reduced on the device before the call, with no host sync,
  and read once the traced window has closed;
- runs inside a profiler range ``pb:<index>``, so the kernels it
  launches are attributed to it (``lib/trace.py``).

The kernel groups: ``attn`` (``flash_attention``, ``flash_decode``,
``flash_decode_paged``) and ``lora`` (``lora_matmul``,
``lora_matmul_bwd``, ``lora_bgmv_rows``, ``lora_bgmv_seq``).
"""
from __future__ import annotations

import functools
import inspect

import torch

from portbench.lib import costs

GROUPS = {"flash_attention": "attn", "flash_decode": "attn",
          "flash_decode_paged": "attn", "lora_matmul": "lora",
          "lora_matmul_bwd": "lora", "lora_bgmv_rows": "lora",
          "lora_bgmv_seq": "lora"}
# kernel name -> (module of repro_torch.kernels, function)
_SITES = {"lora_matmul": ("lora_matmul", "lora_matmul"),
          "lora_matmul_bwd": ("lora_matmul", "lora_matmul_bwd"),
          "lora_bgmv_rows": ("lora_bgmv", "lora_bgmv_rows"),
          "lora_bgmv_seq": ("lora_bgmv", "lora_bgmv_seq"),
          "flash_attention": ("flash_attention", "flash_attention"),
          "flash_decode": ("flash_decode", "flash_decode"),
          "flash_decode_paged": ("flash_decode", "flash_decode_paged")}


def _distinct(ids: torch.Tensor, n_slots: int) -> torch.Tensor:
    seen = torch.zeros(n_slots, dtype=torch.int32, device=ids.device)
    return seen.index_fill_(0, ids.reshape(-1).long(), 1).sum()


def _visible_pairs(q_pos, kv_pos, window: int, causal: bool):
    q = q_pos.reshape(-1).long()[:, None]
    k = kv_pos.reshape(-1).long()[None, :]
    vis = (k <= q) if causal else (k < 10 ** 8).expand(q.shape[0], -1)
    if window and window > 0:
        vis = vis & ((q - k) < window)
    return (vis | (k < 0)).sum()


def _decode_keys(q_pos, kv_pos, B: int, Tc: int, window: int,
                 causal: bool):
    qp = q_pos.reshape(-1, 1).long().expand(B, 1)
    kp = kv_pos.long().expand(B, Tc)
    vis = (kp <= qp) if causal else (kp < 10 ** 8)
    if window and window > 0:
        vis = vis & (qp - kp < window)
    return (vis | (kp < 0)).sum()


def dims(name: str, a: dict) -> tuple[dict, dict, torch.dtype]:
    """(host dims, device-scalar dims, working dtype) of one call, its
    arguments ``a`` bound by parameter name."""
    if name == "lora_matmul":
        x, w = a["x"], a["w"]
        return ({"M": x.shape[0], "K": x.shape[1], "N": w.shape[1],
                 "r": a["a"].shape[1], "bias": a.get("bias") is not None},
                {}, x.dtype)
    if name == "lora_matmul_bwd":
        x, dy = a["x"], a["dy"]
        return ({"M": x.shape[0], "K": x.shape[1], "N": dy.shape[1],
                 "r": a["a"].shape[1]}, {}, x.dtype)
    if name in ("lora_bgmv_rows", "lora_bgmv_seq"):
        x, w, ids = a["x"], a["w"], a["adapter_ids"]
        return ({"M": x.numel() // x.shape[-1], "K": x.shape[-1],
                 "N": w.shape[1], "r": a["a"].shape[2], "ids": ids.numel(),
                 "bias": a.get("bias") is not None},
                {"slots": _distinct(ids, a["a"].shape[0])}, x.dtype)
    if name == "flash_attention":
        q, k = a["q"], a["k"]
        B, S, Hq, D = q.shape
        return ({"B": B, "S": S, "T": k.shape[1], "Hq": Hq,
                 "Hkv": k.shape[2], "D": D},
                {"visible": _visible_pairs(a["q_pos"], a["kv_pos"],
                                           a.get("window", 0),
                                           a.get("causal", True))},
                q.dtype)
    if name == "flash_decode":
        q, k, pk = a["q"], a["k"], a.get("prefix_k")
        B, Hq, D = q.shape
        host = {"B": B, "Hq": Hq, "Hkv": k.shape[2], "D": D,
                "Tc": k.shape[1], "n_p": 0, "n_read": 0,
                "ids": a.get("prefix_ids") is not None,
                "lse": bool(a.get("return_lse", False))}
        dev = {"keys": _decode_keys(a["q_pos"], a["kv_pos"], B, k.shape[1],
                                    a.get("window", 0),
                                    a.get("causal", True))}
        if pk is not None:
            host["n_p"] = pk.shape[-3]
            if a.get("prefix_ids") is not None:
                dev["n_read"] = _distinct(a["prefix_ids"], pk.shape[0])
            else:
                host["n_read"] = 1 if pk.dim() == 3 else B
        return host, dev, q.dtype
    if name == "flash_decode_paged":
        q, kp, pk = a["q"], a["k_pool"], a.get("prefix_k")
        B, Hq, D = q.shape
        maxb, bs = a["table"].shape[1], kp.shape[1]
        n_p = 0 if pk is None else pk.shape[-3]
        keys = (a["q_pos"].long() + 1).clamp(0, maxb * bs).sum() + B * n_p
        return ({"B": B, "Hq": Hq, "Hkv": kp.shape[2], "D": D,
                 "maxb": maxb}, {"keys": keys}, q.dtype)
    raise ValueError(f"probes: unknown kernel {name!r}")


class Probes:
    """The calls recorded while :attr:`active`."""

    def __init__(self):
        self.active = False
        self.calls: list[tuple[str, dict, dict, torch.dtype]] = []
        self._undo: list = []

    def install(self) -> "Probes":
        import importlib
        for name, (mod_name, fn_name) in _SITES.items():
            mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
            orig = getattr(mod, fn_name)
            setattr(mod, fn_name, self._wrap(name, orig))
            self._undo.append((mod, fn_name, orig))
        return self

    def uninstall(self) -> None:
        for mod, fn_name, orig in reversed(self._undo):
            setattr(mod, fn_name, orig)
        self._undo.clear()

    def _wrap(self, name: str, orig):
        sig = inspect.signature(orig)

        @functools.wraps(orig)
        def probe(*args, **kwargs):
            if not self.active:
                return orig(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            host, dev, dtype = dims(name, dict(bound.arguments))
            idx = len(self.calls)
            self.calls.append((name, host, dev, dtype))
            with torch.profiler.record_function(f"pb:{idx}"):
                return orig(*args, **kwargs)
        return probe

    def bounds_ms(self) -> list[tuple[str, float]]:
        """(kernel name, roofline bound in ms) of every recorded call, in
        call order; the device-side dims are read here, in one fetch."""
        devs = [v for _, _, dev, _ in self.calls for v in dev.values()]
        vals = torch.stack([v.reshape(()).long() for v in devs]).cpu() \
            .tolist() if devs else []
        out, i = [], 0
        for name, host, dev, dtype in self.calls:
            d = dict(host)
            for k in dev:
                d[k] = int(vals[i])
                i += 1
            out.append((name, costs.kernel_costs(name, dtype, **d)
                        .bound()[0]))
        return out
