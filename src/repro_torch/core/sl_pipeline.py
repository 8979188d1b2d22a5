"""Split-learning serial pipeline (paper §III-C/III-D, Figs 4-5;
counterpart of ``repro/core/sl_pipeline.py``), on one card.

The paper splits the edge model's tunable stack across an intra-cluster
chain of clients: activations ("smashed data") hop from client to client
over D2D links, gradients hop back. The reference runs the chain as a
``stage`` mesh axis (a ``shard_map`` with one ``ppermute`` a hop). The
port's card is one device, so the chain is serial: each microbatch runs
through the stages in order, each stage through its own slice of layers,
and the hand-off of the activations between stages is the hop. The logits
are the reference's (the end stage's head over each finished microbatch);
only the schedule differs, and with it no value.

- SL *inference*: :func:`pipeline_classify`.
- SL *fine-tuning*: :func:`make_sl_finetune_step`, autograd through the
  chain (the reverse hops are the backward through the stage hand-offs).
- :func:`simulate_sl`: the device-free byte and FLOP trace of the paper's
  serial workflow that ``core/comm.py::sl_round_cost`` prices.

The mesh form (``mesh=``) is not ported; it raises ``unported``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import unported
from repro_torch.core.peft import value_and_grad
from repro_torch.models.attention import param_dtype
from repro_torch.models.layers import cross_entropy, embed, rmsnorm
from repro_torch.models.transformer import _apply_seq, groups_for
from repro_torch.optim.optimizers import apply_updates

_MESH_ITEM = "later, multi-GPU sharding"


# ---------------------------------------------------------------------------
# Stage-split parameters
# ---------------------------------------------------------------------------

def split_for_stages(params: dict, cfg: ModelConfig, n_stages: int) -> dict:
    """The single layer group split into ``n_stages`` contiguous slices:
    ``{"layers": [S lists of L/S layer dicts], "adapters": [the same for
    the stack's adapters]}`` (the port's form of the reference's
    ``(S, L/S, ...)`` leaves). Only single-group stacks are supported, the
    paper's homogeneous client chain."""
    layers = params["backbone"]["layers"]
    if set(layers) != {"g0"}:
        raise ValueError(
            f"pipeline supports single-group stacks, got groups "
            f"{sorted(layers)}")
    L = len(layers["g0"])
    if L % n_stages != 0:
        raise ValueError(
            f"layer count {L} not divisible by n_stages={n_stages}")
    per = L // n_stages
    adapters = params["adapters"]["stack"].get("g0") or \
        [{} for _ in range(L)]
    return {"layers": [layers["g0"][s * per:(s + 1) * per]
                       for s in range(n_stages)],
            "adapters": [adapters[s * per:(s + 1) * per]
                         for s in range(n_stages)]}


def pipeline_classify(params: dict, stage_tree: dict, tokens: torch.Tensor,
                      cfg: ModelConfig, *, n_microbatches: int = 4,
                      mesh=None) -> torch.Tensor:
    """SL forward: tokens (B, S) -> class logits (B, n_out).

    ``params`` supplies the start and end point modules (embedding, final
    norm, head); ``stage_tree`` the stage-split stack
    (:func:`split_for_stages`). Microbatch t is rows ``t * B/M`` to
    ``(t + 1) * B/M``."""
    if mesh is not None:
        raise unported("pipeline_classify(mesh=...)", _MESH_ITEM)
    B, M = tokens.shape[0], n_microbatches
    if B % M != 0:
        raise ValueError(
            f"batch size {B} not divisible by n_microbatches={M}")
    kinds = groups_for(cfg)[0][1]
    backbone = params["backbone"]
    head = params["adapters"]["head"]
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    outs = []
    for toks in tokens.reshape(M, B // M, -1):
        x = embed(backbone["embed"], toks.long())      # start point
        for layers, adapters in zip(stage_tree["layers"],
                                    stage_tree["adapters"]):
            # one client's slice; handing x on is the D2D hop
            for lp, la in zip(layers, adapters):
                for i, k in enumerate(kinds):
                    x, _, _ = _apply_seq(k, lp[f"s{i}"],
                                         la.get(f"s{i}", {}), x, cfg,
                                         positions=positions,
                                         make_cache=False, cache_len=None,
                                         lengths=None, adapter_ids=None)
        # end point: the head over the finished microbatch
        pooled = rmsnorm(backbone["final_norm"], x).float().mean(dim=1)
        outs.append(pooled @ head["w"] + head["b"])
    return torch.cat(outs)


def make_sl_finetune_step(params: dict, cfg: ModelConfig, optimizer, *,
                          n_microbatches: int = 4,
                          lr_trainables: str = "adapters", mesh=None):
    """SL fine-tuning: the gradient flows back through the chain.

    Returns ``step(stage_tree, head, opt_state, batch) -> (stage_tree,
    head, opt_state, loss)``; the optimizer sees ``{"a": stage adapters,
    "h": head}`` (``opt_state = optimizer.init`` of that tree), as in the
    reference. ``lr_trainables`` is the reference's keyword, which neither
    package reads: the stage adapters and the head train."""
    if mesh is not None:
        raise unported("make_sl_finetune_step(mesh=...)", _MESH_ITEM)

    def loss_fn(tr, stage_layers, batch):
        p = {"backbone": params["backbone"],
             "adapters": {**params["adapters"], "head": tr["h"]}}
        logits = pipeline_classify(
            p, {"layers": stage_layers, "adapters": tr["a"]},
            batch["tokens"], cfg, n_microbatches=n_microbatches)
        return cross_entropy(logits, batch["label"])

    def step(stage_tree, head, opt_state, batch):
        tr = {"a": stage_tree["adapters"], "h": head}
        loss, grads = value_and_grad(loss_fn, tr, stage_tree["layers"],
                                     batch, has_aux=False)
        updates, opt_state = optimizer.update(grads, opt_state, tr)
        new = apply_updates(tr, updates)
        return {**stage_tree, "adapters": new["a"]}, new["h"], opt_state, \
            loss

    return step


# ---------------------------------------------------------------------------
# Device-free SL simulator (paper metrics: §III-C.2 / §III-D.2)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SLTrace:
    """Per-round accounting of one SL pass over a client chain."""
    hops: int
    smashed_bytes: int          # total D2D activation traffic (fwd)
    gradient_bytes: int         # reverse traffic (0 for inference)
    feedback_bytes: int         # end->start result feedback
    per_client_flops: list[int]
    peak_activation_bytes: int


def simulate_sl(cfg: ModelConfig, batch: int, seq: int, n_clients: int, *,
                training: bool) -> SLTrace:
    """Analytic trace of the paper's serial workflow for the cost model."""
    d = cfg.d_model
    act = batch * seq * d * param_dtype(cfg).itemsize
    hops = n_clients - 1
    layer_flops = 2 * batch * seq * (
        4 * d * d + 2 * d * cfg.d_ff) if cfg.d_ff else 2 * batch * seq * 4 * d * d
    per_layer = [layer_flops] * cfg.n_layers
    per_client = [int(sum(per_layer[i::n_clients]))
                  for i in range(n_clients)]  # round-robin layer split
    mult = 3 if training else 1              # fwd + bwd ~ 2x fwd
    n_out = max(cfg.peft.head_dim_out, 1)
    return SLTrace(
        hops=hops,
        smashed_bytes=int(act) * hops,
        gradient_bytes=int(act) * hops if training else 0,
        feedback_bytes=batch * n_out * 4,
        per_client_flops=[c * mult for c in per_client],
        peak_activation_bytes=int(act),
    )
