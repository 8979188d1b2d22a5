"""Split-learning pipeline (paper §III-C/III-D, Figs 4-5; counterpart of
``repro/core/sl_pipeline.py``).

The paper splits the edge model's tunable stack across an intra-cluster
chain of clients: activations ("smashed data") hop from client to client
over D2D links, gradients hop back. The reference runs the chain as a
``stage`` mesh axis (a ``shard_map`` with one ``ppermute`` a hop). The
port runs it two ways, with the same logits (the end stage's head over
each finished microbatch):

- without a mesh, serially on one device: each microbatch runs through
  the stages in order, each stage through its own slice of layers, and
  the hand-off of the activations between stages is the hop;
- with ``mesh=`` a (`stage`,) mesh (``launch/mesh.py::make_stage_mesh``),
  rank s runs only stage s's layers and adapters, in the reference's
  GPipe schedule: M + S - 1 ticks, stage 0 embeds microbatch t while t <
  M, every stage runs its slice, the end stage's head gives logits while
  t >= S - 1, and one ring shift s -> s + 1 a tick (:class:`_Hop`, one
  ``batch_isend_irecv``; its backward is the reverse shift). Every rank
  runs the same ticks, so the sends pair up. The end stage's logits are
  summed over `stage` (the reference's ``psum``, ``dt.SumRanks``), whose
  backward hands the loss's gradient on once, so the chain's gradient is
  the monolithic one.

- SL *inference*: :func:`pipeline_classify`.
- SL *fine-tuning*: :func:`make_sl_finetune_step`, autograd through the
  chain (the reverse hops are the backward through the stage hand-offs).
- :func:`simulate_sl`: the device-free byte and FLOP trace of the paper's
  serial workflow that ``core/comm.py::sl_round_cost`` prices.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.peft import value_and_grad
from repro_torch.models.attention import param_dtype
from repro_torch.models.layers import cross_entropy, embed, rmsnorm
from repro_torch.models.params import tree_leaves
from repro_torch.models.transformer import _apply_seq, groups_for
from repro_torch.optim.optimizers import apply_updates
from repro_torch.sharding import dtensor as dt


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
    ``(t + 1) * B/M``. With ``mesh`` a (`stage`,) mesh of S ranks, rank s
    runs stage s (see the module note) and every rank returns the
    logits."""
    B, M = tokens.shape[0], n_microbatches
    if B % M != 0:
        raise ValueError(
            f"batch size {B} not divisible by n_microbatches={M}")
    if mesh is not None:
        return _pipeline_mesh(params, stage_tree, tokens, cfg, M, mesh)
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
            x = _run_stage(layers, adapters, x, cfg, kinds, positions)
        outs.append(_head(backbone, head, x))          # end point
    return torch.cat(outs)


def _run_stage(layers: list, adapters: list, x, cfg: ModelConfig, kinds,
               positions):
    """One client's slice of layers over x (B, S, d)."""
    for lp, la in zip(layers, adapters):
        for i, k in enumerate(kinds):
            x, _, _ = _apply_seq(k, lp[f"s{i}"], la.get(f"s{i}", {}), x,
                                 cfg, positions=positions, make_cache=False,
                                 cache_len=None, lengths=None,
                                 adapter_ids=None)
    return x


def _head(backbone: dict, head: dict, x) -> torch.Tensor:
    """The end point: the head over a finished microbatch's mean-pooled
    final-normed states (f32)."""
    pooled = rmsnorm(backbone["final_norm"], x).float().mean(dim=1)
    return pooled @ head["w"] + head["b"]


def _shift(x: torch.Tensor, to: int, frm: int, group) -> torch.Tensor:
    """Send ``x`` to global rank ``to`` and receive its like from ``frm``,
    in one ``batch_isend_irecv``."""
    import torch.distributed as dist
    x = x.contiguous()
    out = torch.empty_like(x)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, to, group),
            dist.P2POp(dist.irecv, out, frm, group)]):
        req.wait()
    return out


class _Hop(torch.autograd.Function):
    """The D2D hop of one tick: each stage sends its activations to the
    next one (s -> s + 1, the ring of the reference's ``ppermute``) and
    receives the previous one's; the backward sends the gradient back
    (s -> s - 1), the paper's reverse smashed-data flow."""

    @staticmethod
    def forward(ctx, x, group, nxt: int, prv: int):
        ctx.group, ctx.nxt, ctx.prv = group, nxt, prv
        return _shift(x, nxt, prv, group)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.prv, ctx.nxt, ctx.group), None, None, None


def _pipeline_mesh(params: dict, stage_tree: dict, tokens, cfg: ModelConfig,
                   M: int, mesh) -> torch.Tensor:
    """:func:`pipeline_classify` on a (`stage`,) mesh: this rank's stage
    in the GPipe schedule (module note). The first stage's input is
    ``where(first, embedding, received)`` and each stage's logits
    ``where(last, logits, 0)``, as in the reference, so that every hop's
    result is used on every rank and autograd runs every reverse hop on
    every rank in the same order."""
    import torch.distributed as dist
    S = mesh.size(0)
    sid = mesh.get_local_rank(0)
    group = mesh.get_group(0)
    nxt = dist.get_global_rank(group, (sid + 1) % S)
    prv = dist.get_global_rank(group, (sid - 1) % S)
    kinds = groups_for(cfg)[0][1]
    backbone = params["backbone"]
    head = params["adapters"]["head"]
    layers, adapters = stage_tree["layers"][sid], stage_tree["adapters"][sid]
    dev = tokens.device
    toks = tokens.reshape(M, tokens.shape[0] // M, -1)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32, device=dev)
    first = torch.tensor(sid == 0, device=dev)
    last = torch.tensor(sid == S - 1, device=dev)
    x0 = embed(backbone["embed"], toks[0].long())
    buf, outs = torch.zeros_like(x0), []
    for t in range(M + S - 1):
        # start point: embed microbatch t (zeros in the drain ticks)
        if t > 0:
            x0 = embed(backbone["embed"], toks[t].long()) if t < M \
                else torch.zeros_like(x0)
        # one stage: no hop, so nothing needs the received activations
        x = x0 if S == 1 else torch.where(first, x0, buf)
        y = _run_stage(layers, adapters, x, cfg, kinds, positions)
        if t >= S - 1:                 # end point: the finished microbatch
            lg = _head(backbone, head, y)
            outs.append(torch.where(last, lg, torch.zeros_like(lg)))
        if t < M + S - 2:              # the D2D hop (the last one is unread)
            buf = y if S == 1 else _Hop.apply(y, group, nxt, prv)
    out = torch.stack(outs)
    if S > 1:
        # the reference's psum: only the end stage's logits are nonzero
        out = dt.SumRanks.apply(out, (group,))
    return out.reshape(tokens.shape[0], -1)


def make_sl_finetune_step(params: dict, cfg: ModelConfig, optimizer, *,
                          n_microbatches: int = 4,
                          lr_trainables: str = "adapters", mesh=None):
    """SL fine-tuning: the gradient flows back through the chain.

    Returns ``step(stage_tree, head, opt_state, batch) -> (stage_tree,
    head, opt_state, loss)``; the optimizer sees ``{"a": stage adapters,
    "h": head}`` (``opt_state = optimizer.init`` of that tree), as in the
    reference. ``lr_trainables`` is the reference's keyword, which neither
    package reads: the stage adapters and the head train.

    With ``mesh`` a (`stage`,) mesh, rank s differentiates its own stage
    through the pipelined forward: its stage's adapter gradients are the
    monolithic ones, the head's gradient lives on the end stage and is
    broadcast from there, so every rank's head stays equal. Rank s
    updates only stage s's adapters (the other stages' entries come back
    as they went in; their owners update them)."""

    def loss_fn(tr, stage_layers, batch):
        p = {"backbone": params["backbone"],
             "adapters": {**params["adapters"], "head": tr["h"]}}
        logits = pipeline_classify(
            p, {"layers": stage_layers, "adapters": tr["a"]},
            batch["tokens"], cfg, n_microbatches=n_microbatches, mesh=mesh)
        return cross_entropy(logits, batch["label"])

    def step(stage_tree, head, opt_state, batch):
        tr = {"a": stage_tree["adapters"], "h": head}
        loss, grads = value_and_grad(loss_fn, tr, stage_tree["layers"],
                                     batch, has_aux=False)
        if mesh is not None:
            _share_head(grads["h"], mesh)
        updates, opt_state = optimizer.update(grads, opt_state, tr)
        new = apply_updates(tr, updates)
        if mesh is not None:           # this rank owns its stage only
            sid = mesh.get_local_rank(0)
            new["a"] = [a if s == sid else old for s, (a, old) in
                        enumerate(zip(new["a"], stage_tree["adapters"]))]
        return {**stage_tree, "adapters": new["a"]}, new["h"], opt_state, \
            loss

    return step


def _share_head(grads: dict, mesh) -> None:
    """The head's gradient, which only the end stage's rank holds, on
    every rank (a broadcast from it, in place)."""
    import torch.distributed as dist
    if mesh.size(0) == 1:
        return
    group = mesh.get_group(0)
    src = dist.get_global_rank(group, mesh.size(0) - 1)
    for g in tree_leaves(grads):
        dist.broadcast(g, src=src, group=group)


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
