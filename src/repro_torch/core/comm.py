"""Communication / energy / latency cost model (paper §III-C.2, §III-D.2;
counterpart of ``repro/core/comm.py``).

The paper lists six metrics for its workflows and prices none of them;
this module prices them for the wireless topology the paper assumes (D2D
and client-server links, 6G-like defaults). Byte counts come from real
tensor trees or from split-learning traces (``sl_round_cost`` of a
``core/sl_pipeline.py::SLTrace``). The reference's TPU-interconnect preset
(``CostModel.tpu()``) is not carried: it prices a TPU pod, not this
port's card.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from repro_torch.core.sl_pipeline import SLTrace


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """One link class: rate (B/s) and energy per byte (J/B)."""
    rate: float
    energy_per_byte: float

    def latency(self, nbytes: float) -> float:
        return nbytes / self.rate

    def energy(self, nbytes: float) -> float:
        return nbytes * self.energy_per_byte


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Topology prices. Defaults: a 6G-like wireless edge (the paper's)."""
    d2d: LinkModel = LinkModel(rate=250e6 / 8, energy_per_byte=40e-9)
    cs: LinkModel = LinkModel(rate=100e6 / 8, energy_per_byte=80e-9)
    backhaul: LinkModel = LinkModel(rate=10e9 / 8, energy_per_byte=5e-9)
    client_flops: float = 10e12            # edge-device peak
    client_joules_per_flop: float = 2e-11


@dataclasses.dataclass
class RoundCost:
    """The paper's metric set for one fine-tuning round or inference round.

    ``tokens`` counts decode tokens served (0 for fine-tuning rounds) and
    ``padded_tokens`` the decode slot-steps executed without serving;
    ``examples`` counts training examples consumed (0 for serving rounds).
    The fault counters: ``dropped_clusters`` (cluster-rounds lost to
    dropout or stragglers), ``skipped_updates`` (non-finite cluster updates
    guarded out), ``retries`` / ``retransmit_bytes`` (relay retransmission;
    ``comm_bytes`` includes every attempt) and ``timed_out`` (requests
    retired at their deadline). Speculative rounds book ``drafted_tokens``
    and ``accepted_tokens``."""
    latency_s: float
    compute_flops: float
    energy_j: float
    comm_bytes: int
    memory_bytes: int
    tokens: int = 0
    examples: int = 0
    padded_tokens: int = 0
    dropped_clusters: int = 0
    skipped_updates: int = 0
    retries: int = 0
    retransmit_bytes: int = 0
    timed_out: int = 0
    drafted_tokens: int = 0
    accepted_tokens: int = 0

    @property
    def tok_per_s(self) -> float:
        return self.tokens / self.latency_s if self.latency_s > 0 else 0.0

    @property
    def ex_per_s(self) -> float:
        return self.examples / self.latency_s if self.latency_s > 0 else 0.0

    @property
    def utilization(self) -> float:
        """Served fraction of executed decode slot-steps (1.0 = no waste)."""
        total = self.tokens + self.padded_tokens
        return self.tokens / total if total else 1.0

    # summed field by field, except peak memory, which is a max
    _MAX_FIELDS = ("memory_bytes",)

    def __add__(self, o: "RoundCost") -> "RoundCost":
        kw = {}
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(o, f.name)
            kw[f.name] = max(a, b) if f.name in self._MAX_FIELDS else a + b
        return RoundCost(**kw)

    @property
    def acceptance_rate(self) -> float:
        """Committed fraction of drafted tokens (speculative serving)."""
        return (self.accepted_tokens / self.drafted_tokens
                if self.drafted_tokens else 0.0)


def sl_round_cost(trace: SLTrace, cm: CostModel, *,
                  model_delivery_bytes: int = 0,
                  upload_bytes: int = 0) -> RoundCost:
    """Cost of one SL pass (fine-tuning if ``trace.gradient_bytes > 0``).

    Serial chain: the clients' compute latencies add up (the paper's
    serial D2D relay); the hops pay D2D latency; delivery and upload pay
    client-server latency."""
    compute_lat = sum(f / cm.client_flops for f in trace.per_client_flops)
    d2d_bytes = trace.smashed_bytes + trace.gradient_bytes \
        + trace.feedback_bytes
    comm_lat = cm.d2d.latency(d2d_bytes) \
        + cm.cs.latency(model_delivery_bytes + upload_bytes)
    flops = float(sum(trace.per_client_flops))
    energy = flops * cm.client_joules_per_flop + cm.d2d.energy(d2d_bytes) \
        + cm.cs.energy(model_delivery_bytes + upload_bytes)
    return RoundCost(
        latency_s=compute_lat + comm_lat,
        compute_flops=flops,
        energy_j=energy,
        comm_bytes=d2d_bytes + model_delivery_bytes + upload_bytes,
        memory_bytes=trace.peak_activation_bytes,
    )


def transfer_cost(nbytes: int, link: LinkModel) -> RoundCost:
    return RoundCost(link.latency(nbytes), 0.0, link.energy(nbytes),
                     nbytes, 0)
