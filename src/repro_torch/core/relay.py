"""Data-free knowledge relay (paper §III-B, Fig 3; counterpart of
``repro/core/relay.py``).

The edge server is the buffer between GAI (the cloud's foundation model)
and EI (the end clusters):

- **cloud-edge subnetwork** (domain-across flow): the cloud delivers
  foundation adapters to each domain's edge model; edges upload their
  fine-tuned adapters; the cloud FedAvg-aggregates across domains.
- **edge-end subnetwork** (domain-specific flow): each edge delivers its
  domain adapters to its client clusters (HFSL trains inside the domain,
  ``core/hfsl.py``) and absorbs the aggregated result.

"Data-free" is structural: only adapter trees cross a tier boundary,
never tokens, activations or labels. Every transfer is metered in bytes
through ``core/comm.py``.

Attached to a serving :class:`~repro_torch.core.adapter_bank.AdapterBank`
(:meth:`KnowledgeRelay.attach_bank`), every edge update the relay makes,
cloud delivery and end-cluster absorption, is published into the domain's
bank slot. The relay stays the authority: its versions are the logical
ones and its ledger meters the bytes; the bank is the device copy that
serves.

With a :class:`~repro_torch.core.faults.FaultPlan`, every transfer crosses
a lossy link: attempts may be dropped or bit-corrupted on the plan's
schedule, per-leaf CRC32 checksums reject corrupted deliveries (only the
rejected leaves are sent again), and the relay retries with capped
exponential backoff; retries and retransmitted bytes are ledgered, and a
transfer that exhausts ``max_retries`` raises :class:`RelayTransferError`.
The wire unit is the reference's leaf (``checkpoint/io.py::wire_tree``:
keys sorted, each per-layer list stacked to ``(L, ...)``), so the same plan
flips the same byte of the same leaf and books the same bytes in both
packages; the wire copy is made only under an active plan. Without a plan,
or with an all-off one, the accounting is the no-fault relay's.

Torch tensors are mutable where JAX arrays are not: the reference copies
trees by identity, the port clones them. The relay keeps private copies
and every method hands back a clone of its result, so that an in-place
step on a returned tree never reaches ``edges``, ``cloud`` or a bank slot
behind the versions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.checkpoint.io import wire_tree
from repro_torch.core import telemetry
from repro_torch.core.comm import CostModel, RoundCost, transfer_cost
from repro_torch.core.faults import FaultPlan, leaf_checksums
from repro_torch.core.peft import tree_bytes
from repro_torch.models.params import tree_leaves, tree_map


class RelayTransferError(RuntimeError):
    """A relay transfer exhausted its retry budget on a lossy link."""


@dataclasses.dataclass
class Ledger:
    cloud_to_edge: int = 0
    edge_to_cloud: int = 0
    edge_to_end: int = 0
    end_to_edge: int = 0
    transfers: int = 0
    retries: int = 0            # retransmission attempts (beyond first try)
    retransmit_bytes: int = 0   # bytes re-sent on those retries

    def total(self) -> int:
        return (self.cloud_to_edge + self.edge_to_cloud
                + self.edge_to_end + self.end_to_edge)


def _avg(trees: list) -> dict:
    """Leafwise mean: summed in f32 in list order, divided, cast back to
    each leaf's dtype (the reference's ``sum(...) / len``)."""
    def mean(*xs):
        acc = xs[0].float()
        for x in xs[1:]:
            acc = acc + x.float()
        return (acc / len(xs)).to(xs[0].dtype)
    return tree_map(mean, *trees)


def _clone(tree):
    return tree_map(lambda x: x.detach().clone(), tree)


class KnowledgeRelay:
    """Versioned adapter store for one cloud and N domain edges."""

    def __init__(self, cloud_adapters: dict, domains: list[str],
                 cost_model: Optional[CostModel] = None, bank=None, *,
                 faults: Optional[FaultPlan] = None, max_retries: int = 8,
                 backoff_s: float = 0.05, backoff_cap_s: float = 1.0):
        self.cloud = _clone(cloud_adapters)
        self.cloud_version = 0
        self.edges = {d: _clone(cloud_adapters) for d in domains}
        self.edge_versions = {d: 0 for d in domains}
        self.ledger = Ledger()
        self.cm = cost_model or CostModel()
        self.cost = RoundCost(0, 0, 0, 0, 0)
        self.faults = faults
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.backoff_cap_s = backoff_cap_s
        self._tid = 0              # monotonic transfer id (fault schedule key)
        self.bank = None
        if bank is not None:
            self.attach_bank(bank)

    def attach_bank(self, bank) -> None:
        """Route this relay's edge updates into a serving AdapterBank:
        every deliver and absorb publishes the domain's new adapters into
        its bank slot, and attaching seeds every slot with the relay's
        edges. The relay's ``edge_versions`` stay the logical versions;
        the bank's counter counts publishes to the slot (it may have other
        writers)."""
        missing = [d for d in self.edges if d not in bank.domains]
        if missing:
            raise KeyError(f"bank has no slot for domains {missing}")
        self.bank = bank
        for d in self.edges:
            self._publish(d)

    def _publish(self, domain: str) -> None:
        if self.bank is not None:
            self.bank.publish(domain, self.edges[domain])

    def _book(self, field: str, nbytes: int, link) -> None:
        """One attempt's bytes on the wire, into the ledger, the cost and
        the telemetry counters."""
        tel = telemetry.get()
        self.ledger.transfers += 1
        setattr(self.ledger, field, getattr(self.ledger, field) + nbytes)
        self.cost = self.cost + transfer_cost(nbytes, link)
        tel.count("relay.transfers")
        tel.count(f"relay.bytes.{field}", nbytes)

    def _transfer(self, nbytes: int, link, field: str, payload=None):
        """One logical transfer over a (possibly lossy) link.

        Books the wire bytes of each attempt against the ledger's
        ``field`` and the link's latency and energy into :attr:`cost`.
        Under an active plan, attempts may be dropped or corrupted, with
        capped exponential backoff (scaled by the plan's seeded jitter)
        added per retry. Corruption is rejected per wire leaf: only the
        leaves whose checksums mismatch stay pending, so a retransmit sends
        and books just those; a link drop loses the whole attempt. Returns
        the caller's payload (a corrupted wire copy never passes the
        checksum)."""
        tid, self._tid = self._tid, self._tid + 1
        tel = telemetry.get()
        plan = self.faults
        if plan is None or not plan.active:
            self._book(field, nbytes, link)
            return payload
        leaves: list = []
        if payload is not None:
            leaves = [x.detach().cpu()
                      for x in tree_leaves(wire_tree(payload))]
        leaf_chk = leaf_checksums(leaves)
        leaf_nb = [x.numel() * x.element_size() for x in leaves]
        # pending: wire leaves still owed to the receiver; the first
        # attempt ships everything (nbytes), later ones what the last
        # checksum compare rejected
        pending = list(range(len(leaves)))
        pending_nb = nbytes
        with tel.span("relay.transfer", field=field, bytes=nbytes,
                      tid=tid) as sp:
            for attempt in range(self.max_retries + 1):
                if attempt > 0:
                    self.ledger.retries += 1
                    self.ledger.retransmit_bytes += pending_nb
                    backoff = min(self.backoff_s * 2.0 ** (attempt - 1),
                                  self.backoff_cap_s) \
                        * (1.0 + plan.retry_jitter(tid, attempt))
                    self.cost = self.cost + RoundCost(
                        backoff, 0.0, 0.0, 0, 0, retries=1,
                        retransmit_bytes=pending_nb)
                    tel.count("relay.retries")
                    tel.count("relay.retransmit_bytes", pending_nb)
                    tel.observe("relay.backoff_s", backoff)
                self._book(field, pending_nb, link)
                lost = plan.link_drops(tid, attempt)
                if lost:
                    tel.count("relay.link_drops")
                if not lost and pending \
                        and plan.payload_corrupted(tid, attempt):
                    recv = plan.corrupt_payload(
                        [leaves[i] for i in pending], tid, attempt)
                    bad = [i for i, c in zip(pending, leaf_checksums(recv))
                           if c != leaf_chk[i]]
                    if bad:
                        tel.count("relay.checksum_rejects")
                        tel.count("relay.corrupt_leaves", len(bad))
                        pending = bad
                        pending_nb = sum(leaf_nb[i] for i in bad)
                        lost = True
                if not lost:
                    sp.set(attempts=attempt + 1)
                    return payload
            sp.set(attempts=self.max_retries + 1, gave_up=True)
        tel.count("relay.gave_up")
        raise RelayTransferError(
            f"transfer {tid} ({field}, {nbytes} B) dropped "
            f"{self.max_retries + 1} times; giving up")

    # -- cloud-edge subnetwork (domain-across, large-scale flow) ----------
    def cloud_deliver(self, domain: str) -> dict:
        """Cloud foundation adapters -> edge domain model (delivery)."""
        recv = self._transfer(tree_bytes(self.cloud), self.cm.backhaul,
                              "cloud_to_edge", payload=self.cloud)
        self.edges[domain] = _clone(recv)
        self.edge_versions[domain] = self.cloud_version
        self._publish(domain)
        return _clone(self.edges[domain])

    def cloud_aggregate(self, domains: Optional[list[str]] = None) -> dict:
        """Edges -> cloud: FedAvg over domain adapters (upload and
        aggregate)."""
        ds = domains or list(self.edges)
        received = [self._transfer(tree_bytes(self.edges[d]),
                                   self.cm.backhaul, "edge_to_cloud",
                                   payload=self.edges[d]) for d in ds]
        self.cloud = _avg(received)
        self.cloud_version += 1
        return _clone(self.cloud)

    # -- edge-end subnetwork (domain-specific, small-scale flow) ----------
    def edge_deliver(self, domain: str, n_clusters: int) -> dict:
        """Edge -> clusters (segmentation and distribution, Fig 4 step
        1)."""
        per = tree_bytes(self.edges[domain])
        if self.faults is None or not self.faults.active:
            # one batched booking; transfer ids still advance, so a later
            # faulted run's schedule lines up with this one's
            nb = per * n_clusters
            self.ledger.edge_to_end += nb
            self.ledger.transfers += n_clusters
            self._tid += n_clusters
            self.cost = self.cost + transfer_cost(nb, self.cm.cs)
            tel = telemetry.get()
            tel.count("relay.transfers", n_clusters)
            tel.count("relay.bytes.edge_to_end", nb)
            return _clone(self.edges[domain])
        for _ in range(n_clusters):
            self._transfer(per, self.cm.cs, "edge_to_end",
                           payload=self.edges[domain])
        return _clone(self.edges[domain])

    def edge_absorb(self, domain: str, cluster_adapters: list) -> dict:
        """Clusters -> edge: FedAvg (upload and aggregation, Fig 4 step
        4)."""
        received = [self._transfer(tree_bytes(a), self.cm.cs, "end_to_edge",
                                   payload=a) for a in cluster_adapters]
        self.edges[domain] = _avg(received)
        self.edge_versions[domain] += 1
        self._publish(domain)
        return _clone(self.edges[domain])
