"""Device-resident multi-tenant adapter bank (counterpart of
``repro/core/adapter_bank.py``).

GaisNet's layout is one shared frozen backbone with many per-domain
adapter sets (paper §III-B, Fig. 3). The bank keeps every domain's
adapters on the device in one stacked tree, so a single engine wave mixes
rows from different domains (S-LoRA / Punica-style multi-tenant serving):

- **Serving layout**: every leaf gains a leading ``n_slots`` dim. The
  port keeps one adapter dict per layer (``models/transformer.py``), so a
  ``stack`` leaf is ``(n_slots, ...)`` inside its layer's dict: the port's
  form of the reference's ``(L, n_slots, ...)``. Other leaves (the
  classification ``head``) are slot-leading too, as in the reference. The
  multi-LoRA kernels (``kernels/lora_bgmv.py``) and per-row gathers select
  by ``adapter_ids``.
- **publish(domain, adapters)**: writes the domain's slot in place with
  ``copy_`` (the port's form of the reference's donated
  ``dynamic_update_slice``): no new bank, visible to the very next wave.
  Each publish bumps the domain's version.
- **snapshot(domain)**: the training-side acquire, a copy of one domain's
  adapter tree that does not alias the bank.

The bank never holds the backbone: :meth:`serving_params` pairs the shared
frozen backbone with the stacked adapters per wave.

**Slot sharding** (``mesh=``): every leaf becomes a DTensor with its slot
dim on the `slots` axes ((`pod`, `data`); :meth:`shardings`), the other
dims replicated; a slot count that does not divide stays replicated. A
publish writes the slot on the rank that holds it, so the placement
survives the swap; a snapshot is a whole copy on every rank.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import torch

from repro_torch.core import telemetry
from repro_torch.sharding import dtensor as dt


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _stack(trees: list):
    """Stack same-structured trees leaf by leaf along a new leading dim."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: _stack([t[k] for t in trees]) for k in head}
    if isinstance(head, list):
        return [_stack([t[i] for t in trees]) for i in range(len(head))]
    return torch.stack(trees)


def _slice(tree, slot: int):
    """A copy of slot ``slot`` of every leaf (never a view of the bank;
    whole on every rank for a slot-sharded bank)."""
    if isinstance(tree, dict):
        return {k: _slice(v, slot) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_slice(v, slot) for v in tree]
    return dt.whole(tree)[slot].clone()


def _write(cur, slot: int, new) -> None:
    """``cur[slot] = new`` in place; a DTensor leaf writes its slot on the
    rank that holds it."""
    if dt.is_dt(cur):
        new = dt.whole(new)              # a collective: every rank takes it
        loc, start = dt.local_rows(cur)
        if start <= slot < start + loc.shape[0]:
            loc[slot - start].copy_(new)
        return
    cur[slot].copy_(new)


def _pairs(cur, new, where: str) -> list:
    """(bank leaf, payload leaf) pairs, matched by key and index; raises
    ``ValueError`` where the payload's structure differs."""
    if isinstance(cur, dict):
        if not isinstance(new, dict) or set(new) != set(cur):
            raise ValueError(f"{where}: payload structure differs from the "
                             f"slot's (keys {sorted(cur)})")
        return [p for k in cur for p in _pairs(cur[k], new[k],
                                               f"{where}/{k}")]
    if isinstance(cur, list):
        if not isinstance(new, list) or len(new) != len(cur):
            raise ValueError(f"{where}: payload structure differs from the "
                             f"slot's ({len(cur)} layers)")
        return [p for i, (c, n) in enumerate(zip(cur, new))
                for p in _pairs(c, n, f"{where}/{i}")]
    if isinstance(new, (dict, list)):
        raise ValueError(f"{where}: payload has a subtree where the slot has "
                         "a leaf")
    return [(cur, new)]


@torch.no_grad()
def _all_finite(leaves: list) -> bool:
    """Every leaf finite, from one device reduction and one host read."""
    leaves = [dt.whole(t) for t in leaves]
    flags = torch.stack([torch.isfinite(t).all().to(device=leaves[0].device)
                         for t in leaves])
    return bool(flags.all())


class AdapterBank:
    """Stacked per-domain adapter store with slot-indexed publish/serve."""

    def __init__(self, domains: Sequence[str], stacked: dict, *, mesh=None,
                 rules: Optional[dict] = None):
        self.domains = tuple(domains)
        self._slot = {d: i for i, d in enumerate(self.domains)}
        self.mesh = mesh
        if mesh is not None:
            from repro_torch.sharding.rules import distribute_tree
            stacked = distribute_tree(stacked,
                                      self.shardings(stacked, mesh, rules),
                                      mesh)
        self.stacked = stacked
        self.versions: Dict[str, int] = {d: 0 for d in self.domains}
        # last-known-good serving copies: per-domain snapshot of the slot
        # as it was before the most recent validated publish, so a poisoned
        # round can be rolled back without re-validating old state
        self._lkg: Dict[str, dict] = {}
        self._lkg_version: Dict[str, int] = {}
        self.rollbacks: Dict[str, int] = {d: 0 for d in self.domains}

    @staticmethod
    def shardings(stacked: dict, mesh, rules: Optional[dict] = None) -> dict:
        """Partition-spec tree: each leaf's slot dim (dim 0) on the `slots`
        axes, the rest replicated."""
        from repro_torch.models.params import tree_map
        from repro_torch.sharding.rules import dim_sharding
        n = _leaves(stacked)[0].shape[0]
        spec = dim_sharding(mesh, n, "slots", rules=rules)
        return tree_map(lambda _: spec, stacked)

    @classmethod
    def create(cls, adapters_by_domain: Dict[str, dict], *,
               mesh=None, rules: Optional[dict] = None) -> "AdapterBank":
        """Stack one adapter tree per domain into the serving layout (with
        a ``mesh``: slot-sharded over its `data` axis)."""
        domains = list(adapters_by_domain)
        stacked = _stack([adapters_by_domain[d] for d in domains])
        return cls(domains, stacked, mesh=mesh, rules=rules)

    # -- addressing ---------------------------------------------------------
    @property
    def n_slots(self) -> int:
        return len(self.domains)

    def slot(self, domain: str) -> int:
        if domain not in self._slot:
            raise KeyError(
                f"domain {domain!r} has no adapter slot "
                f"(known: {list(self.domains)})")
        return self._slot[domain]

    def adapter_ids(self, domains: Iterable[str]) -> torch.Tensor:
        """Per-row slot ids (int32, on the bank's device) for a
        mixed-domain batch."""
        dev = _leaves(self.stacked)[0].device
        return torch.tensor([self.slot(d) for d in domains],
                            dtype=torch.int32, device=dev)

    def version(self, domain: str) -> int:
        return self.versions[domain]

    # -- publish / acquire --------------------------------------------------
    def validate(self, domain: str, adapters: dict) -> None:
        """Reject a payload that must never reach live traffic: wrong tree
        structure, wrong per-leaf shape (against the slot it would
        overwrite), or any non-finite value. Raises ``ValueError``; a
        passing payload returns silently. Finiteness is one device
        reduction, read once."""
        self.slot(domain)                  # KeyError on unknown domain
        pairs = []
        for key in self.stacked:
            if key not in adapters:
                raise ValueError(
                    f"publish({domain!r}): payload missing subtree {key!r}")
            pairs += _pairs(self.stacked[key], adapters[key],
                            f"publish({domain!r}) {key}")
        for cur, new in pairs:
            if tuple(new.shape) != tuple(cur.shape[1:]):
                raise ValueError(
                    f"publish({domain!r}): leaf shape {tuple(new.shape)} "
                    f"!= slot shape {tuple(cur.shape[1:])}")
        if not _all_finite([new for _, new in pairs]):
            raise ValueError(
                f"publish({domain!r}): payload contains non-finite values")

    @torch.no_grad()
    def publish(self, domain: str, adapters: dict, *,
                validate: bool = True) -> None:
        """Hot-swap one domain's adapters in place (``copy_`` into the
        slot; the next wave that reads :attr:`stacked` serves the new
        version).

        With ``validate`` (the default), the payload is checked first
        (:meth:`validate`) and the outgoing slot contents are kept as the
        domain's last-known-good; :meth:`rollback` restores them if the new
        version turns out bad downstream. A rejected publish raises
        ``ValueError`` and leaves the bank serving the current version."""
        tel = telemetry.get()
        with tel.span("bank.publish", domain=domain,
                      validate=validate) as sp:
            if validate:
                try:
                    self.validate(domain, adapters)
                except ValueError:
                    tel.count("bank.publish_rejects")
                    sp.set(rejected=True)
                    raise
                # a copy, taken before the in-place write
                self._lkg[domain] = self.snapshot(domain)
                self._lkg_version[domain] = self.versions[domain]
            slot = self.slot(domain)
            for key in self.stacked:
                for cur, new in _pairs(self.stacked[key], adapters[key],
                                       f"publish({domain!r}) {key}"):
                    _write(cur, slot, new)
            self.versions[domain] += 1
            sp.set(version=self.versions[domain])
        tel.count("bank.publishes")

    def rollback(self, domain: str) -> int:
        """Re-publish the domain's last-known-good adapters (the slot
        contents before its most recent validated publish). Returns the
        version the slot is rolled back to; raises ``ValueError`` if the
        domain has never had a validated publish. Idempotent: the LKG copy
        survives the rollback, so repeated calls republish the same
        state."""
        if domain not in self._lkg:
            raise ValueError(
                f"rollback({domain!r}): no last-known-good recorded "
                "(no validated publish yet)")
        # the LKG copy was validated when it served; publish it unvalidated
        # so a rollback cannot itself be rejected
        tel = telemetry.get()
        with tel.span("bank.rollback", domain=domain,
                      to_version=self._lkg_version[domain]):
            self.publish(domain, self._lkg[domain], validate=False)
        self.rollbacks[domain] += 1
        tel.count("bank.rollbacks")
        return self._lkg_version[domain]

    def last_known_good_version(self, domain: str) -> Optional[int]:
        """Version number of the stored LKG copy (None before any
        validated publish)."""
        return self._lkg_version.get(domain)

    def snapshot(self, domain: str) -> dict:
        """A copy of one domain's adapter tree (training-side acquire; also
        the per-domain baseline for parity checks). It does not alias the
        bank: a later publish leaves it unchanged."""
        tel = telemetry.get()
        slot = self.slot(domain)
        with tel.span("bank.snapshot", domain=domain):
            snap = _slice(self.stacked, slot)
        tel.count("bank.snapshots")
        return snap

    # -- serving ------------------------------------------------------------
    def serving_params(self, backbone: dict) -> dict:
        """Param tree for the multi-tenant serving / classify path."""
        return {"backbone": backbone, "adapters": self.stacked}
