"""Host-side paged KV-cache bookkeeping: block allocator and prefix cache
(a numpy copy of ``repro/core/paged.py``).

The device side of the paged cache is a block pool ``(L, n_blocks,
block_size, Hkv, D)`` plus per-row block tables (``models/attention.py``);
this module owns the host side: which pool blocks are free, who holds
references to each block, and which blocks hold which prompt prefixes.

- :class:`BlockAllocator`: a free-list allocator with refcounted blocks.
  The free list is LRU-ordered and a freed block keeps its content hash
  until the slot is reused, so a prefix freed by one drain can be revived
  by the next (``acquire`` on a cache hit brings a dead block back at
  refcount 1 without prefilling it again).
- Prefix sharing: prompt blocks are hashed with a chained per-block CRC32
  (each block's hash folds in its predecessor's), so a hash names the
  whole prefix up to and including the block, which is the attention
  state its K/V rows encode. ``match_prefix`` walks the chain to the
  longest cached prefix; ``register`` publishes a prefilled prompt's full
  blocks.

Sharing is copy-on-write by construction: only full blocks are shared and
decode appends into the row's private tail blocks, so a shared block is
never written after it is published. Invariants: refcounts never go
negative, a double free raises, and ``used + free == n_blocks`` after any
sequence of alloc / free / acquire (:meth:`BlockAllocator.check`).
"""
from __future__ import annotations

import dataclasses
import zlib
from collections import OrderedDict
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class PagedSpec:
    """Static paged-cache geometry. ``n_blocks`` sizes the device pool;
    ``block_size`` is the tokens per block (a power of two, so that the
    engine's power-of-two cache capacities divide evenly);
    ``share_prefix`` opts into cross-request prefix sharing (full-block
    prompt hashes; all-attention, full-window configs only)."""
    n_blocks: int = 64
    block_size: int = 16
    share_prefix: bool = False

    def __post_init__(self):
        if self.block_size < 1 or self.block_size & (self.block_size - 1):
            raise ValueError(
                f"block_size must be a power of two, got {self.block_size}")
        if self.n_blocks < 1:
            raise ValueError(f"n_blocks must be >= 1, got {self.n_blocks}")


def block_hashes(tokens, block_size: int) -> list[int]:
    """Chained CRC32 per full block of a prompt:
    ``h[i] = crc32(bytes(h[i-1]) + tokens[i*bs:(i+1)*bs])``. A partial
    tail block is never hashed (it is private by definition)."""
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
    out: list[int] = []
    h = 0
    for i in range(len(toks) // block_size):
        blk = toks[i * block_size:(i + 1) * block_size]
        h = zlib.crc32(blk.tobytes(), zlib.crc32(h.to_bytes(8, "little")))
        out.append(h)
    return out


class BlockAllocator:
    """Refcounted free-list allocator over ``n_blocks`` pool slots."""

    def __init__(self, n_blocks: int, block_size: int):
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self.refcount = [0] * self.n_blocks
        # LRU free list (insertion order = eviction order); a freed block
        # keeps its hash until reused, so it stays a prefix-cache hit
        self._free: OrderedDict[int, None] = OrderedDict(
            (i, None) for i in range(self.n_blocks))
        self._hash_to_block: dict[int, int] = {}
        self._block_to_hash: dict[int, int] = {}
        self.allocated = 0
        self.freed = 0
        self.shared_acquires = 0
        self.hash_hits = 0

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.n_blocks - len(self._free)

    def _evict_hash(self, bid: int) -> None:
        h = self._block_to_hash.pop(bid, None)
        if h is not None and self._hash_to_block.get(h) == bid:
            del self._hash_to_block[h]

    def alloc(self, n: int) -> Optional[list[int]]:
        """Take ``n`` blocks off the free list (LRU first), or None if
        fewer than ``n`` are free. Reuse evicts the block's old hash."""
        if n > len(self._free):
            return None
        out = []
        for _ in range(n):
            bid, _ = self._free.popitem(last=False)
            self._evict_hash(bid)
            self.refcount[bid] = 1
            out.append(bid)
        self.allocated += n
        return out

    def acquire(self, bid: int) -> None:
        """One more reference on ``bid`` (prefix sharing). A dead block
        (rc 0, still hashed) leaves the free list with its contents."""
        if self.refcount[bid] == 0:
            if bid not in self._free:
                raise RuntimeError(f"block {bid} has rc=0 but is not free")
            del self._free[bid]
        self.refcount[bid] += 1
        self.shared_acquires += 1

    def free(self, block_ids) -> None:
        """Drop one reference per block; a block at rc 0 goes to the LRU
        tail with its hash kept."""
        for bid in block_ids:
            if self.refcount[bid] <= 0:
                raise RuntimeError(f"double free of block {bid}")
            self.refcount[bid] -= 1
            if self.refcount[bid] == 0:
                self._free[bid] = None
                self.freed += 1

    def match_prefix(self, tokens) -> tuple[list[int], int]:
        """Longest cached full-block prefix of ``tokens``: (block_ids,
        n_matched_blocks). The walk stops at the first chained hash with no
        mapping; the caller must ``acquire`` each returned block."""
        ids: list[int] = []
        for h in block_hashes(tokens, self.block_size):
            bid = self._hash_to_block.get(h)
            if bid is None:
                break
            ids.append(bid)
        if ids:
            self.hash_hits += 1
        return ids, len(ids)

    def register(self, tokens, block_ids) -> None:
        """Publish a prefilled prompt's full blocks for sharing;
        ``block_ids[i]`` holds tokens ``[i*bs, (i+1)*bs)``. The first
        registration of a hash wins."""
        for h, bid in zip(block_hashes(tokens, self.block_size), block_ids):
            if h in self._hash_to_block:
                continue
            self._evict_hash(bid)          # the block may carry an older hash
            self._hash_to_block[h] = bid
            self._block_to_hash[bid] = h

    def check(self) -> None:
        """Assert the conservation invariant."""
        used = sum(1 for rc in self.refcount if rc > 0)
        if used + len(self._free) != self.n_blocks:
            raise AssertionError(
                f"pool leak: used={used} free={len(self._free)} "
                f"n_blocks={self.n_blocks}")
        if any(rc < 0 for rc in self.refcount):
            raise AssertionError(f"negative refcount: {self.refcount}")
