"""Shared-prefix KV cache for the slot scheduler (counterpart of
``repro.serve.prefix_cache``).

Every admitted request replays its prompt through its own KV lane one token
a step, even when many prompts open with the same preamble. The prefix
pool keeps KV rows of prompt prefixes served before, at token-block
granularity, in a fixed-capacity device pool; admission matches a prompt
on the host and copies the cached blocks into the new lane, so a request
whose first L prompt tokens are cached starts its replay at position L.

* **Host: a radix-trie-lite.** Nodes are keyed ``(parent_block_id,
  token_bytes)``, one node per ``block_tokens``-token chunk, so matching a
  prompt is a dict walk and two prompts share exactly their common
  block-aligned prefix. Eviction is LRU over leaf nodes (a node with
  children is pinned: evicting it would orphan longer prefixes).
* **Device: a block pool per KV leaf.** For every cache leaf (L, S,
  max_len, n_kv, Dh) the pool holds (L, n_blocks, block_tokens, n_kv, Dh).
  ``load`` gathers the matched blocks and writes them into the lane with
  one ``write_lane_window``; ``insert`` copies a block out of a finished
  lane with ``slice_lane_window``. Both write in place: the scheduler's
  cache tensors, which its captured steps read, keep their storage.

Correctness: KV rows are a function of the token prefix, the positions and
the params, so pool rows are the rows a replay would have written. ``load``
writes the whole static match window (padded ids gather block 0); the
positions past the matched length are overwritten by the replay before
they are attended, and the lane's validity mask hides everything past its
frontier. Neither holds for sliding-window ring buffers or recurrent
states, so the scheduler gates the pool on full-attention KV caches. Lanes
copy pool blocks instead of sharing them, so eviction can never corrupt a
request in flight.

Under the serving mesh the block ids split over the data replicas as the
lanes do: replica r owns blocks [r * n_blocks / R, (r + 1) * n_blocks / R)
and holds only those on its ranks. The trie is the same on every rank
(the host loop is replicated); a finished lane's blocks are allocated on
its own replica, a chain's owner is the replica of its first block, the
scheduler routes an admission to the owner and a lane elsewhere forfeits
the hit. A chain may reach into another replica's blocks (a later prompt
extending an earlier one from another replica); the JAX pool gathers those
across replicas, while here a load takes only the chain's leading run on
the owner (``owned_run``): fewer replay steps saved, the same tokens.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..launch.mesh import serve_cache_spec
from ..models.attention import slice_lane_window, write_lane_window


def cache_is_kv_only(cache) -> bool:
    """True when every leaf of a non-empty decode-state tree is a KV
    buffer (named 'k' or 'v', at least 4-D), at any depth: the only states
    whose rows can be block-copied and position-offset. Recurrent leaves
    (wkv, ssm, conv) fold history into one state and cannot be rewound or
    spliced."""
    def kv_only(tree) -> bool:
        return all(kv_only(leaf) if isinstance(leaf, dict) else
                   name in ("k", "v") and isinstance(leaf, torch.Tensor)
                   and leaf.dim() >= 4 for name, leaf in tree.items())
    return isinstance(cache, dict) and bool(cache) and kv_only(cache)


class PrefixPool:
    """Fixed-capacity shared-prefix KV pool, built by the scheduler against
    its own cache tensors. ``n_replicas`` is the mesh's data degree and
    ``replica`` this rank's: the device pool holds that replica's
    ``n_blocks // n_replicas`` blocks."""

    def __init__(self, cache_template, n_blocks: int, block_tokens: int,
                 max_match_blocks: int, n_replicas: int = 1,
                 replica: int = 0):
        if n_blocks < 1 or block_tokens < 1:
            raise ValueError("prefix pool needs n_blocks/block_tokens >= 1")
        if n_blocks % n_replicas:
            raise ValueError(
                f"prefix_cache_blocks {n_blocks} must divide the data "
                f"degree {n_replicas} (blocks are replica-local)")
        if not cache_is_kv_only(cache_template):
            raise NotImplementedError(
                "the prefix cache block-copies full-attention KV rows; "
                "this model's decode state has recurrent/windowed leaves")
        self.n_blocks = n_blocks
        self.block_tokens = block_tokens
        self.max_match_blocks = max_match_blocks
        self.n_replicas = n_replicas
        self.replica = replica
        self.blocks_per_replica = n_blocks // n_replicas

        def make(name, leaf):
            shape = list(leaf.shape)
            lane = serve_cache_spec(f"[{name!r}]", leaf)    # the lane axis
            shape[lane] = self.blocks_per_replica
            shape[lane + 1] = block_tokens
            return torch.zeros(shape, dtype=leaf.dtype, device=leaf.device)

        self.pool = {name: make(name, leaf) for name, leaf in
                     cache_template.items()}
        dev = next(iter(self.pool.values())).device
        self._ids = torch.zeros((max_match_blocks,), dtype=torch.long,
                                device=dev)

        # -- trie-lite: (parent_block_id, chunk_bytes) -> block_id
        self._node: Dict[Tuple[int, bytes], int] = {}
        self._key_of: Dict[int, Tuple[int, bytes]] = {}
        self._children: Dict[int, int] = {}
        self._lru: Dict[int, int] = {}
        self._tick = 0
        bpr = self.blocks_per_replica
        self._free: List[List[int]] = [list(range(r * bpr, (r + 1) * bpr))
                                       for r in range(n_replicas)]
        # -- counters (surfaced through scheduler step records / reports)
        self.hits = 0               # admissions that loaded >= 1 block
        self.saved_steps = 0        # replay steps skipped (sum of t0)
        self.inserted = 0           # blocks written into the pool
        self.evictions = 0

    # -- host trie ----------------------------------------------------------

    def _chunks(self, tokens: np.ndarray, n: int):
        bt = self.block_tokens
        for i in range(n):
            yield np.asarray(tokens[i * bt:(i + 1) * bt],
                             np.int32).tobytes()

    def match(self, tokens, p_len: int) -> Tuple[int, List[int],
                                                 Optional[int]]:
        """Longest cached block-aligned prefix of ``tokens``: (matched
        blocks, block ids, owner replica: that of the first block, None on
        a miss). The usable match is capped at (p_len - 1) // block_tokens:
        the lane's last replay step must still run to emit the first
        token."""
        limit = min((p_len - 1) // self.block_tokens, self.max_match_blocks)
        ids: List[int] = []
        parent = -1
        for chunk in self._chunks(np.asarray(tokens), limit):
            bid = self._node.get((parent, chunk))
            if bid is None:
                break
            ids.append(bid)
            parent = bid
        self._tick += 1
        for bid in ids:
            self._lru[bid] = self._tick
        owner = ids[0] // self.blocks_per_replica if ids else None
        return len(ids), ids, owner

    def owned_run(self, ids: List[int], replica: int) -> List[int]:
        """The leading blocks of a matched chain that ``replica`` holds."""
        n = 0
        while n < len(ids) and ids[n] // self.blocks_per_replica == replica:
            n += 1
        return ids[:n]

    def _alloc(self, replica: int, protect) -> Optional[int]:
        """A free block of ``replica``, else the least recently used of its
        leaves outside ``protect`` (evicted), else None."""
        free = self._free[replica]
        if free:
            return free.pop(0)
        bpr = self.blocks_per_replica
        leaves = [b for b in range(replica * bpr, (replica + 1) * bpr)
                  if self._children.get(b, 1) == 0 and b not in protect]
        if not leaves:
            return None
        victim = min(leaves, key=lambda b: self._lru.get(b, 0))
        key = self._key_of.pop(victim)
        del self._node[key]
        del self._children[victim]
        self._lru.pop(victim, None)
        if key[0] >= 0:
            self._children[key[0]] -= 1
        self.evictions += 1
        return victim

    # -- device copies (called by the scheduler) ------------------------------

    def load(self, cache, ids: List[int], lane: Optional[int]):
        """Copy matched pool blocks (this replica's) into lane ``lane`` of
        ``cache`` in place and return it; padded id slots gather the
        replica's first block, garbage past the matched length that the
        replay overwrites before it is attended. ``cache`` None (a lane of
        another replica) counts the hit and copies nothing."""
        self.hits += 1
        self.saved_steps += len(ids) * self.block_tokens
        if cache is None:
            return None
        padded = np.zeros((self.max_match_blocks,), np.int64)
        padded[:len(ids)] = np.asarray(ids, np.int64) - \
            self.replica * self.blocks_per_replica
        self._ids.copy_(torch.from_numpy(padded))
        mcap, bt = self.max_match_blocks, self.block_tokens
        for name, cleaf in cache.items():
            got = self.pool[name].index_select(-4, self._ids)
            rows = got.reshape(*got.shape[:-4], 1, mcap * bt,
                               *got.shape[-2:])
            write_lane_window(cleaf, rows, lane, 0)
        return cache

    def insert(self, tokens, p_len: int, cache, lane: Optional[int],
               replica: int = 0) -> int:
        """Register a cleanly finished lane's prompt blocks: walk the trie
        and allocate each missing block on the lane's ``replica``, copying
        it out of the lane's KV where that replica is this rank's (``lane``
        its index in ``cache``). Returns the number of blocks saved."""
        limit = min((p_len - 1) // self.block_tokens, self.max_match_blocks)
        parent = -1
        path: set = set()
        saved = 0
        for i, chunk in enumerate(self._chunks(np.asarray(tokens), limit)):
            bid = self._node.get((parent, chunk))
            if bid is None:
                bid = self._alloc(replica, path)
                if bid is None:
                    break
                self._node[(parent, chunk)] = bid
                self._key_of[bid] = (parent, chunk)
                self._children[bid] = 0
                if parent >= 0:
                    self._children[parent] += 1
                if replica == self.replica:
                    local = bid - replica * self.blocks_per_replica
                    for name, cleaf in cache.items():
                        rows = slice_lane_window(cleaf, lane,
                                                 i * self.block_tokens,
                                                 self.block_tokens)
                        write_lane_window(self.pool[name], rows, local, 0)
                self.inserted += 1
                saved += 1
            self._tick += 1
            self._lru[bid] = self._tick
            path.add(bid)
            parent = bid
        return saved

    @property
    def n_cached_blocks(self) -> int:
        return len(self._key_of)

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "saved_steps": self.saved_steps,
                "inserted": self.inserted, "evictions": self.evictions,
                "cached_blocks": self.n_cached_blocks}
