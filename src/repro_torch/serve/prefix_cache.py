"""Shared-prefix KV cache for the slot scheduler (counterpart of
``repro.serve.prefix_cache``; single replica).

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
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.attention import slice_lane_window, write_lane_window


def cache_is_kv_only(cache) -> bool:
    """True when every decode-state leaf is a full-attention KV buffer
    (named 'k' or 'v', at least 4-D): the only states whose rows can be
    block-copied and position-offset."""
    return isinstance(cache, dict) and bool(cache) and all(
        name in ("k", "v") and isinstance(leaf, torch.Tensor)
        and leaf.dim() >= 4 for name, leaf in cache.items())


class PrefixPool:
    """Fixed-capacity shared-prefix KV pool, built by the scheduler against
    its own cache tensors. Single replica: the JAX package's mesh layout
    (blocks sharded over the data axis, ``serve_cache_spec``) is not
    ported."""

    def __init__(self, cache_template, n_blocks: int, block_tokens: int,
                 max_match_blocks: int, mesh=None, cache_shardings=None,
                 n_replicas: int = 1):
        if mesh is not None or cache_shardings is not None or \
                n_replicas != 1:
            raise NotImplementedError(
                "the prefix pool over a (data, model) mesh "
                "(repro.serve.prefix_cache.PrefixPool with mesh=, "
                "launch.mesh.serve_cache_spec) is not ported; the port "
                "serves one replica")
        if n_blocks < 1 or block_tokens < 1:
            raise ValueError("prefix pool needs n_blocks/block_tokens >= 1")
        if not cache_is_kv_only(cache_template):
            raise NotImplementedError(
                "the prefix cache block-copies full-attention KV rows; "
                "this model's decode state has recurrent/windowed leaves")
        self.n_blocks = n_blocks
        self.block_tokens = block_tokens
        self.max_match_blocks = max_match_blocks

        def make(leaf):
            shape = list(leaf.shape)
            shape[-4] = n_blocks
            shape[-3] = block_tokens
            return torch.zeros(shape, dtype=leaf.dtype, device=leaf.device)

        self.pool = {name: make(leaf) for name, leaf in
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
        self._free: List[int] = list(range(n_blocks))
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
        blocks, block ids, owner replica: 0 on a hit, None on a miss). The
        usable match is capped at (p_len - 1) // block_tokens: the lane's
        last replay step must still run to emit the first token."""
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
        return len(ids), ids, (0 if ids else None)

    def _alloc(self, protect) -> Optional[int]:
        """A free block, else the least recently used leaf outside
        ``protect`` (evicted), else None."""
        if self._free:
            return self._free.pop(0)
        leaves = [b for b in range(self.n_blocks)
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

    def load(self, cache, ids: List[int], lane: int):
        """Copy matched pool blocks into lane ``lane`` of ``cache`` in place
        and return it; padded id slots gather block 0, garbage past the
        matched length that the replay overwrites before it is attended."""
        padded = np.zeros((self.max_match_blocks,), np.int64)
        padded[:len(ids)] = ids
        self._ids.copy_(torch.from_numpy(padded))
        self.hits += 1
        self.saved_steps += len(ids) * self.block_tokens
        mcap, bt = self.max_match_blocks, self.block_tokens
        for name, cleaf in cache.items():
            got = self.pool[name].index_select(-4, self._ids)
            rows = got.reshape(*got.shape[:-4], 1, mcap * bt,
                               *got.shape[-2:])
            write_lane_window(cleaf, rows, lane, 0)
        return cache

    def insert(self, tokens, p_len: int, cache, lane: int) -> int:
        """Register a cleanly finished lane's prompt blocks: walk the trie
        and copy each missing block out of the lane's KV. Returns the
        number of blocks saved."""
        limit = min((p_len - 1) // self.block_tokens, self.max_match_blocks)
        parent = -1
        path: set = set()
        saved = 0
        for i, chunk in enumerate(self._chunks(np.asarray(tokens), limit)):
            bid = self._node.get((parent, chunk))
            if bid is None:
                bid = self._alloc(path)
                if bid is None:
                    break
                self._node[(parent, chunk)] = bid
                self._key_of[bid] = (parent, chunk)
                self._children[bid] = 0
                if parent >= 0:
                    self._children[parent] += 1
                for name, cleaf in cache.items():
                    rows = slice_lane_window(cleaf, lane,
                                             i * self.block_tokens,
                                             self.block_tokens)
                    write_lane_window(self.pool[name], rows, bid, 0)
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
