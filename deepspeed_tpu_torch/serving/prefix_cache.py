"""Refcounted prefix cache — shared system prompts prefilled once
(counterpart of ``deepspeed_tpu/serving/prefix_cache.py``, the same host
Python).

A radix-style trie over *block-aligned* token chunks: each edge is one
``block_size``-token tuple, each node pins one physical KV block in the
:class:`~deepspeed_tpu_torch.serving.kv_cache.PagedKVAllocator` (the node holds
a reference, so the block survives its original sequence finishing).  A
request whose prompt starts with a cached chunk path adopts those blocks
copy-free — prefill skips the matched tokens entirely.

Copy-on-write is structural rather than mechanical: only FULL prompt
blocks are ever inserted, and a match is capped strictly below the prompt
length, so every KV write a sequence performs (its unmatched prompt tail
and all generated tokens) lands in private refcount-1 blocks.  Divergence
after a shared prefix therefore never mutates a shared block — there is
nothing to copy.

The cache is a *reclaimable* tenant of the arena: ``release(n)`` drops
least-recently-used leaf pins until ``n`` blocks actually return to the
free list, which the scheduler uses as the first (non-destructive) rung of
its eviction ladder.  Nothing here touches the device; the blocks' device
contents are whatever prefill wrote, untouched.
"""

from typing import Dict, List, Optional, Tuple

from deepspeed_tpu_torch.serving.kv_cache import PagedKVAllocator


class _Node:
    __slots__ = ("children", "block", "last_use")

    def __init__(self, block: Optional[int] = None):
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.block = block          # physical block this node pins (root: None)
        self.last_use = 0


class PrefixCache:
    """Trie of block-aligned prompt chunks over refcounted arena blocks.

    ``max_blocks`` bounds how many arena blocks the cache may pin
    (0 = unbounded up to the arena); past it, LRU leaves are dropped.
    """

    def __init__(self, alloc: PagedKVAllocator, max_blocks: int = 0):
        self.alloc = alloc
        self.block_size = alloc.block_size
        self.max_blocks = int(max_blocks)
        self._root = _Node()
        self._clock = 0                 # monotonic touch counter (LRU key)
        self.cached_blocks = 0
        self.lookups = 0
        self.hits = 0
        self.insertions = 0
        self.released_blocks = 0

    # ---- read path ----------------------------------------------------- #
    def lookup(self, prompt: List[int]) -> List[int]:
        """Longest cached block-aligned prefix of ``prompt`` → physical
        block list (possibly empty).  The match is capped at
        ``(len(prompt) - 1) // block_size`` chunks — strictly shorter than
        the prompt — so at least one prompt token always goes through
        prefill and the completing chunk still yields the first new token
        from real logits."""
        self.lookups += 1
        self._clock += 1
        max_chunks = max(0, (len(prompt) - 1) // self.block_size)
        node, blocks = self._root, []
        for i in range(max_chunks):
            chunk = tuple(prompt[i * self.block_size:(i + 1) * self.block_size])
            child = node.children.get(chunk)
            if child is None:
                break
            child.last_use = self._clock
            blocks.append(child.block)
            node = child
        if blocks:
            self.hits += 1
        return blocks

    # ---- write path ---------------------------------------------------- #
    def insert(self, prompt: List[int], blocks: List[int]) -> int:
        """Pin ``prompt``'s full blocks into the trie.  ``blocks`` is the
        sequence's physical block list in logical order; only the first
        ``len(prompt) // block_size`` (full prompt chunks) are eligible.
        Existing nodes keep their original block (idempotent — re-inserting
        a shared prompt adds no references); new nodes take one reference
        each.  Returns how many new blocks were pinned."""
        n = min(len(prompt) // self.block_size, len(blocks))
        node, added = self._root, 0
        self._clock += 1
        for i in range(n):
            chunk = tuple(prompt[i * self.block_size:(i + 1) * self.block_size])
            child = node.children.get(chunk)
            if child is None:
                child = _Node(block=blocks[i])
                self.alloc.ref(blocks[i])
                node.children[chunk] = child
                self.cached_blocks += 1
                self.insertions += 1
                added += 1
            child.last_use = self._clock
            node = child
        if self.max_blocks:
            while self.cached_blocks > self.max_blocks:
                if not self._drop_lru_leaf():
                    break
        return added

    # ---- reclamation ---------------------------------------------------- #
    def _lru_leaf(self) -> Optional[Tuple[_Node, Tuple[int, ...], _Node]]:
        """(parent, edge, leaf) of the least-recently-used leaf, or None."""
        best = None
        stack = [self._root]
        while stack:
            node = stack.pop()
            for edge, child in node.children.items():
                if child.children:
                    stack.append(child)
                elif best is None or child.last_use < best[2].last_use:
                    best = (node, edge, child)
        return best

    def _drop_lru_leaf(self) -> bool:
        """Unpin one LRU leaf; returns whether a pin was dropped.  The
        block only re-enters the free list if no sequence still holds it —
        unref's return value tells ``release`` how much was reclaimed."""
        found = self._lru_leaf()
        if found is None:
            return False
        parent, edge, leaf = found
        del parent.children[edge]
        self.cached_blocks -= 1
        if self.alloc.unref(leaf.block):
            self.released_blocks += 1
        return True

    def release(self, n_blocks: int) -> int:
        """Drop LRU leaves until ``n_blocks`` blocks actually returned to
        the free list (or the cache is empty).  Returns blocks freed."""
        before = self.released_blocks
        while self.released_blocks - before < n_blocks:
            if not self._drop_lru_leaf():
                break
        return self.released_blocks - before

    # ---- introspection -------------------------------------------------- #
    def stats(self) -> Dict[str, int]:
        return {"prefix_lookups": self.lookups,
                "prefix_hits": self.hits,
                "prefix_cached_blocks": self.cached_blocks,
                "prefix_insertions": self.insertions,
                "prefix_released_blocks": self.released_blocks}
