"""Paged KV-cache allocator — fixed-size blocks in a preallocated arena
(counterpart of ``deepspeed_tpu/serving/kv_cache.py``; the allocator is the
same host Python, the arena a pair of torch tensors on a given device).

The serving-side analogue of ZeRO-Infinity's memory virtualization (arxiv
2104.07857): a sequence's LOGICAL KV memory is decoupled from PHYSICAL HBM
placement, so arena capacity — not batch shape — is the binding constraint.
The device arena is ``[n_layer, num_blocks, block_size, kv_heads, head_dim]``
per K and V; this module owns the host-side bookkeeping:

* a free list of physical block ids (block 0 is reserved as the TRASH
  block: padded/inactive tokens scatter their K/V there, so the compiled
  step needs no write predication);
* a per-sequence block table in logical order, padded to
  ``max_blocks_per_seq`` with trash for the traced ``[B, MB]`` input;
* **per-block refcounts**: a block may be shared by several sequences (the
  prefix cache attaches a cached system-prompt block to every request that
  matches it) plus the cache itself; a block returns to the free list only
  when its last reference drops.  Divergence is copy-on-write by
  construction: only *full*, immutable prompt blocks are ever shared, so
  every KV write lands in a private (refcount-1, single-owner) block;
* eviction: a preempted sequence returns every block to the free list and
  is later *recomputed* (re-prefilled over prompt + generated-so-far).

All methods are O(blocks touched); nothing here touches the device except
``init_arena``.
"""

from typing import Dict, List, Optional

import numpy as np


class ArenaExhausted(Exception):
    """No free blocks and the caller chose not to (or could not) evict."""


class PagedKVAllocator:
    """Host-side free-list allocator over ``num_blocks`` physical blocks.

    Block 0 is the trash block and is never handed out; usable capacity is
    ``num_blocks - 1`` blocks = ``(num_blocks - 1) * block_size`` tokens.
    """

    TRASH = 0

    def __init__(self, num_blocks: int, block_size: int,
                 max_blocks_per_seq: int):
        assert num_blocks >= 2, "arena needs >= 1 usable block + trash"
        assert block_size >= 1 and max_blocks_per_seq >= 1
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        # LIFO free list: recently-freed blocks are reused first (their
        # pages are hot, and stale contents are fully overwritten before
        # any masked-in position can read them)
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._owned: Dict[object, List[int]] = {}   # seq id -> blocks, logical order
        # block id -> total references (sequence owners + prefix-cache pins);
        # a block is live iff it has an entry here, free iff it is in _free
        self._refs: Dict[int, int] = {}
        self.eviction_count = 0

    # -- capacity queries -------------------------------------------------- #
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    def blocks_for_tokens(self, n_tokens: int) -> int:
        return -(-max(0, int(n_tokens)) // self.block_size)

    def capacity_tokens(self) -> int:
        """Largest single-sequence footprint this arena can ever hold."""
        return min(self.num_blocks - 1, self.max_blocks_per_seq) * self.block_size

    def can_allocate(self, seq_id, n_tokens: int) -> bool:
        need = self.blocks_for_tokens(n_tokens) - len(self._owned.get(seq_id, ()))
        return need <= self.free_blocks

    # -- lifecycle --------------------------------------------------------- #
    def allocate(self, seq_id, n_tokens: int) -> bool:
        """Grow ``seq_id``'s block list to cover ``n_tokens`` logical
        tokens.  Returns False when the free list cannot cover the growth —
        the scheduler then evicts a victim and retries.
        Raises when a single sequence exceeds ``max_blocks_per_seq``.

        Partial-growth contract: a failed growth is all-or-nothing.  The
        free-list check happens before any block is popped, so on False a
        nonempty owner's ``_owned`` list is byte-identical to before the
        call (the scheduler may already have written KV into those blocks;
        mutating the list here would orphan live device state), and an
        owner that was empty is removed rather than left as a zero-block
        entry.  The post-assert pins this down so a future rewrite of the
        growth loop cannot quietly reintroduce partial growth."""
        owned = self._owned.setdefault(seq_id, [])
        before = len(owned)
        need = self.blocks_for_tokens(n_tokens)
        if need > self.max_blocks_per_seq:
            raise ArenaExhausted(
                f"sequence needs {need} blocks > max_blocks_per_seq "
                f"{self.max_blocks_per_seq}")
        grow = need - before
        if grow <= 0:
            return True
        if grow > len(self._free):
            if not owned:
                del self._owned[seq_id]
            assert len(self._owned.get(seq_id, ())) == before, (
                "failed growth mutated _owned")
            return False
        for _ in range(grow):
            b = self._free.pop()
            self._refs[b] = 1
            owned.append(b)
        return True

    def free(self, seq_id) -> int:
        """Drop ``seq_id``'s reference on every owned block; blocks whose
        last reference this was return to the free list.  Idempotent on
        unknown ids (a finished-then-evicted race is not an error)."""
        blocks = self._owned.pop(seq_id, [])
        # unref in reverse logical order so unshared blocks re-enter the
        # LIFO free list in the same order the pre-refcount free() used
        for b in reversed(blocks):
            self.unref(b)
        return len(blocks)

    def evict(self, seq_id) -> int:
        """Preemption-path free: same reclamation, counted separately so
        telemetry can distinguish completion from eviction."""
        n = self.free(seq_id)
        if n:
            self.eviction_count += 1
        return n

    # -- sharing (prefix cache) -------------------------------------------- #
    def ref(self, block: int) -> None:
        """Add a reference to a live block (prefix-cache pin or attach)."""
        assert block in self._refs, f"ref on non-live block {block}"
        self._refs[block] += 1

    def unref(self, block: int) -> bool:
        """Drop one reference; returns True when the block was actually
        freed (last reference gone → back on the free list)."""
        refs = self._refs.get(block)
        assert refs is not None and refs > 0, f"unref on dead block {block}"
        if refs > 1:
            self._refs[block] = refs - 1
            return False
        del self._refs[block]
        self._free.append(block)
        return True

    def adopt(self, seq_id, blocks: List[int]) -> None:
        """Attach already-live (cached-prefix) blocks as ``seq_id``'s
        logical prefix, copy-free: each gains a reference.  Must precede
        any private growth — the shared blocks are the sequence's first
        logical blocks, and they are full by construction, so every later
        write lands past them in private blocks (structural COW)."""
        assert not self._owned.get(seq_id), (
            f"adopt must precede private growth for {seq_id}")
        for b in blocks:
            self.ref(b)
        self._owned[seq_id] = list(blocks)

    def owned_blocks(self, seq_id) -> List[int]:
        """Copy of ``seq_id``'s physical block list, logical order."""
        return list(self._owned.get(seq_id, ()))

    # -- table / write-map construction (traced-input shaping) ------------- #
    def block_table(self, seq_id) -> np.ndarray:
        """[max_blocks_per_seq] int32 physical ids, trash-padded."""
        table = np.full((self.max_blocks_per_seq,), self.TRASH, np.int32)
        owned = self._owned.get(seq_id, ())
        table[:len(owned)] = owned
        return table

    def write_map(self, seq_id, start: int, n_tokens: int,
                  n_valid: Optional[int] = None):
        """Physical (block, offset) for tokens at logical positions
        ``start .. start + n_tokens - 1``; positions past ``n_valid``
        (pad tail of a bucketed prefill chunk) are routed to the trash
        block.  → ([n_tokens] int32 blocks, [n_tokens] int32 offsets)."""
        owned = self._owned.get(seq_id, ())
        pos = start + np.arange(int(n_tokens))
        logical = pos // self.block_size
        nv = int(n_tokens) if n_valid is None else min(int(n_valid), int(n_tokens))
        assert nv == 0 or logical[nv - 1] < max(len(owned), 1), (
            f"write past allocation: pos {pos[nv - 1]} needs block "
            f"{logical[nv - 1]}, own {len(owned)}")
        phys = np.asarray([owned[b] if b < len(owned) else self.TRASH
                           for b in logical], np.int32)
        off = (pos % self.block_size).astype(np.int32)
        if n_valid is not None and n_valid < n_tokens:
            phys[n_valid:] = self.TRASH
        return phys, off

    # -- invariants (tests) ------------------------------------------------ #
    def check_consistent(self):
        """Every physical block is exactly one of: trash, free, or live
        with refcount >= 1 — and a live block's references account for
        every sequence holding it (sharing beyond the owner count is the
        prefix cache's pin).  Raises AssertionError on violation."""
        owners: Dict[int, int] = {}
        for seq_id, blocks in self._owned.items():
            in_seq = set()
            for b in blocks:
                assert 0 < b < self.num_blocks, f"bad block id {b}"
                assert b not in in_seq, f"block {b} twice in {seq_id}"
                in_seq.add(b)
                owners[b] = owners.get(b, 0) + 1
        for b, refs in self._refs.items():
            assert 0 < b < self.num_blocks, f"bad live block id {b}"
            assert refs >= 1, f"live block {b} with refcount {refs}"
        for b, n in owners.items():
            assert n <= self._refs.get(b, 0), (
                f"block {b}: {n} owners > {self._refs.get(b, 0)} refs")
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate free-list entry"
        assert not (free & self._refs.keys()), (
            f"blocks both free and live: {sorted(free & self._refs.keys())}")
        assert self.TRASH not in free and self.TRASH not in self._refs, (
            "trash block handed out")
        covered = {self.TRASH} | free | self._refs.keys()
        assert len(covered) == self.num_blocks, (
            f"leaked blocks: {self.num_blocks - len(covered)}")


def init_arena(cfg, num_blocks: int, block_size: int, dtype=None, device=None):
    """Device arena pair for ``models/gpt.py:gpt_paged_step``:
    K/V ``[n_layer, num_blocks, block_size, kv_heads, head_dim]`` zeros on
    ``device`` (default: the current CUDA device)."""
    import torch
    from deepspeed_tpu_torch.accelerator.real_accelerator import resolve_device
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    shape = (cfg.n_layer, num_blocks, block_size, cfg.kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


def arena_bytes(cfg, num_blocks: int, block_size: int, dtype_bytes: int = 2) -> int:
    return (2 * cfg.n_layer * num_blocks * block_size * cfg.kv_heads
            * cfg.head_dim * dtype_bytes)
