"""Tiered KV cache — spill evicted sequences to host/NVMe, restore on
re-admission (counterpart of ``deepspeed_tpu/serving/kv_tiering.py``).

Where ZeRO-Infinity (arxiv 2104.07857) virtualizes training state across
device, host and NVMe, this module virtualizes the *paged KV arena*.  A
sequence the scheduler would otherwise destructively evict instead has
its block contents copied device→host into pinned memory and handed to a
:class:`~deepspeed_tpu_torch.runtime.offload.TieredStore` (host LRU bounded by
``kv_host_cache_bytes``, write-through to CRC-framed NVMe chunks).  On re-admission the bytes restage through the store's
async prefetch ring — kicked while the sequence still waits, polled via
``restage_ready`` so admission happens only once the window is resident —
and are scattered back into freshly allocated blocks.  Restore is bitwise
(the store CRC-verifies every chunk), so greedy token identity holds by
construction rather than by recompute.

Coherence is epoch-keyed: every spill of a sequence gets a fresh
``kvseq/<rid>/<epoch>`` key and removes its predecessor, and a restage or
discard removes the key outright — so a finished sequence's stale bytes
can never resurface in a reused block id.

The copies.  A spill is one ``index_select`` of K and one of V on the
engine's stream (so after the dispatch that last wrote the blocks), each
copied into one pinned host tensor, which the store then keeps as the host
copy; ``spill`` returns once an event recorded after the copies has
completed, so the scheduler may hand the blocks back to the allocator.  A
restage copies the host tensor to the device and ``index_copy_``s it into
the arena, also on the engine's stream, so the next dispatch reads the
restored blocks.  Pinned tensors come from PyTorch's caching host
allocator, which keeps a freed one until its last copy has finished.  On
the CPU the same calls run with plain host tensors.

JAX's manager moves a spill through a ring of ``ring_depth`` chunks of
``spill_chunk_blocks`` (``kv_ring_depth`` / ``kv_spill_chunk_blocks``),
which overlaps its gathers with their transfers.  Here the whole copy is
ordered on one stream; the serving config takes both keys and they shape
nothing.
"""

import contextlib
import shutil
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from deepspeed_tpu_torch.runtime.offload import (TIER_HOST, TIER_NVME, StagingPool,
                                                 TieredStore)


@dataclass
class SpillRecord:
    key: str
    nbytes: int
    tokens: int
    n_blocks: int
    epoch: int


class KVTieringManager:
    """Owns the spill/restage data path for one serving engine.

    The engine thread drives spill/restage and every device call; the
    staging pool's worker threads complete the file I/O — so the
    bookkeeping below is shared state.  ``_lock`` wraps only dict/counter
    mutation, never a store or staging call — those block on disk and
    backpressure, and must not stall a concurrent ``stats()``.
    ``stream`` is the engine's CUDA stream (None: the current stream).
    """

    def __init__(self, offload_dir: Optional[str] = None,
                 host_cache_bytes: int = 1 << 30,
                 spill_budget_bytes: int = 0, stream=None):
        if offload_dir is None:
            offload_dir = tempfile.mkdtemp(prefix="dst-kv-tier-")
            self._owns_dir = True
        else:
            self._owns_dir = False
        self.offload_dir = offload_dir
        self.host_cache_bytes = int(host_cache_bytes)
        self.spill_budget_bytes = int(spill_budget_bytes)  # 0 = unbounded
        self.stream = stream
        self.staging = StagingPool(offload_dir)
        self.store = TieredStore(self.staging, max_in_cpu=self.host_cache_bytes)
        self._lock = threading.Lock()
        self._seqs: Dict[int, SpillRecord] = {}   # guarded-by: _lock
        self._epoch = 0                           # guarded-by: _lock
        self._spilled_bytes = 0                   # guarded-by: _lock
        self.spill_count = 0                      # guarded-by: _lock
        self.restage_count = 0                    # guarded-by: _lock
        self.restage_wait_s = 0.0                 # guarded-by: _lock
        self.restage_sources: Dict[str, int] = {TIER_HOST: 0, TIER_NVME: 0}
        self.restage_waits: List[float] = []      # seconds, one a restage
        # copy traffic (engine thread only): spills on the host clock (the
        # caller waits for them), restages in device time on the card
        self.d2h_bytes = self.h2d_bytes = 0
        self.d2h_s = 0.0
        self._h2d_s = 0.0
        self._h2d_events: List[Tuple[Any, Any]] = []
        self._closed = False

    # ---- copies ------------------------------------------------------ #
    def _on_stream(self, device):
        """The engine's stream as the current one on the card."""
        if device.type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream if self.stream is not None
                                 else torch.cuda.current_stream(device))

    def _gather_to_host(self, kp, vp, blocks: List[int]) -> torch.Tensor:
        """Device→host: one ``[2, L, n_blocks, BS, H, D]`` host tensor
        (pinned on the card) of ``blocks``, landed when this returns."""
        t0 = time.perf_counter()
        L, _, BS, H, D = kp.shape
        cuda = kp.device.type == "cuda"
        out = torch.empty((2, L, len(blocks), BS, H, D), dtype=kp.dtype, pin_memory=cuda)
        with self._on_stream(kp.device):
            idx = torch.tensor(blocks, dtype=torch.long, device=kp.device)
            out[0].copy_(kp.index_select(1, idx), non_blocking=True)
            out[1].copy_(vp.index_select(1, idx), non_blocking=True)
            if cuda:
                landed = torch.cuda.Event()
                landed.record()
        if cuda:
            landed.synchronize()
        self.d2h_bytes += out.numel() * out.element_size()
        self.d2h_s += time.perf_counter() - t0
        return out

    def _scatter_from_host(self, kp, vp, data: torch.Tensor, dest_blocks: List[int]):
        """Host→device into ``dest_blocks``, queued on the engine's stream."""
        t0 = time.perf_counter()
        cuda = kp.device.type == "cuda"
        with self._on_stream(kp.device):
            if cuda:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
            idx = torch.tensor(dest_blocks, dtype=torch.long, device=kp.device)
            dev = data.to(kp.device, non_blocking=True)
            kp.index_copy_(1, idx, dev[0])
            vp.index_copy_(1, idx, dev[1])
            if cuda:
                end.record()
                self._fold_h2d(wait=False)
                self._h2d_events.append((start, end))
            else:
                self._h2d_s += time.perf_counter() - t0
        self.h2d_bytes += data.numel() * data.element_size()

    def _fold_h2d(self, wait: bool) -> None:
        """Add the finished restages' event times to the total (all of
        them, waiting for the last, with ``wait``)."""
        pending = []
        for start, end in self._h2d_events:
            if wait or end.query():
                end.synchronize()
                self._h2d_s += start.elapsed_time(end) / 1e3
            else:
                pending.append((start, end))
        self._h2d_events = pending

    @property
    def h2d_s(self) -> float:
        """Seconds the restages' copies and scatters took: device time
        between CUDA events on the card, the host clock on the CPU."""
        self._fold_h2d(wait=True)
        return self._h2d_s

    # ---- capacity ------------------------------------------------------- #
    def chunk_bytes(self, kp, n_blocks: int) -> int:
        """Spill footprint of ``n_blocks`` arena blocks (K and V)."""
        L, _, BS, H, D = kp.shape
        return 2 * L * int(n_blocks) * BS * H * D * kp.element_size()

    def can_spill(self, nbytes: int) -> bool:
        """Whether the spill budget admits ``nbytes`` more.  Budget 0 is
        unbounded — the host+NVMe tier is then 'full' only when the disk
        itself fails, which surfaces as a StagingError."""
        if not self.spill_budget_bytes:
            return True
        with self._lock:
            return self._spilled_bytes + nbytes <= self.spill_budget_bytes

    # ---- spill path ------------------------------------------------------ #
    def spill(self, rid: int, blocks: List[int], kp, vp,
              tokens: int) -> Optional[str]:  # may-block: staging backpressure
        """Capture ``rid``'s block contents into the tiered store before
        its arena blocks are reclaimed (every copy has landed on return).
        Returns the landing tier (``"host"``/``"nvme"``) or None when the
        spill budget refuses — the caller then falls back to destructive
        evict+recompute."""
        nbytes = self.chunk_bytes(kp, len(blocks))
        if not blocks or not self.can_spill(nbytes):
            return None
        with self._lock:
            self._epoch += 1
            epoch = self._epoch
            old = self._seqs.pop(rid, None)
            if old is not None:
                self._spilled_bytes -= old.nbytes
        if old is not None:
            # superseded spill: its epoch key must not outlive this one
            self.store.remove(old.key)
        key = f"kvseq/{rid}/{epoch}"
        host = self._gather_to_host(kp, vp, blocks)
        if nbytes > self.host_cache_bytes:
            # larger than the whole host cache: straight to the chunk tier,
            # don't wash the LRU
            self.store.put_uncached(key, host)
        else:
            self.store.put(key, host)
        with self._lock:
            self._seqs[rid] = SpillRecord(key=key, nbytes=nbytes,
                                          tokens=int(tokens),
                                          n_blocks=len(blocks), epoch=epoch)
            self._spilled_bytes += nbytes
            self.spill_count += 1
        return TIER_HOST if TIER_HOST in self.store.residency(key) else TIER_NVME

    def spilled_tokens(self, rid: int) -> int:
        with self._lock:
            rec = self._seqs.get(rid)
            return rec.tokens if rec is not None else 0

    def is_spilled(self, rid: int) -> bool:
        with self._lock:
            return rid in self._seqs

    # ---- restage path ---------------------------------------------------- #
    def begin_restage(self, rid: int) -> None:
        """Kick the async prefetch for ``rid``'s spilled bytes (idempotent;
        a no-op when host-resident or already in flight)."""
        with self._lock:
            rec = self._seqs.get(rid)
        if rec is not None:
            self.store.prefetch([rec.key])

    def restage_ready(self, rid: int) -> bool:
        """True when ``restage`` would not block on the NVMe read."""
        with self._lock:
            rec = self._seqs.get(rid)
        return rec is not None and self.store.ready(rec.key)

    def restage(self, rid: int, kp, vp,  # may-block: joins the chunk read
                dest_blocks: List[int]) -> Tuple[Any, Any, Dict[str, Any]]:
        """Restore ``rid``'s spilled KV into ``dest_blocks`` (in place)
        and drop the spill record + chunk.  Returns ``(kp, vp, info)``.
        Raises KeyError when ``rid`` has no spill record and StagingError
        when the bytes are unreadable (the caller falls back to
        recompute)."""
        with self._lock:
            rec = self._seqs.get(rid)
        if rec is None:
            raise KeyError(f"no spill record for rid {rid}")
        if len(dest_blocks) != rec.n_blocks:
            raise ValueError(f"restage of {rec.n_blocks} blocks into {len(dest_blocks)}")
        ready = self.store.ready(rec.key)
        source = (TIER_HOST if TIER_HOST in self.store.residency(rec.key)
                  else TIER_NVME)
        t0 = time.perf_counter()
        data = self.store.get(rec.key)
        wait = time.perf_counter() - t0
        self._scatter_from_host(kp, vp, data, dest_blocks)
        with self._lock:
            self._seqs.pop(rid, None)
            self._spilled_bytes -= rec.nbytes
            self.restage_count += 1
            self.restage_wait_s += wait
            self.restage_sources[source] += 1
            self.restage_waits.append(wait)
        self.store.remove(rec.key)   # restored: the staged copy is dead
        return kp, vp, {"source": source, "ready": ready, "wait_s": wait,
                        "bytes": rec.nbytes, "blocks": rec.n_blocks,
                        "tokens": rec.tokens}

    def discard(self, rid: int) -> bool:
        """Drop ``rid``'s spill record and every staged copy (sequence
        finished or fell back to recompute).  The remove joins any
        in-flight write first, so a reused key epoch can never read these
        bytes back."""
        with self._lock:
            rec = self._seqs.pop(rid, None)
            if rec is not None:
                self._spilled_bytes -= rec.nbytes
        if rec is None:
            return False
        self.store.remove(rec.key)
        return True

    # ---- introspection / lifecycle --------------------------------------- #
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {"kv_spilled_seqs": len(self._seqs),
                   "kv_spilled_bytes": self._spilled_bytes,
                   "kv_spills": self.spill_count,
                   "kv_restages": self.restage_count,
                   "kv_restage_wait_ms": self.restage_wait_s * 1000.0}
        store = self.store.stats()
        out["kv_host_bytes"] = store.get("host_bytes", 0)
        out["kv_nvme_bytes"] = self.staging.total_bytes()
        out["kv_ring_hits"] = store.get("ring_hits", 0)
        out["kv_ring_misses"] = store.get("ring_misses", 0)
        return out

    def describe(self) -> str:
        """Tier occupancy summary for ArenaExhausted messages."""
        s = self.stats()
        budget = (f"{self.spill_budget_bytes}B budget"
                  if self.spill_budget_bytes else "unbounded")
        return (f"host {s['kv_host_bytes']}B/{self.host_cache_bytes}B, "
                f"nvme {s['kv_nvme_bytes']}B ({budget}), "
                f"{s['kv_spilled_seqs']} spilled seqs")

    def drain(self) -> None:
        """Join every in-flight staging task (spill writes, restage
        prefetch reads) without closing the backend.  The serving engine
        calls this before close() and during wedge recovery.  No staging
        task touches the arena: a spill's device copies have landed when
        ``spill`` returns."""
        if not self._closed:
            self.staging.drain()

    def close(self) -> None:
        """Idempotent shutdown: drain staging, drop an owned tempdir."""
        if self._closed:
            return
        self._closed = True
        self.staging.close()
        if self._owns_dir:
            shutil.rmtree(self.offload_dir, ignore_errors=True)
