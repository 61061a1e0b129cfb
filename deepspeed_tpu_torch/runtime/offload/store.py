"""Tiered residency store: key → {host, nvme} (counterpart of
``deepspeed_tpu/runtime/offload/store.py``).

One :class:`TieredStore` owns the host cache and the NVMe chunk backing
for a set of keyed tensors.  Residency per key is the set of tiers
currently holding a valid copy:

* ``host`` — a CPU tensor in the store's LRU cache, bounded by
  ``max_in_cpu`` bytes;
* ``nvme`` — a CRC'd chunk file owned by the :class:`StagingPool`.

``put`` is write-through (host cache + async NVMe write); ``prefetch``
issues async reads for the next window; ``get`` joins them — a read that
finished before it was needed is a **ring hit**, one still in flight or
never issued is a **ring miss** whose blocking time is the stall.
The host copies are the caller's tensors as given (pinned ones stay
pinned), so a restage from the host tier copies to the device directly.
``invalidate`` drops every cached and staged copy, so that after a
rollback the caller re-persists from the restored state (stale NVMe bytes
must never survive a rollback).  JAX's store also marks a device tier
(``mark_hbm``), which only its residency report reads; the port's callers
hold their device copies themselves.
"""

import threading
from collections import OrderedDict
from typing import Any, Dict, Iterable, Optional, Tuple

import torch

from deepspeed_tpu_torch.runtime.offload.staging import (StagingError, StagingFuture,
                                                         StagingPool, as_host_tensor)

TIER_HOST = "host"
TIER_NVME = "nvme"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class TieredStore:
    """Host-LRU + NVMe-backed key/value store of CPU tensors."""

    def __init__(self, staging: StagingPool,
                 max_in_cpu: Optional[int] = None):
        self.staging = staging
        # None = unbounded host cache; 0 = drop host copies as soon as the
        # NVMe write lands (every read then exercises the staged tier)
        self.max_in_cpu = None if max_in_cpu is None else int(max_in_cpu)
        self._host: "OrderedDict[str, torch.Tensor]" = OrderedDict()  # guarded-by: _lock
        self._host_bytes = 0                                        # guarded-by: _lock
        self._pending_reads: Dict[str, StagingFuture] = {}          # guarded-by: _lock
        # keys whose pending read lands in a buffer of the caller's
        self._reads_into: set = set()                               # guarded-by: _lock
        self._pending_writes: Dict[str, StagingFuture] = {}         # guarded-by: _lock
        self._lock = threading.RLock()
        # serializes write SUBMISSION only (prev-lookup → enqueue → record),
        # so same-key writes chain in order while the possibly-blocking
        # enqueue (staging depth cap) never stalls get()/prefetch()/stats()
        self._submit = threading.Lock()
        self.ring_hits = 0                                          # guarded-by: _lock
        self.ring_misses = 0                                        # guarded-by: _lock

    # ---- write path ---------------------------------------------------- #
    def put(self, key: str, array) -> StagingFuture:
        """Install a host copy and start the async NVMe write (its future
        is returned).  The host copy is what ``get`` serves while the write
        drains, so the caller only waits here on staging backpressure
        (the depth cap — accounted wait, taken outside the store lock).

        Overlapping writes of one key are chained (``after=`` the previous
        in-flight future) so a two-worker pool can never land the older
        bytes last; an un-joined prefetch read issued before this put is
        dropped, since its result would predate the new value."""
        host = as_host_tensor(array)
        with self._lock:
            self._host_insert(key, host)
            orphan = self._drop_read(key)
        if orphan is not None:
            orphan.wait()
        with self._submit:
            with self._lock:
                prev = self._pending_writes.get(key)
            # _submit intentionally spans the possibly-blocking enqueue:
            # same-key writes must chain in submission order, and _submit is
            # touched by no other path, so readers never stall behind it
            fut = self.staging.write(key, host, after=prev)
            with self._lock:
                self._pending_writes[key] = fut
        with self._lock:
            self._evict_to_budget()
        return fut

    def put_uncached(self, key: str, array) -> StagingFuture:  # may-block: staging backpressure
        """Write-through without a host-LRU copy (JAX's ``put_device``,
        whose pool did the device-to-host copy itself): hand ``array``, a
        host tensor the caller filled from the device, straight
        to the staging pool.  A spill larger than the host budget must not
        wash the cache; ``get`` serves it from the chunk tier (or from a
        prefetch that landed it back in the LRU).  Returns the write's
        future: the caller may write into ``array`` again once it is done."""
        array = as_host_tensor(array)
        with self._lock:
            # the new bytes supersede any cached copy / in-flight read
            old = self._host.pop(key, None)
            if old is not None:
                self._host_bytes -= _nbytes(old)
            orphan = self._drop_read(key)
        if orphan is not None:
            orphan.wait()
        with self._submit:
            with self._lock:
                prev = self._pending_writes.get(key)
            # same submission-order discipline as put() above
            fut = self.staging.write(key, array, after=prev)
            with self._lock:
                self._pending_writes[key] = fut
        return fut

    def _drop_read(self, key: str) -> Optional[StagingFuture]:  # requires-lock: _lock
        """Forget ``key``'s pending read; the read itself, when it fills a
        buffer of the caller's, for the caller to wait for (outside the
        lock), so that no forgotten read writes into a buffer reused."""
        fut = self._pending_reads.pop(key, None)
        if key in self._reads_into:
            self._reads_into.discard(key)
            return fut
        return None

    def _host_insert(self, key: str, host: torch.Tensor):  # requires-lock: _lock
        old = self._host.pop(key, None)
        if old is not None:
            self._host_bytes -= _nbytes(old)
        self._host[key] = host
        self._host_bytes += _nbytes(host)

    def _evict_to_budget(self):  # requires-lock: _lock
        """LRU-drop host copies whose NVMe write has landed until the
        cache fits ``max_in_cpu``.  Copies without durable backing are
        never dropped — correctness beats the budget."""
        if self.max_in_cpu is None:
            return
        for key in list(self._host):
            if self._host_bytes <= self.max_in_cpu:
                break
            fut = self._pending_writes.get(key)
            if fut is not None and not fut.done:
                continue
            if self.staging.chunk_info(key) is None:
                continue
            dropped = self._host.pop(key)
            self._host_bytes -= _nbytes(dropped)
            self._pending_writes.pop(key, None)

    # ---- read path ----------------------------------------------------- #
    def prefetch(self, keys: Iterable[str], into: Optional[Dict[str, torch.Tensor]] = None):
        """Issue async NVMe reads for keys not already host-resident;
        ``into`` maps a key to a host buffer of the caller's that its read
        fills (``get`` then returns that buffer, and the LRU keeps no copy
        of it: the caller reuses it).

        Read submission can block on the staging depth cap, so it happens
        OUTSIDE the store lock (one saturated queue must not stall every
        concurrent ``get``/``stats``).  A key whose write (``put_uncached``)
        is still in flight is read after that write lands.  The re-check
        before recording each future drops reads made redundant — or stale
        — by a ``put``/``get`` that landed the key meanwhile."""
        with self._lock:
            wanted = []
            for key in keys:
                if key in self._host or key in self._pending_reads:
                    continue
                wfut = self._pending_writes.get(key)
                if ((wfut is None or wfut.done)
                        and self.staging.chunk_info(key) is None):
                    continue
                wanted.append((key, wfut))
        into = into or {}
        for key, wfut in wanted:
            fut = self.staging.read(key, after=wfut, out=into.get(key))
            with self._lock:
                superseded = (key in self._host or key in self._pending_reads
                              or self._pending_writes.get(key) is not wfut)
                if not superseded:
                    self._pending_reads[key] = fut
                    if key in into:
                        self._reads_into.add(key)
            if superseded and key in into:
                fut.wait()     # the result is unused, but it fills the caller's buffer

    def get(self, key: str, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Return the host copy, joining a prefetch or falling back to a
        synchronous NVMe read (into ``out`` when given: a buffer of the
        caller's, which the LRU does not keep).  Hit/miss counts go to
        ``stats()``."""
        with self._lock:
            host = self._host.get(key)
            if host is not None:
                self._host.move_to_end(key)
                self.ring_hits += 1
                return host
            fut = self._pending_reads.pop(key, None)
            borrowed = key in self._reads_into if fut is not None else out is not None
            self._reads_into.discard(key)
        if fut is not None:
            was_done = fut.done
            host = fut.result()
        else:
            # a write may still be in flight for this key; make it durable
            # before reading it back
            with self._lock:
                wfut = self._pending_writes.get(key)
            if wfut is not None:
                wfut.result()
            was_done = False
            host = self.staging.read_sync(key, out=out)
        with self._lock:
            if was_done:
                self.ring_hits += 1
            else:
                self.ring_misses += 1
            if borrowed:
                return host
            cur = self._host.get(key)
            if cur is not None:
                # a concurrent put() installed a fresher copy while this
                # thread was blocked on the NVMe read — the disk bytes are
                # stale and must neither clobber the cache nor be returned
                self._host.move_to_end(key)
                return cur
            self._host_insert(key, host)
            self._evict_to_budget()
        return host

    def ready(self, key: str) -> bool:
        """True when a ``get`` of ``key`` would not block: host-resident,
        or an issued prefetch has completed.  Pure state inspection
        (``StagingFuture.done`` is a non-blocking event check) — the
        scheduler polls this to admit restaging sequences only once their
        window is resident."""
        with self._lock:
            if key in self._host:
                return True
            fut = self._pending_reads.get(key)
            return fut is not None and fut.done

    # ---- residency / coherence ----------------------------------------- #
    def residency(self, key: str) -> Tuple[str, ...]:
        with self._lock:
            tiers = []
            if key in self._host:
                tiers.append(TIER_HOST)
            if self.staging.chunk_info(key) is not None:
                tiers.append(TIER_NVME)
            return tuple(tiers)

    def host_bytes(self) -> int:
        with self._lock:
            return self._host_bytes

    def drain(self):
        """Block until every pending write is durable (and checked)."""
        with self._lock:
            writes = list(self._pending_writes.items())
        for key, fut in writes:
            fut.result()
        with self._lock:
            for key, _ in writes:
                self._pending_writes.pop(key, None)
            self._evict_to_budget()
        self.staging.sync_manifest()

    def remove(self, key: str):
        """Drop every copy of one key — host cache, pending I/O, NVMe
        chunk — so a later ``get``/``residency`` cannot serve a deleted
        leaf from the LRU.  An in-flight write is joined first; otherwise
        it would recreate the chunk file after the delete."""
        with self._lock:
            host = self._host.pop(key, None)
            if host is not None:
                self._host_bytes -= _nbytes(host)
            orphan = self._drop_read(key)
            wfut = self._pending_writes.pop(key, None)
        if orphan is not None:
            orphan.wait()
        if wfut is not None:
            try:
                wfut.result()
            except StagingError:
                pass
        self.staging.delete(key)

    def stats(self) -> Dict[str, Any]:
        snap = self.staging.snapshot()
        with self._lock:
            snap.update(ring_hits=self.ring_hits,
                        ring_misses=self.ring_misses,
                        host_bytes=self._host_bytes,
                        host_keys=len(self._host))
        return snap

    def invalidate(self):
        """Drop every cached and staged copy (rollback coherence): the
        caller re-persists from the restored state, so nothing staged from
        the abandoned trajectory may be read again."""
        self.drain()
        # chunk deletion is file I/O, outside the lock; the trainer is
        # quiescent, so nothing stages between the deletes and the clear
        for key in list(self.staging.keys()):
            self.staging.delete(key)
        with self._lock:
            orphans = [self._pending_reads[k] for k in self._reads_into
                       if k in self._pending_reads]
            self._host.clear()
            self._host_bytes = 0
            self._pending_reads.clear()
            self._reads_into.clear()
            self._pending_writes.clear()
        for fut in orphans:
            fut.wait()
