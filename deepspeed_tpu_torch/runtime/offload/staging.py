"""Async NVMe staging pool — the I/O engine under the tiered offload store
(counterpart of ``deepspeed_tpu/runtime/offload/staging.py``).

* **background worker threads** (``THREAD_COUNT``) drain a bounded task
  queue, so enqueueing a write returns at once and the file I/O overlaps
  the caller's next work.  The pool takes host tensors only: the caller
  moves device bytes to the host itself, so no worker thread ever makes a
  CUDA call;
* **double-buffered bounce buffers**: file I/O goes through a fixed pool of
  ``BUFFER_COUNT`` reusable ``BUFFER_SIZE``-byte buffers (a byte-budget
  semaphore), so the number of chunk copies in flight is capped — the
  backpressure that keeps a fast producer from ballooning host RAM;
* **capped in-flight depth** (``QUEUE_DEPTH``): submission blocks once that
  many tasks are outstanding — the time a submitter spends blocked on the
  cap is accounted to ``wait_s`` (and a dedicated ``submit_wait_s``);
* **per-key write ordering**: ``write(key, ..., after=prev_future)`` makes
  the worker wait for the previous in-flight write of the same key before
  touching the file, so two overlapping writes of one key can never land
  out of order;
* **CRC'd chunk files**: every chunk file's CRC-32 is computed while the
  bytes stream through the bounce buffer and recorded in a
  ``STAGING_MANIFEST.json`` written with the checkpoint plane's atomic
  primitives (``runtime/checkpoint_engine/manifest.py``) — reads verify
  before returning, so torn writes and storage rot surface as
  :class:`StagingError`, never as silently corrupt bytes.

A tensor is staged as its raw bytes (``t.contiguous().view(torch.uint8)``)
and the manifest records its shape and dtype name (``"float32"``,
``"bfloat16"``, ``"int8"``, ...), which this module maps to a
``torch.dtype`` itself.  The chunk files and the manifest are the JAX
package's, byte for byte: a folder that either package's pool wrote, the
other's reads.
"""

import os
import queue
import threading
import time
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.runtime.checkpoint_engine.manifest import (atomic_write_json,
                                                                    fsync_dir)

MANIFEST_FILE = "STAGING_MANIFEST.json"
MANIFEST_VERSION = 1

# the JAX pool's defaults, which its serving tier runs with
BUFFER_COUNT = 2
BUFFER_SIZE = 1 << 20
QUEUE_DEPTH = 8
THREAD_COUNT = 2


class StagingError(RuntimeError):
    """Unrecoverable staging failure (missing chunk, CRC mismatch, I/O
    error surfaced from a worker)."""


def dtype_name(dtype: torch.dtype) -> str:
    """The manifest's dtype name: numpy's spelling, which JAX's pool
    writes (``torch.bfloat16`` -> ``"bfloat16"``)."""
    return str(dtype).removeprefix("torch.")


def _resolve_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise StagingError(f"chunk dtype {name!r} has no torch dtype")
    return dtype


def as_host_tensor(array) -> torch.Tensor:
    """A C-contiguous CPU tensor of ``array``; a device tensor is refused."""
    array = torch.as_tensor(array)
    if array.device.type != "cpu":
        raise StagingError(f"the staging pool takes host tensors; got one on {array.device} "
                           "(copy it to the host first)")
    return array.detach().contiguous()


def _byte_view(host: torch.Tensor) -> np.ndarray:
    """Flat uint8 numpy view of a contiguous CPU tensor's bytes (bf16 has
    no numpy dtype; its bytes do)."""
    return host.reshape(-1).view(torch.uint8).numpy()


class StagingFuture:
    """Join handle for one staged read/write.

    ``result()`` blocks until the worker finishes and returns the read
    tensor (``None`` for writes); the time spent *blocking* is accounted to
    the pool's ``wait_s`` — the stall the prefetch ring exists to hide.
    """

    def __init__(self, pool: "StagingPool", key: str, kind: str):
        self._pool = pool
        self.key = key
        self.kind = kind                      # "read" | "write"
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def _finish(self, value=None, error=None):
        self._value = value
        self._error = error
        self._event.set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.is_set():
            t0 = time.perf_counter()
            if not self._event.wait(timeout):
                raise StagingError(f"staging {self.kind} of {self.key!r} "
                                   f"timed out after {timeout}s")
            self._pool._account_wait(time.perf_counter() - t0, self.kind)
        if self._error is not None:
            raise StagingError(
                f"staging {self.kind} of {self.key!r} failed: "
                f"{self._error}") from self._error
        return self._value


class _BouncePool:
    """Byte-budget semaphore over ``buffer_count`` × ``buffer_size`` bytes.

    Chunk copies acquire their size before touching the file and release
    after — with two buffers this is classic double buffering (one chunk in
    flight to disk while the next is being filled)."""

    def __init__(self, buffer_count: int, buffer_size: int):
        self.buffer_size = max(1, int(buffer_size))
        self.budget = max(1, int(buffer_count)) * self.buffer_size
        self._cond = threading.Condition()
        self._avail = self.budget     # guarded-by: _cond

    def acquire(self, nbytes: int) -> int:  # may-block: waits for buffer space
        """Reserve ``min(nbytes, budget)`` bytes, blocking until free."""
        take = min(max(1, int(nbytes)), self.budget)
        with self._cond:
            while self._avail < take:
                self._cond.wait()
            self._avail -= take
        return take

    def release(self, taken: int):
        with self._cond:
            self._avail += taken
            self._cond.notify_all()


class StagingPool:
    """Bounded async read/write queues over CRC'd chunk files."""

    def __init__(self, folder: str):
        self.folder = folder
        os.makedirs(folder, exist_ok=True)
        self._bounce = _BouncePool(BUFFER_COUNT, BUFFER_SIZE)
        self._depth = threading.Semaphore(QUEUE_DEPTH)
        self._queue: "queue.Queue[Optional[Tuple]]" = queue.Queue()
        self._lock = threading.Lock()
        self._manifest: Dict[str, Dict[str, Any]] = {}  # guarded-by: _lock
        self._closed = False                            # guarded-by: _lock
        # counters (read under _lock via snapshot())
        self.bytes_written = 0                          # guarded-by: _lock
        self.bytes_read = 0                             # guarded-by: _lock
        self.write_count = 0                            # guarded-by: _lock
        self.read_count = 0                             # guarded-by: _lock
        self.wait_s = 0.0                               # guarded-by: _lock
        self.read_wait_s = 0.0                          # guarded-by: _lock
        self.submit_wait_s = 0.0                        # guarded-by: _lock
        self._workers = [
            threading.Thread(target=self._worker, name=f"dst-staging-{i}",
                             daemon=True)
            for i in range(THREAD_COUNT)]
        for w in self._workers:
            w.start()
        self._load_manifest()

    # ---- manifest ----------------------------------------------------- #
    def _manifest_path(self) -> str:
        return os.path.join(self.folder, MANIFEST_FILE)

    def _load_manifest(self):
        import json
        try:
            with open(self._manifest_path()) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return
        if data.get("version") == MANIFEST_VERSION:
            # workers are already running by now — publish under the lock
            with self._lock:
                self._manifest.update(data.get("chunks", {}))

    def sync_manifest(self):  # may-block: drain + fsync'd manifest write
        """Atomically persist the chunk manifest (the checkpoint primitives: tmp +
        fsync + rename + dir fsync) — the durability point for everything
        written so far."""
        self.drain()
        with self._lock:
            chunks = dict(self._manifest)
        atomic_write_json(self._manifest_path(),
                          {"version": MANIFEST_VERSION, "chunks": chunks})
        fsync_dir(self.folder)

    def chunk_info(self, key: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            info = self._manifest.get(key)
        return dict(info) if info else None

    def keys(self):
        with self._lock:
            return sorted(self._manifest)

    def total_bytes(self) -> int:
        """Bytes currently held by the chunk tier (manifest sum) — the
        NVMe occupancy the serving spill budget is checked against."""
        with self._lock:
            return sum(int(info["bytes"]) for info in self._manifest.values())

    # ---- submission --------------------------------------------------- #
    def _path(self, key: str) -> str:
        # keys may carry path-like separators; flatten to one file name
        return os.path.join(self.folder,
                            key.replace(os.sep, "_") + ".chunk")

    def _acquire_depth(self):
        """Take a queue slot, accounting any blocking time: a saturated
        queue stalling the submitter IS staged-I/O wait and must be
        visible to the audit."""
        if self._depth.acquire(blocking=False):
            return
        t0 = time.perf_counter()
        self._depth.acquire()
        waited = time.perf_counter() - t0
        with self._lock:
            self.wait_s += waited
            self.submit_wait_s += waited

    def write(self, key: str, array,  # may-block: depth-cap backpressure
              after: Optional[StagingFuture] = None) -> StagingFuture:
        """Enqueue an async write of a host tensor; the
        worker holds its own reference, so the caller may drop its own at
        once (and must not write into it until the future is done).
        ``after`` (the previous in-flight write of the same key) is awaited
        by the worker before the file is touched, keeping same-key writes
        ordered across workers — ``after`` must be a task enqueued earlier
        on this pool's FIFO queue, which the per-key chaining in
        :class:`TieredStore` guarantees."""
        with self._lock:
            if self._closed:
                raise StagingError("staging pool is closed")
        array = as_host_tensor(array)
        fut = StagingFuture(self, key, "write")
        if after is not None and after.done:
            after = None
        self._acquire_depth()
        self._queue.put(("write", key, array, fut, after))
        return fut

    def read(self, key: str) -> StagingFuture:  # may-block: depth-cap backpressure
        """Enqueue an async (prefetch) read; ``result()`` returns the
        reassembled CPU tensor, CRC-verified."""
        with self._lock:
            if self._closed:
                raise StagingError("staging pool is closed")
        fut = StagingFuture(self, key, "read")
        self._acquire_depth()
        self._queue.put(("read", key, None, fut, None))
        return fut

    def read_sync(self, key: str) -> torch.Tensor:  # may-block: synchronous file I/O
        """Synchronous read (a prefetch-ring MISS — counted as read wait)."""
        t0 = time.perf_counter()
        out = self._do_read(key)
        self._account_wait(time.perf_counter() - t0, "read")
        return out

    def delete(self, key: str):  # may-block: chunk-file unlink
        with self._lock:
            self._manifest.pop(key, None)
        try:
            os.remove(self._path(key))
        except OSError:
            pass

    # ---- worker ------------------------------------------------------- #
    def _worker(self):
        while True:
            task = self._queue.get()
            if task is None:
                return
            op, key, array, fut, after = task
            try:
                if op == "write":
                    if after is not None:
                        # ordering barrier only — a failed predecessor must
                        # not block the newer (superseding) write
                        after._event.wait()
                    self._do_write(key, array)
                    fut._finish(None)
                else:
                    fut._finish(self._do_read(key))
            except BaseException as e:  # noqa: BLE001 — surfaced at join
                fut._finish(error=e)
            finally:
                self._depth.release()
                self._queue.task_done()

    def _do_write(self, key: str, host: torch.Tensor):
        path = self._path(key)
        tmp = path + ".tmp"
        crc = 0
        view = _byte_view(host)
        step = self._bounce.buffer_size
        with open(tmp, "wb") as f:
            for off in range(0, max(1, len(view)), step):
                chunk = view[off:off + step]
                if chunk.size == 0:
                    break
                taken = self._bounce.acquire(len(chunk))
                try:
                    buf = bytes(chunk)          # the bounce copy
                    crc = zlib.crc32(buf, crc)
                    f.write(buf)
                finally:
                    self._bounce.release(taken)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        with self._lock:
            self._manifest[key] = {
                "bytes": int(view.nbytes), "crc32": int(crc),
                "shape": list(host.shape), "dtype": dtype_name(host.dtype)}
            self.bytes_written += int(view.nbytes)
            self.write_count += 1

    def _do_read(self, key: str) -> torch.Tensor:
        info = self.chunk_info(key)
        if info is None:
            raise StagingError(f"no staged chunk for key {key!r}")
        path = self._path(key)
        out = torch.empty(info["shape"], dtype=_resolve_dtype(info["dtype"]))
        view = _byte_view(out)
        crc = 0
        step = self._bounce.buffer_size
        try:
            with open(path, "rb") as f:
                off = 0
                while off < len(view) or (len(view) == 0 and off == 0):
                    taken = self._bounce.acquire(min(step, max(1, len(view) - off)))
                    try:
                        buf = f.read(min(step, len(view) - off) or step)
                    finally:
                        self._bounce.release(taken)
                    if not buf:
                        break
                    view[off:off + len(buf)] = np.frombuffer(buf, np.uint8)
                    crc = zlib.crc32(buf, crc)
                    off += len(buf)
        except OSError as e:
            raise StagingError(f"unreadable chunk {path}: {e}") from e
        if off != info["bytes"]:
            raise StagingError(f"short chunk {path}: {off} of "
                               f"{info['bytes']} bytes")
        if crc != info["crc32"]:
            raise StagingError(f"CRC mismatch on chunk {path}: "
                               f"{crc} != {info['crc32']}")
        with self._lock:
            self.bytes_read += int(info["bytes"])
            self.read_count += 1
        return out

    # ---- accounting / lifecycle --------------------------------------- #
    def _account_wait(self, seconds: float, kind: str):
        with self._lock:
            self.wait_s += seconds
            if kind == "read":
                self.read_wait_s += seconds

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"bytes_written": self.bytes_written,
                    "bytes_read": self.bytes_read,
                    "write_count": self.write_count,
                    "read_count": self.read_count,
                    "wait_s": self.wait_s,
                    "read_wait_s": self.read_wait_s,
                    "submit_wait_s": self.submit_wait_s}

    def drain(self):  # may-block: joins every enqueued task
        """Join every enqueued task (writes durable, reads complete)."""
        self._queue.join()

    def close(self):  # may-block: drain + worker join
        with self._lock:
            if self._closed:
                return
            # set before the drain: a submitter racing close() must get the
            # closed error, not enqueue behind the shutdown sentinels
            self._closed = True
        self.drain()
        for _ in self._workers:
            self._queue.put(None)
        for w in self._workers:
            w.join(timeout=5)
