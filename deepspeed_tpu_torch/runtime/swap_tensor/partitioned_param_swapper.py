"""NVMe parameter swapper (counterpart of
``deepspeed_tpu/runtime/swap_tensor/partitioned_param_swapper.py``).

A tree adapter over the tiered offload store
(:mod:`deepspeed_tpu_torch.runtime.offload`): each leaf becomes one CRC'd
chunk, with a host LRU bounded by ``max_in_cpu`` bytes.  A tree is the
port's (nested dicts, ``blocks`` a list of per-block dicts) or a dict of
leaves by the port's dotted names; both key a leaf by its path joined with
``__`` under a prefix (``blocks.3.qkv_w`` -> ``param__blocks__3__qkv_w``),
so every block's leaves are chunks of their own: per-block chunking.  A
leaf that ``chunk_paths`` selects and that stacks blocks on its first axis
(the JAX package's layout) is chunked along that axis as JAX's swapper
does, under JAX's keys (``<key>__blk<i>``).  The chunk files and the
manifest are the JAX package's, so each package reads the other's chunks.

``prefetch_tree`` / ``prefetch_leaf`` issue the async reads of a window;
``swap_in_tree`` / ``swap_in_leaf`` join them (a read that landed first is
a prefetch-ring hit, the rest misses whose blocking time is the stall).
``invalidate`` and ``remove`` drop the host and pending copies with the
chunks, so a dropped leaf cannot come back from the cache.

``check_swap_folder`` is the engine's refusal of a swap path that cannot
hold the tier: unwritable, on ``tmpfs`` / ``ramfs`` (host memory, not a
disk) or with less room than the tier's bytes.  Nothing falls back to
another tier.
"""

import os
import shutil
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch.runtime.offload.staging import StagingFuture, StagingPool, as_host_tensor
from deepspeed_tpu_torch.runtime.offload.store import TieredStore
from deepspeed_tpu_torch.runtime.swap_tensor.aio_config import get_aio_config


MEMORY_FILESYSTEMS = ("tmpfs", "ramfs")


class SwapPathError(RuntimeError):
    """A swap path that cannot hold the NVMe tier."""


def filesystem_type(path: str) -> str:
    """The type of the filesystem holding ``path``: the mount in
    ``/proc/mounts`` with the longest mount point above it."""
    real = os.path.realpath(path)
    best, fs = "", "unknown"
    with open("/proc/mounts") as f:
        for line in f:
            fields = line.split()
            if len(fields) < 3:
                continue
            mnt = fields[1].replace("\\040", " ")
            inside = real == mnt or real.startswith(mnt.rstrip("/") + "/")
            if inside and len(mnt) >= len(best):
                best, fs = mnt, fields[2]
    return fs


def check_swap_folder(folder: str, need_bytes: int) -> str:
    """Make ``folder`` and raise ``SwapPathError`` unless it is writable,
    on no in-memory filesystem, and has ``need_bytes`` free (chunk files it
    already holds count as room: they are overwritten).  Its filesystem
    type."""
    try:
        os.makedirs(folder, exist_ok=True)
    except OSError as e:
        raise SwapPathError(f"swap path {folder!r} cannot be made: {e}") from e
    if not os.access(folder, os.W_OK | os.X_OK):
        raise SwapPathError(f"swap path {folder!r} is not writable")
    fs = filesystem_type(folder)
    if fs in MEMORY_FILESYSTEMS:
        raise SwapPathError(f"swap path {folder!r} is on {fs}, which is host memory: give "
                            "nvme_path a directory on a disk")
    held = sum(e.stat().st_size for e in os.scandir(folder)
               if e.is_file() and e.name.endswith(".chunk"))
    free = shutil.disk_usage(folder).free
    if free + held < need_bytes:
        raise SwapPathError(f"swap path {folder!r} has {free + held:,} bytes of room, the "
                            f"tier needs {need_bytes:,}")
    return fs


def path_parts(name) -> Tuple[str, ...]:
    """A leaf's path as parts: a dotted name is split on its dots."""
    if isinstance(name, str):
        return tuple(name.split("."))
    return tuple(str(p) for p in name)


def _leaf_key(path: Sequence) -> str:
    return "__".join(str(p) for p in path) or "leaf"


def leaves_with_path(tree, prefix: Tuple = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) of every leaf of ``tree`` in order: dict keys (a dotted
    key split), list indices."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_path(v, prefix + path_parts(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _rebuild(tree, values: Iterator):
    """``tree``'s structure with its leaves replaced, in order, by ``values``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, values) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values) for v in tree)
    return next(values)


class AsyncPartitionedParameterSwapper:

    def __init__(self, swap_folder: str, aio_config: Optional[Dict] = None,
                 buffer_count: int = 2, max_in_cpu: Optional[int] = None,
                 chunk_paths: Optional[Callable[[str], bool]] = None):
        cfg = get_aio_config({"aio": aio_config or {}})
        self.aio_config = cfg
        self.swap_folder = swap_folder
        self.pool = StagingPool(swap_folder, buffer_count=buffer_count,
                                buffer_size=cfg["block_size"], queue_depth=cfg["queue_depth"],
                                thread_count=cfg["thread_count"])
        self.store = TieredStore(self.pool, max_in_cpu=max_in_cpu)
        # key -> (shape, dtype, n_chunks); n_chunks == 0 means one chunk
        self._meta: Dict[str, Any] = {}
        self._chunk_paths = chunk_paths

    def _chunked(self, key: str, host_shape) -> int:
        """Chunks along axis 0 for this leaf (0: one chunk)."""
        if (self._chunk_paths is not None and self._chunk_paths(key)
                and len(host_shape) >= 1 and host_shape[0] > 1):
            return int(host_shape[0])
        return 0

    @staticmethod
    def _chunk_key(key: str, i: int) -> str:
        return f"{key}__blk{i}"

    def _keys_of(self, key: str) -> List[str]:
        n_chunks = self._meta[key][2]
        return [self._chunk_key(key, i) for i in range(n_chunks)] if n_chunks else [key]

    # ---- whole-tree surface ------------------------------------------- #
    def swap_out_tree(self, tree, prefix: str = "p", sync: bool = True,
                      cache: bool = True) -> None:
        """Write every leaf (async) through the tiered store, recording its
        shape and dtype; with ``sync`` the writes are joined before this
        returns.  The writers read each host leaf as given until its write
        lands, so the caller must not write into it meanwhile; ``cache`` as
        in ``swap_out_leaf``."""
        for path, leaf in leaves_with_path(tree):
            self.swap_out_leaf(self.leaf_key(path, prefix), leaf, cache=cache)
        if sync:
            self.store.drain()

    def _tree_keys(self, tree_def_like, prefix: str) -> Iterator[str]:
        for path, _ in leaves_with_path(tree_def_like):
            yield from self._keys_of(self.leaf_key(path, prefix))

    def prefetch_tree(self, tree_def_like, prefix: str = "p") -> None:
        """Start async reads of every chunk (the prefetch ring's host <-
        NVMe half: call it while compute overlaps)."""
        self.store.prefetch(list(self._tree_keys(tree_def_like, prefix)))

    def swap_in_tree(self, tree_def_like, device=None, prefix: str = "p"):
        """Every leaf read back (joining prefetches), in ``tree_def_like``'s
        structure; on ``device`` when given."""
        values = []
        for path, _ in leaves_with_path(tree_def_like):
            t = self.swap_in_leaf(self.leaf_key(path, prefix))
            values.append(t.to(device) if device is not None else t)
        return _rebuild(tree_def_like, iter(values))

    # ---- single-leaf surface ------------------------------------------- #
    def leaf_key(self, path, prefix: str = "p") -> str:
        """The swap key ``swap_out_tree`` uses for this leaf path (a dotted
        name or a sequence of parts)."""
        return f"{prefix}__{_leaf_key(path_parts(path))}"

    def prefetch_leaf(self, key: str, out: Optional[torch.Tensor] = None) -> None:
        """Async read of one leaf's chunks (none for an unknown key); a
        leaf of one chunk may be read into ``out``, a host buffer of the
        caller's (see ``TieredStore.prefetch``)."""
        if key in self._meta:
            into = {key: out} if out is not None and not self._meta[key][2] else None
            self.store.prefetch(self._keys_of(key), into=into)

    def swap_in_leaf(self, key: str, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One leaf back as a host tensor (joins its prefetches); a leaf
        of one chunk that is not in the host LRU is read into ``out`` when
        given."""
        shape, dtype, n_chunks = self._meta[key]
        if n_chunks:
            return torch.stack([self.store.get(k) for k in self._keys_of(key)]).reshape(shape)
        return self.store.get(key, out=out)

    def swap_out_leaf(self, key: str, value, sync: bool = False,
                      cache: bool = True) -> List[StagingFuture]:
        """Write one leaf (async unless ``sync``); the futures of its
        writes.  With ``cache`` the host LRU keeps ``value`` until its write
        lands (JAX's write-through); without, ``value`` goes to the writer
        alone and the caller may write into it again once the futures are
        done (a reused bounce buffer)."""
        host = as_host_tensor(value)
        n_chunks = self._chunked(key, tuple(host.shape))
        self._meta[key] = (tuple(host.shape), host.dtype, n_chunks)
        put = self.store.put if cache else self.store.put_uncached
        futs = [put(k, host[i] if n_chunks else host)
                for i, k in enumerate(self._keys_of(key))]
        if sync:
            self.store.drain()
        return futs

    def swapped_bytes(self) -> int:
        return self.pool.snapshot()["bytes_written"]

    def stats(self) -> Dict[str, Any]:
        return self.store.stats()

    def invalidate(self):
        """Drop every staged chunk and host copy (rollback coherence)."""
        self.store.invalidate()
        self._meta.clear()

    def remove(self, prefix: str = "p"):
        """Delete every copy under ``prefix``: NVMe chunks and host-LRU and
        pending entries, so a later read cannot bring a removed leaf back
        from the cache."""
        for key in [k for k in self._meta if k.startswith(prefix + "__")]:
            keys = self._keys_of(key)
            del self._meta[key]
            for k in keys:
                self.store.remove(k)

    def close(self) -> None:
        """Join pending writes and stop the pool's workers."""
        self.store.drain()
        self.pool.close()
