"""NVMe optimizer-state swapper, ZeRO-Infinity (counterpart of
``deepspeed_tpu/runtime/swap_tensor/partitioned_optimizer_swapper.py``).

The optimizer state lives on NVMe between steps.  ``swap_out`` persists a
state tree (the port's ``{"mu": {...}, "nu": {...}, "count": ...}`` or any
tree of tensors) and keeps only its shapes; ``prefetch`` starts the reads,
``swap_in`` joins them.  The single-leaf surface (``leaf_key``,
``prefetch_leaf``, ``swap_in_leaf``, ``swap_out_leaf``) is what a streamed
walk drives: the engine's ZeRO moments on NVMe are pieces of a flat shard,
each a leaf of this swapper (``runtime/zero/partition_parameters.py``).
Leaves that stack blocks on their first axis (a ``blocks`` part not
followed by a block index) are chunked per block, as in JAX.

``pipeline_write`` (off by default, as in JAX, so ``swapped_bytes()`` is
exact right after ``swap_out``) lets the writes drain while the next
forward runs; ``max_in_cpu`` bounds the host LRU (the engine passes 0:
host copies drop once their write is durable).
``PipelinedOptimizerSwapper`` is the same object, as in JAX: the reference's
separate class changes only the schedule, which is the caller's
``prefetch()`` timing.
"""

from typing import Any, Dict, Optional

import torch

from deepspeed_tpu_torch.runtime.swap_tensor.partitioned_param_swapper import (
    AsyncPartitionedParameterSwapper, _rebuild, leaves_with_path)


def _blocks_chunking(key: str) -> bool:
    """A leaf stacking blocks: a ``blocks`` part not followed by an index."""
    parts = key.split("__")
    return any(p == "blocks" and (i + 1 == len(parts) or not parts[i + 1].isdigit())
               for i, p in enumerate(parts))


class PartitionedOptimizerSwapper:

    PREFIX = "opt"

    def __init__(self, swap_folder: str, aio_config: Optional[Dict] = None,
                 max_in_cpu: Optional[int] = None, pipeline_write: bool = False,
                 buffer_count: int = 2):
        self._swapper = AsyncPartitionedParameterSwapper(
            swap_folder, aio_config, buffer_count=buffer_count,
            max_in_cpu=max_in_cpu, chunk_paths=_blocks_chunking)
        self._template = None       # the swapped state's structure, shapes and dtypes
        self._pipeline_write = pipeline_write

    @property
    def aio_config(self) -> Dict:
        return self._swapper.aio_config

    @property
    def swap_folder(self) -> str:
        return self._swapper.swap_folder

    @property
    def pipeline_write(self) -> bool:
        return self._pipeline_write

    @property
    def store(self):
        return self._swapper.store

    @property
    def is_swapped(self) -> bool:
        return self._template is not None

    def swap_out(self, opt_state) -> None:
        """Persist the whole state to CRC'd chunks, keeping only a template
        of meta tensors.  With ``pipeline_write`` the writes drain
        asynchronously (the store's host copies serve reads meanwhile)."""
        self._template = _template(opt_state)
        self._swapper.swap_out_tree(opt_state, prefix=self.PREFIX,
                                    sync=not self._pipeline_write)

    def prefetch(self) -> None:
        """Begin async reads (at forward time, to overlap compute)."""
        if self._template is not None:
            self._swapper.prefetch_tree(self._template, prefix=self.PREFIX)

    def swap_in(self, device=None):
        """The state read back (joins prefetches), on ``device`` if given."""
        assert self._template is not None, "nothing swapped out"
        return self._swapper.swap_in_tree(self._template, device, prefix=self.PREFIX)

    @property
    def template(self):
        """The swapped state's structure as meta tensors (None when resident)."""
        return self._template

    # ---- single-leaf surface (a streamed walk) ------------------------- #
    def leaf_key(self, path) -> str:
        return self._swapper.leaf_key(path, prefix=self.PREFIX)

    def prefetch_leaf(self, key: str, out: Optional[torch.Tensor] = None) -> None:
        self._swapper.prefetch_leaf(key, out=out)

    def swap_in_leaf(self, key: str, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self._swapper.swap_in_leaf(key, out=out)

    def swap_out_leaf(self, key: str, value, sync: bool = False, cache: bool = True):
        return self._swapper.swap_out_leaf(key, value, sync=sync, cache=cache)

    def swapped_bytes(self) -> int:
        return self._swapper.swapped_bytes()

    def stats(self) -> Dict[str, Any]:
        return self._swapper.stats()

    def drain(self) -> None:
        self._swapper.store.drain()

    def invalidate(self) -> None:
        """Rollback coherence: drop the chunks staged from the abandoned
        trajectory; the caller re-persists from the restored state."""
        self._swapper.invalidate()
        self._template = None

    def close(self) -> None:
        self._swapper.close()


def _template(tree):
    """``tree`` with each leaf a meta tensor of its shape and dtype."""
    def meta(leaf):
        t = torch.as_tensor(leaf)
        return torch.empty(t.shape, dtype=t.dtype, device="meta")
    return _rebuild(tree, iter(meta(leaf) for _, leaf in leaves_with_path(tree)))


# the reference's name: its separate class only changes the driving
# schedule, which here is the caller's prefetch() timing
PipelinedOptimizerSwapper = PartitionedOptimizerSwapper
