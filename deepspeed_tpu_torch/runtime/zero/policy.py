"""Which leaves each ZeRO stage partitions, and where each element lives
(counterpart of ``deepspeed_tpu/runtime/zero/policy.py``).

The JAX package places a sharding on every leaf and lets XLA insert the
collectives: a leaf of at least ``param_shard_min_size`` elements is split
over the ``fsdp`` axis, a smaller one stays replicated (the analogue of
``stage3_param_persistence_threshold``, which folds into the same minimum
at stage 3, ``deepspeed_tpu/runtime/engine.py:165-173``).  Optimizer state
is split from stage 1, gradients from stage 2 and parameters at stage 3.

The port keeps that rule and uses PyTorch's idiom for the placement, as the
reference's ``stage_1_and_2.py`` does: contiguous flat fp32 buffers, one
equal padded partition per rank.  The leaves fall into units:

* the ``persistent`` unit: every leaf under the minimum, held whole by
  every rank (its gradient is all-reduced, each rank updates all of it);
* ``top``: the other leaves outside the blocks (embeddings, the head);
* ``blocks.<i>``: the other leaves of block i, the unit a stage-3 step
  gathers inside the block's checkpoint.

A partitioned unit of n elements is padded to ``world * part`` elements,
``part = ceil(n / world)`` rounded up to ``ALIGN`` (so every partition
starts 256-byte aligned); rank r holds elements ``[r * part, (r + 1) *
part)`` of the unit.  Rank r's *shard* is its partitions of the units end
to end, the persistent unit first: the flat space its fp32 master (at
stage 3), gradient and moments live in.  The padding holds zeros, and
neither the norm nor the update reads it (``Unit.valid``).  Partitioning
changes no number, only where it lives.  The layout is pure arithmetic,
the same at world size 1 (one partition of each unit).
"""

import dataclasses
import re
from typing import Dict, List, Sequence, Tuple

ALIGN = 64                      # elements: 256 bytes of fp32
PERSISTENT = "persistent"
TOP = "top"
_BLOCK = re.compile(r"^blocks\.(\d+)\.")


def zero_min_size(zero_config) -> int:
    """The smallest leaf a stage partitions: ``param_shard_min_size``, raised
    at stage 3 to ``stage3_param_persistence_threshold`` when the config
    sets it (the JAX engine's rule)."""
    min_size = int(zero_config.param_shard_min_size)
    if "param_persistence_threshold" in zero_config.model_fields_set and zero_config.stage >= 3:
        min_size = max(min_size, int(zero_config.param_persistence_threshold))
    return min_size


def is_partitioned(numel: int, min_size: int) -> bool:
    """Whether a leaf of ``numel`` elements is split over the ranks (else
    every rank keeps it whole)."""
    return numel >= max(1, min_size)


def unit_of(name: str, numel: int, min_size: int) -> str:
    if not is_partitioned(numel, min_size):
        return PERSISTENT
    m = _BLOCK.match(name)
    return f"blocks.{m.group(1)}" if m else TOP


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass
class Unit:
    """One unit's leaves and its place in the full and shard layouts."""
    name: str
    leaves: List[int]           # indices into the engine's leaf list
    offsets: List[int]          # each leaf's offset in the unit's flat
    sizes: List[int]
    numel: int                  # real elements
    shards: int                 # ranks it is split over (1: persistent)
    part: int                   # elements a rank holds, padding included
    full_offset: int            # offset in the full (all ranks) layout
    shard_offset: int           # offset in a rank's shard
    valid: int                  # this rank's real elements, from its start
    start: int                  # this rank's first element in the unit

    @property
    def full_numel(self) -> int:
        return self.shards * self.part

    def block_index(self) -> int:
        return int(self.name.split(".")[1]) if self.name.startswith("blocks.") else -1


class ZeroLayout:
    """The units of a model's leaves (``names`` and ``sizes`` in the
    engine's order) for ``world`` ranks, seen from ``rank``."""

    def __init__(self, names: Sequence[str], sizes: Sequence[int], world: int, rank: int,
                 min_size: int):
        self.world, self.rank, self.min_size = int(world), int(rank), int(min_size)
        self.names, self.sizes = list(names), [int(s) for s in sizes]
        groups: Dict[str, List[int]] = {}
        for i, (name, n) in enumerate(zip(self.names, self.sizes)):
            groups.setdefault(unit_of(name, n, self.min_size), []).append(i)
        order = ([PERSISTENT] if PERSISTENT in groups else []) + [
            k for k in groups if k != PERSISTENT]
        self.units: List[Unit] = []
        full_off = shard_off = 0
        for key in order:
            idx = groups[key]
            sizes_u = [self.sizes[i] for i in idx]
            offsets = [sum(sizes_u[:j]) for j in range(len(idx))]
            n = sum(sizes_u)
            shards = 1 if key == PERSISTENT else self.world
            part = _round_up(-(-n // shards), ALIGN)
            start = 0 if shards == 1 else self.rank * part
            valid = max(0, min(part, n - start))
            self.units.append(Unit(key, idx, offsets, sizes_u, n, shards, part, full_off,
                                   shard_off, valid, start))
            full_off += shards * part
            shard_off += part
        self.full_numel = full_off
        self.shard_numel = shard_off
        self.numel = sum(self.sizes)

    def leaf_locations(self) -> List[Tuple[int, int]]:
        """(unit index, offset in the unit) of each leaf, in the leaf order."""
        loc = [(0, 0)] * len(self.names)
        for k, u in enumerate(self.units):
            for i, off in zip(u.leaves, u.offsets):
                loc[i] = (k, off)
        return loc

    def describe(self) -> str:
        parted = [u for u in self.units if u.shards > 1 or u.name != PERSISTENT]
        return (f"ZeroLayout(world={self.world}, min_size={self.min_size}, units="
                f"{len(self.units)} ({len(parted)} partitioned), elements={self.numel:,}, "
                f"shard={self.shard_numel:,})")
