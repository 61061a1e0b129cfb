"""Partitioned parameters, host offload and the stage-3 gather (counterpart
of ``deepspeed_tpu/runtime/zero/partition_parameters.py``).

The JAX module builds each leaf straight into its shard (``Init``), re-homes
shardings to ``pinned_host`` memory for offload (``offload_shardings``) and
reassembles full leaves for user code (``GatheredParameters``); XLA gathers
a stage-3 leaf at its use.  The port holds the same state in the flat
layout of ``runtime/zero/policy.py`` and moves it itself:

* ``FlatStore``: one rank's flat fp32 state (master, moments) on the device,
  or with offload in host memory, in pieces of a fixed size (the pieces are
  the optimizer's chunks).  On a CUDA engine the host pieces are plain CPU
  tensors whose pages CUDA pins (``cudaHostRegister``): asynchronous
  copies, which a captured step holds as graph nodes, and no power-of-two
  rounding of PyTorch's caching host allocator, so the pinned bytes held
  are the bytes asked for.
* ``NvmeFlatStore``: the same flat state with each piece a CRC'd chunk
  file of ZeRO-Infinity's optimizer swapper (``runtime/swap_tensor/``);
  the optimizer walks it piece by piece after the captured step, and the
  checkpoint gather and scatter stream it piece by piece.  ``FlatLeaves``
  is stage 0's flat layout, for a stage-0 engine whose moments live there.
* ``PartitionedParameters``: the engine's ZeRO state.  At stages 1-2 the
  model's leaves are views of one full fp32 buffer and a rank's master is
  its partitions of it; the gradients of a micro-step (stage 2) or of the
  step (stage 1) are reduce-scattered into the rank's fp32 gradient shard,
  and after the update the partitions are all-gathered back.  At stage 3
  the model keeps no weights: the master lives in a shard of its own (on
  the host with ``offload_param``), and ``compute_tree`` hands the model
  its leaves through ``gather``, a ``torch.autograd.Function`` whose
  forward stages the unit's partition onto the device, casts it to the
  compute dtype and all-gathers it, and whose backward reduce-scatters the
  unit's full gradient into the rank's gradient shard.  A block's gather
  runs inside the block's checkpoint, so remat's recompute gathers again
  and nothing of a gathered block outlives its use.
* ``Init``: inside it an engine partitions its parameters as at stage 3
  whatever its stage, as the JAX engine does.
* ``GatheredParameters(engine, modifier_rank=None)``: the full fp32 leaves
  by name, on the host; at stage 3 the model holds them on the device for
  the duration.  With ``modifier_rank`` the holder's leaves are written
  back into the partitions on exit.
"""

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.runtime.zero.policy import PERSISTENT, TOP, ZeroLayout

_INIT_CTX = {"active": False}


def init_ctx_active() -> bool:
    return _INIT_CTX["active"]


@contextlib.contextmanager
def Init(enabled: bool = True, **_compat_kwargs):
    """``with zero.Init(): engine = initialize(...)`` partitions the
    parameters as stage 3 does, whatever the config's stage (the keyword
    arguments of the reference's signature are accepted and unused)."""
    prev = _INIT_CTX["active"]
    _INIT_CTX["active"] = bool(enabled) or prev
    try:
        yield
    finally:
        _INIT_CTX["active"] = prev


# --------------------------------------------------------------------------- #
# Flat state on the device or in host memory
# --------------------------------------------------------------------------- #
def _pin(t: torch.Tensor) -> None:
    rt = torch.cuda.cudart()
    err = rt.cudaHostRegister(t.data_ptr(), t.numel() * t.element_size(), 0)
    if int(getattr(err, "value", err)) != 0:
        raise RuntimeError(f"cudaHostRegister of {t.numel() * t.element_size()} bytes "
                           f"failed: {err}")


def _unpin(t: torch.Tensor) -> None:
    torch.cuda.cudart().cudaHostUnregister(t.data_ptr())


class FlatStore:
    """``numel`` fp32 elements, zeroed: one tensor on ``device``, or with
    ``host`` pieces of ``piece`` elements in host memory (pinned by
    ``cudaHostRegister`` when ``device`` is CUDA)."""

    def __init__(self, numel: int, device: torch.device, host: bool = False,
                 piece: Optional[int] = None):
        self.numel, self.device, self.host = int(numel), torch.device(device), bool(host)
        self.pinned = self.host and self.device.type == "cuda"
        self.piece = int(piece) if host and piece else max(1, self.numel)
        if not self.host:
            self.pieces = [torch.zeros(self.numel, dtype=torch.float32, device=self.device)]
            return
        self.pieces = [torch.zeros(min(self.piece, self.numel - s), dtype=torch.float32)
                       for s in range(0, self.numel, self.piece)]
        if self.pinned:
            for t in self.pieces:
                _pin(t)

    @property
    def nbytes(self) -> int:
        return 4 * self.numel

    def pinned_bytes(self) -> int:
        return self.nbytes if self.pinned else 0

    def flat(self) -> torch.Tensor:
        """The one device tensor (a device store only)."""
        if self.host:
            raise RuntimeError("a host store has no single device tensor")
        return self.pieces[0]

    def views(self, start: int, length: int) -> List[Tuple[int, torch.Tensor]]:
        """(offset in the range, view) pairs covering ``[start, start +
        length)``, one per piece it crosses."""
        out, pos, end = [], int(start), int(start) + int(length)
        while pos < end:
            k, off = divmod(pos, self.piece)
            n = min(end, (k + 1) * self.piece) - pos
            out.append((pos - start, self.pieces[k][off:off + n]))
            pos += n
        return out

    def read_into(self, dst: torch.Tensor, start: int) -> torch.Tensor:
        """Copy ``dst.numel()`` elements from ``start`` into ``dst``."""
        for off, v in self.views(start, dst.numel()):
            dst[off:off + v.numel()].copy_(v, non_blocking=True)
        return dst

    def write(self, start: int, src: torch.Tensor) -> None:
        for off, v in self.views(start, src.numel()):
            v.copy_(src[off:off + v.numel()], non_blocking=self.pinned)

    # ---- the optimizer's walk, one piece at a time ---------------------- #
    nvme = False

    def load_piece(self, k: int, dst: torch.Tensor) -> None:
        """Copy piece ``k`` into ``dst`` (a device buffer) on the stream."""
        dst.copy_(self.pieces[k], non_blocking=True)

    def save_piece(self, k: int, src: torch.Tensor) -> None:
        """Copy ``src`` (a device buffer) back into piece ``k`` on the stream."""
        self.pieces[k].copy_(src, non_blocking=True)

    def close(self) -> None:
        if self.pinned:
            for t in self.pieces:
                _unpin(t)
            self.pinned = False


class _StoreRange:
    """``[start, start + n)`` of an NVMe store, as the destination of a
    checkpoint's ``(dst, src)`` copy: ``copy_`` writes through the store."""

    def __init__(self, store: "NvmeFlatStore", start: int, n: int):
        self.store, self.start, self.n = store, int(start), int(n)

    def numel(self) -> int:
        return self.n

    def copy_(self, src, non_blocking: bool = False) -> "_StoreRange":
        self.store.write(self.start, torch.as_tensor(src).reshape(-1))
        return self


class NvmeFlatStore(FlatStore):
    """``numel`` fp32 elements on NVMe (ZeRO-Infinity's optimizer tier):
    piece ``k`` is the leaf ``<name>__piece<k>`` of ``swapper`` (a
    ``PartitionedOptimizerSwapper``), a CRC'd chunk file; all pieces are
    written as zeros at construction and drained (the initial persist).

    The host side is ``slots`` buffers of one piece (registered with CUDA
    as ``FlatStore``'s pieces are, on a CUDA engine) plus the swapper's host
    LRU, bounded by its ``max_in_cpu``.  The walk (``runtime/optimizers.py``)
    drives ``prefetch_piece`` / ``load_piece`` / ``save_piece`` /
    ``write_saved`` / ``end_walk``: a piece's prefetch takes the next slot
    and reads the chunk into it; ``load_piece`` joins that read and copies
    the slot to the device; after the update ``save_piece`` copies the
    device buffer back into the same slot on the stream, and once the
    caller's event says that copy has landed, ``write_saved`` hands the
    slot to a staging writer (with a host LRU, ``cache``, the LRU gets a
    copy of its own).  A slot is taken again only after its write is done,
    so a slot never goes to a writer, or is refilled, while a copy or a
    write still uses it.

    ``read_into`` / ``write`` / ``views`` stream piece by piece for the
    checkpoint gather and scatter, holding one piece more on the host: a
    read keeps the last piece read, a write patches one open piece (read,
    patched, written back by the next piece's write or by ``flush``).  Any
    failed read or write raises."""

    nvme = True

    def __init__(self, numel: int, device: torch.device, piece: int, swapper, name: str,
                 slots: int = 3):
        self.numel, self.device, self.host = int(numel), torch.device(device), True
        self.piece = max(1, min(int(piece), self.numel))
        self.swapper, self.name = swapper, name
        self.pinned = self.device.type == "cuda"
        self.lengths = [min(self.piece, self.numel - s) for s in range(0, self.numel, self.piece)]
        self.keys = [swapper.leaf_key((name, f"piece{k}")) for k in range(len(self.lengths))]
        self.cache = swapper.store.max_in_cpu != 0
        self.slots = [torch.empty(self.lengths[0], dtype=torch.float32)
                      for _ in range(max(2, int(slots)))]
        if self.pinned:
            for t in self.slots:
                _pin(t)
        self._writes: List[list] = [[] for _ in self.slots]   # a slot's pending writes
        self._turn = 0
        self._slot_of: Dict[int, int] = {}     # piece -> the slot it was read into
        self._unloaded = set()       # pieces prefetched into a slot, not loaded yet
        self._saved = []             # pieces copied back, not yet handed to a writer
        self._read = None            # (piece, host tensor): the last piece read
        self._open = None            # (piece, host tensor): the piece being patched
        zeros = torch.zeros(self.lengths[0], dtype=torch.float32)
        for key, n in zip(self.keys, self.lengths):
            swapper.swap_out_leaf(key, zeros[:n], cache=False)
        swapper.drain()

    @property
    def pieces(self):
        raise RuntimeError("an NVMe store keeps its pieces on disk; use load_piece / read_into")

    def pinned_bytes(self) -> int:
        return sum(4 * t.numel() for t in self.slots) if self.pinned else 0

    def flat(self) -> torch.Tensor:
        raise RuntimeError("an NVMe store has no single device tensor")

    # ---- the walk ----------------------------------------------------- #
    def _view(self, k: int) -> torch.Tensor:
        return self.slots[self._slot_of[k]][:self.lengths[k]]

    def _take_slot(self) -> int:
        """The next slot, once its write is done (raising its failure) and
        a prefetch left in it is joined."""
        b, self._turn = self._turn, (self._turn + 1) % len(self.slots)
        for fut in self._writes[b]:
            fut.result()
        self._writes[b] = []
        for k in [k for k, s in self._slot_of.items() if s == b]:
            if k in self._unloaded:
                self.swapper.swap_in_leaf(self.keys[k], out=self._view(k))
                self._unloaded.discard(k)
            del self._slot_of[k]
        return b

    def prefetch_piece(self, k: int) -> None:
        """Start reading piece ``k`` into a slot (once a walk)."""
        if k in self._slot_of:
            return
        self._slot_of[k] = self._take_slot()
        self._unloaded.add(k)
        self.swapper.prefetch_leaf(self.keys[k], out=self._view(k))

    def load_piece(self, k: int, dst: torch.Tensor) -> None:
        self.prefetch_piece(k)
        host = self.swapper.swap_in_leaf(self.keys[k], out=self._view(k))
        self._unloaded.discard(k)
        dst.copy_(self._checked(k, host), non_blocking=True)

    def save_piece(self, k: int, src: torch.Tensor) -> None:
        """Copy ``src`` into piece ``k``'s slot on the stream, behind the
        copy out of it; ``write_saved`` hands the slot to a writer once the
        caller has waited for the copy."""
        self._view(k).copy_(src, non_blocking=True)
        self._saved.append(k)

    def write_saved(self) -> None:
        """Hand the slots of ``save_piece`` to the staging writers (the
        caller has waited for their copies)."""
        for k in self._saved:
            if self._read is not None and self._read[0] == k:
                self._read = None
            view = self._view(k)
            self._writes[self._slot_of[k]] = self.swapper.swap_out_leaf(
                self.keys[k], view.clone() if self.cache else view, cache=self.cache)
        self._saved = []

    def end_walk(self) -> None:
        """After a walk: its slots stay taken until their writes are done;
        the writes are joined here unless they drain in the background
        (``pipeline_write``)."""
        self._slot_of = {k: b for k, b in self._slot_of.items() if k in self._unloaded}
        if not self.swapper.pipeline_write:
            self.swapper.drain()

    def _checked(self, k: int, host: torch.Tensor) -> torch.Tensor:
        if tuple(host.shape) != (self.lengths[k],) or host.dtype != torch.float32:
            raise RuntimeError(f"NVMe piece {self.keys[k]}: staged {tuple(host.shape)} "
                               f"{host.dtype}, expected ({self.lengths[k]},) float32")
        return host

    def _host_piece(self, k: int) -> torch.Tensor:
        """Piece ``k`` as a host tensor of its own (kept as the last read)."""
        if self._read is not None and self._read[0] == k:
            return self._read[1]
        host = self._checked(k, self.swapper.swap_in_leaf(self.keys[k]))
        if any(host.data_ptr() == t.data_ptr() for t in self.slots):
            # a prefetch had read it into a slot, which the walk reuses
            host = host.clone()
            self._unloaded.discard(k)
        self._read = (k, host)
        return host

    # ---- checkpoint gather and scatter -------------------------------- #
    def _spans(self, start: int, length: int):
        pos, end = int(start), int(start) + int(length)
        while pos < end:
            k, off = divmod(pos, self.piece)
            n = min(end, (k + 1) * self.piece) - pos
            yield pos - start, k, off, n
            pos += n

    def views(self, start: int, length: int):
        return [(o, _StoreRange(self, start + o, n)) for o, _, _, n in self._spans(start, length)]

    def read_into(self, dst: torch.Tensor, start: int) -> torch.Tensor:
        self.flush()
        for o, k, off, n in self._spans(start, dst.numel()):
            dst[o:o + n].copy_(self._host_piece(k)[off:off + n])
        return dst

    def write(self, start: int, src: torch.Tensor) -> None:
        for o, k, off, n in self._spans(start, src.numel()):
            if self._open is None or self._open[0] != k:
                self.flush()
                self._open = (k, self._host_piece(k).clone())
            self._open[1][off:off + n].copy_(src[o:o + n])

    def flush(self) -> None:
        """Write the piece ``write`` patched back to the chunk tier."""
        if self._open is not None:
            k, host = self._open
            self._open = None
            self._read = None
            self.swapper.swap_out_leaf(self.keys[k], host, cache=self.cache)

    def close(self) -> None:
        self.flush()
        self.swapper.drain()
        if self.pinned:
            for t in self.slots:
                _unpin(t)
            self.pinned = False


class FlatLeaves:
    """Stage 0's leaves end to end, in order: the layout its optimizer
    walks when the moments live on NVMe (the gradients are already one
    flat buffer in this order).  The gather and scatter of ``ZeroAdam``'s
    checkpoint state, with no collective."""

    def __init__(self, names: Sequence[str], shapes: Sequence[Tuple[int, ...]]):
        self.names, self.shapes = list(names), [tuple(s) for s in shapes]
        self.sizes = [int(torch.Size(s).numel()) for s in self.shapes]
        self.offsets = [sum(self.sizes[:i]) for i in range(len(self.sizes))]

    def segments(self, leaves: Sequence[torch.Tensor]):
        """``(offset, length, flat view)`` of each leaf."""
        return [(o, n, p.detach().view(-1)) for o, n, p in zip(self.offsets, self.sizes, leaves)]

    def full_named(self, store: FlatStore) -> Dict[str, torch.Tensor]:
        return {name: store.read_into(torch.empty(n, dtype=torch.float32), o).view(shape)
                for name, shape, o, n in zip(self.names, self.shapes, self.offsets, self.sizes)}

    def shard_copies(self, named: Dict[str, torch.Tensor], store: FlatStore):
        copies = []
        for name, o, n in zip(self.names, self.offsets, self.sizes):
            src = torch.as_tensor(named[name]).reshape(-1)
            for off, v in store.views(o, n):
                copies.append((v, src[off:off + v.numel()]))
        return copies


def _nest(flat: Dict[str, torch.Tensor]) -> Dict:
    tree: Dict = {}
    for name, t in flat.items():
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def n_blocks(names: Sequence[str]) -> int:
    return 1 + max([int(n.split(".")[1]) for n in names if n.startswith("blocks.")],
                   default=-1)


def named_tree(named: Dict[str, torch.Tensor]) -> Dict:
    """The model's parameter tree (``param_tree()``'s layout: nested dicts,
    ``blocks`` a list) of leaves given by name."""
    tree = _nest({n: t for n, t in named.items() if not n.startswith("blocks.")})
    blocks = n_blocks(list(named))
    if blocks:
        tree["blocks"] = [_nest({n[len(f"blocks.{i}."):]: t for n, t in named.items()
                                 if n.startswith(f"blocks.{i}.")}) for i in range(blocks)]
    return tree


# --------------------------------------------------------------------------- #
# The stage-3 gather
# --------------------------------------------------------------------------- #
class _GatherUnit(torch.autograd.Function):
    """Forward: unit ``k``'s leaves in the compute dtype, gathered from
    every rank's partition.  Backward: their gradients reduce-scattered
    into the rank's fp32 gradient shard (added, over the micro-steps).
    ``anchor`` is an empty tensor that requires grad, so autograd calls the
    backward; it gets no gradient."""

    @staticmethod
    def forward(ctx, anchor, owner, k):
        ctx.owner, ctx.k = owner, k
        return tuple(owner.gather_unit(k))

    @staticmethod
    def backward(ctx, *grads):
        ctx.owner.reduce_unit(ctx.k, grads)
        return None, None, None


class _BlockLeaves:
    """Block ``i``'s parameter tree, gathered when called (inside the
    block's checkpoint, so remat's recompute calls it again)."""

    def __init__(self, owner: "PartitionedParameters", unit: Optional[int],
                 persistent: Dict[str, torch.Tensor], prefix: str):
        self.owner, self.unit, self.persistent, self.prefix = owner, unit, persistent, prefix

    def __call__(self) -> Dict:
        flat = dict(self.persistent)
        if self.unit is not None:
            flat.update(self.owner.gathered(self.unit))
        return _nest({k[len(self.prefix):]: v for k, v in flat.items()})


class PartitionedParameters:
    """One rank's ZeRO state over the model's leaves (``names``, ``leaves``:
    full fp32 tensors on ``device``, which the caller drops after this
    returns at stage 3).

    ``stage`` 1-2: ``param_flat`` (full layout, every rank) holds the
    leaves, ``grad_flat`` their gradients, ``master_view`` a rank's
    partitions of them.  Stage 3: ``master`` is the rank's fp32 shard, on
    the host with ``offload_param``.  Every stage: ``grad_shard``, the
    rank's fp32 gradient shard on the device."""

    def __init__(self, names: Sequence[str], leaves: Sequence[torch.Tensor], stage: int,
                 layout: ZeroLayout, device: torch.device, compute_dtype: torch.dtype,
                 offload_param: bool = False, piece: Optional[int] = None):
        self.names = list(names)
        self.shapes = [tuple(t.shape) for t in leaves]
        self.stage, self.layout, self.device = stage, layout, torch.device(device)
        self.compute_dtype = compute_dtype
        self.world, self.rank = layout.world, layout.rank
        self._loc = layout.leaf_locations()
        self.grad_shard = torch.zeros(layout.shard_numel, dtype=torch.float32,
                                      device=self.device)
        self.master: Optional[FlatStore] = None
        self.param_flat = self.grad_flat = None
        if stage >= 3:
            self.master = FlatStore(layout.shard_numel, self.device, host=offload_param,
                                    piece=piece)
            for u in layout.units:
                if u.valid:
                    flat = torch.cat([leaves[i].detach().reshape(-1).float() for i in u.leaves])
                    self.master.write(u.shard_offset, flat[u.start:u.start + u.valid])
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._anchor = torch.empty(0, device=self.device, requires_grad=True)
        else:
            self.param_flat = torch.zeros(layout.full_numel, dtype=torch.float32,
                                          device=self.device)
            self.grad_flat = torch.zeros_like(self.param_flat)
            for i, t in enumerate(leaves):
                self.full_view(self.param_flat, i).copy_(t.detach().reshape(-1))

    # ---- layout helpers ------------------------------------------------ #
    def full_view(self, flat: torch.Tensor, i: int) -> torch.Tensor:
        """Leaf ``i`` of a full-layout flat buffer (flat)."""
        k, off = self._loc[i]
        start = self.layout.units[k].full_offset + off
        return flat[start:start + self.layout.sizes[i]]

    def model_leaves(self) -> List[torch.Tensor]:
        """Stages 1-2: the model's leaves, views of ``param_flat``."""
        return [self.full_view(self.param_flat, i).view(s) for i, s in enumerate(self.shapes)]

    def grad_views(self) -> List[torch.Tensor]:
        return [self.full_view(self.grad_flat, i).view(s) for i, s in enumerate(self.shapes)]

    def master_segments(self) -> List[Tuple[int, int, Optional[torch.Tensor]]]:
        """``(shard offset, length, device view or None)`` of each range of
        real elements in the rank's shard: the view is the master's where
        it lives on the device, None where it lives on the host."""
        segs = []
        for u in self.layout.units:
            if not u.valid:
                continue
            if self.stage < 3:
                v = self.param_flat[u.full_offset + u.start:u.full_offset + u.start + u.valid]
            elif not self.master.host:
                v = self.master.flat()[u.shard_offset:u.shard_offset + u.valid]
            else:
                v = None
            segs.append((u.shard_offset, u.valid, v))
        return segs

    # ---- gradients ------------------------------------------------------- #
    def reduce_grads(self) -> None:
        """Stages 1-2: ``grad_flat`` reduced over the ranks and this rank's
        partitions of it added into ``grad_shard``."""
        for u in self.layout.units:
            full = self.grad_flat[u.full_offset:u.full_offset + u.full_numel]
            self._reduce_into_shard(u, full)

    def _reduce_into_shard(self, u, full: torch.Tensor) -> None:
        dst = self.grad_shard[u.shard_offset:u.shard_offset + u.part]
        if u.name == PERSISTENT:
            if self.world > 1:
                comm.all_reduce(full)
            dst[:u.numel].add_(full[:u.numel])
        else:
            out = torch.empty(u.part, dtype=torch.float32, device=self.device)
            comm.reduce_scatter(out, full)
            dst.add_(out)

    def gather_params(self) -> None:
        """Stages 1-2: every rank's updated partitions all-gathered back
        into ``param_flat`` (in place)."""
        for u in self.layout.units:
            if u.name == PERSISTENT:
                continue
            full = self.param_flat[u.full_offset:u.full_offset + u.full_numel]
            comm.all_gather(full, full[u.start:u.start + u.part])

    def sq_norm(self) -> torch.Tensor:
        """The squared global norm of the raw gradient (summed over the
        ranks; the persistent unit, whole on every rank, counted once), fp64
        on the CPU, fp32 on the card."""
        g = self.grad_shard
        dt = torch.float64 if g.device.type == "cpu" else torch.float32
        n_pers = sum(u.part for u in self.layout.units if u.name == PERSISTENT)
        part = torch.linalg.vector_norm(g[n_pers:], dtype=dt).square()
        if self.world > 1:
            comm.all_reduce(part)
        if n_pers:
            part = part + torch.linalg.vector_norm(g[:n_pers], dtype=dt).square()
        return part

    # ---- stage 3 --------------------------------------------------------- #
    def _master_range(self, u) -> torch.Tensor:
        """Unit ``u``'s partition of the master on the device (staged from
        the host with ``offload_param``)."""
        if not self.master.host:
            return self.master.flat()[u.shard_offset:u.shard_offset + u.part]
        dst = torch.empty(u.part, dtype=torch.float32, device=self.device)
        return self.master.read_into(dst, u.shard_offset)

    def gather_unit(self, k: int) -> List[torch.Tensor]:
        u = self.layout.units[k]
        src = self._master_range(u)
        dt = self.compute_dtype
        if u.name == PERSISTENT:
            full = src[:u.numel].to(dt, copy=True)
        else:
            full = torch.empty(u.full_numel, dtype=dt, device=self.device)
            comm.all_gather(full, src.to(dt))
        return [full[o:o + n].view(self.shapes[i])
                for i, o, n in zip(u.leaves, u.offsets, u.sizes)]

    def reduce_unit(self, k: int, grads: Sequence[Optional[torch.Tensor]]) -> None:
        u = self.layout.units[k]
        parts = [g.reshape(-1) if g is not None else
                 torch.zeros(n, dtype=torch.float32, device=self.device)
                 for g, n in zip(grads, u.sizes)]
        if u.full_numel > u.numel:
            parts.append(torch.zeros(u.full_numel - u.numel, dtype=torch.float32,
                                     device=self.device))
        self._reduce_into_shard(u, torch.cat(parts).float())

    def gathered(self, k: int) -> Dict[str, torch.Tensor]:
        u = self.layout.units[k]
        leaves = _GatherUnit.apply(self._anchor, self, k)
        return {self.names[i]: t for i, t in zip(u.leaves, leaves)}

    def compute_tree(self) -> Dict:
        """Stage 3: the tree the model takes.  The persistent and ``top``
        units are gathered now; each block is a callable that gathers it."""
        flat: Dict[str, torch.Tensor] = {}
        block_units: Dict[int, int] = {}
        for k, u in enumerate(self.layout.units):
            if u.name in (PERSISTENT, TOP):
                flat.update(self.gathered(k))
            else:
                block_units[u.block_index()] = k
        blocks = n_blocks(self.names)
        tree = _nest({n: t for n, t in flat.items() if not n.startswith("blocks.")})
        if blocks:
            tree["blocks"] = [
                _BlockLeaves(self, block_units.get(i),
                             {n: t for n, t in flat.items() if n.startswith(f"blocks.{i}.")},
                             f"blocks.{i}.")
                for i in range(blocks)]
        return tree

    # ---- whole leaves, for checkpoints and GatheredParameters ------------ #
    def full_named(self, store: Optional[FlatStore]) -> Dict[str, torch.Tensor]:
        """Every leaf of ``store`` (the master when None) whole, as host
        fp32 tensors by name; a collective (every rank calls it)."""
        if store is None and self.stage < 3:
            return {n: self.full_view(self.param_flat, i).view(s).to("cpu", copy=True)
                    for i, (n, s) in enumerate(zip(self.names, self.shapes))}
        store = store if store is not None else self.master
        out = {}
        for u in self.layout.units:
            seg = store.read_into(torch.empty(u.part, dtype=torch.float32,
                                              device=self.device), u.shard_offset)
            if u.name == PERSISTENT:
                full = seg
            else:
                full = torch.empty(u.full_numel, dtype=torch.float32, device=self.device)
                comm.all_gather(full, seg)
            for i, o, n in zip(u.leaves, u.offsets, u.sizes):
                out[self.names[i]] = full[o:o + n].view(self.shapes[i]).to("cpu", copy=True)
        return {n: out[n] for n in self.names}

    def shard_copies(self, named: Dict[str, torch.Tensor], store: Optional[FlatStore]
                     ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """``(own view, value)`` pairs that write the whole leaves ``named``
        (checked by the caller) into ``store``'s shard (the master when
        None; at stages 1-2 the master is the full ``param_flat``)."""
        copies = []
        if store is None and self.stage < 3:
            for i, n in enumerate(self.names):
                copies.append((self.full_view(self.param_flat, i),
                               torch.as_tensor(named[n]).reshape(-1)))
            return copies
        store = store if store is not None else self.master
        for u in self.layout.units:
            flat = torch.zeros(u.full_numel, dtype=torch.float32)
            for i, o, n in zip(u.leaves, u.offsets, u.sizes):
                flat[o:o + n] = torch.as_tensor(named[self.names[i]]).reshape(-1)
            src = flat[u.start:u.start + u.part]
            for off, v in store.views(u.shard_offset, u.part):
                copies.append((v, src[off:off + v.numel()]))
        return copies

    def rank_leaves(self) -> Dict[str, torch.Tensor]:
        """Stage 3 with a host master: this rank's part of each leaf, by
        name, as host tensors viewing the master where the part lies in one
        piece (a copy where it crosses two): the whole leaf in its shape at
        world size 1, a flat slice of it otherwise."""
        out = {}
        for u in self.layout.units:
            for i, o, n in zip(u.leaves, u.offsets, u.sizes):
                lo, hi = max(o, u.start), min(o + n, u.start + u.part)
                if lo >= hi:
                    continue
                views = [v for _, v in self.master.views(u.shard_offset + lo - u.start, hi - lo)]
                t = views[0] if len(views) == 1 else torch.cat(views)
                out[self.names[i]] = t.view(self.shapes[i]) if hi - lo == n else t
        return out

    def pinned_bytes(self) -> int:
        return self.master.pinned_bytes() if self.master is not None else 0

    def close(self) -> None:
        if self.master is not None:
            self.master.close()


@contextlib.contextmanager
def GatheredParameters(engine, modifier_rank: Optional[int] = None, enabled: bool = True):
    """Yield ``{"params": {name: full fp32 host tensor}}`` of a training
    engine (every rank calls it: it gathers).  At stage 3 the model holds
    the full leaves on the device inside the block.  With
    ``modifier_rank``, the holder's leaves as that rank left them are
    written back into the engine on exit."""
    holder = {"params": engine.get_fp32_params()}
    zero = getattr(engine, "zero", None)
    placed = enabled and zero is not None and zero.stage >= 3
    if placed:
        engine.module.set_params(named_tree({n: t.to(engine.device)
                                             for n, t in holder["params"].items()}))
    try:
        yield holder
    finally:
        if placed:
            engine._place_stage3_placeholders()
    if enabled and modifier_rank is not None:
        sent = comm.broadcast_object_list([holder["params"]], src=modifier_rank)[0]
        engine._copy_in(engine._param_copies(sent))
