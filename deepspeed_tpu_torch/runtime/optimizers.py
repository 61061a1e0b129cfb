"""Optimizer factory (counterpart of ``deepspeed_tpu/runtime/optimizers.py``).

The JAX package builds an optax chain per optimizer name; the port's one
optimizer is decay-after Adam, stepped by the fused multi-tensor kernel of
``ops/cuda/fused_optim.py``: ``Adam``, ``AdamW``, ``FusedAdam`` and
``CPUAdam`` with ``adam_w_mode`` (the default).  ``FusedAdam`` updates a
list of whole leaves (ZeRO stage 0), ``ZeroAdam`` a rank's ZeRO shard, on
the device or streamed through it from host memory.  Every other name
raises, and nothing falls back to ``torch.optim``.
"""

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.cuda.fused_optim import (AdamTable, fused_adam,
                                                      safe_int32_increment,
                                                      spec_from_config, step_scalars)

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
FUSED_ADAM = "fusedadam"
CPU_ADAM = "cpuadam"
LAMB_OPTIMIZER = "lamb"
FUSED_LAMB = "fusedlamb"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
ONEBIT_LAMB_OPTIMIZER = "onebitlamb"
ZERO_ONE_ADAM_OPTIMIZER = "zerooneadam"
ADAGRAD_OPTIMIZER = "adagrad"
SGD_OPTIMIZER = "sgd"
LION_OPTIMIZER = "lion"

ADAM_FAMILY = (ADAM_OPTIMIZER, ADAMW_OPTIMIZER, FUSED_ADAM, CPU_ADAM)
DS_NATIVE_OPTIMIZERS = [ADAM_OPTIMIZER, ADAMW_OPTIMIZER, FUSED_ADAM, CPU_ADAM, LAMB_OPTIMIZER,
                        FUSED_LAMB, ONEBIT_ADAM_OPTIMIZER, ONEBIT_LAMB_OPTIMIZER,
                        ZERO_ONE_ADAM_OPTIMIZER, ADAGRAD_OPTIMIZER, SGD_OPTIMIZER, LION_OPTIMIZER]
UNPORTED = "ROADMAP.md, Queue 1 item 5"


def next_count(count: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The step count after a step: optax's saturating increment, or, where
    the device flag ``skip`` is set, the count unchanged (JAX's ``skip_step``
    keeps the whole optimizer state, so neither the bias corrections nor a
    schedule on the count move)."""
    inc = safe_int32_increment(count)
    if skip is None:
        return inc
    return torch.where(skip != 0, count, inc)


class FusedAdam:
    """Decay-after Adam over a fixed list of fp32 leaves: the state optax's
    ``ScaleByAdamState`` holds (``mu``, ``nu``, ``count``), and one fused
    kernel launch per ``step``.  This object stands where the JAX package
    returns its optax transformation."""

    def __init__(self, params: List[torch.Tensor], grads: List[torch.Tensor],
                 spec: Dict[str, Any], names: Optional[List[str]] = None):
        self.spec = spec
        self.names = list(names) if names is not None else [str(i) for i in range(len(params))]
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = torch.zeros((), dtype=torch.int32, device=params[0].device)
        self.table = AdamTable(params, grads, self.mu, self.nu)

    def step(self, inv: torch.Tensor, clip_factor: torch.Tensor,
             skip: Optional[torch.Tensor] = None, lr_scale: Optional[torch.Tensor] = None
             ) -> None:
        """Update every leaf in place from its raw gradient, which the
        kernel scales by ``inv`` (loss-scale and accumulation unscale) and
        ``clip_factor``; both are device scalars.  ``skip`` (fp32 0-dim,
        non-zero: no update, and the count stays) and ``lr_scale`` (the
        stability ladder's LR backoff, multiplying the step size) are
        device scalars too, or None."""
        neg_lr, bc1, bc2 = step_scalars(self.spec, self.count)
        if lr_scale is not None:
            neg_lr = neg_lr * lr_scale
        scal = torch.stack([inv, clip_factor, neg_lr, bc1, bc2]).to(torch.float32)
        fused_adam(self.table, scal, b1=self.spec["b1"], b2=self.spec["b2"],
                   eps=self.spec["eps"], wd=self.spec["wd"], skip=skip)
        # in place: a captured train step reads and writes this storage
        self.count.copy_(next_count(self.count, skip))

    def state_dict(self) -> Dict[str, Any]:
        """``{"mu": {name: tensor}, "nu": {name: tensor}, "count": tensor}``."""
        return {"mu": dict(zip(self.names, self.mu)), "nu": dict(zip(self.names, self.nu)),
                "count": self.count}

    def state_copies(self, sd: Dict[str, Any]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """``(own tensor, saved value)`` for every tensor of ``sd``, each
        name and shape checked first, so that a state that does not fit
        raises before anything is copied."""
        copies = []
        for key, dsts in (("mu", self.mu), ("nu", self.nu)):
            if set(sd[key]) != set(self.names):
                raise ValueError(f"optimizer state {key} has keys {sorted(sd[key])[:5]}..., "
                                 f"expected {self.names[:5]}...")
            for name, dst in zip(self.names, dsts):
                src = torch.as_tensor(sd[key][name])
                if dst.shape != src.shape:
                    raise ValueError(f"{key}[{name}]: shape {tuple(src.shape)}, expected "
                                     f"{tuple(dst.shape)}")
                copies.append((dst, src))
        count = torch.as_tensor(sd["count"])
        if count.numel() != 1:
            raise ValueError(f"optimizer count: shape {tuple(count.shape)}, expected ()")
        return copies + [(self.count, count.reshape(()))]

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Copy the moments and the count in place (the kernel's table and
        a captured train step keep pointing at them), after checking all of
        ``sd``; ``sd`` as ``state_dict()`` returns it, or as
        ``models/convert.py:adam_state_from_jax`` does."""
        for dst, src in self.state_copies(sd):
            dst.copy_(src)


class ZeroAdam:
    """Decay-after Adam over one rank's ZeRO shard (``runtime/zero/``): the
    same fused kernel over the slices of the flat master, gradient and
    moment buffers that the rank owns, the padding left out.

    ``segments`` are ``(shard offset, length, master view or None)``: a view
    where the master lives on the device, None where it lives in
    ``master_store`` on the host (stage 3 with ``offload_param``).  The
    moments live in ``mu`` and ``nu`` (``FlatStore``\\ s, on the host with
    ``offload_optimizer: cpu``, ``NvmeFlatStore``\\ s with ``nvme``).
    With every state on the device a step is one launch.  Otherwise the
    shard is walked in the stores' pieces: each chunk's state is copied
    into device buffers, updated by one launch over the chunk's slices and
    copied back, on the caller's stream.  The clip factor and ``inv`` come
    in once for the whole shard, so a chunked step gives what one launch
    gives, bit for bit.

    With host stores the walk is part of ``step`` (a captured step holds
    the copies).  With NVMe stores (``streamed``) file I/O cannot be
    captured, so ``step`` only computes the step's scalars into ``scal``
    (and advances the count), and ``walk`` (JAX's ``_fused_offload_step``,
    ``deepspeed_tpu/runtime/engine.py:799-897``) runs after it, on the host:
    for chunk k it joins chunk k's reads (each into a pinned slot of its
    store; the first chunk's started at the step's start) and copies it to
    the device buffers, starts chunk k+1's reads, makes the one launch with
    the same ``scal`` and skip flag, copies the chunk back into its slots,
    waits on an event for those copies and hands the slots to the staging
    writers."""

    def __init__(self, spec: Dict[str, Any], segments, grad: torch.Tensor, mu, nu,
                 master_store=None, gather_full=None, scatter=None):
        self.spec = spec
        self.device = grad.device
        self.mu, self.nu, self.master_store = mu, nu, master_store
        self.count = torch.zeros((), dtype=torch.int32, device=self.device)
        self._gather_full, self._scatter = gather_full, scatter
        staged = [s for s in (master_store if any(v is None for _, _, v in segments) else None,
                              mu, nu) if s is not None and s.host]
        n = grad.numel()
        piece = staged[0].piece if staged else max(1, n)
        self.buffers = {id(s): torch.empty(min(piece, n), dtype=torch.float32,
                                           device=self.device) for s in staged}
        self.staged = staged
        self.streamed = any(st.nvme for st in staged)
        # the step's (inv, clip factor, -lr, bc1, bc2), for a walk after it
        self.scal = torch.zeros(5, dtype=torch.float32, device=self.device)
        self._walk_skip = None
        self.chunks = []          # (piece index, length, AdamTable)
        for c0 in range(0, n, piece):
            c1 = min(n, c0 + piece)
            leaves = ([], [], [], [])
            for a, length, view in segments:
                lo, hi = max(a, c0), min(a + length, c1)
                if lo >= hi:
                    continue
                p = (view[lo - a:hi - a] if view is not None
                     else self.buffers[id(master_store)][lo - c0:hi - c0])
                for dst, t in zip(leaves, (p, grad[lo:hi],
                                           self._slice(mu, lo, hi, c0),
                                           self._slice(nu, lo, hi, c0))):
                    dst.append(t)
            if leaves[0]:
                self.chunks.append((c0 // piece, c1 - c0, AdamTable(*leaves)))

    def _slice(self, store, lo: int, hi: int, c0: int) -> torch.Tensor:
        if store.host:
            return self.buffers[id(store)][lo - c0:hi - c0]
        return store.flat()[lo:hi]

    def step(self, inv: torch.Tensor, clip_factor: torch.Tensor,
             skip: Optional[torch.Tensor] = None, lr_scale: Optional[torch.Tensor] = None
             ) -> None:
        """``FusedAdam.step`` over the shard: with ``skip`` set no launch
        writes, so an offloaded chunk's state copies back unchanged.  When
        ``streamed`` the chunks are left to ``walk``."""
        neg_lr, bc1, bc2 = step_scalars(self.spec, self.count)
        if lr_scale is not None:
            neg_lr = neg_lr * lr_scale
        scal = torch.stack([inv, clip_factor, neg_lr, bc1, bc2]).to(torch.float32)
        if self.streamed:
            # in place: a captured step writes what the walk after it reads
            self.scal.copy_(scal)
            self._walk_skip = skip
        else:
            for k, length, table in self.chunks:
                for s in self.staged:
                    s.load_piece(k, self.buffers[id(s)][:length])
                fused_adam(table, scal, **self._kernel_kw(skip))
                for s in self.staged:
                    s.save_piece(k, self.buffers[id(s)][:length])
        self.count.copy_(next_count(self.count, skip))

    def _kernel_kw(self, skip):
        return dict(b1=self.spec["b1"], b2=self.spec["b2"], eps=self.spec["eps"],
                    wd=self.spec["wd"], skip=skip)

    def prefetch(self) -> None:
        """Start the reads of the walk's first chunk (at the start of a
        step, so they overlap its forward and backward)."""
        if self.streamed and self.chunks:
            for s in self.staged:
                if s.nvme:
                    s.prefetch_piece(self.chunks[0][0])

    def walk(self) -> None:
        """The update of a ``streamed`` shard, after ``step`` (see the
        class).  A failed read or write raises."""
        if not self.streamed:
            return
        nvme = [s for s in self.staged if s.nvme]
        kw = self._kernel_kw(self._walk_skip)
        cuda = self.device.type == "cuda"
        for i, (k, length, table) in enumerate(self.chunks):
            for s in self.staged:
                s.load_piece(k, self.buffers[id(s)][:length])
            if i + 1 < len(self.chunks):
                # chunk k+1's reads start before chunk k's launch (taking
                # a slot may wait for an earlier chunk's write)
                for s in nvme:
                    s.prefetch_piece(self.chunks[i + 1][0])
            fused_adam(table, self.scal, **kw)
            for s in self.staged:
                s.save_piece(k, self.buffers[id(s)][:length])
            if cuda:
                # the slots go to writer threads only once their
                # device-to-host copies have landed
                event = torch.cuda.Event()
                event.record()
                event.synchronize()
            for s in nvme:
                s.write_saved()
        for s in nvme:
            s.end_walk()

    def flush(self) -> None:
        """Write back what a checkpoint load patched into NVMe stores."""
        for s in (self.mu, self.nu):
            if s.nvme:
                s.flush()

    def close(self) -> None:
        self.mu.close()
        self.nu.close()

    def state_dict(self) -> Dict[str, Any]:
        """The whole moments by name (every rank calls it: it gathers)."""
        return {"mu": self._gather_full(self.mu), "nu": self._gather_full(self.nu),
                "count": self.count}

    def state_copies(self, sd: Dict[str, Any]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """``(own view, value)`` writing whole saved moments into this rank's
        shards; the caller has checked their names and shapes."""
        count = torch.as_tensor(sd["count"])
        if count.numel() != 1:
            raise ValueError(f"optimizer count: shape {tuple(count.shape)}, expected ()")
        return (self._scatter(sd["mu"], self.mu) + self._scatter(sd["nu"], self.nu)
                + [(self.count, count.reshape(()))])


def adam_spec(name: str, params: Dict[str, Any], lr_schedule: Optional[Callable] = None
              ) -> Dict[str, Any]:
    """The fused kernel's spec for a ds_config ``optimizer`` block, or the
    ``NotImplementedError`` / ``ValueError`` of an optimizer it is not."""
    name = name.lower()
    if name in ADAM_FAMILY:
        lr = lr_schedule if lr_schedule is not None else params.get("lr", 1e-3)
        spec = spec_from_config(name, params, lr)
        if spec is None:
            raise NotImplementedError(
                f"{name} with adam_w_mode=false and weight_decay (L2 mode) is not ported "
                f"yet ({UNPORTED})")
        return spec
    if name in DS_NATIVE_OPTIMIZERS:
        raise NotImplementedError(f"optimizer {name!r} is not ported yet ({UNPORTED})")
    raise ValueError(f"Unknown optimizer type: {name!r} (valid: {DS_NATIVE_OPTIMIZERS})")


def get_optimizer(name: str, params: Dict[str, Any], leaves: List[torch.Tensor],
                  grads: List[torch.Tensor], lr_schedule: Optional[Callable] = None,
                  names: Optional[List[str]] = None) -> FusedAdam:
    """The optimizer of a ds_config ``optimizer`` block over ``leaves``
    (named ``names`` in its state dict); ``lr_schedule`` (a function of the
    device step count) overrides the static ``lr``."""
    return FusedAdam(leaves, grads, adam_spec(name, params, lr_schedule), names)
