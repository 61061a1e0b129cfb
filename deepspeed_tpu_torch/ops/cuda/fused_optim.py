"""Fused Adam/AdamW update: a hand-written multi-tensor CUDA kernel and its
plain PyTorch version (counterpart of ``deepspeed_tpu/ops/pallas/fused_optim.py``).

``fused_adam(table, scal, ...)`` updates every leaf of an ``AdamTable``
(params, grads, first and second moments, all fp32) in place, in one
launch.  ``scal`` is the fp32 device vector ``[inv, clip_factor, neg_lr,
bc1, bc2]``: the loss-scale unscale and the clip factor fold into the
gradient read as ``(g * inv) * clip``, and the bias corrections and step
size come from the device, so a step needs no host sync.

The per-element op sequence is ``_adam_kernel``'s (``fused_optim.py:139``)
and optax's: ``(1-b1)*g + b1*mu``, ``(1-b2)*(g*g) + b2*nu``,
``(mu/bc1) / (sqrt(nu/bc2) + eps)``, ``+ wd*p`` only when ``wd`` is not 0,
``neg_lr * u``, ``p + u``.  The kernel rounds every operation to fp32 with
no FMA contraction and correctly rounded division and square root, so on
the card it agrees bit for bit with ``adam_reference``, which rounds the
same way.

Dispatch: a table of CPU tensors runs ``adam_reference``; a table of CUDA
tensors launches the kernel of ``csrc/fused_optim.cu`` (replaces
``_adam_kernel``, ``ops/pallas/fused_optim.py:139``).  The table of leaf
pointers and the plan of chunks are built once (``AdamTable``); the leaves
are updated in place, so they stay valid.  The plan (``plan_chunks``, a
pure function of the leaf sizes and the pointers' offsets mod 16) cuts
every leaf into chunks of the kernel's chunk size: 16-byte vector chunks
where p, g, mu and nu are all 16-byte aligned, scalar chunks for a leaf's
last ``n % 4`` elements and for every leaf that is not.  The kernel is
bound by bytes: 28 bytes per element (p, g, mu, nu read; p, mu, nu
written).

``fused_adam.launches`` counts kernel launches, ``adam_reference.calls``
the plain version's calls.
"""

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deepspeed_tpu_torch.ops.cuda import builder

INT32_MAX = 2 ** 31 - 1


# --------------------------------------------------------------------------- #
# Spec and step scalars (ports of spec_from_config :66 and step_scalars :117)
# --------------------------------------------------------------------------- #
def spec_from_config(name: str, params: Dict[str, Any],
                     lr: Union[float, Callable]) -> Optional[Dict[str, Any]]:
    """Fusion spec for a ds_config optimizer block, or ``None`` when the
    optimizer is not a decay-after Adam (the only math this kernel does)."""
    name = (name or "adam").lower()
    if name not in ("adam", "adamw", "fusedadam", "cpuadam"):
        return None
    adam_w = bool(params.get("adam_w_mode", True)) or name == "adamw"
    wd = float(params.get("weight_decay", 0.0))
    if not adam_w and wd:
        return None      # L2 mode: decay feeds the moments; different math
    betas = params.get("betas", (0.9, 0.999))
    return {"b1": float(betas[0]), "b2": float(betas[1]),
            "eps": float(params.get("eps", 1e-8)),
            "wd": wd if adam_w else 0.0, "lr": lr}


def safe_int32_increment(count: torch.Tensor) -> torch.Tensor:
    """optax's saturating int32 increment."""
    return torch.where(count < INT32_MAX, count + 1, INT32_MAX).to(torch.int32)


def step_scalars(spec: Dict[str, Any], count: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(neg_lr, bc1, bc2) as fp32 0-dim tensors on ``count``'s device:
    ``1 - b**count_inc`` in fp32 and ``-1 * lr(count)`` (a schedule, on the
    device count) or the static ``-lr``."""
    c = safe_int32_increment(count).to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full_like(c, spec["b1"]), c)
    bc2 = 1.0 - torch.pow(torch.full_like(c, spec["b2"]), c)
    lr = spec["lr"]
    if callable(lr):
        neg_lr = (-1 * lr(count)).to(torch.float32).reshape(())
    else:
        neg_lr = torch.full_like(c, -lr)
    return neg_lr, bc1, bc2


def _f32(v: float) -> float:
    """``v`` rounded to fp32, the value a weakly typed Python float takes in
    an fp32 JAX expression."""
    return float(np.float32(v))


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded fp32 square root: fp64's root rounded once to fp32
    (53 >= 2*24 + 2 bits, so the double rounding is exact).  ``torch.sqrt``
    on fp32 CPU tensors is not correctly rounded."""
    return torch.sqrt(x.double()).float()


# --------------------------------------------------------------------------- #
# Plain version
# --------------------------------------------------------------------------- #
@torch.no_grad()
def adam_reference(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                   mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor],
                   scal: torch.Tensor, *, b1: float, b2: float, eps: float,
                   wd: float) -> None:
    """The kernel's update, leaf by leaf, in place, each op rounded to fp32."""
    adam_reference.calls += 1
    inv, clip, neg_lr, bc1, bc2 = scal.unbind()
    c1, c2 = _f32(1 - b1), _f32(1 - b2)
    b1, b2, eps, wd = _f32(b1), _f32(b2), _f32(eps), _f32(wd)
    for p, g, mu, nu in zip(params, grads, mus, nus):
        g = (g.float() * inv) * clip
        m = c1 * g + b1 * mu
        v = c2 * (g * g) + b2 * nu
        u = (m / bc1) / (_sqrt_rn(v / bc2) + eps)
        if wd:
            u = u + wd * p
        p.copy_(p + neg_lr * u)
        mu.copy_(m)
        nu.copy_(v)


adam_reference.calls = 0


# --------------------------------------------------------------------------- #
# Kernel wrapper
# --------------------------------------------------------------------------- #
def plan_chunks(sizes: Sequence[int], offsets: Sequence[Sequence[int]],
                chunk: int) -> np.ndarray:
    """The kernel's work: int32 ``[n_chunks, 4]`` rows (leaf, vector,
    count, start), every element of every leaf in exactly one chunk of at
    most ``chunk`` elements.

    ``offsets[i]`` holds leaf i's four base addresses (p, g, mu, nu) mod 16,
    in bytes.  A leaf whose four are all 0 is cut into vector chunks (count
    a multiple of 4, so each range is 16-byte aligned in all four tensors),
    and its last ``n % 4`` elements form a scalar chunk; any other leaf is
    cut into scalar chunks whole.  ``chunk`` is a multiple of 4.
    """
    if chunk <= 0 or chunk % 4:
        raise ValueError(f"plan_chunks: chunk {chunk} must be a positive multiple of 4")
    rows = []
    for leaf, (n, offs) in enumerate(zip(sizes, offsets)):
        if not 0 < n < 2 ** 31:
            raise ValueError(f"plan_chunks: leaf {leaf} has {n} elements (1 to 2**31 - 1)")
        n_vec = n - n % 4 if not any(o % 16 for o in offs) else 0
        rows += [(leaf, 1, min(chunk, n_vec - s), s) for s in range(0, n_vec, chunk)]
        rows += [(leaf, 0, min(chunk, n - s), s) for s in range(n_vec, n, chunk)]
    return np.asarray(rows, np.int32).reshape(-1, 4)


class AdamTable:
    """The leaves one optimizer updates: four equally shaped fp32 lists
    (params, grads, mu, nu).  On CUDA it also holds the device table of
    their pointers, the plan of chunks the kernel walks and the grid it
    launches; the tensors are kept referenced here for as long as the table
    lives."""

    def __init__(self, params: List[torch.Tensor], grads: List[torch.Tensor],
                 mus: List[torch.Tensor], nus: List[torch.Tensor]):
        self.leaves = tuple(list(ts) for ts in (params, grads, mus, nus))
        if not params or any(len(ts) != len(params) for ts in self.leaves):
            raise ValueError("AdamTable: params, grads, mu and nu must be non-empty "
                             "lists of one length")
        self.device = params[0].device
        for i, group in enumerate(zip(*self.leaves)):
            for t in group:
                if t.dtype != torch.float32 or t.device != self.device:
                    raise TypeError(f"AdamTable: leaf {i}: every tensor must be fp32 on "
                                    f"{self.device}, got {t.dtype} on {t.device}")
                if t.shape != group[0].shape or not t.is_contiguous() or t.numel() == 0:
                    raise ValueError(f"AdamTable: leaf {i}: tensors must be contiguous, "
                                     "non-empty and of one shape")
        if self.device.type == "cuda":
            self._build()

    def _build(self) -> None:
        lib = builder.load_library()
        with torch.cuda.device(self.device):
            self.grid = int(lib.dst_fused_adam_grid())
        if self.grid <= 0:
            raise RuntimeError("fused_adam: the occupancy query failed")
        ptrs = [[t.data_ptr() for t in ts] for ts in self.leaves]
        plan = plan_chunks([p.numel() for p in self.leaves[0]],
                           [[a % 16 for a in group] for group in zip(*ptrs)],
                           int(lib.dst_fused_adam_chunk()))
        dev = self.device
        self.table = torch.from_numpy(np.asarray(ptrs, np.int64).reshape(-1)).to(dev)
        self.chunks = torch.from_numpy(plan).to(dev)
        self.n_leaves, self.n_chunks = len(ptrs[0]), len(plan)

    def numel(self) -> int:
        return sum(p.numel() for p in self.leaves[0])


def fused_adam(table: AdamTable, scal: torch.Tensor, *, b1: float, b2: float,
               eps: float, wd: float) -> None:
    """One Adam/AdamW step over every leaf of ``table``, in place."""
    if table.device.type == "cpu":
        adam_reference(*table.leaves, scal, b1=b1, b2=b2, eps=eps, wd=wd)
        return
    if table.device.type != "cuda":
        raise ValueError(f"fused_adam: no kernel for device {table.device}")
    if (scal.dtype != torch.float32 or scal.device != table.device
            or tuple(scal.shape) != (5,) or not scal.is_contiguous()):
        raise TypeError("fused_adam: scal must be a contiguous fp32 [5] tensor on "
                        f"{table.device}")
    lib = builder.load_library()
    rc = lib.dst_fused_adam(table.table.data_ptr(), table.n_leaves, table.chunks.data_ptr(),
                            table.n_chunks, table.grid, scal.data_ptr(), _f32(b1), _f32(b2),
                            _f32(1 - b1), _f32(1 - b2), _f32(eps), _f32(wd), int(wd != 0),
                            torch.cuda.current_stream(table.device).cuda_stream)
    builder.check(lib, rc, "fused_adam")
    fused_adam.launches += 1


fused_adam.launches = 0


def reset_counts() -> None:
    fused_adam.launches = 0
    adam_reference.calls = 0
