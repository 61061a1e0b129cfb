"""Residency planner: fit the step into a device-memory budget (counterpart
of ``deepspeed_tpu/runtime/offload/policy.py``).

Two footprints are compared against the per-device budget
(``zero_optimization.hbm_budget_bytes`` or the ``DST_HBM_BUDGET_BYTES``
environment variable):

* **plain stage 3**: the full gathered compute-dtype parameter tree on the
  device, plus the fp32 parameter shard, the fp32 gradient shard and the
  optimizer-state shards;
* **offload + layer window**: block parameters stay on the host; only the
  non-block leaves plus ``prefetch_depth + 1`` blocks are on the device at
  any instant, and host-tier optimizer state leaves the device entirely.

If the budget admits neither plan the engine refuses at init with
:class:`HBMBudgetError` instead of running out of memory mid-step.  The
arithmetic is ``runtime/memory_model.py``'s.  A tree's leaves are anything
with ``shape`` and ``dtype`` (torch tensors, numpy arrays); its blocks are
the port's list of per-block trees or a tree stacked along a leading layer
dimension, as the JAX package's scanned models hold them.
"""

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.runtime import memory_model


class HBMBudgetError(RuntimeError):
    """The configured step cannot fit the HBM budget under any available
    residency plan (raise instead of OOMing mid-step)."""


def leaf_bytes(shape: Tuple[int, ...], dtype) -> int:
    return int(math.prod(shape) or 1) * _itemsize(dtype)


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tree_leaves(v)]
    return [] if tree is None else [tree]


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return int(np.dtype(dtype).itemsize)


def tree_bytes(tree, itemsize: Optional[int] = None) -> int:
    """Total bytes of a tree of shape/dtype carriers; with ``itemsize`` the
    dtype is overridden (compute-dtype sizing)."""
    total = 0
    for leaf in _tree_leaves(tree):
        n = int(math.prod(leaf.shape) or 1)
        total += n * (itemsize if itemsize is not None else _itemsize(leaf.dtype))
    return total


@dataclass
class ResidencyPlan:
    """The planner's verdict plus the numbers behind it (all bytes are
    per device)."""
    budget_bytes: int
    plain_peak_bytes: int
    window_peak_bytes: int
    fits_plain: bool
    fits_window: bool
    n_layer: int
    prefetch_depth: int
    params_tier: str = "hbm"            # hbm | host | nvme
    optimizer_tier: str = "hbm"
    notes: Tuple[str, ...] = field(default_factory=tuple)

    @property
    def fits(self) -> bool:
        return self.fits_plain or self.fits_window

    def describe(self) -> str:
        mb = 1.0 / (1 << 20)
        return (f"HBM budget {self.budget_bytes * mb:.1f} MiB: "
                f"plain stage-3 peak {self.plain_peak_bytes * mb:.1f} MiB "
                f"({'fits' if self.fits_plain else 'over'}), "
                f"offload window peak {self.window_peak_bytes * mb:.1f} MiB "
                f"({'fits' if self.fits_window else 'over'}; "
                f"L={self.n_layer}, depth={self.prefetch_depth}, "
                f"params@{self.params_tier}, opt@{self.optimizer_tier})")

    def as_record(self) -> Dict[str, Any]:
        return {"budget_bytes": self.budget_bytes,
                "plain_peak_bytes": self.plain_peak_bytes,
                "window_peak_bytes": self.window_peak_bytes,
                "fits_plain": self.fits_plain,
                "fits_window": self.fits_window,
                "n_layer": self.n_layer,
                "prefetch_depth": self.prefetch_depth,
                "params_tier": self.params_tier,
                "optimizer_tier": self.optimizer_tier}


def _block_and_rest(params) -> Tuple[Any, Any, int]:
    """Split a param tree into its ``blocks`` (a list of per-block trees,
    or a subtree stacked along a leading layer dimension) and the rest,
    returning also the layer count (0 when there are no blocks)."""
    if not isinstance(params, dict) or "blocks" not in params:
        return None, params, 0
    blocks = params["blocks"]
    rest = {k: v for k, v in params.items() if k != "blocks"}
    if isinstance(blocks, (list, tuple)):
        return blocks, rest, len(blocks)
    leaves = _tree_leaves(blocks)
    n_layer = int(leaves[0].shape[0]) if leaves and leaves[0].shape else 0
    return blocks, rest, n_layer


def plan_residency(params,
                   opt_state,
                   budget_bytes: int,
                   world: int,
                   compute_itemsize: int,
                   prefetch_depth: int = 2,
                   params_tier: str = "hbm",
                   optimizer_tier: str = "hbm",
                   opt_slots: int = 2) -> ResidencyPlan:
    """Size the plain-stage-3 peak and the offload layer-window peak.

    ``params`` / ``opt_state`` are trees of shape/dtype carriers (tensors
    or arrays).  ``world`` is the gather
    group size (ZeRO-3 shard denominator).  ``opt_state=None`` sizes the
    optimizer as ``opt_slots`` fp32 copies of the param shard (Adam m+v).
    """
    world = max(1, int(world))

    param_total = tree_bytes(params)                      # fp32 master
    gathered = tree_bytes(params, itemsize=compute_itemsize)
    blocks, rest, n_layer = _block_and_rest(params)
    depth = max(1, int(prefetch_depth))

    # the peak arithmetic lives in runtime/memory_model.py — the SAME
    # model the autotuner prunes candidate configs with, so a config the
    # tuner admits is a config this gate admits (parity-tested)
    peaks = memory_model.step_peaks(
        param_bytes=param_total,
        gathered_bytes=gathered,
        world=world,
        opt_bytes=(tree_bytes(opt_state) if opt_state is not None else None),
        opt_slots=opt_slots,
        block_gathered_bytes=(tree_bytes(blocks, itemsize=compute_itemsize)
                              if blocks is not None and n_layer > 0 else 0),
        rest_gathered_bytes=(tree_bytes(rest, itemsize=compute_itemsize)
                             if blocks is not None and n_layer > 0 else 0),
        n_layer=n_layer,
        prefetch_depth=depth,
        optimizer_tier=optimizer_tier)
    notes = list(peaks.notes)
    if params_tier == "hbm":
        notes.append("params_tier=hbm: window plan assumes host residency")

    plan = ResidencyPlan(
        budget_bytes=int(budget_bytes),
        plain_peak_bytes=peaks.plain_peak_bytes,
        window_peak_bytes=peaks.window_peak_bytes,
        fits_plain=peaks.plain_peak_bytes <= budget_bytes,
        fits_window=(peaks.window_peak_bytes <= budget_bytes
                     and peaks.has_window
                     and params_tier != "hbm"),
        n_layer=n_layer,
        prefetch_depth=depth,
        params_tier=params_tier,
        optimizer_tier=optimizer_tier,
        notes=tuple(notes))
    return plan


def check_budget(plan: ResidencyPlan, offload_enabled: bool) -> ResidencyPlan:
    """Enforce the plan: refuse configurations that cannot fit.

    Without offload only the plain peak counts; with offload the window
    plan may rescue it.  Raises :class:`HBMBudgetError` on refusal."""
    if plan.budget_bytes <= 0:
        return plan
    if not offload_enabled:
        if not plan.fits_plain:
            raise HBMBudgetError(
                "plain stage-3 step exceeds the HBM budget — "
                + plan.describe()
                + " — enable zero_optimization.offload_param/"
                  "offload_optimizer to train beyond HBM")
        return plan
    if not plan.fits:
        raise HBMBudgetError(
            "even the offloaded layer window exceeds the HBM budget — "
            + plan.describe())
    return plan
