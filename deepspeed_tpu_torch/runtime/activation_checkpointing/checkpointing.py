"""Activation checkpointing (counterpart of
``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``).

The JAX package selects a ``jax.checkpoint`` policy; the port's one policy
is the default one, ``nothing_saveable``: a block keeps only its inputs and
re-runs its forward in the backward pass, which is
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``.  The
other policies raise until they are ported.
"""

from typing import Callable

import torch.utils.checkpoint

PARTITION_ACTIVATIONS = ("ROADMAP.md, Queue 1 item 6: activation checkpointing "
                         "(partition_activations, dots saveable)")
CPU_CHECKPOINTING = "ROADMAP.md, Queue 1 item 7: offload (cpu_checkpointing)"


def checkpoint_policy(partition_activations: bool = False,
                      cpu_checkpointing: bool = False) -> str:
    """The policy the ``activation_checkpointing`` block selects."""
    if cpu_checkpointing:
        raise NotImplementedError(f"cpu_checkpointing is not ported yet ({CPU_CHECKPOINTING})")
    if partition_activations:
        raise NotImplementedError(
            f"partition_activations is not ported yet ({PARTITION_ACTIVATIONS})")
    return "nothing_saveable"


def checkpoint(function: Callable, *args):
    """Run ``function(*args)`` keeping only its inputs for the backward."""
    return torch.utils.checkpoint.checkpoint(function, *args, use_reentrant=False)
