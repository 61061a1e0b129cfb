"""Activation checkpointing (counterpart of
``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``).

The JAX package's default policy is ``nothing_saveable`` plus the flash
kernel's outputs (``save_only_these_names("flash_o", "flash_lse")``): a
block keeps its input and the attention's o and lse, and re-runs the rest
of its forward in the backward pass, so the flash forward kernel never runs
twice.  The port is ``torch.utils.checkpoint.checkpoint(...,
use_reentrant=False)`` with a selective-checkpoint policy that saves the
outputs of the flash forward op (``dst_torch::flash_fwd``,
``ops/cuda/flash_attention.py``) and prefers to recompute every other op.
The block-sparse forward op (``dst_torch::block_sparse_fwd``,
``ops/cuda/block_sparse_attention.py``) is among those: JAX's policy saves
only flash's outputs, so under remat a sparse layer runs its forward twice
per micro-step, in the port as in JAX.
``partition_activations`` (dots saveable) and ``cpu_checkpointing`` raise
until they are ported.
"""

import functools
from typing import Callable

import torch.utils.checkpoint
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

PARTITION_ACTIVATIONS = ("ROADMAP.md, Queue 1 item 6: activation checkpointing "
                         "(partition_activations, dots saveable)")
CPU_CHECKPOINTING = "ROADMAP.md, Queue 1 item 7: offload (cpu_checkpointing)"
# ops whose outputs every policy saves: the flash forward's (o, lse), which
# the JAX package tags "flash_o" and "flash_lse"
SAVED_OPS = frozenset({"dst_torch::flash_fwd"})


def save_flash_outputs(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``nothing_saveable`` plus the flash forward's outputs."""
    return (CheckpointPolicy.MUST_SAVE if op.name() in SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def checkpoint_policy(partition_activations: bool = False,
                      cpu_checkpointing: bool = False) -> Callable:
    """The selective-checkpoint policy the ``activation_checkpointing``
    block selects."""
    if cpu_checkpointing:
        raise NotImplementedError(f"cpu_checkpointing is not ported yet ({CPU_CHECKPOINTING})")
    if partition_activations:
        raise NotImplementedError(
            f"partition_activations is not ported yet ({PARTITION_ACTIVATIONS})")
    return save_flash_outputs


def checkpoint(function: Callable, *args):
    """Run ``function(*args)`` keeping its inputs and what the policy
    saves for the backward; returns what ``function`` returns (a tensor,
    or a tuple such as a block's ``(x, aux)``)."""
    # No RNG state is stashed for the recompute: nothing draws random
    # numbers inside a checkpointed body (the MoE gating noise is drawn
    # before it, from the engine's generator, and passed in as tensors, so
    # the recompute routes as the forward did), and reading the CUDA
    # generator's state is refused inside a CUDA graph capture.  Dropout
    # (ROADMAP.md, Queue 1 entry 6) draws inside the body: it will need
    # this flag back on, with the generator the capture registers.
    return torch.utils.checkpoint.checkpoint(
        function, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts,
                                     checkpoint_policy()))
