"""Accelerator singleton and device resolution (counterpart of
``deepspeed_tpu/accelerator/real_accelerator.py``).

``get_accelerator()`` returns the CUDA accelerator.  The CPU accelerator is
returned only when it is asked for by name: ``get_accelerator("cpu")`` or
``DS_ACCELERATOR=cpu``.  ``resolve_device`` is what every entry point of the
package calls on its ``device=`` argument: no argument means the card, and
a machine without one raises instead of carrying on on the CPU.
"""

import os
from typing import Optional, Union

import torch

from deepspeed_tpu_torch.accelerator.abstract_accelerator import DeepSpeedAccelerator

_accelerator: Optional[DeepSpeedAccelerator] = None

SUPPORTED = ("cuda", "cpu")


def get_accelerator(name: Optional[str] = None) -> DeepSpeedAccelerator:
    """The CUDA accelerator, or the one ``name`` (or ``DS_ACCELERATOR``)
    asks for."""
    global _accelerator
    from deepspeed_tpu_torch.accelerator.cuda_accelerator import (
        CPU_Accelerator, CUDA_Accelerator)
    name = name or os.environ.get("DS_ACCELERATOR")
    if name is not None:
        if name not in SUPPORTED:
            raise ValueError(f"accelerator {name!r} not in {SUPPORTED}")
        return CPU_Accelerator() if name == "cpu" else CUDA_Accelerator()
    if _accelerator is None:
        _accelerator = CUDA_Accelerator()
    return _accelerator


def set_accelerator(accel: DeepSpeedAccelerator):
    global _accelerator
    _accelerator = accel


def resolve_device(device: Union[None, str, torch.device] = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA
    device, or under the launcher (``LOCAL_RANK`` set, one process a GPU)
    ``cuda:LOCAL_RANK``, made current so that the NCCL group and every
    kernel of the rank run there.  Raises when CUDA is asked for
    (explicitly or by default) on a machine that has none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available on this machine; pass device='cpu' "
                "to run the plain PyTorch path on the CPU")
        if dev.index is None:
            local = os.environ.get("LOCAL_RANK")
            if local is not None:
                dev = torch.device("cuda", int(local))
                torch.cuda.set_device(dev)
            else:
                dev = torch.device("cuda", torch.cuda.current_device())
    return dev
