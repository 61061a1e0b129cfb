"""Accelerator abstraction (counterpart of
``deepspeed_tpu/accelerator/abstract_accelerator.py``).

The interface keeps the JAX package's capability groups: device identity,
synchronization, RNG, streams and events, memory stats, dtype support,
graphs, the communication backend name and the op-builder slot.  On a GPU
the CUDA-isms the TPU package turned into no-ops (streams, events, graphs,
``empty_cache``) are real again, so the CUDA implementation overrides them.
"""

import abc
from typing import Dict, Optional


class DeepSpeedAccelerator(abc.ABC):

    def __init__(self):
        self._name: Optional[str] = None
        self._communication_backend_name: Optional[str] = None

    # ---- device identity --------------------------------------------- #
    @abc.abstractmethod
    def device_name(self, device_index: Optional[int] = None) -> str: ...

    @abc.abstractmethod
    def device(self, device_index: Optional[int] = None): ...

    @abc.abstractmethod
    def device_count(self) -> int: ...

    @abc.abstractmethod
    def current_device(self) -> int: ...

    def current_device_name(self) -> str:
        return self.device_name(self.current_device())

    def set_device(self, device_index: int):
        """Select the process's device (no-op where there is only one)."""

    # ---- synchronization --------------------------------------------- #
    @abc.abstractmethod
    def synchronize(self, device_index: Optional[int] = None): ...

    # ---- RNG ----------------------------------------------------------- #
    @abc.abstractmethod
    def manual_seed(self, seed: int): ...

    def manual_seed_all(self, seed: int):
        self.manual_seed(seed)

    @abc.abstractmethod
    def initial_seed(self) -> int: ...

    def random(self):
        import torch
        return torch.random

    def get_rng_state(self, device_index=None):
        return self.initial_seed()

    def set_rng_state(self, new_state, device_index=None):
        self.manual_seed(int(new_state))

    # ---- streams / events ---------------------------------------------- #
    def stream(self, stream=None):
        import contextlib
        return contextlib.nullcontext()

    def current_stream(self, device_index=None):
        return None

    def default_stream(self, device_index=None):
        return None

    def Stream(self, *a, **k):
        return None

    def Event(self, *a, **k):
        return None

    # ---- memory -------------------------------------------------------- #
    @abc.abstractmethod
    def memory_stats(self, device_index: Optional[int] = None) -> Dict: ...

    def memory_allocated(self, device_index=None) -> int:
        return int(self.memory_stats(device_index).get("bytes_in_use", 0))

    def max_memory_allocated(self, device_index=None) -> int:
        return int(self.memory_stats(device_index).get("peak_bytes_in_use", 0))

    def memory_reserved(self, device_index=None) -> int:
        return self.memory_allocated(device_index)

    def max_memory_reserved(self, device_index=None) -> int:
        return self.max_memory_allocated(device_index)

    def total_memory(self, device_index=None) -> int:
        return int(self.memory_stats(device_index).get("bytes_limit", 0))

    def available_memory(self, device_index=None) -> int:
        return self.total_memory(device_index) - self.memory_allocated(device_index)

    def empty_cache(self):
        """Drop cached allocator blocks, where the device has a cache."""

    def reset_peak_memory_stats(self, device_index=None):
        """Reset the peak-memory counters, where the device keeps them."""

    memory_cached = memory_reserved
    max_memory_cached = max_memory_reserved

    def reset_max_memory_allocated(self, device_index=None):
        self.reset_peak_memory_stats(device_index)

    def reset_max_memory_cached(self, device_index=None):
        self.reset_peak_memory_stats(device_index)

    # ---- dtype support ------------------------------------------------- #
    @abc.abstractmethod
    def is_bf16_supported(self) -> bool: ...

    @abc.abstractmethod
    def is_fp16_supported(self) -> bool: ...

    def supported_dtypes(self):
        import torch
        out = [torch.float32]
        if self.is_bf16_supported():
            out.append(torch.bfloat16)
        if self.is_fp16_supported():
            out.append(torch.float16)
        return out

    # ---- graphs -------------------------------------------------------- #
    def is_triton_supported(self) -> bool:
        return False

    def create_graph(self):
        return None

    def capture_to_graph(self, graph, **kwargs):
        import contextlib
        return contextlib.nullcontext()

    def replay_graph(self, graph):
        """Replay a captured graph, where the device has graphs."""

    # ---- communication / ops ------------------------------------------ #
    @abc.abstractmethod
    def communication_backend_name(self) -> str: ...

    def is_initialized(self) -> bool:
        return True

    @abc.abstractmethod
    def is_available(self) -> bool: ...

    def op_builder_dir(self) -> str:
        """Where the package's kernels live."""
        return "deepspeed_tpu_torch.ops"

    @abc.abstractmethod
    def on_accelerator(self, tensor) -> bool: ...

    # ---- host/pinned memory ------------------------------------------- #
    @abc.abstractmethod
    def pin_memory(self, tensor): ...

    def is_pinned(self, tensor) -> bool:
        return bool(getattr(tensor, "is_pinned", lambda: False)())
