"""CUDA implementation of the accelerator interface (counterpart of
``deepspeed_tpu/accelerator/tpu_accelerator.py``).

Everything is backed by ``torch.cuda``.  ``CPU_Accelerator`` exists for
tests and tools that ask for the CPU explicitly; it is never picked on its
own (``real_accelerator.get_accelerator``).
"""

from typing import Dict, Optional

import torch

from deepspeed_tpu_torch.accelerator.abstract_accelerator import DeepSpeedAccelerator


class CUDA_Accelerator(DeepSpeedAccelerator):

    def __init__(self):
        super().__init__()
        self._name = "cuda"
        self._communication_backend_name = "nccl"

    # ---- device identity --------------------------------------------- #
    def device_name(self, device_index: Optional[int] = None) -> str:
        if device_index is None:
            return self._name
        return f"{self._name}:{device_index}"

    def device(self, device_index: Optional[int] = None):
        if not self.is_available():
            raise RuntimeError("CUDA is not available on this machine; "
                               "ask for the CPU accelerator explicitly")
        return torch.device(self._name, self.current_device()
                            if device_index is None else device_index)

    def device_count(self) -> int:
        return torch.cuda.device_count()

    def current_device(self) -> int:
        return torch.cuda.current_device()

    def set_device(self, device_index: int):
        torch.cuda.set_device(device_index)

    # ---- synchronization --------------------------------------------- #
    def synchronize(self, device_index: Optional[int] = None):
        torch.cuda.synchronize(device_index)

    # ---- RNG ----------------------------------------------------------- #
    def manual_seed(self, seed: int):
        torch.cuda.manual_seed(int(seed))

    def manual_seed_all(self, seed: int):
        torch.cuda.manual_seed_all(int(seed))

    def initial_seed(self) -> int:
        return torch.cuda.initial_seed()

    def get_rng_state(self, device_index=None):
        return torch.cuda.get_rng_state("cuda" if device_index is None
                                        else device_index)

    def set_rng_state(self, new_state, device_index=None):
        torch.cuda.set_rng_state(new_state, "cuda" if device_index is None
                                 else device_index)

    # ---- streams / events ---------------------------------------------- #
    def stream(self, stream=None):
        return torch.cuda.stream(stream)

    def current_stream(self, device_index=None):
        return torch.cuda.current_stream(device_index)

    def default_stream(self, device_index=None):
        return torch.cuda.default_stream(device_index)

    def Stream(self, *a, **k):
        return torch.cuda.Stream(*a, **k)

    def Event(self, *a, **k):
        return torch.cuda.Event(*a, **k)

    # ---- memory -------------------------------------------------------- #
    def memory_stats(self, device_index: Optional[int] = None) -> Dict:
        return dict(torch.cuda.memory_stats(device_index))

    def memory_allocated(self, device_index=None) -> int:
        return torch.cuda.memory_allocated(device_index)

    def max_memory_allocated(self, device_index=None) -> int:
        return torch.cuda.max_memory_allocated(device_index)

    def memory_reserved(self, device_index=None) -> int:
        return torch.cuda.memory_reserved(device_index)

    def max_memory_reserved(self, device_index=None) -> int:
        return torch.cuda.max_memory_reserved(device_index)

    def total_memory(self, device_index=None) -> int:
        return torch.cuda.get_device_properties(
            self.current_device() if device_index is None
            else device_index).total_memory

    def available_memory(self, device_index=None) -> int:
        free, _ = torch.cuda.mem_get_info(device_index)
        return int(free)

    def empty_cache(self):
        torch.cuda.empty_cache()

    def reset_peak_memory_stats(self, device_index=None):
        torch.cuda.reset_peak_memory_stats(device_index)

    # ---- dtype support ------------------------------------------------- #
    def is_bf16_supported(self) -> bool:
        return torch.cuda.is_available() and torch.cuda.is_bf16_supported()

    def is_fp16_supported(self) -> bool:
        return torch.cuda.is_available()

    # ---- graphs -------------------------------------------------------- #
    def is_triton_supported(self) -> bool:
        import importlib.util
        return (torch.cuda.is_available()
                and importlib.util.find_spec("triton") is not None)

    def create_graph(self):
        return torch.cuda.CUDAGraph()

    def capture_to_graph(self, graph, **kwargs):
        return torch.cuda.graph(graph, **kwargs)

    def replay_graph(self, graph):
        graph.replay()

    # ---- communication / availability ---------------------------------- #
    def communication_backend_name(self) -> str:
        return self._communication_backend_name

    def is_available(self) -> bool:
        return torch.cuda.is_available()

    def on_accelerator(self, tensor) -> bool:
        return isinstance(tensor, torch.Tensor) and tensor.is_cuda

    # ---- pinned host memory ------------------------------------------- #
    def pin_memory(self, tensor):
        return tensor.pin_memory()


class CPU_Accelerator(DeepSpeedAccelerator):
    """The host CPU, for tests and tools that ask for it by name."""

    def __init__(self):
        super().__init__()
        self._name = "cpu"
        self._communication_backend_name = "gloo"
        self._seed = 0

    def device_name(self, device_index: Optional[int] = None) -> str:
        return self._name

    def device(self, device_index: Optional[int] = None):
        return torch.device("cpu")

    def device_count(self) -> int:
        return 1

    def current_device(self) -> int:
        return 0

    def synchronize(self, device_index: Optional[int] = None):
        """Host execution is synchronous."""

    def manual_seed(self, seed: int):
        self._seed = int(seed)
        torch.manual_seed(self._seed)

    def initial_seed(self) -> int:
        return self._seed

    def memory_stats(self, device_index: Optional[int] = None) -> Dict:
        return {}

    def is_bf16_supported(self) -> bool:
        return True

    def is_fp16_supported(self) -> bool:
        return False

    def communication_backend_name(self) -> str:
        return self._communication_backend_name

    def is_available(self) -> bool:
        return True

    def on_accelerator(self, tensor) -> bool:
        return isinstance(tensor, torch.Tensor) and tensor.device.type == "cpu"

    def pin_memory(self, tensor):
        return tensor
