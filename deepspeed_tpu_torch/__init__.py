"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

Counterpart of ``deepspeed_tpu/__init__.py``.  This slice serves GPT-2
through the paged KV arena: ``init_serving`` / ``ServingEngine`` /
``DeepSpeedServingConfig``, with hand-written CUDA decode-attention kernels
for Hopper (``ops/cuda/``).  ``initialize`` and ``init_inference`` come in
later slices (ROADMAP.md).  Entry points run on the current CUDA device
unless the caller passes ``device="cpu"``.
"""

from deepspeed_tpu_torch.serving.config import DeepSpeedServingConfig
from deepspeed_tpu_torch.serving.engine import ServingEngine
from deepspeed_tpu_torch.version import __version__


def init_serving(model=None, config=None, **kwargs):
    """Build a continuous-batching ServingEngine (``serving/``) from a
    ``{"serving": {...}}`` config dict + kwargs."""
    from deepspeed_tpu_torch.serving.engine import init_serving as _init
    return _init(model=model, config=config, **kwargs)


__all__ = ["DeepSpeedServingConfig", "ServingEngine", "__version__",
           "init_serving"]
