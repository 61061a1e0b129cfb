"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

Counterpart of ``deepspeed_tpu/__init__.py``.  Three entry points:
training (``initialize`` -> ``DeepSpeedEngine.train_batch``, the GPT
families, dense and mixture-of-experts, at ZeRO stages 0-3 with CPU
offload over ``torch.distributed``, one process a device, with the
hand-written flash attention, cross-entropy and fused AdamW kernels),
serving (``init_serving`` / ``ServingEngine`` over the paged KV arena, with
the paged decode kernel) and inference (``init_inference`` /
``InferenceEngine``: forward and greedy ``generate`` over the contiguous KV
cache, with the contiguous decode kernel; a Hugging Face decoder through
``module_inject``, and int8 weights with ``dtype="int8"``).  Entry points
run on the current CUDA device unless the caller passes ``device="cpu"``.
"""

from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, DeepSpeedConfigError
from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
from deepspeed_tpu_torch.serving.config import DeepSpeedServingConfig
from deepspeed_tpu_torch.serving.engine import ServingEngine
from deepspeed_tpu_torch.version import __version__


def initialize(model=None, config=None, model_parameters=None, lr_scheduler=None,
               device=None, seed: int = 42):
    """Build a training engine (``runtime/engine.py``) from a ds_config dict
    or JSON path; with ``WORLD_SIZE`` > 1, or at a ZeRO stage >= 1, it makes
    the process group first (``comm.init_distributed``).  Returns ``(engine, optimizer, training_dataloader,
    lr_scheduler)`` as the JAX package does; the optimizer object stands
    where JAX returns its optax transformation, and the dataloader is None
    in this slice."""
    engine = DeepSpeedEngine(model=model, config=config, model_parameters=model_parameters,
                             lr_scheduler=lr_scheduler, device=device, seed=seed)
    return engine, engine.optimizer, None, engine.lr_scheduler


def init_inference(model=None, config=None, **kwargs):
    """Build an InferenceEngine (``inference/``) from a config dict +
    kwargs (``params=``, ``device=``, ``policy=``).  ``model`` is the
    port's GPT or a Hugging Face causal LM (``module_inject``)."""
    from deepspeed_tpu_torch.inference.engine import init_inference as _init
    return _init(model=model, config=config, **kwargs)


def init_serving(model=None, config=None, **kwargs):
    """Build a continuous-batching ServingEngine (``serving/``) from a
    ``{"serving": {...}}`` config dict + kwargs."""
    from deepspeed_tpu_torch.serving.engine import init_serving as _init
    return _init(model=model, config=config, **kwargs)


__all__ = ["DeepSpeedConfig", "DeepSpeedConfigError", "DeepSpeedEngine",
           "DeepSpeedInferenceConfig", "DeepSpeedServingConfig", "InferenceEngine",
           "ServingEngine", "__version__", "initialize", "init_inference", "init_serving"]
