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

import json
import os

from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, DeepSpeedConfigError
from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
from deepspeed_tpu_torch.serving.config import DeepSpeedServingConfig
from deepspeed_tpu_torch.serving.engine import ServingEngine
from deepspeed_tpu_torch.version import __version__


def elastic_batch_config(config):
    """``config`` with the elastic agent's re-solved batch applied: when
    ``DS_ELASTIC_TRAIN_BATCH`` is set (``elasticity/elastic_agent.py`` sets
    it before each worker start) its ``train_batch_size`` and
    ``DS_ELASTIC_MICRO_BATCH``'s micro batch replace the config's, and the
    accumulation steps are solved again, as ``deepspeed_tpu/__init__.py:
    56-75`` does.  A path is read first; without the variable ``config`` is
    returned as it is."""
    if not os.environ.get("DS_ELASTIC_TRAIN_BATCH") or config is None:
        return config
    if isinstance(config, (str, os.PathLike)):
        if not os.path.isfile(config):
            raise FileNotFoundError(
                f"elastic restart: config file {config!r} not found "
                f"(agent working directory differs from the launch?)")
        with open(config) as f:
            config = json.load(f)
    config = dict(config)
    config["train_batch_size"] = int(os.environ["DS_ELASTIC_TRAIN_BATCH"])
    config["train_micro_batch_size_per_gpu"] = int(
        os.environ.get("DS_ELASTIC_MICRO_BATCH", config.get("train_micro_batch_size_per_gpu", 1)))
    config.pop("gradient_accumulation_steps", None)       # solved again
    from deepspeed_tpu_torch.utils.logging import log_dist
    log_dist(f"elastic restart: train_batch={config['train_batch_size']}, "
             f"micro={config['train_micro_batch_size_per_gpu']}", ranks=[0])
    return config


def autotuning_experiment_config(config):
    """``config``, or under the autotuner the experiment's own: when
    ``DS_AUTOTUNING_CONFIG`` names a file (the launcher's ``--autotuning``
    points each experiment, and ``run``'s final job, at the config it
    mutated), that file's JSON replaces ``config``, as
    ``deepspeed_tpu/__init__.py:47-56`` does."""
    from deepspeed_tpu_torch.autotuning.scheduler import CONFIG_PATH_ENV
    path = os.environ.get(CONFIG_PATH_ENV)
    if not (path and os.path.isfile(path)):
        return config
    with open(path) as f:
        config = json.load(f)
    from deepspeed_tpu_torch.utils.logging import log_dist
    log_dist(f"autotuning: using experiment config {path}", ranks=[0])
    return config


def initialize(model=None, config=None, model_parameters=None, lr_scheduler=None,
               device=None, seed: int = 42):
    """Build a training engine (``runtime/engine.py``) from a ds_config dict
    or JSON path; with ``WORLD_SIZE`` > 1, or at a ZeRO stage >= 1, it makes
    the process group first (``comm.init_distributed``).  Under the
    autotuner the experiment's config replaces ``config``
    (``autotuning_experiment_config``), then under the elastic agent the
    re-solved batch is applied (``elastic_batch_config``), in the JAX
    package's order.  Returns ``(engine, optimizer, training_dataloader,
    lr_scheduler)`` as the JAX package does; the optimizer object stands
    where JAX returns its optax transformation, and the dataloader is None
    in this slice."""
    config = elastic_batch_config(autotuning_experiment_config(config))
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
