"""Inference config (counterpart of ``deepspeed_tpu/inference/config.py``):
the keys of the JAX package's JSON surface that the port reads or refuses,
``torch_dtype`` in the place of ``jnp_dtype``.

What the port does not take raises in the engine, naming its ROADMAP
entry: ``dtype: "int8"`` (int8 weights), ``tensor_parallel.tp_size > 1``,
``moe.ep_size > 1`` and ``enable_cuda_graph: true`` (the JAX package
accepts and ignores it, since XLA already replays a compiled program; on
the card a graph of the decode step is work still to do).  Any other key
(``max_out_tokens``, ``checkpoint``, ``quant``, ``seed``, ...) is one the
port does not read, and the engine refuses it (``unread_keys``) rather
than drop it silently.
"""

from typing import List

from pydantic import Field

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel


class DeepSpeedTPConfig(DeepSpeedConfigModel):
    tp_size: int = 1


class DeepSpeedMoEConfig(DeepSpeedConfigModel):
    ep_size: int = 1


class DeepSpeedInferenceConfig(DeepSpeedConfigModel):
    replace_with_kernel_inject: bool = Field(False, alias="kernel_inject")
    dtype: str = "bfloat16"
    tensor_parallel: DeepSpeedTPConfig = Field(DeepSpeedTPConfig(), alias="tp")
    enable_cuda_graph: bool = False
    moe: DeepSpeedMoEConfig = DeepSpeedMoEConfig()

    @property
    def torch_dtype(self):
        from deepspeed_tpu_torch.models.gpt import as_torch_dtype
        return as_torch_dtype(str(self.dtype).replace("torch.", ""))

    def unread_keys(self) -> List[str]:
        """The keys given that no field takes, nested ones dotted."""
        keys = list(self.model_extra or {})
        for name in ("tensor_parallel", "moe"):
            keys += [f"{name}.{k}" for k in getattr(self, name).model_extra or {}]
        return keys
