"""Inference config (counterpart of ``deepspeed_tpu/inference/config.py``):
the keys of the JAX package's JSON surface that the port reads or refuses,
``torch_dtype`` in the place of ``jnp_dtype``.

``dtype: "int8"`` is weight-only int8 (``module_inject/quantization.py``):
compute in bf16, the block weights quantized when ``quant.enabled`` and
``quant.weight.enabled`` (both default true), as the JAX engine reads
them; ``quant.weight.num_bits`` other than 8 raises.

``seed`` seeds ``generate``'s sampler (``temperature > 0``) on every
call, as the JAX engine's ``PRNGKey(seed)`` does.  ``replace_method``,
``triangular_masking`` (``tm``), ``return_tuple`` and ``max_out_tokens``
are keys the JAX engine accepts and does not read: the port takes them at
JAX's defaults (``JAX_DEFAULTS``) so a JAX ds_config loads, and refuses
any other value by name.

What the port does not take raises in the engine, naming its ROADMAP
entry: ``tensor_parallel.tp_size > 1``, ``moe.ep_size > 1`` and
``enable_cuda_graph: true`` (the JAX package accepts and ignores it, since
XLA already replays a compiled program; on the card a graph of the decode
step is work still to do).  Any other key (``checkpoint``,
``min_out_tokens``, ``quant.activation``, ...) is one the port does not
read, and the engine refuses it (``unread_keys``) rather than drop it
silently.
"""

from typing import Any, ClassVar, Dict, List

import torch
from pydantic import Field

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel


class DeepSpeedTPConfig(DeepSpeedConfigModel):
    tp_size: int = 1


class DeepSpeedMoEConfig(DeepSpeedConfigModel):
    ep_size: int = 1


class WeightQuantConfig(DeepSpeedConfigModel):
    enabled: bool = True
    num_bits: int = 8


class QuantizationConfig(DeepSpeedConfigModel):
    enabled: bool = True
    weight: WeightQuantConfig = WeightQuantConfig()


class DeepSpeedInferenceConfig(DeepSpeedConfigModel):
    replace_with_kernel_inject: bool = Field(False, alias="kernel_inject")
    dtype: str = "bfloat16"
    tensor_parallel: DeepSpeedTPConfig = Field(DeepSpeedTPConfig(), alias="tp")
    enable_cuda_graph: bool = False
    moe: DeepSpeedMoEConfig = DeepSpeedMoEConfig()
    quant: QuantizationConfig = QuantizationConfig()
    seed: int = 0
    # accepted at JAX's defaults only (see the module docstring)
    replace_method: str = "auto"
    triangular_masking: bool = Field(True, alias="tm")
    return_tuple: bool = True
    max_tokens: int = Field(1024, alias="max_out_tokens")

    JAX_DEFAULTS: ClassVar[Dict[str, Any]] = {"replace_method": "auto", "triangular_masking": True,
                                               "return_tuple": True, "max_out_tokens": 1024}

    def off_default_keys(self) -> Dict[str, Any]:
        """The keys of ``JAX_DEFAULTS`` given another value."""
        fields = {"max_out_tokens": "max_tokens"}
        return {name: getattr(self, fields.get(name, name))
                for name, default in self.JAX_DEFAULTS.items()
                if getattr(self, fields.get(name, name)) != default}

    @property
    def int8(self) -> bool:
        return str(self.dtype).replace("torch.", "") == "int8"

    @property
    def torch_dtype(self):
        """The compute dtype: bf16 for int8 weights."""
        from deepspeed_tpu_torch.models.gpt import as_torch_dtype
        return torch.bfloat16 if self.int8 else as_torch_dtype(
            str(self.dtype).replace("torch.", ""))

    @property
    def quantize_weights(self) -> bool:
        """int8 weights, as the JAX engine decides it."""
        return self.int8 and self.quant.enabled and self.quant.weight.enabled

    def unread_keys(self) -> List[str]:
        """The keys given that no field takes, nested ones dotted."""
        keys = list(self.model_extra or {})
        for name in ("tensor_parallel", "moe", "quant", "quant.weight"):
            node = self
            for part in name.split("."):
                node = getattr(node, part)
            keys += [f"{name}.{k}" for k in node.model_extra or {}]
        return keys
