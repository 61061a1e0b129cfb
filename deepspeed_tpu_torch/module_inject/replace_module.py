"""Swap a Hugging Face decoder for the port's GPT (counterpart of
``deepspeed_tpu/module_inject/replace_module.py``).

The whole model is replaced at once by the port's GPT family (one block
code path over per-layer leaves, decoding through the paged and contiguous
attention kernels), its weights converted by the model type's policy
(``policies.py``), as the JAX package replaces it by its fused scan
program.
"""

from typing import Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.models.gpt import GPT
from deepspeed_tpu_torch.module_inject.policies import (_POLICIES, ENCODER_TYPES, ENCODERS,
                                                        InjectionPolicy, policy_for_model)


def inject_hf_model(hf_model, policy: Optional[InjectionPolicy] = None,
                    dtype: Optional[torch.dtype] = None,
                    device=None) -> Tuple[GPT, Dict[str, torch.Tensor]]:
    """Convert an HF causal LM into ``(GPT, its state dict)``: the model
    holds the converted leaves (in ``dtype``, fp32 by default, on
    ``device``, the current CUDA device by default) and implements the
    inference engine's decode protocol, so ``init_inference(hf_model)``
    serves it through the decode kernels."""
    policy = policy or policy_for_model(hf_model)
    if policy is None:
        mt = getattr(getattr(hf_model, "config", None), "model_type", None)
        supported = sorted({t for pol in _POLICIES for t in pol.model_types})
        msg = (f"no injection policy for model_type={mt!r}; supported: "
               f"{', '.join(supported)} — pass policy= for a custom architecture")
        if mt in ENCODER_TYPES:
            raise NotImplementedError(f"{msg} (the encoder policies are not ported yet: "
                                      f"{ENCODERS})")
        raise ValueError(msg)
    cfg, sd = policy.build(hf_model, dtype=dtype or torch.float32, device=device)
    model = GPT(cfg, device=next(iter(sd.values())).device, state_dict=sd)
    return model, sd


def replace_transformer_layer(model, checkpoint=None, policy=None, dtype=None, device=None):
    """The reference-named entry point: the replacement model and its
    state dict.  ``checkpoint`` is unused (the weights come from the live
    model)."""
    return inject_hf_model(model, policy=policy, dtype=dtype, device=device)


def is_hf_model(model) -> bool:
    """Duck-typed HF detection (has ``.config.model_type`` and
    ``.state_dict``)."""
    return (hasattr(model, "state_dict")
            and hasattr(getattr(model, "config", None), "model_type"))
