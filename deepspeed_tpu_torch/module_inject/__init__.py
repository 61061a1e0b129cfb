"""module_inject: Hugging Face and Megatron-LM decoders for inference
(counterpart of ``deepspeed_tpu/module_inject/``).

* policies (``policies.py``): per-architecture weight-layout converters
  from HF GPT-2, OPT, GPT-Neo, BLOOM, LLaMA, GPT-J and GPT-NeoX to the
  port's GPT family;
* ``inject_hf_model`` / ``replace_transformer_layer`` / ``is_hf_model``
  (``replace_module.py``);
* ``load_megatron_gpt`` (``megatron.py``);
* int8 weight-only quantization (``quantization.py``).

``AutoTP`` waits for tensor parallelism (ROADMAP.md, Queue 1 entry 5); the
encoder policies wait for ``models/{bert,clip}.py`` (entry 8).
"""

from deepspeed_tpu_torch.module_inject.megatron import load_megatron_gpt
from deepspeed_tpu_torch.module_inject.policies import (HFBloomPolicy, HFGPT2Policy,
                                                        HFGPTJPolicy, HFGPTNeoPolicy,
                                                        HFGPTNeoXPolicy, HFLlamaPolicy,
                                                        HFOPTPolicy, InjectionPolicy,
                                                        policy_for_model)
from deepspeed_tpu_torch.module_inject.quantization import (QUANT_KEYS, dequantize_weight,
                                                            is_quantized_leaf,
                                                            quantize_block_params,
                                                            quantize_gpt, quantize_weight)
from deepspeed_tpu_torch.module_inject.replace_module import (inject_hf_model, is_hf_model,
                                                              replace_transformer_layer)
