"""The inference engine (counterpart of ``deepspeed_tpu/inference/engine.py``)
over a model of the port's decode protocol (the GPT family: ``cfg``,
``apply_with_cache``, ``generate(..., prompt_len=)``, ``forward_logits``),
on one device.

* ``forward`` is the full-sequence logits in eval mode (an MoE model gates
  at ``moe_eval_capacity_factor``).
* ``generate`` is greedy decoding over the contiguous KV cache, through the
  decode kernel of ``ops/cuda/decode_attention.py`` on the card.  As in the
  JAX engine, the prompt is right-padded to a multiple of
  ``PROMPT_BUCKET`` and its true length passed on (falling back to the
  exact length near ``n_positions``), so an MoE gate sees the pad rows in
  the prefill as JAX's does.
* ``load_checkpoint`` takes the port's training checkpoints
  (``runtime/checkpointing.py``), cast to the engine's dtype (and
  quantized for int8), into a new model of the engine's own.

The model is served in the configured dtype on the engine's device: when
its weights differ in either (or ``params``, a state dict, is given), the
engine builds its own copy.  The engine never writes into the caller's
model.

A Hugging Face causal LM (duck-typed: ``.config.model_type`` and
``.state_dict()``) is converted through ``module_inject`` (its model
type's policy, or ``policy=``) into the port's GPT, its leaves placed on
the engine's device in the engine's dtype; caller-supplied ``params`` win
over the injected weights, as in JAX.  ``dtype: "int8"`` computes in bf16
and holds the block weights as int8 with per-channel scales
(``module_inject/quantization.py``), quantized after the cast, as JAX's
engine does.

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP
entry: ``tensor_parallel.tp_size > 1``, ``moe.ep_size > 1``,
``telemetry=`` / ``tracer=``, ``enable_cuda_graph: true``, and a model
that is neither the port's GPT family nor an HF decoder a policy takes;
sampled decoding (``temperature > 0``) raises in ``generate()``.  A config
key the engine does not read raises ``ValueError``.
"""

from typing import Dict, Optional

import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import resolve_device
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.models.gpt import model_in
from deepspeed_tpu_torch.module_inject.quantization import check_bits, quantize_gpt
from deepspeed_tpu_torch.module_inject.replace_module import inject_hf_model, is_hf_model
from deepspeed_tpu_torch.utils.logging import log_dist

MODELS = "ROADMAP.md, Queue 1 entry 8 (models/{bert,clip,resnet,simple}.py)"
SERVING = "ROADMAP.md, Queue 1 entry 4 (serving features: CUDA graphs of the decode step)"
SCALE = "ROADMAP.md, Queue 1 entry 5 (tensor and expert parallelism need comm/)"
PLANES = "ROADMAP.md, Queue 1 entry 7 (telemetry and tracing)"


class InferenceEngine:

    PROMPT_BUCKET = 64   # prompt lengths are padded up to multiples of this

    def __init__(self, model, config: Optional[DeepSpeedInferenceConfig] = None,
                 params: Optional[Dict[str, torch.Tensor]] = None, device=None,
                 policy=None, telemetry=None, tracer=None):
        cfg = config or DeepSpeedInferenceConfig()
        self._reject_unported(cfg, model, telemetry, tracer)
        self._config = cfg
        self.device = resolve_device(device)
        self.dtype = cfg.torch_dtype                 # bf16 for int8 weights
        self.quantize_weights = cfg.quantize_weights
        if is_hf_model(model):
            model, _ = inject_hf_model(model, policy=policy, dtype=self.dtype,
                                       device=self.device)
            log_dist("module_inject: replaced the HF model with the port's GPT", ranks=[0])
        self.module = self._placed(model_in(model, self.dtype, self.device, params))
        log_dist(f"InferenceEngine ready: dtype={self.dtype}, device={self.device}, "
                 f"int8 weights={self.quantize_weights}, "
                 f"kernel_inject={cfg.replace_with_kernel_inject}", ranks=[0])

    def _placed(self, model):
        """``model`` (already in the engine's dtype), its block weights
        quantized to int8 when the config asks for it."""
        return quantize_gpt(model) if self.quantize_weights else model

    @staticmethod
    def _reject_unported(cfg, model, telemetry, tracer):
        if cfg.unread_keys():
            raise ValueError(f"inference config keys {cfg.unread_keys()} are not read by the "
                             f"port's engine; it takes dtype, kernel_inject, "
                             f"tensor_parallel.tp_size, moe.ep_size, enable_cuda_graph and "
                             f"quant.enabled, quant.weight.enabled and quant.weight.num_bits")
        if cfg.quantize_weights:
            check_bits(cfg.quant.weight.num_bits)
        if int(cfg.tensor_parallel.tp_size) > 1:
            raise NotImplementedError(
                f"tensor_parallel.tp_size={cfg.tensor_parallel.tp_size} is not ported yet "
                f"({SCALE})")
        if int(cfg.moe.ep_size) > 1:
            raise NotImplementedError(f"moe.ep_size={cfg.moe.ep_size} is not ported yet "
                                      f"({SCALE})")
        if cfg.enable_cuda_graph:
            raise NotImplementedError(f"enable_cuda_graph is not ported yet ({SERVING})")
        if telemetry is not None or tracer is not None:
            raise NotImplementedError(f"inference telemetry and tracing are not ported yet "
                                      f"({PLANES})")
        if not (is_hf_model(model) or (hasattr(model, "cfg")
                                       and hasattr(model, "apply_with_cache"))):
            raise NotImplementedError(
                f"InferenceEngine takes the port's GPT family or a Hugging Face decoder "
                f"(module_inject); {type(model).__name__} is not ported yet ({MODELS})")

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def load_checkpoint(self, load_dir, tag=None):
        """Load the weights of a training checkpoint of the same model
        (the newest tag, or ``tag``), cast to the engine's dtype, into a
        model of the engine's own: the model it was given, which may hold
        a training engine's parameters, is left as it was."""
        from deepspeed_tpu_torch.runtime.checkpointing import load_params_only
        params = load_params_only(load_dir, tag)
        # an int8 model's weights by their unquantized names (a checkpoint
        # holds them in full precision; they are quantized again below)
        own = {name.removesuffix(".q8"): p.shape for name, p in self.module.named_parameters()
               if not name.endswith(".scale")}
        if set(params) != set(own):
            raise ValueError(f"checkpoint params {sorted(set(params) ^ set(own))[:5]} do not "
                             f"match the model's")
        for name, shape in own.items():
            src = torch.as_tensor(params[name])
            if src.shape != shape:
                raise ValueError(f"checkpoint param {name}: shape {tuple(src.shape)}, "
                                 f"expected {tuple(shape)}")
        self.module = self._placed(model_in(self.module, self.dtype, self.device, params))
        return self

    def _ids(self, input_ids) -> torch.Tensor:
        return torch.as_tensor(input_ids, device=self.device).long()

    def forward(self, input_ids, *args, attention_mask=None, **kwargs) -> torch.Tensor:
        """Full-sequence logits ``[B, S, padded_vocab]`` fp32."""
        if attention_mask is not None:
            raise ValueError("this model's forward path does not accept attention_mask")
        return self.module.forward_logits(self._ids(input_ids))

    __call__ = forward

    def generate(self, input_ids, max_new_tokens: int = 32, temperature: float = 0.0,
                 rng=None, **kwargs) -> torch.Tensor:
        """Greedy generation, ``[B, S + max_new_tokens]`` (prompt included),
        the prompt right-padded to a multiple of ``PROMPT_BUCKET``."""
        ids = self._ids(input_ids)
        B, S = ids.shape
        S_pad = max(self.PROMPT_BUCKET, -(-S // self.PROMPT_BUCKET) * self.PROMPT_BUCKET)
        if S_pad + max_new_tokens > self.module.cfg.n_positions:
            # the padded prompt would not fit the cache: the exact length
            return self.module.generate(ids, max_new_tokens, temperature=temperature)
        padded = torch.cat([ids, ids.new_zeros(B, S_pad - S)], dim=1)
        out = self.module.generate(padded, max_new_tokens, temperature=temperature,
                                   prompt_len=S)
        return torch.cat([out[:, :S], out[:, S_pad:]], dim=1)


def init_inference(model=None, config=None, **kwargs):
    """Build an :class:`InferenceEngine` from a config dict and kwargs
    (the JAX package's ``init_inference``): ``params`` (a state dict),
    ``device`` and ``policy`` (or ``injection_policy``: an
    ``InjectionPolicy`` for an HF model) are engine arguments, the rest
    config keys."""
    cfg_dict = dict(config or {})
    cfg_dict.update(kwargs)
    params = cfg_dict.pop("params", None)
    device = cfg_dict.pop("device", None)
    telemetry = cfg_dict.pop("telemetry", None)
    tracer = cfg_dict.pop("tracer", None)
    policy = cfg_dict.pop("injection_policy", cfg_dict.pop("policy", None))
    if cfg_dict.pop("mesh", None) is not None:
        raise NotImplementedError(f"init_inference(mesh=...) is not ported yet ({SCALE})")
    return InferenceEngine(model, config=DeepSpeedInferenceConfig(**cfg_dict), params=params,
                           device=device, policy=policy, telemetry=telemetry, tracer=tracer)
