"""The inference engine (counterpart of ``deepspeed_tpu/inference/engine.py``)
over a model of the port's decode protocol (the GPT family: ``cfg``,
``apply_with_cache``, ``generate(..., prompt_len=)``, ``forward_logits``),
on one device.

* ``forward`` is the full-sequence logits in eval mode (an MoE model gates
  at ``moe_eval_capacity_factor``).
* ``generate`` decodes over the contiguous KV cache, through the decode
  kernel of ``ops/cuda/decode_attention.py`` on the card: greedy, or at
  ``temperature > 0`` sampled with Gumbel noise from a generator seeded by
  the config's ``seed`` on every call (or ``rng=``, a ``torch.Generator``),
  as the JAX engine draws from ``PRNGKey(seed)``.  As in the JAX engine,
  the prompt is right-padded to a multiple of ``PROMPT_BUCKET`` and its
  true length passed on (falling back to the exact length near
  ``n_positions``), so an MoE gate sees the pad rows in the prefill as
  JAX's does.
* ``load_checkpoint`` takes the port's training checkpoints
  (``runtime/checkpointing.py``), cast to the engine's dtype (and
  quantized for int8), into a new model of the engine's own.

The model is served in the configured dtype on the engine's device: when
its weights differ in either (or ``params``, a state dict, is given), the
engine builds its own copy.  The engine never writes into the caller's
model.

Telemetry (``deepspeed_tpu/inference/engine.py:37-52,159-202,336-346``):
``telemetry=`` is a ``TelemetryHub`` (shared with a training engine) or a
``telemetry`` config dict to build a standalone hub from (with ``tracing:
true`` and no ``tracer=``, a tracer too), which the engine owns: its
``close()`` flushes and closes that hub and exports the tracer to
``trace_dir``; with a hub, every
``forward`` / ``generate`` emits an ``inference_request`` record (op,
latency, batch, new tokens, tokens/s), which waits for that request's own
output (``torch.cuda.Event.synchronize`` on an event recorded after it,
not the whole device) — with none, the engine never waits.  ``tracer=``
(else the global tracer) gets the ``inference.forward``,
``inference.generate``, ``inference.prefill`` and ``inference.decode``
spans.  JAX's ``program_cache_evict`` event has no counterpart: the port
compiles no per-shape programs, so there is no program cache to evict.

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
``enable_cuda_graph: true``, and a model
that is neither the port's GPT family nor an HF decoder a policy takes.
A config key the engine does not read, or one of JAX's ignored keys at
another value than JAX's default, raises ``ValueError``.
"""

import time
from typing import Dict, Optional

import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import resolve_device
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.models.gpt import model_in
from deepspeed_tpu_torch.module_inject.quantization import check_bits, quantize_gpt
from deepspeed_tpu_torch.module_inject.replace_module import inject_hf_model, is_hf_model
from deepspeed_tpu_torch.telemetry.hub import telemetry_from_arg
from deepspeed_tpu_torch.telemetry.tracing import maybe_span
from deepspeed_tpu_torch.utils.logging import log_dist

MODELS = "ROADMAP.md, Queue 1 entry 8 (models/{bert,clip,resnet,simple}.py)"
SERVING = "ROADMAP.md, Queue 1 entry 4 (serving features: CUDA graphs of the decode step)"
SCALE = "ROADMAP.md, Queue 1 entry 5 (tensor and expert parallelism need comm/)"


class InferenceEngine:

    PROMPT_BUCKET = 64   # prompt lengths are padded up to multiples of this

    def __init__(self, model, config: Optional[DeepSpeedInferenceConfig] = None,
                 params: Optional[Dict[str, torch.Tensor]] = None, device=None,
                 policy=None, telemetry=None, tracer=None):
        cfg = config or DeepSpeedInferenceConfig()
        self._reject_unported(cfg, model)
        self._config = cfg
        # per-request records; None (the default) keeps serving fully
        # asynchronous — the engine then never waits on the device
        self.telemetry = telemetry
        # span tracing; None falls back to the process-global tracer
        self.tracer = tracer
        self._owned_telemetry = None    # init_inference sets it for a dict-built hub
        self._request_count = 0
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
    def _reject_unported(cfg, model):
        if cfg.unread_keys():
            raise ValueError(f"inference config keys {cfg.unread_keys()} are not read by the "
                             f"port's engine; it takes dtype, kernel_inject, "
                             f"tensor_parallel.tp_size, moe.ep_size, enable_cuda_graph, seed "
                             f"and quant.enabled, quant.weight.enabled and "
                             f"quant.weight.num_bits")
        if cfg.off_default_keys():
            raise ValueError(f"inference config {cfg.off_default_keys()}: these keys are not "
                             f"read by the port's engine (nor by the JAX package's); it takes "
                             f"them at JAX's defaults {cfg.JAX_DEFAULTS} only")
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

    def close(self):
        """Close a hub that ``init_inference`` built from a config dict
        (final flush, ops-server shutdown) and export a tracer it built.
        Idempotent; a hub passed in is its owner's to close."""
        owned, self._owned_telemetry = self._owned_telemetry, None
        if owned is not None:
            owned.close()

    def _record_request(self, op, t0, out, new_tokens=0):
        """Per-request telemetry record.  Waits for the request's own output
        (an event recorded after it on the current stream, not the whole
        device) to get a true end-to-end latency; with no hub it returns
        at once and nothing waits."""
        if self.telemetry is None:
            return out
        # the decode span covers device-side token generation: it opens at
        # dispatch return and closes when the request's output is ready
        with maybe_span("inference.decode", tracer=self.tracer, op=op, new_tokens=new_tokens):
            if out.is_cuda:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(out.device))
                done.synchronize()
        dt = max(time.perf_counter() - t0, 1e-9)
        rec = {"op": op, "latency_ms": dt * 1000.0}
        if out.ndim >= 1:
            rec["batch"] = int(out.shape[0])
        if new_tokens:
            rec["new_tokens"] = int(new_tokens)
            rec["tokens_per_sec"] = new_tokens / dt
        self._request_count += 1
        self.telemetry.emit("inference_request", rec, step=self._request_count)
        return out

    def _ids(self, input_ids) -> torch.Tensor:
        return torch.as_tensor(input_ids, device=self.device).long()

    def forward(self, input_ids, *args, attention_mask=None, **kwargs) -> torch.Tensor:
        """Full-sequence logits ``[B, S, padded_vocab]`` fp32."""
        if attention_mask is not None:
            raise ValueError("this model's forward path does not accept attention_mask")
        ids = self._ids(input_ids)
        t0 = time.perf_counter()
        with maybe_span("inference.forward", tracer=self.tracer, batch=int(ids.shape[0]),
                        seq=int(ids.shape[1]), masked=False):
            return self._record_request("forward", t0, self.module.forward_logits(ids))

    __call__ = forward

    def generate(self, input_ids, max_new_tokens: int = 32, temperature: float = 0.0,
                 rng=None, noise=None, **kwargs) -> torch.Tensor:
        """Greedy (or, at ``temperature > 0``, sampled) generation,
        ``[B, S + max_new_tokens]`` (prompt included), the prompt
        right-padded to a multiple of ``PROMPT_BUCKET``.  ``rng`` is a
        ``torch.Generator`` on the engine's device (default: one seeded by
        the config's ``seed``); ``noise`` replays given Gumbel draws
        (``models/gpt.py:gpt_generate``)."""
        ids = self._ids(input_ids)
        B, S = ids.shape
        if rng is None and noise is None and temperature and temperature > 0:
            rng = torch.Generator(device=self.device).manual_seed(int(self._config.seed))
        sample = dict(temperature=temperature, generator=rng, noise=noise)
        S_pad = max(self.PROMPT_BUCKET, -(-S // self.PROMPT_BUCKET) * self.PROMPT_BUCKET)
        bucketed = S_pad + max_new_tokens <= self.module.cfg.n_positions
        t0 = time.perf_counter()
        with maybe_span("inference.generate", tracer=self.tracer, batch=B, prompt_len=S,
                        max_new_tokens=max_new_tokens, bucketed=bucketed):
            if not bucketed:
                # the padded prompt would not fit the cache: the exact length
                with maybe_span("inference.prefill", tracer=self.tracer, batch=B,
                                prompt_len=S):
                    out = self.module.generate(ids, max_new_tokens, **sample)
            else:
                # prefill = the host's dispatch of the prefill + decode
                # launches; the device's completion is the decode span
                # inside _record_request
                padded = torch.cat([ids, ids.new_zeros(B, S_pad - S)], dim=1)
                with maybe_span("inference.prefill", tracer=self.tracer, batch=B,
                                prompt_len=S, bucket=S_pad):
                    out = self.module.generate(padded, max_new_tokens, prompt_len=S, **sample)
                out = torch.cat([out[:, :S], out[:, S_pad:]], dim=1)
            return self._record_request("generate", t0, out, new_tokens=B * max_new_tokens)


def init_inference(model=None, config=None, **kwargs):
    """Build an :class:`InferenceEngine` from a config dict and kwargs
    (the JAX package's ``init_inference``): ``params`` (a state dict),
    ``device`` and ``policy`` (or ``injection_policy``: an
    ``InjectionPolicy`` for an HF model), ``telemetry`` (a hub, or a
    ``telemetry`` config dict to build one from, which the engine's
    ``close()`` closes) and ``tracer`` are engine arguments, the rest
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
    cfg = DeepSpeedInferenceConfig(**cfg_dict)
    telemetry, tracer, owned = telemetry_from_arg(telemetry, tracer, resolve_device(device))
    try:
        eng = InferenceEngine(model, config=cfg, params=params, device=device, policy=policy,
                              telemetry=telemetry, tracer=tracer)
    except BaseException:
        if owned is not None:
            owned.close()
        raise
    eng._owned_telemetry = owned
    return eng
