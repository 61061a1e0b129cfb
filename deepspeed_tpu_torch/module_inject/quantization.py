"""int8 weight-only quantization for inference (counterpart of
``deepspeed_tpu/module_inject/quantization.py``).

Block matmul weights (``QUANT_KEYS``) are stored as an int8 payload with
per-output-channel fp32 scales, ``{"q8": int8[..., in, out], "scale":
f32[..., 1, out]}``: symmetric over the input axis, ``scale = max(max |w|,
1e-12) / 127``, ``q8 = clip(round(w / scale), -128, 127)`` with round half
to even, as ``jnp.round`` does.  ``models/gpt.py:_dense`` dequantizes a
quantized leaf at its product (``q8`` and ``scale`` cast to the compute
dtype and multiplied, as JAX's ``_wget`` does), so the same model code
serves fp and int8 weights.

``dtype: "int8"`` on the inference config triggers it: the weights are cast
to the compute dtype (bf16) first, then quantized, as JAX's engine does.
On the card the dequantize is a plain PyTorch product before cuBLAS's matmul
(JAX leaves it to XLA; no TPU kernel answers to it); a fused W8A16 product
is ROADMAP work.  ``quantize_partition_specs`` waits for tensor
parallelism (ROADMAP.md, Queue 1 entry 5).
"""

from typing import Dict, Sequence

import torch

from deepspeed_tpu_torch.models.gpt import GPT, QUANT_KEYS


def is_quantized_leaf(x) -> bool:
    return isinstance(x, dict) and "q8" in x and "scale" in x


def check_bits(bits: int) -> None:
    if bits != 8:
        raise NotImplementedError(
            f"int8 weight quantization takes 8 bits, got {bits} (int4 goes through "
            "ops/quantizer.py: ROADMAP.md, Queue 1 entry 8)")


def quantize_weight(w: torch.Tensor, bits: int = 8) -> Dict[str, torch.Tensor]:
    """Per-output-channel symmetric int8 of ``w`` ``[..., in, out]``: the
    scale over the penultimate (input) axis, in fp32."""
    check_bits(bits)
    wf = w.float()
    scale = wf.abs().amax(dim=-2, keepdim=True).clamp(min=1e-12) / 127.0
    q = torch.round(wf / scale).clamp(-128, 127).to(torch.int8)
    return {"q8": q, "scale": scale}


def dequantize_weight(leaf: Dict[str, torch.Tensor], dt: torch.dtype) -> torch.Tensor:
    return leaf["q8"].to(dt) * leaf["scale"].to(dt)


def quantize_block_params(params, keys: Sequence[str] = QUANT_KEYS, bits: int = 8):
    """Quantize the named weight leaves anywhere in a parameter tree (dict
    keys matched by name, any nesting, lists of blocks included); every
    other leaf is kept as it is."""
    if isinstance(params, dict):
        return {k: quantize_weight(v, bits) if k in keys and torch.is_tensor(v) and v.dim() >= 2
                else quantize_block_params(v, keys, bits) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(quantize_block_params(v, keys, bits) for v in params)
    return params


def quantize_gpt(model, keys: Sequence[str] = QUANT_KEYS, bits: int = 8):
    """A new :class:`~deepspeed_tpu_torch.models.gpt.GPT` on ``model``'s
    device whose block weights named in ``keys`` are quantized (a leaf at a
    time, so at most one weight's fp32 copy exists beside the model); every
    other leaf is shared with ``model``, which is left as it is."""
    sd = {}
    for name, p in model.named_parameters():
        if name.startswith("blocks.") and name.rsplit(".", 1)[-1] in keys and p.dim() >= 2:
            q = quantize_weight(p.detach(), bits)
            sd[name + ".q8"], sd[name + ".scale"] = q["q8"], q["scale"]
        else:
            sd[name] = p.detach()
    return GPT(model.cfg, device=model.device, state_dict=sd)
