"""Megatron-LM GPT checkpoints for inference (counterpart of
``deepspeed_tpu/module_inject/megatron.py``).

A Megatron checkpoint is a torch state dict with ``model.language_model``
names (nested, or flat with dotted keys) and a fused ``query_key_value``
whose row order depends on ``checkpoint_version``:

* 1.0: rows ``(num_heads, head_dim, 3)``;
* 2.0 and later: rows ``(num_heads, 3, head_dim)``.

Both are rearranged to the port's ``[E, q | k | v]`` columns, in numpy as
the JAX package does.  The version is read from the checkpoint's own
``checkpoint_version`` field when not given (2.0 when absent).  Merging
per-tensor-parallel-rank shards (several paths) waits for tensor
parallelism (ROADMAP.md, Queue 1 entry 5).
"""

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import resolve_device
from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig
from deepspeed_tpu_torch.utils.logging import log_dist

SCALE = "ROADMAP.md, Queue 1 entry 5 (merging tensor-parallel shards: runtime/state_dict_factory)"


def _qkv_to_fused(w: np.ndarray, b: Optional[np.ndarray], num_heads: int, version: float):
    """Megatron ``query_key_value`` ``[3E, E]`` (and ``[3E]`` bias) -> fused
    (``[E, 3E]``, ``[3E]``) with q | k | v blocks, head-major in each."""
    three_e, E = w.shape
    D = three_e // (3 * num_heads)

    def to_qkv_major(x, trailing):
        if version >= 2.0:                                # (H, 3, D, ...)
            return np.moveaxis(x.reshape((num_heads, 3, D) + trailing), 1, 0)
        return np.moveaxis(x.reshape((num_heads, D, 3) + trailing), 2, 0)   # v1: (H, D, 3)

    wq = to_qkv_major(w, (E,))
    fused_w = np.concatenate([wq[i].reshape(num_heads * D, E) for i in range(3)], axis=0).T
    fused_b = None
    if b is not None:
        bq = to_qkv_major(b, ())
        fused_b = np.concatenate([bq[i].reshape(-1) for i in range(3)])
    return fused_w, fused_b


def _flatten(sd: Dict) -> Dict[str, np.ndarray]:
    """Dot-flatten a (possibly nested) checkpoint dict and strip the
    ``model`` / ``module`` wrappers; leaves that are not arrays (args, rng
    state, the version scalar) are dropped."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}.")
            return
        if torch.is_tensor(node):
            node = node.detach().cpu().float().numpy() if node.is_floating_point() \
                else node.detach().cpu().numpy()
        if isinstance(node, np.ndarray):
            flat[prefix[:-1]] = node

    walk(sd, "")
    for prefix in ("module.", "model."):
        if any(k.startswith(prefix) for k in flat):
            flat = {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
    return flat


def load_megatron_gpt(state_dict: Union[Dict, Sequence[str]],
                      checkpoint_version: Optional[float] = None,
                      num_heads: Optional[int] = None, n_positions: Optional[int] = None,
                      dtype: Optional[torch.dtype] = None, device=None):
    """(GPT, its state dict) from a Megatron-LM GPT state dict (nested or
    dot-flat) or a single checkpoint path, in ``dtype`` (fp32 by default)
    on ``device`` (the current CUDA device by default).  ``num_heads`` is
    required: Megatron stores no head count, and the fused-QKV
    de-interleave depends on it."""
    if num_heads is None:
        raise ValueError("load_megatron_gpt needs num_heads= — Megatron checkpoints do not "
                         "encode the head count, and the fused-QKV row de-interleave "
                         "depends on it")
    if not isinstance(state_dict, dict):
        paths = list(state_dict)
        if len(paths) != 1:
            raise NotImplementedError(f"merging {len(paths)} per-rank Megatron shards is not "
                                      f"ported yet ({SCALE})")
        state_dict = torch.load(paths[0], map_location="cpu", weights_only=False)
    if checkpoint_version is None:
        cv = state_dict.get("checkpoint_version")
        checkpoint_version = float(cv) if cv is not None else 2.0
    sd = _flatten(state_dict)
    lm = "language_model."
    wte = sd[lm + "embedding.word_embeddings.weight"]
    wpe = sd[lm + "embedding.position_embeddings.weight"]
    V, E = wte.shape
    layer_prefix = lm + "transformer.layers."
    layer_ids = sorted({int(k[len(layer_prefix):].split(".")[0])
                        for k in sd if k.startswith(layer_prefix)})
    qkv0 = sd[lm + "transformer.layers.0.attention.query_key_value.weight"]
    if qkv0.shape != (3 * E, E):
        raise ValueError(f"query_key_value {qkv0.shape} does not fit hidden size {E}")
    H = num_heads
    dtype = dtype or torch.float32
    cfg = GPTConfig(vocab_size=V, n_positions=n_positions or wpe.shape[0], n_embd=E,
                    n_layer=len(layer_ids), n_head=H, activation="gelu", vocab_multiple=1,
                    dtype=dtype)
    dev = resolve_device(device)

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev, dtype)

    out: Dict[str, torch.Tensor] = {}
    for n, i in enumerate(layer_ids):
        b = f"{lm}transformer.layers.{i}."
        qkv_w, qkv_b = _qkv_to_fused(sd[b + "attention.query_key_value.weight"],
                                     sd.get(b + "attention.query_key_value.bias"), H,
                                     checkpoint_version)
        block = {"ln1_g": sd[b + "input_layernorm.weight"],
                 "ln1_b": sd[b + "input_layernorm.bias"],
                 "qkv_w": qkv_w,
                 "qkv_b": qkv_b if qkv_b is not None else np.zeros(qkv_w.shape[1], np.float32),
                 "out_w": sd[b + "attention.dense.weight"].T,
                 "out_b": sd[b + "attention.dense.bias"],
                 "ln2_g": sd[b + "post_attention_layernorm.weight"],
                 "ln2_b": sd[b + "post_attention_layernorm.bias"],
                 "fc_w": sd[b + "mlp.dense_h_to_4h.weight"].T,
                 "fc_b": sd[b + "mlp.dense_h_to_4h.bias"],
                 "proj_w": sd[b + "mlp.dense_4h_to_h.weight"].T,
                 "proj_b": sd[b + "mlp.dense_4h_to_h.bias"]}
        for k, v in block.items():
            out[f"blocks.{n}.{k}"] = put(v)
    out.update(wte=put(wte), wpe=put(wpe),
               lnf_g=put(sd[lm + "transformer.final_layernorm.weight"]),
               lnf_b=put(sd[lm + "transformer.final_layernorm.bias"]))
    log_dist(f"megatron-gpt import: L={len(layer_ids)} E={E} H={H} V={V} "
             f"(checkpoint_version={checkpoint_version})", ranks=[0])
    return GPT(cfg, device=dev, state_dict=out), out
