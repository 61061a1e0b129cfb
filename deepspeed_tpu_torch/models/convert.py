"""JAX GPT parameters and optimizer state -> the port's GPT and optimizer (no
JAX file answers to this one; it reads the pytree of
``deepspeed_tpu/models/gpt.py:init_gpt_params`` and optax's
``ScaleByAdamState``), and the JAX ``SimpleModel``'s flax tree -> the
port's ``models/simple.py`` (``simple_params_from_jax``).

The JAX pytree is ``{"wte", "wpe", "lnf_g", "lnf_b", "blocks"}`` (no
``wpe`` with rope or ALiBi positions; ``lm_head`` and ``lm_head_b`` with an
untied head) where ``blocks`` holds stacked ``[n_layer, ...]`` leaves
(``scan_layers=True``) or one ``{"h<i>": {...}}`` dict per layer; the
leaves' widths are the family's (a GQA qkv, a SwiGLU gate | up).  An int8
tree (JAX's ``init_inference(dtype="int8")``) holds ``{"q8", "scale"}``
dicts in place of the block weights; they become ``blocks.<i>.qkv_w.q8``
and ``blocks.<i>.qkv_w.scale``.  An MoE
block holds a nested ``moe`` subtree (``gate.wg``, ``experts.{wi, bi, wo,
bo}`` stacked over experts) in place of ``fc_*`` / ``proj_*``; its leaves
become ``blocks.<i>.moe.gate.wg`` and so on.  Leaves may be numpy arrays or
anything ``numpy.asarray`` reads (JAX arrays included); this module imports
no JAX.

Layout: the ``[in, out]`` weight layout of JAX's ``h @ W`` is KEPT — the
port applies weights as ``h @ W`` too, so no leaf is transposed.  Values and
dtypes are carried over exactly (bf16 leaves stay bf16).

Used by the parity tests and by anyone loading JAX checkpoints into the
port.
"""

from typing import Any, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig, cast_leaf

# every leaf outside ``blocks`` a family's tree may hold
TREE_TOP_KEYS = ("wte", "wpe", "lnf_g", "lnf_b", "lm_head", "lm_head_b")


def _tensor(x) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":   # numpy has no bf16: go through fp32, exactly
        return torch.tensor(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(arr)


def _block_leaves(block: Dict) -> Dict[str, Any]:
    """One block's (or the stacked blocks') leaves by dotted path: the
    ``moe`` subtree is walked, an int8 weight (``{"q8", "scale"}``, JAX's
    ``module_inject/quantization.py``) becomes ``<key>.q8`` and
    ``<key>.scale``, any other leaf is taken as it is."""
    out = {}
    for k, v in block.items():
        if isinstance(v, dict) and set(v) == {"q8", "scale"}:
            out[f"{k}.q8"], out[f"{k}.scale"] = v["q8"], v["scale"]
        elif isinstance(v, dict) and k != "moe":
            raise ValueError(f"block leaf {k}: a dict of {sorted(v)} is neither an int8 weight "
                             "({'q8', 'scale'}) nor the moe subtree")
        elif k == "moe" and isinstance(v, dict):
            stack = [("moe", v)]
            while stack:
                path, node = stack.pop(0)
                if isinstance(node, dict):
                    stack += [(f"{path}.{name}", child) for name, child in node.items()]
                else:
                    out[path] = node
        else:
            out[k] = v
    return out


def params_from_jax(tree: Dict) -> Dict[str, torch.Tensor]:
    """JAX GPT pytree -> state dict with :class:`GPT`'s keys (``"wte"``,
    ``"blocks.<i>.qkv_w"``, ...), CPU tensors, weights ``[in, out]``.  The
    tree's own top-level leaves are carried over; :class:`GPT` checks them
    against its config."""
    extra = sorted(set(tree) - set(TREE_TOP_KEYS) - {"blocks"})
    if extra:
        raise ValueError(f"unknown top-level leaves {extra}")
    sd = {name: _tensor(tree[name]) for name in TREE_TOP_KEYS if name in tree}
    blocks = tree["blocks"]
    if "h0" in blocks:                       # scan_layers=False: one dict per layer
        for i in range(len(blocks)):
            for k, leaf in _block_leaves(blocks[f"h{i}"]).items():
                sd[f"blocks.{i}.{k}"] = _tensor(leaf)
        return sd
    stacked = {k: _tensor(leaf) for k, leaf in _block_leaves(blocks).items()}
    n_layer = next(iter(stacked.values())).shape[0]
    for i in range(n_layer):
        for k, leaf in stacked.items():
            sd[f"blocks.{i}.{k}"] = leaf[i].clone()
    return sd


def gpt_from_jax(cfg: GPTConfig, tree: Dict, device=None,
                 dtype: Optional[torch.dtype] = None) -> GPT:
    """A :class:`GPT` holding the JAX parameters ``tree`` on ``device``
    (default: the current CUDA device), optionally cast to ``dtype``."""
    sd = params_from_jax(tree)
    if dtype is not None:
        sd = {k: cast_leaf(k, v, dtype, v.device) for k, v in sd.items()}
    return GPT(cfg, device=device, state_dict=sd)


def simple_params_from_jax(tree: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``SimpleModel`` parameters (flax's ``{"Dense_<i>": {"kernel",
    "bias"}}``, kernels ``[in, out]``) -> a state dict with
    ``models/simple.py:SimpleModel``'s keys (``"Dense_<i>.kernel"``), CPU
    tensors, the ``[in, out]`` layout kept (the port applies ``h @ kernel``
    too)."""
    sd = {}
    for name, layer in tree.items():
        if not (name.startswith("Dense_") and isinstance(layer, dict)
                and set(layer) == {"kernel", "bias"}):
            raise ValueError(f"not a SimpleModel leaf: {name} "
                             f"({sorted(layer) if isinstance(layer, dict) else type(layer)})")
        for leaf in ("kernel", "bias"):
            sd[f"{name}.{leaf}"] = _tensor(layer[leaf])
    return sd


def adam_state_from_jax(opt_state) -> Dict[str, Any]:
    """optax Adam state -> the port's optimizer state
    (``runtime/optimizers.py:FusedAdam.load_state_dict``): ``{"mu": state
    dict, "nu": state dict, "count": int}``, with :class:`GPT`'s keys for a
    GPT tree (as ``params_from_jax`` names them) and the tree's own keys for
    a flat dict of arrays.

    ``opt_state`` is a ``ScaleByAdamState`` (fields ``mu``, ``nu``,
    ``count``) or an optax chain state holding exactly one such entry, as
    the JAX engine keeps in ``engine.state.opt_state``."""
    if not all(hasattr(opt_state, f) for f in ("mu", "nu", "count")):
        found = [s for s in opt_state if all(hasattr(s, f) for f in ("mu", "nu", "count"))]
        if len(found) != 1:
            raise ValueError(f"expected one Adam state (mu, nu, count) in the optimizer "
                             f"state, found {len(found)}")
        opt_state = found[0]

    def state_dict(tree):
        if "wte" in tree:
            return params_from_jax(tree)
        return {name: _tensor(leaf) for name, leaf in tree.items()}
    return {"mu": state_dict(opt_state.mu), "nu": state_dict(opt_state.nu),
            "count": int(np.asarray(opt_state.count))}
