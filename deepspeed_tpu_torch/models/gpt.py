"""The GPT family for training, generate() and the serving engine
(counterpart of ``deepspeed_tpu/models/gpt.py``).

Ported here: the config, the presets and the family constructors
(``gpt_config``, ``llama_config``, ``bloom_config``), the seeded init, the
training forward and loss (``gpt_block``, ``gpt_forward``,
``chunked_cross_entropy``, ``gpt_loss``), the KV-cache path of
``generate()`` and the paged serving step, with the JAX package's names and
layouts.  Weights keep JAX's ``[in, out]`` layout and are applied as
``h @ W``.  The functions take a parameter tree shaped like the JAX pytree,
except that ``blocks`` is a list of per-layer dicts instead of stacked
``[n_layer, ...]`` leaves (the layer loop is a Python loop; ``scan_layers``
has no meaning here); :class:`GPT` is an ``nn.Module`` that owns such a
tree and has the JAX ``GPT`` object's methods (``__call__(params, batch,
rng, train)`` is the training loss).

One block serves the dense families, as in JAX: GPT-2 (learned positions,
layernorm, gelu MLP, tied head), LLaMA-style (rope, RMSNorm, SwiGLU,
bias-free, grouped-query attention, untied head), BLOOM (ALiBi),
GPT-NeoX-style parallel blocks and GPT-J-style single-norm parallel blocks
(untied head with a bias).  With ``moe_num_experts > 0`` each block's MLP
is a gated bank of GELU experts (``moe/``; JAX's ``_ffn``): top-1 or top-2
gating at ``moe_capacity_factor`` in training and
``moe_eval_capacity_factor`` otherwise, over every token a call is given
(padding and idle serving slots included, as in JAX), and the blocks' aux
losses summed into ``gpt_loss`` times ``moe_aux_coeff``.  In training the
gating noise (RTS priorities, gumbel draws) is drawn from the ``rng``
generator before each block's checkpointed body and handed to it as
tensors, so the recompute routes as the forward did.

The training path (``gpt_forward``, ``gpt_loss``) and the serving paths
(``generate()``, ``gpt_paged_step``) take every family knob: rope at
positions ``arange(S)``, GQA K/V handed to the attention op unexpanded,
ALiBi as per-head slopes the attention op applies itself, the untied head
and its bias through the cross-entropy kernels.

Where JAX updated a cache with ``dynamic_update_slice`` or a scatter, the
port writes into the cache tensor in place (no second cache in memory).

Plain large products (qkv, out, fc, proj, the gate and the experts' batched
products), the norms, the activations, rope, the embedding gather, the
gating and the argmax are PyTorch calls.  Attention
goes through the CUDA kernels of ``ops/cuda/decode_attention.py`` when
decoding (GQA against the un-expanded ``Hkv`` cache, ALiBi as per-head
slopes the kernels apply themselves) and through ``ops/attention.py`` when
training (the reference up to 256 tokens, the flash kernels of
``ops/cuda/flash_attention.py`` above, fed the ``[B, S, H, D]`` views of
the qkv product without copies); the training loss goes through the fused
cross-entropy kernels of ``ops/cuda/cross_entropy.py`` on the card.  An
int8 model (``init_inference(dtype="int8")``) holds its block weights as
``<key>.q8`` and ``<key>.scale`` leaves, dequantized at each product.
Training knobs not ported yet (random-LTD, activation quantization,
dropout, progressive layer drop) raise ``NotImplementedError`` naming
their ROADMAP item.
"""

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.accelerator.real_accelerator import resolve_device
from deepspeed_tpu_torch.moe.experts import FFNExpert
from deepspeed_tpu_torch.moe.layer import MoE
from deepspeed_tpu_torch.moe.sharded_moe import draw_noise
from deepspeed_tpu_torch.ops.attention import alibi_slopes, get_attention_fn
from deepspeed_tpu_torch.ops.cuda.cross_entropy import (ce_logits, cross_entropy,
                                                        label_logit)
from deepspeed_tpu_torch.ops.cuda.decode_attention import (decode_attention,
                                                           paged_attention)
from deepspeed_tpu_torch.ops.cuda import capture
from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing import checkpoint

TRAINING = "ROADMAP.md, Queue 1 item 9 (data pipeline, compression, progressive layer drop)"
DROPOUT = ("ROADMAP.md, Queue 1 item 4: dropout in training (its random streams "
           "cannot match JAX's; no config on the training path uses it)")
# the unchunked cross-entropy holds one [N, V] fp32 logits block up to this size
CE_CHUNK_BYTES = 900 * 2 ** 20

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16, "fp16": torch.float16,
           "float32": torch.float32, "fp32": torch.float32,
           "float": torch.float32}


def as_torch_dtype(dt) -> torch.dtype:
    """A torch dtype from a torch dtype, a name (``"bfloat16"``) or a numpy
    dtype-like."""
    if isinstance(dt, torch.dtype):
        return dt
    name = getattr(dt, "__name__", None) or getattr(dt, "name", None) or str(dt)
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {dt!r}; expected one of "
                         f"{sorted(_DTYPES)}") from None


_ACTIVATIONS = {
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),   # GPT-2's gelu_new
    "gelu": F.gelu,
    "relu": F.relu,
    "gelu_quick": lambda x: x * torch.sigmoid(1.702 * x),   # CLIP's quick_gelu
}


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dropout: float = 0.0
    scan_layers: bool = True
    remat: bool = False
    attn_impl: str = "auto"
    dtype: Any = torch.bfloat16
    activation: str = "gelu_tanh"
    ln_eps: float = 1e-5
    untied_head: bool = False
    ltd_keep: Optional[int] = None
    ltd_layers: Optional[Tuple[int, ...]] = None
    position_encoding: str = "learned"
    norm: str = "layernorm"
    mlp_type: str = "standard"
    intermediate_size: Optional[int] = None
    use_bias: bool = True
    rope_theta: float = 10000.0
    n_kv_head: Optional[int] = None
    vocab_multiple: int = 128
    block_type: str = "sequential"
    rope_dim: Optional[int] = None
    rope_interleaved: bool = False
    head_bias: bool = False
    activation_quant_bits: Optional[int] = None
    activation_quant_type: str = "symmetric"
    moe_num_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_eval_capacity_factor: float = 2.0
    moe_min_capacity: int = 4
    moe_aux_coeff: float = 0.01
    moe_expert_hidden: Optional[int] = None

    def __post_init__(self):
        self.dtype = as_torch_dtype(self.dtype)
        self.padded_vocab = int(
            math.ceil(self.vocab_size / self.vocab_multiple) * self.vocab_multiple)
        if self.n_embd % self.n_head:
            raise ValueError(f"n_embd {self.n_embd} not divisible by n_head "
                             f"{self.n_head}")
        self.head_dim = self.n_embd // self.n_head
        self.kv_heads = self.n_kv_head or self.n_head
        if self.n_head % self.kv_heads:
            raise ValueError(f"n_head {self.n_head} not divisible by n_kv_head "
                             f"{self.kv_heads}")
        self.qkv_dim = (self.n_head + 2 * self.kv_heads) * self.head_dim
        self.ffn_dim = self.intermediate_size or 4 * self.n_embd
        self.expert_hidden = self.moe_expert_hidden or self.ffn_dim
        for knob, allowed in (("position_encoding", ("learned", "rope", "alibi")),
                              ("norm", ("layernorm", "rmsnorm")),
                              ("mlp_type", ("standard", "swiglu")),
                              ("block_type", ("sequential", "parallel",
                                              "parallel_single_ln")),
                              ("activation", tuple(_ACTIVATIONS))):
            if getattr(self, knob) not in allowed:
                raise ValueError(f"GPTConfig.{knob}={getattr(self, knob)!r}; "
                                 f"expected one of {allowed}")
        if self.head_bias and not self.untied_head:
            raise ValueError("head_bias needs untied_head: the bias belongs "
                             "to the lm_head leaf")
        if self.moe_num_experts and self.moe_top_k not in (1, 2):
            raise ValueError(f"GPTConfig.moe_top_k={self.moe_top_k!r}; only top-1 and "
                             f"top-2 gating are defined")
        self._reject_unported()

    def _reject_unported(self):
        training = {"ltd_keep": self.ltd_keep, "ltd_layers": self.ltd_layers,
                    "activation_quant_bits": self.activation_quant_bits}
        for knob, value in training.items():
            if value is not None:
                raise NotImplementedError(
                    f"GPTConfig.{knob}={value!r} is not ported yet ({TRAINING})")


# Model zoo (GPT-2 sizes; the 1.5B "xl" is the north-star model).
GPT_PRESETS: Dict[str, Dict] = {
    "tiny":        dict(vocab_size=512, n_positions=128, n_embd=64, n_layer=2, n_head=4),
    "gpt2":        dict(n_embd=768, n_layer=12, n_head=12),
    "gpt2-medium": dict(n_embd=1024, n_layer=24, n_head=16),
    "gpt2-large":  dict(n_embd=1280, n_layer=36, n_head=20),
    "gpt2-xl":     dict(n_embd=1600, n_layer=48, n_head=25),
}


def gpt_config(preset: str = "gpt2", **overrides) -> GPTConfig:
    kw = dict(GPT_PRESETS[preset])
    kw.update(overrides)
    return GPTConfig(**kw)


def llama_config(vocab_size=32000, n_positions=2048, n_embd=512, n_layer=4,
                 n_head=8, intermediate_size=None, **overrides) -> GPTConfig:
    """LLaMA-style family: rope + RMSNorm + SwiGLU, bias-free, untied head
    (JAX's defaults)."""
    kw = dict(vocab_size=vocab_size, n_positions=n_positions, n_embd=n_embd,
              n_layer=n_layer, n_head=n_head,
              position_encoding="rope", norm="rmsnorm", mlp_type="swiglu",
              use_bias=False, untied_head=True,
              intermediate_size=intermediate_size or int(n_embd * 8 / 3),
              activation="gelu")
    kw.update(overrides)
    return GPTConfig(**kw)


def bloom_config(vocab_size=250880, n_positions=2048, n_embd=512, n_layer=4,
                 n_head=8, **overrides) -> GPTConfig:
    """BLOOM family: ALiBi positions, gelu MLP, tied embeddings (JAX's
    defaults)."""
    kw = dict(vocab_size=vocab_size, n_positions=n_positions, n_embd=n_embd,
              n_layer=n_layer, n_head=n_head,
              position_encoding="alibi", activation="gelu_tanh")
    kw.update(overrides)
    return GPTConfig(**kw)


# --------------------------------------------------------------------------- #
# Parameter construction
# --------------------------------------------------------------------------- #
BLOCK_KEYS = ("ln1_g", "ln1_b", "qkv_w", "qkv_b", "out_w", "out_b",
              "ln2_g", "ln2_b", "fc_w", "fc_b", "proj_w", "proj_b")
# an MoE block's leaves in place of the MLP's (``fc_*``, ``proj_*``), by
# their path in JAX's nested ``moe`` subtree
MOE_KEYS = ("moe.gate.wg", "moe.experts.wi", "moe.experts.bi", "moe.experts.wo",
            "moe.experts.bo")


# the weights an int8 model holds quantized (the large 2-D matmul operands of
# a block, JAX's set), each as two leaves: ``<key>.q8`` and ``<key>.scale``
QUANT_KEYS = ("qkv_w", "out_w", "fc_w", "proj_w")


def block_keys(cfg: "GPTConfig", quantized: bool = False) -> Tuple[str, ...]:
    """One block's leaves, dotted paths into its tree (``moe.gate.wg``;
    ``qkv_w.q8`` and ``qkv_w.scale`` for a quantized weight)."""
    keys = BLOCK_KEYS if not cfg.moe_num_experts else BLOCK_KEYS[:8] + MOE_KEYS
    if not quantized:
        return keys
    return tuple(leaf for k in keys
                 for leaf in ((k + ".q8", k + ".scale") if k in QUANT_KEYS else (k,)))


def get_leaf(tree: Dict, path: str):
    for part in path.split("."):
        tree = tree[part]
    return tree


def nest(flat: Dict[str, Any]) -> Dict:
    """``{"moe.gate.wg": t, ...}`` -> ``{"moe": {"gate": {"wg": t}}, ...}``,
    in ``flat``'s order."""
    tree: Dict = {}
    for path, leaf in flat.items():
        *parents, name = path.split(".")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[name] = leaf
    return tree


def top_keys(cfg: GPTConfig) -> Tuple[str, ...]:
    """The tree's leaves outside ``blocks``: ``wpe`` only with learned
    positions, ``lm_head`` (and ``lm_head_b``) only with an untied head."""
    keys = ["wte"] + (["wpe"] if cfg.position_encoding == "learned" else [])
    keys += ["lnf_g", "lnf_b"]
    if cfg.untied_head:
        keys += ["lm_head"] + (["lm_head_b"] if cfg.head_bias else [])
    return tuple(keys)


def fc_width(cfg: GPTConfig) -> int:
    """Width of the dense MLP's first product: SwiGLU fuses gate | up.  An
    MoE block has no such product (its experts are ``expert_hidden`` wide),
    but JAX's parameter count counts it in place of the bank."""
    return 2 * cfg.ffn_dim if cfg.mlp_type == "swiglu" else cfg.ffn_dim


def leaf_shapes(cfg: GPTConfig, quantized: bool = False
                ) -> Tuple[Dict[str, tuple], Dict[str, tuple]]:
    """(top-level leaf shapes, one block's leaf shapes by dotted path) of
    ``cfg``'s tree.  Bias leaves exist (as zeros) when ``use_bias`` is off,
    as in JAX; an MoE block's expert leaves are stacked ``[experts, ...]``;
    a quantized weight's scale is ``[1, out]``."""
    E, I, V, F_ = cfg.n_embd, cfg.ffn_dim, cfg.padded_vocab, fc_width(cfg)
    NE, H = cfg.moe_num_experts, cfg.expert_hidden
    top = {"wte": (V, E), "wpe": (cfg.n_positions, E), "lnf_g": (E,),
           "lnf_b": (E,), "lm_head": (V, E), "lm_head_b": (V,)}
    block = {"ln1_g": (E,), "ln1_b": (E,), "qkv_w": (E, cfg.qkv_dim),
             "qkv_b": (cfg.qkv_dim,), "out_w": (E, E), "out_b": (E,),
             "ln2_g": (E,), "ln2_b": (E,), "fc_w": (E, F_), "fc_b": (F_,),
             "proj_w": (I, E), "proj_b": (E,), "moe.gate.wg": (E, NE),
             "moe.experts.wi": (NE, E, H), "moe.experts.bi": (NE, H),
             "moe.experts.wo": (NE, H, E), "moe.experts.bo": (NE, E)}
    for k in QUANT_KEYS:
        block[k + ".q8"], block[k + ".scale"] = block[k], (1, block[k][-1])
    return ({k: top[k] for k in top_keys(cfg)},
            {k: block[k] for k in block_keys(cfg, quantized)})


def _normal(shape, scale: float, gen: torch.Generator,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


def _init_block(cfg: GPTConfig, gen: torch.Generator,
                dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """One block's params (GPT-2 init: residual projections scaled by
    1/sqrt(2L)), on ``gen.device``: drawn in fp32, stored in ``dtype``.  An
    MoE block's MLP is the gate (std 0.02) and the stacked experts (JAX's
    ``FFNExpert`` init: std 1/sqrt(fan_in), zero biases)."""
    dev = gen.device
    _, shapes = leaf_shapes(cfg)
    proj_scale = 0.02 / math.sqrt(2 * cfg.n_layer)
    scale = {"qkv_w": 0.02, "out_w": proj_scale, "fc_w": 0.02, "proj_w": proj_scale,
             "moe.gate.wg": 0.02}
    out = {}
    for k in block_keys(cfg):
        if k in scale:
            out[k] = _normal(shapes[k], scale[k], gen, dtype)
        elif k.startswith("moe.experts."):
            continue
        else:                           # norm gains ones, biases zeros
            fill = torch.ones if k.endswith("_g") else torch.zeros
            out[k] = fill(shapes[k], device=dev, dtype=dtype)
    if cfg.moe_num_experts:
        bank = FFNExpert(cfg.n_embd, cfg.expert_hidden).init_params(
            gen, cfg.moe_num_experts, dtype)
        out.update({f"moe.experts.{k}": v for k, v in bank.items()})
    return nest({k: out[k] for k in block_keys(cfg)})


def init_gpt_params(cfg: GPTConfig, generator: torch.Generator,
                    dtype: torch.dtype = torch.float32) -> Dict:
    """Parameter tree from ``generator`` (same distributions as the JAX
    init; not the same numbers), on the generator's device.  Each leaf is
    drawn in fp32 and cast to ``dtype`` before the next is drawn, so a
    bf16 tree never has an fp32 copy beside it (the values are the fp32
    tree's, rounded)."""
    E, dev = cfg.n_embd, generator.device
    tree = {"wte": _normal((cfg.padded_vocab, E), 0.02, generator, dtype)}
    if cfg.position_encoding == "learned":
        tree["wpe"] = _normal((cfg.n_positions, E), 0.01, generator, dtype)
    tree["lnf_g"] = torch.ones(E, device=dev, dtype=dtype)
    tree["lnf_b"] = torch.zeros(E, device=dev, dtype=dtype)
    tree["blocks"] = [_init_block(cfg, generator, dtype) for _ in range(cfg.n_layer)]
    if cfg.untied_head:
        tree["lm_head"] = _normal((cfg.padded_vocab, E), 0.02, generator, dtype)
        if cfg.head_bias:
            tree["lm_head_b"] = torch.zeros(cfg.padded_vocab, device=dev, dtype=dtype)
    return tree


# --------------------------------------------------------------------------- #
# Forward pieces
# --------------------------------------------------------------------------- #
def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    # fp32 statistics regardless of activation dtype (bf16-safe)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * g + b).to(x.dtype)


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in fp32, cast back to ``x``'s dtype."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf * g.float()).to(x.dtype)


def _norm(cfg: GPTConfig, x: torch.Tensor, g: torch.Tensor,
          b: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return rms_norm(x, g, eps=cfg.ln_eps)
    return layer_norm(x, g, b, eps=cfg.ln_eps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
               rope_dim: Optional[int] = None,
               interleaved: bool = False) -> torch.Tensor:
    """Rotary position embedding on ``x`` ``[B, S, H, D]``, in fp32, with
    JAX's arithmetic: ``freqs = (1/theta) ** (i / half)``.  Half-split
    (LLaMA / NeoX) pairing by default, GPT-J's rotate-every-two with
    ``interleaved``; ``rope_dim`` rotates only the first features.
    ``positions`` is ``[S]`` (shared by the batch) or ``[B, S]`` (per row:
    the serving step, where every slot sits at its own position)."""
    D = x.shape[-1]
    rd = rope_dim or D
    xr = x[..., :rd].float()
    half = rd // 2
    freqs = (1.0 / theta) ** (torch.arange(half, dtype=torch.float32,
                                           device=x.device) / half)
    angles = positions[..., None].float() * freqs      # [(B,) S, half]
    cos, sin = angles.cos(), angles.sin()
    if angles.dim() == 2:            # [S, half] -> broadcast over the batch
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:                            # [B, S, half] -> per-row positions
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    if interleaved:
        x1, x2 = xr[..., 0::2], xr[..., 1::2]
        rot = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                          dim=-1).reshape(xr.shape)
    else:
        x1, x2 = xr[..., :half], xr[..., half:]
        rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    if rd == D:
        return rot.to(x.dtype)
    return torch.cat([rot.to(x.dtype), x[..., rd:]], dim=-1)


def _split_qkv(cfg: GPTConfig, qkv: torch.Tensor):
    """[B, S, qkv_dim] -> q [B,S,H,D], k/v [B,S,Hkv,D] (q|k|v order)."""
    B, S = qkv.shape[:2]
    H, Hkv, D = cfg.n_head, cfg.kv_heads, cfg.head_dim
    q, k, v = torch.split(qkv, [H * D, Hkv * D, Hkv * D], dim=-1)
    return (q.reshape(B, S, H, D), k.reshape(B, S, Hkv, D),
            v.reshape(B, S, Hkv, D))


def _dense(cfg: GPTConfig, p: Dict, h: torch.Tensor, name: str, dt) -> torch.Tensor:
    """``h @ <name>_w`` plus ``<name>_b`` unless the family is bias-free.  An
    int8 weight (``{"q8", "scale"}``) is dequantized to ``dt`` first, as
    JAX's ``_wget`` does."""
    w = p[name + "_w"]
    if isinstance(w, dict):
        from deepspeed_tpu_torch.module_inject.quantization import dequantize_weight
        w = dequantize_weight(w, dt)
    y = h @ w.to(dt)
    return y + p[name + "_b"].to(dt) if cfg.use_bias else y


def _mlp(cfg: GPTConfig, p: Dict, h: torch.Tensor, dt) -> torch.Tensor:
    up = _dense(cfg, p, h, "fc", dt)
    if cfg.mlp_type == "swiglu":
        gate, val = up.chunk(2, dim=-1)
        h = F.silu(gate) * val
    else:
        h = _ACTIVATIONS[cfg.activation](up)
    return _dense(cfg, p, h, "proj", dt)


def moe_layer(cfg: GPTConfig) -> MoE:
    """The MoE layer of ``cfg``'s blocks: the gate and GELU expert bank
    that JAX's ``_ffn`` builds from the same fields."""
    return MoE(cfg.n_embd, num_experts=cfg.moe_num_experts, k=cfg.moe_top_k,
               capacity_factor=cfg.moe_capacity_factor,
               eval_capacity_factor=cfg.moe_eval_capacity_factor,
               min_capacity=cfg.moe_min_capacity, expert_hidden=cfg.expert_hidden)


def _ffn(cfg: GPTConfig, p: Dict, h: torch.Tensor, dt, train: bool = False,
         noise: Optional[Dict[str, torch.Tensor]] = None
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The dense MLP, or the block's MoE layer (JAX's ``_ffn``) over every
    row of ``h``.  Returns (y, the gate's aux loss, None for a dense
    block).  ``noise``: the gating uniforms (``moe/sharded_moe.py``), used
    in training only."""
    if not cfg.moe_num_experts:
        return _mlp(cfg, p, h, dt), None
    y, l_aux, _ = moe_layer(cfg)(p["moe"], h, train=train, noise=noise)
    return y.to(dt), l_aux


def _block(cfg: GPTConfig, p: Dict, x: torch.Tensor, dt, attend: Callable,
           rope_pos: Optional[torch.Tensor] = None, train: bool = False,
           noise: Optional[Dict[str, torch.Tensor]] = None
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One block on ``x`` ``[B, S, E]``; returns (x, the MoE aux loss or
    None).  ``attend(q, k, v)`` gives o ``[B, S, H, D]`` (it also writes k
    and v to a cache where there is one); with rope, q and k are rotated at
    ``rope_pos`` first.  Topology: sequential (x + attn, then + mlp),
    parallel (GPT-NeoX: x + attn(ln1 x) + mlp(ln2 x)) or parallel_single_ln
    (GPT-J: one norm feeds both)."""
    B, S, E = x.shape
    h = _norm(cfg, x, p["ln1_g"], p["ln1_b"])
    q, k, v = _split_qkv(cfg, _dense(cfg, p, h, "qkv", dt))
    if cfg.position_encoding == "rope":
        q, k = (apply_rope(t, rope_pos, cfg.rope_theta, cfg.rope_dim,
                           cfg.rope_interleaved) for t in (q, k))
    o = _dense(cfg, p, attend(q, k, v).reshape(B, S, E), "out", dt)
    if cfg.block_type == "sequential":
        x = x + o
        f, aux = _ffn(cfg, p, _norm(cfg, x, p["ln2_g"], p["ln2_b"]), dt, train, noise)
        return x + f, aux
    if cfg.block_type == "parallel":
        f, aux = _ffn(cfg, p, _norm(cfg, x, p["ln2_g"], p["ln2_b"]), dt, train, noise)
        return x + o + f, aux
    f, aux = _ffn(cfg, p, h, dt, train, noise)
    return x + o + f, aux


def _embed(cfg: GPTConfig, params: Dict, input_ids: torch.Tensor,
           pos: torch.Tensor, dt) -> torch.Tensor:
    """Token embedding, plus the learned position embedding where the
    family has one; ``pos`` broadcasts against ``input_ids``."""
    x = params["wte"].to(dt)[input_ids]
    if cfg.position_encoding != "learned":
        return x
    return x + params["wpe"].to(dt)[pos.clamp(0, cfg.n_positions - 1)]


def _head(cfg: GPTConfig, params: Dict, x: torch.Tensor, dt) -> torch.Tensor:
    """Final norm and the head: the tied embedding, or the untied lm_head
    (plus its bias); fp32 logits."""
    x = _norm(cfg, x, params["lnf_g"], params["lnf_b"])
    head = params["lm_head"] if cfg.untied_head else params["wte"]
    logits = (x @ head.to(dt).T).float()
    if cfg.head_bias:
        logits = logits + params["lm_head_b"].float()
    return logits


@functools.lru_cache(maxsize=None)
def _alibi_on(n_head: int, device: str) -> torch.Tensor:
    return torch.from_numpy(alibi_slopes(n_head)).to(device)


def _alibi(cfg: GPTConfig, device) -> Optional[torch.Tensor]:
    """Per-head ALiBi slopes ``[H]`` fp32 for the attention kernels, or
    None.  Made once per device and kept, so a captured training step reads
    them without a host copy in the capture (and holds them)."""
    if cfg.position_encoding != "alibi":
        return None
    return capture.hold(_alibi_on(cfg.n_head, str(torch.device(device))))


def _vocab_masked(cfg: GPTConfig, logits: torch.Tensor) -> torch.Tensor:
    if cfg.padded_vocab != cfg.vocab_size:
        vmask = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab_size
        logits = torch.where(vmask, logits, -1e30)
    return logits


def greedy_tokens(cfg: GPTConfig, logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the real vocab (padded columns masked to -1e30)."""
    return _vocab_masked(cfg, logits).argmax(dim=-1)


def gumbel_noise(shape, generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """fp32 Gumbel noise ``-log(-log(u))``, ``u`` uniform in ``[tiny, 1)``
    from ``generator`` (JAX's ``jax.random.gumbel`` draws the same
    distribution from its own bits)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))


def sampled_tokens(cfg: GPTConfig, logits: torch.Tensor, temperature: float,
                   noise: torch.Tensor) -> torch.Tensor:
    """A draw from ``softmax(logits / temperature)`` over the real vocab:
    ``argmax(logits / T + g)`` with Gumbel ``g`` — what
    ``jax.random.categorical`` computes."""
    return (_vocab_masked(cfg, logits.float()) / temperature + noise).argmax(dim=-1)


# --------------------------------------------------------------------------- #
# Training: forward and loss
# --------------------------------------------------------------------------- #
def gpt_block(cfg: GPTConfig, p: Dict, x: torch.Tensor, attention_fn: Callable,
              train: bool = False, noise: Optional[Dict[str, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One block of the family on ``x`` ``[B, S, E]`` (JAX's ``gpt_block``):
    rope at positions ``arange(S)``, grouped K/V to the attention op as
    they are, ALiBi as the family's per-head slopes.  Returns (x, the MoE
    aux loss; None for a dense block)."""
    S = x.shape[1]
    rope_pos = (torch.arange(S, device=x.device) if cfg.position_encoding == "rope"
                else None)
    slopes = _alibi(cfg, x.device)
    return _block(cfg, p, x, x.dtype,
                  lambda q, k, v: attention_fn(q, k, v, causal=True, alibi=slopes), rope_pos,
                  train, noise)


def _block_noise(cfg: GPTConfig, rng, train: bool, noise, i: int, tokens: int):
    """Block ``i``'s gating noise: ``noise[i]`` where the caller pins it,
    else drawn from the ``rng`` generator in training (MoE blocks only)."""
    if not (train and cfg.moe_num_experts):
        return None
    if noise is not None:
        return noise[i]
    if isinstance(rng, torch.Generator):
        return draw_noise(rng, tokens, cfg.moe_num_experts, cfg.moe_top_k)
    return None


def gpt_forward(cfg: GPTConfig, params: Dict, input_ids: torch.Tensor,
                rng=None, train: bool = False,
                attention_fn: Optional[Callable] = None,
                pld_theta=None, return_hidden: bool = False, with_aux: bool = False,
                noise: Optional[List[Dict[str, torch.Tensor]]] = None):
    """Logits ``[B, S, padded_vocab]`` fp32 (the head's bias added), or
    with ``return_hidden`` the final-norm hidden ``[B, S, E]`` that the
    training loss takes; with ``with_aux``, (that, the blocks' summed MoE
    aux loss).  With ``cfg.remat`` each block keeps its input and the flash
    op's o and lse, and re-runs the rest (rope, the norms, the MLP or the
    experts) in the backward pass (JAX's checkpoint policy).  MoE training
    noise: block i's ``noise[i]`` (the uniforms of ``moe/sharded_moe.py``;
    a test's hook), else drawn from ``rng``, a ``torch.Generator``, before
    the block's body, else none."""
    if pld_theta is not None:
        raise NotImplementedError(f"progressive layer drop is not ported yet ({TRAINING})")
    if train and cfg.dropout:
        raise NotImplementedError(f"dropout={cfg.dropout} is not ported yet ({DROPOUT})")
    attention_fn = attention_fn or get_attention_fn(cfg.attn_impl)
    dt = cfg.dtype
    S = input_ids.shape[1]
    x = _embed(cfg, params, input_ids.long(),
               torch.arange(S, device=input_ids.device)[None], dt)

    def body(p, x, block_noise):
        # a ZeRO-3 engine passes each block as a callable that gathers its
        # leaves: called here, inside the checkpoint, it gathers again for
        # the recompute
        return gpt_block(cfg, p() if callable(p) else p, x, attention_fn, train, block_noise)
    aux_total = None
    for i, p in enumerate(params["blocks"]):
        n = _block_noise(cfg, rng, train, noise, i, input_ids.numel())
        x, aux = checkpoint(body, p, x, n) if cfg.remat else body(p, x, n)
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    out = (_norm(cfg, x, params["lnf_g"], params["lnf_b"]) if return_hidden
           else _head(cfg, params, x, dt))
    if not with_aux:
        return out
    if aux_total is None:
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    return out, aux_total


def chunked_cross_entropy(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                          vocab_size: int, n_chunks: int = 0,
                          head_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy of the hidden ``x`` ``[B, S, E]``
    against ``head`` ``[V, E]`` (plus the head bias ``head_b`` ``[V]`` in
    fp32), padded vocab columns masked with ``-1e9``.

    On the card this is always the fused kernel (``ops/cuda/cross_entropy.py``),
    which never materializes logits and raises on a dtype or width it does
    not take (the JAX gate's mesh test has no meaning at world size 1).
    Elsewhere it is the JAX package's
    chunked path: one ``[N, V]`` block when it fits ``CE_CHUNK_BYTES``
    (``n_chunks=1``), else row chunks recomputed in the backward pass."""
    B, S, E = x.shape
    V = head.shape[0]
    N = B * S
    if x.is_cuda:
        return cross_entropy(x.reshape(N, E), head, labels.reshape(N).to(torch.int32),
                             vocab_size, head_b=head_b)
    if n_chunks <= 0:
        if N * V * 4 <= CE_CHUNK_BYTES:
            n_chunks = 1
        else:
            n_chunks = max(1, -(-N // max(1, CE_CHUNK_BYTES // (4 * V))))
    if n_chunks == 1:
        logits = ce_logits(x.reshape(N, E), head, vocab_size, head_b=head_b)
        lse = torch.logsumexp(logits, dim=-1)
        return (lse - label_logit(logits, labels.reshape(N))).mean()
    # rows padded up to n_chunks * rows; pad rows are masked out of the sum
    rows = -(-N // n_chunks)
    n_pad = n_chunks * rows - N
    xf, lf = x.reshape(N, E), labels.reshape(N)
    if n_pad:
        xf = torch.cat([xf, xf.new_zeros(n_pad, E)])
        lf = torch.cat([lf, lf.new_zeros(n_pad)])
    valid = (torch.arange(n_chunks * rows, device=x.device) < N).reshape(n_chunks, rows)

    def chunk(xc, lc, keep):
        logits = ce_logits(xc, head, vocab_size, head_b=head_b)
        nll = torch.logsumexp(logits, dim=-1) - label_logit(logits, lc)
        return torch.where(keep, nll, 0.0).sum()

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for xc, lc, keep in zip(xf.reshape(n_chunks, rows, E), lf.reshape(n_chunks, rows), valid):
        total = total + checkpoint(chunk, xc, lc, keep)
    return total / N


def gpt_loss(cfg: GPTConfig, params: Dict, input_ids: torch.Tensor,
             labels: torch.Tensor, rng=None, train: bool = True,
             attention_fn: Optional[Callable] = None, pld_theta=None,
             noise: Optional[List[Dict[str, torch.Tensor]]] = None) -> torch.Tensor:
    """Next-token cross-entropy over the head: the tied ``wte``, or the
    untied ``lm_head`` and its bias (no ``[B, S, V]`` logits tensor on the
    card); an MoE model adds ``moe_aux_coeff`` times the blocks' summed
    load-balance loss.  ``rng`` and ``noise`` as ``gpt_forward``'s."""
    x, aux = gpt_forward(cfg, params, input_ids, rng, train, attention_fn,
                         pld_theta=pld_theta, return_hidden=True, with_aux=True, noise=noise)
    head = params["lm_head"] if cfg.untied_head else params["wte"]
    head_b = params["lm_head_b"] if cfg.head_bias else None
    ce = chunked_cross_entropy(x, head, labels, cfg.vocab_size, head_b=head_b)
    if cfg.moe_num_experts:
        ce = ce + cfg.moe_aux_coeff * aux
    return ce


# --------------------------------------------------------------------------- #
# Inference: contiguous KV cache + generate()
# --------------------------------------------------------------------------- #
def init_kv_cache(cfg: GPTConfig, batch: int, max_len: int,
                  device=None) -> Dict:
    """Per-layer K/V cache, stacked ``[L, B, max_len, Hkv, D]`` in
    ``cfg.dtype``; ``pos`` is a host int."""
    dev = resolve_device(device)
    shape = (cfg.n_layer, batch, max_len, cfg.kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "pos": 0}


def _cached_attention(q, ck, cv, pos: int,
                      alibi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q ``[B, S_q, H, D]`` attends causally to cache positions <= its own
    global position (query i sits at ``pos + i``), grouped against the
    un-expanded ``[B, T, Hkv, D]`` cache, with ALiBi from per-head slopes:
    the contiguous-cache kernel on the card, its plain version on the CPU."""
    return decode_attention(q.contiguous(), ck, cv, pos, alibi=alibi)


@torch.no_grad()
def gpt_apply_with_cache(cfg: GPTConfig, params: Dict, input_ids: torch.Tensor,
                         cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """Run ``input_ids`` ``[B, S_new]`` from cache position ``pos``; returns
    (logits ``[B, S_new, padded_vocab]`` fp32, cache advanced by S_new).
    The cache's K/V tensors are written in place."""
    B, S = input_ids.shape
    dt = cfg.dtype
    pos = int(cache["pos"])
    ck_full, cv_full = cache["k"], cache["v"]
    if pos + S > ck_full.shape[2]:
        raise ValueError(f"cache holds {ck_full.shape[2]} positions; cannot "
                         f"write {S} more at {pos}")
    ids = input_ids.long()
    rope_pos = pos + torch.arange(S, device=ids.device)
    x = _embed(cfg, params, ids, rope_pos[None], dt)
    slopes = _alibi(cfg, ids.device)
    for li, p in enumerate(params["blocks"]):
        def attend(q, k, v, li=li):
            ck_full[li, :, pos:pos + S] = k.to(ck_full.dtype)
            cv_full[li, :, pos:pos + S] = v.to(cv_full.dtype)
            return _cached_attention(q, ck_full[li], cv_full[li], pos, alibi=slopes)
        x, _ = _block(cfg, p, x, dt, attend, rope_pos)
    return _head(cfg, params, x, dt), dict(cache, pos=pos + S)


@torch.no_grad()
def gpt_generate(cfg: GPTConfig, params: Dict, input_ids, max_new_tokens: int,
                 temperature: float = 0.0, max_len: Optional[int] = None,
                 prompt_len: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 noise=None) -> torch.Tensor:
    """Autoregressive generation with the padded-vocab mask; returns
    ``[B, S + max_new_tokens]`` int64 (prompt included).  Greedy at
    ``temperature`` <= 0; above it each token is ``argmax(logits / T + g)``
    (``sampled_tokens``), ``g`` Gumbel noise drawn step by step from
    ``generator`` (default: a fresh one seeded 0, as JAX's default key is
    ``PRNGKey(0)``), or taken from ``noise`` ``[max_new_tokens, B,
    padded_vocab]`` when given (to replay another sampler's draws).  With
    ``prompt_len`` the prompt is right-padded to ``S``: the first token
    follows position ``prompt_len - 1`` and decoding overwrites the pad
    tail's cache slots (JAX's bucketed generate; causality keeps the real
    positions from seeing the pad, though an MoE gate still sees the pad
    tokens in the prefill, as JAX's does)."""
    dev = params["wte"].device
    ids = torch.as_tensor(input_ids, device=dev).long()
    B, S = ids.shape
    if S + max_new_tokens > cfg.n_positions:
        raise ValueError(
            f"prompt ({S}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"n_positions ({cfg.n_positions}); the KV cache cannot grow past it")
    sample = bool(temperature) and temperature > 0     # JAX's test: <= 0 is greedy
    if sample:
        shape = (max_new_tokens, B, cfg.padded_vocab)
        if noise is not None:
            noise = torch.as_tensor(noise, dtype=torch.float32, device=dev)
            if tuple(noise.shape) != shape:
                raise ValueError(f"noise has shape {tuple(noise.shape)}; expected {shape}")
        elif generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
    cache = init_kv_cache(cfg, B, max_len or (S + max_new_tokens), device=dev)
    logits, cache = gpt_apply_with_cache(cfg, params, ids, cache)
    last = logits[:, -1]
    if prompt_len is not None:
        last = logits[:, int(prompt_len) - 1]
        cache = dict(cache, pos=int(prompt_len))
    toks: List[torch.Tensor] = []
    for i in range(max_new_tokens):
        if not sample:
            tok = greedy_tokens(cfg, last)
        else:
            g = noise[i] if noise is not None else gumbel_noise(
                (B, cfg.padded_vocab), generator, dev)
            tok = sampled_tokens(cfg, last, temperature, g)
        toks.append(tok)
        if i + 1 < max_new_tokens:      # the last token's logits are never used
            logits, cache = gpt_apply_with_cache(cfg, params, tok[:, None], cache)
            last = logits[:, -1]
    if not toks:
        return ids
    return torch.cat([ids, torch.stack(toks, dim=1)], dim=1)


# --------------------------------------------------------------------------- #
# Paged (block-table) serving step
# --------------------------------------------------------------------------- #
@torch.no_grad()
def gpt_paged_step(cfg: GPTConfig, params: Dict, input_ids: torch.Tensor,
                   positions: torch.Tensor, k_pages: torch.Tensor,
                   v_pages: torch.Tensor, block_tables: torch.Tensor,
                   write_blocks: torch.Tensor, write_offsets: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step over the paged arena.

    ``input_ids`` [B, S] (S = 1 for decode, a chunk for chunked prefill);
    ``positions`` [B] int32 — each row's tokens already in the cache;
    ``k_pages``/``v_pages`` [L, NB, BS, Hkv, D] — the arena (block 0 is the
    trash block), written in place; ``block_tables`` [B, MB] int32;
    ``write_blocks``/``write_offsets`` [B, S] — physical (block, offset) of
    each new token's K/V (padding and idle slots point at the trash block).
    Rope rotates each row at its own positions; ALiBi reaches the kernel as
    per-head slopes, never as a ``[B, H, S, T]`` bias.  Returns (logits
    [B, S, padded_vocab] fp32, k_pages, v_pages).
    """
    B, S = input_ids.shape
    dt = cfg.dtype
    pos2d = positions.long()[:, None] + torch.arange(S, device=positions.device)[None]
    x = _embed(cfg, params, input_ids.long(), pos2d, dt)
    wb, wo = write_blocks.long(), write_offsets.long()
    slopes = _alibi(cfg, input_ids.device)
    for li, p in enumerate(params["blocks"]):
        def attend(q, k, v, li=li):
            # rows that must not write carry trash-block coordinates, so
            # the scatter needs no predication
            k_pages[li, wb, wo] = k.to(k_pages.dtype)
            v_pages[li, wb, wo] = v.to(v_pages.dtype)
            return paged_attention(q.contiguous(), k_pages[li], v_pages[li],
                                   block_tables, positions, alibi=slopes)
        x, _ = _block(cfg, p, x, dt, attend, pos2d)
    return _head(cfg, params, x, dt), k_pages, v_pages


# --------------------------------------------------------------------------- #
# Module
# --------------------------------------------------------------------------- #
def count_params(cfg: GPTConfig) -> int:
    """Parameter count of ``cfg``'s model as JAX counts it (the head bias
    left out; an MoE block counted as a dense one, its bank not), without
    making it."""
    E, L, I, F_ = cfg.n_embd, cfg.n_layer, cfg.ffn_dim, fc_width(cfg)
    per_block = (E * cfg.qkv_dim + cfg.qkv_dim      # qkv (GQA-sized)
                 + E * E + E                        # attn out
                 + E * F_ + F_                      # mlp up (gate|up)
                 + I * E + E                        # mlp down
                 + 4 * E)                           # two norms
    total = cfg.padded_vocab * E + L * per_block + 2 * E
    if cfg.position_encoding == "learned":
        total += cfg.n_positions * E
    if cfg.untied_head:
        total += cfg.padded_vocab * E
    return total


def active_params(cfg: GPTConfig) -> int:
    """Parameters one token runs through: every leaf of the tree (the head
    bias left out), except that an MoE block counts its gate and
    ``moe_top_k`` experts, not the whole bank.  Equal to the tree's size
    for a dense model."""
    top, block = leaf_shapes(cfg)
    share = {k: cfg.moe_top_k / cfg.moe_num_experts for k in MOE_KEYS[1:]}
    per_block = sum(math.prod(s) * share.get(k, 1) for k, s in block.items())
    return int(sum(math.prod(s) for k, s in top.items() if k != "lm_head_b")
               + cfg.n_layer * per_block)


class GPTBlock(nn.Module):
    """One block's parameters, under the JAX leaf names; an MoE block's
    under ``moe.gate`` and ``moe.experts`` submodules (JAX's nesting)."""

    def __init__(self, tensors: Dict, keys: Tuple[str, ...] = BLOCK_KEYS):
        super().__init__()
        self.keys = keys
        for path in keys:
            self.set_leaf(path, get_leaf(tensors, path))

    def set_leaf(self, path: str, tensor: torch.Tensor, requires_grad: bool = False) -> None:
        *parents, name = path.split(".")
        module = self
        for part in parents:
            if not hasattr(module, part):
                module.add_module(part, nn.Module())
            module = getattr(module, part)
        module.register_parameter(name, nn.Parameter(tensor, requires_grad=requires_grad))

    def tree(self) -> Dict:
        return nest(dict(self.named_parameters()))


def is_quantized(sd: Dict[str, torch.Tensor]) -> bool:
    """Whether a state dict holds int8 weights (``<key>.q8`` leaves)."""
    return any(k.endswith(".q8") for k in sd)


def _tree_from_state_dict(cfg: GPTConfig, sd: Dict[str, torch.Tensor],
                          device: torch.device) -> Dict:
    """``{"wte", ..., "blocks.<i>.<leaf>"}`` -> parameter tree on ``device``,
    checked against ``cfg``."""
    quantized = is_quantized(sd)
    expected, block_shapes = leaf_shapes(cfg, quantized)
    expected = dict(expected)
    for i in range(cfg.n_layer):
        for k, shape in block_shapes.items():
            expected[f"blocks.{i}.{k}"] = shape
    missing = sorted(set(expected) - set(sd))
    extra = sorted(set(sd) - set(expected))
    if missing or extra:
        raise ValueError(f"state dict does not fit the config: missing "
                         f"{missing[:5]}, unexpected {extra[:5]}")
    for k, shape in expected.items():
        if tuple(sd[k].shape) != shape:
            raise ValueError(f"{k}: shape {tuple(sd[k].shape)}, config wants {shape}")
    tree = {k: sd[k].to(device) for k in top_keys(cfg)}
    tree["blocks"] = [nest({k: sd[f"blocks.{i}.{k}"].to(device)
                            for k in block_keys(cfg, quantized)})
                      for i in range(cfg.n_layer)]
    return tree


def cast_leaf(name: str, t, dtype: torch.dtype, device) -> torch.Tensor:
    """A leaf in ``dtype`` on ``device``: float leaves cast, an int8
    payload kept, a quantization scale kept in fp32 (as JAX keeps it)."""
    t = torch.as_tensor(t)
    if t.is_floating_point() and not name.endswith(".scale"):
        return t.to(device, dtype)
    return t.to(device)


def model_in(model: "GPT", dtype: torch.dtype, device: torch.device,
             params: Optional[Dict[str, torch.Tensor]] = None) -> "GPT":
    """``model`` itself when it already holds its weights in ``dtype`` on
    ``device`` (and no ``params``, a state dict, replace them), else a copy
    with ``cfg.dtype`` set to ``dtype`` (the serving and inference engines'
    model; the caller's is left alone)."""
    sd = params if params is not None else model.state_dict()
    if (params is None and model.cfg.dtype == dtype
            and all(cast_leaf(k, t, dtype, device) is t for k, t in sd.items())):
        return model
    sd = {k: cast_leaf(k, v, dtype, device) for k, v in sd.items()}
    return type(model)(dataclasses.replace(model.cfg, dtype=dtype), device=device,
                       state_dict=sd)


class GPT(nn.Module):
    """A model of the GPT family with the JAX ``GPT`` object's methods.  The
    weights come from ``seed`` (a ``torch.Generator`` on ``device``; each
    leaf drawn in fp32 and stored in ``param_dtype``, fp32 by default, so a
    full-size model can be made in bf16 on the card without an fp32 copy)
    or from a ``state_dict`` such as ``models/convert.py:params_from_jax``
    returns.  ``device`` defaults to the current CUDA device and raises
    where there is none."""

    def __init__(self, cfg: GPTConfig, device=None, seed: int = 0,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        if state_dict is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
            tree = init_gpt_params(cfg, gen, dtype=param_dtype)
        else:
            tree = _tree_from_state_dict(cfg, state_dict, dev)
        self.quantized = state_dict is not None and is_quantized(state_dict)
        for name in top_keys(cfg):
            self.register_parameter(
                name, nn.Parameter(tree[name], requires_grad=False))
        self.blocks = nn.ModuleList(GPTBlock(p, block_keys(cfg, self.quantized))
                                    for p in tree["blocks"])

    @property
    def device(self) -> torch.device:
        return self.wte.device

    def param_tree(self) -> Dict:
        """The parameters as the functions of this module take them."""
        tree = {name: getattr(self, name) for name in top_keys(self.cfg)}
        tree["blocks"] = [b.tree() for b in self.blocks]
        return tree

    def forward(self, params: Dict, batch, rng=None, train: bool = True,
                pld_theta=None) -> torch.Tensor:
        """The training loss of ``batch`` = (input_ids, labels) under
        ``params`` (the JAX ``GPT.__call__(params, batch, rng, train)``)."""
        input_ids, labels = batch
        return gpt_loss(self.cfg, params, input_ids, labels, rng, train,
                        pld_theta=pld_theta)

    def init_params(self, generator: torch.Generator) -> Dict:
        """A fresh fp32 parameter tree from ``generator`` (on its device)."""
        return init_gpt_params(self.cfg, generator)

    def set_params(self, tree: Dict, requires_grad: bool = False) -> None:
        """Make the tensors of ``tree`` (``param_tree()``'s layout, or a
        state dict with this module's keys) this module's parameters,
        without copying them."""
        if "blocks" not in tree:
            tree = _tree_from_state_dict(self.cfg, tree, tree["wte"].device)
        for name in top_keys(self.cfg):
            self.register_parameter(
                name, nn.Parameter(tree[name], requires_grad=requires_grad))
        for block, p in zip(self.blocks, tree["blocks"]):
            for path in block.keys:
                block.set_leaf(path, get_leaf(p, path), requires_grad)

    # ---- inference decode protocol ---------------------------------- #
    def init_cache(self, batch: int, max_len: int) -> Dict:
        return init_kv_cache(self.cfg, batch, max_len, device=self.device)

    def apply_with_cache(self, input_ids, cache):
        return gpt_apply_with_cache(self.cfg, self.param_tree(), input_ids, cache)

    def generate(self, input_ids, max_new_tokens: int, temperature: float = 0.0,
                 prompt_len: Optional[int] = None, generator=None, noise=None):
        return gpt_generate(self.cfg, self.param_tree(), input_ids,
                            max_new_tokens, temperature=temperature, prompt_len=prompt_len,
                            generator=generator, noise=noise)

    def forward_logits(self, input_ids) -> torch.Tensor:
        """Full-sequence logits in eval mode (the inference engine's
        ``forward``)."""
        with torch.no_grad():
            return gpt_forward(self.cfg, self.param_tree(), input_ids, train=False)

    def paged_step(self, input_ids, positions, k_pages, v_pages, block_tables,
                   write_blocks, write_offsets):
        """Serving-engine protocol: one step over the paged KV arena
        (``serving/engine.py``)."""
        return gpt_paged_step(self.cfg, self.param_tree(), input_ids, positions,
                              k_pages, v_pages, block_tables, write_blocks,
                              write_offsets)

    def num_params(self) -> int:
        return count_params(self.cfg)


    def flops_per_token(self, seq_len: int) -> float:
        """Training FLOPs/token ~ 6N + the attention term (PaLM appendix B)."""
        cfg = self.cfg
        return 6 * self.num_params() + 12 * cfg.n_layer * cfg.n_embd * seq_len
