"""GPT-2 for training, generate() and the serving engine (counterpart of
``deepspeed_tpu/models/gpt.py``).

Ported here: the config and presets, the seeded init, the training
forward and loss (``gpt_block``, ``gpt_forward``, ``chunked_cross_entropy``,
``gpt_loss``), the KV-cache path of ``generate()`` and the paged serving
step, with the JAX package's names and layouts.  Weights keep JAX's
``[in, out]`` layout and are applied as ``h @ W``.  The functions take a
parameter tree shaped like the JAX pytree, except that ``blocks`` is a list
of per-layer dicts instead of stacked ``[n_layer, ...]`` leaves (the layer
loop is a Python loop; ``scan_layers`` has no meaning here); :class:`GPT`
is an ``nn.Module`` that owns such a tree and has the JAX ``GPT`` object's
methods (``__call__(params, batch, rng, train)`` is the training loss).

Where JAX updated a cache with ``dynamic_update_slice`` or a scatter, the
port writes into the cache tensor in place (no second cache in memory).

Plain large products (qkv, out, fc, proj), layernorm, gelu, the embedding
gather and the argmax are PyTorch calls.  Attention goes through the CUDA
kernels of ``ops/cuda/decode_attention.py`` when decoding and through
``ops/attention.py`` when training (the reference up to 256 tokens, the
flash kernels of ``ops/cuda/flash_attention.py`` above, fed the
``[B, S, H, D]`` views of the qkv product without copies); the training
loss goes through the fused cross-entropy kernels of
``ops/cuda/cross_entropy.py`` on the card.
Config knobs of the other GPT families (rope, alibi, rmsnorm, swiglu, GQA,
parallel blocks, MoE, untied heads) and training knobs not ported yet
(random-LTD, activation quantization, dropout, progressive layer drop)
raise ``NotImplementedError`` naming their ROADMAP item.
"""

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.accelerator.real_accelerator import resolve_device
from deepspeed_tpu_torch.ops.attention import get_attention_fn
from deepspeed_tpu_torch.ops.cuda.cross_entropy import (ce_logits, cross_entropy,
                                                        label_logit)
from deepspeed_tpu_torch.ops.cuda.decode_attention import (decode_attention,
                                                           paged_attention)
from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing import checkpoint

OTHER_FAMILIES = "ROADMAP.md, Queue 1: other GPT families"
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
        self.qkv_dim = (self.n_head + 2 * self.kv_heads) * self.head_dim
        self.ffn_dim = self.intermediate_size or 4 * self.n_embd
        self._reject_unported()

    def _reject_unported(self):
        family = {
            "position_encoding": (self.position_encoding, "learned"),
            "norm": (self.norm, "layernorm"),
            "mlp_type": (self.mlp_type, "standard"),
            "block_type": (self.block_type, "sequential"),
            "activation": (self.activation, "gelu_tanh"),
            "n_kv_head": (self.kv_heads, self.n_head),
            "untied_head": (self.untied_head, False),
            "head_bias": (self.head_bias, False),
            "use_bias": (self.use_bias, True),
            "moe_num_experts": (self.moe_num_experts, 0),
        }
        for knob, (value, ported) in family.items():
            if value != ported:
                raise NotImplementedError(
                    f"GPTConfig.{knob}={value!r} is not ported yet; only "
                    f"{ported!r} (GPT-2) is ({OTHER_FAMILIES})")
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


# --------------------------------------------------------------------------- #
# Parameter construction
# --------------------------------------------------------------------------- #
BLOCK_KEYS = ("ln1_g", "ln1_b", "qkv_w", "qkv_b", "out_w", "out_b",
              "ln2_g", "ln2_b", "fc_w", "fc_b", "proj_w", "proj_b")
TOP_KEYS = ("wte", "wpe", "lnf_g", "lnf_b")


def _normal(shape, scale: float, gen: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32) * scale


def _init_block(cfg: GPTConfig, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """One block's params (GPT-2 init: residual projections scaled by
    1/sqrt(2L)), fp32, on ``gen.device``."""
    E, I, dev = cfg.n_embd, cfg.ffn_dim, gen.device
    proj_scale = 0.02 / math.sqrt(2 * cfg.n_layer)

    def ones(n):
        return torch.ones(n, device=dev)

    def zeros(n):
        return torch.zeros(n, device=dev)
    return {
        "ln1_g": ones(E), "ln1_b": zeros(E),
        "qkv_w": _normal((E, cfg.qkv_dim), 0.02, gen), "qkv_b": zeros(cfg.qkv_dim),
        "out_w": _normal((E, E), proj_scale, gen), "out_b": zeros(E),
        "ln2_g": ones(E), "ln2_b": zeros(E),
        "fc_w": _normal((E, I), 0.02, gen), "fc_b": zeros(I),
        "proj_w": _normal((I, E), proj_scale, gen), "proj_b": zeros(E),
    }


def init_gpt_params(cfg: GPTConfig, generator: torch.Generator) -> Dict:
    """Parameter tree from ``generator`` (same distributions as the JAX
    init; not the same numbers), on the generator's device, fp32."""
    E, dev = cfg.n_embd, generator.device
    return {
        "wte": _normal((cfg.padded_vocab, E), 0.02, generator),
        "wpe": _normal((cfg.n_positions, E), 0.01, generator),
        "lnf_g": torch.ones(E, device=dev),
        "lnf_b": torch.zeros(E, device=dev),
        "blocks": [_init_block(cfg, generator) for _ in range(cfg.n_layer)],
    }


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


def _split_qkv(cfg: GPTConfig, qkv: torch.Tensor):
    """[B, S, qkv_dim] -> q [B,S,H,D], k/v [B,S,Hkv,D] (q|k|v order)."""
    B, S = qkv.shape[:2]
    H, Hkv, D = cfg.n_head, cfg.kv_heads, cfg.head_dim
    q, k, v = torch.split(qkv, [H * D, Hkv * D, Hkv * D], dim=-1)
    return (q.reshape(B, S, H, D), k.reshape(B, S, Hkv, D),
            v.reshape(B, S, Hkv, D))


def _mlp(cfg: GPTConfig, p: Dict, h: torch.Tensor, dt) -> torch.Tensor:
    up = h @ p["fc_w"].to(dt) + p["fc_b"].to(dt)
    h = F.gelu(up, approximate="tanh")
    return h @ p["proj_w"].to(dt) + p["proj_b"].to(dt)


def _attn_in(cfg: GPTConfig, p: Dict, x: torch.Tensor, dt):
    h = layer_norm(x, p["ln1_g"], p["ln1_b"], eps=cfg.ln_eps)
    qkv = h @ p["qkv_w"].to(dt) + p["qkv_b"].to(dt)
    return _split_qkv(cfg, qkv)


def _attn_out(cfg: GPTConfig, p: Dict, x: torch.Tensor, o: torch.Tensor, dt):
    """Attention projection, residual, then the MLP sub-block."""
    x = x + (o @ p["out_w"].to(dt) + p["out_b"].to(dt))
    h2 = layer_norm(x, p["ln2_g"], p["ln2_b"], eps=cfg.ln_eps)
    return x + _mlp(cfg, p, h2, dt)


def _embed(cfg: GPTConfig, params: Dict, input_ids: torch.Tensor,
           pos: torch.Tensor, dt) -> torch.Tensor:
    """Token + learned position embedding; ``pos`` broadcasts against
    ``input_ids``."""
    pos = pos.clamp(0, cfg.n_positions - 1)
    return params["wte"].to(dt)[input_ids] + params["wpe"].to(dt)[pos]


def _head(cfg: GPTConfig, params: Dict, x: torch.Tensor, dt) -> torch.Tensor:
    x = layer_norm(x, params["lnf_g"], params["lnf_b"], eps=cfg.ln_eps)
    return (x @ params["wte"].to(dt).T).float()


def greedy_tokens(cfg: GPTConfig, logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the real vocab (padded columns masked to -1e30)."""
    if cfg.padded_vocab != cfg.vocab_size:
        vmask = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab_size
        logits = torch.where(vmask, logits, -1e30)
    return logits.argmax(dim=-1)


# --------------------------------------------------------------------------- #
# Training: forward and loss
# --------------------------------------------------------------------------- #
def gpt_block(cfg: GPTConfig, p: Dict, x: torch.Tensor,
              attention_fn: Callable) -> torch.Tensor:
    """One sequential pre-LN block on ``x`` ``[B, S, E]``."""
    B, S, E = x.shape
    q, k, v = _attn_in(cfg, p, x, x.dtype)
    o = attention_fn(q, k, v, causal=True).reshape(B, S, E)
    return _attn_out(cfg, p, x, o, x.dtype)


def gpt_forward(cfg: GPTConfig, params: Dict, input_ids: torch.Tensor,
                rng=None, train: bool = False,
                attention_fn: Optional[Callable] = None,
                pld_theta=None, return_hidden: bool = False) -> torch.Tensor:
    """Logits ``[B, S, padded_vocab]`` fp32, or with ``return_hidden`` the
    final-layernorm hidden ``[B, S, E]`` that the training loss takes.  With
    ``cfg.remat`` each block keeps its input and the flash op's o and lse,
    and re-runs the rest in the backward pass (JAX's checkpoint policy)."""
    if pld_theta is not None:
        raise NotImplementedError(f"progressive layer drop is not ported yet ({TRAINING})")
    if train and cfg.dropout:
        raise NotImplementedError(f"dropout={cfg.dropout} is not ported yet ({DROPOUT})")
    attention_fn = attention_fn or get_attention_fn(cfg.attn_impl)
    dt = cfg.dtype
    S = input_ids.shape[1]
    x = _embed(cfg, params, input_ids.long(),
               torch.arange(S, device=input_ids.device)[None], dt)
    body = functools.partial(gpt_block, cfg, attention_fn=attention_fn)
    for p in params["blocks"]:
        x = checkpoint(body, p, x) if cfg.remat else body(p, x)
    x = layer_norm(x, params["lnf_g"], params["lnf_b"], eps=cfg.ln_eps)
    if return_hidden:
        return x
    return (x @ params["wte"].to(dt).T).float()


def chunked_cross_entropy(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                          vocab_size: int, n_chunks: int = 0) -> torch.Tensor:
    """Mean next-token cross-entropy of the hidden ``x`` ``[B, S, E]``
    against ``head`` ``[V, E]``, padded vocab columns masked with ``-1e9``.

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
                             vocab_size)
    if n_chunks <= 0:
        if N * V * 4 <= CE_CHUNK_BYTES:
            n_chunks = 1
        else:
            n_chunks = max(1, -(-N // max(1, CE_CHUNK_BYTES // (4 * V))))
    if n_chunks == 1:
        logits = ce_logits(x.reshape(N, E), head, vocab_size)
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
        logits = ce_logits(xc, head, vocab_size)
        nll = torch.logsumexp(logits, dim=-1) - label_logit(logits, lc)
        return torch.where(keep, nll, 0.0).sum()

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for xc, lc, keep in zip(xf.reshape(n_chunks, rows, E), lf.reshape(n_chunks, rows), valid):
        total = total + checkpoint(chunk, xc, lc, keep)
    return total / N


def gpt_loss(cfg: GPTConfig, params: Dict, input_ids: torch.Tensor,
             labels: torch.Tensor, rng=None, train: bool = True,
             attention_fn: Optional[Callable] = None, pld_theta=None) -> torch.Tensor:
    """Next-token cross-entropy over the tied head (no ``[B, S, V]`` logits
    tensor on the card)."""
    x = gpt_forward(cfg, params, input_ids, rng, train, attention_fn,
                    pld_theta=pld_theta, return_hidden=True)
    return chunked_cross_entropy(x, params["wte"], labels, cfg.vocab_size)


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


def _cached_attention(q, ck, cv, pos: int) -> torch.Tensor:
    """q ``[B, S_q, H, D]`` attends causally to cache positions <= its own
    global position (query i sits at ``pos + i``): the contiguous-cache
    kernel on the card, its plain version on the CPU."""
    return decode_attention(q.contiguous(), ck, cv, pos)


@torch.no_grad()
def gpt_apply_with_cache(cfg: GPTConfig, params: Dict, input_ids: torch.Tensor,
                         cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """Run ``input_ids`` ``[B, S_new]`` from cache position ``pos``; returns
    (logits ``[B, S_new, padded_vocab]`` fp32, cache advanced by S_new).
    The cache's K/V tensors are written in place."""
    B, S = input_ids.shape
    E, dt = cfg.n_embd, cfg.dtype
    pos = int(cache["pos"])
    ck_full, cv_full = cache["k"], cache["v"]
    if pos + S > ck_full.shape[2]:
        raise ValueError(f"cache holds {ck_full.shape[2]} positions; cannot "
                         f"write {S} more at {pos}")
    ids = input_ids.long()
    x = _embed(cfg, params, ids,
               pos + torch.arange(S, device=ids.device)[None], dt)
    for li, p in enumerate(params["blocks"]):
        q, k, v = _attn_in(cfg, p, x, dt)
        ck_full[li, :, pos:pos + S] = k.to(ck_full.dtype)
        cv_full[li, :, pos:pos + S] = v.to(cv_full.dtype)
        o = _cached_attention(q, ck_full[li], cv_full[li], pos).reshape(B, S, E)
        x = _attn_out(cfg, p, x, o, dt)
    return _head(cfg, params, x, dt), dict(cache, pos=pos + S)


@torch.no_grad()
def gpt_generate(cfg: GPTConfig, params: Dict, input_ids, max_new_tokens: int,
                 temperature: float = 0.0,
                 max_len: Optional[int] = None) -> torch.Tensor:
    """Greedy autoregressive generation with the padded-vocab mask; returns
    ``[B, S + max_new_tokens]`` int64 (prompt included)."""
    if temperature:
        raise NotImplementedError(
            "sampled decoding is not ported; generate() is greedy "
            "(temperature=0)")
    dev = params["wte"].device
    ids = torch.as_tensor(input_ids, device=dev).long()
    B, S = ids.shape
    if S + max_new_tokens > cfg.n_positions:
        raise ValueError(
            f"prompt ({S}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"n_positions ({cfg.n_positions}); the KV cache cannot grow past it")
    cache = init_kv_cache(cfg, B, max_len or (S + max_new_tokens), device=dev)
    logits, cache = gpt_apply_with_cache(cfg, params, ids, cache)
    last = logits[:, -1]
    toks: List[torch.Tensor] = []
    for i in range(max_new_tokens):
        tok = greedy_tokens(cfg, last)
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
    Returns (logits [B, S, padded_vocab] fp32, k_pages, v_pages).
    """
    B, S = input_ids.shape
    E, dt = cfg.n_embd, cfg.dtype
    pos2d = positions.long()[:, None] + torch.arange(S, device=positions.device)[None]
    x = _embed(cfg, params, input_ids.long(), pos2d, dt)
    wb, wo = write_blocks.long(), write_offsets.long()
    for li, p in enumerate(params["blocks"]):
        q, k, v = _attn_in(cfg, p, x, dt)
        # rows that must not write carry trash-block coordinates, so the
        # scatter needs no predication
        k_pages[li, wb, wo] = k.to(k_pages.dtype)
        v_pages[li, wb, wo] = v.to(v_pages.dtype)
        o = paged_attention(q.contiguous(), k_pages[li], v_pages[li],
                            block_tables, positions).reshape(B, S, E)
        x = _attn_out(cfg, p, x, o, dt)
    return _head(cfg, params, x, dt), k_pages, v_pages


# --------------------------------------------------------------------------- #
# Module
# --------------------------------------------------------------------------- #
class GPTBlock(nn.Module):
    """One block's parameters, under the JAX leaf names."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        super().__init__()
        for name in BLOCK_KEYS:
            self.register_parameter(
                name, nn.Parameter(tensors[name], requires_grad=False))


def _tree_from_state_dict(cfg: GPTConfig, sd: Dict[str, torch.Tensor],
                          device: torch.device) -> Dict:
    """``{"wte", ..., "blocks.<i>.<leaf>"}`` -> parameter tree on ``device``,
    checked against ``cfg``."""
    expected = {"wte": (cfg.padded_vocab, cfg.n_embd),
                "wpe": (cfg.n_positions, cfg.n_embd),
                "lnf_g": (cfg.n_embd,), "lnf_b": (cfg.n_embd,)}
    E, I = cfg.n_embd, cfg.ffn_dim
    block_shapes = {"ln1_g": (E,), "ln1_b": (E,), "qkv_w": (E, cfg.qkv_dim),
                    "qkv_b": (cfg.qkv_dim,), "out_w": (E, E), "out_b": (E,),
                    "ln2_g": (E,), "ln2_b": (E,), "fc_w": (E, I), "fc_b": (I,),
                    "proj_w": (I, E), "proj_b": (E,)}
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
    tree = {k: sd[k].to(device) for k in TOP_KEYS}
    tree["blocks"] = [{k: sd[f"blocks.{i}.{k}"].to(device) for k in BLOCK_KEYS}
                      for i in range(cfg.n_layer)]
    return tree


class GPT(nn.Module):
    """GPT-2 with the JAX ``GPT`` object's inference methods.  The weights
    come from ``seed`` (a ``torch.Generator`` on ``device``) or from a
    ``state_dict`` such as ``models/convert.py:params_from_jax`` returns.
    ``device`` defaults to the current CUDA device and raises where there
    is none."""

    def __init__(self, cfg: GPTConfig, device=None, seed: int = 0,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        if state_dict is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
            tree = init_gpt_params(cfg, gen)
        else:
            tree = _tree_from_state_dict(cfg, state_dict, dev)
        for name in TOP_KEYS:
            self.register_parameter(
                name, nn.Parameter(tree[name], requires_grad=False))
        self.blocks = nn.ModuleList(GPTBlock(p) for p in tree["blocks"])

    @property
    def device(self) -> torch.device:
        return self.wte.device

    def param_tree(self) -> Dict:
        """The parameters as the functions of this module take them."""
        tree = {name: getattr(self, name) for name in TOP_KEYS}
        tree["blocks"] = [dict(b.named_parameters()) for b in self.blocks]
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
        for name in TOP_KEYS:
            self.register_parameter(
                name, nn.Parameter(tree[name], requires_grad=requires_grad))
        for block, p in zip(self.blocks, tree["blocks"]):
            for name in BLOCK_KEYS:
                block.register_parameter(
                    name, nn.Parameter(p[name], requires_grad=requires_grad))

    # ---- inference decode protocol ---------------------------------- #
    def init_cache(self, batch: int, max_len: int) -> Dict:
        return init_kv_cache(self.cfg, batch, max_len, device=self.device)

    def apply_with_cache(self, input_ids, cache):
        return gpt_apply_with_cache(self.cfg, self.param_tree(), input_ids, cache)

    def generate(self, input_ids, max_new_tokens: int, temperature: float = 0.0):
        return gpt_generate(self.cfg, self.param_tree(), input_ids,
                            max_new_tokens, temperature=temperature)

    def paged_step(self, input_ids, positions, k_pages, v_pages, block_tables,
                   write_blocks, write_offsets):
        """Serving-engine protocol: one step over the paged KV arena
        (``serving/engine.py``)."""
        return gpt_paged_step(self.cfg, self.param_tree(), input_ids, positions,
                              k_pages, v_pages, block_tables, write_blocks,
                              write_offsets)

    def num_params(self) -> int:
        cfg = self.cfg
        E, L, I = cfg.n_embd, cfg.n_layer, cfg.ffn_dim
        per_block = (E * cfg.qkv_dim + cfg.qkv_dim      # qkv
                     + E * E + E                        # attn out
                     + E * I + I                        # mlp up
                     + I * E + E                        # mlp down
                     + 4 * E)                           # two norms
        return cfg.padded_vocab * E + L * per_block + 2 * E + cfg.n_positions * E

    def flops_per_token(self, seq_len: int) -> float:
        """Training FLOPs/token ~ 6N + the attention term (PaLM appendix B)."""
        cfg = self.cfg
        return 6 * self.num_params() + 12 * cfg.n_layer * cfg.n_embd * seq_len
