"""Per-architecture injection policies for Hugging Face decoders
(counterpart of ``deepspeed_tpu/module_inject/policies.py``).

A policy reads a ``transformers`` causal LM (duck-typed: ``.config`` with
HF's field names and ``.state_dict()``; ``transformers`` itself is never
imported) and converts it to the port's :class:`GPTConfig` and a state
dict that :class:`GPT` takes (``"wte"``, ``"blocks.<i>.qkv_w"``, ...;
weights ``[in, out]``, the vocab padded, fused ``[q | k | v]`` columns), the
conversions of the JAX policies: torch ``nn.Linear`` weights transposed,
separate q / k / v fused, BLOOM's and GPT-NeoX's head-interleaved qkv
de-interleaved, GPT-Neo's unscaled attention folded into q, BLOOM's
embedding LayerNorm folded into the table, OPT's position offset dropped,
absent biases and norms as zeros and ones.

Each leaf is converted in fp32 (JAX's ``_np``) and placed on the target
device in the target dtype before the next one is made, so no second full
copy of a large model is held in fp32.  BLOOM's embedding fold runs in
numpy, as JAX's does, so that the fp32 result is JAX's to the bit.

Decoders: GPT-2, OPT, GPT-Neo (all-global attention only), BLOOM, LLaMA
(GQA), GPT-J and GPT-NeoX (parallel and sequential residual).  The encoder
policies (BERT, DistilBERT, CLIP text and vision) wait for
``models/{bert,clip}.py`` (ROADMAP.md, Queue 1 entry 8).
"""

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import resolve_device
from deepspeed_tpu_torch.models.gpt import GPTConfig, bloom_config, llama_config

ENCODERS = "ROADMAP.md, Queue 1 entry 8: models/{bert,clip}.py and their policies"
ENCODER_TYPES = ("bert", "distilbert", "clip_text_model", "clip_vision_model")
SPARSE = "ROADMAP.md, Queue 1 entry 8: GPT-Neo local attention through the block-sparse op"


def _np(t) -> torch.Tensor:
    """A leaf in fp32 (on its own device), detached."""
    return torch.as_tensor(t).detach().to(torch.float32)


def _pad_vocab(wte: torch.Tensor, padded: int) -> torch.Tensor:
    v, e = wte.shape
    if v == padded:
        return wte
    out = wte.new_zeros((padded, e))
    out[:v] = wte
    return out


def _zeros(n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=torch.float32)


def _ones(n: int) -> torch.Tensor:
    return torch.ones(n, dtype=torch.float32)


_HF_ACTIVATIONS = {"relu": "relu", "gelu": "gelu",
                   "quick_gelu": "gelu_quick",
                   "gelu_new": "gelu_tanh", "gelu_pytorch_tanh": "gelu_tanh"}


def _map_activation(hf_act: str) -> str:
    """HF ``activation_function`` -> the block's activation name."""
    if hf_act not in _HF_ACTIVATIONS:
        raise NotImplementedError(
            f"activation {hf_act!r} not supported by the fused block; "
            f"supported: {sorted(_HF_ACTIVATIONS)}")
    return _HF_ACTIVATIONS[hf_act]


def _untied_head(hf_config, sd: Dict[str, torch.Tensor], head_key: str):
    """The distinct lm_head matrix, or None when tied (HF's default): an
    untied fine-tune's head is loaded, never replaced by wte."""
    if getattr(hf_config, "tie_word_embeddings", True):
        return None
    return sd[head_key]


def _with(cfg: GPTConfig, **kw) -> GPTConfig:
    return dataclasses.replace(cfg, **kw)


class _Placer:
    """Builds the state dict a leaf at a time: each fp32 leaf is copied to
    the target device and dtype (never aliasing the HF model's tensors)
    before the next is made."""

    def __init__(self, dtype: torch.dtype, device):
        self.dtype, self.device, self.sd = dtype, device, {}

    def put(self, name: str, leaf: torch.Tensor) -> None:
        self.sd[name] = torch.empty(leaf.shape, dtype=self.dtype, device=self.device).copy_(leaf)

    def blocks(self, n_layer: int, block: Callable[[int], Dict[str, torch.Tensor]]) -> None:
        for i in range(n_layer):
            for k, leaf in block(i).items():
                self.put(f"blocks.{i}.{k}", leaf)


class InjectionPolicy:
    """Maps an HF model to (GPTConfig, the port's state dict)."""

    #: HF ``config.model_type`` values this policy handles
    model_types: Tuple[str, ...] = ()

    @classmethod
    def matches(cls, hf_config) -> bool:
        return getattr(hf_config, "model_type", None) in cls.model_types

    def build(self, hf_model, dtype: torch.dtype = torch.float32,
              device=None) -> Tuple[GPTConfig, Dict[str, torch.Tensor]]:
        """(config in ``dtype``, state dict of leaves in ``dtype`` on
        ``device``; default: the current CUDA device)."""
        hc = hf_model.config
        sd = hf_model.state_dict()
        place = _Placer(dtype, resolve_device(device))
        cfg = self.convert(hc, sd, place)
        return _with(cfg, dtype=dtype), place.sd

    def convert(self, hc, sd: Dict[str, torch.Tensor], place: _Placer) -> GPTConfig:
        raise NotImplementedError


def _top(place: _Placer, cfg: GPTConfig, wte, lnf_g, lnf_b, wpe=None, head=None) -> None:
    """The leaves outside the blocks (wte and lm_head padded to the vocab
    multiple)."""
    place.put("wte", _pad_vocab(_np(wte), cfg.padded_vocab))
    if wpe is not None:
        place.put("wpe", _np(wpe))
    place.put("lnf_g", _np(lnf_g))
    place.put("lnf_b", _np(lnf_b))
    if head is not None:
        place.put("lm_head", _pad_vocab(_np(head), cfg.padded_vocab))


def _fused(sd, prefix: str, names) -> torch.Tensor:
    """Separate ``[out, in]`` Linear weights (q / k / v, or gate / up) as
    one ``[in, out_1 | out_2 | ...]``."""
    return torch.cat([_np(sd[prefix.format(n)]).T for n in names], dim=1)


class HFGPT2Policy(InjectionPolicy):
    """HF GPT-2: Conv1D weights are already ``[in, out]``."""

    model_types = ("gpt2",)

    def convert(self, hc, sd, place):
        head = _untied_head(hc, sd, "lm_head.weight")
        cfg = GPTConfig(vocab_size=hc.vocab_size, n_positions=hc.n_positions,
                        n_embd=hc.n_embd, n_layer=hc.n_layer, n_head=hc.n_head,
                        activation=_map_activation(hc.activation_function),
                        ln_eps=hc.layer_norm_epsilon, untied_head=head is not None)
        pre = "transformer."

        def block(i):
            b = f"{pre}h.{i}."
            return {"ln1_g": _np(sd[b + "ln_1.weight"]), "ln1_b": _np(sd[b + "ln_1.bias"]),
                    "qkv_w": _np(sd[b + "attn.c_attn.weight"]),
                    "qkv_b": _np(sd[b + "attn.c_attn.bias"]),
                    "out_w": _np(sd[b + "attn.c_proj.weight"]),
                    "out_b": _np(sd[b + "attn.c_proj.bias"]),
                    "ln2_g": _np(sd[b + "ln_2.weight"]), "ln2_b": _np(sd[b + "ln_2.bias"]),
                    "fc_w": _np(sd[b + "mlp.c_fc.weight"]), "fc_b": _np(sd[b + "mlp.c_fc.bias"]),
                    "proj_w": _np(sd[b + "mlp.c_proj.weight"]),
                    "proj_b": _np(sd[b + "mlp.c_proj.bias"])}
        place.blocks(cfg.n_layer, block)
        _top(place, cfg, sd[pre + "wte.weight"], sd[pre + "ln_f.weight"], sd[pre + "ln_f.bias"],
             wpe=sd[pre + "wpe.weight"], head=head)
        return cfg


class HFOPTPolicy(InjectionPolicy):
    """HF OPT: ``[out, in]`` Linears transposed, q / k / v fused, the
    positions' offset-2 rows dropped, ``final_layer_norm`` of a layer is
    its pre-MLP norm."""

    model_types = ("opt",)

    def convert(self, hc, sd, place):
        if not getattr(hc, "do_layer_norm_before", True):
            raise NotImplementedError("post-LN OPT (350m) layout is not supported by the "
                                      "fused block")
        if hc.word_embed_proj_dim != hc.hidden_size:
            raise NotImplementedError("OPT word_embed_proj_dim != hidden_size not supported")
        head = _untied_head(hc, sd, "lm_head.weight")
        cfg = GPTConfig(vocab_size=hc.vocab_size, n_positions=hc.max_position_embeddings,
                        n_embd=hc.hidden_size, n_layer=hc.num_hidden_layers,
                        n_head=hc.num_attention_heads,
                        activation=_map_activation(hc.activation_function),
                        untied_head=head is not None)
        pre = "model.decoder."

        def block(i):
            b = f"{pre}layers.{i}."
            return {"ln1_g": _np(sd[b + "self_attn_layer_norm.weight"]),
                    "ln1_b": _np(sd[b + "self_attn_layer_norm.bias"]),
                    "qkv_w": _fused(sd, b + "self_attn.{}_proj.weight", "qkv"),
                    "qkv_b": torch.cat([_np(sd[b + f"self_attn.{n}_proj.bias"]) for n in "qkv"]),
                    "out_w": _np(sd[b + "self_attn.out_proj.weight"]).T,
                    "out_b": _np(sd[b + "self_attn.out_proj.bias"]),
                    "ln2_g": _np(sd[b + "final_layer_norm.weight"]),
                    "ln2_b": _np(sd[b + "final_layer_norm.bias"]),
                    "fc_w": _np(sd[b + "fc1.weight"]).T, "fc_b": _np(sd[b + "fc1.bias"]),
                    "proj_w": _np(sd[b + "fc2.weight"]).T, "proj_b": _np(sd[b + "fc2.bias"])}
        place.blocks(cfg.n_layer, block)
        # OPT's learned positions carry a +2 offset (pad / bos rows)
        _top(place, cfg, sd[pre + "embed_tokens.weight"], sd[pre + "final_layer_norm.weight"],
             sd[pre + "final_layer_norm.bias"], wpe=_np(sd[pre + "embed_positions.weight"])[2:],
             head=head)
        return cfg


class HFGPTNeoPolicy(InjectionPolicy):
    """HF GPT-Neo: bias-free q / k / v Linears; its attention is UNSCALED,
    folded in by multiplying q's weights by sqrt(head_dim).  All-"global"
    attention only: local windows need the block-sparse op."""

    model_types = ("gpt_neo",)

    def convert(self, hc, sd, place):
        if any(a != "global" for a in getattr(hc, "attention_layers", [])):
            raise NotImplementedError("GPT-Neo local attention layers not supported by dense "
                                      f"injection; use the sparse-attention ops ({SPARSE})")
        head = _untied_head(hc, sd, "lm_head.weight")
        cfg = GPTConfig(vocab_size=hc.vocab_size, n_positions=hc.max_position_embeddings,
                        n_embd=hc.hidden_size, n_layer=hc.num_layers, n_head=hc.num_heads,
                        activation=_map_activation(hc.activation_function),
                        ln_eps=hc.layer_norm_epsilon, untied_head=head is not None)
        pre = "transformer."
        scale = math.sqrt(cfg.head_dim)

        def block(i):
            b = f"{pre}h.{i}."
            a = b + "attn.attention."
            return {"ln1_g": _np(sd[b + "ln_1.weight"]), "ln1_b": _np(sd[b + "ln_1.bias"]),
                    "qkv_w": torch.cat([_np(sd[a + "q_proj.weight"]).T * scale,
                                        _np(sd[a + "k_proj.weight"]).T,
                                        _np(sd[a + "v_proj.weight"]).T], dim=1),
                    "qkv_b": _zeros(3 * cfg.n_embd),
                    "out_w": _np(sd[a + "out_proj.weight"]).T,
                    "out_b": _np(sd[a + "out_proj.bias"]),
                    "ln2_g": _np(sd[b + "ln_2.weight"]), "ln2_b": _np(sd[b + "ln_2.bias"]),
                    "fc_w": _np(sd[b + "mlp.c_fc.weight"]).T,
                    "fc_b": _np(sd[b + "mlp.c_fc.bias"]),
                    "proj_w": _np(sd[b + "mlp.c_proj.weight"]).T,
                    "proj_b": _np(sd[b + "mlp.c_proj.bias"])}
        place.blocks(cfg.n_layer, block)
        _top(place, cfg, sd[pre + "wte.weight"], sd[pre + "ln_f.weight"], sd[pre + "ln_f.bias"],
             wpe=sd[pre + "wpe.weight"], head=head)
        return cfg


class HFBloomPolicy(InjectionPolicy):
    """HF BLOOM: qkv INTERLEAVED per head (``[H, 3, D]`` on the output
    dim) de-interleaved to ``[q | k | v]``; ALiBi positions; the embedding
    LayerNorm folded into the table (row-wise, so exact: wte' = LN(wte));
    a tied head reads the RAW table, so it becomes an untied head."""

    model_types = ("bloom",)

    def convert(self, hc, sd, place):
        head = _untied_head(hc, sd, "lm_head.weight")
        cfg = bloom_config(vocab_size=hc.vocab_size, n_positions=getattr(hc, "seq_length", 2048),
                           n_embd=hc.hidden_size, n_layer=hc.n_layer, n_head=hc.n_head,
                           ln_eps=hc.layer_norm_epsilon, untied_head=True)
        pre = "transformer."
        E, H = cfg.n_embd, cfg.n_head
        D = E // H

        def deinterleave(w):                    # [E, H*3*D] <- [3E (out), E].T
            w = w.T.reshape(E, H, 3, D)
            return torch.cat([w[:, :, i].reshape(E, E) for i in range(3)], dim=1)

        def deinterleave_b(b):
            b = b.reshape(H, 3, D)
            return torch.cat([b[:, i].reshape(E) for i in range(3)])

        def block(i):
            b = f"{pre}h.{i}."
            return {"ln1_g": _np(sd[b + "input_layernorm.weight"]),
                    "ln1_b": _np(sd[b + "input_layernorm.bias"]),
                    "qkv_w": deinterleave(_np(sd[b + "self_attention.query_key_value.weight"])),
                    "qkv_b": deinterleave_b(_np(sd[b + "self_attention.query_key_value.bias"])),
                    "out_w": _np(sd[b + "self_attention.dense.weight"]).T,
                    "out_b": _np(sd[b + "self_attention.dense.bias"]),
                    "ln2_g": _np(sd[b + "post_attention_layernorm.weight"]),
                    "ln2_b": _np(sd[b + "post_attention_layernorm.bias"]),
                    "fc_w": _np(sd[b + "mlp.dense_h_to_4h.weight"]).T,
                    "fc_b": _np(sd[b + "mlp.dense_h_to_4h.bias"]),
                    "proj_w": _np(sd[b + "mlp.dense_4h_to_h.weight"]).T,
                    "proj_b": _np(sd[b + "mlp.dense_4h_to_h.bias"])}
        place.blocks(cfg.n_layer, block)
        # the embedding LayerNorm folded into the table, in numpy as JAX's
        # policy computes it (its fp32 result to the bit)
        wte = _np(sd[pre + "word_embeddings.weight"])
        w = wte.cpu().numpy()
        g = _np(sd[pre + "word_embeddings_layernorm.weight"]).cpu().numpy()
        bb = _np(sd[pre + "word_embeddings_layernorm.bias"]).cpu().numpy()
        mu = w.mean(axis=1, keepdims=True)
        var = w.var(axis=1, keepdims=True)
        normed = torch.from_numpy((w - mu) / np.sqrt(var + hc.layer_norm_epsilon) * g + bb)
        del w, mu, var
        # a tied head reads the RAW table, so it becomes an untied head
        _top(place, cfg, normed, sd[pre + "ln_f.weight"], sd[pre + "ln_f.bias"],
             head=head if head is not None else wte)
        return cfg


class HFLlamaPolicy(InjectionPolicy):
    """HF LLaMA family: bias-free q / k / v (GQA-sized), rope (HF's
    half-split pairing is the block's), RMSNorm, SwiGLU gate | up fused
    into fc_w, an untied head."""

    model_types = ("llama",)

    def convert(self, hc, sd, place):
        head = _untied_head(hc, sd, "lm_head.weight")
        cfg = llama_config(vocab_size=hc.vocab_size, n_positions=hc.max_position_embeddings,
                           n_embd=hc.hidden_size, n_layer=hc.num_hidden_layers,
                           n_head=hc.num_attention_heads,
                           n_kv_head=getattr(hc, "num_key_value_heads", hc.num_attention_heads),
                           intermediate_size=hc.intermediate_size, ln_eps=hc.rms_norm_eps,
                           rope_theta=getattr(hc, "rope_theta", 10000.0), untied_head=True)
        pre = "model."
        E = cfg.n_embd

        def block(i):
            b = f"{pre}layers.{i}."
            return {"ln1_g": _np(sd[b + "input_layernorm.weight"]), "ln1_b": _zeros(E),
                    "qkv_w": _fused(sd, b + "self_attn.{}_proj.weight", "qkv"),
                    "qkv_b": _zeros(cfg.qkv_dim),
                    "out_w": _np(sd[b + "self_attn.o_proj.weight"]).T, "out_b": _zeros(E),
                    "ln2_g": _np(sd[b + "post_attention_layernorm.weight"]), "ln2_b": _zeros(E),
                    "fc_w": _fused(sd, b + "mlp.{}_proj.weight", ("gate", "up")),
                    "fc_b": _zeros(2 * cfg.ffn_dim),
                    "proj_w": _np(sd[b + "mlp.down_proj.weight"]).T, "proj_b": _zeros(E)}
        place.blocks(cfg.n_layer, block)
        _top(place, cfg, sd[pre + "embed_tokens.weight"], sd[pre + "norm.weight"], _zeros(E),
             head=head if head is not None else sd[pre + "embed_tokens.weight"])
        return cfg


class HFGPTJPolicy(InjectionPolicy):
    """HF GPT-J: partial INTERLEAVED rotary (``rotary_dim``), a parallel
    residual with one LayerNorm feeding attention and MLP, bias-free
    attention projections, an untied head with a bias."""

    model_types = ("gptj",)

    def convert(self, hc, sd, place):
        E = hc.n_embd
        cfg = GPTConfig(vocab_size=hc.vocab_size, n_positions=hc.n_positions, n_embd=E,
                        n_layer=hc.n_layer, n_head=hc.n_head, position_encoding="rope",
                        rope_dim=hc.rotary_dim, rope_interleaved=True,
                        block_type="parallel_single_ln",
                        activation=_map_activation(hc.activation_function),
                        ln_eps=hc.layer_norm_epsilon, untied_head=True, head_bias=True)

        def block(i):
            b = f"transformer.h.{i}."
            # GPT-J has no second LN: identity placeholders (the
            # parallel_single_ln block never reads them)
            return {"ln1_g": _np(sd[b + "ln_1.weight"]), "ln1_b": _np(sd[b + "ln_1.bias"]),
                    "qkv_w": _fused(sd, b + "attn.{}_proj.weight", "qkv"),
                    "qkv_b": _zeros(3 * E),
                    "out_w": _np(sd[b + "attn.out_proj.weight"]).T, "out_b": _zeros(E),
                    "ln2_g": _ones(E), "ln2_b": _zeros(E),
                    "fc_w": _np(sd[b + "mlp.fc_in.weight"]).T,
                    "fc_b": _np(sd[b + "mlp.fc_in.bias"]),
                    "proj_w": _np(sd[b + "mlp.fc_out.weight"]).T,
                    "proj_b": _np(sd[b + "mlp.fc_out.bias"])}
        place.blocks(cfg.n_layer, block)
        _top(place, cfg, sd["transformer.wte.weight"], sd["transformer.ln_f.weight"],
             sd["transformer.ln_f.bias"], head=sd["lm_head.weight"])
        head_b = _zeros(cfg.padded_vocab)
        head_b[:hc.vocab_size] = _np(sd["lm_head.bias"])
        place.put("lm_head_b", head_b)
        return cfg


class HFGPTNeoXPolicy(InjectionPolicy):
    """HF GPT-NeoX / Pythia: fused qkv stored HEAD-INTERLEAVED (``[nh, 3,
    hd]`` rows), de-interleaved here; partial half-split rotary
    (``rotary_pct``); parallel residual when ``use_parallel_residual``."""

    model_types = ("gpt_neox",)

    def convert(self, hc, sd, place):
        E, nh = hc.hidden_size, hc.num_attention_heads
        hd = E // nh
        cfg = GPTConfig(vocab_size=hc.vocab_size, n_positions=hc.max_position_embeddings,
                        n_embd=E, n_layer=hc.num_hidden_layers, n_head=nh,
                        position_encoding="rope", rope_dim=int(hd * hc.rotary_pct),
                        rope_theta=getattr(hc, "rotary_emb_base", 10000.0),
                        block_type="parallel" if hc.use_parallel_residual else "sequential",
                        activation=_map_activation(hc.hidden_act), ln_eps=hc.layer_norm_eps,
                        intermediate_size=hc.intermediate_size, untied_head=True)

        def block(i):
            b = f"gpt_neox.layers.{i}."
            # rows are [nh, 3, hd]; the block wants [q (nh*hd) | k | v] columns
            w = _np(sd[b + "attention.query_key_value.weight"]).reshape(nh, 3, hd, E)
            bq = _np(sd[b + "attention.query_key_value.bias"]).reshape(nh, 3, hd)
            return {"ln1_g": _np(sd[b + "input_layernorm.weight"]),
                    "ln1_b": _np(sd[b + "input_layernorm.bias"]),
                    "qkv_w": torch.cat([w[:, j].reshape(nh * hd, E).T for j in range(3)], dim=1),
                    "qkv_b": torch.cat([bq[:, j].reshape(nh * hd) for j in range(3)]),
                    "out_w": _np(sd[b + "attention.dense.weight"]).T,
                    "out_b": _np(sd[b + "attention.dense.bias"]),
                    "ln2_g": _np(sd[b + "post_attention_layernorm.weight"]),
                    "ln2_b": _np(sd[b + "post_attention_layernorm.bias"]),
                    "fc_w": _np(sd[b + "mlp.dense_h_to_4h.weight"]).T,
                    "fc_b": _np(sd[b + "mlp.dense_h_to_4h.bias"]),
                    "proj_w": _np(sd[b + "mlp.dense_4h_to_h.weight"]).T,
                    "proj_b": _np(sd[b + "mlp.dense_4h_to_h.bias"])}
        place.blocks(cfg.n_layer, block)
        _top(place, cfg, sd["gpt_neox.embed_in.weight"], sd["gpt_neox.final_layer_norm.weight"],
             sd["gpt_neox.final_layer_norm.bias"], head=sd["embed_out.weight"])
        return cfg


_POLICIES = (HFGPT2Policy, HFOPTPolicy, HFGPTNeoPolicy, HFBloomPolicy, HFLlamaPolicy,
             HFGPTJPolicy, HFGPTNeoXPolicy)


def policy_for_model(hf_model) -> Optional[InjectionPolicy]:
    """The policy for an HF model's ``config.model_type``, or None."""
    hf_config = getattr(hf_model, "config", None)
    for pol in _POLICIES:
        if hf_config is not None and pol.matches(hf_config):
            return pol()
    return None
