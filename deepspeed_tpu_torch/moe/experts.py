"""The expert bank (counterpart of ``deepspeed_tpu/moe/experts.py``): one
stacked parameter tree with a leading ``[num_experts, ...]`` dimension, run
as batched products over ``[E, C, M]`` (JAX's ``Experts`` ``vmap``s one
expert over the stack; here the expert itself takes the stack, and the
products are ``torch.bmm``).  The only expert is JAX's: a two-layer
tanh-GELU MLP with biases."""

import math
from typing import Dict

import torch
import torch.nn.functional as F


class FFNExpert:
    """A bank of ``gelu_tanh(x @ wi + bi) @ wo + bo`` experts; ``wi`` ``[E,
    M, H]``, ``wo`` ``[E, H, M]`` (JAX's ``[in, out]`` layout), computed in
    ``x``'s dtype."""

    def __init__(self, model_dim: int, hidden_dim: int):
        self.model_dim = model_dim
        self.hidden_dim = hidden_dim

    def init_params(self, generator: torch.Generator, num_experts: int = 1,
                    dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
        """``num_experts`` experts' leaves stacked ``[E, ...]`` (JAX's
        distributions, not its numbers), on the generator's device: each
        drawn in fp32 and stored in ``dtype``."""
        M, H, E, dev = self.model_dim, self.hidden_dim, num_experts, generator.device

        def normal(shape, fan_in):
            w = torch.randn(shape, generator=generator, device=dev) / math.sqrt(fan_in)
            return w.to(dtype)
        return {"wi": normal((E, M, H), M), "bi": torch.zeros(E, H, device=dev, dtype=dtype),
                "wo": normal((E, H, M), H), "bo": torch.zeros(E, M, device=dev, dtype=dtype)}

    def __call__(self, params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        """Stacked ``params`` (``wi`` ``[E, M, H]``, ...) on ``x`` ``[E, C, M]``
        -> ``[E, C, M]``."""
        dt = x.dtype
        h = torch.bmm(x, params["wi"].to(dt)) + params["bi"].to(dt)[:, None]
        h = F.gelu(h, approximate="tanh")
        return torch.bmm(h, params["wo"].to(dt)) + params["bo"].to(dt)[:, None]

