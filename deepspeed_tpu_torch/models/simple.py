"""Simple models for tests and the autotuner's built-in trial (counterpart
of ``deepspeed_tpu/models/simple.py``).

``SimpleModel`` is the JAX package's flax ``SimpleModel``: ``nlayers``
dense layers of width ``hidden_dim`` (``h @ kernel + bias``, kernel
``[in, out]``) and a softmax cross-entropy over the last layer's outputs,
in the port's model protocol (``init_params(generator)``,
``set_params(tree, requires_grad)``, ``param_tree()`` and
``model(params, batch, rng, train) -> loss``, as the training engine
takes a model).  Its tree is flax's: ``{"Dense_<i>": {"kernel", "bias"}}``;
``models/convert.py:simple_params_from_jax`` carries a JAX tree over.
"""

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from deepspeed_tpu_torch.accelerator.real_accelerator import resolve_device

# flax's default kernel init (lecun_normal: a normal truncated at two
# standard deviations, rescaled to variance 1 / fan_in)
_TRUNC_STD = 0.87962566103423978


def _layer(i: int) -> str:
    return f"Dense_{i}"


class _Dense(nn.Module):
    def __init__(self, kernel: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.kernel = nn.Parameter(kernel, requires_grad=False)
        self.bias = nn.Parameter(bias, requires_grad=False)


class SimpleModel(nn.Module):
    """Linear stack + cross-entropy, mirroring the reference SimpleModel
    (``tests/unit/simple_model.py``: Linear layers + CrossEntropyLoss).
    ``device`` defaults to the current CUDA device and raises where there
    is none."""

    def __init__(self, hidden_dim: int, nlayers: int = 1, device=None, seed: int = 0):
        super().__init__()
        self.hidden_dim = int(hidden_dim)
        self.nlayers = int(nlayers)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        for name, p in self.init_params(gen).items():
            self.add_module(name, _Dense(p["kernel"], p["bias"]))

    def _dense(self):
        return [(_layer(i), getattr(self, _layer(i))) for i in range(self.nlayers)]

    def init_params(self, generator: torch.Generator) -> Dict:
        """A fresh fp32 tree from ``generator`` (on its device): flax's
        ``Dense`` init, lecun-normal kernels and zero biases."""
        h = self.hidden_dim
        dev = generator.device
        std = math.sqrt(1.0 / h) / _TRUNC_STD
        tree = {}
        for i in range(self.nlayers):
            kernel = torch.empty((h, h), dtype=torch.float32, device=dev)
            nn.init.trunc_normal_(kernel, std=std, a=-2 * std, b=2 * std, generator=generator)
            tree[_layer(i)] = {"kernel": kernel,
                               "bias": torch.zeros(h, dtype=torch.float32, device=dev)}
        return tree

    def param_tree(self) -> Dict:
        return {name: {"kernel": d.kernel, "bias": d.bias} for name, d in self._dense()}

    def set_params(self, tree: Dict, requires_grad: bool = False) -> None:
        """Make the tensors of ``tree`` (``param_tree()``'s layout, or a
        state dict keyed ``Dense_<i>.kernel``) this module's parameters,
        without copying them."""
        for name, d in self._dense():
            for leaf in ("kernel", "bias"):
                t = tree[name][leaf] if name in tree else tree[f"{name}.{leaf}"]
                d.register_parameter(leaf, nn.Parameter(t, requires_grad=requires_grad))

    def forward(self, params: Dict, batch, rng=None, train: bool = True) -> torch.Tensor:
        """The mean cross-entropy of ``batch`` = (x ``[B, hidden]``, y
        ``[B]`` class ids) under ``params`` (JAX's ``SimpleModel.__call__``)."""
        x, y = batch
        for i in range(self.nlayers):
            p = params[_layer(i)]
            x = x @ p["kernel"] + p["bias"]
        logp = F.log_softmax(x.float(), dim=-1)
        return -logp.gather(-1, y.long().unsqueeze(-1)).squeeze(-1).mean()


def random_dataset(total_samples: int, hidden_dim: int, nclasses: Optional[int] = None,
                   seed: int = 0):
    """List-style dataset of (x, y) tuples, the JAX package's draws
    (reference ``simple_model.py:random_dataloader``)."""
    rng = np.random.default_rng(seed)
    nclasses = nclasses or hidden_dim
    xs = rng.standard_normal((total_samples, hidden_dim), dtype=np.float32)
    ys = rng.integers(0, nclasses, size=(total_samples,))
    return [(xs[i], ys[i].astype(np.int32)) for i in range(total_samples)]
