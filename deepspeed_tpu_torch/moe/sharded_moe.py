"""Gating and dispatch for mixture-of-experts (counterpart of
``deepspeed_tpu/moe/sharded_moe.py``).

The JAX module's math, kept: the softmax gate in fp32, the static capacity
``max(ceil(T / E * factor), min_capacity)`` (``factor >= num_experts``
drops no token), top-1 gating with Random Token Selection (RTS) and the
aux loss ``E * sum(me * ce)``, top-2 gating with gumbel noise on the
second choice only, the second choice's slots after the first choice's
counts, the aux loss ``mean(me * ce) * E^2`` and the two kept gates
renormalised with an ``eps`` floor.  Nothing here reads a value back to the
host.

What changes is the form of the decision.  JAX returns the GShard tensors
``combine`` and ``dispatch`` of shape ``[T, E, C]`` and contracts them by
einsum; at T 8192, E 128, C 64 that is 67 M elements a layer and a
dispatch product as large as the experts' own.  Here the gating returns
each token's k choices as :class:`Routing`: the flat slot ``expert * C +
slot`` of each choice (``E * C``, a slot no expert owns, where the choice
was dropped) and its combine weight.  :func:`moe_dispatch_combine` gathers
the ``[E, C, M]`` expert input through the slot -> token table and combines
by gathering each token's k output rows: the one-hot products of the
einsum form only add exact zeros, so the numbers are the same.
:func:`dense_combine` expands a :class:`Routing` to JAX's ``[T, E, C]``
tensors (the tests hold the two element for element).

Random numbers come from the caller, as uniforms (``noise``, a dict:
``"rts"`` for top-1's RTS priorities in ``[0, 1)``, ``"gumbel"`` for the
gumbel draws of top-2 and of top-1's ``"RSample"`` policy, in ``(0, 1)``),
or from a ``torch.Generator`` through :func:`draw_noise`.  Ties break as
JAX's do: ``argmax`` takes the first maximum, and the two sorts that rank
tokens for RTS are stable.

:class:`RouteLog` records each gating call's choices, or pins a second run
to the choices of a first: the hook that tests and ``chip_smoke.py`` use to
compare two numerically different paths (a near-tie in the gate can route
a token elsewhere and move its output by far more than rounding).
"""

import contextlib
import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

GUMBEL_MIN = 1e-9
EXPERT_PARALLEL = "ROADMAP.md, Queue 1 entry 5 (expert parallelism needs comm/)"


def _capacity(num_tokens: int, num_experts: int, capacity_factor: float,
              min_capacity: int) -> int:
    """Static per-dispatch expert capacity."""
    cap = int(math.ceil((num_tokens / num_experts) * capacity_factor))
    return max(cap, int(min_capacity))


class Routing(NamedTuple):
    """One gating decision.  ``index`` ``[T, k]`` int64: the flat slot
    ``expert * capacity + slot`` each choice was dispatched to, or
    ``num_experts * capacity`` where it was not; ``weights`` ``[T, k]``
    fp32: its combine weight (0 where not dispatched); ``choices`` ``[T,
    k]``: the experts chosen before the capacity cut."""
    index: torch.Tensor
    weights: torch.Tensor
    choices: torch.Tensor
    num_experts: int
    capacity: int

    @property
    def dispatched(self) -> torch.Tensor:
        return self.index < self.num_experts * self.capacity


# --------------------------------------------------------------------------- #
# Route recording and pinning
# --------------------------------------------------------------------------- #
class RouteLog:
    """Each gating call's own choices (``[T, k]``, in call order), or, given
    ``pinned`` (the ``choices`` of an earlier log over the same calls), the
    pinned choices taken in place of its own.  Then ``differ()`` counts the
    (token, choice) routes where its own choice was another expert, and
    ``margins()`` lists their gaps, in its own gate scores (the softmax gate
    for a first choice, the noisy logit for a second), between its own
    choice and the pinned one.  Used only on eager runs."""

    def __init__(self, pinned: Optional[List[torch.Tensor]] = None):
        self.pinned = pinned
        self.choices: List[torch.Tensor] = []
        self._gaps: List[torch.Tensor] = []

    def take(self, own: torch.Tensor, scores: List[torch.Tensor]) -> torch.Tensor:
        self.choices.append(own.detach().clone())
        if self.pinned is None:
            return own
        pin = self.pinned[len(self.choices) - 1].to(own.device, own.dtype)
        if pin.shape != own.shape:
            raise ValueError(f"pinned routes {tuple(pin.shape)} do not fit gating call "
                             f"{len(self.choices) - 1} of shape {tuple(own.shape)}")
        gaps = torch.stack([s.gather(1, own[:, j:j + 1])[:, 0] - s.gather(1, pin[:, j:j + 1])[:, 0]
                            for j, s in enumerate(scores)], dim=1).detach()
        self._gaps.append(torch.where(pin != own, gaps, torch.nan))
        return pin

    def margins(self) -> List[float]:
        """The gate margin of every route that differs from the pinned one,
        smallest first (reads the device)."""
        gaps = [g[~torch.isnan(g)] for g in self._gaps]
        return sorted(float(m) for g in gaps for m in g.cpu())

    def differ(self) -> int:
        return len(self.margins())

    def min_margin(self) -> float:
        return min(self.margins(), default=math.inf)


_ACTIVE: List[RouteLog] = []


@contextlib.contextmanager
def route_log(pinned: Optional[List[torch.Tensor]] = None):
    """Record (or pin, see :class:`RouteLog`) every gating call in the
    block."""
    log = RouteLog(pinned)
    _ACTIVE.append(log)
    try:
        yield log
    finally:
        _ACTIVE.remove(log)


def _route(own: torch.Tensor, scores: List[torch.Tensor]) -> torch.Tensor:
    return _ACTIVE[-1].take(own, scores) if _ACTIVE else own


# --------------------------------------------------------------------------- #
# Gating
# --------------------------------------------------------------------------- #
def draw_noise(generator: torch.Generator, num_tokens: int, num_experts: int, k: int = 1,
               noisy_gate_policy: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The uniforms one gating call takes in training, drawn from
    ``generator`` on its device: top-1 its RTS priorities (and the gumbel
    draws of "RSample"), top-2 the gumbel draws of its second choice."""
    shape, dev = (num_tokens, num_experts), generator.device

    def uniform():
        return torch.rand(shape, generator=generator, device=dev)
    if k == 2:
        return {"gumbel": uniform().clamp_(min=GUMBEL_MIN)}
    noise = {"rts": uniform()}
    if noisy_gate_policy == "RSample":
        noise["gumbel"] = uniform().clamp_(min=GUMBEL_MIN)
    return noise


def _gumbel(u: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(u))


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    return F.one_hot(idx, n).to(torch.float32)


def _flat_index(experts, slots, weights, E: int, C: int) -> torch.Tensor:
    """``expert * C + slot`` where the weight is positive (JAX's ``dispatch
    = combine > 0``), else ``E * C``."""
    return torch.where(weights > 0, experts * C + slots, E * C)


def top1gating(logits: torch.Tensor, capacity_factor: float = 1.0, min_capacity: int = 4,
               noise: Optional[Dict[str, torch.Tensor]] = None,
               noisy_gate_policy: Optional[str] = None, use_rts: bool = True
               ) -> Tuple[torch.Tensor, Routing, torch.Tensor]:
    """Top-1 gating of ``logits`` ``[T, E]``.  Returns (l_aux, routing,
    exp_counts ``[E]`` of first choices before the capacity cut)."""
    logits = logits.float()
    T, E = logits.shape
    gates = torch.softmax(logits, dim=1)
    C = _capacity(T, E, capacity_factor, min_capacity)
    if noisy_gate_policy == "RSample" and noise is not None:
        scores = logits + _gumbel(noise["gumbel"])
    else:
        scores = gates
    own = scores.argmax(dim=1, keepdim=True)
    idx = _route(own, [scores])
    idx1 = idx[:, 0]
    mask1 = _one_hot(idx1, E)
    exp_counts = mask1.sum(0)
    me = gates.mean(0)
    ce = mask1.mean(0)
    l_aux = (me * ce).sum() * E
    rts = mask1 * noise["rts"] if (use_rts and noise is not None) else mask1
    # keep the top-`C` tokens of each expert by priority; stable sorts, so
    # equal priorities (every one, with RTS off) keep the earlier token
    order = torch.argsort(-rts, dim=0, stable=True)
    rank = torch.argsort(order, dim=0, stable=True)
    keep = (rank < C).to(torch.float32) * mask1
    loc = keep.cumsum(0) - 1
    loc = torch.where(loc < C, loc, C - 1)
    slot = (loc * keep).sum(1).long()
    weights = gates.gather(1, idx) * keep.gather(1, idx)
    index = _flat_index(idx, slot[:, None], weights, E, C)
    return l_aux, Routing(index, weights, idx, E, C), exp_counts


def top2gating(logits: torch.Tensor, capacity_factor: float = 1.0, min_capacity: int = 4,
               noise: Optional[Dict[str, torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, Routing, torch.Tensor]:
    """Top-2 gating of ``logits`` ``[T, E]`` (gumbel noise from
    ``noise["gumbel"]`` on the second choice only).  Returns (l_aux,
    routing, exp_counts)."""
    logits = logits.float()
    T, E = logits.shape
    gates = torch.softmax(logits, dim=1)
    C = _capacity(T, E, capacity_factor * 2.0, min_capacity)
    own1 = gates.argmax(dim=1)
    noisy = logits + _gumbel(noise["gumbel"]) if noise is not None else logits
    except1 = torch.where(_one_hot(own1, E) > 0, -torch.inf, noisy)
    own2 = except1.argmax(dim=1)
    own = torch.stack([own1, own2], dim=1)
    idx = _route(own, [gates, except1])
    mask1, mask2 = _one_hot(idx[:, 0], E), _one_hot(idx[:, 1], E)
    loc1 = mask1.cumsum(0) - 1
    loc2 = mask2.cumsum(0) - 1 + mask1.sum(0, keepdim=True)
    exp_counts = mask1.sum(0)
    me = gates.mean(0)
    ce = mask1.mean(0)
    l_aux = (me * ce).mean() * E * E
    mask1 = mask1 * (loc1 < C)
    mask2 = mask2 * (loc2 < C)
    slot1 = (torch.clamp(loc1, max=C - 1) * mask1).sum(1).long()
    slot2 = (torch.clamp(loc2, max=C - 1) * mask2).sum(1).long()
    kept = torch.stack([mask1.gather(1, idx[:, :1])[:, 0], mask2.gather(1, idx[:, 1:])[:, 0]],
                       dim=1)
    g = gates.gather(1, idx) * kept
    denom = torch.clamp(g.sum(1, keepdim=True), min=torch.finfo(torch.float32).eps)
    weights = g / denom
    index = _flat_index(idx, torch.stack([slot1, slot2], dim=1), weights, E, C)
    return l_aux, Routing(index, weights, idx, E, C), exp_counts


def dense_combine(routing: Routing) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``(combine_weights, dispatch_mask)``, each ``[T, E, C]``, from
    a :class:`Routing` (tests only: the port never makes them)."""
    T, k = routing.index.shape
    E, C = routing.num_experts, routing.capacity
    combine = torch.zeros(T, E * C + 1, dtype=routing.weights.dtype,
                          device=routing.weights.device)
    combine.scatter_(1, routing.index, torch.where(routing.dispatched, routing.weights, 0.0))
    combine = combine[:, :E * C].reshape(T, E, C)
    return combine, combine > 0


def expert_load_metrics(exp_counts: torch.Tensor, routing: Routing, k: int = 1) -> dict:
    """Expert-load and drop-fraction gauges of one gating decision, as
    device scalars (no host read): ``drop_fraction = 1 - dispatched / (T *
    k)``, the load shares of the first choices, their max, min and entropy
    as a fraction of ``log E`` (1.0: balanced; 1/E: one expert takes all)."""
    total = torch.clamp(exp_counts.sum(), min=1.0)
    load = exp_counts / total
    T = routing.index.shape[0]
    kept = routing.dispatched.sum().to(torch.float32)
    drop_fraction = 1.0 - kept / float(max(T * k, 1))
    entropy = -torch.where(load > 0, load * torch.log(load), 0.0).sum()
    return {
        "expert_load": load,
        "load_max": load.max(),
        "load_min": load.min(),
        "load_entropy_frac": entropy / math.log(max(exp_counts.shape[0], 2)),
        "drop_fraction": torch.clamp(drop_fraction, 0.0, 1.0),
        "tokens": float(T),
    }


def emit_expert_gauges(hub, exp_counts: torch.Tensor, routing: Routing, k: int = 1,
                       step=None, layer: str = ""):
    """Buffer a ``moe_gauge`` record (:func:`expert_load_metrics`) on a
    TelemetryHub; a no-op when ``hub`` is None.  The values stay device
    tensors until the hub's windowed drain."""
    if hub is None:
        return
    payload = expert_load_metrics(exp_counts, routing, k=k)
    if layer:
        payload["layer"] = layer
    hub.emit("moe_gauge", payload, step=step)


class TopKGate:
    """The gate: the linear ``wg`` ``[M, E]`` (in fp32) and top-k gating.
    ``capacity_factor`` in training, ``eval_capacity_factor`` otherwise;
    ``drop_tokens=False`` sets both to ``num_experts`` (no drop)."""

    def __init__(self, model_dim: int, num_experts: int, k: int = 1,
                 capacity_factor: float = 1.0, eval_capacity_factor: float = 1.0,
                 min_capacity: int = 4, noisy_gate_policy: Optional[str] = None,
                 drop_tokens: bool = True, use_rts: bool = True):
        if k not in (1, 2):
            raise ValueError(f"only top-1 and top-2 gating are supported, got k={k}")
        self.model_dim = model_dim
        self.num_experts = num_experts
        self.k = k
        self.capacity_factor = capacity_factor if drop_tokens else float(num_experts)
        self.eval_capacity_factor = eval_capacity_factor if drop_tokens else float(num_experts)
        self.min_capacity = min_capacity
        self.noisy_gate_policy = noisy_gate_policy
        self.use_rts = use_rts

    def init_params(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        scale = 1.0 / math.sqrt(self.model_dim)
        return {"wg": torch.randn(self.model_dim, self.num_experts, generator=generator,
                                  device=generator.device) * scale}

    def __call__(self, params, x: torch.Tensor, train: bool = True,
                 noise: Optional[Dict[str, torch.Tensor]] = None,
                 rng: Optional[torch.Generator] = None):
        """x ``[T, M]`` -> (l_aux, routing, exp_counts).  In training the
        noise is ``noise``, or drawn from ``rng``; none in eval."""
        logits = x.float() @ params["wg"].float()
        if not train:
            noise = None
        elif noise is None and rng is not None:
            noise = draw_noise(rng, x.shape[0], self.num_experts, self.k,
                               self.noisy_gate_policy)
        if self.k == 1:
            return top1gating(logits, self.capacity_factor if train else self.eval_capacity_factor,
                              self.min_capacity, noise=noise,
                              noisy_gate_policy=self.noisy_gate_policy if train else None,
                              use_rts=self.use_rts and train)
        return top2gating(logits, self.capacity_factor if train else self.eval_capacity_factor,
                          self.min_capacity, noise=noise)


def moe_dispatch_combine(x: torch.Tensor, routing: Routing, expert_fn: Callable,
                         expert_params) -> torch.Tensor:
    """Dispatch ``x`` ``[T, M]`` to the experts, run them as batched
    products over ``[E, C, M]``, and combine each token's k outputs by its
    weights.  The dispatch gathers rows through the slot -> token table
    (empty slots read a zero row); the combine gathers each token's k rows
    (a dropped choice reads a zero row) and sums them in fp32 in choice
    order, weights rounded to ``x``'s dtype as JAX's combine einsum takes
    them.  Every slot belongs to at most one (token, choice), so the
    scatter in each gather's backward adds at most k rows into a token and
    one into a slot: deterministic."""
    T, M = x.shape
    E, C = routing.num_experts, routing.capacity
    k = routing.index.shape[1]
    tokens = torch.arange(T, device=x.device).repeat_interleave(k)
    table = torch.full((E * C + 1,), T, dtype=torch.long, device=x.device)
    # undispatched choices all write the spare last entry, which is dropped
    table.scatter_(0, routing.index.reshape(-1), tokens)
    x_pad = torch.cat([x, x.new_zeros(1, M)])
    expert_in = x_pad[table[:E * C]].view(E, C, M)
    out = expert_fn(expert_params, expert_in).reshape(E * C, M)
    out_pad = torch.cat([out, out.new_zeros(1, M)])
    picked = out_pad[routing.index].float()                     # [T, k, M]
    w = routing.weights.to(x.dtype).float()
    y = w[:, 0, None] * picked[:, 0]
    for j in range(1, k):
        y = y + w[:, j, None] * picked[:, j]
    return y.to(x.dtype)
