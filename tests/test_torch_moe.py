"""Parity of the port's mixture-of-experts (``deepspeed_tpu_torch/moe/``,
the MoE block of ``models/gpt.py``, its trees in ``models/convert.py``, its
noise in ``runtime/engine.py``) with ``deepspeed_tpu/moe/`` and
``deepspeed_tpu/models/gpt.py`` on the CPU.

Inputs are made with numpy from a seed and fed to both packages; model
weights come from the JAX init (matrices scaled up so routes and greedy
streams vary, biases made nonzero) and reach the port through
``params_from_jax``.  Where JAX gates with noise, the test draws JAX's own
uniforms with its key steps (``sharded_moe.py``: top-1's RTS priorities
from ``fold_in(key, 1)``, top-2's gumbel uniforms from ``key``) and hands
them to the port.

Routing is compared exactly: the model tests record JAX's choices of every
gating call, pin the port to them (``moe.sharded_moe.route_log``), print
how many of the port's own routes differ and their smallest gate margin,
and hold the values only on the pinned run; a differing route must be a
near-tie (margin <= NEAR_TIE).  Tolerances, fp32: gating tensors within
1e-6 (products of softmax values summed in another order), logits and
losses within 1e-5 of max(1, the reference's largest magnitude), every
gradient within 1e-4 of max(1, its reference's largest magnitude) (the
backward of a few layers in another order).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.moe import sharded_moe as jmoe
from deepspeed_tpu.moe.layer import MoE as JMoE
from deepspeed_tpu.serving import DeepSpeedServingConfig as JServingConfig
from deepspeed_tpu.serving import ServingEngine as JServingEngine
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import gpt_from_jax, params_from_jax
from deepspeed_tpu_torch.moe import sharded_moe as tmoe
from deepspeed_tpu_torch.moe.layer import MoE
from deepspeed_tpu_torch.serving.kv_cache import PagedKVAllocator

GATE_TOL = 1e-6
TOL = 1e-5
GRAD_TOL = 1e-4
NEAR_TIE = 1e-5

# tiny MoE models: a GPT-2-style block and a rope / RMSNorm / SwiGLU one
# (whose experts are GELU all the same, as JAX builds them)
MOE = dict(moe_num_experts=4, moe_expert_hidden=96, moe_capacity_factor=1.0,
           moe_eval_capacity_factor=1.0, moe_min_capacity=2, moe_aux_coeff=0.05)
MODELS = {
    "gpt2": ("gpt", dict(vocab_size=300, n_positions=96, n_embd=64, n_layer=2, n_head=4)),
    "llama": ("llama", dict(vocab_size=300, n_positions=96, n_embd=64, n_layer=2, n_head=4,
                            n_kv_head=2, intermediate_size=80)),
}


def make_config(pkg, name, **extra):
    family, kw = MODELS[name]
    ctor = {"gpt": pkg.GPTConfig, "llama": pkg.llama_config}[family]
    return ctor(**kw, **dict(MOE, **extra))


def jax_model(name, seed=0, scale=3.0, **extra):
    """JAX config + params as numpy (matrices scaled by ``scale``, biases
    nonzero)."""
    cfg = make_config(jgpt, name, dtype="float32", **extra)
    params = jgpt.GPT(cfg).init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def scaled(path, a):
        a = np.asarray(a)
        key = path[-1].key
        if key.endswith("_b") or key in ("bi", "bo"):
            return a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return a * scale if np.ndim(a) >= 2 else a
    return cfg, jax.tree_util.tree_map_with_path(scaled, params)


def port_model(name, tree, **extra):
    return gpt_from_jax(make_config(tgpt, name, dtype="float32", **extra), tree, device="cpu")


def assert_close(port, ref, tol=TOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max() / max(1.0, np.abs(ref).max())
    assert err <= tol, f"max-abs error over max(1, |ref|) {err:.3e} > {tol}"


def jax_uniforms(key, T, E, k):
    """The uniforms JAX's gating draws from ``key``, as the port takes them."""
    if k == 1:
        return {"rts": torch.from_numpy(np.asarray(
            jax.random.uniform(jax.random.fold_in(key, 1), (T, E))))}
    return {"gumbel": torch.from_numpy(np.asarray(
        jax.random.uniform(key, (T, E), minval=1e-9, maxval=1.0 - 1e-9)))}


class JaxRoutes:
    """Wraps JAX's gating functions: each call records the experts JAX
    chooses (its own argmax steps, recomputed from the call's logits and
    key) and the uniforms it draws, in call order."""

    def __init__(self, monkeypatch):
        self.choices, self.noise = [], []
        top1, top2 = jmoe.top1gating, jmoe.top2gating

        def rec1(logits, capacity_factor=1.0, min_capacity=4, noise_rng=None,
                 noisy_gate_policy=None, use_rts=True):
            T, E = logits.shape
            self.choices.append(torch.from_numpy(np.asarray(
                jnp.argmax(jax.nn.softmax(logits.astype(jnp.float32), axis=1), axis=1)))[:, None])
            self.noise.append(jax_uniforms(noise_rng, T, E, 1) if noise_rng is not None else None)
            return top1(logits, capacity_factor, min_capacity, noise_rng, noisy_gate_policy,
                        use_rts)

        def rec2(logits, capacity_factor=1.0, min_capacity=4, noise_rng=None):
            T, E = logits.shape
            lf = logits.astype(jnp.float32)
            i1 = jnp.argmax(jax.nn.softmax(lf, axis=1), axis=1)
            noise = jax_uniforms(noise_rng, T, E, 2) if noise_rng is not None else None
            noisy = lf + (-jnp.log(-jnp.log(jnp.asarray(noise["gumbel"].numpy()))) if noise
                          else 0.0)
            i2 = jnp.argmax(jnp.where(jax.nn.one_hot(i1, E) > 0, -jnp.inf, noisy), axis=1)
            self.choices.append(torch.from_numpy(np.stack([np.asarray(i1), np.asarray(i2)], 1)))
            self.noise.append(noise)
            return top2(logits, capacity_factor, min_capacity, noise_rng)
        monkeypatch.setattr(jmoe, "top1gating", rec1)
        monkeypatch.setattr(jmoe, "top2gating", rec2)


def report_routes(log, label):
    """Print the port's own routes that differ from the pinned ones and
    their smallest margin; every one must be a near-tie."""
    margins = log.margins()
    print(f"{label}: {log.differ()} (token, choice) routes of {len(log.choices)} gating calls "
          f"differ from JAX's; smallest gate margin among them "
          f"{min(margins, default=math.inf):.3e}")
    assert all(m <= NEAR_TIE for m in margins), (label, margins[-3:])


# --------------------------------------------------------------------------- #
# gating
# --------------------------------------------------------------------------- #
GATE_CASES = [(64, 4, 1.0, 4), (50, 8, 0.5, 4), (33, 16, 2.0, 2), (40, 4, 0.25, 1)]


@pytest.mark.parametrize("T,E,cf,min_cap", GATE_CASES + [(1, 128, 1.0, 4), (8192, 128, 1.0, 4),
                                                         (8, 128, 128.0, 4)])
def test_capacity_matches_jax(T, E, cf, min_cap):
    assert tmoe._capacity(T, E, cf, min_cap) == jmoe._capacity(T, E, cf, min_cap)


def gate_inputs(T, E, seed):
    return np.random.default_rng(seed).standard_normal((T, E)).astype(np.float32)


def assert_gating_equal(port, ref, k):
    """The port's (l_aux, routing, counts) against JAX's (l_aux, combine,
    dispatch, counts): the dense expansion element for element."""
    l_aux, routing, counts = port
    combine, dispatch = tmoe.dense_combine(routing)
    assert tuple(combine.shape) == tuple(ref[1].shape)
    np.testing.assert_allclose(combine.numpy(), np.asarray(ref[1]), rtol=0, atol=GATE_TOL)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref[3]))
    assert abs(float(l_aux) - float(ref[0])) <= GATE_TOL * max(1.0, abs(float(ref[0])))
    assert routing.index.shape[1] == k


@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("T,E,cf,min_cap", GATE_CASES)
def test_top1gating_matches_jax(T, E, cf, min_cap, noise):
    logits = gate_inputs(T, E, seed=T)
    key = jax.random.PRNGKey(T + E) if noise else None
    ref = jmoe.top1gating(jnp.asarray(logits), cf, min_cap, noise_rng=key)
    port = tmoe.top1gating(torch.from_numpy(logits), cf, min_cap,
                           noise=jax_uniforms(key, T, E, 1) if noise else None)
    assert_gating_equal(port, ref, 1)


@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("T,E,cf,min_cap", GATE_CASES)
def test_top2gating_matches_jax(T, E, cf, min_cap, noise):
    logits = gate_inputs(T, E, seed=T + 1)
    key = jax.random.PRNGKey(T * E) if noise else None
    ref = jmoe.top2gating(jnp.asarray(logits), cf, min_cap, noise_rng=key)
    port = tmoe.top2gating(torch.from_numpy(logits), cf, min_cap,
                           noise=jax_uniforms(key, T, E, 2) if noise else None)
    assert_gating_equal(port, ref, 2)


def test_top1gating_rsample_matches_jax():
    """The "RSample" policy: gumbel noise on the top-1 choice, from
    ``key``, beside the RTS priorities from ``fold_in(key, 1)``."""
    T, E = 48, 8
    logits = gate_inputs(T, E, seed=3)
    key = jax.random.PRNGKey(9)
    ref = jmoe.top1gating(jnp.asarray(logits), 1.0, 4, noise_rng=key,
                          noisy_gate_policy="RSample")
    noise = dict(jax_uniforms(key, T, E, 1), **jax_uniforms(key, T, E, 2))
    port = tmoe.top1gating(torch.from_numpy(logits), 1.0, 4, noise=noise,
                           noisy_gate_policy="RSample")
    assert_gating_equal(port, ref, 1)


@pytest.mark.parametrize("k", [1, 2])
def test_ties_break_as_in_jax(k):
    """Equal logits everywhere: argmax takes the first expert, and with
    RTS off the stable sorts keep the earliest tokens; rows of two tied
    maxima take the first."""
    T, E = 24, 4
    logits = np.zeros((T, E), np.float32)
    logits[::3, 1:3] = 1.0                      # tied first choice: expert 1
    gate = (tmoe.top1gating, jmoe.top1gating) if k == 1 else (tmoe.top2gating, jmoe.top2gating)
    port = gate[0](torch.from_numpy(logits), 0.5, 1)
    ref = gate[1](jnp.asarray(logits), 0.5, 1)
    assert_gating_equal(port, ref, k)
    routing = port[1]
    first = routing.choices[:, 0]
    assert first[0] == 1 and first[1] == 0
    kept = routing.dispatched[:, 0] & (first == 0)
    n_kept = int(kept.sum())
    assert n_kept > 0 and kept.nonzero()[:, 0].tolist() == (first == 0).nonzero()[:n_kept, 0].tolist()


@pytest.mark.parametrize("k", [1, 2])
def test_expert_load_metrics_match_jax(k):
    T, E = 64, 8
    logits = gate_inputs(T, E, seed=5)
    gate = (tmoe.top1gating, jmoe.top1gating) if k == 1 else (tmoe.top2gating, jmoe.top2gating)
    l_aux, routing, counts = gate[0](torch.from_numpy(logits), 0.5, 2)
    ref = gate[1](jnp.asarray(logits), 0.5, 2)
    port = tmoe.expert_load_metrics(counts, routing, k=k)
    want = jmoe.expert_load_metrics(ref[3], ref[2], k=k)
    assert set(port) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(np.asarray(port[name], np.float64), np.asarray(value),
                                   rtol=0, atol=GATE_TOL, err_msg=name)
    assert 0.0 < float(port["drop_fraction"]) < 1.0


def test_route_log_records_and_pins():
    """A pinned run takes the recorded choices; its own differing routes
    are counted with their gate margins."""
    T, E = 32, 4
    logits = torch.from_numpy(gate_inputs(T, E, seed=8))
    with tmoe.route_log() as rec:
        first = tmoe.top2gating(logits, 1.0, 2)
    assert len(rec.choices) == 1 and torch.equal(rec.choices[0], first[1].choices)
    bumped = logits.clone()
    bumped[3] = bumped[3].flip(0) * 2.0        # one token prefers another expert
    with tmoe.route_log(pinned=rec.choices) as pin:
        second = tmoe.top2gating(bumped, 1.0, 2)
    assert torch.equal(second[1].choices, first[1].choices)
    assert pin.differ() >= 1 and pin.min_margin() > 0.0
    own = tmoe.top2gating(bumped, 1.0, 2)[1].choices
    assert pin.differ() == int((own != first[1].choices).sum())


# --------------------------------------------------------------------------- #
# the MoE layer
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_layer_forward_and_grads_match_jax(k, train, monkeypatch):
    """y, l_aux and the gradients of ``sum(y * r) + l_aux`` by x and every
    leaf, against ``jax.grad``; in training with JAX's noise."""
    M, E, H = 32, 4, 48
    kw = dict(hidden_size=M, num_experts=E, k=k, capacity_factor=1.0, eval_capacity_factor=1.5,
              min_capacity=2, expert_hidden=H)
    jlayer = JMoE(**kw)
    jparams = jax.tree.map(lambda a: np.asarray(a) * 2.0, jlayer.init_params(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(2)
    jparams["experts"]["bi"] = rng.standard_normal((E, H)).astype(np.float32) * 0.1
    x = rng.standard_normal((3, 10, M)).astype(np.float32)
    r = rng.standard_normal((3, 10, M)).astype(np.float32)
    key = jax.random.PRNGKey(4) if train else None
    routes = JaxRoutes(monkeypatch)

    def jloss(p, xx):
        y, l_aux, _ = jlayer(p, xx, rng=key, train=train)
        return jnp.sum(y * r) + l_aux
    jy, jaux, jcounts = jlayer(jax.tree.map(jnp.asarray, jparams), jnp.asarray(x), rng=key,
                               train=train)
    monkeypatch.undo()
    jg_params, jg_x = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, jparams),
                                                       jnp.asarray(x))

    layer = MoE(**kw)
    params = jax.tree.map(lambda a: torch.tensor(np.asarray(a), requires_grad=True), jparams)
    xt = torch.tensor(x, requires_grad=True)
    with tmoe.route_log(pinned=routes.choices) as log:
        y, aux, counts = layer(params, xt, train=train, noise=routes.noise[0])
    report_routes(log, f"MoE layer k={k} train={train}")
    assert_close(y.detach().numpy(), jy)
    assert_close(float(aux), float(jaux))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    ((y * torch.from_numpy(r)).sum() + aux).backward()
    assert_close(xt.grad.numpy(), jg_x, GRAD_TOL)
    for path, g in jax.tree_util.tree_leaves_with_path(jg_params):
        leaf = params
        for part in path:
            leaf = leaf[part.key]
        assert_close(leaf.grad.numpy(), g, GRAD_TOL)


def test_moe_layer_matches_dense_single_expert():
    """One expert at ample capacity is the plain FFN on every token."""
    layer = MoE(hidden_size=16, num_experts=1, capacity_factor=4.0, min_capacity=64,
                use_rts=False, expert_hidden=32)
    gen = torch.Generator().manual_seed(0)
    params = layer.init_params(gen)
    x = torch.randn(4, 8, 16, generator=gen)
    y, _, _ = layer(params, x)
    dense = layer.experts(params["experts"], x.reshape(1, -1, 16)).reshape(x.shape)
    torch.testing.assert_close(y, dense, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [1, 2])
def test_moe_layer_draws_training_noise_from_rng(k):
    """``rng=`` draws the uniforms ``draw_noise`` draws from the same
    generator state; in eval neither is used."""
    layer = MoE(hidden_size=16, num_experts=4, k=k, min_capacity=1, expert_hidden=24)
    params = layer.init_params(torch.Generator().manual_seed(0))
    x = torch.randn(2, 12, 16, generator=torch.Generator().manual_seed(1))
    got = layer(params, x, train=True, rng=torch.Generator().manual_seed(2))
    noise = tmoe.draw_noise(torch.Generator().manual_seed(2), 24, 4, k)
    want = layer(params, x, train=True, noise=noise)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(layer(params, x, rng=torch.Generator().manual_seed(2))[0],
                       layer(params, x)[0])


def test_moe_layer_refuses_expert_parallel_and_telemetry():
    """Expert parallelism raises; ``telemetry=`` is taken since the hub is
    ported (its gauges are held against JAX's in
    ``tests/test_torch_telemetry_engines.py``)."""
    with pytest.raises(NotImplementedError, match="Queue 1 entry 5"):
        MoE(hidden_size=16, num_experts=4, ep_size=2)
    hub = object()
    assert MoE(hidden_size=16, num_experts=4, telemetry=hub).telemetry is hub


def test_dispatch_combine_is_deterministic_with_drops():
    """Two runs give the same bits, forward and backward, with dropped
    choices (which read and write the spare slot)."""
    T, M, E = 40, 16, 4
    gen = torch.Generator().manual_seed(3)
    layer = MoE(hidden_size=M, num_experts=E, k=2, capacity_factor=0.5, min_capacity=1,
                expert_hidden=24)
    params = layer.init_params(gen)
    x = torch.randn(T, M, generator=gen)
    outs = []
    for _ in range(2):
        xt = x.clone().requires_grad_(True)
        y, _, _ = layer(params, xt, train=False)
        y.square().sum().backward()
        outs.append((y.detach(), xt.grad))
    l_aux, routing, _ = layer.gate(params["gate"], x, train=False)
    assert not bool(routing.dispatched.all())
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


# --------------------------------------------------------------------------- #
# the MoE GPT: config, trees, training path
# --------------------------------------------------------------------------- #
def test_moe_config_and_sizes_match_jax():
    """DeepSpeed-MoE 350M+MoE-128 (chip_smoke.py's cell): the tree's leaf
    shapes and parameter counts."""
    kw = dict(n_embd=1024, n_head=16, n_layer=24, n_positions=2048, moe_num_experts=128,
              moe_top_k=1, moe_expert_hidden=4096, moe_capacity_factor=1.0,
              moe_eval_capacity_factor=1.0, moe_min_capacity=4, moe_aux_coeff=0.01)
    t, j = tgpt.gpt_config("gpt2", **kw), jgpt.gpt_config("gpt2", **kw)
    assert tgpt.count_params(t) == jgpt.GPT(j).num_params()
    top, block = tgpt.leaf_shapes(t)
    per_block = sum(math.prod(s) for s in block.values())
    assert per_block == 1_078_730_752
    assert math.prod(block["moe.experts.wi"]) + math.prod(block["moe.experts.wo"]) + \
        math.prod(block["moe.experts.bi"]) + math.prod(block["moe.experts.bo"]) == \
        128 * 8_393_728
    assert math.prod(top["wte"]) + math.prod(top["wpe"]) == 53_608_448
    assert tgpt.active_params(t) < per_block
    with pytest.raises(ValueError, match="top-1 and top-2"):
        tgpt.GPTConfig(moe_num_experts=4, moe_top_k=3)


@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_moe_trees_convert_and_init_has_the_jax_tree(name, scan_layers):
    cfg, tree = jax_model(name, scale=1.0, scan_layers=scan_layers)
    sd = params_from_jax(tree)
    model = port_model(name, tree)
    L = cfg.n_layer
    for i in range(L):
        layer = (jax.tree.map(lambda a: a[i], tree["blocks"]) if scan_layers
                 else tree["blocks"][f"h{i}"])
        for k in tgpt.block_keys(model.cfg):
            np.testing.assert_array_equal(sd[f"blocks.{i}.{k}"].numpy(), tgpt.get_leaf(layer, k))
            assert torch.equal(model.state_dict()[f"blocks.{i}.{k}"], sd[f"blocks.{i}.{k}"])
    assert "fc_w" not in model.param_tree()["blocks"][0]
    assert model.num_params() == jgpt.GPT(cfg).num_params()
    seeded = tgpt.GPT(model.cfg, device="cpu", seed=3)
    assert {k: tuple(v.shape) for k, v in seeded.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}


def route_pins(name, jcfg, jparams, ids, monkeypatch, key=None):
    """JAX's routes and noise for one training forward of the unrolled
    (``scan_layers=False``) model: eager and without remat (whose
    ``jax.checkpoint`` traces), so the gating sees values."""
    routes = JaxRoutes(monkeypatch)
    jgpt.gpt_forward(dataclasses.replace(jcfg, remat=False), jparams, jnp.asarray(ids), rng=key,
                     train=True)
    monkeypatch.undo()
    return routes


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_moe_gpt_loss_and_grads_match_jax(name, noise, k, remat, monkeypatch):
    """Logits (eval), the training loss (aux included) and every gradient:
    noise off (``rng=None``), and on with JAX's uniforms, remat on and
    off.  The recompute under remat gates again, pinned to the same
    routes."""
    jcfg, tree = jax_model(name, seed=1, moe_top_k=k, scan_layers=False, remat=remat)
    model = port_model(name, tree, moe_top_k=k, scan_layers=False, remat=remat)
    cfg = model.cfg
    jparams = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(11)
    ids = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    labels = np.roll(ids, -1, axis=-1)
    key = jax.random.PRNGKey(21) if noise else None

    want = jgpt.gpt_forward(jcfg, jparams, jnp.asarray(ids))
    got = tgpt.gpt_forward(cfg, model.param_tree(), torch.from_numpy(ids))
    assert_close(got.numpy(), np.asarray(want))

    routes = route_pins(name, jcfg, jparams, ids, monkeypatch, key)
    assert len(routes.choices) == cfg.n_layer
    jloss, jgrads = jax.value_and_grad(
        lambda p: jgpt.gpt_loss(jcfg, p, jnp.asarray(ids), jnp.asarray(labels), rng=key))(jparams)
    tree_t = jax.tree.map(lambda a: torch.tensor(np.asarray(a), requires_grad=True), tree)
    tparams = dict(tree_t, blocks=[tree_t["blocks"][f"h{i}"] for i in range(cfg.n_layer)])
    pinned = routes.choices + (routes.choices[::-1] if remat else [])
    with tmoe.route_log(pinned=pinned) as log:
        loss = tgpt.gpt_loss(cfg, tparams, torch.from_numpy(ids), torch.from_numpy(labels),
                             noise=routes.noise if noise else None)
        loss.backward()
    report_routes(log, f"{name} k={k} noise={noise} remat={remat}")
    assert len(log.choices) == len(pinned)
    assert_close(float(loss), float(jloss))
    for path, g in jax.tree_util.tree_leaves_with_path(jgrads):
        leaf = tree_t
        for part in path:
            leaf = leaf[part.key]
        # a bias-free family's bias leaves take no gradient (JAX's: zeros)
        got = leaf.grad.numpy() if leaf.grad is not None else np.zeros_like(g)
        assert_close(got, g, GRAD_TOL)


def test_moe_gpt_scanned_layers_match_jax():
    """The stacked (``scan_layers``) JAX tree: logits and the noise-free
    training loss."""
    jcfg, tree = jax_model("gpt2", seed=2, moe_top_k=2)
    model = port_model("gpt2", tree, moe_top_k=2)
    jparams = jax.tree.map(jnp.asarray, tree)
    ids = np.random.default_rng(3).integers(0, 300, (2, 20)).astype(np.int32)
    assert_close(tgpt.gpt_forward(model.cfg, model.param_tree(), torch.from_numpy(ids)).numpy(),
                 np.asarray(jgpt.gpt_forward(jcfg, jparams, jnp.asarray(ids))))
    jloss = float(jgpt.gpt_loss(jcfg, jparams, jnp.asarray(ids), jnp.asarray(ids)))
    loss = float(model(model.param_tree(), (torch.from_numpy(ids), torch.from_numpy(ids))))
    assert_close(loss, jloss)


ENGINE_CFG = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
              "gradient_clipping": 1.0}


@pytest.mark.parametrize("k", [1, 2])
def test_engine_noise_equals_gpt_loss_given_the_same_noise(k):
    """The engine draws each block's noise from its generator (seeded by
    ``initialize(seed=)``) before the block: its loss and gradients equal
    ``gpt_loss`` given the same draws; ``train_batch`` trains."""
    _, tree = jax_model("gpt2", moe_top_k=k)
    model = port_model("gpt2", tree, moe_top_k=k, remat=True)
    cfg = model.cfg
    eng, *_ = dst.initialize(model=model, device="cpu", seed=7, config=ENGINE_CFG)
    ids = np.random.default_rng(5).integers(0, 300, (2, 2, 16)).astype(np.int32)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss = eng.forward(ids[0], ids[0])
    eng.backward(loss)
    gen = torch.Generator().manual_seed(7)
    noise = [tmoe.draw_noise(gen, 32, cfg.moe_num_experts, k) for _ in range(cfg.n_layer)]
    leaves = {n: t.clone().requires_grad_(True) for n, t in start.items()}
    tree_t = tgpt.nest(leaves)
    tree_t["blocks"] = [tree_t["blocks"][str(i)] for i in range(cfg.n_layer)]
    ref = tgpt.gpt_loss(cfg, tree_t, torch.from_numpy(ids[0]), torch.from_numpy(ids[0]),
                        noise=noise)
    ref.backward()
    assert float(loss) == float(ref)
    for name, g in zip(eng._names, eng._grads):
        assert torch.equal(g.view_as(leaves[name]), leaves[name].grad), name
    noise_free = float(tgpt.gpt_loss(cfg, tree_t, torch.from_numpy(ids[0]),
                                     torch.from_numpy(ids[0])))
    assert noise_free != float(ref)
    losses = [float(eng.train_batch(batch=(ids, ids))) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_moe_engine_save_load_round_trip(tmp_path):
    """An MoE engine's checkpoint holds the ``moe`` leaves by their JAX
    paths; a fresh engine loads them (and the optimizer state) exactly and
    trains on."""
    _, tree = jax_model("llama", moe_top_k=2)
    ids = np.random.default_rng(6).integers(0, 300, (2, 2, 12)).astype(np.int32)
    eng, *_ = dst.initialize(model=port_model("llama", tree, moe_top_k=2), device="cpu",
                             config=ENGINE_CFG)
    for _ in range(2):
        eng.train_batch(batch=(ids, ids))
    eng.save_checkpoint(str(tmp_path))
    state = eng._checkpoint_state()
    assert "blocks.1.moe.experts.wi" in state["params"]
    assert "blocks.0.moe.gate.wg" in state["opt_state"]["mu"]
    other = tgpt.GPT(make_config(tgpt, "llama", dtype="float32", moe_top_k=2), device="cpu",
                     seed=9)
    eng2, *_ = dst.initialize(model=other, device="cpu", config=ENGINE_CFG)
    path, _ = eng2.load_checkpoint(str(tmp_path))
    assert path is not None and eng2.global_steps == 2
    for (n, a), b in zip(eng.get_fp32_params().items(), eng2.get_fp32_params().values()):
        assert torch.equal(a, b), n
    for n, a in eng.optimizer.state_dict()["mu"].items():
        assert torch.equal(a, eng2.optimizer.state_dict()["mu"][n]), n
    assert np.isfinite(float(eng2.train_batch(batch=(ids, ids))))


# --------------------------------------------------------------------------- #
# serving paths: generate(), the paged step, the serving engine
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_moe_apply_with_cache_and_generate_match_jax(name, k):
    """Prefill then decode steps through the contiguous cache at the
    eval capacity factor 1.0 (tokens drop in the prefill), and greedy
    tokens."""
    jcfg, tree = jax_model(name, seed=3, moe_top_k=k)
    model = port_model(name, tree, moe_top_k=k)
    jparams = jax.tree.map(jnp.asarray, tree)
    ids = np.random.default_rng(0).integers(1, 300, (2, 9)).astype(np.int32)
    jcache, tcache = jgpt.init_kv_cache(jcfg, 2, 16), model.init_cache(2, 16)
    step = ids
    for _ in range(3):
        jl, jcache = jgpt.gpt_apply_with_cache(jcfg, jparams, jnp.asarray(step), jcache)
        tl, tcache = model.apply_with_cache(torch.from_numpy(step), tcache)
        assert_close(tl.numpy(), np.asarray(jl))
        step = np.asarray(jnp.argmax(jl[:, -1:, :jcfg.vocab_size], axis=-1)).astype(np.int32)
    jout = np.asarray(jgpt.GPT(jcfg).generate(jparams, jnp.asarray(ids), 12))
    tout = model.generate(ids, 12).numpy()
    np.testing.assert_array_equal(tout, jout)
    assert len(set(tout[0, 9:].tolist())) > 1, "degenerate stream tests nothing"


@pytest.mark.parametrize("k", [1, 2])
def test_moe_paged_step_gates_every_row_as_jax(k):
    """A padded prefill chunk, then a decode step of two rows (one idle):
    the gate sees the padding and the idle slot, as JAX's does."""
    jcfg, tree = jax_model("gpt2", seed=2, moe_top_k=k)
    model = port_model("gpt2", tree, moe_top_k=k)
    jparams = jax.tree.map(jnp.asarray, tree)
    cfg = model.cfg
    BS, NB, MB, C = 8, 16, 6, 16
    alloc = PagedKVAllocator(NB, BS, MB)
    prompt = np.random.default_rng(4).integers(1, cfg.vocab_size, size=11).astype(np.int32)
    alloc.allocate("a", 12)
    shape = (cfg.n_layer, NB, BS, cfg.kv_heads, cfg.head_dim)
    jk = jv = jnp.zeros(shape, jnp.float32)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    ids = np.zeros((1, C), np.int32)
    ids[0, :11] = prompt
    wb, wo = alloc.write_map("a", 0, C, n_valid=11)
    step_in = [ids, np.asarray([0], np.int32), alloc.block_table("a")[None], wb[None], wo[None]]
    jl, jk, jv = jgpt.gpt_paged_step(jcfg, jparams, *map(jnp.asarray, step_in[:2]), jk, jv,
                                     *map(jnp.asarray, step_in[2:]))
    tl, tk, tv = model.paged_step(*map(torch.from_numpy, step_in[:2]), tk, tv,
                                  *map(torch.from_numpy, step_in[2:]))
    assert_close(tl.numpy(), np.asarray(jl))
    tok = int(np.argmax(np.asarray(jl)[0, 10, :cfg.vocab_size]))
    tables = np.zeros((2, MB), np.int32)
    tables[1] = alloc.block_table("a")
    wb, wo = np.zeros((2, 1), np.int32), np.zeros((2, 1), np.int32)
    wb[1], wo[1] = alloc.write_map("a", 11, 1)
    step_in = [np.asarray([[0], [tok]], np.int32), np.asarray([0, 11], np.int32), tables, wb, wo]
    jl, _, _ = jgpt.gpt_paged_step(jcfg, jparams, *map(jnp.asarray, step_in[:2]), jk, jv,
                                   *map(jnp.asarray, step_in[2:]))
    tl, _, _ = model.paged_step(*map(torch.from_numpy, step_in[:2]), tk, tv,
                                *map(torch.from_numpy, step_in[2:]))
    assert_close(tl.numpy(), np.asarray(jl))


@pytest.mark.parametrize("factor", [1.0, 4.0])
def test_moe_serving_engine_matches_jax_engine(factor):
    """The port's engine against JAX's on the same requests, at the
    published eval capacity factor 1.0 (chunks and decode batches drop
    tokens, the same ones in both) and at a no-drop factor (>= the 4
    experts), where the tokens also equal the port's generate()."""
    jcfg, tree = jax_model("llama", seed=5, moe_eval_capacity_factor=factor)
    port = port_model("llama", tree, moe_eval_capacity_factor=factor)
    serving = dict(block_size=8, num_blocks=64, max_batch_size=4, prefill_chunk=16,
                   dtype="float32")
    rng = np.random.default_rng(6)
    lens, mnts = [3, 9, 17, 30, 5, 21], [8, 12, 5, 7, 10, 6]
    prompts = [list(rng.integers(1, 300, size=n)) for n in lens]
    jeng = JServingEngine(jgpt.GPT(jcfg), config=JServingConfig(**serving),
                          params=jax.tree.map(jnp.asarray, tree))
    teng = dst.init_serving(model=port, config={"serving": serving}, device="cpu")
    out = []
    for eng in (jeng, teng):
        futs = [eng.submit(p, max_new_tokens=m) for p, m in zip(prompts[:4], mnts[:4])]
        for _ in range(3):
            eng.step()
        futs += [eng.submit(p, max_new_tokens=m) for p, m in zip(prompts[4:], mnts[4:])]
        eng.run()
        out.append(futs)
    for i, (jf, tf) in enumerate(zip(*out)):
        assert tf.done and tf.token_ids == jf.token_ids, i
        if factor >= 4:
            assert tf.token_ids == port.generate([prompts[i]], mnts[i])[0, lens[i]:].tolist(), i
    assert len({t for f in out[1] for t in f.token_ids}) > len(out[1])
    teng.alloc.check_consistent()
