"""Parity of the port's fused AdamW (``deepspeed_tpu_torch/ops/cuda/
fused_optim.py`` and ``runtime/optimizers.py``) with the JAX package's
``fused_adam_tree_update`` (its Pallas kernel in interpret mode) and with
``optax.adamw``, on the same numpy trees.

Tolerance, measured: every tensor within 1 ulp of its largest element
(2 for the unscale/clip fold case, which JAX's own test also bounds by a
few ulp).  The port's plain version rounds every operation to fp32 in the
kernel's order (as the CUDA kernel does, so the two agree bit for bit on
the card); XLA's CPU compiler contracts some of the same multiply-adds into
FMAs, and where a moment cancels towards zero that one-ulp wobble of its
terms is many ulps of the small result, so the bound is taken against the
tensor's scale.  The bias corrections and the saturating count match JAX
bit for bit.

The kernel's plan (``plan_chunks``: vector chunks where p, g, mu and nu
are all 16-byte aligned, scalar chunks for each leaf's ``n % 4`` tail and
for misaligned leaves) is a pure function of the leaf sizes and pointer
offsets, checked here at gradient views into one flat buffer, as the
engine lays them out.

The CUDA kernel runs only on a card: the ``cuda``-marked tests skip here
(``python -m pytest tests/test_torch_fused_optim.py -m cuda`` on the GPU
machine); ``chip_smoke.py`` holds it against the plain version over all
148 GPT-2 leaves, separate and as the engine's flat gradient layout.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.ops.pallas import fused_optim as jfo
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import adam_state_from_jax, params_from_jax
from deepspeed_tpu_torch.ops.cuda import fused_optim as tfo
from deepspeed_tpu_torch.runtime import lr_schedules as tlr
from deepspeed_tpu_torch.runtime.optimizers import FusedAdam, get_optimizer

ULP = 1
KEYS = ("b", "s", "w")


def make_tree(seed):
    rng = np.random.default_rng(seed)
    return {"b": rng.standard_normal(8).astype(np.float32),
            "s": np.asarray(rng.standard_normal(), np.float32),
            "w": rng.standard_normal((17, 9)).astype(np.float32)}


def ulps(a, b) -> float:
    """max |a - b| in ulps of b's largest magnitude."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.spacing(np.float32(np.abs(b).max())))


def schedules(kind):
    """(jax lr, port lr) for a static rate or the linear WarmupLR."""
    if kind == "static":
        return 1e-3, 1e-3
    kw = dict(warmup_min_lr=1e-4, warmup_max_lr=1e-3, warmup_num_steps=4,
              warmup_type="linear")
    return jlr.WarmupLR(**kw).schedule_fn(), tlr.WarmupLR(**kw).schedule_fn()


def port_optimizer(tree, lr, wd):
    params = [torch.from_numpy(np.array(tree[k])) for k in KEYS]
    grads = [torch.zeros_like(p) for p in params]
    spec = tfo.spec_from_config("adamw", {"weight_decay": wd}, lr)
    return FusedAdam(params, grads, spec, names=list(KEYS)), params, grads


def assert_state_close(opt, params, jparams, jadam, bound=ULP):
    for i, k in enumerate(KEYS):
        assert ulps(params[i], jparams[k]) <= bound, k
        assert ulps(opt.mu[i], jadam.mu[k]) <= bound, k
        assert ulps(opt.nu[i], jadam.nu[k]) <= bound, k
    assert int(opt.count) == int(jadam.count)


@pytest.mark.parametrize("start", ["zeros", "carried"])
@pytest.mark.parametrize("lr_kind", ["static", "warmup"])
@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("ref", ["pallas", "optax"])
def test_plain_adamw_matches_jax(ref, wd, lr_kind, start):
    """Five steps; "carried" starts both sides from a JAX state three steps
    in, brought across by ``adam_state_from_jax``."""
    jlr_fn, tlr_fn = schedules(lr_kind)
    tx = optax.adamw(learning_rate=jlr_fn, weight_decay=wd)
    spec = jfo.spec_from_config("adamw", {"weight_decay": wd}, jlr_fn)

    @jax.jit
    def jax_step(p, s, g):
        if ref == "pallas":
            return jfo.fused_adam_tree_update(spec, p, s, g)
        u, s2 = tx.update(g, s, p)
        return jax.tree.map(lambda a, b: a + b, p, u), s2

    jparams = jax.tree.map(jnp.asarray, make_tree(0))
    jstate = tx.init(jparams)
    if start == "carried":
        for i in range(3):
            jparams, jstate = jax_step(jparams, jstate, make_tree(100 + i))
    opt, params, grads = port_optimizer(jax.tree.map(np.asarray, jparams), tlr_fn, wd)
    if start == "carried":
        state = adam_state_from_jax(jstate)
        opt.load_state_dict(state)
        assert state["count"] == 3
    one = torch.ones(())
    for step in range(5):
        g = make_tree(10 + step)
        jparams, jstate = jax_step(jparams, jstate, g)
        for t, k in zip(grads, KEYS):
            t.copy_(torch.from_numpy(np.array(g[k])))
        opt.step(one, one)
    assert_state_close(opt, params, jparams, jstate[0])


def test_scalars_fold_unscale_and_clip():
    """``(g * inv) * clip`` folded into the update, as the JAX kernel's
    [inv, clip] scalars (JAX's ``test_leaf_update_scalars_fold_unscale_and_clip``
    case: inv 1/1024, clip 0.37), against the unfused optax step."""
    tx = optax.adamw(learning_rate=1e-3, weight_decay=0.01)
    jparams = jax.tree.map(jnp.asarray, make_tree(0))
    state = tx.init(jparams)
    g_raw = make_tree(42)
    inv, factor = np.float32(1.0 / 1024.0), np.float32(0.37)

    @jax.jit
    def unfused(p, s, g):
        g = jax.tree.map(lambda x: (x * inv) * factor, g)
        u, s2 = tx.update(g, s, p)
        return jax.tree.map(lambda a, b: a + b, p, u), s2

    jp, js = unfused(jparams, state, g_raw)
    opt, params, grads = port_optimizer(make_tree(0), 1e-3, 0.01)
    for t, k in zip(grads, KEYS):
        t.copy_(torch.from_numpy(np.array(g_raw[k])))
    opt.step(torch.tensor(inv), torch.tensor(factor))
    assert_state_close(opt, params, jp, js[0], bound=2)


SPEC_CASES = [
    ("adam", {}), ("adamw", {"weight_decay": 0.01}), ("fusedadam", {"betas": (0.8, 0.9)}),
    ("cpuadam", {"eps": 1e-6}), ("adam", {"adam_w_mode": False}),
    ("adam", {"adam_w_mode": False, "weight_decay": 0.1}),
    ("adamw", {"adam_w_mode": False, "weight_decay": 0.1}),
    ("lamb", {}), ("sgd", {"momentum": 0.9}), ("lion", {}), ("onebitadam", {}), (None, {}),
]


@pytest.mark.parametrize("name,params", SPEC_CASES, ids=[str(i) for i in range(len(SPEC_CASES))])
def test_spec_from_config_matches_jax(name, params):
    assert tfo.spec_from_config(name, params, 1e-3) == jfo.spec_from_config(name, params, 1e-3)


@pytest.mark.parametrize("name,params", SPEC_CASES, ids=[str(i) for i in range(len(SPEC_CASES))])
def test_get_optimizer_fuses_or_raises(name, params):
    """Decay-after Adam takes the fused kernel; every other optimizer
    raises naming its ROADMAP item (never a torch.optim fallback)."""
    leaf = [torch.zeros(3)]
    if tfo.spec_from_config(name, params, 1e-3) is not None:
        assert isinstance(get_optimizer(name or "adam", params, leaf, [torch.zeros(3)]),
                          FusedAdam)
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1 item 5"):
            get_optimizer(name, params, leaf, [torch.zeros(3)])


def test_get_optimizer_rejects_unknown_names():
    with pytest.raises(ValueError, match="Unknown optimizer"):
        get_optimizer("adamax", {}, [torch.zeros(3)], [torch.zeros(3)])


def test_step_scalars_match_jax_for_counts_up_to_1e4():
    """Bias corrections ``1 - b**count_inc`` and the static ``-lr``, bit for
    bit, for optax counts 0..10^4 (and the saturating increment)."""
    counts = np.arange(0, 10_001, dtype=np.int32)
    spec = {"b1": 0.9, "b2": 0.999, "lr": 3e-4}
    jneg, jbc1, jbc2 = jax.jit(lambda c: jfo.step_scalars(spec, c))(jnp.asarray(counts))
    got = np.asarray([[float(v) for v in tfo.step_scalars(spec, torch.tensor(c))]
                      for c in counts.tolist()], np.float32)
    np.testing.assert_array_equal(got[:, 1], np.asarray(jbc1))
    np.testing.assert_array_equal(got[:, 2], np.asarray(jbc2))
    assert np.all(got[:, 0] == np.float32(-3e-4)) and float(jneg) == float(np.float32(-3e-4))
    top = torch.tensor(2 ** 31 - 1, dtype=torch.int32)
    assert int(tfo.safe_int32_increment(top)) == 2 ** 31 - 1
    assert int(tfo.safe_int32_increment(top - 1)) == 2 ** 31 - 1


def test_zero_weight_decay_adds_nothing():
    """wd = 0 must not add 0 * p: for p = inf that would be NaN."""
    p = [torch.tensor([float("inf"), 1.0])]
    g, mu, nu = [torch.ones(2)], [torch.zeros(2)], [torch.zeros(2)]
    scal = torch.tensor([1.0, 1.0, -1e-3, 0.1, 0.001])
    tfo.fused_adam(tfo.AdamTable(p, g, mu, nu), scal, b1=0.9, b2=0.999, eps=1e-8, wd=0.0)
    assert p[0][0] == float("inf") and torch.isfinite(p[0][1])


def test_adam_state_from_jax_round_trip():
    """A JAX engine-shaped optax state (stacked GPT blocks) comes across
    leaf for leaf, and the port's optimizer holds it under GPT's names."""
    cfg = jgpt.GPTConfig(vocab_size=300, n_positions=16, n_embd=32, n_layer=2, n_head=4,
                         dtype="float32")
    jparams = jgpt.GPT(cfg).init_params(jax.random.PRNGKey(0))
    tx = optax.adamw(1e-3, weight_decay=0.01)
    state = tx.init(jparams)
    g = jax.tree.map(lambda a: jnp.ones_like(a) * 0.5, jparams)
    for _ in range(2):
        _, state = tx.update(g, state, jparams)
    got = adam_state_from_jax(state)
    assert got["count"] == 2
    for key in ("mu", "nu"):
        want = params_from_jax(getattr(state[0], key))
        assert set(got[key]) == set(want)
        for name in want:
            torch.testing.assert_close(got[key][name], want[name], rtol=0, atol=0)
    model = tgpt.GPT(tgpt.GPTConfig(vocab_size=300, n_positions=16, n_embd=32, n_layer=2,
                                    n_head=4, dtype="float32"), device="cpu")
    names, leaves = zip(*model.named_parameters())
    opt = FusedAdam(list(leaves), [torch.zeros_like(p) for p in leaves],
                    tfo.spec_from_config("adamw", {}, 1e-3), names=list(names))
    opt.load_state_dict(got)
    back = opt.state_dict()
    for key in ("mu", "nu"):
        for name in names:
            assert torch.equal(back[key][name], got[key][name])
    assert int(back["count"]) == 2
    with pytest.raises(ValueError):
        adam_state_from_jax((state[1], state[2]))


def test_cpu_table_runs_the_plain_version_and_counts_no_launch():
    tfo.reset_counts()
    opt, _, _ = port_optimizer(make_tree(0), 1e-3, 0.0)
    opt.step(torch.ones(()), torch.ones(()))
    assert tfo.fused_adam.launches == 0 and tfo.adam_reference.calls == 1
    tfo.reset_counts()


# --------------------------------------------------------------------------- #
# the kernel's plan
# --------------------------------------------------------------------------- #
PLAN_SIZES = [1, 3, 5, 70001, 8, 4096 * 3, 153]


def flat_offsets(sizes, view_of, start):
    """Byte offsets mod 16 of each leaf's (p, g, mu, nu) when the tensor
    ``view_of`` is views into one 16-byte aligned flat buffer from element
    ``start`` on (as the engine's gradients are) and the others are
    separate allocations."""
    offs, at = [], start
    for n in sizes:
        o = [0, 0, 0, 0]
        if view_of is not None:
            o[view_of] = 4 * at % 16
        offs.append(o)
        at += n
    return offs


@pytest.mark.parametrize("chunk", [8, 4096])
@pytest.mark.parametrize("view_of,start", [(None, 0), (1, 0), (1, 1), (1, 2), (1, 3), (0, 1),
                                           (2, 2), (3, 3)])
def test_plan_covers_every_element_once_with_aligned_vectors(view_of, start, chunk):
    """Sizes 1, 3, 5, 70001 (and others) at element offsets 0-3: each
    element in exactly one chunk; a vector chunk's range is 16-byte aligned
    in all four tensors; an aligned leaf's n % 4 tail, and every element of
    a misaligned leaf, goes to the scalar path."""
    offs = flat_offsets(PLAN_SIZES, view_of, start)
    plan = tfo.plan_chunks(PLAN_SIZES, offs, chunk)
    assert plan.dtype == np.int32 and plan.shape[1] == 4
    for leaf, n in enumerate(PLAN_SIZES):
        rows = plan[plan[:, 0] == leaf]
        covered = np.zeros(n, np.int64)
        aligned = not any(offs[leaf])
        for _, vector, count, start_el in rows:
            assert 0 < count <= chunk
            covered[start_el:start_el + count] += 1
            if vector:
                assert aligned and count % 4 == 0
                assert all((o + 4 * start_el) % 16 == 0 for o in offs[leaf])
        assert (covered == 1).all(), leaf
        scalar = sorted((int(s), int(c)) for _, v, c, s in rows if not v)
        want = [(0, n)] if not aligned else ([(n - n % 4, n % 4)] if n % 4 else [])
        assert sum(c for _, c in scalar) == sum(c for _, c in want)
        assert (scalar[0][0] if scalar else None) == (want[0][0] if want else None)


def test_plan_refuses_what_it_cannot_cut():
    with pytest.raises(ValueError, match="multiple of 4"):
        tfo.plan_chunks([8], [[0, 0, 0, 0]], 6)
    with pytest.raises(ValueError, match="elements"):
        tfo.plan_chunks([0], [[0, 0, 0, 0]], 8)


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def card_leaves(device, seed):
    """Leaves of odd sizes, some past several of the kernel's 4096-element
    chunks."""
    rng = np.random.default_rng(seed)
    shapes = [(3,), (17, 9), (70001,), (256, 768), (), (5,), (4096 * 2 + 4,)]
    out = []
    for scale in (1.0, 1.0, 0.01, 0.001):      # params, grads, mu, nu (nu >= 0)
        group = []
        for s in shapes:
            a = np.asarray(rng.standard_normal(s), np.float32) * np.float32(scale)
            a = np.asarray(np.abs(a) if scale == 0.001 else a)     # 0-d stays an array
            group.append(torch.from_numpy(a).to(device))
        out.append(group)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_cuda_kernel_matches_plain_bitwise(cuda_device, wd):
    a, b = card_leaves(cuda_device, 1), card_leaves(cuda_device, 1)
    scal = torch.tensor([0.5, 0.7, -1e-3, 0.3, 0.01], device=cuda_device)
    tfo.fused_adam(tfo.AdamTable(*a), scal, b1=0.9, b2=0.999, eps=1e-8, wd=wd)
    tfo.adam_reference(*b, scal, b1=0.9, b2=0.999, eps=1e-8, wd=wd)
    torch.cuda.synchronize()
    for xs, ys in zip(a, b):
        for x, y in zip(xs, ys):
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_cuda_flat_gradient_views_match_plain_bitwise(cuda_device, wd):
    """Gradients as the engine lays them out: views into one flat buffer,
    so every leaf after one of odd size starts off 16 bytes and takes the
    scalar path; the others take the vector path with their tails."""
    a, b = card_leaves(cuda_device, 2), card_leaves(cuda_device, 2)
    sizes = [t.numel() for t in a[1]]
    for group in (a, b):
        flat = torch.cat([t.reshape(-1) for t in group[1]])
        group[1] = [piece.view(t.shape) for piece, t in zip(torch.split(flat, sizes), group[1])]
    table = tfo.AdamTable(*a)
    kinds = table.chunks[:, 1].tolist()
    assert 0 in kinds and 1 in kinds
    assert any(g.data_ptr() % 16 for g in a[1])
    scal = torch.tensor([0.5, 0.7, -1e-3, 0.3, 0.01], device=cuda_device)
    tfo.fused_adam(table, scal, b1=0.9, b2=0.999, eps=1e-8, wd=wd)
    tfo.adam_reference(*b, scal, b1=0.9, b2=0.999, eps=1e-8, wd=wd)
    torch.cuda.synchronize()
    for xs, ys in zip(a, b):
        for x, y in zip(xs, ys):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_cuda_rejects_what_the_kernel_does_not_take(cuda_device):
    p = [torch.zeros(4, device=cuda_device)]
    with pytest.raises(TypeError):
        tfo.AdamTable([p[0].half()], p, p, p)
    with pytest.raises(ValueError):
        tfo.AdamTable(p, [torch.zeros(5, device=cuda_device)], p, p)
    table = tfo.AdamTable(p, [torch.zeros(4, device=cuda_device)], [torch.zeros(4, device=cuda_device)],
                          [torch.zeros(4, device=cuda_device)])
    with pytest.raises(TypeError):
        tfo.fused_adam(table, torch.zeros(4, device=cuda_device), b1=0.9, b2=0.999, eps=1e-8,
                       wd=0.0)
