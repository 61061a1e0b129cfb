"""Shared by the port's serving-resilience tests (``test_torch_kv_tiering.py``,
``test_torch_serving_resilience.py``): the small GPT of the serving tests
(2 layers, width 32) in both packages on the same weights, drawn with
numpy from a seed and converted with ``models/convert.py``, and
``drive``, which serves one request list on a JAX and a port engine
alike, and ``settle_io``, which takes the disk tier's timing out of the
schedule."""

import numpy as np

import jax
import jax.numpy as jnp

from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import gpt_from_jax

MODEL = dict(vocab_size=128, n_positions=128, n_embd=32, n_layer=2, n_head=4)
# matrices N(0, 0.08), the JAX init's 0.02 scaled as the serving tests do, so
# greedy streams vary; gains and biases keep the init's ones and zeros
WEIGHT_STD = 0.08


def tiny_models(seed: int = 0, **overrides):
    """(JAX model, JAX params, port model) on one set of fp32 weights."""
    dims = dict(MODEL, **overrides)
    jmodel = jgpt.GPT(jgpt.GPTConfig(dtype="float32", **dims))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda a: (rng.normal(0.0, WEIGHT_STD, np.shape(a)).astype(np.float32)
                   if np.ndim(a) >= 2 else np.asarray(a, np.float32)),
        jmodel.init_params(jax.random.PRNGKey(0)))
    port = gpt_from_jax(tgpt.GPTConfig(dtype="float32", **dims), tree, device="cpu")
    return jmodel, jax.tree.map(jnp.asarray, tree), port


def prompts_of(seed: int, lens, vocab: int = MODEL["vocab_size"]):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab, size=n)] for n in lens]


def drive(eng, prompts, mnts, first: int, steps_between: int = 4):
    """Submit ``prompts[:first]``, step ``steps_between`` times, submit the
    rest, ``run()`` to the end.  Returns the futures."""
    futs = [eng.submit(p, max_new_tokens=m) for p, m in zip(prompts[:first], mnts[:first])]
    for _ in range(steps_between):
        eng.step()
    futs += [eng.submit(p, max_new_tokens=m) for p, m in zip(prompts[first:], mnts[first:])]
    eng.run()
    return futs


def settle_io(eng):
    """Make a tiered engine's disk reads and writes land before its
    scheduler next asks whether a spilled request is ready to restage.
    The scheduler skips a request whose prefetch is still in flight, so
    with the disk tier in play the step a restage happens at (and with it
    the preemption and spill counts) follows the staging threads' timing;
    settled, it follows the schedule alone, the same in both packages."""
    mgr = eng.tiering
    begin = mgr.begin_restage

    def begin_restage(rid):
        mgr.staging.drain()        # the spill's write has landed: the read can be issued
        begin(rid)
        mgr.staging.drain()        # ... and has landed
    mgr.begin_restage = begin_restage


def counts(eng):
    """The scheduler and tiering counts the two engines are held to."""
    out = {"preemptions": eng.sched.preemption_count, "spills": eng.sched.spill_count,
           "restages": eng.sched.restage_count, "finished": eng.sched.finished_count,
           "incidents": eng.incident_count}
    if eng.tiering is not None:
        out.update(manager_spills=eng.tiering.spill_count,
                   manager_restages=eng.tiering.restage_count)
    return out
