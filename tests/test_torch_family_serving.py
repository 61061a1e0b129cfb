"""The port's serving engine (``deepspeed_tpu_torch/serving/``) against the
JAX package's engine and JAX's ``generate()`` on the tiny LLaMA (GQA, rope),
BLOOM (ALiBi), GPT-J (head_dim 256) and GPT-NeoX (head_dim 96) models of
``tests/test_torch_families.py``, on the same weights, with a roomy arena
and one that preempts, evicts and recomputes: greedy tokens identical.

The file stands on its own so that ``--dist loadfile`` gives these eight
cases, the longest of the families' tests, a worker of their own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.serving import DeepSpeedServingConfig as JServingConfig
from deepspeed_tpu.serving import ServingEngine as JServingEngine
from tests.test_torch_families import jax_model, port_model


SERVE_MODELS = ["llama-g2", "bloom", "gptj-d256", "neox-d96"]


@pytest.fixture(scope="module", params=SERVE_MODELS)
def served(request):
    """(name, JAX model, JAX params, port model) on the same weights."""
    jcfg, tree = jax_model(request.param, seed=5)
    return (request.param, jgpt.GPT(jcfg), jax.tree.map(jnp.asarray, tree),
            port_model(request.param, tree))


def serve_both(served, serving, prompts, mnts, stagger):
    _, jmodel, jparams, port = served
    jeng = JServingEngine(jmodel, config=JServingConfig(**serving), params=jparams)
    teng = dst.init_serving(model=port, config={"serving": serving}, device="cpu")
    out = []
    for eng in (jeng, teng):
        futs = [eng.submit(p, max_new_tokens=m)
                for p, m in zip(prompts[:stagger], mnts[:stagger])]
        for _ in range(3):
            eng.step()
        futs += [eng.submit(p, max_new_tokens=m)
                 for p, m in zip(prompts[stagger:], mnts[stagger:])]
        eng.run()
        out.append(futs)
    return out[0], out[1], jeng, teng


@pytest.mark.parametrize("arena", ["roomy", "evicting"])
def test_serving_engine_matches_jax_engine_and_generate(served, arena):
    """The port's engine against JAX's engine and JAX's generate() on the
    tiny LLaMA (GQA, rope), BLOOM (ALiBi), GPT-J (head_dim 256) and GPT-NeoX
    (head_dim 96); the small arena holds a fifth of the requests' KV, so it
    preempts, evicts and recomputes."""
    name, jmodel, jparams, port = served
    rng = np.random.default_rng(6)
    if arena == "roomy":
        lens, mnts = [3, 9, 17, 30, 5, 21, 12, 7], [8, 12, 5, 7, 10, 6, 12, 9]
        serving = dict(block_size=8, num_blocks=64, max_batch_size=4, prefill_chunk=16,
                       dtype="float32")
        stagger = 4
    else:
        lens, mnts = [10, 14, 6, 12, 9, 16], [20, 16, 24, 12, 18, 14]
        serving = dict(block_size=4, num_blocks=10, max_batch_size=4, prefill_chunk=8,
                       max_blocks_per_seq=9, dtype="float32")
        stagger = len(lens)
    prompts = [list(rng.integers(1, port.cfg.vocab_size, size=n)) for n in lens]
    jfuts, tfuts, jeng, teng = serve_both(served, serving, prompts, mnts, stagger)
    if arena == "evicting":
        assert teng.sched.preemption_count > 0 and teng.alloc.eviction_count > 0
        assert teng.sched.preemption_count == jeng.sched.preemption_count
    for i, (p, m, jf, tf) in enumerate(zip(prompts, mnts, jfuts, tfuts)):
        assert tf.done and tf.token_ids == jf.token_ids, (name, i)
        assert tf.token_ids == port.generate([p], m)[0, len(p):].tolist(), (name, i)
    for i in (0, 3):
        jref = np.asarray(jmodel.generate(jparams, np.asarray(prompts[i], np.int32)[None],
                                          mnts[i]))
        assert tfuts[i].token_ids == jref[0, lens[i]:].tolist(), (name, i)
    assert len({t for f in tfuts for t in f.token_ids}) > len(tfuts)
    teng.alloc.check_consistent()
