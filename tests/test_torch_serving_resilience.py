"""The port's serving resilience plane and sampled decoding against
``deepspeed_tpu``'s, on the CPU.

* Bounded dispatch (``serve_step_timeout_s``) and in-process recovery:
  the cases of ``tests/unit/serving/test_serving_resilience.py`` (a wedged
  step, ``result()`` riding through a wedge and ``timeout_s`` bounding the
  wait, the unbounded engine, a restage fault falling back to recompute,
  the serve sites' validation) run under the same plans on a JAX and a
  port engine built once per module: equal tokens (also equal to
  ``generate()``), equal incident, preemption, spill and restage counts,
  no request lost.
* ``init_serving`` takes ``kv_tiering``, ``serve_step_timeout_s > 0`` and
  an installed plan; ``telemetry=`` and ``tracer=`` still raise, naming
  ROADMAP entry 7.
* Sampled ``generate()`` (``temperature > 0``), the model's and
  ``InferenceEngine``'s, gives JAX's tokens when JAX's own Gumbel draws
  are passed in (``noise=``); a seed gives the same output twice and two
  seeds differ.  The inference config takes the keys JAX accepts and
  ignores at JAX's defaults and refuses other values by name.

The bounded worker's device and stream on the card are held by
``tests/test_torch_resilience_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch as dst
from deepspeed_tpu.serving import DeepSpeedServingConfig as JServingConfig
from deepspeed_tpu.serving import ServingEngine as JServingEngine
from deepspeed_tpu.serving.engine import ServeStepTimeout as JServeStepTimeout
from deepspeed_tpu.testing import fault_injection as jfi
from deepspeed_tpu_torch.serving import ServeStepTimeout
from deepspeed_tpu_torch.testing import fault_injection as fi
from tests.torch_serving_common import counts, prompts_of, tiny_models

BOUNDED = dict(block_size=8, num_blocks=64, max_batch_size=4, prefill_chunk=8,
               dtype="float32", serve_step_timeout_s=0.5)
TIERED = dict(block_size=4, num_blocks=10, max_batch_size=4, prefill_chunk=8,
              max_blocks_per_seq=9, dtype="float32", kv_tiering=True)


@pytest.fixture(autouse=True)
def _clean_plans():
    yield
    fi.clear_plan()
    jfi.clear_plan()


@pytest.fixture(scope="module")
def models():
    return tiny_models(seed=1)


def engine_pair(models, serving):
    jmodel, jparams, port = models
    jeng = JServingEngine(jmodel, config=JServingConfig(**serving), params=jparams)
    teng = dst.init_serving(model=port, config={"serving": serving}, device="cpu")
    for eng in (jeng, teng):
        eng.submit([1, 2], max_new_tokens=2).result()     # both phases warm
    return jeng, teng


@pytest.fixture(scope="module")
def bounded(models):
    jeng, teng = engine_pair(models, BOUNDED)
    yield jeng, teng
    jeng.close()
    teng.close()


@pytest.fixture(scope="module")
def tiered(models):
    jeng, teng = engine_pair(models, TIERED)
    yield jeng, teng
    jeng.close()
    teng.close()


def install(plan):
    fi.install_plan(plan)
    jfi.install_plan(plan)


def reference(port, prompt, n):
    return port.generate([prompt], n)[0, len(prompt):].tolist()


# --------------------------------------------------------------------------- #
# bounded dispatch and recovery
# --------------------------------------------------------------------------- #
def test_wedged_step_recovers_token_identical_in_both(models, bounded):
    _, _, port = models
    prompts = prompts_of(5, (6, 11, 4, 9))
    mnts = [8, 5, 10, 7]
    seen = {}
    for name, eng, timeout in (("jax", bounded[0], JServeStepTimeout),
                               ("port", bounded[1], ServeStepTimeout)):
        before = counts(eng)
        futs = [eng.submit(p, max_new_tokens=m) for p, m in zip(prompts, mnts)]
        eng.step()                                 # real progress pre-wedge
        assert eng.sched.active
        (jfi if name == "jax" else fi).install_plan(
            [{"site": "serve.step", "action": "wedge", "on_hit": 1}])
        with pytest.raises(timeout) as ei:
            eng.step()
        assert ei.value.deadline_s == pytest.approx(0.5)
        # recovered before raising: every request requeued, none lost, latched
        assert eng.incident_count == before["incidents"] + 1
        assert not eng.sched.active and len(eng.sched.waiting) == len(futs)
        assert all(r.prefilled == 0 for r in eng.sched.waiting)
        assert eng._incident_health()["ok"] is False
        eng.alloc.check_consistent()
        eng.run()
        assert eng._incident_health()["ok"] is True, "the first clean step clears"
        seen[name] = ([f.token_ids for f in futs], ei.value.op,
                      {k: v - before[k] for k, v in counts(eng).items()})
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == [reference(port, p, m) for p, m in zip(prompts, mnts)]
    assert bounded[1]._bounded.stats()["abandoned"] >= 1


def test_result_rides_through_a_wedge_and_timeout_s_bounds_the_wait(models, bounded):
    _, _, port = models
    seen = {}
    for name, eng in (("jax", bounded[0]), ("port", bounded[1])):
        before = eng.incident_count
        (jfi if name == "jax" else fi).install_plan(
            [{"site": "serve.step", "action": "wedge", "on_hit": 2}])
        fut = eng.submit([3, 1, 4, 1, 5], max_new_tokens=6)
        out = fut.result()                      # rides through the incident
        (jfi if name == "jax" else fi).clear_plan()
        slow = eng.submit([2, 7, 1], max_new_tokens=8)
        with pytest.raises(TimeoutError):
            slow.result(timeout_s=0.0)          # wall-clock bound, not steps
        seen[name] = (out, slow.result(timeout_s=30.0), eng.incident_count - before)
    assert seen["port"] == seen["jax"]
    assert seen["port"] == (reference(port, [3, 1, 4, 1, 5], 6),
                            reference(port, [2, 7, 1], 8), 1)


def test_unbounded_engine_has_no_dispatch_worker(models):
    jmodel, jparams, port = models
    serving = dict(BOUNDED, serve_step_timeout_s=0.0)
    jeng = JServingEngine(jmodel, config=JServingConfig(**serving), params=jparams)
    teng = dst.init_serving(model=port, config=serving, device="cpu")
    assert jeng._bounded is None and teng._bounded is None
    out = teng.submit([9, 8, 7], max_new_tokens=3).result()
    assert out == jeng.submit([9, 8, 7], max_new_tokens=3).result() == reference(
        port, [9, 8, 7], 3)
    for eng in (jeng, teng):
        eng.close()
        eng.close()                             # idempotent


def test_restage_fault_falls_back_to_recompute_in_both(models, tiered):
    """A scripted serve.restage failure on every restage: each spilled
    request recomputes, and the tokens still equal generate()'s."""
    _, _, port = models
    prompts = prompts_of(6, (10, 14, 6, 12, 9))
    mnts = [16, 12, 20, 10, 14]
    install([{"site": "serve.restage", "action": "raise", "times": 100}])
    seen = {}
    for name, eng in (("jax", tiered[0]), ("port", tiered[1])):
        before = counts(eng)
        futs = [eng.submit(p, max_new_tokens=m) for p, m in zip(prompts, mnts)]
        eng.run()
        seen[name] = ([f.token_ids for f in futs],
                      {k: v - before[k] for k, v in counts(eng).items()})
    assert seen["port"] == seen["jax"]
    delta = seen["port"][1]
    assert delta["preemptions"] > 0 and delta["spills"] > 0 and delta["restages"] == 0
    assert seen["port"][0] == [reference(port, p, m) for p, m in zip(prompts, mnts)]
    assert fi.get_injector().rules[0].hits == jfi.get_injector().rules[0].hits > 0
    assert tiered[1].tiering.stats()["kv_spilled_seqs"] == 0
    tiered[1].alloc.check_consistent()


def test_serve_fault_sites_validate_in_both():
    install([{"site": "serve.step", "action": "wedge"},
             {"site": "serve.restage", "action": "raise"}])
    for mod in (fi, jfi):
        mod.clear_plan()
        with pytest.raises(ValueError):
            mod.install_plan([{"site": "serve.steps", "action": "wedge"}])


def test_init_serving_takes_the_resilience_plane(models, tmp_path):
    _, _, port = models
    fi.install_plan([{"site": "serve.step", "action": "delay", "delay_s": 0.0,
                      "times": 1000}])
    eng = dst.init_serving(model=port, device="cpu", config={"serving": dict(
        TIERED, serve_step_timeout_s=5.0, kv_offload_dir=str(tmp_path / "kv"),
        kv_host_cache_bytes=4096, kv_ring_depth=3, kv_spill_chunk_blocks=4)})
    assert eng._config.kv_ring_depth == 3 and eng._config.kv_spill_chunk_blocks == 4
    assert eng.tiering.host_cache_bytes == 4096
    assert eng.tiering.offload_dir == str(tmp_path / "kv")
    assert eng._bounded is not None and eng._bounded.deadline_s == 5.0
    assert eng.submit([5, 6, 7], max_new_tokens=4).result() == reference(port, [5, 6, 7], 4)
    assert fi.get_injector().log, "serve.step fired"
    stats = eng.step()
    assert stats["incidents"] == 0 and "kv_spills" in stats
    eng.close()
    assert (tmp_path / "kv").is_dir(), "a caller's offload dir is the caller's"
    for kwargs in ({"telemetry": object()}, {"tracer": object()}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1 entry 7"):
            dst.init_serving(model=port, device="cpu", config=TIERED, **kwargs)


# --------------------------------------------------------------------------- #
# sampled generate and the inference config
# --------------------------------------------------------------------------- #
def jax_gumbel(key, n, B, V):
    """The draws JAX's ``gpt_generate`` takes: one ``categorical`` a step,
    each from ``split(key, n)[i]``, ``gumbel`` over ``[B, padded_vocab]``."""
    return np.stack([np.asarray(jax.random.gumbel(r, (B, V), jnp.float32))
                     for r in jax.random.split(key, n)])


@pytest.fixture(scope="module")
def sampling_models():
    # vocab 250 pads to 256: the padded columns must never be drawn
    return tiny_models(seed=2, vocab_size=250, n_positions=96)


@pytest.mark.parametrize("temperature", [0.7, 1.3])
def test_sampled_generate_equals_jax_with_its_draws(sampling_models, temperature):
    jmodel, jparams, port = sampling_models
    V = port.cfg.padded_vocab
    ids = np.random.default_rng(3).integers(1, 250, (3, 9)).astype(np.int32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jmodel.generate(jparams, ids, 14, rng=key, temperature=temperature))
    got = port.generate(ids, 14, temperature=temperature,
                        noise=jax_gumbel(key, 14, 3, V)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 9:] < 250).all() and len(set(got[:, 9:].ravel().tolist())) > 10
    # the inference engines, bucketed prompts, the config's seed
    jeng = deepspeed_tpu.init_inference(model=jmodel, params=jparams,
                                        config={"dtype": "float32", "seed": 5})
    teng = dst.init_inference(model=port, device="cpu", config={"dtype": "float32", "seed": 5})
    want = np.asarray(jeng.generate(ids, max_new_tokens=10, temperature=temperature))
    got = teng.generate(ids, max_new_tokens=10, temperature=temperature,
                        noise=jax_gumbel(jax.random.PRNGKey(5), 10, 3, V)).numpy()
    np.testing.assert_array_equal(got, want)


def test_sampled_generate_is_seeded(sampling_models):
    _, _, port = sampling_models
    ids = np.random.default_rng(4).integers(1, 250, (2, 6))

    def run(seed, **cfg):
        eng = dst.init_inference(model=port, device="cpu",
                                 config=dict({"dtype": "float32", "seed": seed}, **cfg))
        return eng.generate(ids, max_new_tokens=12, temperature=1.0).numpy()
    first = run(3)
    np.testing.assert_array_equal(run(3), first)
    assert (run(4) != first).any()
    gen = port.generate(ids, 12, temperature=1.0,
                        generator=torch.Generator().manual_seed(9)).numpy()
    np.testing.assert_array_equal(
        port.generate(ids, 12, temperature=1.0,
                      generator=torch.Generator().manual_seed(9)).numpy(), gen)
    greedy = port.generate(ids, 12).numpy()
    np.testing.assert_array_equal(port.generate(ids, 12, temperature=-1.0).numpy(), greedy)
    with pytest.raises(ValueError, match="noise"):
        port.generate(ids, 12, temperature=1.0, noise=np.zeros((12, 2, 7), np.float32))
    eng = dst.init_serving(model=port, device="cpu", config={"dtype": "float32"})
    with pytest.raises(NotImplementedError, match="greedy"):
        eng.submit([1, 2], max_new_tokens=4, temperature=0.7)


def test_inference_config_takes_jax_defaults_and_refuses_other_values(sampling_models):
    _, _, port = sampling_models
    defaults = {"replace_method": "auto", "triangular_masking": True, "return_tuple": True,
                "max_out_tokens": 1024, "seed": 7, "dtype": "float32"}
    eng = dst.init_inference(model=port, device="cpu", config=defaults)
    assert eng._config.seed == 7 and eng._config.max_tokens == 1024
    dst.init_inference(model=port, device="cpu", config={"tm": True, "dtype": "float32"})
    for key, value in (("replace_method", "layer"), ("triangular_masking", False),
                       ("return_tuple", False), ("max_out_tokens", 64), ("tm", False)):
        name = "triangular_masking" if key == "tm" else key
        with pytest.raises(ValueError, match=f"{name}.*not read by the port's engine"):
            dst.init_inference(model=port, device="cpu", config={key: value})
