"""The port's fault-injection harness (``deepspeed_tpu_torch/testing/``)
against ``deepspeed_tpu/testing/fault_injection.py``, and the sites it
drives in the port, on the CPU.

* One plan, fed the same hits, fires the same rules on the same hits in
  both packages (``on_hit``, ``times``, ``match``, several rules); plans
  are validated alike (the same ``SITES`` and ``ACTIONS``; JAX's rules
  have no probability field, and the port's none either: the hit
  counters are the only clock).  ``wedge``, ``delay``, ``raise`` and the
  file corruptions act alike; numeric rules corrupt torch tensors as
  JAX's corrupt arrays; plans load from ``DS_FAULT_PLAN``.
* The ``"faulty"`` checkpoint engine wraps a real one in both; the
  ``ckpt.*`` sites fire in the same order with the same tags in both
  engines' ``save_checkpoint``, and a ``raise`` at ``ckpt.mid_save`` leaves
  the earlier tag as ``latest`` in both.  ``train.step`` fires after each
  step of ``train_batch`` in both; ``comm.collective`` fires in the port's
  collectives.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax

import deepspeed_tpu
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.parallel import mesh as mesh_lib
from deepspeed_tpu.runtime.checkpoint_engine import get_checkpoint_engine as jget_engine
from deepspeed_tpu.testing import fault_injection as jfi
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig
from deepspeed_tpu_torch.runtime.checkpoint_engine import (LocalCheckpointEngine,
                                                           TorchCheckpointEngine,
                                                           get_checkpoint_engine)
from deepspeed_tpu_torch.runtime.checkpointing import list_tags
from deepspeed_tpu_torch.testing import fault_injection as fi

DIMS = dict(vocab_size=128, n_positions=32, n_embd=32, n_layer=2, n_head=4)
TRAIN = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 1,
         "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
         "steps_per_print": 10 ** 9}
CKPT_SITES = ("ckpt.pre_save", "ckpt.mid_save", "ckpt.pre_commit", "ckpt.post_commit")


@pytest.fixture(autouse=True)
def _clean_plans():
    fi.clear_plan()
    jfi.clear_plan()
    yield
    fi.clear_plan()
    jfi.clear_plan()


# --------------------------------------------------------------------------- #
# rules and plans, both packages
# --------------------------------------------------------------------------- #
PLAN_CASES = {
    "nth-hit": ([{"site": "train.step", "action": "raise", "on_hit": 3}],
                [("train.step", {})] * 5),
    "times-window": ([{"site": "serve.step", "action": "raise", "on_hit": 2, "times": 2}],
                     [("serve.step", {"step": i}) for i in range(5)]),
    "match-filter": ([{"site": "ckpt.pre_commit", "action": "raise", "match": {"tag": "t2"}}],
                     [("ckpt.pre_commit", {"tag": t}) for t in ("t1", "t2", "t1", "t2")]),
    "site-mismatch": ([{"site": "train.step", "action": "raise"}],
                      [("train.loss", {}), ("comm.collective", {"op": "all_reduce"})]),
    "two-rules": ([{"site": "comm.collective", "action": "raise", "on_hit": 2,
                    "match": {"op": "all_gather"}},
                   {"site": "serve.restage", "action": "delay", "delay_s": 0.0,
                    "times": 3}],
                  [("comm.collective", {"op": o}) for o in ("all_gather", "all_reduce",
                                                            "all_gather", "all_gather")]
                  + [("serve.restage", {"rid": r}) for r in range(4)]),
}


def replay(injector, hits, raised_type):
    out = []
    for site, ctx in hits:
        try:
            injector.fire(site, **ctx)
            out.append(False)
        except raised_type:
            out.append(True)
    return out, [(e["site"], e["action"], e["hit"], e["ctx"]) for e in injector.log]


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_one_plan_fires_alike_in_both_packages(case):
    plan, hits = PLAN_CASES[case]
    got = replay(fi.FaultInjector(plan), hits, fi.FaultInjected)
    want = replay(jfi.FaultInjector(plan), hits, jfi.FaultInjected)
    assert got == want
    assert any(got[0]) or case in ("site-mismatch", "two-rules")


def test_plans_validate_alike():
    assert sorted(fi.SITES) == sorted(jfi.SITES) and fi.ACTIONS == jfi.ACTIONS
    assert fi.NUMERIC_ACTIONS == jfi.NUMERIC_ACTIONS
    for bad, match in (({"site": "serve.steps", "action": "wedge"}, "unknown fault site"),
                       ({"site": "train.step", "action": "explode"}, "unknown fault action"),
                       ({"action": "raise"}, "missing 'site'")):
        for mod in (fi, jfi):
            with pytest.raises(ValueError, match=match):
                mod.install_plan([bad])
    fi.install_plan([{"site": "serve.step", "action": "wedge"},
                     {"site": "serve.restage", "action": "raise"}])


def test_raise_carries_errno_and_is_an_oserror():
    inj = fi.FaultInjector([{"site": "train.step", "action": "raise", "errno": 28,
                             "message": "disk full"}])
    with pytest.raises(OSError) as ei:
        inj.fire("train.step")
    assert ei.value.errno == 28 and "disk full" in str(ei.value)


def test_wedge_parks_until_released_and_its_cap_expires():
    fi.arm_wedges()
    inj = fi.FaultInjector([{"site": "serve.step", "action": "wedge"}])
    done = threading.Event()
    t = threading.Thread(target=lambda: (inj.fire("serve.step", step=1), done.set()),
                         daemon=True)
    t.start()
    assert not done.wait(0.2)              # parked
    fi.release_wedges()
    assert done.wait(2.0)
    t.join(2.0)
    fi.arm_wedges()
    capped = fi.FaultInjector([{"site": "serve.step", "action": "wedge", "max_wedge_s": 0.1}])
    t0 = time.monotonic()
    capped.fire("serve.step")
    assert 0.05 <= time.monotonic() - t0 < 5.0
    slow = fi.FaultInjector([{"site": "train.step", "action": "delay", "delay_s": 0.05}])
    t0 = time.monotonic()
    slow.fire("train.step")
    assert time.monotonic() - t0 >= 0.04


@pytest.mark.parametrize("site", ["train.loss", "train.grads"])
def test_unplanted_value_sites_are_refused(site, monkeypatch):
    """The value sites are planted since ``runtime/stability.py``: a plan at
    either installs in process and through DS_FAULT_PLAN, as JAX's does,
    arms the engine's device seam, and the seam's hits corrupt a value as
    :func:`numeric_fault` does (none is refused any more)."""
    assert site in fi.SITES and site in fi.VALUE_SITES
    rule = {"site": site, "action": "nan"}
    fi.install_plan([rule])
    assert fi.value_sites_armed()
    mult, add = fi.numeric_seam(site)
    assert np.isnan(2.0 * mult + add)
    assert fi.numeric_seam(site) == (1.0, -0.0)        # one hit only
    monkeypatch.setenv(fi.PLAN_ENV, json.dumps([rule]))
    fi.clear_plan()
    assert fi.get_injector().rules[0].site == site
    fi.clear_plan()
    monkeypatch.delenv(fi.PLAN_ENV)
    assert not fi.value_sites_armed()
    jfi.install_plan([rule])            # JAX's engine plants it
    jfi.clear_plan()


@pytest.mark.parametrize("action,spec,want", [
    ("nan", {}, float("nan")), ("inf", {}, float("inf")),
    ("spike", {"factor": 100.0}, -250.0), ("spike", {}, -2500.0),
])
def test_seam_hits_corrupt_as_numeric_fault(action, spec, want):
    """``value * mult + add`` gives what :func:`numeric_fault` gives for a
    finite value, and ``(1, -0.0)`` leaves every value bit for bit."""
    rule = dict({"site": "train.grads", "action": action, "on_hit": 2}, **spec)
    seam = fi.FaultInjector([rule])
    host = fi.FaultInjector([rule])
    for hit in range(3):
        mult, add = seam.seam("train.grads")
        x = torch.tensor([-2.5, -0.0, 0.0, 1e-30], dtype=torch.float32)
        got = x * mult + add
        ref = host.transform("train.grads", x.clone())
        if hit != 1:
            assert (mult, add) == (1.0, -0.0)
            assert torch.equal(got, x) and torch.equal(torch.signbit(got), torch.signbit(x))
        else:
            assert torch.allclose(got[:1], ref[:1], equal_nan=True)
            assert np.isclose(float(got[0]), want, equal_nan=True)


def test_numeric_rules_corrupt_torch_values_as_jax_corrupts_arrays(monkeypatch):
    plan = [{"site": "train.grads", "action": "nan"},
            {"site": "train.loss", "action": "spike", "factor": 100.0, "on_hit": 2}]
    value = {"w": np.full((2, 3), 2.0, np.float32), "step": np.int32(7)}
    fi.install_plan(plan)
    jfi.install_plan(plan)
    got = fi.numeric_fault("train.grads", {"w": torch.from_numpy(value["w"]),
                                           "step": torch.tensor(7, dtype=torch.int32)})
    want = jfi.numeric_fault("train.grads", value)
    assert torch.isnan(got["w"]).all() and np.isnan(np.asarray(want["w"])).all()
    assert int(got["step"]) == int(want["step"]) == 7
    losses = [fi.numeric_fault("train.loss", torch.tensor(1.5)) for _ in range(3)]
    jlosses = [jfi.numeric_fault("train.loss", np.float32(1.5)) for _ in range(3)]
    assert [float(x) for x in losses] == [float(x) for x in jlosses] == [1.5, 150.0, 1.5]
    fi.clear_plan()
    x = torch.ones(3)
    assert fi.numeric_fault("train.loss", x) is x
    inf = fi.FaultInjector([{"site": "train.loss", "action": "inf"}])
    assert torch.isinf(inf.transform("train.loss", [torch.ones(2)])[0]).all()


def test_plans_load_from_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv(fi.PLAN_ENV, json.dumps([{"site": "train.step", "action": "raise"}]))
    fi.clear_plan()
    with pytest.raises(fi.FaultInjected):
        fi.fault_point("train.step")
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps([{"site": "ckpt.pre_save", "action": "raise"}]))
    monkeypatch.setenv(fi.PLAN_ENV, f"@{plan}")
    fi.clear_plan()
    assert fi.get_injector() is not None
    with pytest.raises(fi.FaultInjected):
        fi.fault_point("ckpt.pre_save")
    fi.fault_point("train.step")


def test_file_corruptions_match_jax(tmp_path):
    for name, mod in (("port", fi), ("jax", jfi)):
        d = tmp_path / name
        d.mkdir()
        (d / "b.bin").write_bytes(b"xyz")
        (d / "a.bin").write_bytes(bytes(range(16)))
        mod.bitflip_file(str(d))                  # sorted walk: a.bin
        mod.bitflip_file(str(d / "b.bin"), offset=1)
        (d / "c.bin").write_bytes(b"0123456789")
        mod.truncate_file(str(d / "c.bin"), size=4)
    for f in ("a.bin", "b.bin", "c.bin"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()
    assert (tmp_path / "port" / "a.bin").read_bytes() != bytes(range(16))
    # the port's engines write <path>.pt / .npz: a rule may name <path>
    (tmp_path / "state.npz").write_bytes(b"\x00" * 4)
    fi.bitflip_file(str(tmp_path / "state"), offset=2)
    assert (tmp_path / "state.npz").read_bytes() == b"\x00\x00\xff\x00"


def test_comm_collective_site_fires_in_the_port_collectives():
    fi.install_plan([{"site": "comm.collective", "action": "raise", "times": 10,
                      "match": {"op": "all_reduce"}}])
    with pytest.raises(fi.FaultInjected):
        comm.all_reduce(torch.ones(4))
    fi.install_plan([{"site": "comm.collective", "action": "raise", "times": 10}])
    for call in (lambda: comm.all_gather(torch.zeros(4), torch.ones(4)),
                 lambda: comm.reduce_scatter(torch.zeros(1), torch.ones(4)),
                 lambda: comm.broadcast(torch.ones(4))):
        with pytest.raises(fi.FaultInjected):
            call()
    assert [e["ctx"]["op"] for e in fi.get_injector().log] == [
        "all_gather", "reduce_scatter", "broadcast"]


# --------------------------------------------------------------------------- #
# the "faulty" checkpoint engine
# --------------------------------------------------------------------------- #
def test_faulty_engine_wraps_a_real_one_in_both(tmp_path):
    plan = [{"site": "engine.commit", "action": "raise"}]
    ce = get_checkpoint_engine("faulty", config_params={"inner": "local", "plan": plan})
    jce = jget_engine("faulty", config_params={"inner": "local", "plan": plan})
    assert isinstance(ce, fi.FaultyCheckpointEngine) and isinstance(ce.inner,
                                                                    LocalCheckpointEngine)
    assert isinstance(jce, jfi.FaultyCheckpointEngine)
    for engine, err in ((ce, fi.FaultInjected), (jce, jfi.FaultInjected)):
        with pytest.raises(err):
            engine.commit("t")
    assert isinstance(get_checkpoint_engine("faulty", config_params={"inner": "torch"}).inner,
                      TorchCheckpointEngine)
    assert get_checkpoint_engine("faulty", async_save=True,
                                 config_params={"inner": "torch"}).async_save
    # pass-through round trip; an OSError on the 2nd write; a silent bitflip
    tree = {"a": {"b": torch.arange(6.0).reshape(2, 3)}}
    inj = fi.FaultInjector([{"site": "engine.save", "action": "raise", "on_hit": 2},
                            {"site": "engine.post_save", "action": "bitflip",
                             "match": {"path": str(tmp_path / "rot")}}])
    ce = fi.FaultyCheckpointEngine(LocalCheckpointEngine(), injector=inj)
    ce.create("t")
    ce.save(tree, str(tmp_path / "s1"))
    assert ce.commit("t")
    assert torch.equal(ce.load(str(tmp_path / "s1"))["a"]["b"], tree["a"]["b"])
    with pytest.raises(OSError):
        ce.save(tree, str(tmp_path / "s2"))
    ce.save(tree, str(tmp_path / "rot"))      # no exception: silent rot
    assert (tmp_path / "rot.npz").read_bytes() != (tmp_path / "s1.npz").read_bytes()


def test_ckpt_sites_and_train_step_in_both_engines(tmp_path):
    """Both engines on the same weights: ``train.step`` fires once a step
    with the step number; the four ``ckpt.*`` sites fire in the same order
    with the same tags; a ``raise`` at ``ckpt.mid_save`` of a second save
    leaves the first tag ``latest`` (the staged one never promoted), and a
    load resumes it."""
    jcfg = jgpt.GPTConfig(dtype="float32", scan_layers=True, **DIMS)
    tree = jax.tree.map(np.asarray, jgpt.GPT(jcfg).init_params(jax.random.PRNGKey(0)))
    ids = np.random.default_rng(0).integers(0, DIMS["vocab_size"], (1, 2, 16)).astype(np.int32)
    batch = (ids, np.roll(ids, -1, axis=-1))
    seen = {}
    mesh = mesh_lib.MeshSpec(device_count=1).build(jax.devices()[:1])
    try:
        jeng = deepspeed_tpu.initialize(model=jgpt.GPT(jcfg), model_parameters=tree,
                                        config=TRAIN, mesh=mesh)[0]
        teng = dst.initialize(model=GPT(GPTConfig(dtype="float32", **DIMS), device="cpu"),
                              config=TRAIN, device="cpu",
                              model_parameters=params_from_jax(tree))[0]
        for name, eng, mod in (("jax", jeng, jfi), ("port", teng, fi)):
            save_dir = str(tmp_path / name)
            inj = mod.install_plan([{"site": s, "action": "delay", "delay_s": 0.0,
                                     "times": 100} for s in ("train.step",) + CKPT_SITES])
            for _ in range(2):
                eng.train_batch(batch=batch)
            eng.save_checkpoint(save_dir, tag="first")
            mod.install_plan([{"site": "ckpt.mid_save", "action": "raise"}])
            with pytest.raises(mod.FaultInjected):
                eng.save_checkpoint(save_dir, tag="second")
            with open(os.path.join(save_dir, "latest")) as f:
                latest = f.read().strip()
            mod.clear_plan()
            path, _ = eng.load_checkpoint(save_dir)
            seen[name] = dict(
                log=[(e["site"], e["ctx"].get("step"), e["ctx"].get("tag"))
                     for e in inj.log],
                latest=latest, loaded=os.path.basename(str(path).rstrip("/")),
                steps=eng.global_steps)
    finally:
        mesh_lib.reset_mesh()
    assert seen["port"] == seen["jax"]
    assert seen["port"]["latest"] == "first" and seen["port"]["steps"] == 2
    assert [s for s, _, _ in seen["port"]["log"]] == ["train.step"] * 2 + list(CKPT_SITES)
    assert list_tags(str(tmp_path / "port")) == ["first"]
