"""The port's stability sentinel against the JAX package's, on the CPU
(``runtime/stability.py``, the engine's stability boundary, the value
sites of ``testing/fault_injection.py``).

* ``sentinel_observe`` over seeded sequences of (loss, grad_norm, overflow,
  at_min_scale) that reach every cause code, the warm-up and the EMA
  updates: codes equal, states within 1e-6 relative.
* The host ladder (``StabilitySentinel``) on the same stats: the same
  actions, and ``state_dict`` / ``load_state_dict`` with JAX's merge rules.
* ``fingerprint_batch``: a numpy batch and its torch tensors give JAX's
  fingerprint.
* The engine, 2 layers fp32, a ``train.grads`` nan plan over three steps,
  a checkpoint, a quarantined batch fed again: JAX's and the port's event
  sequences, ``skipped``, quarantine sets and ``get_lr`` are equal; losses
  within 1e-5 relative and parameters within the training tests' limits
  (2e-5, and 2 lr a step for an element whose gradient is at rounding
  level).  The port's JSONL passes ``tools/stability_report.py``.
* The same at gas 2 with a ``train.loss`` nan and spike and a batch whose
  micro-batches are NaN by themselves (a GPT whose batch carries a
  ``poison`` leaf in both packages), those micro-batches fed again after
  the rollback: also the step records' losses equal JAX's.
* With the block on and no fault the step is the one without it, bit for
  bit; a ``train.loss`` spike on a graphed-style step; the ZeRO optimizer
  (stage 2 with CPU offload, a gloo world of one) leaves its shard, its
  host moments and its count unchanged on a skipped step.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import deepspeed_tpu
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.parallel import mesh as mesh_lib
from deepspeed_tpu.runtime import stability as jst
from deepspeed_tpu.runtime.config import DeepSpeedStabilityConfig as JStabilityConfig
from deepspeed_tpu.testing import fault_injection as jfi
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.runtime import stability as tst
from deepspeed_tpu_torch.runtime.config import DeepSpeedStabilityConfig
from deepspeed_tpu_torch.testing import fault_injection as fi
from tests.test_torch_training import MODELS, batch

REPO = Path(__file__).resolve().parents[1]
MICRO, GAS, SEQ, LR = 2, 2, 16, 1e-3
KW = dict(warmup_steps=4, ema_alpha=0.1, grad_spike_factor=4.0, loss_spike_zscore=8.0,
          scale_collapse_windows=2)


@pytest.fixture(autouse=True)
def _clean():
    yield
    fi.clear_plan()
    jfi.clear_plan()


def observations(seed: int):
    """A seeded sequence of (loss, grad_norm, overflow, at_min_scale): a
    warm-up of clean steps, then in a seeded order a grad-norm spike, a
    loss spike, a NaN loss, an infinite norm, an overflow, a run of three
    steps at the minimum loss scale and clean steps."""
    rng = np.random.default_rng(seed)
    blocks = [[0], [1], [2], [3], [4], [5, 5, 5]] + [[7]] * 12
    kinds = [7] * 5 + [k for i in rng.permutation(len(blocks)) for k in blocks[i]]
    out = []
    for kind in kinds:
        loss = np.float32(2.0 + 0.05 * rng.standard_normal())
        norm = np.float32(1.0 + 0.1 * rng.standard_normal())
        overflow = at_min = False
        if kind == 0:
            norm = np.float32(norm * 50)
        elif kind == 1:
            loss = np.float32(loss + 5.0)
        elif kind == 2:
            loss = np.float32(np.nan)
        elif kind == 3:
            norm = np.float32(np.inf)
        elif kind == 4:
            overflow = True
        elif kind == 5:
            at_min = True
        out.append((loss, norm, overflow, at_min))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sentinel_observe_matches_jax(seed):
    js, ts = jst.init_sentinel_state(), tst.init_sentinel_state()
    codes = []
    for loss, norm, overflow, at_min in observations(seed):
        js, jc = jst.sentinel_observe(js, loss, norm, overflow, at_min, **KW)
        ts, tc = tst.sentinel_observe(ts, torch.tensor(loss), torch.tensor(norm),
                                      torch.tensor(overflow), torch.tensor(at_min), **KW)
        assert int(tc) == int(jc)
        codes.append(int(tc))
        for name, a, b in zip(tst.SentinelState._fields, js, ts):
            np.testing.assert_allclose(float(b), float(a), rtol=1e-6, err_msg=name)
    assert set(codes) == set(tst.CAUSE_NAMES), codes       # every cause, and clean
    assert tst.CAUSE_NAMES == jst.CAUSE_NAMES


def test_ladder_actions_and_state_round_trip_match_jax():
    cfg = dict(lr_backoff_after=2, rollback_after=4, max_lr_backoffs=2, max_auto_rollbacks=1,
               quarantine_ring=3)
    jl = jst.StabilitySentinel(JStabilityConfig(enabled=True, **cfg))
    tl = tst.StabilitySentinel(DeepSpeedStabilityConfig(enabled=True, **cfg), read_fn=float)
    codes = [0, 2, 2, 2, 0, 1, 3, 3, 4, 4, 4, 0, 0, 5, 5, 5, 5, 5, 5]
    for step, code in enumerate(codes, start=1):
        stats = {"anomaly_code": np.int32(code), "loss": np.float32(step),
                 "grad_norm": np.float32(0.5), "loss_scale": np.float32(1.0)}
        fps = [f"fp{step}", f"fp{step}b"]
        ja = jl.observe(step, stats, fingerprints=fps)
        ta = tl.observe(step, stats, fingerprints=fps)
        assert ta == ja, step
        if ta is not None and ta["action"] == "rollback":
            assert (tl.after_rollback(tl.episode_fingerprints(), step)
                    == jl.after_rollback(jl.episode_fingerprints(), step))
        if ta is not None and ta["action"] == "lr_backoff":
            jl.note_lr_backoff()
            tl.note_lr_backoff()
    assert tl.drain() == jl.drain()
    assert tl.state_dict() == jl.state_dict()
    # the merge rules: quarantine unions, auto_rollbacks never goes back
    saved = dict(tl.state_dict(), quarantine=[["old", 1]], auto_rollbacks=0)
    tl.load_state_dict(saved)
    jl.load_state_dict(saved)
    assert tl.state_dict() == jl.state_dict() and tl.auto_rollbacks == 1


@pytest.mark.parametrize("dtype", ["int32", "int64", "float32", "uint8"])
def test_fingerprint_is_the_same_for_numpy_and_torch(dtype):
    rng = np.random.default_rng(3)
    ids = (rng.standard_normal((2, 5)) * 50).astype(dtype)
    labels = np.roll(ids, 1, axis=-1)
    want = jst.fingerprint_batch((ids, labels))
    assert tst.fingerprint_batch((ids, labels)) == want
    assert tst.fingerprint_batch((torch.from_numpy(ids), torch.from_numpy(labels))) == want
    assert tst.fingerprint_batch({"b": labels, "a": ids}) == jst.fingerprint_batch(
        {"b": labels, "a": ids})
    assert tst.fingerprint_batch((ids[:1], labels)) != want
    assert tst.fingerprint_batch(()) is None


def engine_config(**extra):
    cfg = {"train_micro_batch_size_per_gpu": MICRO, "gradient_accumulation_steps": GAS,
           "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}},
           "gradient_clipping": 1.0, "steps_per_print": 10 ** 9}
    cfg.update(extra)
    return cfg


STABILITY = {"enabled": True, "warmup_steps": 2, "lr_backoff_after": 2,
             "lr_backoff_factor": 0.5, "rollback_after": 3, "max_auto_rollbacks": 2}
# train.grads hits 3-5 (steps 3-5) are NaN: skip, then LR backoff, then a
# rollback to the step-1 checkpoint that quarantines the three batches
PLAN = [{"site": "train.grads", "action": "nan", "on_hit": 3, "times": 3}]
ITERS = 9


def data(vocab):
    """One batch an iteration; iteration 7 feeds iteration 3's batch again,
    which the quarantine then skips."""
    out = [batch(vocab, MICRO, SEQ, seed=90 + i, gas=GAS) for i in range(ITERS)]
    out[7] = out[3]
    return out


def drive(engine, batches, save_dir, loss_of):
    losses = []
    for it, leaves in enumerate(batches):
        if it == 1:
            engine.save_checkpoint(str(save_dir))
        losses.append(loss_of(engine.train_batch(batch=tuple(leaves))))
    return losses


EVENT_FIELDS = {"anomaly": ("step", "detected_at", "code", "cause", "consecutive"),
                "lr_backoff": ("step", "cause", "factor", "lr_scale", "count"),
                "auto_rollback": ("from_step", "to_step", "tag", "cause", "quarantined",
                                  "count"),
                "batch_quarantined": ("fp", "phase", "step")}


def events(records):
    return [(r["kind"],) + tuple(r.get(k) for k in EVENT_FIELDS[r["kind"]])
            for r in records if r.get("kind") in EVENT_FIELDS]


class JPoisonable(jgpt.GPT):
    """JAX's GPT whose batch carries a third leaf, ``poison``: the loss
    times ``1 + sum(poison)``, so a NaN there makes its micro-batch's loss
    and gradients NaN by themselves (zeros leave them bit for bit)."""

    def __call__(self, params, batch, rng, train, **kw):
        ids, labels, poison = batch
        return super().__call__(params, (ids, labels), rng, train, **kw) * (1.0 + poison.sum())


class TPoisonable(tgpt.GPT):
    """The port's GPT with the same ``poison`` leaf."""

    def forward(self, params, batch, rng=None, train=True, pld_theta=None):
        ids, labels, poison = batch
        return super().forward(params, (ids, labels), rng, train, pld_theta) * (1.0 + poison.sum())


def run_both(tmp_path, monkeypatch, plan, batches, poisonable=False):
    """JAX's engine and the port's, 2 layers fp32 with the stability block
    and telemetry, over ``batches`` under ``plan`` (a checkpoint before
    iteration 1): (the port's results, JAX's, the port's engine, model and
    JSONL).  Results: the returned losses, the ladder's events, the step
    records' losses (None where JAX records none), the quarantine set,
    ``skipped``, the step count, ``get_lr`` and the final parameters."""
    monkeypatch.setenv("DST_PALLAS_CE", "0")
    monkeypatch.setenv("DST_PALLAS_FUSED_OPT", "0")
    jcfg = jgpt.GPTConfig(dtype="float32", scan_layers=True, **MODELS["tiny"])
    jparams = jax.tree.map(lambda a: np.asarray(a),
                           jgpt.GPT(jcfg).init_params(jax.random.PRNGKey(0)))
    tele = {"enabled": True, "flush_every": 1}

    def results(eng, losses, params):
        eng.telemetry.flush()
        records = eng.telemetry.ring.records
        return dict(losses=losses, events=events(records),
                    recorded=[r.get("loss") for r in records if r.get("kind") == "step"],
                    quarantined=eng.stability.quarantined(), skipped=int(eng.skipped_steps),
                    steps=eng.global_steps, lr=eng.get_lr(), params=params)

    mesh = mesh_lib.MeshSpec(device_count=1).build(jax.devices()[:1])
    try:
        jmodel = (JPoisonable if poisonable else jgpt.GPT)(jcfg)
        jeng = deepspeed_tpu.initialize(
            model=jmodel, model_parameters=jparams, mesh=mesh,
            config=engine_config(stability=STABILITY, telemetry=tele,
                                 checkpoint={"engine": "local"}))[0]
        jfi.install_plan(plan)
        jlosses = drive(jeng, batches, tmp_path / "jck", lambda v: float(np.asarray(v)))
        want = results(jeng, jlosses, jeng.state.params)
        jeng.close()
    finally:
        mesh_lib.reset_mesh()
        jfi.clear_plan()

    jsonl = tmp_path / "port.jsonl"
    model = (TPoisonable if poisonable else tgpt.GPT)(
        tgpt.GPTConfig(dtype="float32", **MODELS["tiny"]), device="cpu")
    eng = dst.initialize(model=model, device="cpu", model_parameters=params_from_jax(jparams),
                         config=engine_config(stability=STABILITY,
                                              telemetry=dict(tele, jsonl_path=str(jsonl))))[0]
    fi.install_plan(plan)
    got = results(eng, drive(eng, batches, tmp_path / "tck", float), None)
    return got, want, eng, model, jsonl


def assert_same_run(got, want, model):
    """The port's run against JAX's: events, quarantine, ``skipped``, steps
    and lr equal; returned and recorded losses within 1e-5 relative (NaN
    where JAX's is); parameters within the training tests' limits."""
    assert got["events"] == want["events"]
    assert got["quarantined"] == want["quarantined"]
    for key in ("skipped", "steps", "lr"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    nan = float("nan")
    assert [r is None for r in got["recorded"]] == [r is None for r in want["recorded"]]
    np.testing.assert_allclose([nan if r is None else r for r in got["recorded"]],
                               [nan if r is None else r for r in want["recorded"]], rtol=1e-5)
    ref = params_from_jax(want["params"])
    for k, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - ref[k].numpy())
        assert diff.max() <= 2 * LR * ITERS, k
        assert np.mean(diff <= 2e-5) > 0.99, (k, diff.max())


def test_engine_nan_plan_matches_jax(tmp_path, monkeypatch):
    got, want, eng, model, jsonl = run_both(tmp_path, monkeypatch, PLAN,
                                            data(MODELS["tiny"]["vocab_size"]))
    assert_same_run(got, want, model)
    kinds = [e[0] for e in got["events"]]
    assert kinds.index("lr_backoff") < kinds.index("auto_rollback") < len(kinds)
    assert ("batch_quarantined", "skipped") in {(e[0], e[2]) for e in got["events"]}
    assert len(got["quarantined"]) == 6
    # the rollback restored the checkpoint's count of skipped steps, as in JAX
    assert got["skipped"] == 0
    eng.close()
    spec = importlib.util.spec_from_file_location("stability_report",
                                                  REPO / "tools" / "stability_report.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main([str(jsonl), "--max-rollbacks", "1"]) == 0
    assert tool.main([str(jsonl), "--max-rollbacks", "0"]) == 1
    meta = json.loads((tmp_path / "tck" / "global_step1" / "client_state.json").read_text())
    assert set(meta["stability"]) == {"quarantine", "ring", "lr_backoffs", "auto_rollbacks",
                                      "anomalies_total", "lr_backoff_scale"}


# steps 3-5 (iterations 2-4) are anomalous three ways: a ``train.loss`` nan
# at step 3, a batch whose two micro-batches carry NaN in their ``poison``
# leaf at step 4, a 100x ``train.loss`` spike at step 5
LOSS_PLAN = [{"site": "train.loss", "action": "nan", "on_hit": 3},
             {"site": "train.loss", "action": "spike", "factor": 100.0, "on_hit": 5}]
POISONED_ITER = 3
# after the rollback, iteration 7 feeds the poisoned first micro-batch again
# beside a fresh one, iteration 8 the poisoned last micro-batch
REPLAYS = ((7, 0), (8, 1))            # (iteration, micro-batch)


def poisoned_data(vocab):
    out = []
    for i in range(ITERS):
        ids, labels = batch(vocab, MICRO, SEQ, seed=90 + i, gas=GAS)
        bad = np.full((GAS, MICRO), np.nan if i == POISONED_ITER else 0.0, np.float32)
        out.append((ids, labels, bad))
    for it, m in REPLAYS:
        out[it] = tuple(np.concatenate([own[:m], old[m:m + 1], own[m + 1:]])
                        for own, old in zip(out[it], out[POISONED_ITER]))
    return out


def test_engine_loss_plan_and_poisoned_batches_match_jax(tmp_path, monkeypatch):
    """gas 2.  A nan and a spike at the ``train.loss`` value site, whose
    corrupted loss the sentinel judges and the step record holds while
    ``train_batch`` returns the clean mean, as in JAX; between them a batch
    whose micro-batches give NaN losses and gradients by themselves.  After
    the rollback those micro-batches, fed again beside fresh ones, are
    quarantined and dropped before the device, so the steps stay finite;
    with the last one dropped the sentinel judges a loss of 0 and the step
    records none, as JAX's do."""
    got, want, eng, model, _ = run_both(tmp_path, monkeypatch, LOSS_PLAN,
                                        poisoned_data(MODELS["tiny"]["vocab_size"]),
                                        poisonable=True)
    assert_same_run(got, want, model)
    causes = [e[4] for e in got["events"] if e[0] == "anomaly"]
    assert causes == ["nonfinite_loss", "nonfinite_loss", "loss_spike"], causes
    assert [e[0] for e in got["events"]].count("auto_rollback") == 1
    skipped = [e for e in got["events"] if e[0] == "batch_quarantined" and e[2] == "skipped"]
    assert len(skipped) == len(REPLAYS)
    assert np.isnan(got["losses"][POISONED_ITER]) and np.isfinite(got["losses"][-3:]).all()
    assert got["recorded"][-1] is None and got["recorded"][-2] is not None
    eng.close()


def port_engine(config, seed=0):
    model = tgpt.GPT(tgpt.GPTConfig(dtype="float32", **MODELS["tiny"]), device="cpu", seed=seed)
    return dst.initialize(model=model, device="cpu", config=config, seed=seed)[0], model


def test_stability_on_without_a_fault_is_the_step_without_it_bitwise():
    batches = [batch(300, MICRO, SEQ, seed=40 + i, gas=GAS) for i in range(3)]
    off, moff = port_engine(engine_config())
    on, mon = port_engine(engine_config(stability={"enabled": True}))
    for ids, labels in batches:
        assert torch.equal(off.train_batch(batch=(ids, labels)),
                           on.train_batch(batch=(ids, labels)))
    for (k, a), (_, b) in zip(moff.named_parameters(), mon.named_parameters()):
        assert torch.equal(a, b), k
    assert on.skipped_steps == 0 and int(on.optimizer.count) == 3


def test_loss_spike_plan_is_seen_one_step_later_and_skipped(tmp_path):
    """A ``train.loss`` spike at step 4 (past the warm-up): the loss-spike
    detector fires on the device and the update is skipped; the host
    ladder sees the code at the next boundary."""
    eng, model = port_engine(engine_config(stability=dict(STABILITY, warmup_steps=2),
                                           telemetry={"enabled": True, "flush_every": 1}))
    batches = [batch(300, MICRO, SEQ, seed=50, gas=GAS)] * 6
    fi.install_plan([{"site": "train.loss", "action": "spike", "factor": 100.0, "on_hit": 4}])
    seen = []
    for i, (ids, labels) in enumerate(batches):
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        count = int(eng.optimizer.count)
        eng.train_batch(batch=(ids, labels))
        eng.telemetry.flush()
        seen.append([r["step"] for r in eng.telemetry.ring.records if r["kind"] == "anomaly"])
        if i == 3:
            assert int(eng.optimizer.count) == count
            assert all(torch.equal(p, before[k]) for k, p in model.named_parameters())
    assert seen[3] == [] and seen[4] == [4]
    (rec,) = [r for r in eng.telemetry.ring.records if r["kind"] == "anomaly"]
    assert rec["cause"] == "loss_spike" and rec["detected_at"] == 5
    assert eng.skipped_steps == 1


def test_zero_offload_skip_leaves_shard_host_moments_and_count(monkeypatch):
    """Stage 2 with the moments offloaded (``ZeroAdam``): a skipped step
    writes no partition, no host moment and no count."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    cfg = engine_config(stability=STABILITY, zero_optimization={
        "stage": 2, "offload_optimizer": {"device": "cpu"}})
    eng, _ = port_engine(cfg)
    try:
        ids, labels = batch(300, MICRO, SEQ, seed=70, gas=GAS)
        eng.train_batch(batch=(ids, labels))
        opt = eng.optimizer
        assert opt.mu.host and opt.nu.host

        def state():
            return ([p.detach().clone() for p in eng.module.parameters()]
                    + [torch.cat(opt.mu.pieces), torch.cat(opt.nu.pieces)], int(opt.count))
        before = state()
        fi.install_plan([{"site": "train.grads", "action": "inf", "on_hit": 1}])
        eng.train_batch(batch=(ids, labels))
        after = state()
        assert all(torch.equal(a, b) for a, b in zip(before[0], after[0]))
        assert before[1] == after[1] == 1 and eng.skipped_steps == 1
        fi.clear_plan()
        eng.train_batch(batch=(ids, labels))
        assert int(opt.count) == 2 and not torch.equal(torch.cat(opt.mu.pieces), before[0][-2])
    finally:
        eng.close()
        from deepspeed_tpu_torch import comm
        comm.destroy_process_group()
