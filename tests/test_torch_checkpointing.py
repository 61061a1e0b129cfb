"""Checkpoints of the port (``runtime/checkpointing.py``,
``runtime/checkpoint_engine/``, ``utils/zero_to_fp32.py``, ``ckpt_cli.py``)
on the CPU, against the uninterrupted run and against the JAX package.

* Round trip: train, save, load into a fresh engine, continue; losses,
  parameters, moments and ``count`` are bit-equal to the uninterrupted run
  (GAS 2, a linear ``WarmupLR``, so a wrong count or schedule step shows).
* Against JAX: the JAX engine trains 2 steps, saves, a second JAX engine
  loads and trains 2 more; the port does the same from ``params_from_jax``
  of the same init.  Losses and grad norms within 1e-5 relative, final
  parameters to ``tests/test_torch_training.py``'s engine limits.
* Manifests both ways: a port checkpoint passes the JAX package's
  ``verify_manifest`` and ``tools/verify_checkpoint.py``; a JAX-written
  manifest passes the port's.
* Faults: a flipped byte, a truncated file and a ``latest`` naming a lost
  tag roll back to the earlier tag; an explicit corrupt tag raises
  ``CheckpointCorruptError``; ``keep_last_n``, ``save_latest=False``,
  ``load_module_only``; ``preemption_enabled`` raises naming item 8.  A
  tag that verifies but does not fit (one leaf of the wrong shape, or an
  ``lr_scale`` other than 1, which only the unported stability sentinel
  sets) is refused before anything is written: the engine is unchanged.
* Async save: training goes on while the finalizer runs; after the wait a
  fresh engine loads and equals; the finalizer and writer threads make no
  CUDA call.
* Tools: ``zero_to_fp32.py`` (the copy in the save dir, run there) gives
  back the parameters exactly; ``ckpt_cli inspect`` lists them.
"""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import deepspeed_tpu
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.parallel import mesh as mesh_lib
from deepspeed_tpu.runtime.checkpoint_engine import manifest as jmanifest
from deepspeed_tpu_torch import ckpt_cli
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig
from deepspeed_tpu_torch.runtime.checkpoint_engine import (LocalCheckpointEngine,
                                                           TorchCheckpointEngine,
                                                           get_checkpoint_engine)
from deepspeed_tpu_torch.runtime.checkpoint_engine import manifest as tmanifest
from deepspeed_tpu_torch.runtime.fault_tolerance import CheckpointCorruptError

REPO = Path(__file__).resolve().parents[1]
DIMS = dict(vocab_size=300, n_positions=64, n_embd=32, n_layer=2, n_head=4)
GAS, MICRO, SEQ, LR = 2, 2, 16, 1e-3


def config(**extra):
    return dict({"train_micro_batch_size_per_gpu": MICRO, "gradient_accumulation_steps": GAS,
                 "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}},
                 "scheduler": {"type": "WarmupLR", "params": {
                     "warmup_num_steps": 4, "warmup_max_lr": LR, "warmup_type": "linear"}},
                 "gradient_clipping": 1.0, "steps_per_print": 10 ** 9}, **extra)


def engine(seed=0, model_parameters=None, **extra):
    model = GPT(GPTConfig(dtype="float32", remat=True, **DIMS), device="cpu", seed=seed)
    return dst.initialize(model=model, config=config(**extra), device="cpu",
                          model_parameters=model_parameters)[0]


def batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, DIMS["vocab_size"], (GAS, MICRO, SEQ)).astype(np.int32)
        out.append((ids, np.roll(ids, -1, axis=-1)))
    return out


def train(eng, bs):
    return [float(eng.train_batch(batch=b)) for b in bs]


def assert_same_state(a, b):
    for (k, x), y in zip(a.module.named_parameters(), b._leaves):
        assert torch.equal(x, y), k
    oa, ob = a.optimizer, b.optimizer
    for x, y in zip(oa.mu + oa.nu, ob.mu + ob.nu):
        assert torch.equal(x, y)
    assert int(oa.count) == int(ob.count)
    assert (a.global_steps, a.global_samples, a.micro_steps) == (
        b.global_steps, b.global_samples, b.micro_steps)
    assert a.lr_scheduler.state_dict() == b.lr_scheduler.state_dict()


def state_file(tag_dir):
    for name in ("state.pt", "state.npz"):
        if os.path.isfile(os.path.join(tag_dir, name)):
            return os.path.join(tag_dir, name)
    raise FileNotFoundError(tag_dir)


def flip_byte(path, offset=None):
    data = bytearray(Path(path).read_bytes())
    i = len(data) // 2 if offset is None else offset
    data[i] ^= 0xFF
    Path(path).write_bytes(bytes(data))


# --------------------------------------------------------------------------- #
# round trip
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("store", ["torch", "local"])
def test_resumed_run_equals_the_uninterrupted_one_bitwise(tmp_path, store):
    bs = batches(6, seed=1)
    whole = engine()
    want = train(whole, bs)
    first = engine(checkpoint={"engine": store})
    got = train(first, bs[:3])
    first.save_checkpoint(str(tmp_path), client_state={"epoch": 7})
    resumed = engine(seed=99, checkpoint={"engine": store})   # other weights until the load
    path, client = resumed.load_checkpoint(str(tmp_path))
    assert path == str(tmp_path / "global_step3") and client == {"epoch": 7}
    assert resumed.get_lr() == pytest.approx(whole_lr_at(3), rel=1e-6)
    got += train(resumed, bs[3:])
    assert got == want
    assert_same_state(whole, resumed)


def whole_lr_at(step):
    return [LR * min(step / 4, 1.0)]


def test_layout_matches_the_jax_engine(tmp_path):
    eng = engine()
    train(eng, batches(2))
    eng.save_checkpoint(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["global_step2", "latest", "zero_to_fp32.py"]
    assert (tmp_path / "latest").read_text() == "global_step2"
    tag = tmp_path / "global_step2"
    assert sorted(os.listdir(tag)) == ["MANIFEST.json", "client_state.json", "state.pt"]
    meta = json.loads((tag / "client_state.json").read_text())
    assert {k: meta[k] for k in ("global_steps", "global_samples", "micro_steps")} == {
        "global_steps": 2, "global_samples": 2 * GAS * MICRO, "micro_steps": 2 * GAS}
    assert meta["lr_scheduler"] == {"last_batch_iteration": 1, "lr_scale": 1.0}
    manifest = json.loads((tag / "MANIFEST.json").read_text())
    assert manifest["meta"]["tag"] == "global_step2" and manifest["file_count"] == 2


def test_local_engine_stores_bf16_through_fp32_exactly(tmp_path):
    ce = LocalCheckpointEngine()
    x = torch.randn(5, 7).to(torch.bfloat16)
    ce.save({"a": {"b": x}, "n": torch.tensor(3, dtype=torch.int32)}, str(tmp_path / "state"))
    back = ce.load(str(tmp_path / "state"))
    assert back["a"]["b"].dtype == torch.float32
    assert torch.equal(back["a"]["b"].to(torch.bfloat16), x) and int(back["n"]) == 3
    assert isinstance(get_checkpoint_engine("orbax"), TorchCheckpointEngine)
    assert isinstance(get_checkpoint_engine("default"), TorchCheckpointEngine)
    with pytest.raises(NotImplementedError, match="item 8"):
        get_checkpoint_engine("faulty")
    with pytest.raises(ValueError):
        get_checkpoint_engine("nope")


# --------------------------------------------------------------------------- #
# against the JAX engine
# --------------------------------------------------------------------------- #
def test_resume_matches_a_resumed_jax_run(monkeypatch, tmp_path):
    monkeypatch.setenv("DST_PALLAS_CE", "1")
    monkeypatch.setenv("DST_PALLAS_FUSED_OPT", "1")
    jcfg = jgpt.GPTConfig(dtype="float32", scan_layers=True, **DIMS)
    jparams = jax.tree.map(lambda a: np.asarray(a) * (4.0 if np.ndim(a) >= 2 else 1.0),
                           jgpt.GPT(jcfg).init_params(jax.random.PRNGKey(0)))
    bs = batches(4, seed=21)
    cfg = config()
    mesh = mesh_lib.MeshSpec(device_count=1).build(jax.devices()[:1])
    jlosses, jnorms = [], []
    try:
        for part, start in ((bs[:2], None), (bs[2:], jparams)):
            jeng, _, _, _ = deepspeed_tpu.initialize(
                model=jgpt.GPT(jcfg), model_parameters=jparams, config=cfg, mesh=mesh)
            if start is not None:
                path, _ = jeng.load_checkpoint(str(tmp_path / "jax"))
                assert path is not None and jeng.global_steps == 2
            for ids, labels in part:
                jlosses.append(float(jeng.train_batch(batch=(ids, labels))))
                jnorms.append(jeng.get_global_grad_norm())
            if start is None:
                jeng.save_checkpoint(str(tmp_path / "jax"))
        jfinal = jeng.state.params
    finally:
        mesh_lib.reset_mesh()

    sd = params_from_jax(jparams)
    first = engine(model_parameters=sd)
    losses, norms = [], []
    for b in bs[:2]:
        losses.append(float(first.train_batch(batch=b)))
        norms.append(first.get_global_grad_norm())
    first.save_checkpoint(str(tmp_path / "port"))
    resumed = engine(seed=5)
    resumed.load_checkpoint(str(tmp_path / "port"))
    for b in bs[2:]:
        losses.append(float(resumed.train_batch(batch=b)))
        norms.append(resumed.get_global_grad_norm())
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    np.testing.assert_allclose(norms, jnorms, rtol=1e-5)
    got = dict(resumed.module.named_parameters())
    E = DIMS["n_embd"]
    for k, v in params_from_jax(jfinal).items():
        diff = np.abs(got[k].detach().numpy() - v.numpy())
        assert diff.max() <= 2 * LR * len(bs), k
        if k.endswith("qkv_b"):
            diff = np.concatenate([diff[:E], diff[2 * E:]])     # all but the key bias
        assert diff.max() <= 2e-5, (k, diff.max())
    assert int(resumed.optimizer.count) == 4 and resumed.global_steps == 4


# --------------------------------------------------------------------------- #
# manifests both ways
# --------------------------------------------------------------------------- #
def test_a_port_checkpoint_passes_the_jax_verifiers(tmp_path):
    eng = engine()
    train(eng, batches(1))
    eng.save_checkpoint(str(tmp_path))
    report = jmanifest.verify_manifest(str(tmp_path / "global_step1"))
    assert report["status"] == "verified" and report["checked"] == 2
    out = subprocess.run([sys.executable, str(REPO / "tools" / "verify_checkpoint.py"),
                          str(tmp_path)], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert json.loads(out.stdout)["verified"] == 1


def test_the_jax_verifier_exits_1_on_a_flipped_byte(tmp_path):
    eng = engine()
    train(eng, batches(1))
    eng.save_checkpoint(str(tmp_path))
    flip_byte(state_file(tmp_path / "global_step1"))
    out = subprocess.run([sys.executable, str(REPO / "tools" / "verify_checkpoint.py"),
                          str(tmp_path)], capture_output=True, text=True, timeout=120)
    assert out.returncode == 1 and json.loads(out.stdout)["corrupt"] == 1


def test_ckpt_cli_verify_gives_the_jax_verifiers_exit_codes(tmp_path, capsys):
    two_tags(tmp_path)
    assert ckpt_cli.main(["verify", str(tmp_path)]) == 0
    assert json.loads(capsys.readouterr().out)["verified"] == 1
    assert ckpt_cli.main(["verify", str(tmp_path), "--all"]) == 0
    assert json.loads(capsys.readouterr().out)["verified"] == 2
    flip_byte(state_file(tmp_path / "global_step1"))
    assert ckpt_cli.main(["verify", str(tmp_path)]) == 0           # latest is step 2
    assert ckpt_cli.main(["verify", str(tmp_path), "--tag", "global_step1"]) == 1
    assert ckpt_cli.main(["verify", str(tmp_path), "--tag", "global_step1", "--shallow"]) == 0
    assert ckpt_cli.main(["verify", str(tmp_path / "nope")]) == 2
    capsys.readouterr()


def test_a_jax_written_manifest_passes_the_ports(tmp_path):
    (tmp_path / "state").mkdir()
    (tmp_path / "state" / "leaf").write_bytes(os.urandom(4096))
    (tmp_path / "client_state.json").write_text("{}")
    jmanifest.write_manifest(str(tmp_path), extra={"tag": "t"})
    ok, report = tmanifest.manifest_ok(str(tmp_path))
    assert ok and report["status"] == "verified" and report["checked"] == 2
    flip_byte(tmp_path / "state" / "leaf", 10)
    assert tmanifest.verify_manifest(str(tmp_path))["status"] == "corrupt"


# --------------------------------------------------------------------------- #
# faults
# --------------------------------------------------------------------------- #
def two_tags(tmp_path, **extra):
    eng = engine(**extra)
    bs = batches(2, seed=4)
    train(eng, bs[:1])
    eng.save_checkpoint(str(tmp_path))
    step1 = [p.clone() for p in eng._leaves]
    train(eng, bs[1:])
    eng.save_checkpoint(str(tmp_path))
    return eng, step1


@pytest.mark.parametrize("fault", ["flipped-byte", "truncated", "latest-names-a-lost-tag"])
def test_a_torn_newest_tag_rolls_back_to_the_earlier_one(tmp_path, fault):
    _, step1 = two_tags(tmp_path)
    newest = tmp_path / "global_step2"
    if fault == "flipped-byte":
        flip_byte(state_file(newest))
    elif fault == "truncated":
        path = state_file(newest)
        os.truncate(path, os.path.getsize(path) // 2)
    else:
        import shutil
        shutil.rmtree(newest)
    fresh = engine(seed=8)
    path, _ = fresh.load_checkpoint(str(tmp_path))
    assert path == str(tmp_path / "global_step1") and fresh.global_steps == 1
    for a, b in zip(step1, fresh._leaves):
        assert torch.equal(a, b)


def engine_state(eng):
    """Every value a load writes, as copies."""
    opt = eng.optimizer
    tensors = [t.clone() for t in list(eng._leaves) + opt.mu + opt.nu + [opt.count]
               + list(eng.scaler)]
    return tensors, (eng.global_steps, eng.global_samples, eng.micro_steps,
                     eng.lr_scheduler.state_dict())


def assert_unchanged(eng, before):
    tensors, counters = engine_state(eng)
    assert all(torch.equal(a, b) for a, b in zip(before[0], tensors))
    assert counters == before[1]


def misfit(tmp_path, fault):
    """One saved tag, rewritten so that it still verifies (a fresh
    manifest) and does not fit the engine in exactly one place, the last
    one a load would reach in its group."""
    eng = engine()
    train(eng, batches(1, seed=12))
    eng.save_checkpoint(str(tmp_path))
    tag = tmp_path / "global_step1"
    store = TorchCheckpointEngine()
    tree = store.load(str(tag / "state"))
    last = eng._names[-1]
    if fault == "param-shape":
        tree["params"][last] = torch.zeros(3)
    elif fault == "nu-shape":
        tree["opt_state"]["nu"][last] = torch.zeros(3)
    elif fault == "count-shape":
        tree["opt_state"]["count"] = torch.zeros(2, dtype=torch.int32)
    store.save(tree, str(tag / "state"))
    meta = json.loads((tag / "client_state.json").read_text())
    if fault == "lr-scale":
        meta["lr_scheduler"]["lr_scale"] = 0.5
    (tag / "client_state.json").write_text(json.dumps(meta))
    extra = json.loads((tag / "MANIFEST.json").read_text())["meta"]
    os.remove(tag / "MANIFEST.json")
    tmanifest.write_manifest(str(tag), extra=extra)
    assert tmanifest.manifest_ok(str(tag))[0]


@pytest.mark.parametrize("fault", ["param-shape", "nu-shape", "count-shape", "lr-scale"])
def test_a_tag_that_does_not_fit_is_refused_and_changes_nothing(tmp_path, fault):
    misfit(tmp_path, fault)
    eng = engine(seed=8)
    train(eng, batches(2, seed=13))
    before = engine_state(eng)
    # through 'latest': the restore fails, rollback finds no other tag
    assert eng.load_checkpoint(str(tmp_path)) == (None, {})
    assert_unchanged(eng, before)
    # by its name: the cause is raised
    with pytest.raises(NotImplementedError if fault == "lr-scale" else ValueError,
                       match="item 8" if fault == "lr-scale" else "shape"):
        eng.load_checkpoint(str(tmp_path), tag="global_step1")
    assert_unchanged(eng, before)
    # and the engine trains on as if nothing had been tried
    ref = engine(seed=8)
    train(ref, batches(2, seed=13))
    assert train(eng, batches(1, seed=14)) == train(ref, batches(1, seed=14))


def test_schedule_state_saves_lr_scale_one_and_refuses_another():
    eng = engine()
    train(eng, batches(2))
    sched = eng.lr_scheduler
    assert sched.state_dict() == {"last_batch_iteration": 1, "lr_scale": 1.0}
    with pytest.raises(NotImplementedError, match=r"Queue 1 item 8"):
        sched.load_state_dict({"last_batch_iteration": 7, "lr_scale": 0.5})
    assert sched.last_batch_iteration == 1
    sched.load_state_dict({"last_batch_iteration": 7, "lr_scale": 1.0})
    assert sched.last_batch_iteration == 7


def test_an_explicit_corrupt_tag_raises_a_named_error(tmp_path):
    two_tags(tmp_path)
    flip_byte(state_file(tmp_path / "global_step2"))
    with pytest.raises(CheckpointCorruptError, match="global_step2"):
        engine().load_checkpoint(str(tmp_path), tag="global_step2")


def test_no_latest_loads_nothing_and_an_explicit_tag_still_loads(tmp_path):
    _, step1 = two_tags(tmp_path)
    os.remove(tmp_path / "latest")
    fresh = engine(seed=8)
    before = [p.clone() for p in fresh._leaves]
    assert fresh.load_checkpoint(str(tmp_path)) == (None, {})
    for a, b in zip(before, fresh._leaves):
        assert torch.equal(a, b)
    path, _ = fresh.load_checkpoint(str(tmp_path), tag="global_step1")
    assert path.endswith("global_step1") and torch.equal(fresh._leaves[0], step1[0])


def test_keep_last_n_drops_old_tags(tmp_path):
    eng = engine(fault_tolerance={"keep_last_n": 2})
    for b in batches(4, seed=2):
        train(eng, [b])
        eng.save_checkpoint(str(tmp_path))
    tags = sorted(d for d in os.listdir(tmp_path) if d.startswith("global_step"))
    assert tags == ["global_step3", "global_step4"]


def test_save_latest_false_leaves_the_pointer(tmp_path):
    eng = engine()
    train(eng, batches(1))
    eng.save_checkpoint(str(tmp_path))
    train(eng, batches(1, seed=1))
    eng.save_checkpoint(str(tmp_path), tag="side", save_latest=False)
    assert (tmp_path / "latest").read_text() == "global_step1"
    assert (tmp_path / "side" / "MANIFEST.json").is_file()


def test_load_module_only_keeps_the_optimizer_state(tmp_path):
    src, _ = two_tags(tmp_path)
    fresh = engine(seed=8)
    train(fresh, batches(1, seed=30))
    mu = [m.clone() for m in fresh.optimizer.mu]
    fresh.load_checkpoint(str(tmp_path), load_module_only=True)
    for a, b in zip(src._leaves, fresh._leaves):
        assert torch.equal(a, b)
    for a, b in zip(mu, fresh.optimizer.mu):
        assert torch.equal(a, b)
    assert int(fresh.optimizer.count) == 1 and fresh.global_steps == 2


def test_fault_tolerance_block_passes_unless_preemption_is_enabled():
    eng = engine(fault_tolerance={"keep_last_n": 3, "max_rollback": 1, "verify_on_load": False})
    assert eng.config.fault_tolerance_config.keep_last_n == 3
    assert eng.config.fault_tolerance_config.save_retries == 3
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1 item 8"):
        engine(fault_tolerance={"preemption_enabled": True})


# --------------------------------------------------------------------------- #
# async save
# --------------------------------------------------------------------------- #
@pytest.fixture
def no_cuda(monkeypatch):
    """CUDA absent, and every CUDA entry a checkpoint could reach recorded
    with the thread that called it."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("synchronize", "current_stream", "device_count", "_lazy_init",
                 "empty_cache", "memory_allocated"):
        real = getattr(torch.cuda, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append((_name, threading.current_thread().name))
            return _real(*a, **k)
        monkeypatch.setattr(torch.cuda, name, spy)
    return calls


def test_async_save_trains_on_and_a_fresh_engine_loads_after_the_wait(tmp_path, no_cuda):
    bs = batches(5, seed=6)
    eng = engine(checkpoint={"async_save": True})
    train(eng, bs[:2])
    snapshot = [p.clone() for p in eng._leaves]
    eng.save_checkpoint(str(tmp_path))
    fin = eng._ckpt_finalizer
    train(eng, bs[2:])                    # trains on while the finalizer runs
    fin.join(timeout=60)
    assert not fin.is_alive()
    eng.checkpoint_engine.wait()
    assert fin.name.startswith("ckpt-finalize-")
    assert not [c for c in no_cuda if c[1].startswith("ckpt-")], no_cuda
    fresh = engine(seed=3, checkpoint={"async_save": True})
    path, _ = fresh.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step2") and fresh.global_steps == 2
    for a, b in zip(snapshot, fresh._leaves):
        assert torch.equal(a, b)
    whole = engine()
    train(whole, bs)
    train(fresh, bs[2:])
    assert_same_state(whole, fresh)
    eng.close()


def test_a_failed_async_finalize_is_raised_at_the_next_save(tmp_path, monkeypatch):
    eng = engine(checkpoint={"async_save": True}, fault_tolerance={"save_retries": 0})
    train(eng, batches(1))
    import deepspeed_tpu_torch.runtime.checkpointing as ckpt

    def boom(*a, **k):
        raise OSError("disk gone")
    monkeypatch.setattr(ckpt, "write_manifest", boom)
    eng.save_checkpoint(str(tmp_path))
    eng._ckpt_finalizer.join(timeout=60)
    assert not eng._ckpt_finalizer.is_alive()
    monkeypatch.undo()
    with pytest.raises(ckpt.CheckpointWriteError, match="disk gone"):
        eng.save_checkpoint(str(tmp_path))
    eng.save_checkpoint(str(tmp_path))    # the error is raised once
    eng.close()


# --------------------------------------------------------------------------- #
# tools
# --------------------------------------------------------------------------- #
def test_zero_to_fp32_in_the_save_dir_gives_back_the_params(tmp_path):
    eng = engine()
    train(eng, batches(2))
    eng.save_checkpoint(str(tmp_path / "ck"))
    out = tmp_path / "fp32.pt"
    run = subprocess.run([sys.executable, "zero_to_fp32.py", str(tmp_path / "ck"), str(out)],
                         cwd=tmp_path / "ck", capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=""))
    assert run.returncode == 0, run.stderr
    sd = torch.load(out, weights_only=True)
    live = eng.get_fp32_params()
    assert list(sd) == list(live)
    for k, v in live.items():
        assert sd[k].dtype == torch.float32 and torch.equal(sd[k], v), k


def test_ckpt_cli_inspect_lists_the_params_and_export_writes_them(tmp_path, capsys):
    eng = engine()
    train(eng, batches(1))
    eng.save_checkpoint(str(tmp_path))
    assert ckpt_cli.main(["inspect", str(tmp_path)]) == 0
    text = capsys.readouterr().out
    for name, p in eng.module.named_parameters():
        assert f"{name} " in text and str(tuple(p.shape)) in text
    assert "global_steps: 1" in text and f"{len(eng._names)} tensors" in text
    assert ckpt_cli.main(["export", str(tmp_path), str(tmp_path / "w.npz")]) == 0
    with np.load(tmp_path / "w.npz") as data:
        assert np.array_equal(data["wte"], eng.get_fp32_params()["wte"].numpy())


def test_save_16bit_model_writes_fp16_leaves(tmp_path):
    eng = engine()
    path = eng.save_16bit_model(str(tmp_path))
    with np.load(path) as data:
        assert len(data.files) == len(eng._names) and data["p0"].dtype == np.float16
        np.testing.assert_array_equal(data["p0"], eng._leaves[0].detach().half().numpy())
