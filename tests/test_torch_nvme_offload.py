"""ZeRO-Infinity's NVMe tier in the port's engine against ``deepspeed_tpu``'s,
on the CPU.

* SimpleModel (hidden 16, Adam lr 1e-2, 5 steps of 8 rows through
  ``forward`` / ``backward`` / ``step``) at stages 0 and 1 with
  ``offload_optimizer: nvme``, the JAX engine built once per module: losses
  within 1e-5 relative, parameters within 1e-5 relative and 1e-7 absolute
  (an element whose gradient is at rounding level at some step, fewer than
  2 %, within Adam's 2 lr a step: the autotuning tests' bound); between
  steps JAX holds no optimizer state and the port no host copy of a moment.
* A tiny GPT (vocab 128, n_embd 64, 4 layers, 4 heads, seq 32, batch 8,
  Adam lr 1e-3, JAX's ``tests/unit/test_offload_e2e.py`` model) at stage 3
  with both tiers on NVMe, 3 steps: losses within 1e-5 relative of the JAX
  engine's, parameters within 2e-5 absolute (the key bias, whose gradient
  is rounding noise, within 2 lr a step); the port's NVMe run equals its
  CPU-offload run and its stage-0 run bit for bit.
* Checkpoints across the tiers: saved with NVMe and loaded by a CPU-offload,
  a stage-0 and an NVMe engine, and the reverse; two more steps bit for bit
  an uninterrupted run's.
* Rollback coherence (JAX's ``test_offload_e2e.py:144-165``): after a
  ``load_checkpoint`` the run continues in lockstep with an uninterrupted
  one, the moments on disk are the checkpoint's and the parameter tier's
  chunks the restored master.
* A step the stability sentinel skips leaves the moments on disk, the
  parameters and the count unchanged.
* The telemetry JSONL passes JAX's ``tools/offload_audit.py``; a corrupted
  chunk makes the next step raise.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models.gpt import GPT as JGPT
from deepspeed_tpu.models.gpt import GPTConfig as JGPTConfig
from deepspeed_tpu.models.simple import SimpleModel as JSimpleModel
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.models.convert import params_from_jax, simple_params_from_jax
from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig
from deepspeed_tpu_torch.models.simple import SimpleModel
from deepspeed_tpu_torch.runtime.offload.staging import StagingError, StagingPool
from deepspeed_tpu_torch.runtime.zero.partition_parameters import NvmeFlatStore
from deepspeed_tpu_torch.runtime.swap_tensor.partitioned_param_swapper import filesystem_type
from deepspeed_tpu_torch.testing import fault_injection as fi

REPO = Path(__file__).resolve().parents[1]
HIDDEN, ROWS, SIMPLE_STEPS, SIMPLE_LR = 16, 8, 5, 1e-2
SIMPLE_RTOL, SIMPLE_ATOL, ROUNDING_GRAD = 1e-5, 1e-7, 1e-6
TINY = dict(vocab_size=128, n_positions=32, n_embd=64, n_layer=4, n_head=4)
GPT_LR, GPT_STEPS, SEQ = 1e-3, 3, 32
IDS = np.random.default_rng(0).integers(0, 128, (8, SEQ)).astype(np.int32)
PIECE = 4096                     # sub_group_size: the tiny GPT's 216 K values in 53 pieces


@pytest.fixture(autouse=True)
def _world_of_one(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    yield
    fi.clear_plan()
    comm.destroy_process_group()


def swap_root(factory) -> Path:
    """A directory on a disk: the test's temporary one unless that lies in
    memory, else one under the checkout's git-ignored build directory."""
    root = factory.mktemp("nvme")
    if filesystem_type(str(root)) in ("tmpfs", "ramfs"):
        root = REPO / "build_torch" / "test_nvme" / root.name
        root.mkdir(parents=True, exist_ok=True)
    return root


@pytest.fixture
def swap(tmp_path_factory):
    return swap_root(tmp_path_factory)


# --------------------------------------------------------------------------- #
# SimpleModel at stages 0 and 1 against the JAX engine
# --------------------------------------------------------------------------- #
def simple_data():
    rng = np.random.default_rng(11)
    out = []
    for _ in range(SIMPLE_STEPS):
        x = rng.standard_normal((ROWS, HIDDEN)).astype(np.float32)
        out.append((x, (x.sum(axis=1) > 0).astype(np.int32)))
    return out


def simple_config(stage, path):
    return {"train_batch_size": ROWS,
            "optimizer": {"type": "Adam", "params": {"lr": SIMPLE_LR}},
            "zero_optimization": {"stage": stage, "offload_optimizer": {
                "device": "nvme", "nvme_path": str(path)}}}


@pytest.fixture(scope="module")
def jax_simple(tmp_path_factory):
    """The JAX engine's NVMe runs at stages 0 and 1, each built once."""
    jmodel = JSimpleModel(hidden_dim=HIDDEN)
    # host copies: the JAX engine donates the arrays it is given
    params = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(3)))
    runs = {}
    for stage in (0, 1):
        eng = deepspeed_tpu.initialize(
            model=jmodel, model_parameters=params,
            config=simple_config(stage, swap_root(tmp_path_factory)))[0]
        assert eng.optimizer_swapper is not None and eng.state.opt_state is None
        losses, off_host = [], []
        for x, y in simple_data():
            loss = eng.forward(x, y)
            eng.backward(loss)
            eng.step()
            losses.append(float(loss))
            off_host.append(eng.state.opt_state is None)
        runs[stage] = (losses, jax.tree.map(np.asarray, eng.state.params), off_host)
    return params, runs


@pytest.mark.parametrize("stage", [0, 1])
def test_simple_model_nvme_trains_as_jax(jax_simple, swap, stage):
    params, runs = jax_simple
    jlosses, jparams, joff = runs[stage]
    assert all(joff)
    model = SimpleModel(hidden_dim=HIDDEN, device="cpu")
    eng = dst.initialize(model=model, model_parameters=simple_params_from_jax(params),
                         device="cpu", config=simple_config(stage, swap))[0]
    opt = eng.optimizer
    assert isinstance(opt.mu, NvmeFlatStore) and opt.streamed
    tiny = {n: torch.zeros(p.shape, dtype=torch.bool) for n, p in model.named_parameters()}
    for (x, y), jl in zip(simple_data(), jlosses):
        loss = eng.forward(x, y)
        eng.backward(loss)
        for n, p in model.named_parameters():
            tiny[n] |= p.grad.abs() < ROUNDING_GRAD
        eng.step()
        np.testing.assert_allclose(float(loss.detach()), jl, rtol=SIMPLE_RTOL)
        # the moments live on disk: no host copy between steps
        assert eng.optimizer_swapper.store.host_bytes() == 0
    n_tiny = 0
    for name, t in eng.get_fp32_params().items():
        layer, leaf = name.split(".")
        got, want, mask = t.numpy(), jparams[layer][leaf], tiny[name].numpy()
        np.testing.assert_allclose(got[~mask], want[~mask], rtol=SIMPLE_RTOL, atol=SIMPLE_ATOL)
        assert np.all(np.abs(got[mask] - want[mask]) <= 2 * SIMPLE_LR * SIMPLE_STEPS)
        n_tiny += int(mask.sum())
    assert n_tiny <= 0.02 * sum(m.numel() for m in tiny.values())
    assert int(opt.count) == SIMPLE_STEPS and eng.optimizer_swapper.swapped_bytes() > 0
    eng.close()


# --------------------------------------------------------------------------- #
# the tiny GPT at stage 3 with both tiers on NVMe
# --------------------------------------------------------------------------- #
def jax_gpt():
    cfg = JGPTConfig(dtype=jnp.float32, attn_impl="reference", **TINY)
    return cfg, jax.tree.map(np.asarray, JGPT(cfg).init_params(jax.random.key(0)))


def gpt_config(zero):
    return {"train_micro_batch_size_per_gpu": 8, "gradient_accumulation_steps": 1,
            "optimizer": {"type": "Adam", "params": {"lr": GPT_LR}},
            "steps_per_print": 10 ** 9, "zero_optimization": zero}


def nvme_zero(path, stage=3, both=True, **over):
    oc = {"device": "nvme", "nvme_path": str(path)}
    zero = {"stage": stage, "offload_optimizer": dict(oc, **over), "sub_group_size": PIECE}
    if both:
        zero["offload_param"] = dict(oc)
    return zero


CPU_ZERO = {"stage": 3, "offload_param": {"device": "cpu"}, "offload_optimizer": {"device": "cpu"},
            "sub_group_size": PIECE}


def port_gpt(params, zero, **extra):
    model = GPT(GPTConfig(dtype="float32", **TINY), device="cpu")
    eng = dst.initialize(model=model, model_parameters=params, device="cpu", seed=7,
                         config=dict(gpt_config(zero), **extra))[0]
    return eng


def train(eng, n):
    return [float(eng.train_batch(batch=(IDS[None], IDS[None]))) for _ in range(n)]


@pytest.fixture(scope="module")
def jax_gpt_run(tmp_path_factory):
    """The JAX engine at stage 3 with both tiers on NVMe (JAX's own e2e
    test's config), built once: its losses and final parameters."""
    cfg, params = jax_gpt()
    nvme = str(swap_root(tmp_path_factory))
    eng = deepspeed_tpu.initialize(
        model=JGPT(cfg), model_parameters=params, seed=7,
        config={"train_batch_size": 8, "optimizer": {"type": "Adam", "params": {"lr": GPT_LR}},
                "zero_optimization": {"stage": 3,
                                      "offload_param": {"device": "nvme", "nvme_path": nvme},
                                      "offload_optimizer": {"device": "nvme",
                                                            "nvme_path": nvme}}})[0]
    assert eng.param_swapper is not None and eng.optimizer_swapper is not None
    losses = []
    for _ in range(GPT_STEPS):
        loss = eng.forward(IDS, IDS)
        eng.backward(loss)
        eng.step()
        losses.append(float(loss))
    return params, losses, jax.tree.map(np.asarray, eng.state.params)


def test_tiny_gpt_stage3_both_tiers_on_nvme_trains_as_jax(jax_gpt_run, swap):
    params, jlosses, jfinal = jax_gpt_run
    eng = port_gpt(params_from_jax(params), nvme_zero(swap))
    assert eng.param_swapper is not None and eng.optimizer.streamed
    losses = train(eng, GPT_STEPS)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    got = eng.get_fp32_params()
    E = TINY["n_embd"]
    for k, v in params_from_jax(jfinal).items():
        diff = np.abs(got[k].numpy() - v.numpy())
        assert diff.max() <= 2 * GPT_LR * GPT_STEPS, k
        if k.endswith("qkv_b"):
            diff = np.concatenate([diff[:E], diff[2 * E:]])     # all but the key bias
        assert diff.max() <= 2e-5, (k, diff.max())
    rec = eng.last_offload_record          # the walk drains its writes: exact a step
    assert rec["optimizer_bytes_written"] == rec["optimizer_bytes_read"] == 8 * eng._num_params
    eng.close()
    # the parameter tier: the initial persist and one a step, each leaf once
    assert eng.param_swapper.swapped_bytes() == 4 * eng._num_params * (GPT_STEPS + 1)


def test_nvme_run_is_the_cpu_offload_and_stage0_runs_bitwise(jax_gpt_run, swap):
    params = params_from_jax(jax_gpt_run[0])
    runs = {}
    for name, zero in (("nvme", nvme_zero(swap)),
                       ("nvme-optimizer", nvme_zero(swap / "o", both=False)),
                       ("cpu", CPU_ZERO), ("stage0", {"stage": 0})):
        eng = port_gpt(params, zero)
        runs[name] = (train(eng, GPT_STEPS), eng.get_fp32_params(),
                      eng.optimizer.state_dict())
        eng.close()
        comm.destroy_process_group()
    ref_losses, ref_params, ref_state = runs["stage0"]
    for name, (losses, got, state) in runs.items():
        assert losses == ref_losses, name
        assert all(torch.equal(got[k], ref_params[k]) for k in got), name
        for key in ("mu", "nu"):
            assert all(torch.equal(state[key][k], ref_state[key][k]) for k in got), (name, key)
        assert int(state["count"]) == GPT_STEPS


# --------------------------------------------------------------------------- #
# checkpoints across tiers; rollback coherence
# --------------------------------------------------------------------------- #
TIERS = {"nvme": lambda path: nvme_zero(path), "cpu": lambda path: CPU_ZERO,
         "stage0": lambda path: {"stage": 0}}


@pytest.mark.parametrize("saved,loaded", [("nvme", "cpu"), ("nvme", "stage0"), ("nvme", "nvme"),
                                          ("cpu", "nvme"), ("stage0", "nvme")])
def test_checkpoint_resumes_across_tiers(jax_gpt_run, swap, saved, loaded):
    params = params_from_jax(jax_gpt_run[0])
    src = port_gpt(params, TIERS[saved](swap / "src"))
    train(src, 2)
    src.save_checkpoint(str(swap / "ck"))
    dst_eng = port_gpt(params, TIERS[loaded](swap / "dst"))
    path, _ = dst_eng.load_checkpoint(str(swap / "ck"))
    assert path is not None and dst_eng.global_steps == 2
    assert train(dst_eng, 2) == train(src, 2)
    a, b = src.get_fp32_params(), dst_eng.get_fp32_params()
    assert all(torch.equal(a[k], b[k]) for k in a)
    sa, sb = src.optimizer.state_dict(), dst_eng.optimizer.state_dict()
    assert all(torch.equal(sa[m][k], sb[m][k]) for m in ("mu", "nu") for k in a)
    src.close()
    dst_eng.close()


def test_rollback_resyncs_the_nvme_tiers(jax_gpt_run, swap):
    params = params_from_jax(jax_gpt_run[0])
    off = port_gpt(params, nvme_zero(swap / "n"))
    ref = port_gpt(params, CPU_ZERO)
    train(off, 2)
    train(ref, 2)
    off.save_checkpoint(str(swap / "ck"), tag="t2")
    saved = off.optimizer.state_dict()
    train(off, 2)                                     # the abandoned trajectory
    off.load_checkpoint(str(swap / "ck"), tag="t2")
    # the moments on disk are the checkpoint's again, read piece by piece
    pool = StagingPool(str(swap / "n" / "optimizer"))
    mu = torch.cat([pool.read_sync(k) for k in off.optimizer.mu.keys])
    assert torch.equal(mu, torch.cat([off.optimizer.mu._host_piece(k)
                                      for k in range(len(off.optimizer.mu.keys))]))
    assert all(torch.equal(off.optimizer.state_dict()["mu"][k], saved["mu"][k])
               for k in saved["mu"])
    pool.close()
    # the parameter tier holds the restored master once its writes land
    off.param_swapper.store.drain()
    master = off.zero.rank_leaves()
    ppool = StagingPool(str(swap / "n" / "params"))
    for name, t in master.items():
        assert torch.equal(ppool.read_sync(off.param_swapper.leaf_key(name, "param")), t), name
    ppool.close()
    assert train(off, 2) == train(ref, 2)
    a, b = off.get_fp32_params(), ref.get_fp32_params()
    assert all(torch.equal(a[k], b[k]) for k in a)
    off.close()
    ref.close()


# --------------------------------------------------------------------------- #
# stability skip, telemetry audit, a failed read
# --------------------------------------------------------------------------- #
def disk_moments(eng):
    eng.optimizer_swapper.drain()
    return {name: (Path(eng.optimizer_swapper.swap_folder) / f"{name}.chunk").read_bytes()
            for name in eng.optimizer.mu.keys + eng.optimizer.nu.keys}


def test_stability_skip_leaves_the_moments_on_disk(jax_gpt_run, swap):
    params = params_from_jax(jax_gpt_run[0])
    eng = port_gpt(params, nvme_zero(swap, pipeline_write=True),
                   stability={"enabled": True, "warmup_steps": 2})
    train(eng, 1)
    before = (disk_moments(eng), eng.get_fp32_params(), int(eng.optimizer.count))
    fi.install_plan([{"site": "train.grads", "action": "nan", "on_hit": 1}])
    train(eng, 1)
    fi.clear_plan()
    after = (disk_moments(eng), eng.get_fp32_params(), int(eng.optimizer.count))
    assert eng.skipped_steps == 1
    assert after[0] == before[0] and after[2] == before[2] == 1
    assert all(torch.equal(after[1][k], before[1][k]) for k in before[1])
    train(eng, 1)
    assert int(eng.optimizer.count) == 2 and disk_moments(eng) != before[0]
    eng.close()


def test_telemetry_passes_the_offload_audit(jax_gpt_run, swap):
    params = params_from_jax(jax_gpt_run[0])
    jsonl = swap / "t.jsonl"
    eng = port_gpt(params, nvme_zero(swap / "n"),
                   telemetry={"enabled": True, "jsonl_path": str(jsonl), "flush_every": 1})
    train(eng, GPT_STEPS)
    moments = 8 * eng._num_params
    eng.close()
    kinds = [json.loads(line)["kind"] for line in jsonl.read_text().splitlines()]
    assert kinds.count("offload_staged") == GPT_STEPS
    out = subprocess.run([sys.executable, str(REPO / "tools" / "offload_audit.py"), str(jsonl),
                          "--min-hit-rate", "0.5"], capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr
    report = json.loads(out.stdout[out.stdout.index("{"):])
    assert report["steps_audited"] == GPT_STEPS and set(report["stores"]) == {"param",
                                                                              "optimizer"}
    # each step reads and writes the moments once; the first step's record
    # also holds the initial persist of the zeroed moments
    opt = report["stores"]["optimizer"]
    assert opt["bytes_read"] == GPT_STEPS * moments
    assert opt["bytes_written"] == (GPT_STEPS + 1) * moments


def test_a_refused_engine_releases_its_host_state(swap, monkeypatch):
    """An engine refused once its host state exists (here its swap path
    lies in memory, after the stage-3 master went to the host) closes that
    state before the error leaves ``initialize``: on a CUDA engine the
    pages it registered would otherwise stay registered after the memory
    is freed, and a later pinned allocation there fails."""
    from deepspeed_tpu_torch.runtime.swap_tensor import partitioned_param_swapper as tpps
    from deepspeed_tpu_torch.runtime.zero import partition_parameters as tpp
    closed = []
    close = tpp.FlatStore.close
    monkeypatch.setattr(tpp.FlatStore, "close", lambda self: (closed.append(self), close(self)))
    monkeypatch.setattr(tpps, "filesystem_type", lambda path: "tmpfs")
    zero = {"stage": 3, "offload_param": {"device": "cpu"},
            "offload_optimizer": {"device": "nvme", "nvme_path": str(swap)}}
    with pytest.raises(tpps.SwapPathError, match="on tmpfs"):
        port_gpt(None, zero)
    assert [st.host for st in closed] == [True]          # the host master


def test_a_corrupted_chunk_makes_the_step_raise(jax_gpt_run, swap):
    eng = port_gpt(params_from_jax(jax_gpt_run[0]), nvme_zero(swap, both=False))
    train(eng, 1)
    chunk = Path(eng.optimizer_swapper.swap_folder) / f"{eng.optimizer.nu.keys[3]}.chunk"
    data = bytearray(chunk.read_bytes())
    data[7] ^= 0xFF
    chunk.write_bytes(bytes(data))
    with pytest.raises(StagingError, match="CRC mismatch"):
        train(eng, 1)
    eng.close()
