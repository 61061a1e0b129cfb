"""ZeRO stages 0-3, CPU offload and data parallelism of the port, on the CPU.

* Two ranks over gloo (``tests/torch_zero_worker.py``, spawned once for the
  module on a free port, each ``join`` under ``JOIN_TIMEOUT_S``): the tiny
  GPT of ``tests/test_torch_training.py`` (fp32, GAS 2, clip 1.0 binding,
  AdamW) trains 3 steps at seven configurations: stages 0, 1, 2 and 3, stage
  2 with ``offload_optimizer`` and stage 3 with ``offload_param`` and
  ``offload_optimizer`` to the CPU and to NVMe (in pieces of 4096
  elements, so the update walks many chunks; each rank's NVMe tier under
  its own ``rank<r>`` folder).  Each is held against the JAX engine at the
  same stage on
  a 2-device CPU mesh and against the port's world-1 stage-0 run on the
  same global batch: losses and grad norms within 1e-5 relative, moments
  within 1e-4 of their largest magnitude, parameters within 2e-5 absolute
  (the attention key bias, whose gradient is rounding noise, within Adam's
  bound of 2 lr a step), as ``check_engine_trajectory`` holds the engine.
* In the same spawn: the eager ``forward`` / ``backward`` / ``step`` at
  stage 2 gives ``train_batch``'s parameters bit for bit, and the stage-3
  run's checkpoint, saved at world 2, loads into a world-1 stage-0 engine
  with equal parameters, moments and count, and ``zero_to_fp32`` reads it.
* At world 1 (a gloo group of one): the chunked, offloaded update equals
  the device one bit for bit; a mixture-of-experts GPT trains at stage 3
  with offload as at stage 0, bit for bit; ``GatheredParameters``.
* ``stage_state_bytes``, ``plan_residency`` and ``check_budget`` give the
  JAX package's numbers and refusals on the same inputs.
"""

import multiprocessing
import socket

import numpy as np
import pytest
import torch

import jax

import deepspeed_tpu
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.parallel import mesh as mesh_lib
from deepspeed_tpu.runtime import memory_model as jmm
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.runtime.offload import policy as jpolicy
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import adam_state_from_jax, params_from_jax
from deepspeed_tpu_torch.runtime import memory_model as tmm
from deepspeed_tpu_torch.runtime.offload import policy as tpolicy
from deepspeed_tpu_torch.runtime.zero import GatheredParameters
from deepspeed_tpu_torch.utils import zero_to_fp32
from tests import torch_zero_worker
from tests.test_torch_training import MODELS, batch

WORLD, MICRO, GAS, SEQ, STEPS, LR, CLIP = 2, 2, 2, 16, 3, 1e-3, 1.0
JOIN_TIMEOUT_S = 120
LOSS_RTOL, MOMENT_TOL, PARAM_TOL = 1e-5, 1e-4, 2e-5
OFFLOAD = {"device": "cpu"}
NVME = {"device": "nvme"}
PIECE = 4096
CONFIGS = {
    "stage0": {"stage": 0},
    "stage1": {"stage": 1},
    "stage2": {"stage": 2},
    "stage3": {"stage": 3},
    "stage2-offload-optimizer": {"stage": 2, "offload_optimizer": OFFLOAD,
                                 "sub_group_size": PIECE},
    "stage3-offload-both": {"stage": 3, "offload_param": OFFLOAD, "offload_optimizer": OFFLOAD,
                            "sub_group_size": PIECE},
    # ZeRO-Infinity: each rank swaps its shard under <nvme_path>/rank<r>
    "stage3-nvme-both": {"stage": 3, "offload_param": NVME, "offload_optimizer": NVME,
                         "sub_group_size": PIECE},
}
CHECKPOINTED = "stage3-offload-both"


def with_nvme_path(zero, path):
    """``zero`` with ``nvme_path`` set in its NVMe offload blocks."""
    return {k: dict(v, nvme_path=str(path)) if v == NVME else v for k, v in zero.items()}


def ds_config(zero, micro=MICRO):
    return {"train_micro_batch_size_per_gpu": micro, "gradient_accumulation_steps": GAS,
            "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}},
            "gradient_clipping": CLIP, "steps_per_print": 10 ** 9,
            "zero_optimization": dict(zero)}


@pytest.fixture(scope="module")
def setup():
    """The JAX model, its parameters (scaled so the clip binds) and the
    global batches ``[gas, WORLD * MICRO, SEQ]``."""
    jcfg = jgpt.GPTConfig(dtype="float32", scan_layers=True, **MODELS["tiny"])
    jparams = jax.tree.map(lambda a: np.asarray(a) * (4.0 if np.ndim(a) >= 2 else 1.0),
                           jgpt.GPT(jcfg).init_params(jax.random.PRNGKey(0)))
    batches = [batch(jcfg.vocab_size, WORLD * MICRO, SEQ, seed=40 + i, gas=GAS)
               for i in range(STEPS)]
    yield jcfg, jparams, batches
    comm.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world2(setup, tmp_path_factory):
    """Every world-2 run of the module, from one spawn of two ranks."""
    _, jparams, batches = setup
    out = tmp_path_factory.mktemp("zero-world2")
    spec = {"dims": MODELS["tiny"], "params": params_from_jax(jparams),
            "batches": [(torch.from_numpy(i), torch.from_numpy(l)) for i, l in batches],
            "configs": {name: ds_config(with_nvme_path(z, out / "nvme"))
                        for name, z in CONFIGS.items()},
            "checkpoint": CHECKPOINTED, "eager": "stage2"}
    spec_path = str(out / "spec.pt")
    torch.save(spec, spec_path)
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=torch_zero_worker.run, args=(r, WORLD, port, spec_path, str(out)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_TIMEOUT_S)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = [(out / f"rank{r}.err").read_text() for r in range(WORLD)
              if (out / f"rank{r}.err").exists()]
    assert not hung, f"ranks {hung} still running after {JOIN_TIMEOUT_S} s"
    assert not errors and all(p.exitcode == 0 for p in procs), "\n".join(errors)
    runs = {name: torch.load(out / f"{name}.pt", weights_only=True) for name in CONFIGS}
    runs["eager"] = torch.load(out / "eager.pt", weights_only=True)
    return runs, out


@pytest.fixture(scope="module")
def jax_runs(setup):
    """The JAX engine at stages 0-3 on a 2-device CPU mesh, the same global
    batches."""
    jcfg, jparams, batches = setup
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DST_PALLAS_CE", "0")
        for stage in range(4):
            cfg = ds_config({"stage": stage})
            mesh = mesh_lib.MeshSpec.from_config(JConfig(cfg), device_count=WORLD).build(
                jax.devices("cpu")[:WORLD])
            try:
                engine = deepspeed_tpu.initialize(model=jgpt.GPT(jcfg), model_parameters=jparams,
                                                  config=cfg, mesh=mesh)[0]
                losses, norms = [], []
                for ids, labels in batches:
                    losses.append(float(engine.train_batch(batch=(ids, labels))))
                    norms.append(engine.get_global_grad_norm())
                adam = adam_state_from_jax(engine.state.opt_state)
                runs[stage] = {"losses": losses, "norms": norms,
                               "params": params_from_jax(engine.state.params),
                               "mu": adam["mu"], "nu": adam["nu"], "count": adam["count"]}
            finally:
                mesh_lib.reset_mesh()
    return runs


def train_port(setup, zero, micro=WORLD * MICRO, **model_kw):
    """The port at world size 1 on the whole global batch."""
    _, jparams, batches = setup
    model = tgpt.GPT(tgpt.GPTConfig(dtype="float32", **dict(MODELS["tiny"], **model_kw)),
                     device="cpu")
    engine = dst.initialize(model=model, config=ds_config(zero, micro),
                            model_parameters=params_from_jax(jparams), device="cpu")[0]
    losses, norms = [], []
    for ids, labels in batches:
        losses.append(float(engine.train_batch(batch=(ids, labels))))
        norms.append(engine.get_global_grad_norm())
    opt = engine.optimizer.state_dict()
    return engine, {"losses": losses, "norms": norms, "params": engine.get_fp32_params(),
                    "mu": {k: v.detach().clone() for k, v in opt["mu"].items()},
                    "nu": {k: v.detach().clone() for k, v in opt["nu"].items()},
                    "count": int(opt["count"])}


@pytest.fixture(scope="module")
def world1_stage0(setup):
    engine, run = train_port(setup, {"stage": 0})
    engine.close()
    return run


def assert_trajectory(got, want, what):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL, err_msg=what)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=LOSS_RTOL, err_msg=what)
    assert min(got["norms"]) > CLIP, what                # the clip binds every step
    E = MODELS["tiny"]["n_embd"]
    for k, v in want["params"].items():
        diff = np.abs(got["params"][k].numpy() - v.numpy())
        assert diff.max() <= 2 * LR * STEPS, (what, k)
        if k.endswith("qkv_b"):
            diff = np.concatenate([diff[:E], diff[2 * E:]])     # all but the key bias
        assert diff.max() <= PARAM_TOL, (what, k, diff.max())
    assert got["count"] == want["count"] == STEPS, what
    for key in ("mu", "nu"):
        for k, v in want[key].items():
            np.testing.assert_allclose(got[key][k].numpy(), v.numpy(), rtol=0,
                                       atol=MOMENT_TOL * float(v.abs().max()),
                                       err_msg=f"{what} {key} {k}")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_world2_matches_jax_and_the_world1_stage0_run(name, world2, jax_runs, world1_stage0):
    runs, _ = world2
    got = runs[name]
    assert got["world"] == WORLD and got["stage"] == CONFIGS[name]["stage"]
    assert got["pinned"] == 0                       # no CUDA: host pieces are not pinned
    assert_trajectory(got, jax_runs[CONFIGS[name]["stage"]], f"{name} vs JAX")
    assert_trajectory(got, world1_stage0, f"{name} vs the port at world 1, stage 0")


def test_world2_stage2_eager_micro_steps_equal_train_batch(world2):
    runs, _ = world2
    eager, fused = runs["eager"], runs["stage2"]
    np.testing.assert_array_equal(eager["norms"], fused["norms"])
    for k, v in fused["params"].items():
        assert torch.equal(eager["params"][k], v), k


def test_stage3_checkpoint_saved_at_world2_loads_at_world1_stage0(world2, setup):
    runs, out = world2
    saved = runs[CHECKPOINTED]
    ck = str(out / "ckpt")
    engine, _ = train_port(setup, {"stage": 0})
    path, _ = engine.load_checkpoint(ck)
    assert path is not None and engine.global_steps == STEPS
    params = engine.get_fp32_params()
    opt = engine.optimizer.state_dict()
    assert int(opt["count"]) == saved["count"] == STEPS
    for k, v in saved["params"].items():
        assert torch.equal(params[k], v), k
        assert torch.equal(opt["mu"][k], saved["mu"][k]) and torch.equal(opt["nu"][k],
                                                                          saved["nu"][k]), k
    engine.close()
    sd = zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(ck)
    assert set(sd) == set(saved["params"])
    assert all(torch.equal(sd[k], v) for k, v in saved["params"].items())


@pytest.mark.parametrize("zero,plain", [
    ({"stage": 2, "offload_optimizer": OFFLOAD, "sub_group_size": 512}, {"stage": 2}),
    ({"stage": 3, "offload_param": OFFLOAD, "offload_optimizer": OFFLOAD,
      "sub_group_size": 512}, {"stage": 3}),
], ids=["stage2", "stage3"])
def test_chunked_offloaded_adamw_equals_the_device_update_bitwise(setup, zero, plain):
    e1, chunked = train_port(setup, zero)
    e2, whole = train_port(setup, plain)
    assert len(e1.optimizer.chunks) > 8 and len(e2.optimizer.chunks) == 1
    assert chunked["losses"] == whole["losses"] and chunked["norms"] == whole["norms"]
    for key in ("params", "mu", "nu"):
        for k, v in whole[key].items():
            assert torch.equal(chunked[key][k], v), (key, k)
    e1.close()
    e2.close()


def test_moe_trains_at_stage3_with_offload_as_at_stage0(setup):
    moe = dict(moe_num_experts=4, moe_top_k=2, remat=True)
    runs = []
    for zero in ({"stage": 0}, {"stage": 3, "offload_param": OFFLOAD,
                                "offload_optimizer": OFFLOAD}):
        _, jparams, _ = setup
        model = tgpt.GPT(tgpt.GPTConfig(dtype="float32", **dict(MODELS["tiny"], **moe)),
                         device="cpu", seed=3)
        engine = dst.initialize(model=model, config=ds_config(zero, WORLD * MICRO),
                                device="cpu", seed=5)[0]
        losses = [float(engine.train_batch(batch=b)) for b in setup[2]]
        runs.append((losses, engine.get_fp32_params()))
        engine.close()
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(runs[0][1][k], v) for k, v in runs[1][1].items())
    assert any(".moe.experts." in k for k in runs[0][1])


def test_gathered_parameters_at_stage3(setup):
    engine, run = train_port(setup, {"stage": 3})
    model = engine.module
    assert all(p.numel() == 0 for p in model.parameters())      # the model holds partitions
    ids = torch.from_numpy(setup[2][0][0][0])
    with GatheredParameters(engine, modifier_rank=0) as holder:
        full = dict(model.named_parameters())
        assert all(torch.equal(full[k].cpu(), v) for k, v in run["params"].items())
        logits = model.forward_logits(ids)
        holder["params"]["wte"] = holder["params"]["wte"] * 0.5
    assert all(p.numel() == 0 for p in model.parameters())
    assert logits.shape[:2] == ids.shape and torch.isfinite(logits).all()
    assert torch.equal(engine.get_fp32_params()["wte"], run["params"]["wte"] * 0.5)
    engine.close()


# --------------------------------------------------------------------------- #
# the memory model and the residency planner against JAX's
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("world", [1, 2, 8])
def test_stage_state_bytes_matches_jax(stage, world):
    for n, itemsize in ((124_082_688, 2), (8_030_261_248, 2), (1_557_686_400, 4)):
        assert (tmm.stage_state_bytes(n, stage, world, compute_itemsize=itemsize)
                == jmm.stage_state_bytes(n, stage, world, compute_itemsize=itemsize))
        assert (vars(tmm.analytic_step_peaks(n, world, itemsize, n // 2, 24, 2,
                                             optimizer_tier="host"))
                == vars(jmm.analytic_step_peaks(n, world, itemsize, n // 2, 24, 2,
                                                optimizer_tier="host")))


def stacked_tree(layers=4, width=256):
    """A JAX-style tree with blocks stacked along the layer dimension."""
    f = np.float32
    return {"wte": np.zeros((1024, width), f), "lnf_g": np.zeros((width,), f),
            "blocks": {"qkv_w": np.zeros((layers, width, 3 * width), f),
                       "fc_w": np.zeros((layers, width, 4 * width), f)}}


PLANS = [  # budget, world, params tier, optimizer tier, offload on
    (64 << 20, 1, "hbm", "hbm", False),
    (4 << 20, 1, "hbm", "hbm", False),
    (4 << 20, 1, "cpu", "cpu", True),
    (2 << 20, 2, "cpu", "cpu", True),
    (1 << 16, 4, "cpu", "hbm", True),
    (16 << 20, 8, "hbm", "cpu", False),
]


@pytest.mark.parametrize("budget,world,ptier,otier,offload", PLANS,
                         ids=[f"plan{i}" for i in range(len(PLANS))])
def test_plan_residency_and_check_budget_match_jax(budget, world, ptier, otier, offload):
    tree = stacked_tree()
    kw = dict(budget_bytes=budget, world=world, compute_itemsize=2, prefetch_depth=1,
              params_tier=ptier, optimizer_tier=otier)
    want, got = jpolicy.plan_residency(tree, None, **kw), tpolicy.plan_residency(tree, None, **kw)
    assert got.as_record() == want.as_record() and got.describe() == want.describe()
    try:
        jpolicy.check_budget(want, offload_enabled=offload)
    except jpolicy.HBMBudgetError as e:
        with pytest.raises(tpolicy.HBMBudgetError) as raised:
            tpolicy.check_budget(got, offload_enabled=offload)
        assert str(raised.value) == str(e)
    else:
        assert tpolicy.check_budget(got, offload_enabled=offload) is got


def test_plan_residency_takes_the_ports_list_of_blocks():
    """The port's GPT tree (blocks as a list) plans as the stacked tree."""
    tree = stacked_tree()
    listed = dict(tree, blocks=[{k: v[i] for k, v in tree["blocks"].items()} for i in range(4)])
    kw = dict(budget_bytes=4 << 20, world=2, compute_itemsize=2, prefetch_depth=1,
              params_tier="cpu", optimizer_tier="cpu")
    assert (tpolicy.plan_residency(listed, None, **kw).as_record()
            == jpolicy.plan_residency(tree, None, **kw).as_record())


def test_engine_refuses_a_step_over_its_hbm_budget():
    model = tgpt.GPT(tgpt.GPTConfig(dtype="float32", **MODELS["tiny"]), device="cpu")
    with pytest.raises(tpolicy.HBMBudgetError, match="exceeds the HBM budget"):
        dst.initialize(model=model, device="cpu", config=ds_config(
            {"stage": 3, "hbm_budget_bytes": 1 << 10}, WORLD * MICRO))
