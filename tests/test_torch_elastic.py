"""The port's elastic agent, launcher, batch solver and preemption exit
against the JAX package's, on the CPU (``elasticity/``, ``launcher/``,
``cli_utils.py``, ``runtime/fault_tolerance.py``, the ``elasticity`` and
``fault_tolerance`` blocks, ``initialize``'s elastic batch).

* ``compute_elastic_config`` over a grid of configurations and world sizes:
  the same batch, device counts and micro batch (or the same error) as
  JAX's.
* The ``elasticity`` block is checked and acted on: an unknown key or an
  enabled block without its solver keys is refused; ``recovery_enabled``
  builds the recovery plane (the block was accepted and ignored before).
  ``initialize`` applies the agent's ``DS_ELASTIC_TRAIN_BATCH`` /
  ``DS_ELASTIC_MICRO_BATCH`` as JAX's does.
* The agent's exit classification with bare-``python`` workers, port and
  JAX agents side by side: a clean exit, a preemption (143 and -SIGTERM),
  the recovery codes 113 / 114, a SIGKILL with and without the marker,
  and a crash, with their restart, preemption and recovery counts.
* The runner's hostfile, filters, world info and command, and the
  launcher's children's environment, against JAX's functions; the local
  GPU count honours ``CUDA_VISIBLE_DEVICES``; ``cli_utils elastic`` prints
  JAX's solution.
* The preemption exit: a worker with ``preemption_enabled`` sends itself
  SIGTERM at ``train.step``; it saves ``preempt_step<N>`` (verified), books
  ``ckpt_stall``, records ``preemption`` notice and exit, and exits 143.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
from collections import OrderedDict
from pathlib import Path

import pytest

from deepspeed_tpu import cli_utils as jcli
from deepspeed_tpu.elasticity import elastic_agent as jagent
from deepspeed_tpu.elasticity import elasticity as jel
from deepspeed_tpu.launcher import runner as jrunner
from deepspeed_tpu.comm import recovery as jrec
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch import cli_utils as tcli
from deepspeed_tpu_torch.comm import recovery as trec
from deepspeed_tpu_torch.elasticity import elastic_agent as tagent
from deepspeed_tpu_torch.elasticity import elasticity as tel
from deepspeed_tpu_torch.launcher import runner as trunner
from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfigError
from deepspeed_tpu_torch.runtime.fault_tolerance import PREEMPTION_EXIT_CODES
from tests.torch_robust_worker import TINY

REPO = Path(__file__).resolve().parents[1]


def elastic(**kw):
    block = {"enabled": True, "max_train_batch_size": 64, "micro_batch_sizes": [1, 2, 4],
             "min_gpus": 1, "max_gpus": 16, "version": 0.2, "num_gpus_per_node": 1}
    block.update(kw)
    return {"elasticity": block}


@pytest.mark.parametrize("kw", [
    {}, {"version": 0.1}, {"micro_batch_sizes": [2, 3, 5], "max_train_batch_size": 1000},
    {"num_gpus_per_node": 4, "max_gpus": 64}, {"prefer_larger_batch_size": False},
    {"model_parallel_size": 2, "num_gpus_per_node": 8, "max_gpus": 32, "min_gpus": 8},
])
@pytest.mark.parametrize("world", [0, 1, 2, 3, 4, 8])
def test_compute_elastic_config_matches_jax(kw, world):
    cfg = elastic(**kw)

    def solve(mod):
        try:
            return mod.compute_elastic_config(cfg, "0.0", world_size=world,
                                              return_microbatch=True)
        except mod.ElasticityError as e:
            return type(e).__name__, str(e)
    assert solve(tel) == solve(jel)


def test_elasticity_block_is_checked_and_acted_on(tmp_path):
    with pytest.raises(DeepSpeedConfigError, match="unknown 'elasticity' keys"):
        dst.DeepSpeedConfig({"train_batch_size": 8, "elasticity": {"enabled": True,
                                                                   "max_batch": 8}})
    with pytest.raises(DeepSpeedConfigError, match="max_train_batch_size is required"):
        dst.DeepSpeedConfig({"train_batch_size": 8, "elasticity": {"enabled": True}})
    # the block of the fault as it was found: recovery and the solver on
    cfg = {"train_micro_batch_size_per_gpu": 2, "optimizer": {"type": "AdamW"},
           "elasticity": dict(elastic()["elasticity"], recovery_enabled=True,
                              collective_timeout_s=5.0)}
    model = GPT(GPTConfig(dtype="float32", **TINY), device="cpu")
    eng = dst.initialize(model=model, device="cpu", config=cfg)[0]
    assert eng.recovery_manager is not None and eng.recovery_policy.collective_timeout_s == 5.0
    assert eng._bounded is not None and eng._bounded.deadline_s == 5.0
    eng.close()


def test_initialize_applies_the_agents_batch(monkeypatch, tmp_path):
    monkeypatch.setenv("DS_ELASTIC_TRAIN_BATCH", "12")
    monkeypatch.setenv("DS_ELASTIC_MICRO_BATCH", "3")
    path = tmp_path / "ds.json"
    path.write_text(json.dumps({"train_batch_size": 4, "gradient_accumulation_steps": 4,
                                "optimizer": {"type": "AdamW"}}))
    model = GPT(GPTConfig(dtype="float32", **TINY), device="cpu")
    eng = dst.initialize(model=model, device="cpu", config=str(path))[0]
    assert (eng.train_batch_size(), eng.train_micro_batch_size_per_gpu(),
            eng.gradient_accumulation_steps()) == (12, 3, 4)
    monkeypatch.setenv("DS_ELASTIC_TRAIN_BATCH", "8")
    monkeypatch.delenv("DS_ELASTIC_MICRO_BATCH")
    got = dst.elastic_batch_config({"train_micro_batch_size_per_gpu": 2, "train_batch_size": 2})
    assert got == {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2}
    with pytest.raises(FileNotFoundError):
        dst.elastic_batch_config(str(tmp_path / "missing.json"))


# --------------------------------------------------------------------------- #
# the agent's exit classification
# --------------------------------------------------------------------------- #
def exits_then_zero(tmp_path, first: str):
    """A worker whose first run ends with ``first`` (a Python statement),
    every later run with 0."""
    marker = tmp_path / "ran"
    body = textwrap.dedent(f"""\
        import os, signal, sys
        if os.path.exists({str(marker)!r}):
            sys.exit(0)
        open({str(marker)!r}, "w").write("1")
        {first}
        """)
    script = tmp_path / "worker.py"
    script.write_text(body)
    return [sys.executable, str(script)]


@pytest.mark.parametrize("case,first,counts", [
    ("clean", "sys.exit(0)", (0, 0, 0)),
    ("preempted-143", "sys.exit(143)", (0, 1, 0)),
    ("preempted-sigterm", "os.kill(os.getpid(), signal.SIGTERM)", (0, 1, 0)),
    ("restart-113", "sys.exit(113)", (0, 0, 1)),
    ("shrink-114", "sys.exit(114)", (0, 0, 1)),
    ("killed-with-marker", "os.kill(os.getpid(), signal.SIGKILL)", (0, 0, 1)),
    ("killed", "os.kill(os.getpid(), signal.SIGKILL)", (1, 0, 0)),
    ("crash", "sys.exit(7)", (1, 0, 0)),
])
def test_agent_classifies_exits_as_jax(tmp_path, case, first, counts):
    got = {}
    for name, mod, rec in (("port", tagent, trec), ("jax", jagent, jrec)):
        root = tmp_path / name
        root.mkdir()
        rdv = root / "rdv"
        if case == "killed-with-marker":
            rec.write_recovery_marker(str(rdv), "rank_killed")
        sleeps = []
        agent = mod.DSElasticAgent(
            mod.WorkerSpec(exits_then_zero(root, first), env={rec.RENDEZVOUS_DIR_ENV: str(rdv)}),
            max_restarts=1, monitor_interval=0.05, sleep_fn=sleeps.append)
        rc = agent.run()
        got[name] = (rc, (agent.restart_count, agent.preemption_count, agent.recovery_count),
                     len(sleeps))
    assert got["port"] == got["jax"]
    assert got["port"][:2] == (0, counts)
    assert got["port"][2] == counts[0]          # backoff only on a crash
    assert PREEMPTION_EXIT_CODES == (143, -signal.SIGTERM)


# --------------------------------------------------------------------------- #
# runner, launcher, cli
# --------------------------------------------------------------------------- #
def test_runner_resources_and_command_match_jax(tmp_path, monkeypatch):
    hostfile = tmp_path / "hostfile"
    hostfile.write_text("# hosts\nworker-0 slots=4\nworker-1 slots=4\n\nworker-2 slots=2\n")
    res = trunner.fetch_hostfile(str(hostfile))
    assert res == jrunner.fetch_hostfile(str(hostfile))
    for inc, exc in (("worker-0@worker-1:0,2", ""), ("", "worker-1:1@worker-2"), ("", "")):
        assert (trunner.parse_inclusion_exclusion(res, inc, exc)
                == jrunner.parse_inclusion_exclusion(res, inc, exc))
    assert trunner.encode_world_info(res) == jrunner.encode_world_info(res)
    bad = tmp_path / "bad"
    bad.write_text("worker-0 gpus=4\n")
    with pytest.raises(ValueError):
        trunner.fetch_hostfile(str(bad))
    args = trunner.parse_args(["--num_gpus", "2", "--master_port", "29600", "train.py", "--x",
                               "1"])
    jargs = jrunner.parse_args(["--num_gpus", "2", "--master_port", "29600", "train.py",
                                "--x", "1"])
    cmd = trunner.build_launch_cmd(args, OrderedDict(localhost=2))
    jcmd = jrunner.build_launch_cmd(jargs, OrderedDict(localhost=2))
    assert cmd[3] == "deepspeed_tpu_torch.launcher.launch"
    assert cmd[:3] + cmd[4:] == jcmd[:3] + jcmd[4:]
    env = {"CUDA_HOME": "/c", "NCCL_DEBUG": "INFO", "DS_ELASTIC_TRAIN_BATCH": "8",
           "HOME": "/h", "JAX_PLATFORMS": "cpu"}
    monkeypatch.chdir(tmp_path)
    exports = trunner.collect_env_exports(cwd=str(tmp_path), env=env)
    assert exports == {"CUDA_HOME": "/c", "NCCL_DEBUG": "INFO", "DS_ELASTIC_TRAIN_BATCH": "8"}
    assert trunner.local_gpu_count({"CUDA_VISIBLE_DEVICES": "0,2,3"}) == 3
    assert trunner.local_gpu_count({"CUDA_VISIBLE_DEVICES": ""}) == 0
    assert trunner.local_gpu_count({"CUDA_VISIBLE_DEVICES": "-1"}) == 0
    assert trunner.discover_local_gpus({"CUDA_VISIBLE_DEVICES": "1"}) == OrderedDict(localhost=1)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert trunner.resolve_resources(trunner.parse_args(
        ["--hostfile", str(tmp_path / "none"), "x.py"])) == OrderedDict(localhost=1)


def test_launcher_children_get_the_torch_distributed_env(tmp_path):
    script = tmp_path / "show_env.py"
    script.write_text(textwrap.dedent("""\
        import json, os, sys
        keys = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                "COORDINATOR_ADDRESS", "PROCESS_ID")
        open(os.path.join(sys.argv[1], "r%s.json" % os.environ["RANK"]), "w").write(
            json.dumps({k: os.environ.get(k) for k in keys}))
        """))
    world = trunner.encode_world_info(OrderedDict(localhost=2))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    # the port's launcher by its file: it imports no torch (``-m`` would
    # import the package first)
    launchers = {"port": [str(REPO / "deepspeed_tpu_torch" / "launcher" / "launch.py")],
                 "jax": ["-m", "deepspeed_tpu.launcher.launch"]}
    out = {}
    for name, launcher in launchers.items():
        d = tmp_path / name
        d.mkdir()
        rc = subprocess.run([sys.executable, *launcher, f"--world_info={world}",
                             "--master_port=29512", str(script), str(d)], env=env, timeout=60,
                            cwd=REPO).returncode
        assert rc == 0
        out[name] = [json.loads((d / f"r{i}.json").read_text()) for i in range(2)]
    for port, jax_ in zip(out["port"], out["jax"]):
        assert jax_["COORDINATOR_ADDRESS"] == "127.0.0.1:29512"
        assert port["COORDINATOR_ADDRESS"] is None and port["PROCESS_ID"] is None
        keep = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
        assert {k: port[k] for k in keep} == {k: jax_[k] for k in keep}
    fail = tmp_path / "fail.py"
    fail.write_text("import os, sys, time\nif os.environ['RANK'] == '1':\n    sys.exit(3)\n"
                    "time.sleep(30)\n")
    rc = subprocess.run([sys.executable, *launchers["port"], f"--world_info={world}",
                         str(fail)], env=env, timeout=60, cwd=REPO).returncode
    assert rc == 3


def test_cli_elastic_prints_the_jax_solution(tmp_path, capsys):
    path = tmp_path / "ds.json"
    path.write_text(json.dumps(elastic()))
    assert tcli.main(["elastic", "-c", str(path), "-w", "4"]) == 0
    port = capsys.readouterr().out
    assert jcli.dst_elastic_main(["-c", str(path), "-w", "4"]) == 0
    assert port == capsys.readouterr().out
    assert tcli.main([]) == 2


# --------------------------------------------------------------------------- #
# the preemption exit
# --------------------------------------------------------------------------- #
PREEMPT_WORKER = textwrap.dedent("""\
    import json, sys
    import numpy as np
    sys.path.insert(0, {repo!r})
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig
    from deepspeed_tpu_torch.testing import fault_injection as fi
    from tests.torch_robust_worker import TINY
    ck, jsonl = sys.argv[1], sys.argv[2]
    model = GPT(GPTConfig(dtype="float32", **TINY), device="cpu", seed=0)
    eng = dst.initialize(model=model, device="cpu", config={{
        "train_micro_batch_size_per_gpu": 2, "optimizer": {{"type": "AdamW"}},
        "fault_tolerance": {{"preemption_enabled": True, "preemption_grace_s": 30}},
        "telemetry": {{"enabled": True, "jsonl_path": jsonl, "flush_every": 1}}}})[0]
    fi.install_plan([{{"site": "train.step", "action": "sigterm", "on_hit": 2}}])
    ids = np.random.default_rng(0).integers(0, 300, (1, 2, 16)).astype(np.int32)
    for step in range(4):
        eng.train_batch(batch=(ids, ids))
        if step == 0:
            eng.save_checkpoint(ck)
    print("NOT PREEMPTED", flush=True)
    """).format(repo=str(REPO))


def test_preemption_saves_preempt_step_and_exits_143(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(PREEMPT_WORKER)
    ck, jsonl = tmp_path / "ck", tmp_path / "t.jsonl"
    proc = subprocess.run([sys.executable, str(script), str(ck), str(jsonl)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 143, proc.stderr[-3000:]
    assert "NOT PREEMPTED" not in proc.stdout
    assert (ck / "latest").read_text() == "preempt_step2"
    from deepspeed_tpu_torch.runtime.checkpoint_engine.manifest import manifest_ok
    assert manifest_ok(str(ck / "preempt_step2"))[0]
    records = [json.loads(line) for line in jsonl.read_text().splitlines()]
    pre = [r for r in records if r["kind"] == "preemption"]
    assert [r["phase"] for r in pre] == ["notice", "exit"]
    assert pre[0]["reason"] == f"signal:{int(signal.SIGTERM)}"
    assert pre[1]["saved"] and pre[1]["tag"] == "preempt_step2" and pre[1]["step"] == 2
    efficiency = json.loads((tmp_path / "EFFICIENCY.json").read_text())
    assert efficiency["ledger"]["categories"]["ckpt_stall"] > 0
