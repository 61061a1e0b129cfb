"""The port's collective recovery against the JAX package's, on the CPU
(``comm/recovery.py``, the engine's recovery boundary and ladder,
``comm/bounded.py``).

* The wire format: rendezvous files (members, heartbeats, abort, acks,
  plan, quarantine) and recovery markers written by either package are
  read by the other; ``RecoveryPolicy`` parses a block and decides the
  ladder's rungs as JAX's does.
* In process (a gloo world of one at ZeRO stage 1, so the step runs
  collectives): a ``comm.collective`` wedge fires under the deadline, the
  engine takes the retry rung with one incident, books ``comm_recovery``
  and ends with the parameters of an unwedged run; ``/recovery`` answers
  on the ops server.  An incident past ``max_step_retries`` exits 113 and
  leaves the marker JAX's agent consumes.
* Two gloo ranks at ZeRO stage 2 with the stability block and a nan plan:
  both skip the same step and end with equal parameters.
* Four gloo ranks, rank 3 SIGKILLed at a step boundary after a checkpoint:
  the survivors see it dead, rank 2 leaves with 114, ranks 0-1 make the
  group again at world 2, lay ZeRO out again from the checkpoint and finish
  with the loss of a clean world-2 run resumed from that checkpoint;
  ``tools/recovery_report.py`` passes on rank 0's JSONL.
"""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from deepspeed_tpu.comm import recovery as jrec
import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.comm import recovery as trec
from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig
from deepspeed_tpu_torch.testing import fault_injection as fi
from tests.test_torch_zero import free_port
from tests.torch_robust_worker import TINY

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_robust_worker.py"


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "DS_RECOVERY_DIR", "DS_FAULT_PLAN"):
        monkeypatch.delenv(key, raising=False)
    yield
    fi.clear_plan()
    comm.destroy_process_group()


def tool(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------------------------- #
# the wire format and the policy
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_rendezvous_files_and_markers_cross_packages(tmp_path, writer):
    w, r = (trec, jrec) if writer == "port" else (jrec, trec)
    a = w.FileRendezvous(str(tmp_path), rank=0, world_size=2, clock=lambda: 100.0)
    b = r.FileRendezvous(str(tmp_path), rank=1, world_size=2, clock=lambda: 100.5)
    a.announce()
    a.heartbeat(step=7, epoch=0)
    b.announce()
    assert sorted(b.members()) == [0, 1] and b.heartbeats()[0]["step"] == 7
    assert a.signal_abort(0, {"cause": "collective_timeout", "detail": {"op": "x"}})
    assert b.read_abort(0)["cause"] == "collective_timeout"
    a.ack_abort(0, {"step": 7})
    assert 0 in b.acks(0)
    a.publish_plan(0, {"rung": "shrink", "new_world": 1, "kept_ranks": [0]})
    assert b.read_plan(0)["kept_ranks"] == [0]
    a.write_quarantine([1], detail={"why": "dead"})
    assert r.FileRendezvous(str(tmp_path), rank=0, world_size=2).read_quarantine()["ranks"] == [1]
    w.write_recovery_marker(str(tmp_path), "restart", epoch=3, extra={"step": 5})
    marker = r.consume_recovery_marker(str(tmp_path))
    assert marker["cause"] == "restart" and marker["epoch"] == 3
    assert r.consume_recovery_marker(str(tmp_path)) is None      # one shot
    assert (w.RECOVERY_EXIT_CODES, w.RENDEZVOUS_DIR_ENV) == (r.RECOVERY_EXIT_CODES,
                                                             r.RENDEZVOUS_DIR_ENV)


@pytest.mark.parametrize("block", [
    {}, {"recovery_enabled": True, "max_step_retries": 1, "min_world_size": 2},
    {"recovery_enabled": True, "allow_shrink": False, "allow_restart": False},
])
def test_policy_parses_and_decides_as_jax(block):
    tp = trec.RecoveryPolicy.from_config({"elasticity": block})
    jp = jrec.RecoveryPolicy.from_config({"elasticity": block})
    assert tp.to_json() == jp.to_json()
    cfg = dst.DeepSpeedConfig({"train_batch_size": 8, "elasticity": block}, world_size=8)
    assert trec.RecoveryPolicy.from_config(cfg).to_json() == tp.to_json()
    for attempt in range(3):
        for survivors in range(1, 9):
            assert tp.next_rung(attempt, survivors, 8) == jp.next_rung(attempt, survivors, 8)
            assert tp.shrink_target(survivors) == jp.shrink_target(survivors)


# --------------------------------------------------------------------------- #
# in process: retry in place, then the restart exit
# --------------------------------------------------------------------------- #
RECOVERY = {"recovery_enabled": True, "collective_timeout_s": 1.0, "max_step_retries": 1,
            "retry_backoff_s": 0.05}


def engine(tmp_path, recovery=True, retries=1, **telemetry):
    config = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 1,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
              "zero_optimization": {"stage": 1}, "steps_per_print": 10 ** 9}
    if recovery:
        config["elasticity"] = dict(RECOVERY, rendezvous_dir=str(tmp_path / "rdv"),
                                    max_step_retries=retries)
    if telemetry:
        config["telemetry"] = dict({"enabled": True, "flush_every": 1}, **telemetry)
    model = GPT(GPTConfig(dtype="float32", **TINY), device="cpu", seed=0)
    return dst.initialize(model=model, device="cpu", config=config, seed=0)[0]


def batches(n):
    """``n`` batches of ``[gas 1, micro 2, seq 16]`` ids and their labels."""
    rng = np.random.default_rng(5)
    out = []
    for _ in range(n):
        ids = rng.integers(0, TINY["vocab_size"], (1, 2, 16)).astype(np.int32)
        out.append((ids, np.roll(ids, -1, axis=-1)))
    return out


def test_wedged_collective_retries_in_place(tmp_path):
    data = batches(3)
    ref = engine(tmp_path, recovery=False)
    for ids, labels in data:
        ref.train_batch(batch=(ids, labels))
    want = ref.get_fp32_params()
    ref.close()
    comm.destroy_process_group()

    eng = engine(tmp_path, ops_server=True)
    # the step's first collective wedges: the deadline expires, the
    # abandoned call is freed and finishes the step, the retry takes it
    fi.install_plan([{"site": "comm.collective", "action": "wedge", "on_hit": 1}])
    t0 = time.monotonic()
    for ids, labels in data:
        eng.train_batch(batch=(ids, labels))
    assert time.monotonic() - t0 >= RECOVERY["collective_timeout_s"]
    got = eng.get_fp32_params()
    assert all(torch.equal(got[k], v) for k, v in want.items())
    status = eng.recovery_manager.status()
    assert status["incidents"] == status["recoveries"] == 1
    assert status["ladder_state"] == "recovered"
    assert status["last_abort"]["cause"] == "collective_timeout"
    assert eng.global_steps == 3
    led = eng.telemetry.ledger.snapshot()
    assert led["categories"]["comm_recovery"] >= 0.5 * RECOVERY["collective_timeout_s"]
    import urllib.request
    url = eng.telemetry.obs_server.url
    body = json.loads(urllib.request.urlopen(url + "/recovery", timeout=10).read())
    assert body["incidents"] == 1
    eng.close()


def test_an_incident_past_the_retries_exits_113_with_the_marker(tmp_path):
    """With no retry left (``max_step_retries`` 0 here; on the card a second
    wedge in the recapture after one retry, ``chip_smoke.py`` phase 39) the
    ladder's last rung exits 113 for the elastic agent."""
    eng = engine(tmp_path, retries=0)
    ids, labels = batches(1)[0]
    eng.train_batch(batch=(ids, labels))
    fi.install_plan([{"site": "comm.collective", "action": "wedge", "on_hit": 1}])
    with pytest.raises(SystemExit) as exc:
        eng.train_batch(batch=(ids, labels))
    assert exc.value.code == trec.RECOVERY_RESTART_EXIT_CODE == 113
    marker = jrec.consume_recovery_marker(str(tmp_path / "rdv"))
    assert marker is not None and marker["cause"] == "restart"


# --------------------------------------------------------------------------- #
# across processes
# --------------------------------------------------------------------------- #
def spawn(tmp_path, rank, world, port, cfgv, rdv="rdv"):
    env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), DS_RECOVERY_DIR=str(tmp_path / rdv),
               PYTHONPATH=str(REPO))
    env.pop("DS_FAULT_PLAN", None)
    return subprocess.Popen([sys.executable, str(WORKER), json.dumps(cfgv)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def reap(procs, timeout_s):
    deadline = time.monotonic() + timeout_s
    out, hung = {}, []
    for rank, p in procs.items():
        try:
            o, e = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            out[rank] = (p.returncode, o, e)
        except subprocess.TimeoutExpired:
            hung.append(rank)
            p.kill()
            p.communicate()
    assert not hung, f"hung ranks: {hung}"
    return out


def result(stdout):
    for line in stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    return None


def test_two_gloo_ranks_at_stage_2_skip_the_same_step(tmp_path):
    port = free_port()
    cfgv = {"steps": 4, "stage": 2,
            "config": {"stability": {"enabled": True, "warmup_steps": 100}},
            "plan": [{"site": "train.grads", "action": "nan", "on_hit": 2}]}
    res = reap({r: spawn(tmp_path, r, 2, port, cfgv) for r in range(2)}, 120)
    assert all(rc == 0 for rc, _, _ in res.values()), {r: v[2][-2000:] for r, v in res.items()}
    r0, r1 = result(res[0][1]), result(res[1][1])
    assert r0["skipped"] == r1["skipped"] == 1
    assert r0["digest"] == r1["digest"] and r0["losses"] == r1["losses"]


def test_a_killed_rank_shrinks_four_ranks_to_two_with_the_loss_of_a_clean_run(tmp_path):
    world, total, save_at = 4, 6, 2
    ckpt = str(tmp_path / "ck")
    rec = {"recovery_enabled": True, "collective_timeout_s": 30.0,
           "heartbeat_interval_s": 0.1, "heartbeat_timeout_s": 2.0, "retry_backoff_s": 0.05}
    port = free_port()
    procs = {}
    for rank in range(world):
        cfgv = {"steps": total, "save_step": save_at, "ckpt_dir": ckpt, "step_sleep": 0.3,
                "config": {"elasticity": rec, "telemetry": {
                    "enabled": True, "flush_every": 1,
                    "jsonl_path": str(tmp_path / f"rank{rank}.jsonl")}}}
        if rank == 3:
            # SIGKILLed at the boundary of step 3, after the step-2 checkpoint
            cfgv["plan"] = [{"site": "train.step", "action": "kill",
                             "signal": int(signal.SIGKILL), "on_hit": 3}]
        procs[rank] = spawn(tmp_path, rank, world, port, cfgv)
    res = reap(procs, 240)
    rc = {r: v[0] for r, v in res.items()}
    tails = {r: v[2][-2000:] for r, v in res.items()}
    assert rc == {0: 0, 1: 0, 2: trec.MESH_SHRINK_EXIT_CODE, 3: -signal.SIGKILL}, tails
    results = [result(res[r][1]) for r in (0, 1)]
    for r in results:
        assert r["final_step"] == total and r["world"] == 2
        st = r["status"]
        assert st["ladder_state"] == "recovered" and st["world_size"] == 2
        assert 3 in st["quarantined_ranks"] and st["last_abort"]["cause"] == "rank_dead"
    assert results[0]["digest"] == results[1]["digest"]
    marker = jrec.consume_recovery_marker(str(tmp_path / "rdv"))
    assert marker is not None and marker["cause"] == "mesh_shrink"

    # a clean world-2 run resumed from the same checkpoint
    port = free_port()
    clean = reap({r: spawn(tmp_path, r, 2, port, {"steps": total, "load_dir": ckpt},
                           rdv="rdv_clean") for r in range(2)}, 120)
    assert all(v[0] == 0 for v in clean.values()), {r: v[2][-2000:] for r, v in clean.items()}
    want = result(clean[0][1])
    assert want["final_loss"] == results[0]["final_loss"]
    assert want["digest"] == results[0]["digest"]
    # rank 0 writes the JSONL (the hub's rank-0 sink)
    assert not (tmp_path / "rank1.jsonl").exists()
    assert tool("recovery_report").main([str(tmp_path / "rank0.jsonl"), "--max-recovery-s", "60",
                                         "--forbid-cold-restart"]) == 0
