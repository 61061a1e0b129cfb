"""The port's engines under the telemetry plane against the JAX package's,
on the CPU (``runtime/config.py``, ``comm/``, ``runtime/checkpointing.py``,
``runtime/engine.py``, ``serving/``, ``inference/``, ``moe/``).

* The ``telemetry`` block: every key of JAX's ``DeepSpeedTelemetryConfig``
  with its default; the blocks still unported go on raising, each naming
  its ROADMAP entry (``wall_clock_breakdown``, the comms logger, the
  monitors, the flops profiler, progressive layer drop, ...).
* Training: JAX's engine and ``initialize()`` run three steps with the
  block on; the step records' ``loss`` and ``grad_norm`` agree within the
  training tests' 1e-5 relative, ``lr`` and ``global_samples`` exactly.
  The port's JSONL, ``EFFICIENCY.json`` and Chrome trace (the
  ``train_batch`` span; the eager API's ``fwd`` / ``bwd`` / ``step``) are
  written, and the checkpoint spans and events (``ckpt_saved``,
  ``ckpt_rollback``).  With a step graph's static outputs (a stand-in
  that overwrites its outputs at every run, as a replay does), each record
  holds its own step's loss and norm.  A ``train.step`` wedge outlasting a
  short ``watchdog_timeout_s`` leaves a dump naming the open span.
* Serving: JAX's and the port's engines serve the same prompts with a hub
  (a preempting, spilling arena; a prefix-sharing one): the same sequence
  of event kinds with the same host-side fields (times excluded); under a
  forced TTFT burn both shed ladders move alike and shed the same
  request.  A mid-run HTTP scrape of the port's engine shows live
  histograms and gauges; a dict-built hub is the engine's to close, and
  ``tools/serve_report.py`` reads its JSONL.
* Inference: ``init_inference(telemetry=...)`` records each request as
  JAX's does, with the four ``inference.*`` spans.
* MoE: ``MoE(telemetry=hub)`` buffers JAX's ``moe_gauge`` values, and none
  while a stream captures.
* Across ranks: in one spawn of two gloo ranks (``tests/torch_zero_worker.py``)
  the four collectives under the plane's counters, monitor and spans, the
  cross-rank metrics fold (equal to the host merge of the ranks'
  snapshots) and the collective monitor's gather (equal views; the fold
  equal to JAX's ``fold_windows``).
* ``cuda`` tests (skip here): on the card, a graphed ``train_batch``'s
  records flushed after five steps equal each step's own loss and norm;
  a serving run with the hub gives the tokens of one without it.

Every test resets the global tracer.
"""

import copy
import json
import multiprocessing
import os
import re
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.moe.layer import MoE as JMoE
from deepspeed_tpu.runtime.config import DeepSpeedTelemetryConfig as JTelemetryConfig
from deepspeed_tpu.serving import DeepSpeedServingConfig as JServingConfig
from deepspeed_tpu.serving import ServingEngine as JServingEngine
from deepspeed_tpu.serving.scheduler import ShedError as JShedError
from deepspeed_tpu.telemetry import collective_monitor as jcm
from deepspeed_tpu.telemetry import flight_recorder as jfr
from deepspeed_tpu.telemetry import metrics as jmetrics
from deepspeed_tpu.telemetry import tracing as jtracing
from deepspeed_tpu.telemetry.hub import RingBufferSink as JRing
from deepspeed_tpu.telemetry.hub import TelemetryHub as JHub
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.moe.layer import MoE
from deepspeed_tpu_torch.runtime.config import DeepSpeedTelemetryConfig
from deepspeed_tpu_torch.serving.scheduler import ShedError
from deepspeed_tpu_torch.telemetry import collective_monitor as tcm
from deepspeed_tpu_torch.telemetry import metrics as tmetrics
from deepspeed_tpu_torch.telemetry import tracing as ttracing
from deepspeed_tpu_torch.telemetry.hub import RingBufferSink, TelemetryHub
from deepspeed_tpu_torch.testing import fault_injection as fi
from tests import torch_zero_worker
from tests.test_torch_training import MODELS, batch
from tests.test_torch_zero import free_port
from tests.torch_serving_common import prompts_of, settle_io, tiny_models

REPO = Path(__file__).resolve().parents[1]
STEPS, MICRO, GAS, SEQ, LR = 3, 2, 2, 16, 1e-3


@pytest.fixture(autouse=True)
def _clean():
    yield
    ttracing.set_global_tracer(None)
    jtracing.set_global_tracer(None)
    fi.clear_plan()


def train_config(**telemetry):
    cfg = {"train_micro_batch_size_per_gpu": MICRO, "gradient_accumulation_steps": GAS,
           "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 4,
                                                         "warmup_max_lr": LR}},
           "gradient_clipping": 1.0, "steps_per_print": 10 ** 9}
    if telemetry:
        cfg["telemetry"] = dict({"enabled": True}, **telemetry)
    return cfg


def port_engine(config, params=None):
    model = tgpt.GPT(tgpt.GPTConfig(dtype="float32", **MODELS["tiny"]), device="cpu")
    return dst.initialize(model=model, config=config, model_parameters=params, device="cpu")[0]


def kinds_of(ring, kind):
    return [r for r in ring.records if r.get("kind") == kind]


# --------------------------------------------------------------------------- #
# the config block and the refusals
# --------------------------------------------------------------------------- #
def test_telemetry_config_has_jax_keys_and_defaults():
    jfields, tfields = JTelemetryConfig.model_fields, DeepSpeedTelemetryConfig.model_fields
    assert list(tfields) == list(jfields)
    j, t = JTelemetryConfig().model_dump(), DeepSpeedTelemetryConfig().model_dump()
    for key in ("profiler_dir", "flight_recorder_dir"):          # under TMPDIR in the port
        assert os.path.basename(t.pop(key)) == os.path.basename(j.pop(key))
    assert t == j
    full = dict(enabled=True, jsonl_path="x.jsonl", flush_every=3, ops_server=True,
                slo_rules=[{"name": "r", "metric": "m", "op": "value", "bound": 1.0}],
                profiler_dir="p", flight_recorder_dir="f", watchdog_enabled=True)
    assert (DeepSpeedTelemetryConfig(**full).model_dump()
            == JTelemetryConfig(**full).model_dump())


@pytest.mark.parametrize("config,item", [
    ({"wall_clock_breakdown": True}, r"item 8 \(wall_clock_breakdown\)"),
    ({"progressive_layer_drop": {"enabled": True}}, r"item 9 \(progressive layer drop\)"),
    ({"csv_monitor": {"enabled": True}}, r"item 9 \(monitor\)"),
    ({"comms_logger": {"enabled": True}}, r"item 7 \(comms\)"),
    ({"tensorboard": {"enabled": True}}, r"item 9 \(monitor\)"),
    ({"flops_profiler": {"enabled": True}}, r"item 9 \(flops profiler\)"),
    ({"telemetry": {"enabled": True, "goodput_peak_tflops_per_chip": 989.0}},
     r"item 9 \(flops profiler\)"),
])
def test_unported_blocks_beside_telemetry_still_raise(config, item):
    model = tgpt.GPT(tgpt.GPTConfig(dtype="float32", **MODELS["tiny"]), device="cpu")
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md, Queue 1 {item}"):
        dst.initialize(model=model, device="cpu",
                       config=dict(train_config(jsonl_path=""), **config))


# --------------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jax_setup():
    jcfg = jgpt.GPTConfig(dtype="float32", **MODELS["tiny"])
    jparams = jax.tree.map(lambda a: np.asarray(a) * (4.0 if np.ndim(a) >= 2 else 1.0),
                           jgpt.GPT(jcfg).init_params(jax.random.PRNGKey(0)))
    batches = [batch(jcfg.vocab_size, MICRO, SEQ, seed=60 + i, gas=GAS) for i in range(STEPS)]
    return jcfg, jparams, batches


def test_training_step_records_match_jax(jax_setup, tmp_path, monkeypatch):
    monkeypatch.setenv("DST_PALLAS_CE", "0")
    monkeypatch.setenv("DST_PALLAS_FUSED_OPT", "0")
    jcfg, jparams, batches = jax_setup
    from deepspeed_tpu.parallel import mesh as mesh_lib
    mesh = mesh_lib.MeshSpec(device_count=1).build(jax.devices()[:1])
    try:
        jeng = deepspeed_tpu.initialize(model=jgpt.GPT(jcfg), model_parameters=jparams,
                                        config=train_config(flush_every=STEPS),
                                        mesh=mesh)[0]
        for ids, labels in batches:
            jeng.train_batch(batch=(ids, labels))
        want = kinds_of(jeng.telemetry.ring, "step")
        jeng.close()
    finally:
        mesh_lib.reset_mesh()
    jsonl = tmp_path / "t.jsonl"
    eng = port_engine(train_config(flush_every=STEPS, jsonl_path=str(jsonl), tracing=True,
                                   trace_dir=str(tmp_path)), params_from_jax(jparams))
    for ids, labels in batches:
        eng.train_batch(batch=(ids, labels))
    got = kinds_of(eng.telemetry.ring, "step")
    assert len(got) == len(want) == STEPS
    for g, w in zip(got, want):
        assert g["step"] == w["step"] and g["global_samples"] == w["global_samples"]
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-12)
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-5)
        assert g["loss_scale"] == w["loss_scale"] == 1.0
    # the eager API's spans and a checkpoint's, then the files of close()
    ids, labels = batches[0]
    for i in range(GAS):
        eng.backward(eng.forward(ids[i], labels[i]))
        eng.step()
    eng.save_checkpoint(str(tmp_path / "ck"))
    eng.train_batch(batch=batches[1])
    eng.save_checkpoint(str(tmp_path / "ck"))
    newest = tmp_path / "ck" / f"global_step{eng.global_steps}" / "state.pt"
    newest.write_bytes(newest.read_bytes()[:-7] + b"corrupt")
    eng.load_checkpoint(str(tmp_path / "ck"))
    saved = kinds_of(eng.telemetry.ring, "ckpt_saved")
    (rollback,) = kinds_of(eng.telemetry.ring, "ckpt_rollback")
    assert [r["tag"] for r in saved] == ["global_step4", "global_step5"]
    assert (rollback["from_tag"], rollback["to_tag"]) == ("global_step5", "global_step4")
    eng.close()
    spans = [e["name"] for e in json.loads((tmp_path / "trace_rank0.json").read_text())
             ["traceEvents"] if e.get("ph") == "X"]
    assert spans.count("train_batch") == STEPS + 1
    assert spans.count("fwd") == spans.count("bwd") == GAS and spans.count("step") == 1
    assert spans.count("checkpoint.save") == 2 and spans.count("checkpoint.load") == 1
    records = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert records[0]["kind"] == "schema"
    assert [r["step"] for r in records if r["kind"] == "step"] == [1, 2, 3, 4, 5]
    efficiency = json.loads((tmp_path / "EFFICIENCY.json").read_text())
    assert efficiency["ledger"]["steps"] == 5 and efficiency["ledger"]["conservation"]["ok"]
    assert efficiency["ledger"]["categories"]["ckpt_stall"] > 0
    assert ttracing.get_global_tracer() is None


class StaticGraphs:
    """A stand-in for ``StepGraphs`` on the CPU: like a replay, every run
    writes its outputs into the same static tensors and returns those."""

    captures = 1

    def __init__(self, engine):
        self.engine, self.outputs = engine, None

    def run(self, sources, body):
        out = body([self.engine._place(x) for x in sources])
        if self.outputs is None:
            self.outputs = [t.detach().clone() for t in out]
        for static, t in zip(self.outputs, out):
            static.copy_(t)
        return self.outputs

    def clear(self):
        pass


def test_graphed_records_hold_each_steps_own_values(jax_setup):
    _, jparams, batches = jax_setup
    params = params_from_jax(jparams)
    ref = port_engine(train_config(), params)
    want = []
    for ids, labels in batches:
        want.append((float(ref.train_batch(batch=(ids, labels))), ref.get_global_grad_norm()))
    eng = port_engine(train_config(flush_every=STEPS), params)
    eng.graphs = StaticGraphs(eng)
    for ids, labels in batches:
        eng.train_batch(batch=(ids, labels))
    got = [(r["loss"], r["grad_norm"]) for r in kinds_of(eng.telemetry.ring, "step")]
    assert got == want and len(set(got)) == len(got)
    eng.close()


WEDGED = "stall:train_batch step=1"


def wedge_dumps(path):
    """The finished dumps of the wedged step (a slow step before it, on a
    loaded machine, may leave one of its own)."""
    dumps = [jfr.read_dump(str(p)) for p in sorted(path.glob("flight_rank0_*.jsonl"))]
    return [d for d in dumps if d.get("header") and d["header"][0]["reason"] == WEDGED
            and d.get("end") == [{"complete": True}]]


def test_train_step_wedge_dumps_the_open_span(tmp_path):
    eng = port_engine(train_config(tracing=True, watchdog_enabled=True,
                                   watchdog_timeout_s=1.0, watchdog_poll_s=0.05,
                                   watchdog_signal_dump=False,
                                   flight_recorder_dir=str(tmp_path)))
    ids, labels = batch(300, MICRO, SEQ, seed=3, gas=GAS)
    eng.train_batch(batch=(ids, labels))
    fi.install_plan([{"site": "train.step", "action": "wedge", "max_wedge_s": 60.0}])

    def release():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                if wedge_dumps(tmp_path):
                    break
            except (OSError, ValueError):       # a dump still being written
                pass
            time.sleep(0.05)
        fi.release_wedges()
    t = threading.Thread(target=release)
    t.start()
    eng.train_batch(batch=(ids, labels))
    t.join(timeout=90)
    assert not t.is_alive()
    (sections,) = wedge_dumps(tmp_path)
    assert [s["name"] for s in sections["open_spans"][0]] == ["train_batch"]
    assert eng.global_steps == 2
    eng.close()


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #
# times, and the disk tier's bytes, which follow its writer threads' timing
TIME_FIELDS = {"ttft_ms", "latency_ms", "tokens_per_sec", "age_ms", "elapsed_ms",
               "queue_age_ms", "wait_ms", "recovery_s", "deadline_ms", "kv_restage_wait_ms",
               "kv_nvme_bytes"}
# a TTFT objective no run here misses: JAX's first requests wait for its
# compiles, which would burn the default rule and shed in JAX alone
CALM_TTFT = [{"name": "ttft", "metric": "serve_ttft_ms", "op": "p99", "bound": 1e9}]
TIME_KINDS = {"goodput", "slo_burn", "slo_clear"}
SERVE_CASES = {
    # preemptions, spills to the host tier and restages
    "tiered": (dict(block_size=4, num_blocks=10, max_batch_size=4, prefill_chunk=8,
                    max_blocks_per_seq=9, dtype="float32", kv_tiering=True,
                    telemetry_every=2),
               (7, 11, 5, 9, 13, 6), (12, 6, 10, 8, 5, 9), 3),
    # prefix hits and recompute under preemption
    "prefix": (dict(block_size=4, num_blocks=16, max_batch_size=3, prefill_chunk=8,
                    dtype="float32", prefix_cache=True, telemetry_every=3),
               (9, 12, 10, 11, 9), (8, 10, 6, 9, 12), 2),
}


@pytest.fixture(scope="module")
def serving_models():
    return tiny_models(seed=1)


def hubs(**kw):
    """A JAX hub and a port hub from the same telemetry block, each with
    an in-memory ring (and the registry, SLO monitor and ledger)."""
    cfg = dict(enabled=True, ring_buffer_size=4096, flush_every=0, **kw)
    return (JHub.from_config(JTelemetryConfig(**cfg)),
            TelemetryHub.from_config(DeepSpeedTelemetryConfig(**cfg), device="cpu"))


def host_events(hub):
    hub.flush()
    return [{k: v for k, v in r.items() if k not in TIME_FIELDS}
            for r in hub.ring.records if r["kind"] not in TIME_KINDS]


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_serving_events_match_jax(serving_models, case):
    jmodel, jparams, port = serving_models
    serving, lens, mnts, first = SERVE_CASES[case]
    prompts = prompts_of(11, lens)
    if case == "prefix":
        prompts = [prompts[0][:8] + p for p in prompts]       # a shared 8-token prefix
    jhub, thub = hubs(slo_rules=CALM_TTFT)
    jeng = JServingEngine(jmodel, config=JServingConfig(**serving), params=jparams,
                          telemetry=jhub)
    teng = dst.init_serving(model=port, config={"serving": serving}, device="cpu",
                            telemetry=thub)
    outs = []
    for eng in (jeng, teng):
        if eng.tiering is not None:
            settle_io(eng)
        futs = [eng.submit(p, max_new_tokens=m) for p, m in zip(prompts[:first], mnts)]
        for _ in range(3):
            eng.step()
        futs += [eng.submit(p, max_new_tokens=m)
                 for p, m in zip(prompts[first:], mnts[first:])]
        eng.run()
        outs.append([f.token_ids for f in futs])
    assert outs[0] == outs[1]
    want, got = host_events(jhub), host_events(thub)
    assert [r["kind"] for r in got] == [r["kind"] for r in want]
    assert got == want
    kinds = {r["kind"] for r in got}
    expect = {"serve_request", "serve_step", "serve_preempt"}
    expect |= {"kv_spill", "kv_restage"} if case == "tiered" else {"prefix_hit"}
    assert expect <= kinds
    for hub in (jhub, thub):
        assert hub.registry.snapshot()["counters"]["serve_finished_total"]["value"] == len(lens)
    for eng in (jeng, teng):
        eng.close()


def test_ttft_burn_sheds_alike(serving_models):
    jmodel, jparams, port = serving_models
    serving = dict(block_size=8, num_blocks=64, max_batch_size=4, prefill_chunk=8,
                   dtype="float32", telemetry_every=1, shed_recovery_steps=3)
    rule = {"name": "ttft", "metric": "serve_ttft_ms", "op": "p99", "bound": 1e-6,
            "min_samples": 1, "budget_frac": 0.5, "fast_burn": 1.0, "slow_burn": 1.0}
    jhub, thub = hubs(slo_rules=[rule])
    jeng = JServingEngine(jmodel, config=JServingConfig(**serving), params=jparams,
                          telemetry=jhub)
    teng = dst.init_serving(model=port, config={"serving": serving}, device="cpu",
                            telemetry=thub)
    ladders = []
    for eng, shed in ((jeng, JShedError), (teng, ShedError)):
        ladder = []
        eng.submit([5, 6, 7], max_new_tokens=3).result()      # a TTFT sample: the rule burns
        for i in range(6):
            try:
                eng.submit([9, 10, 11, 12], max_new_tokens=2, slo="batch")
                ladder.append(("admitted", eng.admission.level))
            except shed:
                ladder.append(("shed", eng.admission.level))
            eng.step()
        ladders.append(ladder)
    assert ladders[0] == ladders[1]
    assert ("shed", 2) in ladders[1]
    assert host_events(jhub) == host_events(thub)
    assert thub.slo_monitor.state_for_metric("serve_ttft_ms") == "burn_fast"
    for eng in (jeng, teng):
        eng.close()


def prom(text, name):
    m = re.search(rf"^{re.escape(name)} (\S+)$", text, re.MULTILINE)
    return float(m.group(1)) if m else None


def test_mid_run_scrape_and_a_dict_built_hub(serving_models, tmp_path):
    """As ``tests/unit/serving/test_serving_obs.py`` for the JAX engine: a
    scrape mid-run shows populated TTFT / latency histograms and live arena
    gauges, ``/healthz`` is healthy with ``serve_arena``.  The dict-built
    hub and tracer are the engine's: ``close()`` writes the JSONL's last
    records and the trace, which the repo's report reads."""
    _, _, port = serving_models
    jsonl = tmp_path / "serve.jsonl"
    eng = dst.init_serving(model=port, device="cpu", config={"serving": dict(
        block_size=8, num_blocks=64, max_batch_size=4, prefill_chunk=16, telemetry_every=2,
        dtype="float32")}, telemetry={"enabled": True, "jsonl_path": str(jsonl),
                                      "flush_every": 2, "ops_server": True, "ops_port": 0,
                                      "tracing": True, "trace_dir": str(tmp_path)})
    url = eng.telemetry.obs_server.url
    futs = [eng.submit(p, max_new_tokens=6) for p in prompts_of(0, (5, 9, 7, 12))]
    while sum(f.done for f in futs) < 2:
        eng.step()
    assert not all(f.done for f in futs)
    with urllib.request.urlopen(f"{url}/metrics", timeout=10) as r:
        text = r.read().decode()
    assert prom(text, "dstpu_serve_ttft_ms_count") >= 2
    assert prom(text, "dstpu_serve_latency_ms_count") >= 2
    assert prom(text, "dstpu_serve_blocks_in_use") > 0
    for name in ("dstpu_serve_kv_host_bytes", "dstpu_serve_step_ms_count",
                 "dstpu_serve_decode_step_ms_count", "dstpu_goodput_frac"):
        assert name in text
    with urllib.request.urlopen(f"{url}/healthz", timeout=10) as r:
        health = json.loads(r.read().decode())
    assert health["healthy"] and health["checks"]["serve_arena"]["blocks_in_use"] > 0
    eng.run()
    eng.close()
    assert eng.telemetry.closed and eng.telemetry.obs_server._thread is None
    spans = {e["name"] for e in json.loads((tmp_path / "trace_rank0.json").read_text())
             ["traceEvents"] if e.get("ph") == "X"}
    assert {"serve.step", "serve.prefill", "serve.decode"} <= spans
    import importlib.util
    spec = importlib.util.spec_from_file_location("_serve_report",
                                                  REPO / "tools" / "serve_report.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = tmp_path / "report.json"
    assert tool.main([str(jsonl), "--json", str(out), "--forbid-incident-loss"]) == 0
    report = json.loads(out.read_text())
    assert report["finished"] == 4 and report["new_tokens"] == 24
    goodput = json.loads((tmp_path / "EFFICIENCY.json").read_text())["ledger"]
    assert goodput["mode"] == "serve" and goodput["serve"]


# --------------------------------------------------------------------------- #
# inference and MoE
# --------------------------------------------------------------------------- #
def test_inference_requests_match_jax(serving_models):
    jmodel, jparams, port = serving_models
    cfg = {"enabled": True, "ring_buffer_size": 64}
    jeng = deepspeed_tpu.init_inference(model=jmodel, params=jparams, telemetry=cfg,
                                        config={"dtype": "float32"})
    tracer = ttracing.Tracer()
    teng = dst.init_inference(model=port, device="cpu", config={"dtype": "float32"},
                              telemetry=cfg, tracer=tracer)
    ids = np.asarray(prompts_of(5, (6, 6)), np.int32)
    records = []
    for eng in (jeng, teng):
        eng.forward(ids)
        eng.generate(ids, max_new_tokens=4)
        eng.telemetry.flush()
        records.append([{k: v for k, v in r.items() if k not in TIME_FIELDS}
                        for r in eng.telemetry.ring.records if r["kind"] not in TIME_KINDS])
    assert records[1] == records[0]
    assert [r["op"] for r in records[1]] == ["forward", "generate"]
    names = [s["name"] for s in tracer.snapshot()]
    assert names == ["inference.decode", "inference.forward", "inference.prefill",
                     "inference.decode", "inference.generate"]


def test_inference_closes_the_hub_it_built(serving_models, tmp_path):
    """A dict-built hub and tracer are the engine's: the records wait in
    the hub (``emit`` does not flush) until ``close()``, which writes them
    for JAX's reader, stops the ops server and exports the trace.  A hub
    passed in is its owner's to close."""
    _, _, port = serving_models
    jsonl = tmp_path / "inference.jsonl"
    eng = dst.init_inference(model=port, device="cpu", config={"dtype": "float32"},
                             telemetry={"enabled": True, "jsonl_path": str(jsonl),
                                        "ops_server": True, "ops_port": 0,
                                        "tracing": True, "trace_dir": str(tmp_path)})
    ids = np.asarray(prompts_of(5, (6, 6)), np.int32)
    eng.forward(ids)
    eng.generate(ids, max_new_tokens=4)
    assert not jsonl.exists() and not eng.telemetry.closed
    eng.close()
    eng.close()
    assert eng.telemetry.closed and eng.telemetry.obs_server._thread is None
    from deepspeed_tpu.telemetry import stats as jstats
    records, err = jstats.load_records(str(jsonl))
    assert err is None
    reqs = [r for r in records if r["kind"] == "inference_request"]
    assert [(r["op"], r["batch"], r.get("new_tokens")) for r in reqs] == [
        ("forward", 2, None), ("generate", 2, 8)]
    spans = {e["name"] for e in json.loads((tmp_path / "trace_rank0.json").read_text())
             ["traceEvents"] if e.get("ph") == "X"}
    assert {"inference.forward", "inference.generate", "inference.prefill",
            "inference.decode"} <= spans
    hub = TelemetryHub(sinks=[RingBufferSink()], flush_every=0)
    shared = dst.init_inference(model=port, device="cpu", config={"dtype": "float32"},
                                telemetry=hub)
    shared.forward(ids)
    shared.close()
    assert not hub.closed and len(hub._pending) == 1


def test_moe_gauges_match_jax():
    M, E, H = 32, 4, 48
    kw = dict(hidden_size=M, num_experts=E, k=2, capacity_factor=1.0,
              eval_capacity_factor=1.0, min_capacity=2, expert_hidden=H)
    jhub = JHub(sinks=[JRing()], flush_every=0, sync_fn=lambda: None)
    thub = TelemetryHub(sinks=[RingBufferSink()], flush_every=0)
    jlayer, layer = JMoE(telemetry=jhub, **kw), MoE(telemetry=thub, **kw)
    jparams = jax.tree.map(lambda a: np.asarray(a) * 2.0,
                           jlayer.init_params(jax.random.PRNGKey(1)))
    x = np.random.default_rng(2).standard_normal((3, 10, M)).astype(np.float32)
    jlayer(jax.tree.map(jnp.asarray, jparams), jnp.asarray(x))
    params = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jparams)
    layer(params, torch.tensor(x))
    jhub.flush()
    thub.flush()
    (want,), (got,) = jhub.ring.of_kind("moe_gauge"), thub.ring.of_kind("moe_gauge")
    assert set(got) == set(want) and got["step"] == want["step"] == 1
    for key in ("expert_load", "load_max", "load_min", "load_entropy_frac", "drop_fraction",
                "tokens"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-7, err_msg=key)
    with pytest.MonkeyPatch.context() as mp:          # no gauge while a stream captures
        mp.setattr(torch.cuda, "is_available", lambda: True)
        mp.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
        layer(params, torch.tensor(x))
    assert not thub._pending and layer._gauge_step == 1


# --------------------------------------------------------------------------- #
# across ranks: two gloo ranks in one spawn
# --------------------------------------------------------------------------- #
WORLD, JOIN_TIMEOUT_S = 2, 120


@pytest.fixture(scope="module")
def world2_telemetry(tmp_path_factory):
    out = tmp_path_factory.mktemp("telemetry-world2")
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=torch_zero_worker.run_telemetry,
                         args=(r, WORLD, port, str(out))) for r in range(WORLD)]
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
    return [json.loads((out / f"telemetry{r}.json").read_text()) for r in range(WORLD)]


def test_collectives_feed_the_plane_on_each_rank(world2_telemetry):
    for rank, r in enumerate(world2_telemetry):
        counters = r["own"]["counters"]
        sizes = {"all_reduce": 32, "all_gather": 32, "reduce_scatter": 32, "broadcast": 32}
        for op, nbytes in sizes.items():
            assert counters[f'comm_bytes_total{{op="{op}"}}']["value"] == nbytes
            assert counters[f'comm_ops_total{{op="{op}"}}']["value"] == 1
        records = r["view"]["records"]
        assert [(x["seq"], x["op"]) for x in records] == [
            (1, "all_reduce"), (2, "all_gather"), (3, "reduce_scatter"), (4, "broadcast")]
        assert all(x["t_exit_us"] is not None and x["axis"] == "world" for x in records)
        assert [(name, args["seq"]) for name, args in r["spans"]] == [
            ("comm.all_reduce", 1), ("comm.all_gather", 2), ("comm.reduce_scatter", 3),
            ("comm.broadcast", 4)]


def test_cross_rank_fold_equals_the_host_merge(world2_telemetry):
    own = [r["own"] for r in world2_telemetry]
    want = tmetrics.merge_snapshots(own)
    assert jmetrics.merge_snapshots(own) == want
    for r in world2_telemetry:
        assert r["merged"] == json.loads(json.dumps(want))
    assert want["counters"]["requests"]["value"] == 7.0
    assert want["gauges"]["queue"]["min"] == 2.5 and want["gauges"]["queue"]["max"] == 5.0


def test_collective_gather_over_the_group_equals_the_host_views(world2_telemetry):
    views = [r["view"] for r in world2_telemetry]
    for r in world2_telemetry:
        assert len(r["gathered"]) == WORLD
        for got, view in zip(r["gathered"], views):
            assert got["rank"] == view["rank"]
            assert [{k: x[k] for k in ("seq", "op", "axis", "dtype", "shape", "bytes", "fp",
                                       "t_enter_us")} for x in got["records"]] == [
                {k: x[k] for k in ("seq", "op", "axis", "dtype", "shape", "bytes", "fp",
                                   "t_enter_us")} for x in view["records"]]
        want = jcm.fold_windows(copy.deepcopy(views))
        assert tcm.fold_windows(copy.deepcopy(r["gathered"])) == want
        assert r["health"]["common_seqs"] == want["common_seqs"] == 4
        assert not r["health"]["desync"]["detected"]


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the graphed step and the serving kernels under the "
                    "hub run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_graphed_records_carry_each_steps_values(cuda_device):
    """Five replays of a captured step, flushed once after the fifth: each
    record holds its own step's loss and grad norm (the replay overwrites
    its static outputs), equal to an engine without telemetry read after
    every step; the telemetry keeps one capture."""
    def engine(**telemetry):      # head_dim 64, a width the flash kernels take
        model = tgpt.GPT(tgpt.GPTConfig(vocab_size=300, n_positions=64, n_embd=128, n_layer=2,
                                        n_head=2, dtype="float32"), device=cuda_device, seed=0)
        return dst.initialize(model=model, config=train_config(**telemetry),
                              device=cuda_device, seed=0)[0]
    batches = [tuple(torch.from_numpy(a).to(cuda_device)
                     for a in batch(300, MICRO, SEQ, seed=9 + i, gas=GAS)) for i in range(5)]
    ref = engine()
    want = [(float(ref.train_batch(batch=b)), ref.get_global_grad_norm()) for b in batches]
    eng = engine(flush_every=5)
    for b in batches:
        eng.train_batch(batch=b)
    got = [(r["loss"], r["grad_norm"]) for r in kinds_of(eng.telemetry.ring, "step")]
    assert got == want and len(set(got)) == 5      # five batches: five different steps
    assert eng.graphs.captures == 1 and eng.graphs.replays == 4
    ref.close()
    eng.close()


@pytest.mark.cuda
def test_cuda_serving_tokens_equal_with_the_hub(cuda_device, tmp_path):
    model = tgpt.GPT(tgpt.GPTConfig(vocab_size=256, n_positions=256, n_embd=128, n_layer=2,
                                    n_head=2, dtype="float32"), device=cuda_device, seed=0)
    prompts = prompts_of(4, (40, 70, 25, 55, 33), 256)
    tokens = []
    for telemetry in (None, {"enabled": True, "jsonl_path": str(tmp_path / "s.jsonl"),
                             "ops_server": True, "tracing": True,
                             "trace_dir": str(tmp_path)}):
        kw = {} if telemetry is None else {"telemetry": telemetry}
        eng = dst.init_serving(model=model, device=cuda_device, config={"serving": dict(
            block_size=16, num_blocks=12, max_batch_size=4, prefill_chunk=32,
            dtype="float32", telemetry_every=2)}, **kw)
        futs = [eng.submit(p, max_new_tokens=20) for p in prompts]
        eng.run()
        tokens.append([f.token_ids for f in futs])
        eng.close()
    assert tokens[0] == tokens[1]
    records = [json.loads(line) for line in (tmp_path / "s.jsonl").read_text().splitlines()]
    assert sum(r.get("event") == "finished" for r in records) == len(prompts)
