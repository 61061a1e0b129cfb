"""The port's telemetry plane (``deepspeed_tpu_torch/telemetry/``) against
``deepspeed_tpu/telemetry/``, on the CPU.

* Module parity, one parametrised test: the same scripted call sequences,
  with injected clocks, go into both packages' modules and the results must
  be equal — the record schema, the statistics helpers, the metrics
  registry and ``MetricsSink`` (Prometheus text, single and merged), the
  histogram's quantiles, the SLO monitor (verdicts, ``state_for_metric``
  and the ``slo_burn`` / ``slo_clear`` transitions), the goodput ledger
  (snapshots, the registry it mirrors into, ``fold_goodput``), the tracer
  (Chrome events with times taken out, the ZeRO-3 lanes), the profiler
  window's state machine, the collective fold (``fold_windows``, the
  window records' fold, the pack / unpack round trip), the cross-rank fold
  of explicit rank snapshots (JAX through a device mesh, the port in one
  process) and the JSONL sink's rotation read back through ``stats``.
* What only the port has: the hub drains its buffered device tensors with
  one synchronize and one ``.cpu()`` a device and never ``.item()``; the
  CUDA memory stats under JAX's key names; a flight-recorder dump never
  reads a tensor and JAX's ``read_dump`` reads it; the ops server's
  endpoints over HTTP (bodies equal to JAX's server's) and its join on
  ``stop``; ``ProfilerWindow`` writing a ``torch.profiler`` Chrome trace
  in which a span opened inside the window is named; a watchdog stall
  dumping the open span.
* Formats: JAX's ``report.fold_file`` reads the port's JSONL,
  ``tools/trace_merge.py`` merges the port's Chrome traces and
  ``tools/goodput_report.py`` reads its ``EFFICIENCY.json``.

Every test leaves no global tracer behind.
"""

import copy
import importlib.util
import json
import os
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from deepspeed_tpu.telemetry import collective_monitor as jcm
from deepspeed_tpu.telemetry import events as jevents
from deepspeed_tpu.telemetry import flight_recorder as jfr
from deepspeed_tpu.telemetry import hub as jhub
from deepspeed_tpu.telemetry import ledger as jledger
from deepspeed_tpu.telemetry import metrics as jmetrics
from deepspeed_tpu.telemetry import obs_server as jobs
from deepspeed_tpu.telemetry import profiler as jprofiler
from deepspeed_tpu.telemetry import slo as jslo
from deepspeed_tpu.telemetry import stats as jstats
from deepspeed_tpu.telemetry import tracing as jtracing
from deepspeed_tpu.telemetry.report import fold_file
from deepspeed_tpu_torch.telemetry import collective_monitor as tcm
from deepspeed_tpu_torch.telemetry import events as tevents
from deepspeed_tpu_torch.telemetry import flight_recorder as tfr
from deepspeed_tpu_torch.telemetry import hub as thub
from deepspeed_tpu_torch.telemetry import ledger as tledger
from deepspeed_tpu_torch.telemetry import metrics as tmetrics
from deepspeed_tpu_torch.telemetry import obs_server as tobs
from deepspeed_tpu_torch.telemetry import profiler as tprofiler
from deepspeed_tpu_torch.telemetry import slo as tslo
from deepspeed_tpu_torch.telemetry import stats as tstats
from deepspeed_tpu_torch.telemetry import tracing as ttracing
from deepspeed_tpu_torch.telemetry import watchdog as twatchdog

REPO = Path(__file__).resolve().parents[1]
JAX = types.SimpleNamespace(cm=jcm, events=jevents, hub=jhub, ledger=jledger, metrics=jmetrics,
                            profiler=jprofiler, slo=jslo, stats=jstats, tracing=jtracing)
PORT = types.SimpleNamespace(cm=tcm, events=tevents, hub=thub, ledger=tledger, metrics=tmetrics,
                             profiler=tprofiler, slo=tslo, stats=tstats, tracing=ttracing)


@pytest.fixture(autouse=True)
def _no_global_tracer():
    yield
    ttracing.set_global_tracer(None)
    jtracing.set_global_tracer(None)


class Clock:
    """An injected clock: seconds, or nanoseconds with ``ns=True``."""

    def __init__(self, t=100.0, ns=False):
        self.t, self.ns = t, ns

    def __call__(self):
        return int(self.t * 1e9) if self.ns else self.t

    def advance(self, s):
        self.t += s


class Events:
    """A stand-in hub for the SLO monitor: keeps what it is sent."""

    def __init__(self):
        self.events = []

    def emit(self, kind, payload, step=None):
        self.events.append((kind, dict(payload)))


# --------------------------------------------------------------------------- #
# scripted scenarios, run once on each package
# --------------------------------------------------------------------------- #
SINK_RECORDS = [
    {"kind": "step", "step": 1, "loss": 2.5, "lr": 1e-3, "grad_norm": 0.75,
     "step_time_ms": 12.0, "samples_per_sec": 80.0, "comm_bytes": 4096,
     "device_peak_bytes": 1 << 20},
    {"kind": "serve_request", "event": "submitted", "rid": 1},
    {"kind": "serve_request", "event": "finished", "rid": 1, "new_tokens": 8,
     "ttft_ms": 40.0, "latency_ms": 90.0},
    {"kind": "serve_step", "queue_depth": 3, "active": 2, "blocks_in_use": 7,
     "kv_host_bytes": 512, "kv_nvme_bytes": 0, "elapsed_ms": 50.0, "prefix_lookups": 4,
     "prefix_hits": 1},
    {"kind": "serve_preempt", "rid": 2},
    {"kind": "serve_shed", "event": "level", "level": 2},
    {"kind": "serve_shed", "event": "rejected", "slo": "batch"},
    {"kind": "serve_expired", "slo": "standard"},
    {"kind": "serve_incident", "event": "recovered", "recovery_s": 0.25},
    {"kind": "kv_spill", "tier": "host", "bytes": 2048},
    {"kind": "kv_restage", "ok": True, "wait_ms": 3.0},
    {"kind": "kv_restage", "ok": False},
    {"kind": "prefix_hit", "rid": 3},
    {"kind": "offload_staged", "opt_bytes_written": 100, "opt_ring_hits": 3,
     "ring_hits": 3, "ring_misses": 1, "wait_ms": 2.0},
    {"kind": "offload_wait", "wait_ms": 4.0},
    {"kind": "anomaly"}, {"kind": "auto_rollback"}, {"kind": "lr_backoff"},
    {"kind": "batch_quarantined"},
    {"kind": "comm_summary", "ops": {"all_reduce": {"total_bytes": 1024,
                                                    "compression_ratio": 2.0,
                                                    "buckets": [{"latency_ms": 1.5}]}},
     "total_bytes": 1024, "total_logical_bytes": 2048},
    {"kind": "collective_desync", "desync": {"first_seq": 5}},
    {"kind": "slo_burn", "rule": "serve_p99_ttft_ms", "severity": "fast"},
    {"kind": "downtime", "downtime_s": 3.5},
    {"kind": "step", "step": "malformed", "step_time_ms": "x"},
]


def populate(reg, offset=0.0):
    for name, labels, amount in (("requests", None, 3), ("bytes", {"op": "all_reduce"}, 512),
                                 ("bytes", {"op": "all_gather"}, 1024)):
        reg.counter(name, labels, help="h").inc(amount + offset)
    reg.gauge("queue").set(4.5 + offset)
    reg.gauge("lazy", fn=lambda: 7.0)
    reg.gauge("broken", fn=lambda: 1 / 0)
    h = reg.histogram("latency_ms")
    for v in (0.25, 1.0, 2.5, 7.0, 40.0, 250.0, 65536.0):    # exact in fp32 (JAX's fold)
        h.observe(v + offset)
    reg.histogram("skew_ms", {"op": "x"}, bounds=(1.0, 5.0, 2.0)).observe(3.0)
    return reg


def scenario_events(pkg):
    ev = pkg.events
    return (ev.SCHEMA_VERSION, ev.KINDS, ev.STEP_REQUIRED_FIELDS,
            ev.make_record("step", {"kind": "x", "schema": 9, "loss": 1.0}))


def scenario_stats(pkg):
    st = pkg.stats
    bounds = (1.0, 2.0, 5.0, 10.0)
    counts = [3, 0, 4, 1, 2]
    return ([st.percentile(sorted([5.0, 1.0, 3.0, 9.0]), q) for q in (0, 50, 90, 100)],
            [st.bucket_index(bounds, v) for v in (0.5, 1.0, 1.5, 10.0, 11.0)],
            st.merge_bucket_counts(counts, [1, 1, 1, 1, 1]),
            [st.quantile_from_buckets(bounds, counts, q) for q in (0.0, 0.5, 0.9, 0.99, 1.0)],
            st.DEFAULT_MS_BUCKETS)


def scenario_metrics(pkg):
    m = pkg.metrics
    a, b = populate(m.MetricsRegistry()), populate(m.MetricsRegistry(), offset=1.0)
    snaps = [a.snapshot(), b.snapshot()]
    merged = m.merge_snapshots(snaps)
    schema, vec = m.pack_snapshot(snaps[0])
    sink = m.MetricsSink(m.MetricsRegistry())
    sink.write(copy.deepcopy(SINK_RECORDS))
    replay = m.replay_jsonl(m.MetricsRegistry(), copy.deepcopy(SINK_RECORDS))
    return (m.render_prometheus(snaps[0]), m.render_prometheus(merged, merged=True),
            merged, vec, m.snapshot_from_vector(schema, vec),
            m.render_prometheus(sink.registry.snapshot(), prefix="x_"),
            m.render_prometheus(replay.snapshot()), m.dumps_snapshot(snaps[1]))


def scenario_histogram(pkg):
    h = pkg.metrics.Histogram("h", bounds=(1.0, 5.0, 10.0, 50.0))
    out = [h.quantile(0.5)]
    for v in (0.5, 2.0, 2.0, 6.0, 7.0, 20.0, 60.0, 45.0):
        h.observe(v)
        out.append([h.quantile(q) for q in (0.5, 0.9, 0.95, 0.99)])
    return out, h.count, h.sum, h.bounds


def scenario_slo(pkg):
    s, m = pkg.slo, pkg.metrics
    reg, hub, clock = m.MetricsRegistry(), Events(), Clock(0.0)
    rules = s.rules_from_config([
        {"name": "ttft", "metric": "serve_ttft_ms", "op": "p99", "bound": 100.0,
         "min_samples": 2, "fast_window_s": 20.0, "slow_window_s": 60.0},
        {"name": "stall", "metric": "counter:offload_stall_ms_total", "op": "ratio",
         "bound": 0.1, "den": "sum:train_step_time_ms", "min_samples": 2},
        {"name": "queue", "metric": "gauge:serve_queue_depth", "op": "value", "bound": 4.0,
         "cmp": "le", "min_samples": 1, "budget_frac": 0.5}]) + s.default_rules()
    mon = s.SLOMonitor(rules, registry=reg, telemetry=hub, clock=clock)
    out = []
    ttft, step_ms = reg.histogram("serve_ttft_ms"), reg.histogram("train_step_time_ms")
    for i in range(30):
        ttft.observe(50.0 if i < 8 or i > 20 else 500.0 + i)
        step_ms.observe(10.0 if i < 22 else 40.0)
        reg.counter("offload_stall_ms_total").inc(0.5 if i < 10 else 3.0)
        reg.gauge("serve_queue_depth").set(i % 7)
        out.append(mon.evaluate())
        out.append(mon.state_for_metric("serve_ttft_ms"))
        clock.advance(5.0)
    out.append(mon.verdict())
    return out, hub.events, [r.to_dict() for r in rules]


def scenario_ledger(pkg):
    lg, m = pkg.ledger, pkg.metrics
    out = []
    for mode in ("train", "serve"):
        clock, reg = Clock(), m.MetricsRegistry()
        led = lg.GoodputLedger(mode=mode, registry=reg, clock=clock, hang_threshold_s=5.0,
                               flops_per_step=lambda: 2e12, peak_flops_per_s=1e15, run_id="r")
        for step in range(1, 9):
            clock.advance(1.0 + 0.25 * step)
            if step == 3:
                led.note_ckpt_stall(0.5)
            if step == 5:
                led.on_rollback(5, 2)
            if step == 6:
                led.note_comm_recovery(0.4)
                led.note_straggler_share(0.1)
            led.on_step(step, offload_wait_s=0.1 * (step % 3), exposed_comm_s=0.05,
                        quarantine_frac=0.25 if step == 4 else 0.0)
            if mode == "serve":
                led.note_serve_request("standard" if step % 2 else "interactive",
                                       300.0 * step, 16)
                led.note_wasted_prefill("batch", 12)
                led.note_serve_expired("batch", 4)
        clock.advance(2.0)
        led.note_downtime(1.5)
        led.note_hang(0.75)
        led.note_quarantine_skip(0.2)
        snap = led.snapshot()
        snap.pop("start_unix")
        out.append((snap, m.render_prometheus(reg.snapshot()), led.conservation()))
    records = [pkg.events.make_record("goodput", dict(out[0][0], start_unix=1.0)),
               pkg.events.make_record("goodput", dict(out[1][0], run_id="s", start_unix=2.0))]
    out.append(lg.fold_goodput(records))
    out.append((lg.CATEGORIES, lg.DEFAULT_SLO_TTFT_BOUNDS_MS))
    return out


def scenario_tracer(pkg):
    tr_mod = pkg.tracing
    clock = Clock(1.0, ns=True)
    beats = []
    tr = tr_mod.Tracer(rank=2, capacity=8, clock=clock, heartbeat=lambda: beats.append(1))
    open_seen = []
    with tr.span("train_batch", step=1, gas=2):
        clock.advance(0.001)
        with tr.span("comm.all_reduce", op="all_reduce", bytes=64, seq=1):
            clock.advance(0.002)
            open_seen = [(r["name"], r["depth"]) for r in tr.open_spans()]
        tr.instant("marker", why="x")
    tr.add_span("zero3.block", 10, 20, track="zero3.compute", kind="compute", block=0)
    tr_mod.emit_zero3_schedule(tr, 0, 10_000, n_blocks=3, layered=True, depth=1, offload=True)
    tr_mod.emit_zero3_schedule(tr, 0, 10_000, n_blocks=2, layered=False)
    tr_mod.set_global_tracer(tr)
    with tr_mod.maybe_span("checkpoint.save", tag="t"):
        pass
    glob = tr_mod.get_global_tracer() is tr
    tr_mod.set_global_tracer(None)
    with tr_mod.maybe_span("ignored"):
        pass
    events = [{k: v for k, v in e.items() if k not in ("ts", "dur")}
              for e in tr.to_chrome_events()]
    return events, tr.dropped, open_seen, len(beats), glob


def scenario_profiler(pkg):
    calls = []

    def run(start, end, max_steps=64):
        win = pkg.profiler.ProfilerWindow(start, end, "/nowhere", max_window_steps=max_steps,
                                          start_fn=lambda d: calls.append(("start", d)),
                                          stop_fn=lambda: calls.append(("stop",)))
        states = []
        for step in range(12):
            win.step_begin(step)
            states.append(win.state)
            win.step_end(step + 1)
            states.append(win.state)
        win.close()
        return states + [win.end_step, win.state]
    return run(3, 5), run(2, 100, max_steps=4), run(20, 30), calls


def collective_views():
    """Two ranks' window views: rank 1 arrives late on every seq and
    stages a different collective at seq 4."""
    views = []
    for rank in (0, 1):
        recs = []
        for seq in range(1, 7):
            op = "all_gather" if (rank == 1 and seq == 4) else "all_reduce"
            shape = [8, 4] if seq % 2 else [16]
            fp = jcm.fingerprint_of(op, "world", "float32", shape)
            t = 1_700_000_000_000_000 + seq * 1000 + rank * (150 + 40 * seq)
            recs.append({"seq": seq, "op": op, "axis": "world", "dtype": "float32",
                         "shape": shape, "bytes": 128 * seq, "fp": fp, "t_enter_us": t,
                         "t_exit_us": None if seq == 6 else t + 20})
        views.append({"schema": 1, "rank": rank, "records": recs})
    return views


def scenario_collective(pkg):
    cm = pkg.cm
    views = collective_views()
    health = cm.fold_windows(copy.deepcopy(views))
    later = cm.fold_windows(copy.deepcopy(views), new_after=3)
    recs = [pkg.events.make_record("collective_window", dict(v, step=1)) for v in views]
    offline = cm.fold_window_records(copy.deepcopy(recs))
    base = min(r["t_enter_us"] for v in views for r in v["records"])
    packed = [cm.pack_window(v, base, 8) for v in views]
    unpacked = [cm.unpack_window(vec, meta, v["rank"], base)
                for (meta, vec), v in zip(packed, views)]
    reg = pkg.metrics.MetricsRegistry()
    cm.feed_registry(reg, health)
    clock = Clock(0.0, ns=True)
    mon = cm.CollectiveMonitor(rank=1, capacity=4, clock_ns=clock)
    mon._anchor_unix_us, mon._anchor_mono_ns = 1_000_000, 0
    for i in range(6):
        rec = mon.begin("all_reduce", "world", "float32", (i + 1,), 4 * (i + 1))
        clock.advance(0.001)
        if i < 5:
            mon.end(rec)
    return (health, later, offline, packed, unpacked,
            pkg.metrics.render_prometheus(reg.snapshot()), mon.window_view(),
            mon.last_records(2), mon.wedged_summary(), mon.seq)


def scenario_cross_rank_fold(pkg):
    snaps = [populate(pkg.metrics.MetricsRegistry(), offset=o).snapshot() for o in (0.0, 2.0)]
    reg = pkg.metrics.MetricsRegistry()
    merged = pkg.metrics.cross_rank_snapshot(reg, per_rank_snapshots=snaps)
    return merged, reg.pod_snapshot == merged, pkg.metrics.render_prometheus(merged, merged=True)


def scenario_jsonl_rotation(pkg):
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t.jsonl")
        sink = pkg.hub.JsonlSink(path, max_bytes=300, keep=2)
        for i in range(12):
            sink.write([pkg.events.make_record("step", {"step": i, "loss": float(i)})])
        sink.close()
        names = sorted(os.path.basename(p) for p in pkg.stats.rotated_set(path))
        records, err = pkg.stats.load_records(path)
    return names, err, [{k: v for k, v in r.items() if k != "created_unix"} for r in records]


SCENARIOS = {f.__name__.removeprefix("scenario_"): f for f in (
    scenario_events, scenario_stats, scenario_metrics, scenario_histogram, scenario_slo,
    scenario_ledger, scenario_tracer, scenario_profiler, scenario_collective,
    scenario_cross_rank_fold, scenario_jsonl_rotation)}


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_module_matches_jax(case):
    want = SCENARIOS[case](JAX)
    got = SCENARIOS[case](PORT)
    assert got == want


def test_package_exports_jax_all():
    import deepspeed_tpu.telemetry as jt
    import deepspeed_tpu_torch.telemetry as tt
    assert tt.__all__ == jt.__all__
    for name in tt.__all__:
        assert hasattr(tt, name), name


# --------------------------------------------------------------------------- #
# the hub: one drain a window, device tensors, memory stats
# --------------------------------------------------------------------------- #
def test_hub_drains_buffered_tensors_once_a_window(monkeypatch):
    syncs = []
    ring = thub.RingBufferSink(64)
    hub = thub.TelemetryHub(sinks=[ring], flush_every=4, batch_size=8,
                            sync_fn=lambda: syncs.append(1))
    losses = [torch.tensor(1.0 + i / 3, dtype=torch.float32) for i in range(4)]
    extras = {"bf16": torch.tensor(0.3125, dtype=torch.bfloat16),
              "count": torch.tensor(7, dtype=torch.int64), "flag": torch.tensor(True),
              "vec": torch.arange(3, dtype=torch.float32) / 4}
    cpu_calls = []
    real_cpu = torch.Tensor.cpu

    def counting_cpu(self, *a, **kw):
        cpu_calls.append(tuple(self.shape))
        return real_cpu(self, *a, **kw)

    def no_item(self):
        raise AssertionError("the drain read a tensor with .item()")
    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    monkeypatch.setattr(torch.Tensor, "item", no_item)
    for i, loss in enumerate(losses[:3]):
        hub.record_step(i + 1, loss=loss, grad_norm=loss * 2, **extras)
    hub.emit("moe_gauge", {"expert_load": torch.ones(4) / 4}, step=3)
    assert not syncs and not cpu_calls and len(ring.records) == 0
    hub.record_step(4, loss=losses[3], grad_norm=losses[3] * 2, **extras)   # flush_every
    assert syncs == [1] and len(cpu_calls) == 1            # one device here: one copy
    monkeypatch.undo()
    steps = ring.of_kind("step")
    assert [r["loss"] for r in steps] == [float(v) for v in losses]
    assert [r["grad_norm"] for r in steps] == [float(v * 2) for v in losses]
    first = steps[0]
    assert first["bf16"] == 0.3125 and first["count"] == 7 and first["flag"] is True
    assert first["vec"] == [0.0, 0.25, 0.5]
    assert ring.last("moe_gauge")["expert_load"] == [0.25] * 4
    for field in jevents.STEP_REQUIRED_FIELDS:
        assert field in first
    hub.emit("anomaly", {"cause": "x"})
    hub.flush()
    assert syncs == [1], "a window of host records takes no sync"
    hub.close()


def test_hub_memory_stats_use_jax_key_names(monkeypatch):
    assert thub.device_memory_stats("cpu") == {} and thub.device_memory_stats(None) == {}
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d: {
        "allocated_bytes.all.current": 10, "allocated_bytes.all.peak": 30})
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(total_memory=80))
    assert thub.device_memory_stats("cuda:0") == {
        "bytes_in_use": 10, "peak_bytes_in_use": 30, "bytes_limit": 80}
    ring = thub.RingBufferSink()
    hub = thub.TelemetryHub(sinks=[ring], flush_every=1, device="cuda:0",
                            sync_fn=lambda: None)
    hub.record_step(1, loss=1.0)
    assert ring.last("step")["device_peak_bytes"] == 30


# --------------------------------------------------------------------------- #
# flight recorder, watchdog
# --------------------------------------------------------------------------- #
def test_dump_never_reads_a_tensor_and_jax_reads_the_dump(tmp_path, monkeypatch):
    hub = thub.TelemetryHub(sinks=[thub.RingBufferSink()], flush_every=0)
    hub.record_step(1, loss=torch.ones((), dtype=torch.bfloat16), lr=1e-3,
                    vec=torch.zeros(2, 3))
    tracer = ttracing.Tracer(rank=0)
    rec = tfr.FlightRecorder(str(tmp_path), rank=0, hub=hub, tracer=tracer)
    for name in ("cpu", "item", "tolist", "numpy", "__float__", "__array__"):
        monkeypatch.setattr(torch.Tensor, name, lambda self, *a, **k: pytest.fail(
            "the dump read a tensor"), raising=False)
    with tracer.span("train_batch", step=1, loss=torch.ones(3)):
        path = rec.dump(reason="manual")
    monkeypatch.undo()
    sections = jfr.read_dump(path)
    assert sections["header"][0]["reason"] == "manual"
    assert sections["end"] == [{"complete": True}]
    (pending,) = sections["pending_records"]
    assert pending[0]["loss"] == "<unforced Tensor bfloat16[] on cpu>"
    assert pending[0]["vec"] == "<unforced Tensor float32[2, 3] on cpu>"
    (open_spans,) = sections["open_spans"]
    assert [s["name"] for s in open_spans] == ["train_batch"]
    assert open_spans[0]["args"]["loss"] == "<unforced Tensor float32[3] on cpu>"
    assert any(t["stack"] for t in sections["thread_stacks"][0])


def test_watchdog_stall_dumps_the_open_span(tmp_path):
    tracer = ttracing.Tracer(rank=0)
    dog = twatchdog.HangWatchdog(timeout_s=0.2, poll_s=0.05)
    tracer.heartbeat = dog.pet
    rec = tfr.FlightRecorder(str(tmp_path), tracer=tracer)
    dumps = []
    dog.on_stall = lambda *a: dumps.append(rec.on_stall(*a))
    dog.start()
    try:
        dog.arm("train_batch step=3")
        with tracer.span("train_batch", step=3):
            deadline = time.monotonic() + 10
            while not dumps and time.monotonic() < deadline:
                time.sleep(0.02)
    finally:
        dog.stop()
    assert dumps, "the watchdog did not fire"
    sections = jfr.read_dump(dumps[0])
    assert sections["header"][0]["reason"] == "stall:train_batch step=3"
    assert [s["name"] for s in sections["open_spans"][0]] == ["train_batch"]


# --------------------------------------------------------------------------- #
# the ops server
# --------------------------------------------------------------------------- #
def http(url, method="GET"):
    req = urllib.request.Request(url, method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_ops_server_endpoints_match_jax(tmp_path):
    bodies = {}
    for name, pkg, obs in (("jax", JAX, jobs), ("port", PORT, tobs)):
        reg = populate(pkg.metrics.MetricsRegistry())
        clock = Clock(0.0)
        mon = pkg.slo.SLOMonitor([pkg.slo.SLORule("q", "gauge:queue", "value", 1.0,
                                                  min_samples=1)], registry=reg, clock=clock)
        mon.evaluate()
        srv = obs.ObsServer(reg, port=0, slo_monitor=mon)
        srv.add_health_check("ok", lambda: {"ok": True, "n": 1})
        srv.start()
        try:
            got = {p: http(srv.url + p) for p in ("/metrics", "/slo", "/healthz", "/goodput",
                                                  "/collectives", "/recovery", "/nope")}
            srv.add_health_check("bad", lambda: {"ok": False})
            got["/healthz bad"] = http(srv.url + "/healthz")
            got["/debug/dump"] = http(srv.url + "/debug/dump", method="POST")[0]
            if name == "port":
                srv.flight_recorder = tfr.FlightRecorder(str(tmp_path))
                code, body = http(srv.url + "/debug/dump", method="POST")
                assert code == 200 and Path(json.loads(body)["path"]).is_file()
        finally:
            thread = srv._thread
            srv.stop()
        assert thread is None or not thread.is_alive(), "stop() joins the server thread"
        bodies[name] = got
    assert bodies["port"] == bodies["jax"]
    assert bodies["port"]["/metrics"][0] == 200 and bodies["port"]["/slo"][0] == 503
    assert bodies["port"]["/healthz bad"][0] == 503


# --------------------------------------------------------------------------- #
# the profiler window and the span annotation
# --------------------------------------------------------------------------- #
def test_profiler_window_writes_a_chrome_trace_naming_spans(tmp_path):
    win = tprofiler.ProfilerWindow(1, 3, str(tmp_path / "prof"))
    tracer = ttracing.Tracer(rank=0)
    x = torch.randn(64, 64)
    for step in range(5):
        win.step_begin(step)
        with tracer.span("train_batch", step=step):
            (x @ x).sum()
        win.step_end(step + 1)
    assert win.state == "done"
    doc = json.loads(Path(win.trace_path).read_text())
    names = [e.get("name") for e in doc["traceEvents"]]
    assert names.count("train_batch") == 2            # steps 1 and 2, inside the window
    assert any("mm" in str(n) for n in names)
    tprofiler.ProfilerWindow(0, 1, str(tmp_path / "never")).close()
    assert not (tmp_path / "never").exists()


def test_profiler_window_from_config_keeps_the_guard():
    from deepspeed_tpu.runtime.config import DeepSpeedTelemetryConfig as JCfg
    from deepspeed_tpu_torch.runtime.config import DeepSpeedTelemetryConfig as TCfg
    for kw in ({}, {"profiler_start_step": 5}, {"profiler_start_step": 2,
                                                 "profiler_end_step": 200,
                                                 "profiler_max_window_steps": 8},
               {"profiler_start_step": 4, "profiler_end_step": 3}):
        j = jprofiler.ProfilerWindow.from_config(JCfg(**kw))
        t = tprofiler.ProfilerWindow.from_config(TCfg(**kw))
        assert (j is None) == (t is None)
        if j is not None:
            assert (t.start_step, t.end_step) == (j.start_step, j.end_step)


# --------------------------------------------------------------------------- #
# formats: the repo's readers take the port's files
# --------------------------------------------------------------------------- #
def load_tool(name):
    spec = importlib.util.spec_from_file_location(f"_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_run_files(tmp_path):
    """A hub with a ledger writing JSONL and EFFICIENCY.json from device
    tensors, and two ranks' span traces."""
    jsonl = str(tmp_path / "telemetry.jsonl")
    hub = thub.TelemetryHub(sinks=[thub.JsonlSink(jsonl)], flush_every=3, batch_size=4)
    hub.ledger = tledger.GoodputLedger()
    hub.efficiency_json_path = str(tmp_path / "EFFICIENCY.json")
    for step in range(1, 8):
        hub.record_step(step, loss=torch.tensor(3.0 - step / 10), lr=1e-3,
                        grad_norm=torch.tensor(0.5), global_samples=4 * step)
        hub.ledger.on_step(step)
    hub.close()
    traces = []
    for rank in (0, 1):
        tr = ttracing.Tracer(rank=rank)
        with tr.span("train_batch", step=1):
            with tr.span("comm.all_reduce", op="all_reduce", bytes=64, seq=1):
                pass
        traces.append(tr.export_chrome_trace(str(tmp_path / f"trace_rank{rank}.json")))
    return jsonl, hub.efficiency_json_path, traces


def test_repo_readers_take_the_port_files(tmp_path):
    jsonl, efficiency, traces = port_run_files(tmp_path)
    folded = fold_file(jsonl, label="port", skip_steps=1)
    assert folded["train"]["steps"] == 7 and folded["train"]["loss"] == pytest.approx(2.3)
    merged = tmp_path / "merged.json"
    assert load_tool("trace_merge").main([*traces, "-o", str(merged)]) == 0
    doc = json.loads(merged.read_text())
    assert {e.get("pid") for e in doc["traceEvents"] if e.get("ph") == "X"} == {0, 1}
    assert load_tool("telemetry_report").main([jsonl, "-o", str(tmp_path / "r.json")]) == 0
    for path in (efficiency, jsonl):
        out = tmp_path / "goodput.json"
        assert load_tool("goodput_report").main([path, "--json", str(out)]) == 0
        report = json.loads(out.read_text())
        assert report["ok"] and report["steps"] == 7
