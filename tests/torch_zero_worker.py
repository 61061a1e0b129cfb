"""One rank of the port's data-parallel CPU runs in ``tests/test_torch_zero.py``
(``run``) and of the cross-rank telemetry case of
``tests/test_torch_telemetry_engines.py`` (``run_telemetry``).

``run(rank, world, port, spec_path, out_dir)`` joins a gloo process group
through ``env://`` on ``127.0.0.1:port`` and, for each configuration of
the spec, trains a GPT from the spec's parameters on its rows of the
spec's global batches; rank 0 writes what it saw to ``out_dir``.  It
imports no JAX, so a spawned rank starts quickly.
"""

import os
import traceback

import torch


def _train(dst, spec, cfg, rank, world, eager=False):
    from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig
    model = GPT(GPTConfig(dtype="float32", **spec["dims"]), device="cpu")
    engine = dst.initialize(model=model, config=cfg, model_parameters=spec["params"],
                            device="cpu")[0]
    micro = cfg["train_micro_batch_size_per_gpu"]
    rows = slice(rank * micro, (rank + 1) * micro)
    losses, norms = [], []
    for ids, labels in spec["batches"]:
        ids, labels = ids[:, rows], labels[:, rows]
        if eager:
            for i in range(ids.shape[0]):
                engine.backward(engine.forward(ids[i], labels[i]))
                engine.step()
            norms.append(engine.get_global_grad_norm())
            continue
        losses.append(float(engine.train_batch(batch=(ids, labels))))
        norms.append(engine.get_global_grad_norm())
    return engine, losses, norms


def run(rank: int, world: int, port: int, spec_path: str, out_dir: str) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    try:
        import deepspeed_tpu_torch as dst
        from deepspeed_tpu_torch import comm
        spec = torch.load(spec_path, weights_only=True)
        for name, cfg in spec["configs"].items():
            engine, losses, norms = _train(dst, spec, cfg, rank, world)
            params = engine.get_fp32_params()
            opt = engine.optimizer.state_dict()
            if name == spec["checkpoint"]:
                engine.save_checkpoint(os.path.join(out_dir, "ckpt"))
            if rank == 0:
                torch.save({"losses": losses, "norms": norms, "params": params,
                            "mu": opt["mu"], "nu": opt["nu"], "count": int(opt["count"]),
                            "stage": engine.zero_optimization_stage(),
                            "world": engine.world_size, "pinned": engine.pinned_bytes()},
                           os.path.join(out_dir, f"{name}.pt"))
            engine.close()
        engine, _, norms = _train(dst, spec, spec["configs"][spec["eager"]], rank, world,
                                  eager=True)
        params = engine.get_fp32_params()
        if rank == 0:
            torch.save({"params": params, "norms": norms}, os.path.join(out_dir, "eager.pt"))
        engine.close()
        comm.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_telemetry(rank: int, world: int, port: int, out_dir: str) -> None:
    """One rank of ``tests/test_torch_telemetry_engines.py``'s cross-rank
    case: with the telemetry plane wired into ``comm/`` (a registry, a
    collective monitor, a global tracer), the four tensor collectives, then
    the cross-rank metrics fold and the collective monitor's gather over
    the gloo group; each rank writes what it saw to ``out_dir``."""
    import json
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    try:
        from deepspeed_tpu_torch import comm
        from deepspeed_tpu_torch.telemetry import collective_monitor as cm
        from deepspeed_tpu_torch.telemetry import metrics, tracing
        from deepspeed_tpu_torch.telemetry.hub import RingBufferSink, TelemetryHub
        comm.init_distributed(device="cpu")
        reg = metrics.MetricsRegistry()
        mon = cm.CollectiveMonitor(rank=rank, capacity=16)
        tracer = tracing.Tracer(rank=rank)
        comm.configure_metrics_registry(reg)
        comm.configure_collective_monitor(mon)
        tracing.set_global_tracer(tracer)
        x = torch.arange(8, dtype=torch.float32) + 10 * rank
        comm.all_reduce(x.clone())
        comm.all_gather(torch.empty(8 * world), x)
        comm.reduce_scatter(torch.empty(8 // world), x.clone())
        comm.broadcast(x.clone(), src=0)
        comm.configure_metrics_registry(None)
        comm.configure_collective_monitor(None)
        tracing.set_global_tracer(None)
        # rank-dependent series beside the comm counters
        reg.counter("requests").inc(3 + rank)
        reg.gauge("queue").set(2.5 * (rank + 1))
        for v in (0.5 + rank, 20.0, 300.0 * (rank + 1)):
            reg.histogram("latency_ms").observe(v)
        own = reg.snapshot()
        merged = metrics.cross_rank_snapshot(reg)
        view = mon.window_view()
        gathered = cm.gather_windows_over_group(view)
        hub = TelemetryHub(sinks=[RingBufferSink()], flush_every=0)
        hub.collective_monitor = mon
        health = hub.collective_fold(step=1)
        with open(os.path.join(out_dir, f"telemetry{rank}.json"), "w") as f:
            json.dump({"own": own, "merged": merged, "view": view, "gathered": gathered,
                       "health": health,
                       "spans": [(s["name"], s["args"]) for s in tracer.snapshot()]}, f)
        comm.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
