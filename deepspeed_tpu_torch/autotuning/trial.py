"""Default trial runner: one short profiled run of a candidate config
(counterpart of ``deepspeed_tpu/autotuning/trial.py``, the same workload
and outputs).

Launched by :class:`~deepspeed_tpu_torch.autotuning.scheduler.TrialScheduler`
as ``python -m deepspeed_tpu_torch.autotuning.trial [--device cpu]``; the
candidate's full ds_config arrives via ``DS_AUTOTUNING_CONFIG`` (or as the
first argument) with telemetry forced on, so the engine's close drops the
``EFFICIENCY.json`` the loop scores.  The workload is deliberately tiny and
synthetic — the trial exists to exercise the CONFIG under the goodput
ledger, not to converge a model:

* ``autotuning.trial.steps`` optimizer steps (default 6) of
  :class:`~deepspeed_tpu_torch.models.simple.SimpleModel` with
  ``autotuning.trial.hidden_dim`` (default 64), through ``forward`` /
  ``backward`` / ``step`` (the fused AdamW kernel on the card);
* deterministic data (seeded numpy) so two trials differ only by their
  config;
* the inherited ``DS_FAULT_PLAN`` fires inside the engine exactly as in
  production — a plan that wedges the step leaves the trial hung for the
  scheduler's watchdog to reap.

It runs on the card unless ``--device cpu`` is given: a trial that cannot
reach the card fails, it does not fall back to the CPU.  The seed-era
``DS_AUTOTUNING_METRIC_PATH`` contract is honored too: the runner drops a
``metrics.json`` with raw throughput, and prints one ``TRIAL_DONE`` line.
"""

import argparse
import json
import os
import sys
import time


def run_trial(config: dict, device=None) -> dict:
    import numpy as np
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.simple import SimpleModel

    trial_cfg = dict((config.get("autotuning") or {}).get("trial") or {})
    steps = int(trial_cfg.get("steps", 6))
    hidden = int(trial_cfg.get("hidden_dim", 64))
    seed = int(trial_cfg.get("seed", 0))

    cfg = json.loads(json.dumps(config))
    # the candidate patch sets the micro-batch; the global batch is then
    # derived from the live world size, so a stale train_batch_size from
    # the base config must not conflict
    if "train_micro_batch_size_per_gpu" in cfg:
        cfg.pop("train_batch_size", None)
    cfg.setdefault("optimizer", {"type": "Adam", "params": {"lr": 1e-3}})

    model = SimpleModel(hidden_dim=hidden, device=device, seed=seed)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg, device=device,
                                                seed=seed)

    gas = engine.gradient_accumulation_steps()
    rows = max(engine.train_batch_size() // max(gas, 1), 1)
    rng = np.random.default_rng(seed)
    data = [(rng.standard_normal((rows, hidden)).astype(np.float32),
             np.zeros((rows,), np.int32)) for _ in range(4)]

    t0 = time.monotonic()
    while engine.global_steps < steps:
        x, y = data[engine.micro_steps % len(data)]
        loss = engine.forward(x, y)
        engine.backward(loss)
        engine.step()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    wall = time.monotonic() - t0
    engine.close()

    samples = engine.global_samples
    return {"throughput": (samples / wall) if wall > 0 else 0.0,
            "steps": engine.global_steps, "wall_s": wall}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m deepspeed_tpu_torch.autotuning.trial")
    parser.add_argument("config", nargs="?", default=None,
                        help="the trial's ds_config (default: $DS_AUTOTUNING_CONFIG)")
    parser.add_argument("--device", default=None,
                        help="'cpu' to run on the CPU; default the current CUDA device")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    cfg_path = args.config or os.environ.get("DS_AUTOTUNING_CONFIG")
    if not cfg_path:
        print("trial: no config (pass a path or set DS_AUTOTUNING_CONFIG)",
              file=sys.stderr)
        return 2
    with open(cfg_path) as f:
        config = json.load(f)
    metrics = run_trial(config, device=args.device)
    metric_path = os.environ.get("DS_AUTOTUNING_METRIC_PATH")
    if metric_path:
        from deepspeed_tpu_torch.autotuning.scheduler import write_metrics
        write_metrics(metric_path, metrics)
    print("TRIAL_DONE " + json.dumps(metrics), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
