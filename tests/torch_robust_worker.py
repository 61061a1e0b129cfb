"""One rank of the port's robustness tests, run as a process of its own
(``python tests/torch_robust_worker.py '<json>'``) with ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` set by the test or by
the port's launcher.  It imports no JAX.

Modes (``"mode"`` of the JSON argument):

* ``train``: a tiny GPT on the CPU through ``initialize()`` ->
  ``train_batch(data_iter=...)`` to ``steps``, each rank taking its rows of
  a global batch seeded by the step (so a run that rewinds to a
  checkpoint, or that changes its world size, draws the right data), an
  optional checkpoint at ``save_step`` and an optional ``load_dir`` to
  start from; prints one ``RESULT`` JSON line (final step and loss, the
  recovery status, the ledger's ``comm_recovery``, the fingerprint of the
  parameters).
"""

import hashlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY = dict(vocab_size=300, n_positions=64, n_embd=32, n_layer=2, n_head=4)
GLOBAL_BATCH, SEQ = 8, 16


def params_digest(engine) -> str:
    h = hashlib.sha256()
    for name, t in sorted(engine.get_fp32_params().items()):
        h.update(name.encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def main() -> int:
    cfgv = json.loads(sys.argv[1])
    import torch
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig

    torch.set_num_threads(1)
    model = GPT(GPTConfig(dtype="float32", **TINY), device="cpu", seed=0)
    config = {"train_batch_size": GLOBAL_BATCH, "steps_per_print": 10 ** 9,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
              "gradient_clipping": 1.0,
              "zero_optimization": {"stage": int(cfgv.get("stage", 1))}}
    config.update(cfgv.get("config", {}))
    engine = dst.initialize(model=model, device="cpu", config=config, seed=0)[0]
    if cfgv.get("load_dir"):
        engine.load_checkpoint(cfgv["load_dir"])
    if cfgv.get("plan"):
        from deepspeed_tpu_torch.testing import fault_injection as fi
        fi.install_plan(cfgv["plan"])

    def batches():
        # step-keyed: after a rewind the engine draws the rewound step's rows
        while True:
            rng = np.random.default_rng(1000 + engine.global_steps)
            ids = rng.integers(0, TINY["vocab_size"], (GLOBAL_BATCH, SEQ)).astype(np.int32)
            micro = engine.train_micro_batch_size_per_gpu()
            rows = slice(engine.rank * micro, (engine.rank + 1) * micro)
            yield ids[rows], np.roll(ids, -1, axis=-1)[rows]

    it = batches()
    loss = None
    losses = []
    while engine.global_steps < int(cfgv["steps"]):
        loss = engine.train_batch(data_iter=it)
        losses.append(float(loss))
        if engine.global_steps == int(cfgv.get("save_step", 0)) and cfgv.get("ckpt_dir"):
            engine.save_checkpoint(cfgv["ckpt_dir"])
        if cfgv.get("step_sleep"):
            # paces the run, so that a rank killed at a step boundary is dead
            # before its peers reach the next one (the liveness probe, not a
            # half-run collective, then opens the incident)
            time.sleep(float(cfgv["step_sleep"]))
    led = engine.telemetry.ledger if engine.telemetry is not None else None
    result = {
        "rank": engine.rank, "world": engine.world_size, "final_step": engine.global_steps,
        "final_loss": float(loss), "losses": losses, "digest": params_digest(engine),
        "skipped": engine.skipped_steps,
        "status": engine.recovery_manager.status() if engine.recovery_manager else None,
        "comm_recovery_s": (led.snapshot()["categories"].get("comm_recovery", 0.0)
                            if led is not None else None),
    }
    engine.close()
    print("RESULT " + json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
