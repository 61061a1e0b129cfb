"""A user training script for the port's autotuner, run as a process of its
own:

    python tests/torch_autotune_worker.py [--deepspeed_config CFG] [--device cpu]
        [--preset gpt2|tiny] [--steps 6]

It builds a GPT (``--preset gpt2``: ``gpt_config("gpt2")`` at seq 512, vocab
padded to 50304, bf16, remat; ``tiny``: the CPU tests' tiny GPT at seq 16,
fp32) from seed 0, trains it through ``initialize()`` -> ``train_batch`` on
seeded numpy tokens for ``--steps`` steps and closes the engine.  The
ds_config is ``--deepspeed_config``, or ``$DS_AUTOTUNING_CONFIG`` when the
closed loop's scheduler runs it with no arguments; under the launcher's
``--autotuning`` ``initialize`` replaces it with the experiment's own.

It imports no JAX.  It prints one ``WORKER`` JSON line: the engine's micro
batch, GAS and ZeRO stage, the process age at its imports, at the engine and
at the end of the first step (``startup_s``), the mean step ms of the
steps after the second (timed as one block), their samples/s, the engine's
own throughput, the last loss, and the launches of every kernel with the
plain versions' calls, beside the launches the path must make.  With
``$DS_AUTOTUNING_METRIC_PATH`` set the same document goes to
``launches.json`` beside the metrics file.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY = dict(vocab_size=300, n_positions=64, n_embd=32, n_layer=2, n_head=4)
SEQ = {"gpt2": 512, "tiny": 16}


def process_age() -> float:
    """Seconds since this process started (/proc/self/stat's start time)."""
    ticks = os.sysconf("SC_CLK_TCK")
    start = int(open("/proc/self/stat").read().rsplit(")", 1)[1].split()[19]) / ticks
    return float(open("/proc/uptime").read().split()[0]) - start


def kernel_counts():
    """(launches by kernel, calls by plain version) of the training path's
    kernels: flash attention, the fused cross-entropy and AdamW."""
    from deepspeed_tpu_torch.ops.cuda import cross_entropy as tce
    from deepspeed_tpu_torch.ops.cuda import flash_attention as tfa
    from deepspeed_tpu_torch.ops.cuda import fused_optim as tfo
    launches = {fn.__name__: fn.launches for fn in (
        tfa.flash_forward, tfa.flash_backward_dq, tfa.flash_backward_dkv, tce.ce_forward,
        tce.ce_backward_dx, tce.ce_backward_dhead, tfo.fused_adam)}
    plain = {fn.__name__: fn.calls for fn in (
        tfa.flash_forward_reference, tfa.flash_backward_dq_reference,
        tfa.flash_backward_dkv_reference, tce.ce_forward_reference,
        tce.ce_backward_dx_reference, tce.ce_backward_dhead_reference, tfo.adam_reference)}
    return launches, plain


def expected_launches(engine, cfg, seq: int, steps: int):
    """The launches ``steps`` graphed steps make on the card: each flash
    kernel once per layer per micro-step (above 256 tokens), each
    cross-entropy kernel once per micro-step, AdamW once per step (or once
    per chunk of offloaded state)."""
    from deepspeed_tpu_torch.ops.attention import XLA_FUSED_MAX_SEQ
    micro = steps * engine.gradient_accumulation_steps()
    want = {"ce_forward": micro, "ce_backward_dx": micro, "ce_backward_dhead": micro,
            "fused_adam": steps * len(getattr(engine.optimizer, "chunks", [None]))}
    flash = micro * cfg.n_layer if seq > XLA_FUSED_MAX_SEQ else 0
    want.update(flash_forward=flash, flash_backward_dq=flash, flash_backward_dkv=flash)
    return want


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--deepspeed_config", default=None)
    parser.add_argument("--device", default=None)
    parser.add_argument("--preset", default="gpt2", choices=sorted(SEQ))
    parser.add_argument("--steps", type=int, default=6)
    args = parser.parse_args(argv)
    times = {"python_s": process_age()}
    import torch
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.autotuning.scheduler import CONFIG_PATH_ENV, METRIC_PATH_ENV
    from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig, gpt_config
    from deepspeed_tpu_torch.ops.cuda import cross_entropy, flash_attention, fused_optim
    times["import_s"] = process_age()

    seq = SEQ[args.preset]
    if args.preset == "gpt2":
        cfg = gpt_config("gpt2", n_positions=seq, remat=True)
    else:
        cfg = GPTConfig(dtype="float32", **TINY)
    model = GPT(cfg, device=args.device, seed=0)
    config = args.deepspeed_config or os.environ[CONFIG_PATH_ENV]
    engine = dst.initialize(model=model, config=config, device=args.device, seed=0)[0]
    cuda = engine.device.type == "cuda"
    times["engine_s"] = process_age()
    for mod in (flash_attention, cross_entropy, fused_optim):
        mod.reset_counts()

    gas, micro = engine.gradient_accumulation_steps(), engine.train_micro_batch_size_per_gpu()
    # the steps after the second are timed as one block, drained at its ends
    # only: a drain after each step would fall between the engine's
    # throughput timer's stop and start, which leave such host time out
    timed_from, t0, loss = min(2, args.steps - 1), None, None
    while engine.global_steps < args.steps:
        if engine.global_steps == timed_from:
            if cuda:
                torch.cuda.synchronize(engine.device)
            t0 = time.perf_counter()
        ids = np.random.default_rng(900 + engine.global_steps).integers(
            0, cfg.vocab_size, (gas, micro, seq)).astype(np.int32)
        loss = engine.train_batch(batch=(ids, ids))
        if "startup_s" not in times:
            if cuda:
                torch.cuda.synchronize(engine.device)
            times["startup_s"] = process_age()
    if cuda:
        torch.cuda.synchronize(engine.device)
    timed_s, timed = time.perf_counter() - t0, engine.global_steps - timed_from
    launches, plain = kernel_counts()
    info = {"micro_batch": micro, "gas": gas, "zero_stage": engine._zero_stage,
            "steps": engine.global_steps, "times": times,
            "step_ms": timed_s / timed * 1e3,
            "samples_per_s": engine.train_batch_size() * timed / timed_s,
            "engine_throughput": engine.tput_timer.avg_samples_per_sec(),
            "loss": float(loss), "launches": launches, "plain_calls": plain,
            "expected": expected_launches(engine, cfg, seq, engine.global_steps) if cuda else None}
    engine.close()
    metric_path = os.environ.get(METRIC_PATH_ENV)
    if metric_path:
        with open(os.path.join(os.path.dirname(metric_path), "launches.json"), "w") as f:
            json.dump(info, f)
    print("WORKER " + json.dumps(info), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
