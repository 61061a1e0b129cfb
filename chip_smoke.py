#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. environment: torch / CUDA versions and the card's name and power limit;
2. build: compiles the CUDA kernels from ``deepspeed_tpu_torch/ops/cuda/csrc``;
3. kernels against their plain PyTorch versions at the serving shapes of
   GPT-2 XL (H=25, D=64, block 16), Llama-3-8B (H 32 over 8 kv heads, D
   128) and BLOOM-7b1 (H 32, D 128, ALiBi slopes), fp32 and bf16 (KERNEL_HEADS
   below): max abs error, median
   kernel and plain times by CUDA events (L2 flushed before each launch),
   the bound (bytes or operations over the H100 SXM's peaks) and, for the
   contiguous kernel, one ``scaled_dot_product_attention`` call as a
   yardstick.  The contiguous kernel runs at batch-8 decode and at
   generate()'s own shapes (a 300-token prefill, a masked decode step).
   bf16 is also held at peaked scores (q scaled to a score std of ~3, where
   a lost 16-key block shows) against the plain version computed in fp32 on
   the same inputs, by relative L2.  Beside each paged case, one SDPA call
   over the cache gathered beforehand (the gather untimed; GQA as
   ``enable_gqa``, ALiBi as a float ``attn_mask``) is reported as a lower
   reference: no PyTorch call takes a block table, so it is not a library
   time.  Each decode case is also timed after a read-only flush
   (the 64 MB buffer summed, not zeroed): zeroing leaves ~50 MB of dirty
   lines in L2 whose write-back shares the bandwidth with the kernel's
   reads, which is not how the serving step finds the cache;
4. end to end in fp32 (TF32 off): GPT-2 XL at full width and depth, seeded
   weights, served through ``init_serving`` and held token for token
   against the port's ``generate()`` — once with a roomy arena, once with a
   small one that forces preemption and recompute.  A divergence counts as
   a near-tie only where generate()'s top-two logits at the first differing
   position are within 1e-4;
5. bf16 serving of the same requests: tokens/s, median TTFT and median
   decode-step time, finite logits, a profile of 8 decode steps (device
   time by kernel, paged attention's device ms per step) and the
   prefill's last and the first decode step's logits, the same token fed,
   against the plain attention path (BF16_LOGIT_TOL below);
6. the training kernels against their plain versions at GPT-2's training
   shape, fp32 and bf16: the flash attention forward, dQ and dKV at the
   path's shape (B 8, S 512, H 12, head_dim 64, causal), at GPT-2 XL's
   (H 25, S 1024, B 2) and at the dense seq-4096 step's (B 2, S 4096, H
   12), with GQA (Hkv 4), ALiBi, a per-head bias, a ragged S 1000 and
   without the causal mask; the cross-entropy forward, dx and
   dhead at N 4096 (micro 8 x seq 512), E 768, V 50304 (vocab 50257), in
   bf16 also at GPT-2 medium's, large's and XL's widths (E 1024, 1280,
   1600), and the forward alone at the sparse step's N 8192, each forward
   beside cuBLAS's ``x @ head[:vocab]^T`` alone ("product-only", the least
   a library takes for the product the kernel fuses); and
   the fused AdamW over all 148 GPT-2 leaves at n_positions 512
   (124,082,688 values, bit for bit; again with the gradients as views
   into one flat buffer, the engine's layout).  Times as in phase 3, with
   ``scaled_dot_product_attention`` (forward; its autograd backward as one
   call against dQ + dKV), ``x @ head^T`` + ``F.cross_entropy`` (and its
   autograd backward) and ``torch._fused_adamw_`` as yardsticks.  The bf16
   kernels are held against plain versions whose products are exact (the
   flash plain versions always; the cross-entropy ones with
   ``fp32_products``), at peaked scores (flash: score std 3; cross-entropy:
   FLASH_* and CE_* below);
7. training end to end in bf16: ``deepspeed_tpu_torch.initialize`` ->
   ``train_batch`` with bench.py's headline config at seq 512 (micro 8,
   AdamW lr 1e-4 wd 0.01, clip 1.0, remat, attn_impl "auto" -> flash): 2
   warm-up calls (the first runs the step eagerly and captures it as one
   CUDA graph) and 12 timed graphed steps (replays), then 3 eager steps
   of the same engine through ``forward`` / ``backward`` / ``step``; for
   both, the median step ms, the host's queue ms, samples/s, TFLOPs by
   bench.py's formula, and a ``torch.profiler`` step's device time and
   busy share (the eager step also split by category; "not measured"
   where the profiler records no device time), each profiled step's
   launch counters held against the kernels its trace holds and, for the
   replay, against the captured graph's kernel nodes, and peak device
   memory; a falling finite loss and one capture in all; then
   the same at seq 256, where "auto" takes the reference attention;
8. the seq-512 model in fp32 (TF32 off), 3 graphed steps through the
   kernels and 3 eager ones through the plain versions from the same
   seeded weights: losses and final parameters held to the tolerances
   stated at the top;
9. the block-sparse path in bf16: the same config at seq 4096, micro 2,
   with a ds_config ``sparse_attention`` block (the Sparse Transformer
   "fixed" layout, block 64) that reaches the model as
   ``attn_impl="block_sparse"`` through ``register_attention`` and an
   adapter over ``SparseSelfAttention`` (as a user of the package writes
   it): 2 warm-up calls, 6 timed graphed steps and 3 eager ones, profiled
   as in phase 7 (the eager split with the sparse kernels as a category of
   their own); then 3 graphed steps of the same config with
   ``attn_impl="flash"``, the dense step at the same length;
10. the sparse path in fp32 (TF32 off), 3 steps through the kernels and 3
   through the plain versions, as phase 8;
11. the other GPT-2 widths in bf16 through the same entry points and
   config at seq 512, micro 8: ``gpt_config("gpt2-medium")``, ``gpt2-large``
   and ``gpt2-xl`` at full size, each two warm-up calls (the capture and
   the first replay), 4 / 3 / 3 timed graphed steps and 2 / 2 / 1 eager
   ones: a finite loss, falling over all steps (gpt2-xl: over its first
   three, see TRAIN_WIDTHS), graphed and eager step times, host times,
   device times and busy shares, peak device memory graphed and eager, and
   the launch counts of every kernel, each model freed (``engine.close()``)
   before the next;
12. the engine core: (a) GPT-2 at seq 512 in fp32 (TF32 off), 3 graphed
   and 3 eager steps from the same seeded weights, held to phase 8's
   limits, with whether they are bitwise equal; (b) resume in bf16: 3
   graphed steps, ``save_checkpoint``, 3 more; a fresh engine from other
   weights ``load_checkpoint``s and runs the same 3, held to the first
   bit for bit (phase 8's limits where a kernel proves not to be
   deterministic, printed as such); the same with ``checkpoint.async_save``,
   training on while the finalizer writes and waiting before the load;
   ``deepspeed_tpu_torch.ckpt_cli verify`` (the walk and exit codes of
   ``tools/verify_checkpoint.py``; its ``main`` in this process) exits 0
   on the save dir and 1 after one flipped byte in the newest tag's state
   file; save and load
   seconds and bytes; (c) the first engine loads that save dir, rolls back
   to the earlier tag, and its next replays give the same losses with no
   new capture.  Checkpoints go to a temporary directory, removed after;
13. Llama-3-8B (``llama_config`` at ``meta-llama/Meta-Llama-3-8B``'s widths,
   FAMILY_CELLS below): fp32 (TF32 off) at 4 of its 32 layers, seeded
   weights, ``init_serving`` held token for token against the port's
   ``generate()`` with a roomy and a preempting arena, near-ties counted as
   in phase 4; then bf16 at all 32 layers, made in bf16 on the card: the
   measurements of phase 5 (tokens/s, median TTFT, median decode step, a
   profiled decode step's device ms, busy share and paged-attention share,
   the first decode step's logits against the plain attention path), the
   paged kernel launched once per layer per dispatch, and peak memory;
14. the same for BLOOM-7b1's widths (``bloom_config``, ALiBi, tied head):
   fp32 at 4 of 30 layers, bf16 at all 30;
15-17. the families' training cells (FAMILY_TRAIN below): Llama-3-8B's
   widths at 8 layers, bf16, graphed and eager, profiled; its fp32 kernel
   path against the plain path at 2 layers; BLOOM-7b1's widths at 2 layers;
18. DeepSpeed-MoE's 350M+MoE-128 (MOE_CELL below) served: (a) fp32 (TF32
   off) at 4 of its 24 blocks with a no-drop eval capacity factor (chunked
   and whole-prompt prefills would drop different tokens at 1.0), held
   token for token against the port's ``generate()`` through
   ``init_serving`` (roomy and preempting) and ``init_inference(...)
   .generate``, near-ties counted as in phase 4; (b) bf16 at all 24 blocks
   and the published factor 1.0 through ``init_serving``: phase 5's
   measurements (the logit comparison pinned to the kernel run's routes,
   the routes that differ and their smallest gate margin printed), 24
   paged launches a dispatch, peak memory, and the drop fraction and load
   entropy of every gating call of one more serve of the same requests;
19. its training, bf16, at 2 of 24 blocks (micro 4 x seq 2048, AdamW lr
   1e-4 wd 0.01, clip 1.0, remat, ZeRO-0, graphed, gating noise drawn from
   the engine's generator): as phase 15, with TFLOPs by the active
   parameter count (one expert a token), all uninstrumented; then the
   drop fraction of each of 4 eager steps after them, under MoEGauges;
20. its fp32 kernel path against the plain path at 2 blocks, phase 8's
   config, top-1 and top-2: 3 graphed steps, 3 eager steps through the
   kernels (recording every gating call's routes; bitwise equal to the
   graphed ones, or held to phase 8's limits), 3 eager steps through the
   plain versions pinned to those routes (the routes of their own that
   differ and their smallest gate margin printed), held to phase 8's
   limits;
21. the attention kernels at head_dim 256 (GPT-J-6B's 16 heads) and 96
   (GPT-NeoX-20B's 64), fp32 and bf16, as phase 3 does (WIDE_KERNEL_HEADS:
   paged batch-8 decode and prefill chunk 64, contiguous batch-8 T 1024
   and T 1000, generate()'s prefill 300 and decode) and the flash forward
   alone (WIDE_FLASH_CASES: B 1, S 2048 causal; S 200 ragged; GQA 4; ALiBi)
   against its plain version, with ``scaled_dot_product_attention`` as the
   yardstick;
22. GPT-J-6B (``EleutherAI/gpt-j-6b``'s widths, FAMILY_CELLS): fp32 at 4 of
   its 28 layers through ``init_serving`` held token for token against
   ``generate()``, roomy and preempting; bf16 at all 28 layers, phase 13's
   measurements, 28 paged launches a dispatch;
23. GPT-NeoX-20B (``EleutherAI/gpt-neox-20b``'s widths): the same, fp32 at
   4 of 44 layers, bf16 at all 44 (41.1 GB of weights);
24. ``module_inject`` and int8: HF-layout stand-ins (``hf_standin``: a
   ``config`` namespace with HF's field names, a ``state_dict()`` with HF's
   keys and layouts) of GPT-J-6B and GPT-NeoX-20B at 2 layers, seeded, go
   through ``init_inference``: fp32 greedy tokens against the port's
   ``generate()`` on the same weights (near-ties counted as in phase 4),
   bf16 logits of a 300-token forward (flash) and of a prefill and decode
   step (the contiguous kernel) against the plain attention path; then
   GPT-J-6B at full size in bf16 and with ``dtype="int8"``: int8 block
   weight bytes against bf16, peak memory, the median decode step of each,
   their greedy agreement over 32 tokens x 8 prompts, the largest logit
   distance, and a 2048-token forward through the flash kernel;
25. flash dQ and dKV (and the forward) at head_dim 256 and 96 against
   their plain versions, fp32 and bf16, as phase 6 (WIDE_BACKWARD_CASES:
   GPT-J-6B's and GPT-NeoX-20B's training shape, B 4, S 2048, H 16 / 64,
   causal; a ragged S 200, GQA 4, ALiBi, a dense bias at S 129, S 65 at
   each width), each kernel's time, bound and one SDPA autograd backward
   beside it, and the blocks per SM of each new instantiation;
26. GPT-J-6B's widths at 12 of 28 layers and GPT-NeoX-20B's at 5 of 44
   (FAMILY_TRAIN: 2.83 B and 2.89 B parameters, near phase 15's 2.80 B)
   trained as phase 15: bf16, micro 4 x seq 2048, graphed and eager,
   profiled by category;
27. their fp32 kernel paths against their plain paths at 2 layers, as
   phase 16 (FAMILY_PARITY, phase 8's limits);
28. ZeRO at world size 1 (a one-rank NCCL group, so every collective of a
   stage runs): GPT-2 at phase 8's fp32 config, 3 graphed steps at each of
   ZERO_CONFIGS (stages 0-3, stage 2 with ``offload_optimizer`` and stage 3
   with both offloads, the offloaded state in 8 chunks; and ZeRO-Infinity's
   NVMe tier: stage 1 and stage 3 with ``offload_optimizer: nvme`` and
   stage 3 with both tiers on NVMe, each in a fresh directory of the
   machine's disk with NVME_AIO's staging knobs, the update a walk over
   the 8 chunks after each replay), each held to phase 8's limits against
   stage 0 (and whether bit for bit), one capture each, AdamW's launches a
   step printed, and one more replay's launch counters held against the
   captured graph's kernel nodes (and the walk's AdamW launches after it)
   and the trace;
29. GPT-2 XL (BASELINE.md's north star) in bf16 at stage 3 with
   ``offload_param`` and ``offload_optimizer`` (cpu), seq 512 micro 8:
   graphed and eager steps, the bytes a step moves each way, the pinned
   bandwidth (a 1 GiB copy each way), the step's floor (device time
   outside the copies, and phase 11's stage-0 device time, plus the bytes
   over that bandwidth), peak device memory and pinned host bytes beside
   the memory model's plan, the loss finite and falling;
30. Llama-3-8B's widths at stage 3 with both offloads, micro 4 x seq 2048
   (phase 15's cell), at 10 layers, whose 12 pinned bytes a parameter must
   fit what MemAvailable leaves: phase 29's readings and TFLOPs by
   bench.py's formula;
31. tiered KV: Llama-3-8B at 16 of its 32 layers in bf16 through
   ``init_serving`` (seeded weights; KV 64 KiB a token, 1 MiB a 16-token
   block), 12
   requests of 300-700 prompt tokens and 64 new in three waves of rising
   SLO class (TIERED_WAVES), served in a roomy arena, then in 192 blocks
   with ``kv_tiering`` (host cache 128 MiB, disk tier under $TMPDIR or the
   checkout, whichever has more room) and without it: every restaged
   block equal byte for byte to what was spilled (``RestageCheck``, apart
   from the tiering code), at least one restage from the disk tier,
   spills, restages by source, the copies' bytes and GB/s each way (and
   the same spills through ``index_select`` and ``.cpu()`` into pageable
   memory, ``RestageCheck``'s own gathers), the median restage wait, each
   run's wall time and prefill tokens (what tiering saved against
   recompute), tokens against the roomy run with near-ties counted as in
   phase 4 at twice the bf16 paths' own logit distance (a prefill row
   against a decode step at one position, the two paths a resumed request
   and an uninterrupted one take), the tokens each comparison reached (a
   request is compared up to its first divergence), and the spread of the
   roomy run's top-two logit gaps against that bound;
32. bounded dispatch on the same cell: ``serve_step_timeout_s`` 8 times the
   tiered run's median step (at least 0.5 s) and a wedge of ``serve.step``
   at its 60th hit: exactly one incident, every request finished with all
   its tokens, ``last_recovery_s``, tokens against the run without the
   fault; then a raise at the first ``serve.restage``: that request
   recomputes, the others restage;
33. sampled ``generate()`` at Llama-3-8B's widths, fp32 at 2 layers (TF32
   off): the kernel path and the plain path fed the same Gumbel noise draw
   the same tokens; through ``init_inference``, one ``seed`` twice gives the
   same tokens and two seeds differ;
34. phases 31-32's traffic, arena and schedule at fp32 (TF32 off) at 4
   layers of Llama-3-8B's widths, the host cache scaled with the block
   (64 MiB): a roomy run, a tiered one (restages held byte for byte), a
   recomputing one and a wedged one with bounded dispatch, each held
   token for token to the roomy run with phase 4's 1e-4 near-tie bound,
   so that every request of the recovered and the tiered runs is
   compared to its end, and the roomy run's top-two gap spread;
35. the telemetry plane on phase 5's serving cell (GPT-2 XL bf16 through
   ``init_serving``, 8 slots, its prompts), four runs in turn (off,
   scraped, hub, off): telemetry off; a dict-built hub
   (JSONL, ``flush_every`` 8, metrics, the default SLO rules, tracing into
   a ``trace_dir``) with the ops server on an ephemeral port while a thread
   scrapes ``/metrics`` and ``/healthz`` over HTTP every 0.1 s; the same
   hub without the ops server: the same tokens in all four; in each hub run
   one finished ``serve_request`` record a request and ``serve_step``
   records, the ``serve.step`` / ``serve.prefill`` / ``serve.decode``
   spans, and in each scraped run a mid-run scrape with ``serve_ttft_ms``
   counted and blocks in use and ``/healthz`` healthy with
   ``serve_arena``; 48 paged launches a dispatch; the median decode step
   and TTFT of each setting, and each run's tokens/s;
36. the telemetry plane on phase 7's training cell (GPT-2 bf16, seq 512,
   micro 8, ``train_batch``): 24 steps from one seed with the
   ``telemetry`` block off (each step's loss and grad norm read after it)
   and on (JSONL with ``flush_every`` 5, metrics, goodput, tracing, a
   profiler window over steps 10-12): losses and parameters bit for bit
   equal, each step record's loss and grad norm equal to the off run's,
   one capture and the launch counters equal to the captured graph's
   kernel nodes, ``EFFICIENCY.json`` written, the profiler's Chrome trace
   holding device events; the graphed step's median off and on;
37. the stability sentinel in phase 7's graphed cell: clean steps with
   the ``stability`` block on and off bit for bit (one capture each, the
   counters equal to the graph's kernel nodes, each median step); a
   ``train.grads`` nan step leaving parameters, moments and count bit for
   bit, seen on the host one step later; a run of poisoned steps walking
   the ladder in JAX's order (the backed-off replay moving the parameters
   half as far as one at the full lr; the rollback into the same graphs;
   the quarantined batch skipped); the fused AdamW kernel's skip flag set
   and clear against its plain version, also on a ``ZeroAdam`` chunk;
38. phase 7's cell at ZeRO-1 (a one-rank NCCL group) under the port's
   elastic agent and launcher, one agent run of four starts: a preemption
   (SIGTERM at a step boundary, exit 143), a crash (exit 9), a wedged
   collective with no retry left (exit 113 with the marker) and the
   finishing start: the agent's restarts, the budget spent only on the
   crash, each start's start-up seconds, the preemption save and
   ``ckpt_stall``; the final parameters equal an uninterrupted run's bit
   for bit;
39. collective recovery in process on that cell: a ``comm.collective``
   wedge at the capture's first collective retried in place (one
   incident, the capture abandoned and taken again, ``comm_recovery``
   booked, ``/recovery`` answering, the parameters of phase 38's
   uninterrupted run);
40. the autotuner through the launcher: ``python -m
   deepspeed_tpu_torch.launcher.runner --autotuning run`` on
   ``tests/torch_autotune_worker.py`` (GPT-2 at full width, bf16, seq 512,
   AdamW, remat, seeded tokens, 6 ``train_batch`` steps) with
   ``autotuning: {zero_stages: [0], micro_batch_sizes: [4, 8]}``: two
   experiments and the final run, each its own process; each experiment's
   ``metrics.json`` (the engine's throughput at its ``steps_per_print``
   boundaries) above 0, ``ds_config_optimal.json`` the one with the larger
   throughput, the final run training at its micro-batch; each child's
   launches of the flash, cross-entropy and AdamW kernels exactly what its
   steps make, no plain version called;
41. the closed loop on the same worker: ``ClosedLoopAutotuner`` over ZeRO-3
   x ``offload_param`` {none, cpu} x micro {4, 8} with GPT-2's
   ``model_info`` and a device budget between the offloaded layer-window
   peak and the gathered peak: the two unoffloaded candidates pruned (no
   trial dir, no process), two trials scored from their
   ``EFFICIENCY.json``, their launches held as in phase 40; then a GPT-2
   engine with the emitted ``ds_config_patch.json`` applied builds under
   ``stale_policy: refuse``, and one with a copy whose fingerprint says
   ``num_params: 1`` raises ``StaleTuningError`` with no kernel launched.
   Each trial's start-up seconds, mean step ms, samples/s and score are
   printed;
42. ZeRO-Infinity at GPT-2 XL: phase 29's config with ``offload_optimizer:
   nvme`` on a fresh directory of the machine's disk (its filesystem and
   free bytes printed; tmpfs or less room than twice the moments fails),
   after 1 GiB written and read back through ``AIOHandle`` there with and
   without ``use_o_direct`` (bytes equal, GB/s): a warm-up step and two
   timed ones, their losses bit for bit phase 29's first three, one
   capture, AdamW once a chunk a step in the walk; each step split into
   the replay and the walk, the staging bytes beside ``/proc/self/io``,
   ``offload_wait``, ring hits and misses, pinned host bytes against phase
   29's, peak device memory, and the depth at Llama-3-8B's widths that the
   host and disk admit with the moments on the host and on NVMe; one walk
   chunk of AdamW against its plain version.
Phases 40-41's searches run in a thread beside phases 38-39 (their trials
are processes of their own, whose start-ups take most of their time); the
check at build of phase 41 runs after phase 39.  Each phase prints its
seconds, and the total is printed after phase 41.

Phase 2 also prints the registers, spills, blocks per SM and shared
memory of the kernels the tree redesigned last (the cross-entropy forward
and the block-sparse forward and dQ) and of those at head_dim 96 and 256
(the three flash kernels, the decode kernels' two paths), from ptxas's log
and the occupancy query.
Phase 6 also holds the three block-sparse kernels against their plain
versions (``kernel_rounding=True``: p and ds rounded to the input dtype
before their products, as the bf16 kernels' tensor cores take them; the
JAX-literal plain version keeps them in fp32 and is reported beside, for
the path's case) in fp32 and bf16 over SPARSE_CASES below, with
``scaled_dot_product_attention`` under the layout's dense mask and the
port's flash kernels at the same shape as yardsticks (flash dQ also on
its own, the per-tile yardstick of sparse dQ).  The forward and dQ walk
the work list of ``fwd_work``, dKV that of ``dkv_work`` (its rows report
the split length, the task count and the workspace bytes); a second call
must give bitwise-equal dQ, dK and dV, and
the fixed split lengths of DKV_SPLITS are held to the same tolerances and
timed beside the kept one at each bf16 case.

Each run of phases 4-5, 7-37 (generate(), each serve, the timed
graphed and eager training steps, each fp32 training run) zeroes the launch
counters just before it and reads them just after: its kernels must have
launched (a replay counts every launch of its graph; the capture counts
none; the
flash kernels exactly once per layer per micro-step, the remat recompute
reusing the saved o and lse; the sparse forward twice, since remat saves
nothing of it, as in JAX, and its dQ and dKV once; the cross-entropy
kernels once per micro-step; AdamW once per step), no other kernel, and
the plain versions never (the fp32 phases' plain runs excepted).
The kernel table reports each kernel's case at the shape of the latest
slice's run that launches it and that run's count (the paged kernel
phase 31's tiered serve, the contiguous one phase 24's, the flash and
cross-entropy kernels the autotuner's children of phases 40-41 (their
launches summed; the case at GPT-2's training shape from phase 6), AdamW
phase 42's NVMe walk (its case one chunk of that walk), the block-sparse
kernels phase 9's).
The last two lines are the kernel table (JSON) and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside this file, it exits non-zero and prints no result.
"""

import atexit
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"float32": 67e12,  # fp32 outside the tensor cores
              "bfloat16": 989e12}
# decode kernels and AdamW: |kernel - plain| <= TOL * max(1, |plain|): fp32
# sums in another order; bf16 outputs are rounded to bf16 (2^-8 relative)
# after a softmax whose p the two versions round at different points
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# decode kernels in bf16 at peaked scores (q scaled to a score std of ~3):
# relative L2 against the plain version computed in fp32 on the same bf16
# inputs.  The kernel's own error is bf16 rounding of p and o (2^-9
# relative each, ~2e-3 together); a lost 16-key block moves o by percents
PEAKED_Q_STD = 3.0
PEAKED_L2_TOL = 5e-3
NEAR_TIE = 1e-4
# bf16 prefill and first decode step's logits, kernel vs plain attention:
# at most BF16_LOGIT_TOL, or LOGIT_NOISE_FACTOR times the plain bf16 path's
# own distance from the same model with each attention computed in fp32
# on its bf16 inputs (bf16 rounding that a deep random model amplifies;
# the larger of the two).  A lost block or a wrong head moves the logits
# by their own size (a flipped token moved them by 7.5 at Llama-3-8B)
BF16_LOGIT_TOL = 0.25
LOGIT_NOISE_FACTOR = 3.0

H, D, BS = 25, 64, 16            # GPT-2 XL heads / head_dim, arena block size
MB = 1024 // BS                  # blocks per sequence at n_positions 1024
# phase 3's head shapes: model -> (H, Hkv, head_dim, ALiBi).  The decode
# kernels run at each, the paged cases at 1024-slot table rows
# phases 13-14: name -> (constructor in models/gpt.py, its published widths,
# layers of the fp32 identity run: 4, cut from 8 so that the script ends in
# its time); bf16 runs at full depth
FAMILY_CELLS = {
    # meta-llama/Meta-Llama-3-8B config.json: untied head, GQA 32:8, rope
    # theta 5e5, SwiGLU 14336, 8.03B parameters
    "llama3-8b": ("llama_config", dict(vocab_size=128256, n_positions=8192, n_embd=4096,
                                       n_layer=32, n_head=32, n_kv_head=8,
                                       intermediate_size=14336, rope_theta=500000.0,
                                       ln_eps=1e-5), 4),
    # bigscience/bloom-7b1 config.json: ALiBi, tied head, 7.07B parameters
    "bloom-7b1": ("bloom_config", dict(vocab_size=250880, n_positions=2048, n_embd=4096,
                                       n_layer=30, n_head=32), 4),
    # phases 22-23.  EleutherAI/gpt-j-6b config.json: head_dim 256, rotary_dim
    # 64 interleaved, a parallel residual from one LayerNorm, gelu_new, an
    # untied head with a bias; 6.05 B parameters
    "gptj-6b": ("GPTConfig", dict(vocab_size=50400, n_positions=2048, n_embd=4096,
                                  n_layer=28, n_head=16, position_encoding="rope",
                                  rope_dim=64, rope_interleaved=True,
                                  block_type="parallel_single_ln", activation="gelu_tanh",
                                  untied_head=True, head_bias=True, ln_eps=1e-5), 4),
    # EleutherAI/gpt-neox-20b config.json: head_dim 96, rotary_pct 0.25
    # (rope_dim 24, base 10000), a parallel residual, intermediate 24576,
    # an untied head; its gelu_fast is the tanh gelu; 20.55 B parameters
    "neox-20b": ("GPTConfig", dict(vocab_size=50432, n_positions=2048, n_embd=6144,
                                   n_layer=44, n_head=64, position_encoding="rope",
                                   rope_dim=24, rope_theta=10000.0, block_type="parallel",
                                   intermediate_size=24576, activation="gelu_tanh",
                                   untied_head=True, ln_eps=1e-5), 4),
}
KERNEL_HEADS = {"gpt2-xl": (H, H, D, False),
                "llama3-8b": (32, 8, 128, False),      # GQA 4:1
                "bloom-7b1": (32, 32, 128, True),
                "moe-350m": (16, 16, 64, False)}
# phase 21: the same cases at GPT-J-6B's and GPT-NeoX-20B's heads
WIDE_KERNEL_HEADS = {"gptj-6b": (16, 16, 256, False),
                     "neox-20b": (64, 64, 96, False)}

PROMPT_LENS = [17, 45, 80, 130, 200, 260, 300, 33, 150, 96]
NEW_TOKENS = 32
# contiguous kernel cases (name, B, S_q, T, pos): batch-8 decode with every
# key live (T = 1024, and ragged T = 1000), then generate()'s own shapes for
# the longest prompt: a 300-token prefill from 0 into a 332-slot cache
# (causal masking inside the chunk, 10 query groups) and a decode step at
# pos 200 (the cache's tail masked)
CONTIGUOUS_CASES = [("contiguous-T1024", 8, 1, 1024, 1023),
                    ("contiguous-T1000", 8, 1, 1000, 999),
                    ("generate-prefill", 1, 300, 332, 0),
                    ("generate-decode", 1, 1, 332, 200)]
SERVE_CFG = {"block_size": BS, "max_batch_size": 8, "prefill_chunk": 64}

# training: bench.py's headline config (bench.py:122-130) at seq 512, where
# attn_impl="auto" takes flash; a short run at seq 256 drives the reference
TRAIN_SEQ, TRAIN_MICRO, TRAIN_TIMED_STEPS = 512, 8, 12
SHORT_SEQ, SHORT_TIMED_STEPS = 256, 3
TRAIN_CFG = {"train_micro_batch_size_per_gpu": TRAIN_MICRO, "gradient_accumulation_steps": 1,
             "optimizer": {"type": "AdamW", "params": {"lr": 1e-4, "weight_decay": 0.01}},
             "zero_optimization": {"stage": 0}, "bf16": {"enabled": True},
             "gradient_clipping": 1.0, "steps_per_print": 10 ** 9}
TRAIN_PARAMS = 124_082_688          # GPT-2 at n_positions 512: 148 leaves
TRAIN_LAYERS = 12
CE_SHAPE = (TRAIN_MICRO * TRAIN_SEQ, 768, 50304, 50257)     # N, E, V, vocab_size
# the cross-entropy kernels at the other GPT-2 widths (bf16, the path's
# dtype; same N, V and inputs as CE_SHAPE)
CE_WIDTHS = {"gpt2-medium-train": 1024, "gpt2-large-train": 1280, "gpt2-xl-train": 1600}
# the cross-entropy forward alone at the sparse step's shape (micro 2 x seq
# 4096 = N 8192 rows; bf16, E 768, the same V and inputs)
CE_SPARSE_ROWS = 2 * 4096
# eager steps (forward / backward / step) timed beside the graphed ones
EAGER_STEPS = 3
# phase 11: preset -> (graphed, eager, loss window) at full size: timed
# graphed steps after two warm-up calls (the first captures, the second is
# the first replay, whose host time includes the graph's one-off upload),
# timed eager steps, and the steps over which the loss must fall (None: all
# of them).  gpt2-xl at lr 1e-4 on one fixed batch overshoots from its
# fourth step (losses 10.2145, 10.0052, 9.4982, 10.2838, 10.3649, 10.2290
# on the H100, graphed and eager alike, bit for bit), so its loss is held
# over the first three
TRAIN_WIDTHS = {"gpt2-medium": (4, 2, None), "gpt2-large": (3, 2, None),
                "gpt2-xl": (3, 1, 3)}
# each wrapper's kernel, by a pattern of its name in the profiler's trace
# (demangled) and in the captured graph's dump (mangled: Lb0E is "false"):
# one launch per wrapper call
KERNEL_NAMES = {"paged_attention": r"paged_(decode|prefill)_kernel",
                "decode_attention": r"contiguous_(decode|prefill)_kernel",
                "flash_forward": r"flash_fwd_kernel", "flash_backward_dq": r"flash_dq_kernel",
                "flash_backward_dkv": r"flash_dkv_kernel",
                "ce_forward": r"ce_fwd_(wgmma_)?kernel",
                "ce_backward_dx": r"ce_(bwd|wide_ds)_kernel(<[^,<>]+, false>|I\w+?Lb0E)"
                                  r"|ce_wide_dx_kernel",
                "ce_backward_dhead": r"ce_(bwd|wide_ds)_kernel(<[^,<>]+, true>|I\w+?Lb1E)"
                                     r"|ce_wide_dhead_kernel",
                "fused_adam": r"adam_kernel", "block_sparse_forward": r"sparse_fwd_kernel",
                "block_sparse_backward_dq": r"sparse_dq_(wgmma_)?kernel",
                "block_sparse_backward_dkv": r"sparse_dkv_kernel"}
# phases 15-17: the families' training cells.  name -> (layers, warm-up,
# timed graphed steps, eager steps, profiled by category).  Depth cut:
# ZeRO and offload are not ported, so the fp32 master, gradient, two
# moments and the bf16 copy (18 bytes a parameter) sit on one 80 GB card:
# Llama-3-8B at 8 of 32 layers is 2.80 B parameters, ~50 GB of state;
# BLOOM-7b1 at 2 of 30 (its 250880 x 4096 tied head alone is 1.03 B)
# phase 26: GPT-J-6B's widths at 12 of 28 layers (2.83 B) and
# GPT-NeoX-20B's at 5 of 44 (2.89 B), near Llama's 2.80 B, for the same cut
FAMILY_TRAIN = {"llama3-8b": (8, 2, 6, 2, True), "bloom-7b1": (2, 2, 3, 1, False),
                "gptj-6b": (12, 2, 6, 2, True), "neox-20b": (5, 2, 6, 2, True)}
FAMILY_TRAIN_SEQ, FAMILY_TRAIN_MICRO = 2048, 4
FAMILY_TRAIN_CFG = dict(TRAIN_CFG, train_micro_batch_size_per_gpu=FAMILY_TRAIN_MICRO)
# the fp32 kernel-vs-plain parity of Llama-3-8B's widths (phase 16), and of
# GPT-J-6B's and GPT-NeoX-20B's (phase 27), at phase 8's config and limits:
# layers, seq, micro
FAMILY_PARITY = (2, TRAIN_SEQ, TRAIN_MICRO)
# phases 18-20: DeepSpeed-MoE's 350M+MoE-128 (Rajbhandari et al., ICML 2022;
# Megatron-DeepSpeed examples_deepspeed/MoE/ds_pretrain_gpt_350M_MoE128.sh):
# GPT-2 medium's dense widths (1024 x 16 heads, head_dim 64, learned
# positions, tied head over vocab 50304) at n_positions 2048; 128 GELU
# experts of 4096 in every block (the published model has them in every
# other block; the repo's MoE layout puts a bank in each); top-1, capacity
# factor 1.0 in training and eval, min capacity 4, aux coefficient 0.01
MOE_CELL = dict(n_embd=1024, n_head=16, n_layer=24, n_positions=2048, moe_num_experts=128,
                moe_top_k=1, moe_expert_hidden=4096, moe_capacity_factor=1.0,
                moe_eval_capacity_factor=1.0, moe_min_capacity=4, moe_aux_coeff=0.01)
# phase 18 (a): blocks of the fp32 identity runs (about 4.37 B parameters,
# 17.5 GB; cut from 8 so that the script ends in its time), at an eval
# capacity factor >= the 128 experts, which drops no token
MOE_FP32_LAYERS, MOE_NO_DROP = 4, 128.0
# phase 19: blocks, warm-up, timed graphed and eager steps (2 blocks: 2.21 B
# parameters, ~40 GB of fp32 master, gradient, moments and bf16 copy), and
# the eager steps after them that read the gating's drop fraction;
# phase 20: blocks of the fp32 parity runs
MOE_TRAIN = (2, 2, 6, 2, 4)
MOE_TRAIN_PARAMS = 2_211_072_000
MOE_PARITY_LAYERS = 2
# phases 28-30: ZeRO and CPU offload at world size 1 (a one-rank NCCL
# group, so every collective of the stage runs).  Phase 28: GPT-2 at phase
# 8's fp32 config at the six configurations of tests/test_torch_zero.py,
# the offloaded state in pieces of ZERO_PIECE elements (8 chunks of GPT-2's
# 124 M), each held to phase 8's limits against stage 0
OFFLOAD = {"device": "cpu"}
# ZeRO-Infinity's NVMe tier: ``nvme_path`` is set for each run, a fresh
# directory under ckpt_root() (the machine's local disk), removed after it
NVME = {"device": "nvme"}
ZERO_PIECE = 2 ** 24
ZERO_CONFIGS = {
    "stage0": {"stage": 0}, "stage1": {"stage": 1}, "stage2": {"stage": 2},
    "stage3": {"stage": 3},
    "stage2-offload-optimizer": {"stage": 2, "offload_optimizer": OFFLOAD,
                                 "sub_group_size": ZERO_PIECE},
    "stage3-offload-both": {"stage": 3, "offload_param": OFFLOAD, "offload_optimizer": OFFLOAD,
                            "sub_group_size": ZERO_PIECE},
    "stage1-nvme-optimizer": {"stage": 1, "offload_optimizer": NVME,
                              "sub_group_size": ZERO_PIECE},
    "stage3-nvme-optimizer": {"stage": 3, "offload_optimizer": NVME,
                              "sub_group_size": ZERO_PIECE},
    "stage3-nvme-both": {"stage": 3, "offload_param": NVME, "offload_optimizer": NVME,
                         "sub_group_size": ZERO_PIECE},
}
ZERO3_OFFLOAD = {"stage": 3, "offload_param": OFFLOAD, "offload_optimizer": OFFLOAD}
# the NVMe runs' ``aio`` block: the staging pool's 8 writer threads and 8 MiB
# bounce buffers wrote fastest (0.84 GiB/s) of the settings
# ``runtime/swap_tensor/swap_probe.py`` tries, 4 GiB in 512 MiB chunks on
# the H100 machine's disk
NVME_AIO = {"block_size": 8 << 20, "queue_depth": 32, "thread_count": 8}
# phase 42: GPT-2 XL at phase 29's config with the moments on NVMe; a
# warm-up step (the capture) and two timed ones, the three losses held bit
# for bit to phase 29's first three
NVME_XL = (1, 2)
# the swap path must hold twice the moments (each piece is rewritten
# through a temporary file beside it)
NVME_ROOM_FACTOR = 2
# phase 42's AIOHandle reading: 1 GiB written and read back
AIO_PROBE_BYTES = 1 << 30
# phase 29: GPT-2 XL (BASELINE.md's north star, GPT-2 1.5B at ZeRO-3 with
# offload) at bench.py's config, seq 512, micro 8: warm-up, timed graphed and
# eager steps, loss window (phase 11's gpt2-xl cut: lr 1e-4 on one batch
# overshoots from its fourth step)
ZERO_XL = (2, 3, 1, 3)
# phase 30: Llama-3-8B's widths at stage 3 with both offloads, micro 4 x seq
# 2048 (phase 15's cell) at LLAMA_MIN_LAYERS layers, if the host holds them
# (12 bytes a parameter pinned: fp32 master and two moments); warm-up,
# timed graphed and eager steps
LLAMA_OFFLOAD = (2, 1, 1)       # warm-up, timed, eager steps (~4.6 s each)
# 10 layers, still past phase 15's 8 (16 took 59.0 s, 10 took 42.0 s): the
# time went to phases 40-41
LLAMA_MIN_LAYERS = 10
# of MemAvailable, the part phase 30 leaves to the rest of the machine
HOST_RESERVE_FRACTION, HOST_RESERVE_BYTES = 0.15, 4 << 30
PINNED_PROBE_BYTES = 1 << 30
# what a profiled step keeps in front of it inside the profiler's window.
# The trace loses device records at a window's start, two ways, seen on the
# H100: (1) it drops records it dates before the window, and its device
# timestamps can sit a millisecond off the host's (an fp32 GPT-2 replay
# lost 1-2 of its 12 flash forwards in 3 of 259 profiles, in none of 259
# behind ~20 ms of synchronised sleep, TRACE_MARGIN_CYCLES); (2) late in a
# long run (from phase 28 on) every window lost its first ~40 device
# records, the sleep among them, and with them the step's first flash
# forward.  So the window opens on TRACE_FILL_KERNELS empty sleeps, then
# the margin; each end keeps the margin.  No sleep counts as a kernel
TRACE_MARGIN_CYCLES = 40_000_000
TRACE_FILL_KERNELS = 256
# phase 12: graphed against eager steps (fp32), and the save / resume runs
# (bf16: RESUME_STEPS steps, a save, RESUME_STEPS more)
GRAPH_PARITY_STEPS, RESUME_STEPS = 3, 3
# cross-entropy inputs: x ~ N(0, 1), head ~ N(0, CE_HEAD_STD^2), so the
# logits' std is 0.15 * sqrt(768) ~ 4.2 and a few columns dominate each
# row's softmax, as in a trained model.  (At head std 0.02 the softmax is
# nearly flat, p ~ 2e-5, and its part of dx and dhead sits below bf16's
# resolution of the one-hot part, so a wrong softmax product would pass.)
CE_HEAD_STD = 0.15
# cross-entropy tolerances, against the plain version with fp32 products
# on the same inputs (the JAX-faithful plain version rounds bf16 logits,
# which moves p by percents, so it holds the bf16 kernels to nothing):
# * forward: |err| / max(1, |plain|) of nll and lse: fp32 sums of 768
#   exact products in another order;
# * dx, dhead: max |err| / max |plain|.  fp32: sums of 50304 (dx) or 2048
#   (dhead) terms in another order.  bf16: both sides round the output to
#   bf16, so where their fp32 sums straddle a rounding point they part by
#   one bf16 ulp, at most 2^-7 of max |plain|;
# * the softmax part on its own, |err|_2 / |softmax part|_2: dx against
#   plain + g * head[label] (the one-hot term taken out), dhead over the
#   vocab rows no label hits (pure softmax product).  Only the sparse
#   one-ulp flips above add to it in bf16: 7.9e-4 (dx) and 1.2e-4 (dhead)
#   on the H100, where dropping the softmax product gives 1.
CE_FWD_TOL = {"float32": 1e-5, "bfloat16": 1e-5}
CE_GRAD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
CE_SOFTMAX_TOL = {"float32": 1e-5, "bfloat16": 2e-3}
# the cross-entropy kernels at the families' training shape (phase 6):
# N 8192 rows (micro 4 x seq 2048), E 4096, over each family's vocab, with
# and without a head bias; head std so that the logits' std is ~4.2, as
# CE_HEAD_STD gives at E 768.  fp32 cases are timed over fewer calls (a
# call takes seconds there)
CE_FAMILY_VOCABS = {"llama3-8b": 128256, "bloom-7b1": 250880}
# the (family, head bias) cases that run in fp32 too, a call taking
# seconds at these shapes: both of Llama's and BLOOM's without a bias
# (BLOOM's with a bias is held in bf16 only, to keep the whole script
# inside 1200 s)
CE_FAMILY_FP32 = {("llama3-8b", False), ("llama3-8b", True), ("bloom-7b1", False)}
CE_FAMILY_HEAD_STD = CE_HEAD_STD * (768 / 4096) ** 0.5
# ... and the forward's and softmax part's tolerances scaled by sqrt(4096 /
# 768): a score sums 4096 products, not 768, and the kernels' fp32
# rounding of it grows with the root of the length.  ce_family_cases
# prints, for the Llama cases without a bias, how far the kernel's and the
# plain version's lse and dx are from an fp64 reference
CE_FAMILY_WIDTH_SCALE = (4096 / 768) ** 0.5
# flash attention cases: (B, S, H, Hkv, causal, bias, alibi); the path's
# shape first.  q is drawn with std 3 (k, v, do std 1), so the scores
# q.k * scale have std 3 and each row's softmax is peaked: a wrong p . v or
# a wrong ds moves the outputs by far more than rounding does.
FLASH_CASES = {
    "gpt2-train": (8, 512, 12, 12, True, None, False),
    "gpt2-xl": (2, 1024, 25, 25, True, None, False),
    "gqa": (8, 512, 12, 4, True, None, False),
    "alibi": (8, 512, 12, 12, True, None, True),
    "bias": (8, 512, 12, 12, True, "per-head", False),
    "ragged": (2, 1000, 12, 12, True, None, False),
    "noncausal": (8, 512, 12, 12, False, None, False),
    "gpt2-s4096": (2, 4096, 12, 12, True, None, False),
    # the MoE cell's training shape (micro 4 x seq 2048, 16 heads of 64)
    "moe-350m-train": (4, 2048, 16, 16, True, None, False),
    # the families' training shape (micro 4 x seq 2048) at head_dim 128
    # (trailing entry; 64 where absent): Llama-3-8B's GQA 32:8, BLOOM-7b1's
    # 32 heads with ALiBi
    "llama3-8b-train": (4, 2048, 32, 8, True, None, False, 128),
    "bloom-7b1-train": (4, 2048, 32, 32, True, None, True, 128),
}
# phase 21: the flash forward alone at the served head_dims (trailing
# entry), GPT-J-6B's and GPT-NeoX-20B's heads: a 2048-token prompt, a
# ragged one, GQA 4 and ALiBi (GQA and ALiBi exercise the kernel's
# options at these widths; neither model has them)
WIDE_FLASH_CASES = {
    "gptj-6b-s2048": (1, 2048, 16, 16, True, None, False, 256),
    "gptj-6b-s200": (1, 200, 16, 16, True, None, False, 256),
    "gptj-6b-gqa4-s512": (1, 512, 16, 4, True, None, False, 256),
    "gptj-6b-alibi-s512": (1, 512, 16, 16, True, None, True, 256),
    "neox-20b-s2048": (1, 2048, 64, 64, True, None, False, 96),
    "neox-20b-s200": (1, 200, 64, 64, True, None, False, 96),
    "neox-20b-gqa4-s512": (1, 512, 64, 16, True, None, False, 96),
    "neox-20b-alibi-s512": (1, 512, 64, 64, True, None, True, 96),
}
# phase 25: flash dQ and dKV (with the forward) at GPT-J-6B's and
# GPT-NeoX-20B's head_dims (trailing entry): the training cells' shape
# first (micro 4 x seq 2048, causal, their heads), then the served widths'
# kernel cases of tests/test_torch_flash_attention.py at each width: a
# ragged S 200, GQA 4 at S 320, ALiBi, a dense bias without the causal
# mask at S 129, S 65 (one row into a second tile)
WIDE_BACKWARD_CASES = {
    "gptj-6b-train": (4, 2048, 16, 16, True, None, False, 256),
    "neox-20b-train": (4, 2048, 64, 64, True, None, False, 96),
    **{f"d{d}-{name}": (*shape, d) for d in (256, 96) for name, shape in (
        ("ragged-s200", (2, 200, 8, 8, True, None, False)),
        ("gqa4-s320", (1, 320, 8, 2, True, None, False)),
        ("alibi-s256", (1, 256, 8, 8, True, None, True)),
        ("bias-noncausal-s129", (1, 129, 4, 4, False, "per-head", False)),
        ("s65-causal", (2, 65, 4, 4, True, None, False)))},
}
FLASH_Q_STD = 3.0
# flash tolerances, kernel against the plain version (exact products) on
# the same inputs, per output: max |err| / max |plain| and |err|_2 /
# |plain|_2 (lse: |err| / max(1, |plain|)).  fp32: sums in another order.
# bf16: both sides round p, ds and the outputs to bf16, from fp32 values
# that differ by rounding noise, so an element parts by at most about one
# bf16 ulp (2^-8 of its size) and the norm by far less.  The H100 read at
# most 4.9e-3 (max) and 1.2e-3 (o) / 1.5e-4 (dq, dk, dv) in norm over these
# cases; fp32 6e-7.  A wrong p . v or ds at these peaked scores is off by
# a large fraction of the output's norm.
FLASH_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 2e-3)}
FLASH_LSE_TOL = 1e-5
# fp32 kernel path vs plain path over 3 steps: score tiles sum in another
# order, so gradients differ by rounding noise d (~1e-10 absolute).  Adam
# moves an element by lr * m / (sqrt(v) + eps), so that noise moves a step
# by at most lr * d / eps ~ 1e-2 * lr, even where the exact gradient is
# zero (the attention key bias).  TRAIN_PARAM_ATOL is a tenth of the
# 3 * lr = 3e-4 that three steps can move any element: one element whose
# step went the wrong way or by a wrong size fails it.  Over all
# parameters the difference stays a rounding-level fraction of their norm
TRAIN_LOSS_RTOL, TRAIN_PARAM_REL_L2, TRAIN_PARAM_ATOL = 1e-5, 1e-6, 3e-5
# the sparse path: the same config at seq 4096, micro 2 (8192 tokens per
# step), with a ds_config sparse_attention block: the Sparse Transformer
# "fixed" pattern keeps 640 of the 2080 causal block pairs per head.  The
# fp32 parity of phase 10 holds it to the TRAIN_* limits above, for the
# same reasons (its full width and depth fit the time limit).
SPARSE_SEQ, SPARSE_MICRO, SPARSE_TIMED_STEPS, SPARSE_DENSE_STEPS = 4096, 2, 6, 3
SPARSE_BLOCK = {"mode": "fixed", "block": 64, "num_local_blocks": 4, "num_global_blocks": 1,
                "attention": "unidirectional"}
SPARSE_TRAIN_CFG = dict(TRAIN_CFG, train_micro_batch_size_per_gpu=SPARSE_MICRO,
                        sparse_attention=SPARSE_BLOCK)
SPARSE_PARAMS = 126_835_200         # GPT-2 at n_positions 4096: 148 leaves
# block-sparse kernel cases: (B, S, H, sparse_attention block, causal); the
# path's shape and layout first.  "empty-future": a [2, 4, 4] layout whose
# head 0 lists nothing in rows 2-3 and whose head 1 lists only a future
# block in row 0 (the JAX tests' cases).  Inputs and tolerances as the
# flash cases' (q std 3; FLASH_TOL, FLASH_LSE_TOL), against the plain
# versions with the kernel's rounding.
SPARSE_CASES = {
    "gpt2-s4096-fixed": (2, 4096, 12, SPARSE_BLOCK, True),
    "bigbird-s2048": (2, 2048, 12, {"mode": "bigbird", "block": 64, "num_random_blocks": 2,
                                    "num_sliding_window_blocks": 3, "num_global_blocks": 1,
                                    "attention": "bidirectional", "seed": 3}, False),
    "per-head-s2048": (2, 2048, 12, dict(SPARSE_BLOCK, different_layout_per_head=True,
                                         num_different_global_patterns=4), True),
    "empty-future-s256": (1, 256, 2, None, True),
}
# fixed dKV split lengths timed beside the kept one (DKV_SPLIT, "auto") at
# each bf16 case, each also held to the tolerances; None splits no column
DKV_SPLITS = (None, 8, 16, 32)
# phase 24: layers of the HF-layout stand-ins; the 300-token forward that
# takes flash (above ops/attention.py's 256); GPT-J-6B int8 against bf16:
# prompts x prompt length, new tokens, the long forward's length
INJECT_LAYERS, INJECT_FORWARD = 2, 300
INT8_PROMPTS, INT8_PROMPT_LEN, INT8_NEW, INT8_FORWARD = 8, 64, 32, 2048
# phases 31-32: Llama-3-8B's widths at TIERED_LAYERS of its 32 layers in
# bf16 under arena pressure (the whole script must finish in 1200 s: one
# H100 machine with a slow host took 1191 s with all 32 layers, and
# another 1191 s with 16, these phases taking 136 s of it).  One block of
# 16 tokens holds 2 x 8 layers x 8 kv heads x 128 x 2 B x 16 = 0.5 MiB of
# KV; the arena's 192 usable blocks (96 MiB) hold about half of what 12
# requests of 300-700 prompt tokens and 64 new tokens need (6,778 tokens,
# 424 blocks), so preemption spills, and a host cache of 64 MiB (128
# blocks, as 256 MiB held at 32 layers: about four spills) sends older
# spills to the disk tier.  The roomy
# arena holds 8 slots of the longest request (48 blocks each).  They come
# in three waves of rising SLO class (count, class, engine steps before the
# next wave): the standard wave's admissions spill batch requests, the
# realtime wave's spill again once those spills' disk writes have landed,
# so the host LRU drops the oldest to the disk tier; a roomy arena's 8
# slots take them without a preemption.
TIERED_LENS = [300, 700, 420, 650, 350, 560, 610, 480, 330, 690, 520, 400]
TIERED_WAVES = ((5, "batch", 50), (4, "standard", 40), (3, "realtime", 0))
TIERED_NEW = 64
TIERED_BLOCKS, TIERED_ROOMY_BLOCKS = 193, 8 * 48 + 1
TIERED_LAYERS = 8
TIERED_HOST_BYTES = 64 << 20
# bounded dispatch: the deadline is this many times the tiered run's median
# step (never below TIMEOUT_FLOOR_S), and the wedge takes the serve.step hit
# WEDGE_HIT, well after each phase's first (inline) dispatch
TIMEOUT_FACTOR, TIMEOUT_FLOOR_S = 8.0, 0.5
WEDGE_HIT = 60
# phase 34: phases 31-32's traffic at fp32 at this depth (the arena and the
# schedule as there, the host cache scaled with the block's bytes)
FP32_TIER_LAYERS = 4
# phase 33: sampled generate() at Llama-3-8B's widths, fp32 at 2 layers
# (TF32 off), where the kernel and plain paths agree to ~1e-6 and the same
# Gumbel noise must give the same tokens; batch x prompt, new tokens, T
SAMPLE_LAYERS, SAMPLE_BATCH, SAMPLE_PROMPT, SAMPLE_NEW, SAMPLE_T = 2, 4, 64, 32, 0.8


# one line at a time: the thread of phases 40-41 prints beside the main one
_SAY = threading.Lock()


def fail(msg: str) -> None:
    # on both streams: a caller that keeps only the end of one still reads why
    with _SAY:
        print(f"FAIL: {msg}", flush=True)
        print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    with _SAY:
        sys.stdout.write(msg + "\n")
        sys.stdout.flush()


# --------------------------------------------------------------------------- #
# timing
# --------------------------------------------------------------------------- #
def median_ms(fn, reps: int, flush=None) -> float:
    """Median device time of one call of ``fn`` by CUDA events, ``flush``
    run (untimed) before each call so the inputs come from HBM, not L2.
    A long sleep kernel queued first keeps the card busy while the host
    queues every call, so no event pair spans a wait for the host."""
    import torch
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(100_000_000)          # ~50 ms of device time
    for start, end in events:
        if flush is not None:
            flush()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def compare(out, ref):
    """(max abs error, max error scaled by max(1, |plain|))."""
    diff = (out.float() - ref.float()).abs()
    scaled = diff / ref.float().abs().clamp(min=1.0)
    return diff.max().item(), scaled.max().item()


def bound(nbytes: int, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------- #
def device_normal(rng, shapes, device):
    """Standard normal fp32 tensors of ``shapes``, drawn on ``device`` by a
    generator seeded from one draw of ``rng`` (drawing tens of millions of
    values on the host took a third of phases 3 and 21)."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(2 ** 62)))
    return [torch.randn(shape, generator=gen, device=device) for shape in shapes]


def paged_inputs(rng, B, Sq, lengths, dtype, device, heads=(H, H, D)):
    import torch
    Hq, Hkv, Dh = heads
    NB = B * MB + 1
    kp, vp, q = (t.to(dtype) for t in device_normal(
        rng, [(NB, BS, Hkv, Dh), (NB, BS, Hkv, Dh), (B, Sq, Hq, Dh)], device))
    ids = np.arange(1, NB, dtype=np.int32)
    rng.shuffle(ids)
    tables = ids[:B * MB].reshape(B, MB)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, torch.int32)
    return q, kp, vp, dev(tables), dev(np.asarray(lengths, np.int32))


def peaked_checks(dtype_name, scaled, kernel, exact, q):
    """The checks of one decode-kernel case: the error scaled by max(1,
    |plain|) against TOL and, in bf16, the relative L2 error at peaked
    scores (q * PEAKED_Q_STD) against ``exact`` (the plain version in fp32
    on the same inputs)."""
    import torch
    checks = [("err/max(1,|plain|)", scaled, TOL[dtype_name])]
    if dtype_name == "bfloat16":
        qq = q * PEAKED_Q_STD
        out, ref = kernel(qq), exact(qq)
        torch.cuda.synchronize()
        checks.append(("peaked err_2/|exact|_2",
                       ((out.float() - ref).norm() / ref.norm()).item(), PEAKED_L2_TOL))
    return checks


def sdpa_mask(keep, slopes, qpos, T, dtype):
    """SDPA's attn_mask for a causal ``keep`` ``[B or 1, S_q, T]``: the
    boolean mask itself, or with ALiBi the float bias slope_h * (k - q)
    with -inf where masked (``[B, H, S_q, T]``); None where nothing is
    masked and there is no ALiBi."""
    import torch
    if slopes is None:
        return None if bool(keep.all()) else keep[:, None]
    dist = (torch.arange(T, device=keep.device)[None, None, :] - qpos[:, :, None]).float()
    bias = slopes[None, :, None, None] * dist[:, None]
    return bias.masked_fill(~keep[:, None], float("-inf")).to(dtype)


def kernel_cases(device, flush, clean_flush, reps: int = 50, plain_reps: int = 10,
                 heads=KERNEL_HEADS):
    """Every model's head shape (``heads``) x case x dtype: error, times,
    bound.  Returns the result rows.  ``clean_flush`` is a read-only flush,
    for the second pair of times."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.attention import alibi_slopes
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da

    rng = np.random.default_rng(1234)
    decode_lengths = [0, 1, 15, 16, 17, 500, 299, MB * BS - 1]
    rows = []
    for model, (Hq, Hkv, Dh, alibi) in heads.items():
        prefix = "" if model == "gpt2-xl" else model + "-"
        slopes = torch.from_numpy(alibi_slopes(Hq)).to(device) if alibi else None
        for dtype_name, dtype in (("float32", torch.float32),
                                  ("bfloat16", torch.bfloat16)):
            esize = torch.tensor([], dtype=dtype).element_size()
            for case, B, Sq, lengths in (
                    ("paged-decode", 8, 1, decode_lengths),
                    ("paged-prefill", 1, 64, [MB * BS - 24])):  # len + 64 > MB*BS
                q, kp, vp, tables, lens = paged_inputs(rng, B, Sq, lengths, dtype, device,
                                                       (Hq, Hkv, Dh))

                def kernel(qq):
                    return da.paged_attention(qq, kp, vp, tables, lens, alibi=slopes)
                out = kernel(q)
                ref = da.paged_attention_reference(q, kp, vp, tables, lens, alibi=slopes)
                torch.cuda.synchronize()
                if not torch.isfinite(out).all():
                    fail(f"{prefix}{case} {dtype_name}: non-finite kernel output")
                err, scaled = compare(out, ref)
                checks = peaked_checks(
                    dtype_name, scaled, kernel,
                    lambda qq: da.paged_attention_reference(
                        qq.float(), kp.float(), vp.float(), tables, lens, alibi=slopes), q)
                # lower reference: SDPA over the cache gathered beforehand
                # (GQA as enable_gqa, ALiBi as a float attn_mask)
                T = MB * BS
                kt, vt = (pages[tables.long()].reshape(B, T, Hkv, Dh).transpose(1, 2)
                          .contiguous() for pages in (kp, vp))
                qt = q.transpose(1, 2).contiguous()
                qpos = lens.long()[:, None] + torch.arange(Sq, device=device)[None]
                keep = torch.arange(T, device=device)[None, None, :] <= qpos[:, :, None]
                mask = sdpa_mask(keep, slopes, qpos, T, dtype)
                gathered, gathered_clean = (median_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=Hkv != Hq), reps, fl)
                    for fl in (flush, clean_flush))
                clean = median_ms(lambda: kernel(q), reps, clean_flush)
                del kt, vt
                live = [min(n + Sq, MB * BS) for n in lengths]
                nbytes = (2 * sum(live) * Hkv * Dh * esize + 2 * q.numel() * esize
                          + tables.numel() * 4 + lens.numel() * 4)
                flops = 4.0 * sum(min(n + i + 1, MB * BS) for n in lengths
                                  for i in range(Sq)) * Hq * Dh
                b_ms, b_by = bound(nbytes, flops, dtype_name)
                rows.append(dict(
                    kernel="paged_attention", case=prefix + case, dtype=dtype_name, err=err,
                    scaled=scaled, checks=checks, ms=median_ms(lambda: kernel(q), reps, flush),
                    plain_ms=median_ms(lambda: da.paged_attention_reference(
                        q, kp, vp, tables, lens, alibi=slopes), plain_reps, flush),
                    bound_ms=b_ms, bound_by=b_by, library_ms=None,
                    note=f"H {Hq}, Hkv {Hkv}, D {Dh}{', ALiBi' if alibi else ''}; SDPA over "
                         f"the pre-gathered cache, gather untimed (a lower reference, not "
                         f"a library time): {gathered:.4f} ms; after a read-only flush: "
                         f"kernel {clean:.4f}, that SDPA {gathered_clean:.4f} ms"))
                del q, kp, vp
            for case, B, Sq, T, pos in CONTIGUOUS_CASES:
                q, ck, cv = (t.to(dtype) for t in device_normal(
                    rng, [(B, Sq, Hq, Dh), (B, T, Hkv, Dh), (B, T, Hkv, Dh)], device))

                def kernel(qq):
                    return da.decode_attention(qq, ck, cv, pos, alibi=slopes)
                out = kernel(q)
                ref = da.decode_attention_reference(q, ck, cv, pos, alibi=slopes)
                torch.cuda.synchronize()
                if not torch.isfinite(out).all():
                    fail(f"{prefix}{case} {dtype_name}: non-finite kernel output")
                err, scaled = compare(out, ref)
                checks = peaked_checks(
                    dtype_name, scaled, kernel,
                    lambda qq: da.decode_attention_reference(qq.float(), ck.float(),
                                                             cv.float(), pos, alibi=slopes), q)
                live = min(pos + Sq, T)
                nbytes = 2 * B * live * Hkv * Dh * esize + 2 * q.numel() * esize
                flops = 4.0 * B * sum(min(pos + i + 1, T) for i in range(Sq)) * Hq * Dh
                b_ms, b_by = bound(nbytes, flops, dtype_name)
                # yardstick: one SDPA call on the same inputs, with the causal
                # mask where it hides a column (and ALiBi as a float mask);
                # the port never calls it
                qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, ck, cv))
                qpos = pos + torch.arange(Sq, device=device)[None]
                keep = torch.arange(T, device=device)[None, None, :] <= qpos[:, :, None]
                mask = sdpa_mask(keep, slopes, qpos, T, dtype)
                lib, lib_clean = (median_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=Hkv != Hq), reps, fl)
                    for fl in (flush, clean_flush))
                clean = median_ms(lambda: kernel(q), reps, clean_flush)
                rows.append(dict(
                    kernel="decode_attention", case=prefix + case,
                    dtype=dtype_name, err=err, scaled=scaled, checks=checks,
                    ms=median_ms(lambda: kernel(q), reps, flush),
                    plain_ms=median_ms(lambda: da.decode_attention_reference(
                        q, ck, cv, pos, alibi=slopes), plain_reps, flush),
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                    note=f"H {Hq}, Hkv {Hkv}, D {Dh}{', ALiBi' if alibi else ''}; after a "
                         f"read-only flush: kernel {clean:.4f}, SDPA {lib_clean:.4f} ms"))
                del q, ck, cv, qt, kt, vt
            torch.cuda.empty_cache()
    report_rows(rows)
    return rows


# --------------------------------------------------------------------------- #
# phases 4-5: end to end
# --------------------------------------------------------------------------- #
def make_prompts(vocab: int, lens, seed: int = 7):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab, size=n)] for n in lens]


def serve(eng, prompts, new_tokens, on_step=None):
    """Submit the first six, step three times, submit the rest (staggered
    arrival), drive to completion.  Returns the futures."""
    def step():
        t0 = time.perf_counter()
        stats = eng.step()
        if on_step is not None:
            on_step(time.perf_counter() - t0, stats)

    futs = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts[:6]]
    for _ in range(3):
        step()
    futs += [eng.submit(p, max_new_tokens=new_tokens) for p in prompts[6:]]
    while eng.sched.has_work:
        step()
    return futs


def top2_gap(model, prefix) -> float:
    """generate()'s top-two logit gap for the token after ``prefix``."""
    import torch
    cfg = model.cfg
    ids = torch.tensor([prefix], device=model.device)
    cache = model.init_cache(1, len(prefix))
    logits, _ = model.apply_with_cache(ids, cache)
    last = logits[0, -1, :cfg.vocab_size]
    top = torch.topk(last, 2).values
    return float(top[0] - top[1])


def check_identity(model, prompts, futs, refs, label) -> int:
    """Token identity with generate(); returns the near-tie count."""
    ties = 0
    for i, (p, f, ref) in enumerate(zip(prompts, futs, refs)):
        got = f.token_ids
        if got == ref:
            continue
        k = next((j for j, (a, b) in enumerate(zip(got, ref)) if a != b),
                 min(len(got), len(ref)))
        gap = top2_gap(model, p + ref[:k])
        if gap > NEAR_TIE:
            fail(f"{label}: request {i} diverges at token {k} "
                 f"({got[k:k + 4]} vs {ref[k:k + 4]}), top-2 gap {gap:.3e} "
                 f"> {NEAR_TIE}")
        ties += 1
        say(f"{label}: request {i} near-tie at token {k} (gap {gap:.3e})")
    return ties


def kernel_modules():
    from deepspeed_tpu_torch.ops.cuda import block_sparse_attention as tbs
    from deepspeed_tpu_torch.ops.cuda import cross_entropy as tce
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    from deepspeed_tpu_torch.ops.cuda import flash_attention as tfa
    from deepspeed_tpu_torch.ops.cuda import fused_optim as tfo
    return da, tce, tfo, tfa, tbs


def read_counts():
    """(launches by kernel, calls by plain version)."""
    da, tce, tfo, tfa, tbs = kernel_modules()
    launches = {fn.__name__: fn.launches for fn in (
        da.paged_attention, da.decode_attention, tfa.flash_forward, tfa.flash_backward_dq,
        tfa.flash_backward_dkv, tce.ce_forward, tce.ce_backward_dx, tce.ce_backward_dhead,
        tfo.fused_adam, tbs.block_sparse_forward, tbs.block_sparse_backward_dq,
        tbs.block_sparse_backward_dkv)}
    plain = {fn.__name__: fn.calls for fn in (
        da.paged_attention_reference, da.decode_attention_reference,
        tfa.flash_forward_reference, tfa.flash_backward_dq_reference,
        tfa.flash_backward_dkv_reference, tce.ce_forward_reference,
        tce.ce_backward_dx_reference, tce.ce_backward_dhead_reference, tfo.adam_reference,
        tbs.block_sparse_forward_reference, tbs.block_sparse_backward_dq_reference,
        tbs.block_sparse_backward_dkv_reference)}
    return launches, plain


def counted(label: str, expect, run):
    """Zero every counter, ``run()``, read the counters at once.  ``expect``
    maps each kernel the run must launch to its exact count (None: at least
    once).  Fails if one of them is off, another kernel launched, or a
    plain version ran.  Returns (run's result, launches by kernel)."""
    for mod in kernel_modules():
        mod.reset_counts()
    result = run()
    counts, plain = read_counts()
    say(f"{label} launches: {json.dumps(counts)}; plain calls: {sum(plain.values())}")
    for kernel, n in counts.items():
        want = expect.get(kernel, 0)
        if (want is None and n <= 0) or (want is not None and n != want):
            fail(f"{label}: {kernel} launched {n} times, expected "
                 f"{'at least 1' if want is None else want}")
    if any(plain.values()):
        fail(f"{label}: plain versions ran on the card's path: {plain}")
    return result, counts


def phase_fp32(model, prompts, device, roomy_blocks: int, small_blocks: int,
               name: str = ""):
    import deepspeed_tpu_torch as dst

    tag = f"{name} " if name else ""
    refs, gen_counts = counted(f"{tag}fp32 generate()", {"decode_attention": None}, lambda: [
        model.generate([p], NEW_TOKENS)[0, len(p):].tolist() for p in prompts])
    results = {"generate": dict(counts=gen_counts), "refs": refs}
    for label, blocks in (("roomy", roomy_blocks), ("preempting", small_blocks)):
        eng = dst.init_serving(model=model, device=device, config={"serving": dict(
            SERVE_CFG, num_blocks=blocks, dtype="float32")})
        t0 = time.perf_counter()
        futs, counts = counted(f"{tag}fp32 serve ({label})", {"paged_attention": None},
                               lambda: serve(eng, prompts, NEW_TOKENS))
        wall = time.perf_counter() - t0
        ties = check_identity(model, prompts, futs, refs, f"{tag}fp32 {label}")
        pre = eng.sched.preemption_count
        say(f"{tag}fp32 serve ({label}, {blocks} blocks): {len(futs)} requests "
            f"token-identical to generate() except {ties} near-ties; "
            f"preemptions={pre}; {wall:.2f}s")
        if label == "preempting" and pre == 0:
            fail(f"{tag}the small arena did not force a preemption")
        eng.alloc.check_consistent()
        results[label] = dict(ties=ties, preemptions=pre, counts=counts)
        del eng
    return results


def first_decode_logits(model, prompt, attention: str, tok=None):
    """(token fed, the prefill's last logits, the logits of one decode step
    after it) through the paged step, with ``attention`` "kernel", "plain"
    (its plain version) or "exact" (the plain version in fp32 on the bf16
    inputs, rounded back).  The decode step feeds ``tok``, or by default
    the prefill's greedy token: give the other runs the kernel run's
    token, so a near-tie that flips the argmax does not compare two
    different steps."""
    import torch
    from deepspeed_tpu_torch.models import gpt as gpt_mod
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    from deepspeed_tpu_torch.serving.kv_cache import PagedKVAllocator, init_arena

    cfg, dev = model.cfg, model.device
    C = SERVE_CFG["prefill_chunk"]
    alloc = PagedKVAllocator(64, BS, MB)
    alloc.allocate("r", len(prompt) + 1)
    kp, vp = init_arena(cfg, 64, BS, dtype=cfg.dtype, device=dev)
    table = torch.from_numpy(alloc.block_table("r")[None]).to(dev)
    saved = gpt_mod.paged_attention
    def exact(q, kp, vp, tables, lengths, alibi=None):
        return da.paged_attention_reference(q.float(), kp.float(), vp.float(), tables,
                                            lengths, alibi=alibi).to(q.dtype)
    gpt_mod.paged_attention = {"kernel": da.paged_attention,
                               "plain": da.paged_attention_reference,
                               "exact": exact}[attention]
    try:
        for start in range(0, len(prompt), C):
            n = min(C, len(prompt) - start)
            ids = np.zeros((1, C), np.int64)
            ids[0, :n] = prompt[start:start + n]
            wb, wo = alloc.write_map("r", start, C, n_valid=n)
            logits, kp, vp = model.paged_step(
                torch.from_numpy(ids).to(dev),
                torch.tensor([start], dtype=torch.int32, device=dev), kp, vp,
                table, torch.from_numpy(wb[None]).to(dev),
                torch.from_numpy(wo[None]).to(dev))
        last = logits[0, n - 1]
        if tok is None:
            tok = int(gpt_mod.greedy_tokens(cfg, last))
        wb, wo = alloc.write_map("r", len(prompt), 1)
        logits, _, _ = model.paged_step(
            torch.tensor([[tok]], device=dev),
            torch.tensor([len(prompt)], dtype=torch.int32, device=dev), kp, vp,
            table, torch.from_numpy(wb[None]).to(dev),
            torch.from_numpy(wo[None]).to(dev))
        return tok, last, logits[0, 0]
    finally:
        gpt_mod.paged_attention = saved


def profile_decode(eng, prompts, card: str, steps: int = 8):
    """Device time by kernel over ``steps`` pure decode steps of a full
    batch (torch.profiler), and the device's busy share of the wall time
    (profiling adds host time, so the busy share reads low).  Returns
    (device ms a step, busy share, paged attention's ms a step, its share
    of device time), or None where the profiler recorded no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for p in prompts[:eng._config.max_batch_size]:
        eng.submit(p, max_new_tokens=steps + 4)
    while eng.sched.waiting or any(r.needs_prefill
                                   for r in eng.sched.active.values()):
        eng.step()
    torch.cuda.synchronize()
    # the device's activity alone: what follows reads only kernels, and the
    # host's ops (thousands a step) would cost seconds to parse
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    eng.run()
    # device-side events only: a CPU op's self device time repeats the time
    # of the kernels it launched
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows = sorted(((e.key, e.self_device_time_total) for e in device),
                  key=lambda r: -r[1])
    total = sum(t for _, t in rows)
    if not total:
        say("profile: the profiler recorded no device time (not measured)")
        return None
    launches = sum(e.count for e in device)
    paged = [e for e in device if "paged_decode_kernel" in e.key
             or "paged_prefill_kernel" in e.key]
    paged_us = sum(e.self_device_time_total for e in paged)
    say(f"profile: {steps} decode steps x {eng._config.max_batch_size} rows, "
        f"device busy {total / wall_us:.1%} of {wall_us / 1e3:.2f} ms wall "
        f"({total / steps / 1e3:.3f} ms device, {launches / steps:.0f} device "
        f"ops per step) [{card}]")
    say(f"profile: paged attention {paged_us / steps / 1e3:.4f} ms device per decode "
        f"step ({sum(e.count for e in paged) / steps:.0f} launches per step, "
        f"{paged_us / total:.1%} of device time) [{card}]")
    for name, t in rows[:6]:
        say(f"  {t / total:6.1%} {t / steps / 1e3:8.3f} ms/step  {name[:70]}")
    return (total / steps / 1e3, total / wall_us, paged_us / steps / 1e3, paged_us / total)


def phase_bf16(model, prompts, device, blocks: int, card: str, name: str = ""):
    import torch
    import deepspeed_tpu_torch as dst

    tag = f"{name} " if name else ""
    eng = dst.init_serving(model=model, device=device, config={"serving": dict(
        SERVE_CFG, num_blocks=blocks, dtype="bfloat16")})
    eng.submit(prompts[0][:20], max_new_tokens=4).result()    # warm-up
    finite = []
    inner = eng.module.paged_step

    def checked_step(*args):
        out = inner(*args)
        finite.append(torch.isfinite(out[0]).all())
        return out
    eng.module.paged_step = checked_step
    step_ms, decode_ms = [], []

    def on_step(dt, stats):
        step_ms.append(dt * 1e3)
        if stats["decode_batch"] and not stats["prefill_tokens"]:
            decode_ms.append(dt * 1e3)

    t0 = time.perf_counter()
    futs, counts = counted(f"{tag}bf16 serve", {"paged_attention": None},
                           lambda: serve(eng, prompts, NEW_TOKENS, on_step))
    wall = time.perf_counter() - t0
    if not all(bool(f) for f in finite):
        fail(f"{tag}non-finite logits in bf16 serving")
    ntok = sum(len(f.token_ids) for f in futs)
    if any(len(f.token_ids) != NEW_TOKENS for f in futs):
        fail(f"{tag}a bf16 request did not produce all its tokens")
    # every dispatch runs each layer's attention through the paged kernel
    per_dispatch = model.cfg.n_layer
    if counts["paged_attention"] != per_dispatch * len(finite):
        fail(f"{tag}bf16 serve: {counts['paged_attention']} paged launches in "
             f"{len(finite)} dispatches, expected {per_dispatch} per dispatch")
    ttft = [(f.request.first_token_at - f.request.arrival) * 1e3 for f in futs]
    say(f"{tag}bf16 serve: {len(futs)} requests, {ntok} tokens in {wall:.3f}s = "
        f"{ntok / wall:.1f} tokens/s; median TTFT {statistics.median(ttft):.1f} ms; "
        f"median decode step {statistics.median(decode_ms):.2f} ms "
        f"({len(decode_ms)} pure decode steps); {len(finite)} dispatches, "
        f"{per_dispatch} paged launches each, all logits finite [{card}]")
    profile = profile_decode(eng, prompts, card)
    serve_model = eng.module
    del eng
    # an MoE model's gate could route a token elsewhere on another path at a
    # near-tie: the plain and exact runs take the kernel run's routes
    from deepspeed_tpu_torch.moe.sharded_moe import route_log
    with route_log() as routes:
        tok, *kernel = first_decode_logits(serve_model, prompts[1], "kernel")
    with route_log(pinned=routes.choices) as plain_routes:
        plain = first_decode_logits(serve_model, prompts[1], "plain", tok=tok)[1:]
    with route_log(pinned=routes.choices) as exact_routes:
        exact = first_decode_logits(serve_model, prompts[1], "exact", tok=tok)[1:]
    if routes.choices:
        say(f"{tag}bf16 logit comparison pinned to the kernel run's routes over "
            f"{len(routes.choices)} gating calls: own routes that differ: plain attention "
            f"{plain_routes.differ()} (smallest gate margin {plain_routes.min_margin():.3e}), "
            f"exact attention {exact_routes.differ()} (smallest {exact_routes.min_margin():.3e})")

    def dist(a, b):
        return max((x - y).abs().max().item() for x, y in zip(a, b))
    err, noise = dist(kernel, plain), dist(plain, exact)
    tol = max(BF16_LOGIT_TOL, LOGIT_NOISE_FACTOR * noise)
    say(f"{tag}bf16 prefill's last and first decode step's logits (same token fed): "
        f"kernel vs plain attention max abs diff {err:.4f} (tol {tol:.4f}); plain vs "
        f"exact attention {noise:.4f}, kernel vs exact {dist(kernel, exact):.4f}; "
        f"|logits| max {plain[1].abs().max().item():.3f}")
    if not err <= tol:
        fail(f"{tag}bf16 logits differ by {err:.4f} > {tol:.4f}")
    return dict(tokens_per_s=ntok / wall, ttft_ms=statistics.median(ttft),
                decode_step_ms=statistics.median(decode_ms), counts=counts,
                profile=profile)


def phase_family(name: str, device, card: str):
    """Phases 13-14: one family at the widths of its published config,
    seeded weights.  fp32 (TF32 off) token identity of ``init_serving``
    with the port's ``generate()`` at FAMILY_CELLS' cut depth, roomy and
    preempting; then bf16 at full depth through ``init_serving`` (made in
    bf16 on the card, no fp32 copy), as phase 5, with peak memory."""
    import torch
    from deepspeed_tpu_torch.models import gpt as gpt_mod

    ctor, kw, fp32_layers = FAMILY_CELLS[name]
    make = getattr(gpt_mod, ctor)
    cfg = make(**dict(kw, n_layer=fp32_layers), dtype="float32")
    t0 = time.perf_counter()
    model = gpt_mod.GPT(cfg, device=device, seed=0)
    torch.cuda.synchronize()
    say(f"model: {name} fp32 at {fp32_layers} of {kw['n_layer']} layers (depth cut to fit "
        f"the fp32 run's time; widths as published) x {cfg.n_embd}, {cfg.n_head} heads over "
        f"{cfg.kv_heads} kv heads, head_dim {cfg.head_dim}, {cfg.position_encoding} "
        f"positions, {model.num_params() / 1e9:.3f}B params, seeded init in "
        f"{time.perf_counter() - t0:.1f}s")
    prompts = make_prompts(cfg.vocab_size, PROMPT_LENS)
    fp32 = phase_fp32(model, prompts, device, roomy_blocks=512, small_blocks=40, name=name)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)      # what earlier phases left
    cfg = make(**kw, dtype="bfloat16")
    t0 = time.perf_counter()
    model = gpt_mod.GPT(cfg, device=device, seed=0, param_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated(device) - before
    init_peak = torch.cuda.max_memory_allocated(device) - before
    say(f"model: {name} bf16 at full depth, {cfg.n_layer} layers, "
        f"{model.num_params() / 1e9:.3f}B params, {weights / 2 ** 30:.2f} GiB of weights, "
        f"init peak {init_peak / 2 ** 30:.2f} GiB (both above the {before / 2 ** 30:.2f} GiB "
        f"earlier phases held), seeded init in {time.perf_counter() - t0:.1f}s")
    bf16 = phase_bf16(model, prompts, device, blocks=512, card=card, name=name)
    peak = torch.cuda.max_memory_allocated(device) - before
    say(f"{name} bf16: peak device memory {peak / 2 ** 30:.2f} GiB allocated above the "
        f"{before / 2 ** 30:.2f} GiB earlier phases held "
        f"({torch.cuda.max_memory_reserved(device) / 2 ** 30:.2f} reserved in all) [{card}]")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(fp32=fp32, bf16=bf16, peak_gib=peak / 2 ** 30, n_layer=cfg.n_layer)


# --------------------------------------------------------------------------- #
# phase 6: the training kernels against their plain versions
# --------------------------------------------------------------------------- #
def build_info(log: str, entry: str):
    """(registers, spill store bytes, spill load bytes) of the kernel whose
    mangled name holds ``entry``, from ptxas's lines in the build log."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and entry in line:
            text = " ".join(lines[i:i + 6])
            regs = re.search(r"Used (\d+) registers", text)
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
            if regs and spills:
                return int(regs.group(1)), int(spills.group(1)), int(spills.group(2))
    fail(f"build log: no ptxas line for {entry}")


def report_rows(rows):
    """Print each kernel case with its checks, then fail if a check is past
    its tolerance.  A row without ``checks`` is held to TOL of max(1,
    |plain|)."""
    bad = []
    for r in rows:
        checks = r.get("checks") or [("err/max(1,|plain|)", r["scaled"], TOL[r["dtype"]])]
        lib = r["library_ms"]
        say(f"kernel {r['kernel']} case={r['case']} dtype={r['dtype']} "
            f"max_abs_err={r['err']:.3e} "
            + " ".join(f"{name}={val:.3e}(tol {tol:g})" for name, val, tol in checks)
            + f" ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) library_ms="
            f"{'null' if lib is None else format(lib, '.4f')}"
            + (f" [{r['note']}]" if r.get("note") else ""))
        bad += [f"{r['kernel']} {r['case']} {r['dtype']}: {name} {val:.3e} > {tol:g}"
                for name, val, tol in checks if not val <= tol]
    if bad:
        fail("; ".join(bad))


def ce_checks(name, dtype_name, out, ref, head, labels, gscale, vocab, width_scale=1.0):
    """(label, value, tolerance) of one cross-entropy output against the
    plain version with fp32 products (CE_* tolerances; the forward's and
    the softmax part's, which measure the fp32 rounding of the scores,
    times ``width_scale``)."""
    import torch
    diff = (out.float() - ref.float()).abs()
    if name == "ce_forward":
        return [("err/max(1,|plain|)",
                 (diff / ref.float().abs().clamp(min=1.0)).max().item(),
                 CE_FWD_TOL[dtype_name] * width_scale)]
    checks = [("err/max|plain|", diff.max().item() / ref.float().abs().max().item(),
               CE_GRAD_TOL[dtype_name])]
    if name == "ce_backward_dx":
        softmax = ref.float() + gscale * head[labels.long()].float()
        err = diff
    else:
        hit = torch.zeros(head.shape[0], dtype=torch.bool, device=head.device)
        hit[labels.long()] = True
        rows = ~hit & (torch.arange(head.shape[0], device=head.device) < vocab)
        softmax, err = ref.float()[rows], diff[rows]
    checks.append(("softmax-part err_2/|softmax|_2",
                   (err.norm() / softmax.norm()).item(),
                   CE_SOFTMAX_TOL[dtype_name] * width_scale))
    return checks


def flash_inputs(case: str, dtype, device, seed: int = 2024, cases=FLASH_CASES):
    """(q, k, v, do), bias, slopes, causal for one ``cases`` entry, drawn
    on the card from a seeded generator."""
    import torch
    from deepspeed_tpu_torch.ops.attention import alibi_slopes
    B, S, H, Hkv, causal, bias_kind, alibi, *head_dim = cases[case]
    D = head_dim[0] if head_dim else 64
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def randn(shape, std=1.0):
        return torch.randn(shape, generator=gen, device=device) * std
    q = randn((B, S, H, D), FLASH_Q_STD).to(dtype)
    k, v = (randn((B, S, Hkv, D)).to(dtype) for _ in range(2))
    do = randn((B, S, H, D)).to(dtype)
    bias = randn((1, H, S, S), 0.5) if bias_kind == "per-head" else None
    slopes = torch.from_numpy(alibi_slopes(H)).to(device) if alibi else None
    return (q, k, v, do), bias, slopes, causal


def flash_checks(pairs):
    """(label, value, tolerance) for each named (kernel out, plain out)."""
    checks, worst = [], 0.0
    for name, got, want, dtype_name in pairs:
        err = got.float() - want.float()
        worst = max(worst, err.abs().max().item())
        if name == "lse":
            checks.append(("lse err/max(1,|plain|)",
                           (err.abs() / want.abs().clamp(min=1.0)).max().item(), FLASH_LSE_TOL))
            continue
        max_tol, l2_tol = FLASH_TOL[dtype_name]
        checks.append((f"{name} err/max|plain|",
                       err.abs().max().item() / want.float().abs().max().item(), max_tol))
        checks.append((f"{name} err_2/|plain|_2", (err.norm() / want.float().norm()).item(),
                       l2_tol))
    return checks, worst


def flash_sdpa_mask(bias, slopes, causal, S, dtype, device):
    """SDPA's additive attn_mask for a flash case: the bias or ALiBi (with
    the causal mask as -inf) in q's dtype; None without either (SDPA's
    is_causal then masks)."""
    import torch
    if bias is None and slopes is None:
        return None
    pos = torch.arange(S, device=device)
    dist = (pos[None, :] - pos[:, None]).float()
    mask = bias if bias is not None else slopes[None, :, None, None] * dist[None, None]
    if causal:
        mask = mask.masked_fill(dist > 0, float("-inf"))
    return mask.to(dtype)


def flash_case_rows(case: str, cases, dtype_name: str, device, flush, card: str, reps: int,
                    plain_reps: int):
    """One case of ``cases``: the three flash kernels against their plain
    versions, with ``scaled_dot_product_attention`` (and its autograd
    backward, one call for dq, dk and dv) as the yardstick; three rows."""
    import torch
    import torch.nn.functional as F
    tfa = kernel_modules()[3]

    dtype = getattr(torch, dtype_name)
    B, S, H, Hkv, causal, *_ = cases[case]
    (q, k, v, do), bias, slopes, causal = flash_inputs(case, dtype, device, cases=cases)
    D = q.shape[-1]
    scale = 1.0 / D ** 0.5
    args = (q, k, v)
    extra = (bias, slopes, causal, scale)
    o, lse = tfa.flash_forward(*args, *extra)
    ro, rlse = tfa.flash_forward_reference(*args, *extra)
    delta = (ro.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    bargs = (q, k, v, do, rlse, delta) + extra
    dq = tfa.flash_backward_dq(*bargs)
    rdq = tfa.flash_backward_dq_reference(*bargs)
    dk, dv = tfa.flash_backward_dkv(*bargs)
    rdk, rdv = tfa.flash_backward_dkv_reference(*bargs)
    torch.cuda.synchronize()
    for t in (o, lse, dq, dk, dv):
        if not torch.isfinite(t.float()).all():
            fail(f"flash {case} {dtype_name}: non-finite kernel output")
    # yardstick: SDPA in its [B, H, S, D] layout, the bias or ALiBi (with
    # the causal mask) as an additive mask in q's dtype
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    mask = flash_sdpa_mask(bias, slopes, causal, S, dtype, device)

    def sdpa(a, b, c):
        return F.scaled_dot_product_attention(
            a, b, c, attn_mask=mask, is_causal=causal and mask is None, scale=scale,
            enable_gqa=Hkv != H)
    # as many calls as the plain versions get: in fp32, and with a mask,
    # SDPA runs its math path, whose calls take as long as theirs
    fwd_lib = median_ms(lambda: sdpa(qt, kt, vt), plain_reps, flush)
    lib_in = [t.detach().requires_grad_() for t in (qt, kt, vt)]
    lib_out = sdpa(*lib_in)
    bwd_lib = median_ms(lambda: torch.autograd.grad(lib_out, lib_in, dot, retain_graph=True),
                        plain_reps, flush)
    del lib_out, lib_in
    if case == "gpt2-train":
        # what auto would run here without flash: JAX's reference
        # attention in plain torch, forward and autograd backward
        from deepspeed_tpu_torch.ops.attention import reference_attention
        ref_in = [t.detach().requires_grad_() for t in (q, k, v)]
        ref_fwd = median_ms(lambda: reference_attention(*ref_in, causal=True), reps, flush)
        ref_out = reference_attention(*ref_in, causal=True)
        ref_bwd = median_ms(lambda: torch.autograd.grad(ref_out, ref_in, do, retain_graph=True),
                            reps, flush)
        say(f"reference attention at the path's shape ({dtype_name}): forward "
            f"{ref_fwd:.4f} ms, backward {ref_bwd:.4f} ms (one autograd call) [{card}]")
        del ref_out, ref_in
    esize = q.element_size()
    n_q, n_kv, n_row = q.numel(), k.numel(), B * H * S
    n_pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    bias_bytes = bias.numel() * 4 if bias is not None else 0
    specs = [
        ("flash_forward", [("o", o, ro), ("lse", lse, rlse)],
         lambda: tfa.flash_forward(*args, *extra),
         lambda: tfa.flash_forward_reference(*args, *extra),
         (2 * n_q + 2 * n_kv) * esize + 4 * n_row + bias_bytes, 4.0 * D * n_pairs,
         fwd_lib, "library: scaled_dot_product_attention forward"),
        ("flash_backward_dq", [("dq", dq, rdq)],
         lambda: tfa.flash_backward_dq(*bargs),
         lambda: tfa.flash_backward_dq_reference(*bargs),
         (3 * n_q + 2 * n_kv) * esize + 8 * n_row + bias_bytes, 6.0 * D * n_pairs,
         bwd_lib, "library: one SDPA autograd backward giving dq, dk and dv"),
        ("flash_backward_dkv", [("dk", dk, rdk), ("dv", dv, rdv)],
         lambda: tfa.flash_backward_dkv(*bargs),
         lambda: tfa.flash_backward_dkv_reference(*bargs),
         (2 * n_q + 4 * n_kv) * esize + 8 * n_row + bias_bytes, 8.0 * D * n_pairs,
         bwd_lib, "library: the same SDPA backward"),
    ]
    rows = []
    for name, outs, kern, plain, nbytes, flops, lib, note in specs:
        checks, worst = flash_checks([(o_name, got, want, dtype_name)
                                      for o_name, got, want in outs])
        b_ms, b_by = bound(nbytes, flops, dtype_name)
        rows.append(dict(
            kernel=name, case=case, dtype=dtype_name, err=worst, scaled=worst,
            checks=checks, ms=median_ms(kern, reps, flush),
            plain_ms=median_ms(plain, plain_reps, flush), bound_ms=b_ms,
            bound_by=b_by, library_ms=lib,
            note=note if D == 64 else f"H {H}, Hkv {Hkv}, D {D}; {note}"))
    return rows


def flash_cases(device, flush, card: str, reps: int = 20, plain_reps: int = 5):
    """The three flash kernels against their plain versions over
    FLASH_CASES, fp32 and bf16 (``flash_case_rows``)."""
    import torch
    rows = []
    for dtype_name in ("float32", "bfloat16"):
        for case in FLASH_CASES:
            rows += flash_case_rows(case, FLASH_CASES, dtype_name, device, flush, card, reps,
                                    plain_reps)
            torch.cuda.empty_cache()
        report_rows(rows[-3 * len(FLASH_CASES):])
    by = {(r["kernel"], r["case"], r["dtype"]): r for r in rows}
    for dtype_name in ("float32", "bfloat16"):
        fwd = by[("flash_forward", "gpt2-train", dtype_name)]
        dq = by[("flash_backward_dq", "gpt2-train", dtype_name)]
        dkv = by[("flash_backward_dkv", "gpt2-train", dtype_name)]
        say(f"flash gpt2-train {dtype_name}: forward {fwd['ms']:.4f} ms vs SDPA forward "
            f"{fwd['library_ms']:.4f}; dQ + dKV {dq['ms'] + dkv['ms']:.4f} ms vs one SDPA "
            f"backward {dq['library_ms']:.4f} [{card}]")
        ratios = {k: by[(k, "gpt2-train", dtype_name)]["ms"] / by[(k, "noncausal", dtype_name)]["ms"]
                  for k in ("flash_forward", "flash_backward_dq", "flash_backward_dkv")}
        say(f"flash causal / non-causal time ({dtype_name}, B 8, S 512): "
            + ", ".join(f"{k} {r:.3f}" for k, r in ratios.items()))
        for case in ("llama3-8b-train", "bloom-7b1-train"):
            fwd, dq, dkv = (by[(k, case, dtype_name)] for k in (
                "flash_forward", "flash_backward_dq", "flash_backward_dkv"))
            say(f"flash {case} {dtype_name} (head_dim 128): forward {fwd['ms']:.4f} ms (bound "
                f"{fwd['bound_ms']:.4f}, SDPA {fwd['library_ms']:.4f}); dQ {dq['ms']:.4f} + dKV "
                f"{dkv['ms']:.4f} ms (bounds {dq['bound_ms']:.4f} + {dkv['bound_ms']:.4f}) vs one "
                f"SDPA backward {dq['library_ms']:.4f} [{card}]")
    return rows


def wide_flash_cases(device, flush, card: str, reps: int = 20, plain_reps: int = 3):
    """Phase 21: the flash forward alone (the kernel that serves these
    widths) against its plain version over WIDE_FLASH_CASES, fp32 and bf16,
    one SDPA forward as the yardstick."""
    import torch
    import torch.nn.functional as F
    tfa = kernel_modules()[3]

    rows = []
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for case, (B, S, H, Hkv, *_) in WIDE_FLASH_CASES.items():
            (q, k, v, _), bias, slopes, causal = flash_inputs(case, dtype, device,
                                                              cases=WIDE_FLASH_CASES)
            D = q.shape[-1]
            extra = (bias, slopes, causal, 1.0 / D ** 0.5)
            o, lse = tfa.flash_forward(q, k, v, *extra)
            ro, rlse = tfa.flash_forward_reference(q, k, v, *extra)
            torch.cuda.synchronize()
            if not (torch.isfinite(o.float()).all() and torch.isfinite(lse).all()):
                fail(f"flash {case} {dtype_name}: non-finite kernel output")
            checks, worst = flash_checks([("o", o, ro, dtype_name), ("lse", lse, rlse, dtype_name)])
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            mask = flash_sdpa_mask(bias, slopes, causal, S, dtype, device)
            lib = median_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None, scale=extra[3],
                enable_gqa=Hkv != H), reps, flush)
            n_pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
            b_ms, b_by = bound((2 * q.numel() + 2 * k.numel()) * q.element_size()
                               + 4 * B * H * S, 4.0 * D * n_pairs, dtype_name)
            rows.append(dict(
                kernel="flash_forward", case=case, dtype=dtype_name, err=worst, scaled=worst,
                checks=checks, ms=median_ms(lambda: tfa.flash_forward(q, k, v, *extra), reps,
                                            flush),
                plain_ms=median_ms(lambda: tfa.flash_forward_reference(q, k, v, *extra),
                                   plain_reps, flush),
                bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                note=f"H {H}, Hkv {Hkv}, D {D}; library: scaled_dot_product_attention "
                     f"forward{' (enable_gqa)' if Hkv != H else ''}"))
            del q, k, v, o, lse, ro, rlse, qt, kt, vt
        torch.cuda.empty_cache()
    report_rows(rows)
    return rows


def wide_backward_cases(device, flush, card: str, reps: int = 10, plain_reps: int = 2):
    """Phase 25: flash dQ and dKV (and the forward) at head_dim 256 and 96
    against their plain versions over WIDE_BACKWARD_CASES, fp32 and bf16,
    with phase 6's tolerances and yardsticks (``flash_case_rows``), and the
    blocks per SM and shared memory of each dQ and dKV instantiation at
    those widths."""
    import torch
    tfa = kernel_modules()[3]
    rows = []
    for dtype_name in ("float32", "bfloat16"):
        for case in WIDE_BACKWARD_CASES:
            rows += flash_case_rows(case, WIDE_BACKWARD_CASES, dtype_name, device, flush, card,
                                    reps, plain_reps)
            torch.cuda.empty_cache()
    report_rows(rows)
    say("flash dQ / dKV at head_dim 96 and 256, blocks per SM x shared memory per block "
        "(occupancy query): " + ", ".join(
            "{} {}{} D{} {} x {} B".format(kern, dt_name, " extras" if extras else "", d,
                                          *tfa.kernel_occupancy(kern, dt, extras, d))
            for kern in ("dq", "dkv") for d in (96, 256)
            for dt_name, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32))
            for extras in (False, True)))
    by = {(r["kernel"], r["case"], r["dtype"]): r for r in rows}
    for case in ("gptj-6b-train", "neox-20b-train"):
        B, S, H, Hkv, *_, D = WIDE_BACKWARD_CASES[case]
        for dtype_name in ("bfloat16", "float32"):
            fwd, dq, dkv = (by[(k, case, dtype_name)] for k in (
                "flash_forward", "flash_backward_dq", "flash_backward_dkv"))
            say(f"flash {case} {dtype_name} (B {B}, S {S}, H {H}, D {D}): forward "
                f"{fwd['ms']:.4f} ms (bound {fwd['bound_ms']:.4f}, SDPA {fwd['library_ms']:.4f}); "
                f"dQ {dq['ms']:.4f} + dKV {dkv['ms']:.4f} ms (bounds {dq['bound_ms']:.4f} + "
                f"{dkv['bound_ms']:.4f}) vs one SDPA backward {dq['library_ms']:.4f} [{card}]")
    return rows


def sparse_layout(case: str) -> np.ndarray:
    """The [H, nb, nb] layout of one SPARSE_CASES entry."""
    from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
        sparsity_config_from_dict)
    _, S, H, block, _ = SPARSE_CASES[case]
    if block is not None:
        return sparsity_config_from_dict(block, num_heads=H).make_layout(S)
    layout = np.zeros((H, 4, 4), np.int32)
    layout[0, :2, :2] = 1                 # head 0: rows 2-3 list nothing
    layout[1, 0, 2] = 1                   # head 1: row 0 lists only future block 2
    layout[1, 1:, :2] = 1
    return layout


def sparse_pairs(layout: np.ndarray, causal: bool, bs: int) -> int:
    """(query, key) pairs a layout computes for one batch row: its listed
    blocks, under ``causal`` the diagonal's lower triangle and no future
    block (which the kernels skip)."""
    nb = layout.shape[-1]
    i, j = np.meshgrid(np.arange(nb), np.arange(nb), indexing="ij")
    per = np.where(np.logical_or(not causal, j < i), bs * bs,
                   np.where(j == i, bs * (bs + 1) // 2, 0))
    return int((layout * per[None]).sum())


def dkv_splits(row, kept, kargs, layout, causal, plain, flush, reps: int, card: str):
    """dKV at one case with the fixed split lengths of DKV_SPLITS (None: no
    column split), each held to the case's tolerances against the same
    plain outputs and timed beside the kept one (``kept``, what "auto"
    gave); one line."""
    import torch
    tbs = kernel_modules()[4]
    B = kargs[0].shape[0]
    times = {f"{tbs.DKV_SPLIT} = {kept}": row["ms"]}
    for split in DKV_SPLITS:
        work = tbs.dkv_work(layout, causal, B, kargs[0].device, kargs[0].dtype, split=split)
        out = tbs.block_sparse_backward_dkv(*kargs, work=work)
        torch.cuda.synchronize()
        checks, _ = flash_checks([(n, got, want, row["dtype"])
                                  for n, got, want in zip(("dk", "dv"), out, plain)])
        bad = [f"{n} {val:.3e} > {tol:g}" for n, val, tol in checks if not val <= tol]
        if bad:
            fail(f"block_sparse_backward_dkv split {split}: " + "; ".join(bad))
        times[split] = median_ms(lambda: tbs.block_sparse_backward_dkv(*kargs, work=work), reps,
                                 flush)
        del out, work
    say(f"block_sparse_backward_dkv {row['case']} {row['dtype']} by split length (ms; "
        f"kept first, None: no split): "
        + ", ".join(f"{sp} {ms:.4f}" for sp, ms in times.items()) + f" [{card}]")


def sparse_cases(device, flush, card: str, reps: int = 20, plain_reps: int = 3):
    """The three block-sparse kernels against their plain versions (with
    the kernel's rounding) over SPARSE_CASES, fp32 and bf16.  Yardsticks:
    ``scaled_dot_product_attention`` with the layout's dense boolean mask
    (forward; its autograd backward as one call against dQ + dKV), and the
    port's flash kernels at the same shape, the dense cost the layout is
    meant to cut."""
    import torch
    import torch.nn.functional as F
    _, _, _, tfa, tbs = kernel_modules()

    rows = []
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for case in SPARSE_CASES:
            B, S, H, _, causal = SPARSE_CASES[case]
            layout = sparse_layout(case)
            bs = S // layout.shape[-1]
            gen = torch.Generator(device=device)
            gen.manual_seed(2025)
            q = (torch.randn((B, S, H, 64), generator=gen, device=device) * FLASH_Q_STD).to(dtype)
            k, v, do = (torch.randn((B, S, H, 64), generator=gen, device=device).to(dtype)
                        for _ in range(3))
            row_lut, row_cnt, col_lut, col_cnt = tbs.device_luts(layout, device)
            scale = 1.0 / 8.0
            fargs = (q, k, v, row_lut, row_cnt, causal, scale)
            fwork = tbs.fwd_work(layout, causal, device)
            o, lse = tbs.block_sparse_forward(*fargs, work=fwork)
            ro, rlse = tbs.block_sparse_forward_reference(*fargs, kernel_rounding=True)
            delta = (ro.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
            qargs = (q, k, v, do, rlse, delta, row_lut, row_cnt, causal, scale)
            kargs = (q, k, v, do, rlse, delta, col_lut, col_cnt, causal, scale)
            work = tbs.dkv_work(layout, causal, B, device, dtype)
            split = tbs.dkv_split(layout, causal, B, device, dtype)
            dq = tbs.block_sparse_backward_dq(*qargs, work=fwork)
            rdq = tbs.block_sparse_backward_dq_reference(*qargs, kernel_rounding=True)
            dk, dv = tbs.block_sparse_backward_dkv(*kargs, work=work)
            rdk, rdv = tbs.block_sparse_backward_dkv_reference(*kargs, kernel_rounding=True)
            torch.cuda.synchronize()
            for t in (o, lse, dq, dk, dv):
                if not torch.isfinite(t.float()).all():
                    fail(f"sparse {case} {dtype_name}: non-finite kernel output")
            if case == "gpt2-s4096-fixed" and dtype == torch.bfloat16:
                # the JAX-literal plain version keeps p and ds in fp32: what
                # the kernel's bf16 rounding of them moves, for the record
                lo, _ = tbs.block_sparse_forward_reference(*fargs)
                ldq = tbs.block_sparse_backward_dq_reference(*qargs)
                ldk, ldv = tbs.block_sparse_backward_dkv_reference(*kargs)
                say("sparse gpt2-s4096-fixed bf16, kernel vs the JAX-literal plain version "
                    "(p, ds in fp32), err_2/|plain|_2: " + ", ".join(
                        f"{n} {((a.float() - b.float()).norm() / b.float().norm()).item():.3e}"
                        for n, a, b in (("o", o, lo), ("dq", dq, ldq), ("dk", dk, ldk),
                                        ("dv", dv, ldv))))
                del lo, ldq, ldk, ldv
            # yardstick: SDPA in its [B, H, S, D] layout under the dense mask
            # of the layout (and the causal triangle)
            keep = torch.from_numpy(layout).to(device).bool()
            keep = keep.repeat_interleave(bs, 1).repeat_interleave(bs, 2)[None]
            if causal:
                keep = keep & torch.ones(S, S, dtype=torch.bool, device=device).tril()
            qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))

            def sdpa(a, b, c):
                return F.scaled_dot_product_attention(a, b, c, attn_mask=keep, scale=scale)
            fwd_lib = median_ms(lambda: sdpa(qt, kt, vt), reps, flush)
            lib_in = [t.detach().requires_grad_() for t in (qt, kt, vt)]
            lib_out = sdpa(*lib_in)
            bwd_lib = median_ms(lambda: torch.autograd.grad(lib_out, lib_in, dot,
                                                            retain_graph=True), reps, flush)
            del lib_out, lib_in, keep, qt, kt, vt, dot
            # the port's flash kernels at the same shape (dense, causal or not)
            fo, flse = tfa.flash_forward(q, k, v, None, None, causal, scale)
            fdelta = (fo.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
            flash_fwd = median_ms(lambda: tfa.flash_forward(q, k, v, None, None, causal, scale),
                                  reps, flush)
            flash_bwd = median_ms(lambda: tfa.flash_block_bwd(
                q, k, v, do, flse, fdelta, causal=causal, scale=scale), reps, flush)
            flash_dq = median_ms(lambda: tfa.flash_backward_dq(
                q, k, v, do, flse, fdelta, None, None, causal, scale), reps, flush)
            del fo, flse, fdelta
            esize = q.element_size()
            n_q, n_row = q.numel(), B * H * S
            pairs = B * sparse_pairs(layout, causal, bs)
            lut_f = 4 * (fwork.tasks.numel() + fwork.entries.numel())   # the forward's work list
            lut_c = 4 * (work.tasks.numel() + work.entries.numel())     # dKV's work list
            specs = [
                ("block_sparse_forward", [("o", o, ro), ("lse", lse, rlse)],
                 lambda: tbs.block_sparse_forward(*fargs, work=fwork),
                 lambda: tbs.block_sparse_forward_reference(*fargs, kernel_rounding=True),
                 4 * n_q * esize + 4 * n_row + lut_f, 4.0 * 64 * pairs, fwd_lib,
                 f"library: SDPA forward under the dense mask; flash forward {flash_fwd:.4f}; "
                 f"{fwork.tasks.shape[0]} tasks x batch {B}, longest walk "
                 f"{int(fwork.tasks[0, 3])}"),
                ("block_sparse_backward_dq", [("dq", dq, rdq)],
                 lambda: tbs.block_sparse_backward_dq(*qargs, work=fwork),
                 lambda: tbs.block_sparse_backward_dq_reference(*qargs, kernel_rounding=True),
                 5 * n_q * esize + 8 * n_row + lut_f, 6.0 * 64 * pairs, bwd_lib,
                 f"library: one SDPA backward under the mask; flash dQ + dKV {flash_bwd:.4f}, "
                 f"flash dQ {flash_dq:.4f}"),
                ("block_sparse_backward_dkv", [("dk", dk, rdk), ("dv", dv, rdv)],
                 lambda: tbs.block_sparse_backward_dkv(*kargs, work=work),
                 lambda: tbs.block_sparse_backward_dkv_reference(*kargs, kernel_rounding=True),
                 6 * n_q * esize + 8 * n_row + lut_c, 8.0 * 64 * pairs, bwd_lib,
                 f"library: the same SDPA backward; split {tbs.DKV_SPLIT} = {split}, "
                 f"{work.tasks.shape[0]} tasks x batch {B}, workspace "
                 f"{work.workspace_bytes():,} B"),
            ]
            for name, outs, kern, plain, nbytes, flops, lib, note in specs:
                checks, worst = flash_checks([(o_name, got, want, dtype_name)
                                              for o_name, got, want in outs])
                b_ms, b_by = bound(nbytes, flops, dtype_name)
                rows.append(dict(
                    kernel=name, case=case, dtype=dtype_name, err=worst, scaled=worst,
                    checks=checks, ms=median_ms(kern, reps, flush),
                    plain_ms=median_ms(plain, plain_reps, flush), bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib, flash_fwd_ms=flash_fwd,
                    flash_bwd_ms=flash_bwd, flash_dq_ms=flash_dq,
                    live_tiles=B * fwork.entries.numel(),
                    note=note))
            # each dQ row is written by one block; dKV's split columns are
            # summed in split order and each launch leaves its counters at 0:
            # the timed calls above changed nothing
            dq2 = tbs.block_sparse_backward_dq(*qargs, work=fwork)
            if not torch.equal(dq, dq2):
                fail(f"block_sparse_backward_dq {case} {dtype_name}: two calls on the same "
                     "inputs differ")
            dk2, dv2 = tbs.block_sparse_backward_dkv(*kargs, work=work)
            if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
                fail(f"block_sparse_backward_dkv {case} {dtype_name}: two calls on the same "
                     "inputs differ")
            del dq2, dk2, dv2
            if dtype == torch.bfloat16:
                dkv_splits(rows[-1], split, kargs, layout, causal, (rdk, rdv), flush, reps, card)
            del o, lse, ro, rlse, dq, rdq, dk, dv, rdk, rdv
            torch.cuda.empty_cache()
        report_rows(rows[-3 * len(SPARSE_CASES):])
    by = {(r["kernel"], r["case"], r["dtype"]): r for r in rows}
    for dtype_name in ("float32", "bfloat16"):
        fwd, dq, dkv = (by[(k, "gpt2-s4096-fixed", dtype_name)] for k in (
            "block_sparse_forward", "block_sparse_backward_dq", "block_sparse_backward_dkv"))
        say(f"sparse gpt2-s4096-fixed {dtype_name}: forward {fwd['ms']:.4f} ms vs SDPA under "
            f"the mask {fwd['library_ms']:.4f} vs flash {fwd['flash_fwd_ms']:.4f}; dQ + dKV "
            f"{dq['ms'] + dkv['ms']:.4f} ms vs one SDPA backward {dq['library_ms']:.4f} vs "
            f"flash dQ + dKV {dq['flash_bwd_ms']:.4f} [{card}]")
    # sparse dQ's cost per live (head, batch) tile of 64 x 64 beside flash
    # dQ's at the same shape (causal: its tiles on or below the diagonal)
    for dtype_name in ("float32", "bfloat16"):
        parts = []
        for case in SPARSE_CASES:
            B, S, H, _, causal = SPARSE_CASES[case]
            r = by[("block_sparse_backward_dq", case, dtype_name)]
            nb = S // 64
            dense_tiles = B * H * (nb * (nb + 1) // 2 if causal else nb * nb)
            parts.append(f"{case} {1e6 * r['ms'] / r['live_tiles']:.2f} ns over "
                         f"{r['live_tiles']} tiles vs flash dQ "
                         f"{1e6 * r['flash_dq_ms'] / dense_tiles:.2f} ns over {dense_tiles} "
                         f"({r['ms']:.4f} vs {r['flash_dq_ms']:.4f} ms)")
        say(f"block_sparse_backward_dq {dtype_name} per live tile: " + "; ".join(parts)
            + f" [{card}]")
    return rows


def ce_cases(device, flush, reps: int = 20, plain_reps: int = 5):
    """The three cross-entropy kernels at GPT-2's training shape (N 4096 =
    micro 8 x seq 512, E 768, V 50304, vocab 50257), fp32 and bf16, in bf16
    at the other GPT-2 widths (CE_WIDTHS) and at the MoE cell's (N 8192 =
    micro 4 x seq 2048, E 1024), and the forward alone at the sparse step's
    N 8192.  Beside the forward, cuBLAS's ``x @
    head[:vocab]^T`` alone (and over the padded head, ``x @ head^T``): the
    least a library takes for the product the kernel fuses."""
    import torch
    import torch.nn.functional as F
    tce = kernel_modules()[1]

    N0, E0, V, vocab = CE_SHAPE
    runs = [("gpt2-train", N0, E0, "float32"), ("gpt2-train", N0, E0, "bfloat16")] + [
        (case, N0, E, "bfloat16") for case, E in CE_WIDTHS.items()] + [
        ("gpt2-s4096-sparse", CE_SPARSE_ROWS, E0, "bfloat16"),
        ("moe-350m-train", FAMILY_TRAIN_MICRO * FAMILY_TRAIN_SEQ, MOE_CELL["n_embd"],
         "bfloat16")]
    rows = []
    for case, N, E, dtype_name in runs:
        forward_only = case == "gpt2-s4096-sparse"
        rng = np.random.default_rng(4321)
        x32, h32 = device_normal(rng, [(N, E), (V, E)], device)
        h32 *= CE_HEAD_STD
        labels = torch.from_numpy(rng.integers(0, vocab, N).astype(np.int32)).to(device)
        gscale = torch.full((1,), 1.0 / N, device=device)
        dtype = getattr(torch, dtype_name)
        x, head = x32.to(dtype), h32.to(dtype)
        del x32, h32
        esize = x.element_size()
        k_reps = reps if dtype == torch.bfloat16 else max(3, reps // 4)
        nll, lse = tce.ce_forward(x, head, labels, vocab)
        rnll, rlse = tce.ce_forward_reference(x, head, labels, vocab, fp32_products=True)
        args = (x, head, labels, rlse, gscale, vocab)
        outs = {"ce_forward": (torch.stack([nll, lse]), torch.stack([rnll, rlse]))}
        if not forward_only:
            outs["ce_backward_dx"] = (tce.ce_backward_dx(*args),
                                      tce.ce_backward_dx_reference(*args, fp32_products=True))
            outs["ce_backward_dhead"] = (tce.ce_backward_dhead(*args),
                                         tce.ce_backward_dhead_reference(*args,
                                                                         fp32_products=True))
        del rnll, rlse
        torch.cuda.synchronize()
        product_ms = median_ms(lambda: x @ head[:vocab].T, k_reps, flush)
        padded_ms = median_ms(lambda: x @ head.T, k_reps, flush)
        # yardstick: x @ head^T over the real vocab, then F.cross_entropy (two
        # calls), and one autograd backward that gives dx and dhead together
        xr = x.detach().requires_grad_()
        hr = head[:vocab].detach().requires_grad_()
        lab64 = labels.long()
        fwd_lib = median_ms(lambda: F.cross_entropy(xr @ hr.T, lab64), k_reps, flush)
        loss = F.cross_entropy(xr @ hr.T, lab64)
        bwd_lib = None if forward_only else median_ms(
            lambda: torch.autograd.grad(loss, (xr, hr), retain_graph=True), k_reps, flush)
        io = N * E * esize + V * E * esize + N * 4 + N * 4      # x, head, labels, lse
        # kernel and plain (the module's own, JAX's unchunked branch) timings
        specs = {
            "ce_forward": (lambda: tce.ce_forward(x, head, labels, vocab),
                           lambda: tce.ce_forward_reference(x, head, labels, vocab),
                           io + N * 4, 2.0 * N * E * V, fwd_lib, "library: matmul + "
                           "F.cross_entropy, two calls"),
            "ce_backward_dx": (lambda: tce.ce_backward_dx(*args),
                               lambda: tce.ce_backward_dx_reference(*args),
                               io + N * E * esize, 4.0 * N * E * V, bwd_lib,
                               "library: one autograd backward giving dx and dhead"),
            "ce_backward_dhead": (lambda: tce.ce_backward_dhead(*args),
                                  lambda: tce.ce_backward_dhead_reference(*args),
                                  io + V * E * esize, 4.0 * N * E * V, bwd_lib,
                                  "library: one autograd backward giving dx and dhead"),
        }
        specs["ce_forward"] = specs["ce_forward"][:5] + (
            specs["ce_forward"][5] + f"; product-only {product_ms:.4f} (x @ head[:vocab]^T), "
            f"{padded_ms:.4f} (x @ head^T, V {V})",)
        for name, (kern, plain, nbytes, flops, lib, note) in specs.items():
            if name not in outs:
                continue
            out, ref = outs[name]
            if not torch.isfinite(out.float()).all():
                fail(f"{name} {dtype_name}: non-finite kernel output")
            err, scaled = compare(out, ref)
            b_ms, b_by = bound(nbytes, flops, dtype_name)
            rows.append(dict(
                kernel=name, case=case, dtype=dtype_name, err=err, scaled=scaled,
                checks=ce_checks(name, dtype_name, out, ref, head, labels, gscale, vocab),
                ms=median_ms(kern, k_reps, flush), plain_ms=median_ms(plain, plain_reps, flush),
                bound_ms=b_ms, bound_by=b_by, library_ms=lib, note=note,
                product_ms=product_ms if name == "ce_forward" else None))
        del xr, hr, loss, outs, x, head
        torch.cuda.empty_cache()
    return rows


def fp64_distance(x, head, labels, lse, gscale, dx, rdx, klse, card: str) -> None:
    """Print how far the kernel's and the plain version's lse (``klse``,
    ``lse``: their relative errors) and dx (given the plain lse; in the
    softmax part's norm) are from the same computed in fp64 on the same
    inputs."""
    import torch
    logits = x.double() @ head.double().T
    exact_lse = torch.logsumexp(logits, -1)
    lse_err = [((t.double() - exact_lse).abs() / exact_lse.abs().clamp(min=1.0)).max().item()
               for t in (klse, lse)]
    ds = torch.exp(logits - lse.double()[:, None])
    del logits
    ds[torch.arange(x.shape[0], device=x.device), labels.long()] -= 1.0
    exact = (ds * gscale.double()) @ head.double()
    del ds
    softmax = exact + gscale.double() * head[labels.long()].double()
    say("cross-entropy {} at N {}, E {}, V {}, distance from fp64: lse kernel {:.3e}, plain "
        "{:.3e}; dx's softmax part kernel {:.3e}, plain {:.3e} [{}]".format(
            str(x.dtype).split(".")[-1], x.shape[0], x.shape[1], head.shape[0], *lse_err,
            ((dx.double() - exact).norm() / softmax.norm()).item(),
            ((rdx.double() - exact).norm() / softmax.norm()).item(), card))


def ce_family_cases(device, flush, card: str, reps: int = 5, fp32_reps: int = 1):
    """The three cross-entropy kernels at the families' training shape
    (N 8192 = micro 4 x seq 2048, E 4096: the backward's wide path) over
    CE_FAMILY_VOCABS, with and without a head bias, bf16 (and fp32 for the
    cases of CE_FAMILY_FP32), against
    the plain versions with fp32 products, phase 6's CE_* tolerances (the
    forward's and the softmax part's times CE_FAMILY_WIDTH_SCALE; the bias
    gradient held as dhead is); beside each, ``x @ head^T (+ b)`` and
    ``F.cross_entropy`` and their autograd backward.  Each bf16 wide
    backward runs twice and must give bitwise-equal dx and dhead (and
    dbias), and each call must make the launches ``launches_per_call``
    counts."""
    import torch
    import torch.nn.functional as F
    tce = kernel_modules()[1]

    N, E = FAMILY_TRAIN_MICRO * FAMILY_TRAIN_SEQ, 4096
    rows = []
    for cell, V in CE_FAMILY_VOCABS.items():
        for bias in (False, True):
            dtypes = (("float32", "bfloat16") if (cell, bias) in CE_FAMILY_FP32
                      else ("bfloat16",))
            for dtype_name in dtypes:
                dtype = getattr(torch, dtype_name)
                case = f"{cell}-train" + ("-bias" if bias else "")
                gen = torch.Generator(device=device)
                gen.manual_seed(4321)
                x = torch.randn((N, E), generator=gen, device=device).to(dtype)
                head = (torch.randn((V, E), generator=gen, device=device)
                        * CE_FAMILY_HEAD_STD).to(dtype)
                labels = torch.randint(0, V, (N,), generator=gen, device=device,
                                       dtype=torch.int32)
                b = ((torch.randn(V, generator=gen, device=device) * 0.5).to(dtype)
                     if bias else None)
                gscale = torch.full((1,), 1.0 / N, device=device)
                esize = x.element_size()
                k_reps = reps if dtype == torch.bfloat16 else fp32_reps
                per_call = tce.launches_per_call(N, E, V, dtype, bias=bias)
                tce.reset_counts()
                nll, lse = tce.ce_forward(x, head, labels, V, head_b=b)
                rnll, rlse = tce.ce_forward_reference(x, head, labels, V, fp32_products=True,
                                                      head_b=b)
                # each backward kernel against its plain version on the same lse
                args = (x, head, labels, rlse, gscale, V)
                dx = tce.ce_backward_dx(*args, head_b=b)
                dh = tce.ce_backward_dhead(*args, head_b=b)
                torch.cuda.synchronize()
                launches = (tce.ce_forward.launches, tce.ce_backward_dx.launches,
                            tce.ce_backward_dhead.launches)
                if launches != (1, per_call, per_call):
                    fail(f"cross-entropy {case} {dtype_name}: launches {launches}, expected "
                         f"(1, {per_call}, {per_call})")
                if dtype == torch.bfloat16:     # the wide backward is deterministic
                    again = (tce.ce_backward_dx(*args, head_b=b),
                             tce.ce_backward_dhead(*args, head_b=b))
                    first = [dx] + (list(dh) if bias else [dh])
                    second = [again[0]] + (list(again[1]) if bias else [again[1]])
                    same = all(torch.equal(u, w) for u, w in zip(first, second))
                    say(f"cross-entropy {case} bf16: a second backward is bitwise equal: {same}")
                    if not same:
                        fail(f"cross-entropy {case}: the wide backward is not deterministic")
                    del again, first, second
                outs = {"ce_forward": (torch.stack([nll, lse]), torch.stack([rnll, rlse])),
                        "ce_backward_dx": (dx, tce.ce_backward_dx_reference(
                            *args, fp32_products=True, head_b=b))}
                rdh = tce.ce_backward_dhead_reference(*args, fp32_products=True, head_b=b)
                extra = []
                if bias:
                    (dh, db), (rdh, rdb) = dh, rdh
                    extra = [("dbias err/max|plain|", (db.float() - rdb.float()).abs().max().item()
                              / rdb.float().abs().max().item(), CE_GRAD_TOL[dtype_name])]
                outs["ce_backward_dhead"] = (dh, rdh)
                if not bias and cell == "llama3-8b":
                    fp64_distance(x, head, labels, rlse, gscale, dx, outs["ce_backward_dx"][1],
                                  lse, card)
                del rnll, nll, lse
                torch.cuda.synchronize()
                # yardstick: the logits by cuBLAS (plus the bias), F.cross_entropy,
                # and one autograd backward giving dx and dhead (and dbias)
                xr, hr = x.detach().requires_grad_(), head.detach().requires_grad_()
                br = b.detach().requires_grad_() if bias else None
                lab64 = labels.long()

                def lib_loss():
                    logits = xr @ hr.T
                    return F.cross_entropy(logits + br if bias else logits, lab64)
                fwd_lib = median_ms(lib_loss, k_reps, flush)
                loss = lib_loss()
                leaves = (xr, hr) + ((br,) if bias else ())
                bwd_lib = median_ms(lambda: torch.autograd.grad(loss, leaves, retain_graph=True),
                                    k_reps, flush)
                del loss
                io = N * E * esize + V * E * esize + N * 4 + N * 4 + (V * esize if bias else 0)
                specs = {
                    "ce_forward": (lambda: tce.ce_forward(x, head, labels, V, head_b=b),
                                   lambda: tce.ce_forward_reference(x, head, labels, V,
                                                                    head_b=b),
                                   io + N * 4, 2.0 * N * E * V, fwd_lib,
                                   "library: matmul + F.cross_entropy"),
                    "ce_backward_dx": (lambda: tce.ce_backward_dx(*args, head_b=b),
                                       lambda: tce.ce_backward_dx_reference(*args, head_b=b),
                                       io + N * E * esize, 4.0 * N * E * V, bwd_lib,
                                       "library: one autograd backward giving dx and dhead"),
                    "ce_backward_dhead": (lambda: tce.ce_backward_dhead(*args, head_b=b),
                                          lambda: tce.ce_backward_dhead_reference(*args,
                                                                                 head_b=b),
                                          io + V * E * esize, 4.0 * N * E * V, bwd_lib,
                                          "library: the same autograd backward"),
                }
                for name, (kern, plain, nbytes, flops, lib, note) in specs.items():
                    out, ref = outs[name]
                    if not torch.isfinite(out.float()).all():
                        fail(f"{name} {case} {dtype_name}: non-finite kernel output")
                    err, scaled = compare(out, ref)
                    checks = ce_checks(name, dtype_name, out, ref, head, labels, gscale, V,
                                       CE_FAMILY_WIDTH_SCALE)
                    if name == "ce_backward_dhead":
                        checks += extra
                    b_ms, b_by = bound(nbytes, flops, dtype_name)
                    rows.append(dict(
                        kernel=name, case=case, dtype=dtype_name, err=err, scaled=scaled,
                        checks=checks, ms=median_ms(kern, k_reps, flush),
                        plain_ms=median_ms(plain, 1, flush), bound_ms=b_ms, bound_by=b_by,
                        library_ms=lib, note=note + f"; {per_call if name != 'ce_forward' else 1}"
                        f" launches a call"))
                del xr, hr, br, outs, x, head, b, dx, dh, rdh, args, rlse
                torch.cuda.empty_cache()
            report_rows(rows[-3 * len(dtypes):])
    return rows


def adam_case(device, flush, reps: int = 20, plain_reps: int = 3):
    """The fused AdamW kernel over all 148 GPT-2 leaves at seq 512 (fp32
    params, grads and moments, a mid-training state), bit for bit against
    the plain version; ``torch._fused_adamw_`` on the same leaves is the
    yardstick (the port never calls it)."""
    import torch
    from deepspeed_tpu_torch.models.gpt import gpt_config, init_gpt_params
    tfo = kernel_modules()[2]

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    tree = init_gpt_params(gpt_config("gpt2", n_positions=TRAIN_SEQ), gen)
    params = [tree[k] for k in ("wte", "wpe", "lnf_g", "lnf_b")] + [
        t for blk in tree["blocks"] for t in blk.values()]

    def randn_like(p, scale):
        return torch.randn(p.shape, generator=gen, device=device) * scale
    grads = [randn_like(p, 1e-3) for p in params]
    mus = [randn_like(p, 1e-4) for p in params]
    nus = [randn_like(p, 1e-3).square() for p in params]
    spec = tfo.spec_from_config("adamw", {"weight_decay": 0.01}, 1e-4)
    neg_lr, bc1, bc2 = tfo.step_scalars(spec, torch.tensor(10, dtype=torch.int32,
                                                           device=device))
    scal = torch.stack([torch.tensor(0.5, device=device), torch.tensor(0.7, device=device),
                        neg_lr, bc1, bc2])
    kw = dict(b1=spec["b1"], b2=spec["b2"], eps=spec["eps"], wd=spec["wd"])

    def clone(ts):
        return [t.clone() for t in ts]
    a = [clone(params), grads, clone(mus), clone(nus)]
    b = [clone(params), grads, clone(mus), clone(nus)]
    table = tfo.AdamTable(*a)
    tfo.fused_adam(table, scal, **kw)
    tfo.adam_reference(*b, scal, **kw)
    torch.cuda.synchronize()
    mismatches = sum(int((x != y).sum()) for xs, ys in zip(a, b) for x, y in zip(xs, ys))
    err = max((x - y).abs().max().item() for xs, ys in zip(a, b) for x, y in zip(xs, ys))
    n = table.numel()
    say(f"fused_adam: {len(params)} leaves, {n:,} values; {mismatches} elements differ from "
        f"the plain version (bitwise contract)")
    if len(params) != 148 or n != TRAIN_PARAMS:
        fail(f"fused_adam: expected 148 leaves and {TRAIN_PARAMS:,} values, got "
             f"{len(params)} and {n:,}")
    if mismatches:
        fail(f"fused_adam: {mismatches} elements differ from the plain version")
    # the engine's layout: the gradients as views into one flat buffer
    # (runtime/engine.py), every GPT-2 leaf a multiple of 4 elements, so
    # every view stays 16-byte aligned
    sizes = [g.numel() for g in grads]
    flat = torch.cat([g.reshape(-1) for g in grads])
    flat_grads = [piece.view(g.shape) for piece, g in zip(torch.split(flat, sizes), grads)]
    fa = [clone(params), flat_grads, clone(mus), clone(nus)]
    fb = [clone(params), flat_grads, clone(mus), clone(nus)]
    flat_table = tfo.AdamTable(*fa)
    tfo.fused_adam(flat_table, scal, **kw)
    tfo.adam_reference(*fb, scal, **kw)
    torch.cuda.synchronize()
    flat_mismatches = sum(int((x != y).sum()) for xs, ys in zip(fa, fb) for x, y in zip(xs, ys))
    scalar = int((flat_table.chunks[:, 1] == 0).sum())
    say(f"fused_adam, flat gradient views (the engine's layout): {flat_mismatches} elements "
        f"differ from the plain version; {flat_table.n_chunks} chunks ({scalar} scalar) over "
        f"a grid of {table.grid} blocks")
    if flat_mismatches:
        fail(f"fused_adam, flat gradient views: {flat_mismatches} elements differ from the "
             "plain version")
    del fa, fb, flat_table
    lib_p, lib_m, lib_v = clone(params), clone(mus), clone(nus)
    steps = [torch.tensor(10.0, device=device) for _ in params]
    lib = median_ms(lambda: torch._fused_adamw_(
        lib_p, grads, lib_m, lib_v, [], steps, lr=1e-4, beta1=0.9, beta2=0.999,
        weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False), reps, flush)
    b_ms, b_by = bound(28 * n, 20.0 * n, "float32")
    return [dict(kernel="fused_adam", case="gpt2-148-leaves", dtype="float32", err=err,
                 scaled=err, ms=median_ms(lambda: tfo.fused_adam(table, scal, **kw), reps,
                                          flush),
                 plain_ms=median_ms(lambda: tfo.adam_reference(*b, scal, **kw), plain_reps,
                                    flush),
                 bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                 note="library: torch._fused_adamw_ on the same leaves")]


def adam_moe_case(device, flush, reps: int = 5, plain_reps: int = 2):
    """The fused AdamW kernel over the 13 leaves of one block of the MoE
    cell (1,078,730,752 fp32 values; the bank's wi and wo 536,870,912 each,
    the training run's largest leaves), bit for bit against the plain
    version, ``torch._fused_adamw_`` as the yardstick."""
    import torch
    from deepspeed_tpu_torch.models import gpt as gpt_mod
    tfo = kernel_modules()[2]

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    cfg = moe_config(1, "float32")
    block = gpt_mod._init_block(cfg, gen)
    params = [gpt_mod.get_leaf(block, k) for k in gpt_mod.block_keys(cfg)]

    def randn_like(p, scale):
        return torch.randn(p.shape, generator=gen, device=device) * scale
    grads = [randn_like(p, 1e-3) for p in params]
    mus = [randn_like(p, 1e-4) for p in params]
    nus = [randn_like(p, 1e-3).square() for p in params]
    spec = tfo.spec_from_config("adamw", {"weight_decay": 0.01}, 1e-4)
    neg_lr, bc1, bc2 = tfo.step_scalars(spec, torch.tensor(10, dtype=torch.int32,
                                                           device=device))
    scal = torch.stack([torch.tensor(0.5, device=device), torch.tensor(0.7, device=device),
                        neg_lr, bc1, bc2])
    kw = dict(b1=spec["b1"], b2=spec["b2"], eps=spec["eps"], wd=spec["wd"])
    a = [[t.clone() for t in ts] for ts in (params, mus, nus)]
    a.insert(1, grads)
    b = [params, grads, mus, nus]            # the originals: no second copy in memory
    table = tfo.AdamTable(*a)
    tfo.fused_adam(table, scal, **kw)
    tfo.adam_reference(*b, scal, **kw)
    torch.cuda.synchronize()
    mismatches = sum(int((x != y).sum()) for xs, ys in zip(a, b) for x, y in zip(xs, ys))
    err = max((x - y).abs().max().item() for xs, ys in zip(a, b) for x, y in zip(xs, ys))
    n = table.numel()
    say(f"fused_adam (moe-350m block): {len(params)} leaves, {n:,} values, largest "
        f"{max(p.numel() for p in params):,}; {mismatches} elements differ from the plain "
        f"version (bitwise contract)")
    if mismatches:
        fail(f"fused_adam (moe-350m block): {mismatches} elements differ from the plain version")
    steps = [torch.tensor(10.0, device=device) for _ in params]
    lib = median_ms(lambda: torch._fused_adamw_(
        a[0], grads, a[2], a[3], [], steps, lr=1e-4, beta1=0.9, beta2=0.999,
        weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False), reps, flush)
    b_ms, b_by = bound(28 * n, 20.0 * n, "float32")
    row = dict(kernel="fused_adam", case="moe-350m-block", dtype="float32", err=err,
               scaled=err, ms=median_ms(lambda: tfo.fused_adam(table, scal, **kw), reps, flush),
               plain_ms=median_ms(lambda: tfo.adam_reference(*b, scal, **kw), plain_reps, flush),
               bound_ms=b_ms, bound_by=b_by, library_ms=lib,
               note="library: torch._fused_adamw_ on the same leaves")
    del a, b, table, params, grads, mus, nus
    torch.cuda.empty_cache()
    return [row]


# --------------------------------------------------------------------------- #
# phases 7-8: training end to end
# --------------------------------------------------------------------------- #
def adam_launches(engine) -> int:
    """AdamW launches a step: one, or one a chunk of the ZeRO optimizer."""
    return len(getattr(engine.optimizer, "chunks", [None]))


def train_engine(model, config, device):
    import deepspeed_tpu_torch as dst
    engine, _, _, _ = dst.initialize(model=model, config=config, device=device, seed=0)
    engine.tput_timer.start_step = 10 ** 12     # no device drain inside the timed steps
    return engine


def train_batch_of(vocab: int, device, seq: int = TRAIN_SEQ, micro: int = TRAIN_MICRO,
                   seed: int = 0):
    import torch
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(0, vocab, (1, micro, seq))
                           .astype(np.int32)).to(device)
    return ids, ids


def eager_step(engine, batch):
    """One optimizer step through the eager micro-step API (``forward``,
    ``backward`` and ``step`` per micro-batch): the kernels of the graphed
    ``train_batch``, launched one by one from Python.  The mean loss."""
    ids, labels = batch
    gas = engine.gradient_accumulation_steps()
    total = None
    for i in range(gas):
        loss = engine.forward(ids[i], labels[i])
        engine.backward(loss)
        engine.step()
        total = loss.detach() if total is None else total + loss.detach()
    return total / gas


def timed_steps(step, n: int):
    """``n`` calls of ``step``: (results, host ms to queue each, wall ms of
    each to the device's drain)."""
    import torch
    out, host, wall = [], [], []
    for _ in range(n):
        t0 = time.perf_counter()
        out.append(step())
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    return out, host, wall


def register_sparse_attention() -> None:
    """``attn_impl="block_sparse"``: the ds_config block -> SparsityConfig
    -> SparseSelfAttention at max_seq_length 4096, behind the attention
    contract, registered as a user of the package does it (the package has
    no such adapter, as the JAX package has none)."""
    from deepspeed_tpu_torch.ops.attention import register_attention
    from deepspeed_tpu_torch.ops.sparse_attention import SparseSelfAttention
    from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
        sparsity_config_from_dict)
    module = SparseSelfAttention(
        sparsity_config_from_dict(SPARSE_TRAIN_CFG["sparse_attention"], num_heads=12),
        max_seq_length=SPARSE_SEQ)

    def block_sparse(q, k, v, *, causal, bias=None, alibi=None):
        if bias is not None or alibi is not None:
            raise NotImplementedError("block-sparse attention takes no bias or ALiBi slopes")
        return module(q, k, v)
    register_attention("block_sparse", block_sparse)


def train_expect(attn_impl: str, seq: int, layers: int, steps: int, plain: bool = False,
                 ce_launches: int = 1, adam_launches: int = 1):
    """Exact launches of ``steps`` steps of one micro-step each (or, with
    ``plain``, calls of the plain versions): the attention kernels once per
    layer per step (the sparse forward twice: remat saves nothing of it),
    the cross-entropy kernels once per step (the backward's ``ce_launches``
    each on the wide path: ``launches_per_call``), AdamW ``adam_launches``
    times (once, or once a chunk of offloaded state)."""
    from deepspeed_tpu_torch.ops.attention import XLA_FUSED_MAX_SEQ
    n = layers * steps
    bwd = steps * (1 if plain else ce_launches)
    want = {"ce_forward": steps, "ce_backward_dx": bwd, "ce_backward_dhead": bwd,
            "fused_adam": steps * adam_launches}
    if attn_impl == "block_sparse":
        want.update(block_sparse_forward=2 * n, block_sparse_backward_dq=n,
                    block_sparse_backward_dkv=n)
    elif attn_impl == "flash" or (attn_impl == "auto" and seq > XLA_FUSED_MAX_SEQ):
        want.update(flash_forward=n, flash_backward_dq=n, flash_backward_dkv=n)
    if plain:
        want = {("adam_reference" if k == "fused_adam" else k + "_reference"): count
                for k, count in want.items()}
    return want


class KeptGraphs:
    """An engine's accelerator whose graphs keep their ``cudaGraph_t``
    (``keep_graph=True``: the first replay instantiates it), so that
    ``graph_kernel_counts`` can list the kernel nodes a replay launches.
    Everything else is the accelerator's own."""

    def __init__(self, accel):
        self._accel = accel

    def __getattr__(self, name):
        return getattr(self._accel, name)

    def create_graph(self):
        import torch
        return torch.cuda.CUDAGraph(keep_graph=True)


def graph_kernel_counts(engine):
    """The kernel nodes of the engine's one captured step (built through
    ``KeptGraphs``) by wrapper, as ``KERNEL_NAMES`` names them, and the
    graph's node count: what each replay launches, read from the graph
    itself (the CUDA runtime's DOT dump of it), with no profiler."""
    (step,) = engine.graphs.steps.values()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_graph_") as tmp:
        path = os.path.join(tmp, "step.dot")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")      # the dump's own "DEBUG:" notes
            step.graph.debug_dump(path)
        text = Path(path).read_text() if os.path.exists(path) else ""
    nodes = re.split(r'(?m)^\s*"graph_\d+_node_\d+"\s*\[', text)[1:]
    if not nodes:
        fail("the captured step's DOT dump lists no node, so its launches cannot be read")
    return ({k: sum(1 for n in nodes if re.search(pat, n)) for k, pat in KERNEL_NAMES.items()},
            len(nodes))


def profile_train_step(engine, batch, card: str, attn_impl: str = "auto",
                       graphed: bool = False, split: bool = True):
    """One step's device time (torch.profiler) and the device's busy share
    of the step's wall time (profiling adds host time, so the busy share
    reads low), for a graphed ``train_batch`` replay or an eager step.
    With ``split`` (eager only: a replay's kernels have no CPU op) the
    device time by category: the flash, cross-entropy and AdamW kernels
    are named by their kernel names (the block-sparse ones too); other
    kernels are attributed through the CPU op that launched them:
    "reference attention" is every kernel under the attention call (forward
    and remat recompute) or under the reference's backward ops (bmm,
    softmax, mask) -- with flash or the sparse kernels only what surrounds
    their op.  The step's launch counters are held against the kernels in
    the trace and, for a replay, against the captured graph's kernel nodes
    (``graph_kernel_counts``, which needs no profiler); the step runs
    behind ``TRACE_FILL_KERNELS`` empty sleeps and ``TRACE_MARGIN_CYCLES``
    of sleep, and ends that margin before the window does.  None where the
    profiler recorded no device time (not measured)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from deepspeed_tpu_torch.ops import attention as tattn

    inner = tattn._REGISTRY[attn_impl]

    def traced(*a, **k):
        with record_function("attention_call"):
            return inner(*a, **k)
    tattn._REGISTRY[attn_impl] = traced
    try:
        torch.cuda.synchronize()
        before = read_counts()[0]
        # the host's ops only where ``split`` attributes kernels through them
        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if split else [])
        with profile(activities=acts) as prof:
            for _ in range(TRACE_FILL_KERNELS):
                torch.cuda._sleep(1)
            torch.cuda._sleep(TRACE_MARGIN_CYCLES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if graphed:
                engine.train_batch(batch=batch)
            else:
                eager_step(engine, batch)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            torch.cuda._sleep(TRACE_MARGIN_CYCLES)
            torch.cuda.synchronize()
        counted_launches = {k: n - before[k] for k, n in read_counts()[0].items()}
    finally:
        tattn._REGISTRY[attn_impl] = inner
    path = "graphed replay" if graphed else "eager step"
    if graphed:
        # the counters' launches in this replay against the graph's kernel
        # nodes, and with NVMe moments the walk's AdamW launches after it
        in_graph, n_nodes = graph_kernel_counts(engine)
        walked = (len(engine.optimizer.chunks)
                  if getattr(engine.optimizer, "streamed", False) else 0)
        stepped = dict(in_graph, fused_adam=in_graph["fused_adam"] + walked)
        if stepped != counted_launches:
            fail(f"train profile ({path}): launch counters {counted_launches} disagree with "
                 f"the kernel nodes of the captured graph {in_graph}"
                 + (f" and the walk's {walked} AdamW launches" if walked else ""))
        say(f"train profile ({path}): launch counters equal the captured graph's kernel nodes "
            f"({json.dumps({k: n for k, n in in_graph.items() if n})}; {n_nodes} nodes)"
            + (f" and the walk's {walked} AdamW launches after the replay" if walked else ""))
    by_name = {}                     # device time and launches per kernel name
    for e in prof.key_averages():
        # the range opened above also appears on the device's timeline (a
        # GPU user annotation spanning its kernels): not a kernel; nor are
        # the margin's sleeps
        if (e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                and e.key != "attention_call" and "spin_kernel" not in e.key):
            t, n = by_name.get(e.key, (0.0, 0))
            by_name[e.key] = (t + e.self_device_time_total, n + e.count)
    device_total = sum(t for t, _ in by_name.values())
    if not device_total:
        say(f"train profile ({path}): the profiler recorded no device time (not measured)")
        return None
    # the counters' launches in this step against the kernels the trace saw
    traced = {k: sum(n for name, (_, n) in by_name.items() if re.search(pat, name))
              for k, pat in KERNEL_NAMES.items()}
    if traced != counted_launches:
        fail(f"train profile ({path}): launch counters {counted_launches} disagree with the "
             f"kernels in the trace {traced}")
    say(f"train profile ({path}): launch counters equal the trace's kernel counts "
        f"({json.dumps({k: n for k, n in traced.items() if n})})")
    n_kernels = sum(n for _, n in by_name.values())
    if not split:
        copy_us = sum(t for name, (t, _) in by_name.items() if name.startswith("Memcpy"))
        comm_us = sum(t for name, (t, _) in by_name.items() if "nccl" in name.lower())
        say(f"train profile ({path}): device busy {device_total / wall_us:.1%} of "
            f"{wall_us / 1e3:.3f} ms wall ({device_total / 1e3:.3f} ms device, {n_kernels} "
            f"kernels; of it {copy_us / 1e3:.3f} ms host-device copies, {comm_us / 1e3:.3f} ms "
            f"NCCL) [{card}]")
        return {"device_ms": device_total / 1e3, "wall_ms": wall_us / 1e3,
                "copy_ms": copy_us / 1e3, "comm_ms": comm_us / 1e3}
    attn_ops = ("attention_call", "BmmBackward", "SoftmaxBackward", "WhereBackward")

    def category(kernel: str) -> str:
        k = kernel.lower()
        if "flash_fwd_kernel" in k or "flash_dq_kernel" in k or "flash_dkv_kernel" in k:
            return "flash attention kernels"
        if "sparse_fwd_kernel" in k or "sparse_dq_" in k or "sparse_dkv_kernel" in k:
            return "block-sparse attention kernels"
        if "ce_fwd" in k or "ce_bwd" in k or "ce_wide" in k:
            return "cross-entropy kernels"
        if "adam_kernel" in k:
            return "fused AdamW"
        if any(g in k for g in ("gemm", "cutlass", "xmma", "nvjet", "sm90_", "cublas")):
            return "GEMMs"
        return "layernorm / elementwise / other"

    def under_attention(op) -> bool:
        while op is not None:
            if any(a in op.name for a in attn_ops):
                return True
            op = op.cpu_parent
        return False
    # kernels an aten op launched carry a link to it; those under the
    # attention call (forward and remat recompute) or the reference's
    # backward ops move to "reference attention"
    attn = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and under_attention(e):
            for kern in getattr(e, "kernels", []):
                attn[kern.name] = attn.get(kern.name, 0.0) + kern.duration
    split = {}
    for name, (t, _) in by_name.items():
        cat = category(name)
        a = 0.0 if cat.endswith("attention kernels") else min(attn.get(name, 0.0), t)
        split["reference attention"] = split.get("reference attention", 0.0) + a
        split[cat] = split.get(cat, 0.0) + t - a
    say(f"train profile ({path}): one bf16 step, device busy {device_total / wall_us:.1%} of "
        f"{wall_us / 1e3:.2f} ms wall ({device_total / 1e3:.3f} ms device, "
        f"{n_kernels} kernels) [{card}]")
    for cat, t in sorted(split.items(), key=lambda kv: -kv[1]):
        say(f"  {t / device_total:6.1%} {t / 1e3:8.3f} ms  {cat}")
    # the kernels redesigned lately, by name: device ms and launches in the step
    picked = {label: [(t, n) for name, (t, n) in by_name.items() if key in name]
              for label, key in (("CE forward", "ce_fwd_"), ("CE wide backward", "ce_wide_"),
                                 ("block-sparse forward", "sparse_fwd_kernel"),
                                 ("block-sparse dQ", "sparse_dq_"),
                                 ("block-sparse dKV", "sparse_dkv_kernel"),
                                 ("flash dKV", "flash_dkv_kernel"), ("AdamW", "adam_kernel"))}
    say("train profile: per step " + ", ".join(
        f"{label} {sum(t for t, _ in hits) / 1e3:.3f} ms ({sum(n for _, n in hits)} launches)"
        for label, hits in picked.items() if hits) + f" [{card}]")
    say("train profile: top kernels")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        say(f"  {t / device_total:6.1%} {t / 1e3:8.3f} ms {n:5d}x  {name[:90]}")
    return {"device_ms": device_total / 1e3, "wall_ms": wall_us / 1e3,
            "split_ms": {k: v / 1e3 for k, v in split.items()}}


def phase_train_bf16(device, card: str, seq: int = TRAIN_SEQ, timed: int = TRAIN_TIMED_STEPS,
                     profiled: bool = True, attn_impl: str = "auto", micro: int = TRAIN_MICRO,
                     config=TRAIN_CFG, preset: str = "gpt2", warmup: int = 2,
                     eager: int = EAGER_STEPS, loss_steps=None, cfg=None,
                     flops_per_token=None, flops_label: str = "bench.py's dense formula",
                     after=None):
    """GPT-2 (``preset``; or the model of ``cfg``, a GPTConfig of another
    family, made in bf16 since the engine draws its own fp32 masters) at
    ``seq`` through initialize() -> train_batch,
    bench.py's headline config (``config``): warm-up (the first call warms
    up and captures the graph), ``timed`` graphed steps (replays; one
    capture in all), then ``eager`` steps of the same engine through
    ``forward`` / ``backward`` / ``step``, each timed on the host clock (the
    host's queue time and the wall time to the device's drain) and
    profiled (device time and busy share; the eager step by category when
    ``profiled``).  With "auto" above 256 tokens the attention is flash:
    its three kernels launch once per layer per step; at 256 and below it
    is the reference and they never do.  "block_sparse" runs the sparse
    kernels (``train_expect``); the counts are exact on both paths.  The
    loss must fall over the first ``loss_steps`` steps (None: all of them).
    Peak device memory: from the engine's state through the graphed steps
    (warm-up, capture, replays), then over the eager steps alone.  TFLOPs
    by ``model.flops_per_token(seq)``, or by ``flops_per_token`` (named by
    ``flops_label``).  ``after(engine, batch)`` runs once the measurements
    and profiles are done, before the engine closes; what it returns is
    the result's ``after``."""
    import torch
    from deepspeed_tpu_torch.models.gpt import GPT, gpt_config

    # an engine dropped by an earlier run lives on in reference cycles
    # until Python's cyclic collector runs: free it before measuring
    gc.collect()
    torch.cuda.empty_cache()
    if cfg is None:
        cfg = gpt_config(preset, n_positions=seq, remat=True, attn_impl=attn_impl)
        model = GPT(cfg, device=device, seed=0)
    else:
        model = GPT(cfg, device=device, seed=0, param_dtype=torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())      # the tree's leaves
    engine = train_engine(model, config, device)
    engine.graphs.accelerator = KeptGraphs(engine.graphs.accelerator)
    batch = train_batch_of(cfg.vocab_size, device, seq, micro)
    ce_launches = kernel_modules()[1].launches_per_call(
        micro * seq, cfg.n_embd, cfg.padded_vocab, torch.bfloat16, bias=cfg.head_bias)
    adam = adam_launches(engine)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state_gib = torch.cuda.memory_allocated() / 2 ** 30

    def graphed_step():
        return engine.train_batch(batch=batch)
    losses = [graphed_step() for _ in range(warmup)]
    torch.cuda.synchronize()
    label = f"bf16 train {preset} seq {seq} {attn_impl}"
    (out, host_ms, step_ms), counts = counted(
        f"{label} graphed ({timed} steps)",
        train_expect(attn_impl, seq, cfg.n_layer, timed, ce_launches=ce_launches,
                     adam_launches=adam),
        lambda: timed_steps(graphed_step, timed))
    losses += out
    mem = {"state_gib": state_gib,
           "graphed_alloc_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "graphed_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30}
    torch.cuda.reset_peak_memory_stats()
    (out, e_host_ms, e_step_ms), e_counts = counted(
        f"{label} eager ({eager} steps)",
        train_expect(attn_impl, seq, cfg.n_layer, eager, ce_launches=ce_launches,
                     adam_launches=adam),
        lambda: timed_steps(lambda: eager_step(engine, batch), eager))
    losses += out
    mem["eager_alloc_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"{label} memory: state {mem['state_gib']:.2f} GiB allocated (params, gradients, "
        f"moments, batch); graphed steps (warm-up, capture, replays) peak "
        f"{mem['graphed_alloc_gib']:.2f} GiB allocated, {mem['graphed_reserved_gib']:.2f} GiB "
        f"reserved; eager steps after them peak {mem['eager_alloc_gib']:.2f} GiB allocated "
        f"(the graph's pool is reserved beside them, not allocated) [{card}]")
    captures = engine.graphs.captures
    if captures != 1:
        fail(f"{label}: {captures} captures for one batch signature")
    vals = [float(v) for v in losses]
    if not all(np.isfinite(vals)):
        fail(f"bf16 train: non-finite loss {vals}")
    window = vals[:loss_steps] if loss_steps else vals
    if not window[-1] < window[0]:
        fail(f"bf16 train: the loss did not fall over {len(window)} steps ({window[0]:.4f} -> "
             f"{window[-1]:.4f})")
    say(f"{label}: losses {[round(v, 4) for v in vals]}")
    rates = {}
    fpt = flops_per_token or model.flops_per_token(seq)
    for path, wall, host in (("graphed", step_ms, host_ms), ("eager", e_step_ms, e_host_ms)):
        med = statistics.median(wall)
        samples_s = micro / (med / 1e3)
        rates[path] = (med, statistics.median(host), samples_s, samples_s * seq * fpt / 1e12)
        say(f"bf16 train ({path}): {preset} ({cfg.n_layer} layers x {cfg.n_embd}) seq {seq} "
            f"micro {micro} attn_impl {attn_impl}, {n_params:,} params; median step "
            f"{med:.3f} ms (min {min(wall):.3f}, max {max(wall):.3f}) over {len(wall)} steps, "
            f"of which the host takes a median {rates[path][1]:.3f} ms to queue it; "
            f"{samples_s:.2f} samples/s; {rates[path][3]:.2f} TFLOPs by {flops_label} "
            f"[{card}]")
    say(f"bf16 train: loss {vals[0]:.4f} -> {vals[-1]:.4f} over {len(vals)} steps ({warmup} "
        f"warm-up, {timed} graphed, {eager} eager); {captures} capture, "
        f"{engine.graphs.replays} replays")
    prof = profile_train_step(engine, batch, card, attn_impl, graphed=True, split=False)
    e_prof = profile_train_step(engine, batch, card, attn_impl, graphed=False, split=profiled)
    for path, pr in (("graphed", prof), ("eager", e_prof)):
        if pr is not None:
            say(f"train ({path}): device busy {pr['device_ms'] / rates[path][0]:.1%} of the "
                f"median un-profiled step ({pr['device_ms']:.3f} ms device / "
                f"{rates[path][0]:.3f} ms)")
    extra = after(engine, batch) if after is not None else None
    engine.close()
    med, host, samples_s, tflops = rates["graphed"]
    return dict(step_ms=med, host_ms=host, samples_per_s=samples_s, tflops=tflops,
                eager_step_ms=rates["eager"][0], eager_host_ms=rates["eager"][1],
                eager_samples_per_s=rates["eager"][2], eager_tflops=rates["eager"][3],
                losses=vals, counts=counts, eager_counts=e_counts, profile=prof,
                eager_profile=e_prof, params=n_params, n_layer=cfg.n_layer,
                n_embd=cfg.n_embd, memory=mem, after=extra)


def param_copies(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def trajectory_diff(losses, params, ref_losses, ref_params):
    """(max relative loss difference, max abs parameter difference, its
    parameter, relative L2 difference over all parameters)."""
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    worst, worst_key, diff_sq, norm_sq = 0.0, "", 0.0, 0.0
    for k, a in params.items():
        d = (a - ref_params[k]).double()
        if d.abs().max().item() > worst:
            worst, worst_key = d.abs().max().item(), k
        diff_sq += d.square().sum().item()
        norm_sq += ref_params[k].double().square().sum().item()
    return loss_rel, worst, worst_key, (diff_sq / norm_sq) ** 0.5


def device_ms(result, key: str = "profile") -> float:
    return (result.get(key) or {}).get("device_ms", float("nan"))


def bitwise_equal(losses, params, ref_losses, ref_params) -> bool:
    import torch
    return losses == ref_losses and all(torch.equal(a, ref_params[k]) for k, a in params.items())


def phase_train_fp32_parity(device, steps: int = 3, seq: int = TRAIN_SEQ,
                            micro: int = TRAIN_MICRO, attn_impl: str = "auto", config=TRAIN_CFG,
                            cfg=None):
    """GPT-2 at ``seq``, full width and depth (or the model of ``cfg``), in
    fp32 (TF32 off): ``steps``
    graphed train_batch steps through the training kernels (flash, or the
    sparse ones with "block_sparse"; cross-entropy, AdamW), then ``steps``
    eager steps through their plain versions (patched in where the engine
    calls the kernels; the plain cross-entropy backward indexes by a mask,
    which a graph capture refuses), from the same seeded weights.  The
    plain path's only use on the card.  An MoE model also runs its kernel
    steps eagerly, recording every gating call's routes (held to the
    graphed steps), and its plain steps are pinned to those routes and held
    against them (the routes of their own that differ, and their smallest
    gate margin, printed)."""
    import torch
    from deepspeed_tpu_torch.models.gpt import GPT, gpt_config
    from deepspeed_tpu_torch.moe.sharded_moe import route_log
    from deepspeed_tpu_torch.runtime import optimizers
    _, tce, tfo, tfa, tbs = kernel_modules()

    if cfg is None:
        cfg = gpt_config("gpt2", n_positions=seq, remat=True, dtype="float32",
                         attn_impl=attn_impl)
    config = {k: v for k, v in config.items() if k != "bf16"}
    ce_launches = tce.launches_per_call(micro * seq, cfg.n_embd, cfg.padded_vocab,
                                        torch.float32, bias=cfg.head_bias)

    def run_path(graphed: bool = True):
        gc.collect()                     # an earlier engine may linger in reference cycles
        torch.cuda.empty_cache()
        model = GPT(cfg, device=device, seed=0)
        engine = train_engine(model, config, device)
        batch = train_batch_of(cfg.vocab_size, device, seq, micro)
        losses = [float(engine.train_batch(batch=batch) if graphed else eager_step(engine, batch))
                  for _ in range(steps)]
        engine.close()
        return losses, param_copies(model)

    label = f"fp32 train {cfg.n_layer} layers x {cfg.n_embd} seq {seq} {attn_impl}"
    moe = bool(cfg.moe_num_experts)
    if moe:
        label += f" moe top-{cfg.moe_top_k}"
    want = train_expect(attn_impl, seq, cfg.n_layer, steps, ce_launches=ce_launches)
    (k_losses, k_params), k_counts = counted(f"{label}, kernels", want, run_path)
    routes = None
    if moe:
        # the kernels again, eagerly, recording every gating call's routes
        # (the graphed run draws the same noise: the capture registers the
        # engine's generator); the plain path takes these routes
        with route_log() as routes:
            (e_losses, e_params), _ = counted(f"{label}, kernels eager", want,
                                              lambda: run_path(graphed=False))
        same = bitwise_equal(e_losses, e_params, k_losses, k_params)
        loss_rel, worst, _, rel_l2 = trajectory_diff(e_losses, e_params, k_losses, k_params)
        say(f"{label}: graphed and eager kernel steps bitwise equal {same} (losses rel diff "
            f"{loss_rel:.3e}, params max abs diff {worst:.3e}, relative L2 {rel_l2:.3e}); "
            f"{len(routes.choices)} gating calls recorded")
        if not (loss_rel <= TRAIN_LOSS_RTOL and worst <= TRAIN_PARAM_ATOL
                and rel_l2 <= TRAIN_PARAM_REL_L2):
            fail(f"{label}: graphed and eager kernel steps differ past phase 8's limits")
        del k_params
        k_losses, k_params = e_losses, e_params
    saved = (tfa.flash_forward, tfa.flash_backward_dq, tfa.flash_backward_dkv, tce.ce_forward,
             tce.ce_backward_dx, tce.ce_backward_dhead, optimizers.fused_adam,
             tbs.block_sparse_forward, tbs.block_sparse_backward_dq,
             tbs.block_sparse_backward_dkv)
    tfa.flash_forward = tfa.flash_forward_reference
    tfa.flash_backward_dq = tfa.flash_backward_dq_reference
    tfa.flash_backward_dkv = tfa.flash_backward_dkv_reference
    # the plain versions walk the LUTs, not the forward's or dKV's work list
    tbs.block_sparse_forward = (
        lambda *args, work=None: tbs.block_sparse_forward_reference(*args))
    tbs.block_sparse_backward_dq = (
        lambda *args, work=None: tbs.block_sparse_backward_dq_reference(*args))
    tbs.block_sparse_backward_dkv = (
        lambda *args, work=None: tbs.block_sparse_backward_dkv_reference(*args))
    tce.ce_forward = tce.ce_forward_reference
    tce.ce_backward_dx = tce.ce_backward_dx_reference
    tce.ce_backward_dhead = tce.ce_backward_dhead_reference
    optimizers.fused_adam = lambda table, scal, **kw: tfo.adam_reference(*table.leaves, scal,
                                                                        **kw)
    try:
        for mod in kernel_modules():
            mod.reset_counts()
        with route_log(pinned=routes.choices if moe else None) as pinned:
            p_losses, p_params = run_path(graphed=False)
        _, plain = read_counts()
    finally:
        (tfa.flash_forward, tfa.flash_backward_dq, tfa.flash_backward_dkv, tce.ce_forward,
         tce.ce_backward_dx, tce.ce_backward_dhead, optimizers.fused_adam,
         tbs.block_sparse_forward, tbs.block_sparse_backward_dq,
         tbs.block_sparse_backward_dkv) = saved
    say(f"{label}, plain versions: plain calls {json.dumps(plain)}")
    if moe:
        say(f"{label}, plain versions pinned to the kernel run's routes: {pinned.differ()} "
            f"(token, choice) routes of their own differ over {len(pinned.choices)} gating "
            f"calls; smallest gate margin among them {pinned.min_margin():.3e}")
    loss_rel, worst, worst_key, rel_l2 = trajectory_diff(k_losses, k_params, p_losses, p_params)
    say(f"{label} parity over {steps} steps: losses kernel {k_losses} vs plain "
        f"{p_losses} (max rel diff {loss_rel:.3e}, tol {TRAIN_LOSS_RTOL:g}); params max abs "
        f"diff {worst:.3e} in {worst_key} (tol {TRAIN_PARAM_ATOL:g}), relative L2 "
        f"diff {rel_l2:.3e} (tol {TRAIN_PARAM_REL_L2:g})")
    want_plain = train_expect(attn_impl, seq, cfg.n_layer, steps, plain=True)
    if plain != {k: want_plain.get(k, 0) for k in plain}:
        fail(f"{label}, plain versions: expected {want_plain}, got {plain}")
    if not loss_rel <= TRAIN_LOSS_RTOL:
        fail(f"{label}: kernel and plain losses differ by {loss_rel:.3e}")
    if not (worst <= TRAIN_PARAM_ATOL and rel_l2 <= TRAIN_PARAM_REL_L2):
        fail(f"{label}: kernel and plain parameters differ past the tolerance")
    return dict(loss_rel=loss_rel, param_max=worst, param_rel_l2=rel_l2, counts=k_counts,
                routes_differ=pinned.differ() if moe else 0,
                min_margin=pinned.min_margin() if moe else None)


# --------------------------------------------------------------------------- #
# phase 12: the graphed step against the eager one, and checkpoints
# --------------------------------------------------------------------------- #
def phase_graph_parity(device, steps: int = GRAPH_PARITY_STEPS):
    """GPT-2 at seq 512 in fp32 (TF32 off): ``steps`` graphed train_batch
    steps and ``steps`` eager ones (forward / backward / step), each from
    the same seeded weights over the same batches, held to phase 8's
    limits; whether they are bitwise equal is printed."""
    from deepspeed_tpu_torch.models.gpt import GPT, gpt_config
    cfg = gpt_config("gpt2", n_positions=TRAIN_SEQ, remat=True, dtype="float32")
    config = {k: v for k, v in TRAIN_CFG.items() if k != "bf16"}
    batches = [train_batch_of(cfg.vocab_size, device, seed=20 + i) for i in range(steps)]

    def run(graphed: bool):
        model = GPT(cfg, device=device, seed=0)
        engine = train_engine(model, config, device)
        losses = [float(engine.train_batch(batch=b) if graphed else eager_step(engine, b))
                  for b in batches]
        engine.close()
        return losses, param_copies(model)
    expect = train_expect("auto", TRAIN_SEQ, cfg.n_layer, steps)
    (g_losses, g_params), _ = counted("fp32 graphed train_batch", expect, lambda: run(True))
    (e_losses, e_params), _ = counted("fp32 eager steps", expect, lambda: run(False))
    loss_rel, worst, worst_key, rel_l2 = trajectory_diff(g_losses, g_params, e_losses, e_params)
    same = bitwise_equal(g_losses, g_params, e_losses, e_params)
    say(f"graphed vs eager, fp32 seq {TRAIN_SEQ}, {steps} steps: losses {g_losses} vs "
        f"{e_losses}; bitwise equal: {same}; max rel loss diff {loss_rel:.3e} (tol "
        f"{TRAIN_LOSS_RTOL:g}); params max abs diff {worst:.3e} in {worst_key or '-'} (tol "
        f"{TRAIN_PARAM_ATOL:g}), relative L2 {rel_l2:.3e} (tol {TRAIN_PARAM_REL_L2:g})")
    if not (loss_rel <= TRAIN_LOSS_RTOL and worst <= TRAIN_PARAM_ATOL
            and rel_l2 <= TRAIN_PARAM_REL_L2):
        fail("graphed and eager steps differ past phase 8's limits")
    return dict(bitwise=same, loss_rel=loss_rel, param_max=worst, param_rel_l2=rel_l2)


def hold_resumed(label, losses, params, ref_losses, ref_params) -> bool:
    """A resumed run against the uninterrupted one: bitwise, or where a
    kernel is not deterministic from run to run (then named by the printed
    difference), within phase 8's limits."""
    if bitwise_equal(losses, params, ref_losses, ref_params):
        say(f"{label}: bitwise equal to the uninterrupted run (losses {losses})")
        return True
    loss_rel, worst, worst_key, rel_l2 = trajectory_diff(losses, params, ref_losses, ref_params)
    say(f"{label}: NOT bitwise equal: losses {losses} vs {ref_losses} (max rel {loss_rel:.3e}); "
        f"params max abs diff {worst:.3e} in {worst_key}, relative L2 {rel_l2:.3e}; a kernel of "
        "the step is not deterministic from run to run; held to phase 8's limits")
    if not (loss_rel <= TRAIN_LOSS_RTOL and worst <= TRAIN_PARAM_ATOL
            and rel_l2 <= TRAIN_PARAM_REL_L2):
        fail(f"{label}: the resumed run differs past phase 8's limits")
    return False


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def ckpt_verify(save_dir: str):
    """``ckpt_cli verify`` on ``save_dir``, through the module's ``main`` in
    this process (a process of its own would spend seconds importing
    torch): its exit code and the end of its output."""
    import contextlib
    import io
    from deepspeed_tpu_torch import ckpt_cli
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
        rc = ckpt_cli.main(["verify", save_dir])
    return rc, out.getvalue().strip()[-600:]


def flip_byte(path: str) -> None:
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


def phase_resume(device, card: str, steps: int = RESUME_STEPS):
    """bf16 GPT-2 at seq 512 (bench.py's config), per save mode (sync, then
    ``checkpoint.async_save``): ``steps`` graphed steps, a save, ``steps``
    more (losses and params A; with async_save the steps run while the
    finalizer writes, and the save is waited for after them); a fresh engine
    from other weights loads and runs the same ``steps`` (B), held to A
    bit for bit.  Then (sync) a second tag at step 2 x ``steps``: ``ckpt_cli
    verify`` exits 0, and 1 after one flipped byte in its state file; the
    first engine, graphed, loads the save dir, rolls back to the earlier
    tag and replays the same steps to A's losses with no new capture.
    Save and load seconds and bytes are printed.  Checkpoints go to a
    temporary directory, removed at the end: under ``$TMPDIR`` or beside
    this file, whichever has more room (two tags of ~1.5 GB at once)."""
    from deepspeed_tpu_torch.models.gpt import GPT, gpt_config
    from deepspeed_tpu_torch.runtime.checkpointing import wait_for_finalizer

    cfg = gpt_config("gpt2", n_positions=TRAIN_SEQ, remat=True)
    batches = [train_batch_of(cfg.vocab_size, device, seed=40 + i) for i in range(2 * steps)]

    def engine_of(seed: int, async_save: bool):
        config = dict(TRAIN_CFG, checkpoint={"async_save": async_save})
        model = GPT(cfg, device=device, seed=seed)
        return model, train_engine(model, config, device)

    def run(engine, bs):
        return [float(engine.train_batch(batch=b)) for b in bs]

    out = {}
    parent = max((tempfile.gettempdir(), str(Path(__file__).resolve().parent)),
                 key=lambda d: shutil.disk_usage(d).free)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=parent)
    say(f"checkpoints under {root} ({shutil.disk_usage(parent).free / 2 ** 30:.1f} GiB free)")
    try:
        for mode in ("sync", "async"):
            save_dir = os.path.join(root, mode)
            model_a, a = engine_of(0, mode == "async")
            losses_a = run(a, batches[:steps])
            t0 = time.perf_counter()
            a.save_checkpoint(save_dir)
            save_s = time.perf_counter() - t0
            losses_a += run(a, batches[steps:])
            t0 = time.perf_counter()
            wait_for_finalizer(a)
            wait_s = time.perf_counter() - t0
            params_a = param_copies(model_a)
            tag_dir = os.path.join(save_dir, f"global_step{steps}")
            nbytes = dir_bytes(tag_dir)
            model_b, b = engine_of(1, mode == "async")
            t0 = time.perf_counter()
            path, _ = b.load_checkpoint(save_dir)
            load_s = time.perf_counter() - t0
            if path != tag_dir or b.global_steps != steps:
                fail(f"resume ({mode}): loaded {path} at step {b.global_steps}")
            losses_b = run(b, batches[steps:])
            same = hold_resumed(f"resume ({mode} save)", losses_b, param_copies(model_b),
                                losses_a[steps:], params_a)
            b.close()
            say(f"checkpoint ({mode}): save {save_s:.3f} s blocking"
                + (f" + {wait_s:.3f} s finalize waited after {steps} steps" if mode == "async"
                   else "") + f", load {load_s:.3f} s, {nbytes:,} bytes in {tag_dir.split(os.sep)[-1]}"
                f" [{card}]")
            out[mode] = dict(save_s=save_s, wait_s=wait_s, load_s=load_s, bytes=nbytes,
                             bitwise=same)
            if mode == "async":
                a.close()
                break
            # a second tag, verified, then torn: the loader rolls back
            a.save_checkpoint(save_dir)
            rc_ok, out_ok = ckpt_verify(save_dir)
            flip_byte(os.path.join(save_dir, f"global_step{2 * steps}", "state.pt"))
            rc_torn, out_torn = ckpt_verify(save_dir)
            say(f"ckpt_cli verify: exit {rc_ok} on the save dir, {rc_torn} after one flipped "
                "byte in the newest tag's state file")
            if (rc_ok, rc_torn) != (0, 1):
                fail(f"ckpt_cli verify exited {rc_ok} / {rc_torn}, expected 0 / 1; its output: "
                     f"{out_ok!r} / {out_torn!r}")
            captures = a.graphs.captures
            path, _ = a.load_checkpoint(save_dir)
            if path != tag_dir or a.global_steps != steps:
                fail(f"rollback: loaded {path} at step {a.global_steps}, expected {tag_dir}")
            again = run(a, batches[steps:])
            say(f"rollback into the same graphed engine: loaded {path.split(os.sep)[-1]}, "
                f"losses {again}, captures {captures} -> {a.graphs.captures}")
            if a.graphs.captures != captures:
                fail("a load into a graphed engine needed a new capture")
            hold_resumed("rollback replay", again, param_copies(model_a), losses_a[steps:],
                         params_a)
            a.close()
            shutil.rmtree(save_dir)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# --------------------------------------------------------------------------- #
def phase_family_train(name: str, device, card: str):
    """Phases 15, 17 and 26: one family's training cell, its published widths
    cut in depth to FAMILY_TRAIN's layers, seeded weights, through
    initialize() -> train_batch with bench.py's config at micro 4 x seq
    2048 (bf16, AdamW lr 1e-4 wd 0.01, clip 1.0, remat, ZeRO-0): as phase
    7, the graphed and eager steps timed, profiled and counted."""
    from deepspeed_tpu_torch.models import gpt as gpt_mod
    ctor, kw, _ = FAMILY_CELLS[name]
    layers, warmup, timed, eager, profiled = FAMILY_TRAIN[name]
    cfg = getattr(gpt_mod, ctor)(**dict(kw, n_layer=layers), remat=True, dtype="bfloat16")
    say(f"model: {name} training at {layers} of {kw['n_layer']} layers (depth cut: the fp32 "
        f"master, gradient, moments and bf16 copy of every parameter sit on one card, ZeRO "
        f"and offload not ported) x {cfg.n_embd}, {cfg.n_head} heads over {cfg.kv_heads} kv "
        f"heads, head_dim {cfg.head_dim}, {cfg.position_encoding} positions, "
        f"{'untied' if cfg.untied_head else 'tied'} head over vocab {cfg.padded_vocab}, "
        f"{gpt_mod.count_params(cfg) / 1e9:.3f}B params; micro {FAMILY_TRAIN_MICRO} x seq "
        f"{FAMILY_TRAIN_SEQ}")
    return phase_train_bf16(device, card, seq=FAMILY_TRAIN_SEQ, timed=timed, profiled=profiled,
                            micro=FAMILY_TRAIN_MICRO, config=FAMILY_TRAIN_CFG, preset=name,
                            warmup=warmup, eager=eager, cfg=cfg)


# --------------------------------------------------------------------------- #
# phases 18-20: DeepSpeed-MoE 350M+MoE-128
# --------------------------------------------------------------------------- #
def moe_config(layers: int, dtype: str, **overrides):
    from deepspeed_tpu_torch.models.gpt import gpt_config
    return gpt_config("gpt2", **dict(MOE_CELL, n_layer=layers, **overrides), dtype=dtype)


class MoEGauges:
    """While active, every gating call (``moe/sharded_moe.py``, where the
    MoE layer calls it) also computes ``expert_load_metrics`` of its
    decision and keeps its (tokens, drop fraction, load entropy), the last
    two as device scalars.  Nothing is read on the host until ``summary``.
    Smoke-only instrumentation: no measured run is made under it."""

    def __init__(self):
        self.records = []

    def __enter__(self):
        from deepspeed_tpu_torch.moe import sharded_moe
        self._saved = (sharded_moe.top1gating, sharded_moe.top2gating)
        sharded_moe.top1gating = self._wrap(self._saved[0], 1)
        sharded_moe.top2gating = self._wrap(self._saved[1], 2)
        return self

    def __exit__(self, *exc):
        from deepspeed_tpu_torch.moe import sharded_moe
        sharded_moe.top1gating, sharded_moe.top2gating = self._saved

    def _wrap(self, gating, k: int):
        from deepspeed_tpu_torch.moe.sharded_moe import expert_load_metrics

        def gated(logits, *args, **kwargs):
            out = gating(logits, *args, **kwargs)
            m = expert_load_metrics(out[2], out[1], k=k)
            self.records.append((logits.shape[0], m["drop_fraction"].detach(),
                                 m["load_entropy_frac"].detach()))
            return out
        return gated

    def summary(self):
        """By gating width (tokens a call): calls, mean drop fraction, mean
        load entropy (fraction of log E)."""
        out = {}
        for tokens, drop, ent in self.records:
            c, d, e = out.get(tokens, (0, 0.0, 0.0))
            out[tokens] = (c + 1, d + float(drop), e + float(ent))
        return {t: (c, d / c, e / c) for t, (c, d, e) in sorted(out.items())}


def phase_moe_serve(device, card: str):
    """Phase 18: the MoE cell served.  (a) fp32 (TF32 off) at
    MOE_FP32_LAYERS blocks and the no-drop eval factor: ``init_serving``
    (roomy, preempting; phase 4's checks) and ``init_inference(...)
    .generate`` held token for token against ``generate()``; (b) bf16 at
    all 24 blocks and factor 1.0, made in bf16 on the card: phase 5's
    measurements through ``init_serving`` with 24 paged launches a
    dispatch, peak memory, then one more serve of the same requests under
    MoEGauges for the drop fraction and load entropy."""
    import torch
    import deepspeed_tpu_torch as dst
    from types import SimpleNamespace
    from deepspeed_tpu_torch.models import gpt as gpt_mod

    cfg = moe_config(MOE_FP32_LAYERS, "float32", moe_eval_capacity_factor=MOE_NO_DROP)
    t0 = time.perf_counter()
    model = gpt_mod.GPT(cfg, device=device, seed=0)
    torch.cuda.synchronize()
    say(f"model: moe-350m fp32 at {cfg.n_layer} of {MOE_CELL['n_layer']} blocks (depth cut to "
        f"fit the fp32 run; widths as published) x {cfg.n_embd}, {cfg.n_head} heads, "
        f"{cfg.moe_num_experts} experts of {cfg.expert_hidden}, top-{cfg.moe_top_k}, eval "
        f"capacity factor {cfg.moe_eval_capacity_factor:g} (no drop), "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f}B params, seeded init in "
        f"{time.perf_counter() - t0:.1f}s")
    prompts = make_prompts(cfg.vocab_size, PROMPT_LENS)
    fp32 = phase_fp32(model, prompts, device, roomy_blocks=512, small_blocks=40,
                      name="moe-350m")
    eng = dst.init_inference(model=model, device=device, config={"dtype": "float32"})
    if eng.module is not model:
        fail("init_inference copied an fp32 model it could serve as it is")
    t0 = time.perf_counter()
    outs, inf_counts = counted("moe-350m fp32 init_inference generate",
                               {"decode_attention": None}, lambda: [
                                   eng.generate([p], NEW_TOKENS)[0, len(p):].tolist()
                                   for p in prompts])
    wall = time.perf_counter() - t0
    ties = check_identity(model, prompts, [SimpleNamespace(token_ids=o) for o in outs],
                          fp32["refs"], "moe-350m fp32 init_inference")
    say(f"moe-350m fp32 init_inference(...).generate: {len(outs)} requests (prompts padded "
        f"to 64-token buckets) token-identical to generate() except {ties} near-ties; "
        f"{wall:.2f}s")
    fp32["inference"] = dict(ties=ties, counts=inf_counts)
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    cfg = moe_config(MOE_CELL["n_layer"], "bfloat16")
    t0 = time.perf_counter()
    model = gpt_mod.GPT(cfg, device=device, seed=0, param_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated(device) - before
    n_params = sum(p.numel() for p in model.parameters())
    bank = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
               if ".moe.experts." in n)
    say(f"model: moe-350m bf16 at all {cfg.n_layer} blocks, {n_params / 1e9:.3f}B params "
        f"({gpt_mod.active_params(cfg) / 1e6:.1f}M active a token), {weights / 2 ** 30:.2f} GiB "
        f"of weights (the expert banks {bank / 1e9:.2f} GB), eval capacity "
        f"factor {cfg.moe_eval_capacity_factor:g}, seeded init in "
        f"{time.perf_counter() - t0:.1f}s")
    bf16 = phase_bf16(model, prompts, device, blocks=512, card=card, name="moe-350m")
    peak = torch.cuda.max_memory_allocated(device) - before
    say(f"moe-350m bf16: peak device memory {peak / 2 ** 30:.2f} GiB allocated above the "
        f"{before / 2 ** 30:.2f} GiB earlier phases held "
        f"({torch.cuda.max_memory_reserved(device) / 2 ** 30:.2f} reserved in all) [{card}]")
    eng = dst.init_serving(model=model, device=device, config={"serving": dict(
        SERVE_CFG, num_blocks=512, dtype="bfloat16")})
    with MoEGauges() as gauges:
        serve(eng, prompts, NEW_TOKENS)
    load = gauges.summary()
    say("moe-350m bf16 gating (expert_load_metrics of every gating call of one more serve, "
        "by tokens a call: calls, mean drop fraction, mean load entropy as a fraction of "
        "log 128): " + "; ".join(f"{t} tokens: {c} calls, drop {d:.4f}, entropy {e:.4f}"
                                 for t, (c, d, e) in load.items()))
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(fp32=fp32, bf16=bf16, peak_gib=peak / 2 ** 30, weights_gib=weights / 2 ** 30,
                load=load)


def phase_moe_train(device, card: str):
    """Phase 19: the MoE cell's training at MOE_TRAIN's blocks through
    initialize() -> train_batch (bf16, micro 4 x seq 2048, bench.py's
    config, remat, graphed, the gating noise from the engine's
    generator): phase 15's measurements and TFLOPs by the active parameter
    count, all without instrumentation; then, after them, a few eager
    steps of the same engine under MoEGauges for each step's drop
    fraction (the forward's gating calls)."""
    from deepspeed_tpu_torch.models import gpt as gpt_mod
    from deepspeed_tpu_torch.moe.sharded_moe import _capacity
    layers, warmup, timed, eager, gauged = MOE_TRAIN
    cfg = moe_config(layers, "bfloat16", remat=True)
    seq, micro = FAMILY_TRAIN_SEQ, FAMILY_TRAIN_MICRO
    active = gpt_mod.active_params(cfg)
    capacity = _capacity(micro * seq, cfg.moe_num_experts, cfg.moe_capacity_factor,
                         cfg.moe_min_capacity)
    say(f"model: moe-350m training at {layers} of {MOE_CELL['n_layer']} blocks (depth cut: the "
        f"fp32 master, gradient, moments and bf16 copy of every parameter sit on one card, "
        f"ZeRO and offload not ported) x {cfg.n_embd}, {cfg.moe_num_experts} experts of "
        f"{cfg.expert_hidden}, top-{cfg.moe_top_k}, capacity factor "
        f"{cfg.moe_capacity_factor:g} (capacity {capacity} a block); "
        f"{active:,} active params a token; micro {micro} x seq {seq}")

    def drops(engine, batch):
        out = []
        for _ in range(gauged):
            with MoEGauges() as gauges:
                eager_step(engine, batch)
            out.append([round(float(d), 4) for _, d, _ in gauges.records[:layers]])
        return out
    r = phase_train_bf16(device, card, seq=seq, timed=timed, profiled=True, micro=micro,
                         config=FAMILY_TRAIN_CFG, preset="moe-350m", warmup=warmup,
                         eager=eager, cfg=cfg,
                         flops_per_token=6 * active + 12 * layers * cfg.n_embd * seq,
                         flops_label="the active parameter count (one expert a token)",
                         after=drops)
    if r["params"] != MOE_TRAIN_PARAMS:
        fail(f"moe-350m training: expected {MOE_TRAIN_PARAMS:,} parameters, got "
             f"{r['params']:,}")
    r["drops"] = r.pop("after")
    say(f"moe-350m training: drop fraction per block in each of {gauged} eager steps after "
        f"the {warmup} warm-up, {timed} graphed and {eager} eager measured ones (forward "
        f"gating, under MoEGauges): {r['drops']}")
    return r


def phase_moe_parity(device):
    """Phase 20: the MoE cell at MOE_PARITY_LAYERS blocks in fp32 (TF32
    off), phase 8's config (seq 512, micro 8), top-1 and top-2: the kernel
    path against the plain path (``phase_train_fp32_parity``: routes
    recorded on the kernels' eager run, the plain run pinned to them)."""
    out = {}
    for k in (1, 2):
        cfg = moe_config(MOE_PARITY_LAYERS, "float32", remat=True, moe_top_k=k)
        out[k] = phase_train_fp32_parity(device, cfg=cfg)
    return out


# --------------------------------------------------------------------------- #
# phase 24: module_inject and int8
# --------------------------------------------------------------------------- #
class HFStandIn:
    """What ``module_inject`` reads of a Hugging Face model: ``config`` (HF's
    field names) and ``state_dict()`` (HF's keys and layouts)."""

    def __init__(self, config, state_dict):
        self.config, self._state_dict = config, state_dict

    def state_dict(self):
        return self._state_dict


# the block activations' names in HF configs
HF_ACTIVATION = {"gelu_tanh": "gelu_new", "gelu": "gelu", "relu": "relu"}


def hf_standin(model, kind: str) -> HFStandIn:
    """An HF-layout stand-in of the port's ``model``, the inverse of
    ``module_inject``'s GPT-J (``kind`` "gptj") or GPT-NeoX ("gpt_neox")
    policy: Linear weights ``[out, in]``, q / k / v separate (GPT-J) or
    head-interleaved ``[H, 3, D]`` rows (NeoX), the vocab unpadded.  Its
    tensors are the model's own where the layout matches (no copy)."""
    from types import SimpleNamespace
    cfg = model.cfg
    V, E, H, D, L = cfg.vocab_size, cfg.n_embd, cfg.n_head, cfg.head_dim, cfg.n_layer
    p = {k: t.detach() for k, t in model.state_dict().items()}
    act = HF_ACTIVATION[cfg.activation]
    sd = {}
    if kind == "gptj":
        hc = SimpleNamespace(model_type="gptj", vocab_size=V, n_positions=cfg.n_positions,
                             n_embd=E, n_layer=L, n_head=H, rotary_dim=cfg.rope_dim,
                             activation_function=act, layer_norm_epsilon=cfg.ln_eps,
                             tie_word_embeddings=False)
        sd["transformer.wte.weight"] = p["wte"][:V]
        for i in range(L):
            b, t = f"transformer.h.{i}.", f"blocks.{i}."
            q, k, v = p[t + "qkv_w"].split(E, dim=1)
            sd.update({b + "ln_1.weight": p[t + "ln1_g"], b + "ln_1.bias": p[t + "ln1_b"],
                       b + "attn.q_proj.weight": q.T, b + "attn.k_proj.weight": k.T,
                       b + "attn.v_proj.weight": v.T, b + "attn.out_proj.weight": p[t + "out_w"].T,
                       b + "mlp.fc_in.weight": p[t + "fc_w"].T, b + "mlp.fc_in.bias": p[t + "fc_b"],
                       b + "mlp.fc_out.weight": p[t + "proj_w"].T,
                       b + "mlp.fc_out.bias": p[t + "proj_b"]})
        sd.update({"transformer.ln_f.weight": p["lnf_g"], "transformer.ln_f.bias": p["lnf_b"],
                   "lm_head.weight": p["lm_head"][:V], "lm_head.bias": p["lm_head_b"][:V]})
        return HFStandIn(hc, sd)
    hc = SimpleNamespace(model_type="gpt_neox", vocab_size=V,
                         max_position_embeddings=cfg.n_positions, hidden_size=E, num_hidden_layers=L, num_attention_heads=H,
                         rotary_pct=cfg.rope_dim / D, rotary_emb_base=cfg.rope_theta,
                         use_parallel_residual=cfg.block_type == "parallel", hidden_act=act,
                         layer_norm_eps=cfg.ln_eps, intermediate_size=cfg.ffn_dim,
                         tie_word_embeddings=False)
    sd["gpt_neox.embed_in.weight"] = p["wte"][:V]
    for i in range(L):
        b, t = f"gpt_neox.layers.{i}.", f"blocks.{i}."
        # [E, q | k | v] columns -> [H, 3, D] rows of [3E, E]
        w = p[t + "qkv_w"].T.reshape(3, H, D, E).transpose(0, 1).reshape(3 * E, E)
        bias = p[t + "qkv_b"].reshape(3, H, D).transpose(0, 1).reshape(3 * E)
        sd.update({b + "input_layernorm.weight": p[t + "ln1_g"],
                   b + "input_layernorm.bias": p[t + "ln1_b"],
                   b + "post_attention_layernorm.weight": p[t + "ln2_g"],
                   b + "post_attention_layernorm.bias": p[t + "ln2_b"],
                   b + "attention.query_key_value.weight": w,
                   b + "attention.query_key_value.bias": bias,
                   b + "attention.dense.weight": p[t + "out_w"].T,
                   b + "attention.dense.bias": p[t + "out_b"],
                   b + "mlp.dense_h_to_4h.weight": p[t + "fc_w"].T,
                   b + "mlp.dense_h_to_4h.bias": p[t + "fc_b"],
                   b + "mlp.dense_4h_to_h.weight": p[t + "proj_w"].T,
                   b + "mlp.dense_4h_to_h.bias": p[t + "proj_b"]})
    sd.update({"gpt_neox.final_layer_norm.weight": p["lnf_g"],
               "gpt_neox.final_layer_norm.bias": p["lnf_b"], "embed_out.weight": p["lm_head"][:V]})
    return HFStandIn(hc, sd)


INJECT_KINDS = {"gptj-6b": "gptj", "neox-20b": "gpt_neox"}


def standin_model(name: str, device, layers: int = INJECT_LAYERS):
    """(the port's fp32 GPT at ``name``'s widths and ``layers`` layers,
    seeded, its padded vocab rows zero so the policy's round trip is
    exact; its HF-layout stand-in).  NeoX-20B's published ``gelu_fast`` is
    refused by the policy, as by JAX's: the stand-in says ``gelu``, the
    nearest activation it takes."""
    import torch
    from deepspeed_tpu_torch.models import gpt as gpt_mod
    _, kw, _ = FAMILY_CELLS[name]
    kw = dict(kw, n_layer=layers)
    if name == "neox-20b":
        kw["activation"] = "gelu"
    model = gpt_mod.GPT(gpt_mod.GPTConfig(**kw, dtype="float32"), device=device, seed=0)
    with torch.no_grad():
        for leaf in ("wte", "lm_head", "lm_head_b"):
            if hasattr(model, leaf):
                getattr(model, leaf)[model.cfg.vocab_size:] = 0
    return model, hf_standin(model, INJECT_KINDS[name])


def attention_paths(model, ids, attention: str):
    """Logits of ``model`` (bf16) on ``ids``: the full forward (flash above
    256 tokens) and a prefill then one decode step through the contiguous
    cache, with ``attention`` "kernel", "plain" (the plain versions) or
    "exact" (the plain versions in fp32 on the bf16 inputs)."""
    import torch
    from deepspeed_tpu_torch.models import gpt as gpt_mod
    from deepspeed_tpu_torch.ops import attention as attn_mod
    tfa, da = kernel_modules()[3], kernel_modules()[0]

    def flash_plain(q, k, v, causal=True, bias=None, alibi=None, exact=False):
        cast = (lambda t: t.float()) if exact else (lambda t: t)
        o, _ = tfa.flash_forward_reference(cast(q), cast(k), cast(v), None, alibi, causal,
                                           1.0 / q.shape[-1] ** 0.5)
        return o.to(q.dtype)

    def decode_plain(q, ck, cv, pos, alibi=None, exact=False):
        cast = (lambda t: t.float()) if exact else (lambda t: t)
        return da.decode_attention_reference(cast(q), cast(ck), cast(cv), pos,
                                             alibi=alibi).to(q.dtype)
    fns = {"kernel": (attn_mod.flash_attention, da.decode_attention),
           "plain": (flash_plain, decode_plain),
           "exact": (lambda *a, **k: flash_plain(*a, **k, exact=True),
                     lambda *a, **k: decode_plain(*a, **k, exact=True))}[attention]
    saved = gpt_mod.decode_attention
    gpt_mod.decode_attention = fns[1]
    try:
        with torch.no_grad():
            full = gpt_mod.gpt_forward(model.cfg, model.param_tree(), ids, attention_fn=fns[0])
        cache = model.init_cache(ids.shape[0], ids.shape[1] + 1)
        prefill, cache = model.apply_with_cache(ids, cache)
        tok = ids[:, :1]
        step, _ = model.apply_with_cache(tok, cache)
    finally:
        gpt_mod.decode_attention = saved
    V = model.cfg.vocab_size
    return full[..., :V], prefill[..., :V], step[..., :V]


def phase_inject(device, card: str):
    """Phase 24: the stand-ins through ``init_inference`` (fp32 tokens,
    bf16 logits), then GPT-J-6B at full size in bf16 and int8."""
    import torch
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import gpt as gpt_mod

    out = {}
    for name in INJECT_KINDS:
        model, standin = standin_model(name, device)
        if name == "neox-20b":
            say("neox-20b stand-in: hidden_act 'gelu' in place of the published 'gelu_fast', "
                "which module_inject refuses as the JAX package does")
        prompts = make_prompts(model.cfg.vocab_size, PROMPT_LENS[:4])

        def run():
            eng = dst.init_inference(standin, device=device, config={"dtype": "float32"})
            return eng, [eng.generate([p], NEW_TOKENS)[0, len(p):].tolist() for p in prompts]
        (eng, toks), counts = counted(f"{name} fp32 init_inference(stand-in) generate",
                                      {"decode_attention": None}, run)
        own = dict(model.named_parameters())
        differ = [k for k, t in eng.module.named_parameters() if not torch.equal(t, own[k])]
        if differ:
            fail(f"{name}: the injected weights differ from the model's: {differ[:4]}")
        ties = 0
        for i, (p, got) in enumerate(zip(prompts, toks)):
            ref = model.generate([p], NEW_TOKENS)[0, len(p):].tolist()
            if got == ref:
                continue
            k = next(j for j, (a, b) in enumerate(zip(got, ref)) if a != b)
            gap = top2_gap(model, p + ref[:k])
            if gap > NEAR_TIE:
                fail(f"{name} init_inference(stand-in): request {i} diverges at token {k}, "
                     f"top-2 gap {gap:.3e} > {NEAR_TIE}")
            ties += 1
        del eng
        say(f"{name} stand-in ({INJECT_LAYERS} layers, {len(standin.state_dict())} HF leaves) "
            f"through init_inference, fp32: injected weights equal the model's bit for bit; "
            f"{len(prompts)} greedy streams of {NEW_TOKENS} equal to generate() except {ties} "
            f"near-ties")
        eng16 = dst.init_inference(standin, device=device, config={"dtype": "bfloat16"})
        ids = torch.from_numpy(np.asarray(make_prompts(model.cfg.vocab_size, [INJECT_FORWARD],
                                                       seed=11))).to(device)
        kernel, fwd_counts = counted(f"{name} bf16 forward + cached prefill and decode",
                                     {"flash_forward": eng16.module.cfg.n_layer,
                                      "decode_attention": 2 * eng16.module.cfg.n_layer},
                                     lambda: attention_paths(eng16.module, ids, "kernel"))
        plain = attention_paths(eng16.module, ids, "plain")
        exact = attention_paths(eng16.module, ids, "exact")

        def dist(a, b):
            return max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b))
        err, noise = dist(kernel, plain), dist(plain, exact)
        tol = max(BF16_LOGIT_TOL, LOGIT_NOISE_FACTOR * noise)
        say(f"{name} stand-in bf16 logits ({INJECT_FORWARD}-token forward through flash, its "
            f"prefill and one decode step through the contiguous kernel): kernel vs plain "
            f"attention max abs diff {err:.4f} (tol {tol:.4f}); plain vs exact {noise:.4f}; "
            f"|logits| max {plain[0].abs().max().item():.3f}")
        if not all(torch.isfinite(t).all() for t in kernel) or not err <= tol:
            fail(f"{name} stand-in bf16 logits differ by {err:.4f} > {tol:.4f}")
        out[name] = dict(ties=ties, counts=counts, forward_counts=fwd_counts, err=err)
        del eng16, model, standin, kernel, plain, exact
        gc.collect()
        torch.cuda.empty_cache()

    # GPT-J-6B at full size: bf16 against int8 weights
    _, kw, _ = FAMILY_CELLS["gptj-6b"]
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    model = gpt_mod.GPT(gpt_mod.GPTConfig(**kw, dtype="bfloat16"), device=device, seed=0,
                        param_dtype=torch.bfloat16)
    bf16_peak_init = torch.cuda.max_memory_allocated(device) - before
    eng16 = dst.init_inference(model, device=device, config={"dtype": "bfloat16"})
    eng8 = dst.init_inference(model, device=device, config={"dtype": "int8"})
    if eng16.module is not model or not eng8.module.quantized:
        fail("gptj-6b: the bf16 engine must serve the model itself and the int8 one a "
             "quantized copy")
    qkeys = gpt_mod.QUANT_KEYS
    bf16_bytes = sum(t.numel() * t.element_size() for n, t in model.named_parameters()
                     if n.rsplit(".", 1)[-1] in qkeys)
    int8_bytes = sum(t.numel() * t.element_size() for n, t in eng8.module.named_parameters()
                     if n.endswith((".q8", ".scale")))
    rng = np.random.default_rng(13)
    ids = torch.from_numpy(rng.integers(1, model.cfg.vocab_size, size=(
        INT8_PROMPTS, INT8_PROMPT_LEN))).to(device)
    results = {}
    for label, eng in (("bf16", eng16), ("int8", eng8)):
        step_ms = []
        inner = gpt_mod.gpt_apply_with_cache

        def timed(cfg, params, input_ids, cache, inner=inner, step_ms=step_ms):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = inner(cfg, params, input_ids, cache)
            torch.cuda.synchronize()
            if input_ids.shape[1] == 1:
                step_ms.append((time.perf_counter() - t0) * 1e3)
            return res
        eng.generate(ids[:1, :8], max_new_tokens=2)                 # warm-up
        gpt_mod.gpt_apply_with_cache = timed
        try:
            toks, counts = counted(f"gptj-6b {label} init_inference generate",
                                   {"decode_attention": None},
                                   lambda eng=eng: eng.generate(ids, max_new_tokens=INT8_NEW))
        finally:
            gpt_mod.gpt_apply_with_cache = inner
        with torch.no_grad():
            logits = eng.module.forward_logits(ids)[:, -1, :model.cfg.vocab_size]
        results[label] = dict(tokens=toks[:, INT8_PROMPT_LEN:].cpu(), logits=logits,
                              step_ms=statistics.median(step_ms), counts=counts)
    same = results["bf16"]["tokens"] == results["int8"]["tokens"]
    agree = int(same.long().cumprod(dim=1).sum())                  # up to each first divergence
    logit_dist = (results["bf16"]["logits"] - results["int8"]["logits"]).abs().max().item()
    long_ids = torch.from_numpy(rng.integers(1, model.cfg.vocab_size, size=(
        1, INT8_FORWARD))).to(device)
    logits, flash_counts = counted(f"gptj-6b bf16 {INT8_FORWARD}-token forward",
                                   {"flash_forward": model.cfg.n_layer},
                                   lambda: eng16.forward(long_ids))
    if not torch.isfinite(logits).all():
        fail("gptj-6b: non-finite logits in the long forward")
    peak = torch.cuda.max_memory_allocated(device) - before
    say(f"gptj-6b full size, {model.cfg.n_layer} layers: block weights int8 "
        f"{int8_bytes / 2 ** 30:.2f} GiB (q8 and fp32 scales) against bf16 "
        f"{bf16_bytes / 2 ** 30:.2f} GiB ({int8_bytes / bf16_bytes:.3f}x); bf16 init peak "
        f"{bf16_peak_init / 2 ** 30:.2f} GiB, peak {peak / 2 ** 30:.2f} GiB with both engines "
        f"[{card}]")
    say(f"gptj-6b decode step ({INT8_PROMPTS} rows, median of {INT8_NEW - 1}): bf16 "
        f"{results['bf16']['step_ms']:.2f} ms, int8 {results['int8']['step_ms']:.2f} ms; "
        f"greedy agreement {agree} of {same.numel()} tokens up to each stream's first "
        f"divergence ({int(same.all(dim=1).sum())} of {INT8_PROMPTS} streams identical); "
        f"largest last-position logit distance int8 vs bf16 {logit_dist:.4f} [{card}]")
    out["int8"] = dict(bf16=results["bf16"], int8=results["int8"], agree=agree,
                       tokens=same.numel(), logit_dist=logit_dist, peak_gib=peak / 2 ** 30,
                       int8_gib=int8_bytes / 2 ** 30, bf16_gib=bf16_bytes / 2 ** 30,
                       flash_counts=flash_counts)
    del eng8, eng16, model, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# phases 28-30: ZeRO stages and CPU offload
# --------------------------------------------------------------------------- #
def phase_zero_stages(device, card: str, steps: int = 3, seq: int = TRAIN_SEQ,
                      micro: int = TRAIN_MICRO):
    """Phase 28: GPT-2 at phase 8's fp32 config, ``steps`` graphed steps at
    each of ZERO_CONFIGS, held to phase 8's limits against stage 0 (and
    whether bit for bit).  Each run: one capture, its launch counters exact
    (AdamW once a chunk of offloaded state; with NVMe moments in the walk
    after the replay), then one more replay whose counters are held against
    the captured graph's kernel nodes (and the walk's launches) and the
    profiler's trace.  An NVMe configuration swaps in a fresh directory
    under ``ckpt_root()`` with NVME_AIO's knobs, removed after its run."""
    import torch
    from deepspeed_tpu_torch.models.gpt import GPT, gpt_config
    _, tce, _, _, _ = kernel_modules()
    cfg = gpt_config("gpt2", n_positions=seq, remat=True, dtype="float32")
    base = {k: v for k, v in TRAIN_CFG.items() if k != "bf16"}
    ce_launches = tce.launches_per_call(micro * seq, cfg.n_embd, cfg.padded_vocab,
                                        torch.float32, bias=cfg.head_bias)
    runs = {}
    for name, zero in ZERO_CONFIGS.items():
        gc.collect()
        torch.cuda.empty_cache()
        model = GPT(cfg, device=device, seed=0)
        swap = None
        if NVME in (zero.get("offload_param"), zero.get("offload_optimizer")):
            swap = tempfile.mkdtemp(prefix="chip_smoke_nvme_", dir=ckpt_root())
            zero = with_nvme_path(zero, swap)
        config = dict(base, zero_optimization=zero, **({"aio": NVME_AIO} if swap else {}))
        engine = train_engine(model, config, device)
        engine.graphs.accelerator = KeptGraphs(engine.graphs.accelerator)
        batch = train_batch_of(cfg.vocab_size, device, seq, micro)
        adam = adam_launches(engine)
        label = f"fp32 train gpt2 seq {seq} {name}"
        t0 = time.perf_counter()
        losses, counts = counted(
            f"{label} graphed ({steps} steps)",
            train_expect("auto", seq, cfg.n_layer, steps, ce_launches=ce_launches,
                         adam_launches=adam),
            lambda: [float(engine.train_batch(batch=batch)) for _ in range(steps)])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        params = engine.get_fp32_params()
        if engine.graphs.captures != 1:
            fail(f"{label}: {engine.graphs.captures} captures for one batch signature")
        prof = profile_train_step(engine, batch, card, graphed=True, split=False)
        runs[name] = dict(losses=losses, params=params, counts=counts, adam=adam, secs=secs,
                          world=engine.world_size, stage=engine.zero_optimization_stage(),
                          pinned=engine.pinned_bytes(), profile=prof)
        say(f"{label}: world size {engine.world_size}, stage {runs[name]['stage']}, AdamW "
            f"launches a step {adam}, losses {losses}, {secs:.2f} s for {steps} steps (warm-up "
            f"and capture included), pinned host bytes {runs[name]['pinned']:,} [{card}]"
            + (f"; NVMe: the walk after each replay, {adam} chunks read and written a step, "
               f"last step's offload record {json.dumps(engine.last_offload_record)}"
               if swap else ""))
        engine.close()
        del engine, model
        if swap:
            shutil.rmtree(swap, ignore_errors=True)
    ref = runs["stage0"]
    for name, r in runs.items():
        same = bitwise_equal(r["losses"], r["params"], ref["losses"], ref["params"])
        loss_rel, worst, worst_key, rel_l2 = trajectory_diff(r["losses"], r["params"],
                                                             ref["losses"], ref["params"])
        r.update(bitwise=same, loss_rel=loss_rel, param_max=worst, param_rel_l2=rel_l2)
        say(f"zero {name} vs stage 0 over {steps} steps: bitwise equal {same}; losses max rel "
            f"diff {loss_rel:.3e} (tol {TRAIN_LOSS_RTOL:g}), params max abs diff {worst:.3e} "
            f"in {worst_key} (tol {TRAIN_PARAM_ATOL:g}), relative L2 {rel_l2:.3e} (tol "
            f"{TRAIN_PARAM_REL_L2:g})")
        if not (loss_rel <= TRAIN_LOSS_RTOL and worst <= TRAIN_PARAM_ATOL
                and rel_l2 <= TRAIN_PARAM_REL_L2):
            fail(f"zero {name}: the trajectory differs from stage 0 past phase 8's limits")
    for r in runs.values():
        del r["params"]
    return runs


def with_nvme_path(zero, path: str):
    """``zero`` with ``nvme_path`` set in its NVMe offload blocks."""
    return {k: (dict(v, nvme_path=path) if isinstance(v, dict) and v.get("device") == "nvme"
                else v) for k, v in zero.items()}


def mem_available() -> int:
    """MemAvailable of /proc/meminfo, in bytes."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    fail("/proc/meminfo has no MemAvailable")


def pinned_bandwidth(device, nbytes: int = PINNED_PROBE_BYTES, reps: int = 5):
    """(host->device, device->host) bytes/s of one ``nbytes`` copy between
    the device and host memory registered as the engine's offload holds it
    (``FlatStore``), by CUDA events, median of ``reps``."""
    import torch
    from deepspeed_tpu_torch.runtime.zero.partition_parameters import FlatStore
    n = nbytes // 4
    host = FlatStore(n, device, host=True, piece=n)
    dev = torch.empty(n, dtype=torch.float32, device=device)
    try:
        h2d = median_ms(lambda: dev.copy_(host.pieces[0], non_blocking=True), reps)
        d2h = median_ms(lambda: host.pieces[0].copy_(dev, non_blocking=True), reps)
    finally:
        torch.cuda.synchronize()
        host.close()
    return nbytes / (h2d / 1e3), nbytes / (d2h / 1e3)


def offload_traffic(engine):
    """(host->device, device->host) bytes of one step of an offloaded ZeRO
    engine, from its layout: each gather of a unit's fp32 partition (a
    block twice a micro-step under remat: the forward and the recompute;
    the other units once), and each chunk of staged optimizer state in and
    out."""
    z, opt = engine.zero, engine.optimizer
    gas = engine.gradient_accumulation_steps()
    remat = bool(getattr(getattr(engine.module, "cfg", None), "remat", False))
    h2d = d2h = 0
    if z.master is not None and z.master.host:
        for u in z.layout.units:
            h2d += 4 * u.part * gas * (2 if remat and u.name.startswith("blocks.") else 1)
    for _, length, _ in opt.chunks:
        h2d += 4 * length * len(opt.staged)
        d2h += 4 * length * len(opt.staged)
    return h2d, d2h


def memory_model_plan(engine, n_layer: int):
    """The memory model's numbers for an offloaded stage-3 engine at world
    size 1: the JAX model's plain and layer-window peaks (bf16 compute, one
    block prefetched; activations are not in it) and the host bytes
    ``host_state_bytes`` gives."""
    from deepspeed_tpu_torch.runtime import memory_model as mm
    lay = engine.zero.layout
    n = lay.numel
    blk = sum(u.numel for u in lay.units if u.name.startswith("blocks."))
    peaks = mm.analytic_step_peaks(n, 1, compute_itemsize=2, block_params=blk,
                                   n_layer=n_layer, prefetch_depth=1, optimizer_tier="cpu")
    return dict(params=n, plain_peak=peaks.plain_peak_bytes, window_peak=peaks.window_peak_bytes,
                host=mm.host_state_bytes(n, 1, True, True))


def phase_zero_offload(device, card: str, label: str, bandwidth, stage0_device_ms=None, **kw):
    """Phases 29-30: ``phase_train_bf16`` (``kw``) at stage 3 with both
    offloads, and the offload readings: bytes a step each way, the step's
    floor (the step's device time outside host-device copies, and
    ``stage0_device_ms`` where given, plus the bytes over the measured
    pinned bandwidth), peak device memory and pinned host bytes beside the
    memory model's plan."""
    def readings(engine, batch):
        h2d, d2h = offload_traffic(engine)
        return dict(h2d=h2d, d2h=d2h, pinned=engine.pinned_bytes(),
                    plan=memory_model_plan(engine, engine.module.cfg.n_layer),
                    chunks=adam_launches(engine), stage=engine.zero_optimization_stage())
    r = phase_train_bf16(device, card, profiled=False, after=readings, **kw)
    a = r["after"]
    copy_s = a["h2d"] / bandwidth[0] + a["d2h"] / bandwidth[1]
    prof = r["profile"] or {}
    compute_ms = prof["device_ms"] - prof["copy_ms"] if prof else float("nan")
    a.update(copy_floor_ms=copy_s * 1e3, floor_ms=compute_ms + copy_s * 1e3,
             compute_ms=compute_ms,
             stage0_floor_ms=(stage0_device_ms + copy_s * 1e3) if stage0_device_ms else None)
    gib = 2 ** 30
    plan = a["plan"]
    say(f"{label}: stage {a['stage']} with offload_param and offload_optimizer (cpu), "
        f"{plan['params']:,} params; graphed step {r['step_ms']:.3f} ms (device "
        f"{device_ms(r):.3f}, of it {prof.get('copy_ms', float('nan')):.3f} host-device copies), "
        f"eager step {r['eager_step_ms']:.3f} ms; host->device {a['h2d'] / 1e9:.3f} GB and "
        f"device->host {a['d2h'] / 1e9:.3f} GB a step ({a['chunks']} AdamW chunks); pinned "
        f"bandwidth {bandwidth[0] / 1e9:.2f} GB/s up, {bandwidth[1] / 1e9:.2f} GB/s down; floor "
        f"{a['floor_ms']:.3f} ms (device time outside copies {compute_ms:.3f} + copies at that "
        f"bandwidth {a['copy_floor_ms']:.3f})"
        + (f", {a['stage0_floor_ms']:.3f} ms from the stage-0 step's device time "
           f"{stage0_device_ms:.3f}" if stage0_device_ms else "")
        + f"; step / floor {r['step_ms'] / a['floor_ms']:.2f}; peak device memory graphed "
        f"{r['memory']['graphed_alloc_gib']:.2f} GiB allocated / "
        f"{r['memory']['graphed_reserved_gib']:.2f} reserved, eager "
        f"{r['memory']['eager_alloc_gib']:.2f} allocated; the memory model's layer-window peak "
        f"{plan['window_peak'] / gib:.2f} GiB (plain stage-3 {plan['plain_peak'] / gib:.2f}; "
        f"no activations); pinned host {a['pinned'] / gib:.2f} GiB held, model "
        f"{plan['host'] / gib:.2f} GiB; loss {r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}; "
        f"{r['tflops']:.2f} TFLOPs [{card}]")
    return r


def llama_offload_depth(available: int):
    """Llama-3-8B's widths at LLAMA_MIN_LAYERS layers, whose pinned host
    state (``host_state_bytes``) must fit what MemAvailable leaves after
    HOST_RESERVE_*: (layers, params, host bytes).  The deepest cut that
    fits, 20 layers on an H100 machine's host, took ~12 s more of the
    script's 1200 s."""
    from deepspeed_tpu_torch.models.gpt import count_params, llama_config
    from deepspeed_tpu_torch.runtime import memory_model as mm
    _, kw, _ = FAMILY_CELLS["llama3-8b"]
    room = (1 - HOST_RESERVE_FRACTION) * available - HOST_RESERVE_BYTES
    n = count_params(llama_config(**dict(kw, n_layer=LLAMA_MIN_LAYERS)))
    host = mm.host_state_bytes(n, 1, True, True)
    if host > room:
        fail(f"MemAvailable {available / 2 ** 30:.1f} GiB holds fewer than {LLAMA_MIN_LAYERS} "
             f"layers of Llama-3-8B's offloaded state")
    return LLAMA_MIN_LAYERS, n, host


# --------------------------------------------------------------------------- #
# phase 42: ZeRO-Infinity's NVMe tier at GPT-2 XL
# --------------------------------------------------------------------------- #
def proc_io():
    """``/proc/self/io`` as a dict: ``read_bytes`` / ``write_bytes`` are the
    bytes this process made the block layer fetch and send (what reached
    storage rather than the page cache, where the filesystem counts it)."""
    out = {}
    for line in Path("/proc/self/io").read_text().splitlines():
        key, _, val = line.partition(":")
        out[key.strip()] = int(val)
    return out


def o_direct_accepted(folder: str) -> bool:
    """Whether the filesystem of ``folder`` opens a file with O_DIRECT (the
    aio engine falls back to buffered I/O where it does not)."""
    path = os.path.join(folder, "o_direct_probe")
    try:
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | getattr(os, "O_DIRECT", 0), 0o644)
    except OSError:
        return False
    os.close(fd)
    os.remove(path)
    return hasattr(os, "O_DIRECT")


def aio_reading(folder: str, device, card: str, nbytes: int = AIO_PROBE_BYTES):
    """``nbytes`` of random bytes written and read back through
    ``AIOHandle`` (NVME_AIO's threads and block size) in ``folder``, from
    and into pinned (page-aligned) tensors, with and without
    ``use_o_direct``: bytes equal; GB/s each way by the host clock.  The
    read follows the write, so it may be served from the page cache
    (warm).  (mode -> (write GB/s, read GB/s))."""
    import torch
    from deepspeed_tpu_torch.ops.aio import AIOHandle
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    src.copy_(torch.randint(0, 256, (nbytes,), dtype=torch.uint8, device=device))
    back = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    direct = o_direct_accepted(folder)
    out = {}
    for od in (False, True):
        h = AIOHandle(block_size=NVME_AIO["block_size"], queue_depth=NVME_AIO["queue_depth"],
                      num_threads=NVME_AIO["thread_count"], use_o_direct=od)
        path = os.path.join(folder, f"aio_{int(od)}.bin")
        back.zero_()
        t0 = time.perf_counter()
        h.pwrite(src, path)
        w_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        h.pread(back, path)
        r_s = time.perf_counter() - t0
        h.close()
        os.remove(path)
        if not torch.equal(back, src):
            fail(f"AIOHandle (use_o_direct={od}): the bytes read back differ from those written")
        out["o_direct" if od else "buffered"] = (nbytes / w_s / 1e9, nbytes / r_s / 1e9)
        say(f"AIOHandle use_o_direct={od}: {nbytes / 2 ** 30:.0f} GiB written "
            f"{nbytes / w_s / 1e9:.3f} GB/s, read back (warm) {nbytes / r_s / 1e9:.3f} GB/s, "
            f"bytes equal; buffers page-aligned {src.data_ptr() % 4096 == 0}, the filesystem "
            f"{'takes' if direct else 'refuses'} O_DIRECT"
            + ("" if direct or not od else " (so the engine ran buffered)") + f" [{card}]")
    return out


def llama_depths(available: int, disk_free: int, piece: int):
    """The depth at Llama-3-8B's widths that the host admits with both
    offloads to the host (phase 30's reckoning: 12 bytes a parameter
    pinned within what HOST_RESERVE_* leave of MemAvailable) and with the
    moments on NVMe (4 bytes a parameter pinned plus the walk's bounce
    buffers, two a moment of one ``piece``; 8 bytes a parameter on the
    swap path plus one temporary file a bounce buffer in flight):
    (host-tier layers, NVMe-tier layers, full depth)."""
    from deepspeed_tpu_torch.models.gpt import count_params, llama_config
    from deepspeed_tpu_torch.runtime import memory_model as mm
    _, kw, _ = FAMILY_CELLS["llama3-8b"]
    room = (1 - HOST_RESERVE_FRACTION) * available - HOST_RESERVE_BYTES
    full = kw["n_layer"]
    host_depth = nvme_depth = 0
    for layers in range(1, full + 1):
        n = count_params(llama_config(**dict(kw, n_layer=layers)))
        if mm.host_state_bytes(n, 1, True, True) <= room:
            host_depth = layers
        inflight = 4 * 4 * min(piece, n)
        if (mm.host_state_bytes(n, 1, True, False) + inflight <= room
                and 8 * n + inflight <= disk_free):
            nvme_depth = layers
    return host_depth, nvme_depth, full


def adam_chunk_case(device, flush, n: int, reps: int = 10, plain_reps: int = 2):
    """The fused AdamW kernel over one chunk of the NVMe walk (``n`` fp32
    values of master, gradient and moments, one flat leaf, a mid-training
    state) bit for bit against the plain version; ``torch._fused_adamw_``
    on the same values as the yardstick."""
    import torch
    tfo = kernel_modules()[2]
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def randn(scale):
        return torch.randn(n, generator=gen, device=device) * scale
    p, g, mu, nu = randn(2e-2), randn(1e-3), randn(1e-4), randn(1e-3).square()
    spec = tfo.spec_from_config("adamw", {"weight_decay": 0.01}, 1e-4)
    neg_lr, bc1, bc2 = tfo.step_scalars(spec, torch.tensor(10, dtype=torch.int32,
                                                           device=device))
    scal = torch.stack([torch.tensor(0.5, device=device), torch.tensor(0.7, device=device),
                        neg_lr, bc1, bc2])
    kw = dict(b1=spec["b1"], b2=spec["b2"], eps=spec["eps"], wd=spec["wd"])
    a = [[p.clone()], [g], [mu.clone()], [nu.clone()]]
    b = [[p], [g], [mu], [nu]]
    table = tfo.AdamTable(*a)
    tfo.fused_adam(table, scal, **kw)
    tfo.adam_reference(*b, scal, **kw)
    torch.cuda.synchronize()
    mismatches = sum(int((x[0] != y[0]).sum()) for x, y in zip(a, b))
    err = max((x[0] - y[0]).abs().max().item() for x, y in zip(a, b))
    say(f"fused_adam (gpt2-xl NVMe walk chunk): {n:,} values; {mismatches} elements differ "
        f"from the plain version (bitwise contract)")
    if mismatches:
        fail(f"fused_adam (NVMe walk chunk): {mismatches} elements differ from the plain version")
    steps = [torch.tensor(10.0, device=device)]
    lib = median_ms(lambda: torch._fused_adamw_(
        a[0], [g], a[2], a[3], [], steps, lr=1e-4, beta1=0.9, beta2=0.999,
        weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False), reps, flush)
    b_ms, b_by = bound(28 * n, 20.0 * n, "float32")
    row = dict(kernel="fused_adam", case="gpt2-xl-nvme-chunk", dtype="float32", err=err,
               scaled=err, ms=median_ms(lambda: tfo.fused_adam(table, scal, **kw), reps, flush),
               plain_ms=median_ms(lambda: tfo.adam_reference(*b, scal, **kw), plain_reps, flush),
               bound_ms=b_ms, bound_by=b_by, library_ms=lib,
               note="library: torch._fused_adamw_ on the same values")
    del a, b, table, p, g, mu, nu
    torch.cuda.empty_cache()
    return row


def phase_nvme_offload(device, card: str, ref, flush):
    """Phase 42: GPT-2 XL at phase 29's config (bf16, seq 512, micro 8,
    stage 3, ``offload_param: cpu``) with ``offload_optimizer: nvme`` on a
    fresh directory of the machine's disk (its filesystem and free bytes
    printed; tmpfs, or less room than NVME_ROOM_FACTOR times the moments,
    fails), NVME_AIO's staging knobs.  Before it, ``aio_reading`` on that
    directory.  One warm-up step (the capture) and two timed ones: their
    losses bit for bit phase 29's first three (``ref``: its result), one
    capture, the launches exact (AdamW once a chunk a step, in the walk).
    Readings (no limits): the engine's build (with the initial persist of
    zeroed moments), each step's ms split into the replay (to a device
    sync before the walk) and the walk, the staging bytes read and written
    beside ``/proc/self/io``'s deltas, ``offload_wait`` ms, ring hits and
    misses, pinned host bytes against phase 29's, peak device memory, and
    Llama-3-8B's depth that MemAvailable and the disk admit with the
    moments on the host and on NVMe.  Then one walk chunk of AdamW against
    its plain version (the kernel table's row)."""
    import torch
    from deepspeed_tpu_torch.models.gpt import GPT, gpt_config
    from deepspeed_tpu_torch.runtime.swap_tensor.partitioned_param_swapper import (
        MEMORY_FILESYSTEMS, filesystem_type)
    warm, timed = NVME_XL
    gib = 2 ** 30
    swap = tempfile.mkdtemp(prefix="chip_smoke_nvme_", dir=ckpt_root())
    try:
        cfg = gpt_config("gpt2-xl", n_positions=TRAIN_SEQ, remat=True)
        fs, free = filesystem_type(swap), shutil.disk_usage(swap).free
        available = mem_available()
        gc.collect()
        torch.cuda.empty_cache()
        model = GPT(cfg, device=device, seed=0)
        n_params = sum(p.numel() for p in model.parameters())
        moments = 8 * n_params
        say(f"gpt2-xl nvme: swap path {swap} on {fs}, {free / 1e9:.2f} GB free; the moments "
            f"{moments / 1e9:.2f} GB ({NVME_ROOM_FACTOR}x: {NVME_ROOM_FACTOR * moments / 1e9:.2f}"
            f" GB); MemAvailable {available / gib:.2f} GiB [{card}]")
        if fs in MEMORY_FILESYSTEMS:
            fail(f"gpt2-xl nvme: the swap path is on {fs}, host memory, not a disk")
        if free < NVME_ROOM_FACTOR * moments:
            fail(f"gpt2-xl nvme: {free / 1e9:.2f} GB free, less than {NVME_ROOM_FACTOR}x the "
                 f"moments")
        aio = aio_reading(swap, device, card)
        zero = with_nvme_path(dict(ZERO3_OFFLOAD, offload_optimizer=NVME), swap)
        t0 = time.perf_counter()
        engine = train_engine(model, dict(TRAIN_CFG, zero_optimization=zero, aio=NVME_AIO),
                              device)
        build_s = time.perf_counter() - t0
        batch = train_batch_of(cfg.vocab_size, device)
        chunks = adam_launches(engine)
        ce_launches = kernel_modules()[1].launches_per_call(
            TRAIN_MICRO * TRAIN_SEQ, cfg.n_embd, cfg.padded_vocab, torch.bfloat16,
            bias=cfg.head_bias)
        walk_s = []
        walk = engine.optimizer.walk

        def timed_walk():
            torch.cuda.synchronize()         # the replay's device work ends here
            t = time.perf_counter()
            walk()
            walk_s.append(time.perf_counter() - t)
        engine.optimizer.walk = timed_walk
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps = []

        def run():
            out = []
            for _ in range(warm + timed):
                io0, t0 = proc_io(), time.perf_counter()
                out.append(engine.train_batch(batch=batch))
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                io1 = proc_io()
                steps.append(dict(ms=ms, walk_ms=walk_s[-1] * 1e3,
                                  replay_ms=ms - walk_s[-1] * 1e3,
                                  io_read=io1["read_bytes"] - io0["read_bytes"],
                                  io_write=io1["write_bytes"] - io0["write_bytes"],
                                  rec=dict(engine.last_offload_record)))
            return out
        label = "bf16 train gpt2-xl seq 512 nvme"
        losses, counts = counted(
            f"{label} ({warm} warm-up, {timed} timed)",
            train_expect("auto", TRAIN_SEQ, cfg.n_layer, warm + timed, ce_launches=ce_launches,
                         adam_launches=chunks), run)
        vals = [float(v) for v in losses]
        peak = (torch.cuda.max_memory_allocated() / gib, torch.cuda.max_memory_reserved() / gib)
        pinned = engine.pinned_bytes()
        captures = engine.graphs.captures
        piece = engine.optimizer.chunks[0][1]
        engine.close()
        del engine, model
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(swap, ignore_errors=True)
    want = ref["losses"][:warm + timed]
    same = vals == want
    say(f"{label}: losses {vals} against phase 29's first {warm + timed} {want}: bitwise "
        f"equal {same}; {captures} capture; AdamW {chunks} launches a step in the walk")
    if captures != 1:
        fail(f"{label}: {captures} captures for one batch signature")
    if not same:
        fail(f"{label}: the losses differ from phase 29's")
    for i, st in enumerate(steps):
        r = st["rec"]
        say(f"{label} step {i} ({'warm-up and capture' if i < warm else 'timed'}): "
            f"{st['ms']:.1f} ms = replay {st['replay_ms']:.1f} + walk {st['walk_ms']:.1f}; "
            f"staging read {r['optimizer_bytes_read'] / 1e9:.3f} GB, wrote "
            f"{r['optimizer_bytes_written'] / 1e9:.3f} GB; /proc/self/io read_bytes "
            f"{st['io_read'] / 1e9:.3f} GB, write_bytes {st['io_write'] / 1e9:.3f} GB; "
            f"offload_wait {r['wait_ms']:.1f} ms; ring hits {r['ring_hits']}, misses "
            f"{r['ring_misses']} [{card}]")
    timed_steps_ = steps[warm:]
    host_depth, nvme_depth, full = llama_depths(available, free, piece)
    say(f"{label}: engine build {build_s:.1f} s (the initial persist of "
        f"{moments / 1e9:.2f} GB of zeroed moments included); timed steps "
        f"{statistics.median(s['ms'] for s in timed_steps_):.1f} ms median (replay "
        f"{statistics.median(s['replay_ms'] for s in timed_steps_):.1f}, walk "
        f"{statistics.median(s['walk_ms'] for s in timed_steps_):.1f}); pinned host "
        f"{pinned / gib:.2f} GiB against phase 29's {ref['after']['pinned'] / gib:.2f}; peak "
        f"device memory {peak[0]:.2f} GiB allocated, {peak[1]:.2f} reserved (phase 29: "
        f"{ref['memory']['graphed_alloc_gib']:.2f} / {ref['memory']['graphed_reserved_gib']:.2f}); "
        f"Llama-3-8B's widths: MemAvailable {available / gib:.2f} GiB and {free / 1e9:.2f} GB "
        f"of disk admit {host_depth} of {full} layers with the moments on the host, "
        f"{nvme_depth} of {full} with them on NVMe [{card}]")
    row = adam_chunk_case(device, flush, piece)
    return dict(losses=vals, counts=counts, steps=steps, pinned=pinned, peak=peak,
                build_s=build_s, aio=aio, depths=(host_depth, nvme_depth, full), row=row,
                chunks=chunks)


# --------------------------------------------------------------------------- #
# phases 31-33: tiered KV, bounded dispatch and recovery, sampled generate()
# --------------------------------------------------------------------------- #
class RestageCheck:
    """Holds every restage of a tiered engine to its spill, byte for byte,
    apart from the tiering code: after each spill the spilled blocks as the
    arena holds them are gathered here to the host (an ``index_select`` and
    ``.cpu()`` into pageable memory, timed: the plain copy beside the
    engine's); after each restage the blocks they landed in are gathered
    and compared as raw bytes."""

    def __init__(self, eng):
        import torch
        self.eng, self.saved = eng, {}
        self.restages = self.blocks = 0
        self.seconds = 0.0             # the check's own gathers, inside the run's wall
        self.spill_bytes, self.spill_seconds = 0, 0.0   # of it, those after a spill
        adapter = eng.sched.tiering
        spill, restage = adapter.spill, adapter.restage

        def host(blocks):
            t0 = time.perf_counter()
            idx = torch.tensor(blocks, dtype=torch.long, device=eng.device)
            out = [p.index_select(1, idx).view(torch.uint8).cpu()
                   for p in (eng._k_pages, eng._v_pages)]
            self.seconds += time.perf_counter() - t0
            return out

        def checked_spill(req):
            blocks = eng.alloc.owned_blocks(req.rid)[:eng.alloc.blocks_for_tokens(req.prefilled)]
            tier = spill(req)
            if tier is not None:
                t0 = self.seconds
                self.saved[req.rid] = host(blocks)
                self.spill_seconds += self.seconds - t0
                self.spill_bytes += sum(a.numel() for a in self.saved[req.rid])
            return tier

        def checked_restage(req):
            ok = restage(req)
            saved = self.saved.pop(req.rid, None)
            if ok:
                n = eng.alloc.blocks_for_tokens(req.spilled_tokens)
                got = host(eng.alloc.owned_blocks(req.rid)[:n])
                if saved is None or not all(torch.equal(a, b) for a, b in zip(got, saved)):
                    fail(f"request {req.rid}: a restaged block differs from what was spilled")
                self.restages += 1
                self.blocks += n
            return ok
        adapter.spill, adapter.restage = checked_spill, checked_restage


class DispatchLog:
    """Wraps an engine's model step: counts the dispatches started and
    returned (a dispatch abandoned by a timeout returns later, on its own
    thread, and launches its kernels all the same) and keeps each one's
    logits-finite flag.  One step at a time: the abandoned dispatch and
    the engine's next one do not interleave their launch counts.
    ``restore`` puts the model's own step back."""

    def __init__(self, eng):
        import threading
        import torch
        self.started, self.finite = 0, []
        self.module, self.own = eng.module, vars(eng.module).get("paged_step")
        inner, lock = eng.module.paged_step, threading.Lock()

        def step(*args):
            with lock:
                self.started += 1
                out = inner(*args)
                self.finite.append(torch.isfinite(out[0]).all())
            return out
        eng.module.paged_step = step

    def restore(self):
        if self.own is None:
            del self.module.paged_step       # the class's method again
        else:
            self.module.paged_step = self.own

    def join(self, timeout_s: float = 30.0):
        """Wait until every started dispatch has returned."""
        t0 = time.monotonic()
        while len(self.finite) < self.started and time.monotonic() - t0 < timeout_s:
            time.sleep(0.01)
        if len(self.finite) < self.started:
            fail(f"{self.started - len(self.finite)} dispatch(es) never returned")


def serve_waves(eng, prompts, new_tokens):
    """Submit the requests in TIERED_WAVES, drive to completion; (futures,
    prefill tokens dispatched, seconds of each step)."""
    from deepspeed_tpu_torch.serving.engine import ServeStepTimeout
    futs, prefill, steps = [], 0, []

    def step():
        nonlocal prefill
        t0 = time.perf_counter()
        try:
            stats = eng.step()
        except ServeStepTimeout as e:
            say(f"incident: {e} (recovered in {eng.last_recovery_s * 1e3:.1f} ms)")
            return
        steps.append(time.perf_counter() - t0)
        prefill += stats["prefill_tokens"]
    for n, slo, after in TIERED_WAVES:
        futs += [eng.submit(p, max_new_tokens=new_tokens, slo=slo)
                 for p in prompts[len(futs):len(futs) + n]]
        for _ in range(after):
            step()
    while eng.sched.has_work:
        step()
    return futs, prefill, steps


def same_tokens(model, prompts, futs, ref_futs, label: str, tie: float) -> int:
    """Token identity with a reference run; a divergence counts as a
    near-tie only where generate()'s top-two logits at the first differing
    position are within ``tie``, and ends that request's comparison (its
    later tokens follow another context).  Prints how many tokens were
    compared; returns the near-tie count."""
    ties = compared = total = 0
    for i, (p, f, r) in enumerate(zip(prompts, futs, ref_futs)):
        got, ref = f.token_ids, r.token_ids
        if len(got) != len(ref):
            fail(f"{label}: request {i} has {len(got)} tokens, the reference {len(ref)}")
        total += len(ref)
        if got == ref:
            compared += len(ref)
            continue
        k = next(j for j, (a, b) in enumerate(zip(got, ref)) if a != b)
        compared += k + 1
        gap = top2_gap(model, p + ref[:k])
        if gap > tie:
            fail(f"{label}: request {i} diverges at token {k} ({got[k:k + 4]} vs "
                 f"{ref[k:k + 4]}), top-2 gap {gap:.3e} > {tie:.3e}")
        ties += 1
        say(f"{label}: request {i} near-tie at token {k} (gap {gap:.3e})")
    say(f"{label}: {ties} near-ties (bound {tie:.3e}); {compared} of {total} tokens "
        f"compared")
    return ties


def gap_spread(model, prompts, futs, label: str, tie: float) -> dict:
    """The top-two logit gap at every generated position of a run (one
    forward a request over its prompt and tokens): how many positions a
    near-tie bound of ``tie`` would excuse."""
    import torch
    gaps = []
    for p, f in zip(prompts, futs):
        ids = p + f.token_ids[:-1]
        cache = model.init_cache(1, len(ids))
        logits, _ = model.apply_with_cache(torch.tensor([ids], device=model.device), cache)
        top = torch.topk(logits[0, len(p) - 1:, :model.cfg.vocab_size].float(), 2).values
        gaps += (top[:, 0] - top[:, 1]).tolist()
    gaps.sort()
    out = dict(n=len(gaps), under=sum(g <= tie for g in gaps), min=gaps[0],
               p1=gaps[len(gaps) // 100], p5=gaps[len(gaps) // 20],
               median=gaps[len(gaps) // 2])
    say(f"{label}: top-2 logit gaps at its {out['n']} generated positions: min "
        f"{out['min']:.3e}, 1% {out['p1']:.3e}, 5% {out['p5']:.3e}, median "
        f"{out['median']:.3e}; {out['under']} at or under the near-tie bound {tie:.3e}")
    return out


def path_noise(model, prompt) -> float:
    """Largest logit distance between the two bf16 paths that give one
    position's logits in serving: the prefill chunk's last row over
    ``prompt``, and a decode step feeding its last token after a prefill of
    the rest.  Resumed and recomputed requests take the first where an
    uninterrupted one takes the second."""
    _, prefilled, _ = first_decode_logits(model, prompt, "kernel")
    _, _, decoded = first_decode_logits(model, prompt[:-1], "kernel", tok=prompt[-1])
    return (prefilled.float() - decoded.float()).abs().max().item()


def tiered_config(blocks: int, tiering: bool, offload_dir=None, dtype="bfloat16",
                  host_bytes=None, **extra):
    host_bytes = TIERED_HOST_BYTES if host_bytes is None else host_bytes
    return {"serving": dict(SERVE_CFG, num_blocks=blocks, dtype=dtype, kv_tiering=tiering,
                            kv_host_cache_bytes=host_bytes, kv_offload_dir=offload_dir,
                            **extra)}


def tiered_run(model, prompts, device, label: str, config, card: str, plan=None):
    """One serve of ``prompts`` through ``init_serving(config)``: the launch
    counters zeroed just before and read just after, every dispatch's
    logits finite and n_layer paged launches each, every request complete;
    a tiered engine's restages held byte for byte to its spills.  A fault
    ``plan`` is installed after the warm-up request."""
    import torch
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.testing import fault_injection as fi

    eng = dst.init_serving(model=model, device=device, config=config)
    eng.submit(prompts[0][:20], max_new_tokens=4).result()      # warm-up, both phases
    check = RestageCheck(eng) if eng.tiering is not None else None
    log = DispatchLog(eng)
    if plan is not None:
        fi.install_plan(plan)
    t0 = time.perf_counter()
    try:
        (futs, prefill, steps), counts = counted(
            label, {"paged_attention": None}, lambda: (serve_waves(eng, prompts, TIERED_NEW),
                                                       log.join(), torch.cuda.synchronize())[0])
    finally:
        fi.clear_plan()
        log.restore()
    wall = time.perf_counter() - t0
    if not all(bool(f) for f in log.finite):
        fail(f"{label}: non-finite logits")
    if counts["paged_attention"] != model.cfg.n_layer * log.started:
        fail(f"{label}: {counts['paged_attention']} paged launches in {log.started} "
             f"dispatches, expected {model.cfg.n_layer} per dispatch")
    if any(len(f.token_ids) != TIERED_NEW for f in futs):
        fail(f"{label}: a request lost tokens")
    eng.alloc.check_consistent()
    r = dict(eng=eng, futs=futs, prefill=prefill, wall=wall, steps=steps, counts=counts,
             dispatches=log.started, preemptions=eng.sched.preemption_count,
             spills=eng.sched.spill_count, restages=eng.sched.restage_count,
             incidents=eng.incident_count, check=check)
    checked = "" if check is None else f" (of it {check.seconds:.3f} s in the byte check)"
    say(f"{label}: {len(futs)} requests x {TIERED_NEW} tokens in {wall:.3f} s{checked} "
        f"({len(futs) * TIERED_NEW / wall:.1f} tokens/s), {len(steps)} steps (median "
        f"{statistics.median(steps) * 1e3:.2f} ms), {log.started} dispatches, {prefill} prefill "
        f"tokens, preemptions {r['preemptions']}, spills {r['spills']}, restages "
        f"{r['restages']}, incidents {r['incidents']} [{card}]")
    return r


def tiering_numbers(r, card: str, label: str = "tiering"):
    """The copies' and the tiers' readings of one tiered run."""
    mgr, check = r["eng"].tiering, r["check"]
    staged = mgr.staging.snapshot()
    waits = mgr.restage_waits
    h2d_s = mgr.h2d_s
    out = dict(spills=r["spills"], restages=r["restages"], sources=dict(mgr.restage_sources),
               d2h_gb=mgr.d2h_bytes / 1e9, h2d_gb=mgr.h2d_bytes / 1e9,
               d2h_gbs=mgr.d2h_bytes / mgr.d2h_s / 1e9 if mgr.d2h_s else 0.0,
               h2d_gbs=mgr.h2d_bytes / h2d_s / 1e9 if h2d_s else 0.0,
               cpu_gbs=(check.spill_bytes / check.spill_seconds / 1e9
                        if check.spill_seconds else 0.0),
               disk_written_gb=staged["bytes_written"] / 1e9,
               disk_read_gb=staged["bytes_read"] / 1e9,
               wait_ms=statistics.median(waits) * 1e3 if waits else 0.0,
               checked=check.restages, checked_blocks=check.blocks)
    say(f"{label}: {out['spills']} spills, {out['restages']} restages "
        f"({out['sources']['host']} from host memory, {out['sources']['nvme']} from disk); "
        f"spills {out['d2h_gb']:.3f} GB device->host at {out['d2h_gbs']:.2f} GB/s (host clock "
        f"until spill() returns: index_select on the engine's stream, the copy into pinned "
        f"memory, its event); the same spills through index_select + .cpu() into pageable "
        f"memory {out['cpu_gbs']:.2f} GB/s (the byte check's gathers); restages "
        f"{out['h2d_gb']:.3f} GB host->device at {out['h2d_gbs']:.2f} GB/s (device time of "
        f"the copy and index_copy_); disk tier {out['disk_written_gb']:.3f} GB written (every "
        f"spill, write-through), {out['disk_read_gb']:.3f} GB read; median restage wait "
        f"{out['wait_ms']:.3f} ms; {out['checked']} restages ({out['checked_blocks']} blocks) "
        f"equal their spilled bytes [{card}]")
    if out["checked"] != out["restages"]:
        fail(f"{label}: {out['checked']} of {out['restages']} restages checked")
    return out


def tiered_cell(device):
    """Phases 31-32's cell: Llama-3-8B at its published widths and
    TIERED_LAYERS layers in bf16 (seeded weights, made in bf16 on the card), the 12
    requests, the near-tie bound of its bf16 paths, and a folder for the
    disk tier (under $TMPDIR or the checkout, whichever has more room)."""
    import torch
    from deepspeed_tpu_torch.models import gpt as gpt_mod

    ctor, kw, _ = FAMILY_CELLS["llama3-8b"]
    cfg = getattr(gpt_mod, ctor)(**dict(kw, n_layer=TIERED_LAYERS), dtype="bfloat16")
    model = gpt_mod.GPT(cfg, device=device, seed=0, param_dtype=torch.bfloat16)
    block = 2 * cfg.n_layer * BS * cfg.kv_heads * cfg.head_dim * 2
    prompts = make_prompts(cfg.vocab_size, TIERED_LENS, seed=31)
    need = sum(-(-(n + TIERED_NEW) // BS) for n in TIERED_LENS)
    say(f"model: llama3-8b bf16 at {cfg.n_layer} of {kw['n_layer']} layers; KV {block // BS // 1024} KiB a "
        f"token, {block / 2 ** 20:.0f} MiB a {BS}-token block; {len(prompts)} requests of "
        f"{min(TIERED_LENS)}-{max(TIERED_LENS)} prompt tokens + {TIERED_NEW} new need {need} "
        f"blocks; tiered arena {TIERED_BLOCKS - 1} blocks "
        f"({(TIERED_BLOCKS - 1) * block / 2 ** 20:.0f} MiB), host cache "
        f"{TIERED_HOST_BYTES / 2 ** 20:.0f} MiB; roomy arena {TIERED_ROOMY_BLOCKS - 1} blocks")
    noise = path_noise(model, prompts[0])
    say(f"bf16 paths: a prefill row and a decode step at the same position differ by up to "
        f"{noise:.4f} in the logits; near-tie bound twice that, {2 * noise:.4f}")
    parent = max((tempfile.gettempdir(), str(Path(__file__).resolve().parent)),
                 key=lambda d: shutil.disk_usage(d).free)
    root = tempfile.mkdtemp(prefix="chip_smoke_kv_", dir=parent)
    say(f"disk tier under {root} ({shutil.disk_usage(parent).free / 2 ** 30:.1f} GiB free)")
    return dict(model=model, prompts=prompts, tie=2 * noise, root=root)


def phase_tiered(cell, device, card: str):
    """Phase 31: the 12 requests in a roomy arena, with tiering in the small
    one, and without it (preemption recomputes).  Token identity with the
    roomy run is counted as phase 4 counts it, at the bf16 paths' own
    logit distance (``same_tokens``); every restage equals its spill byte
    for byte (``RestageCheck``); some restage must come from the disk."""
    model, prompts, tie, root = cell["model"], cell["prompts"], cell["tie"], cell["root"]
    roomy = tiered_run(model, prompts, device, "llama3-8b bf16 serve (roomy)",
                       tiered_config(TIERED_ROOMY_BLOCKS, False), card)
    if roomy["preemptions"]:
        fail("the roomy arena preempted")
    spread = gap_spread(model, prompts, roomy["futs"], "llama3-8b bf16 serve (roomy)", tie)
    tiered = tiered_run(model, prompts, device, "llama3-8b bf16 serve (tiered)",
                        tiered_config(TIERED_BLOCKS, True, os.path.join(root, "tiered")), card)
    numbers = tiering_numbers(tiered, card)
    if numbers["sources"]["nvme"] == 0:
        fail("tiering: no restage came from the disk tier")
    ties = same_tokens(model, prompts, tiered["futs"], roomy["futs"], "tiered vs roomy", tie)
    recompute = tiered_run(model, prompts, device, "llama3-8b bf16 serve (recompute)",
                           tiered_config(TIERED_BLOCKS, False), card)
    rties = same_tokens(model, prompts, recompute["futs"], roomy["futs"],
                        "recompute vs roomy", tie)
    saved = recompute["prefill"] - tiered["prefill"]
    for r in (roomy, tiered, recompute):
        r["eng"].close()
    say(f"summary: llama3-8b bf16 under arena pressure ({TIERED_BLOCKS - 1} blocks): tiered "
        f"{tiered['wall']:.3f} s, {tiered['prefill']} prefill tokens, {tiered['preemptions']} "
        f"preemptions; recompute {recompute['wall']:.3f} s, {recompute['prefill']} prefill "
        f"tokens, {recompute['preemptions']} preemptions; roomy {roomy['wall']:.3f} s, "
        f"{roomy['prefill']} prefill tokens; tiering saved {saved} prefill tokens; near-ties "
        f"vs roomy: tiered {ties}, recompute {rties} [{card}]")
    return dict(roomy=roomy, tiered=tiered, recompute=recompute, tiering=numbers, saved=saved,
                ties=ties, rties=rties, spread=spread)


def phase_bounded(cell, tiered, device, card: str):
    """Phase 32: the tiered cell with ``serve_step_timeout_s`` TIMEOUT_FACTOR
    times the tiered run's median step and a wedge of serve.step at hit
    WEDGE_HIT: one incident, every request finished, tokens as the run
    without the fault (near-ties counted); then a raise at the first
    serve.restage: that request recomputes, tokens as before."""
    model, prompts, tie, root = cell["model"], cell["prompts"], cell["tie"], cell["root"]
    step_s = statistics.median(tiered["steps"])
    deadline = max(TIMEOUT_FLOOR_S, TIMEOUT_FACTOR * step_s)
    wedged = tiered_run(
        model, prompts, device, "llama3-8b bf16 serve (bounded, wedged once)",
        tiered_config(TIERED_BLOCKS, True, os.path.join(root, "wedged"),
                      serve_step_timeout_s=deadline), card,
        plan=[{"site": "serve.step", "action": "wedge", "on_hit": WEDGE_HIT}])
    eng = wedged["eng"]
    if wedged["incidents"] != 1:
        fail(f"bounded dispatch: {wedged['incidents']} incidents, expected 1")
    wties = same_tokens(model, prompts, wedged["futs"], tiered["futs"], "wedged vs tiered", tie)
    bounded = eng._bounded.stats()
    say(f"bounded dispatch: deadline {deadline:.3f} s ({TIMEOUT_FACTOR:g}x the tiered run's "
        f"median step {step_s * 1e3:.2f} ms); the wedge at serve.step hit {WEDGE_HIT} raised "
        f"ServeStepTimeout; recovery (fresh arena and allocator, every request requeued) "
        f"last_recovery_s {eng.last_recovery_s:.4f} s; incidents {eng.incident_count}, "
        f"abandoned workers {bounded['abandoned']}, bounded dispatches {bounded['calls']}; "
        f"every request finished with {TIERED_NEW} tokens; near-ties vs the run without the "
        f"fault {wties}; {wedged['wall']:.3f} s [{card}]")
    eng.close()
    faulted = tiered_run(
        model, prompts, device, "llama3-8b bf16 serve (restage fault)",
        tiered_config(TIERED_BLOCKS, True, os.path.join(root, "faulted")), card,
        plan=[{"site": "serve.restage", "action": "raise", "on_hit": 1}])
    fties = same_tokens(model, prompts, faulted["futs"], tiered["futs"],
                        "restage fault vs tiered", tie)
    # each spill is restaged once or falls back once: one fell back
    fell = faulted["spills"] - faulted["restages"]
    say(f"restage fault: the first restage raised FaultInjected and its request recomputed "
        f"({faulted['restages']} restages of {faulted['spills']} spills; {faulted['prefill']} "
        f"prefill tokens against the fault-free run's {tiered['prefill']}); near-ties vs the "
        f"run without the fault {fties} [{card}]")
    if fell != 1:
        fail(f"restage fault: {fell} restages fell back to recompute, expected 1")
    faulted["eng"].close()
    return dict(wedged=wedged, faulted=faulted, deadline=deadline, step_s=step_s, wties=wties,
                fties=fties, recovery_s=eng.last_recovery_s)


def phase_sampled(device, card: str):
    """Phase 33: sampled generate() (temperature > 0) at Llama-3-8B's widths,
    fp32 at SAMPLE_LAYERS layers (TF32 off): the kernel path against the
    plain path fed the same Gumbel noise, token for token; through
    init_inference, a seed twice gives the same tokens, two seeds differ."""
    import torch
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import gpt as gpt_mod
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da

    torch.backends.cuda.matmul.allow_tf32 = False
    ctor, kw, _ = FAMILY_CELLS["llama3-8b"]
    cfg = getattr(gpt_mod, ctor)(**dict(kw, n_layer=SAMPLE_LAYERS), dtype="float32")
    model = gpt_mod.GPT(cfg, device=device, seed=0)
    ids = torch.tensor(make_prompts(cfg.vocab_size, [SAMPLE_PROMPT] * SAMPLE_BATCH, seed=33),
                       device=device)
    noise = gpt_mod.gumbel_noise((SAMPLE_NEW, SAMPLE_BATCH, cfg.padded_vocab),
                                 torch.Generator(device=device).manual_seed(5), device)
    kernel, counts = counted("fp32 sampled generate()", {"decode_attention": None}, lambda: (
        model.generate(ids, SAMPLE_NEW, temperature=SAMPLE_T, noise=noise)))
    saved = gpt_mod.decode_attention
    gpt_mod.decode_attention = da.decode_attention_reference
    try:
        plain = model.generate(ids, SAMPLE_NEW, temperature=SAMPLE_T, noise=noise)
    finally:
        gpt_mod.decode_attention = saved
    if not torch.equal(kernel, plain):
        fail("sampled generate(): the kernel path and the plain path drew different tokens "
             "from the same noise")
    greedy = model.generate(ids, SAMPLE_NEW)
    new = kernel[:, SAMPLE_PROMPT:]
    if (new >= cfg.vocab_size).any():
        fail("sampled generate() drew a padded vocab column")

    def seeded(seed):
        eng = dst.init_inference(model=model, device=device,
                                 config={"dtype": "float32", "seed": seed})
        return eng.generate(ids, max_new_tokens=SAMPLE_NEW, temperature=SAMPLE_T)
    a, b, c = seeded(3), seeded(3), seeded(4)
    if not torch.equal(a, b) or torch.equal(a, c):
        fail("init_inference seed: the same seed must repeat and two seeds must differ")
    differ = int((new != greedy[:, SAMPLE_PROMPT:]).sum())
    say(f"sampled generate(): llama3-8b widths, fp32, {SAMPLE_LAYERS} layers, {SAMPLE_BATCH} x "
        f"{SAMPLE_PROMPT} prompt tokens + {SAMPLE_NEW} at T {SAMPLE_T}: kernel path == plain "
        f"path on the same noise ({SAMPLE_BATCH * SAMPLE_NEW} tokens, {differ} of them off the "
        f"greedy stream); init_inference seed 3 twice equal, seed 4 differs in "
        f"{int((a != c).sum())} tokens; {counts['decode_attention']} decode launches [{card}]")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(counts=counts, differ=differ)


def phase_tiered_fp32(device, card: str):
    """Phase 34: phases 31-32's traffic at fp32 (TF32 off), FP32_TIER_LAYERS
    layers of Llama-3-8B's widths: the same arena and schedule (the host
    cache scaled with the block), a roomy, a tiered, a recomputing and a
    wedged run (bounded dispatch), each held token for token to the roomy
    run with phase 4's NEAR_TIE, where the fp32 paths leave no room for
    the bf16 bound's near-ties: every request of the tiered and the
    recovered runs is compared to its end unless its top-two gap is under
    1e-4 (``same_tokens`` prints how far the comparison reached)."""
    import torch
    from deepspeed_tpu_torch.models import gpt as gpt_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    ctor, kw, _ = FAMILY_CELLS["llama3-8b"]
    cfg = getattr(gpt_mod, ctor)(**dict(kw, n_layer=FP32_TIER_LAYERS), dtype="float32")
    model = gpt_mod.GPT(cfg, device=device, seed=0)
    prompts = make_prompts(cfg.vocab_size, TIERED_LENS, seed=31)
    # phase 31's host cache in that cell's blocks (bf16, TIERED_LAYERS)
    host = TIERED_HOST_BYTES * (FP32_TIER_LAYERS * 4) // (TIERED_LAYERS * 2)
    root = tempfile.mkdtemp(prefix="chip_smoke_kv_", dir=max(
        (tempfile.gettempdir(), str(Path(__file__).resolve().parent)),
        key=lambda d: shutil.disk_usage(d).free))
    label = f"llama3-8b fp32 {FP32_TIER_LAYERS}-layer serve"
    try:
        def config(*args, **extra):
            return tiered_config(*args, dtype="float32", host_bytes=host, **extra)
        roomy = tiered_run(model, prompts, device, f"{label} (roomy)",
                           config(TIERED_ROOMY_BLOCKS, False), card)
        spread = gap_spread(model, prompts, roomy["futs"], f"{label} (roomy)", NEAR_TIE)
        tiered = tiered_run(model, prompts, device, f"{label} (tiered)",
                            config(TIERED_BLOCKS, True, os.path.join(root, "tiered")), card)
        numbers = tiering_numbers(tiered, card, f"{label} tiering")
        recompute = tiered_run(model, prompts, device, f"{label} (recompute)",
                               config(TIERED_BLOCKS, False), card)
        deadline = max(TIMEOUT_FLOOR_S, TIMEOUT_FACTOR * statistics.median(tiered["steps"]))
        wedged = tiered_run(
            model, prompts, device, f"{label} (bounded, wedged once)",
            config(TIERED_BLOCKS, True, os.path.join(root, "wedged"),
                   serve_step_timeout_s=deadline), card,
            plan=[{"site": "serve.step", "action": "wedge", "on_hit": WEDGE_HIT}])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if not tiered["spills"] or tiered["restages"] != tiered["spills"]:
        fail(f"{label}: {tiered['spills']} spills, {tiered['restages']} restages")
    if wedged["incidents"] != 1:
        fail(f"{label}: {wedged['incidents']} incidents in the wedged run, expected 1")
    ties = {name: same_tokens(model, prompts, r["futs"], roomy["futs"], f"{label}: {name} vs roomy",
                              NEAR_TIE)
            for name, r in (("tiered", tiered), ("recompute", recompute), ("wedged", wedged))}
    for r in (roomy, tiered, recompute, wedged):
        r["eng"].close()
    say(f"summary: {label} under arena pressure ({TIERED_BLOCKS - 1} blocks, host cache "
        f"{host / 2 ** 20:.0f} MiB): tiered {tiered['preemptions']} preemptions, "
        f"{tiered['spills']} spills, {numbers['sources']['nvme']} restages from disk; wedged "
        f"{wedged['incidents']} incident, last_recovery_s {wedged['eng'].last_recovery_s:.4f} s; "
        f"near-ties at {NEAR_TIE:g} vs roomy: tiered {ties['tiered']}, recompute "
        f"{ties['recompute']}, wedged {ties['wedged']} [{card}]")
    counts = {name: r["counts"] for name, r in (("roomy", roomy), ("tiered", tiered),
                                                 ("recompute", recompute), ("wedged", wedged))}
    del model, roomy, tiered, recompute, wedged
    gc.collect()
    torch.cuda.empty_cache()
    return dict(counts=counts, ties=ties, spread=spread, tiering=numbers)


# ---- 35-36: the telemetry plane ------------------------------------------------ #
OPS_FLUSH_EVERY = 8              # phase 35's hub: JSONL flush window (records)
OPS_SCRAPE_S = 0.1               # the scraper thread's period
OPS_TRAIN_STEPS, OPS_TRAIN_WARMUP = 24, 2
# phase 37: the stability block on phase 7's cell; the ladder's thresholds
# make two consecutive anomalies back the lr off and three roll back
STABILITY_CFG = {"enabled": True, "warmup_steps": 1000, "lr_backoff_after": 2,
                 "lr_backoff_factor": 0.5, "rollback_after": 3}
STABILITY_CLEAN_STEPS, STABILITY_TAIL = 6, 4
# phase 38: the agent run's length and the step whose boundary is sent
# SIGTERM
PREEMPT_TOTAL, PREEMPT_STEP = 6, 3
# phase 39: the recovery plane's deadline in process (a warm GPT-2 step and
# its capture take ~0.4 s); a fresh worker's first step takes 9-18 s (on
# first use), which phase 38's worker deadline covers
RECOVERY_STEPS = 3
RECOVERY_CFG = {"recovery_enabled": True, "collective_timeout_s": 5.0,
                "max_step_retries": 1, "retry_backoff_s": 0.1}
RECOVERY_WORKER_TIMEOUT_S = 25.0
OPS_TRAIN_FLUSH_EVERY = 5
OPS_PROFILE_WINDOW = (10, 12)    # phase 36's profiler window, [start, end) steps
DEVICE_EVENT_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Scraper:
    """A thread that GETs ``/metrics`` and ``/healthz`` of an ops server
    every ``period`` seconds until ``stop()``; a scrape counts as mid-run
    when ``live`` was set before its requests and still after them."""

    def __init__(self, url: str, period: float = OPS_SCRAPE_S):
        import threading
        self.url, self.period = url, period
        self.live = False
        self.scrapes, self.errors = [], []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="chip-smoke-scraper",
                                        daemon=True)

    def _get(self, path):
        import urllib.error
        import urllib.request
        try:
            with urllib.request.urlopen(self.url + path, timeout=5) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:      # /healthz answers 503 when unhealthy
            return e.code, e.read().decode()

    def _loop(self):
        while not self._stop.is_set():
            before = self.live
            try:
                metrics = self._get("/metrics")
                health = self._get("/healthz")
            except Exception as e:
                self.errors.append(repr(e))
            else:
                self.scrapes.append({"mid_run": before and self.live,
                                     "metrics": metrics, "health": health})
            self._stop.wait(self.period)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=30)
        if self._thread.is_alive():
            fail("the ops-server scraper thread did not stop")


def prom_value(text: str, name: str):
    """The value of an unlabelled Prometheus series, or None."""
    m = re.search(rf"^{re.escape(name)} (\S+)$", text, re.MULTILINE)
    return float(m.group(1)) if m else None


def ops_serve_run(model, prompts, device, card: str, label: str, telemetry=None):
    """One phase-5 serving run of ``model`` (bf16, 8 slots, 512 blocks)
    through ``init_serving``: a warm-up request, then ``serve``'s staggered
    traffic, counted.  With ``telemetry`` (a config dict) a ``Scraper``
    runs beside it.  Returns tokens, times, counts and the scrapes."""
    import torch
    import deepspeed_tpu_torch as dst

    kw = {} if telemetry is None else {"telemetry": telemetry}
    eng = dst.init_serving(model=model, device=device, config={"serving": dict(
        SERVE_CFG, num_blocks=512, dtype="bfloat16")}, **kw)
    eng.submit(prompts[0][:20], max_new_tokens=4).result()    # warm-up
    dispatches = []
    inner = eng.module.paged_step

    def counted_step(*args):
        out = inner(*args)
        dispatches.append(torch.isfinite(out[0]).all())
        return out
    eng.module.paged_step = counted_step
    step_ms, decode_ms = [], []

    def on_step(dt, stats):
        step_ms.append(dt * 1e3)
        if stats["decode_batch"] and not stats["prefill_tokens"]:
            decode_ms.append(dt * 1e3)

    scraper = None
    if telemetry is not None and telemetry.get("ops_server"):
        if eng.telemetry is None or eng.telemetry.obs_server is None:
            fail(f"{label}: the dict-built hub has no ops server")
        scraper = Scraper(eng.telemetry.obs_server.url).start()
        scraper.live = True
    try:
        t0 = time.perf_counter()
        futs, counts = counted(f"{label} serve", {"paged_attention": None},
                               lambda: serve(eng, prompts, NEW_TOKENS, on_step))
        wall = time.perf_counter() - t0
    finally:
        if scraper is not None:
            scraper.live = False
            scraper.stop()
    if not all(bool(f) for f in dispatches):
        fail(f"{label}: non-finite logits")
    if any(len(f.token_ids) != NEW_TOKENS for f in futs):
        fail(f"{label}: a request did not produce all its tokens")
    per = model.cfg.n_layer
    if counts["paged_attention"] != per * len(dispatches):
        fail(f"{label}: {counts['paged_attention']} paged launches in {len(dispatches)} "
             f"dispatches, expected {per} per dispatch")
    ntok = sum(len(f.token_ids) for f in futs)
    ttft = [(f.request.first_token_at - f.request.arrival) * 1e3 for f in futs]
    out = dict(tokens=[f.token_ids for f in futs], tokens_per_s=ntok / wall,
               ttft_ms=statistics.median(ttft), decode_step_ms=statistics.median(decode_ms),
               decode_ms=decode_ms, ttfts=ttft, dispatches=len(dispatches), counts=counts,
               scraper=scraper, submitted=eng._rid_counter)
    say(f"{label}: {len(futs)} requests, {ntok} tokens in {wall:.3f}s = "
        f"{out['tokens_per_s']:.1f} tokens/s; median TTFT {out['ttft_ms']:.1f} ms; median "
        f"decode step {out['decode_step_ms']:.2f} ms ({len(decode_ms)} pure decode steps); "
        f"{len(dispatches)} dispatches, {per} paged launches each [{card}]")
    eng.close()
    return out


def check_ops_run(on, label: str):
    """The checks of a run with the hub: one finished ``serve_request``
    record a request and ``serve_step`` records in the JSONL, the three
    serving spans in the Chrome trace; with the ops server scraped, a
    mid-run scrape with ``serve_ttft_ms`` counted and blocks in use and
    ``/healthz`` healthy with ``serve_arena``."""
    sc, records, trace = on["scraper"], on["records"], on["trace"]
    finished = [r["rid"] for r in records
                if r.get("kind") == "serve_request" and r.get("event") == "finished"]
    if sorted(finished) != list(range(1, on["submitted"] + 1)):
        fail(f"{label}: finished serve_request records for rids {sorted(finished)}, "
             f"expected one each for 1..{on['submitted']}")
    n_steps = sum(r.get("kind") == "serve_step" for r in records)
    if n_steps < 1:
        fail(f"{label}: no serve_step record in the JSONL")
    spans = {e["name"] for e in trace["traceEvents"] if e.get("ph") == "X"}
    missing = {"serve.step", "serve.prefill", "serve.decode"} - spans
    if missing:
        fail(f"{label}: the Chrome trace lacks the spans {sorted(missing)}")
    said = (f"JSONL {len(records)} records ({len(finished)} finished serve_request, {n_steps} "
            f"serve_step); trace spans {sorted(spans)}")
    if sc is None:
        say(f"{label}: {said}")
        return
    mid = [s for s in sc.scrapes if s["mid_run"]]
    live = [s for s in mid if s["metrics"][0] == 200
            and (prom_value(s["metrics"][1], "dstpu_serve_ttft_ms_count") or 0) > 0
            and (prom_value(s["metrics"][1], "dstpu_serve_blocks_in_use") or 0) > 0]
    if not live:
        fail(f"{label}: no mid-run /metrics scrape showed serve_ttft_ms counted and blocks "
             f"in use ({len(mid)} mid-run scrapes, {len(sc.errors)} errors: {sc.errors[:2]})")
    code, body = live[-1]["health"]
    health = json.loads(body)
    if code != 200 or not health.get("healthy") or "serve_arena" not in health.get("checks", {}):
        fail(f"{label}: /healthz mid-run answered {code} {body[:300]}")
    say(f"{label}: {len(sc.scrapes)} scrapes ({len(mid)} mid-run, {len(live)} with TTFT "
        f"counted, the last of them "
        f"{prom_value(live[-1]['metrics'][1], 'dstpu_serve_ttft_ms_count'):.0f} requests), "
        f"/healthz {code} with checks {sorted(health['checks'])}; {said}")


#: phase 35's runs in turn: the hub with its ops server scraped by a
#: thread, then OPS_PAIRS pairs of runs with telemetry off and with the hub
#: alone, in the order off-hub, hub-off, ... so that a drift of the host's
#: speed over the phase falls on both settings alike
OPS_PAIRS = 3
OPS_RUNS = ("scraped",) + sum((("off", "hub") if i % 2 == 0 else ("hub", "off")
                               for i in range(OPS_PAIRS)), ())


def quartiles(values):
    """(first quartile, median, third quartile) of ``values``."""
    q = statistics.quantiles(values, n=4, method="inclusive")
    return q[0], q[1], q[2]


def phase_ops_serve(device, card: str):
    """Phase 35: phase 5's serving cell (GPT-2 XL bf16, 8 slots, its
    prompts) through ``init_serving``, the runs of OPS_RUNS in turn: a
    dict-built hub (JSONL, ``flush_every`` OPS_FLUSH_EVERY, metrics, the
    default SLO rules, tracing into a ``trace_dir``) with the ops server on
    an ephemeral port while a thread scrapes ``/metrics`` and ``/healthz``
    ("scraped"); then OPS_PAIRS pairs of a run with telemetry off ("off")
    and one with the same hub without the ops server ("hub").  The same
    tokens in all; each hub run passes ``check_ops_run``; ``n_layer``
    paged launches a dispatch in every run.  Each run's median decode
    step; each setting's quartiles of them; the hub's gap in the median
    and in each pair; median TTFT and tokens/s."""
    import torch
    from deepspeed_tpu_torch.models.gpt import GPT, gpt_config

    gc.collect()
    torch.cuda.empty_cache()
    cfg = gpt_config("gpt2-xl", dtype="bfloat16")
    model = GPT(cfg, device=device, seed=0, param_dtype=torch.bfloat16)
    prompts = make_prompts(cfg.vocab_size, PROMPT_LENS)
    runs = {kind: [] for kind in OPS_RUNS}
    for i, kind in enumerate(OPS_RUNS):
        label = f"ops plane {kind} ({i + 1} of {len(OPS_RUNS)}): bf16 gpt2-xl"
        if kind == "off":
            runs[kind].append(ops_serve_run(model, prompts, device, card, label))
            continue
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ops_") as tmp:
            jsonl = os.path.join(tmp, "serve.jsonl")
            on = ops_serve_run(model, prompts, device, card, label, telemetry={
                "enabled": True, "jsonl_path": jsonl, "flush_every": OPS_FLUSH_EVERY,
                "metrics": True, "ops_server": kind == "scraped", "ops_port": 0,
                "tracing": True, "trace_dir": tmp})
            on["records"] = [json.loads(line) for line in Path(jsonl).read_text().splitlines()]
            on["trace"] = json.loads(Path(tmp, "trace_rank0.json").read_text())
        check_ops_run(on, label)
        runs[kind].append(on)
    first = runs["off"][0]["tokens"]
    for kind, rs in runs.items():
        for r in rs:
            if r["tokens"] != first:
                bad = sum(a != b for a, b in zip(r["tokens"], first))
                fail(f"ops plane: {bad} requests' tokens differ between the runs ({kind})")
    per_run = {k: [statistics.median(r["decode_ms"]) for r in rs] for k, rs in runs.items()}
    med = {k: {"decode_step_ms": statistics.median(per_run[k]),
               "ttft_ms": statistics.median(x for r in rs for x in r["ttfts"]),
               "tokens_per_s": [r["tokens_per_s"] for r in rs]} for k, rs in runs.items()}
    gap = {k: med[k]["decode_step_ms"] / med["off"]["decode_step_ms"] - 1.0
           for k in ("hub", "scraped")}
    # run i of "hub" and run i of "off" are adjacent (OPS_RUNS)
    pairs = [h / o - 1.0 for h, o in zip(per_run["hub"], per_run["off"])]
    spread = {k: quartiles(per_run[k]) for k in ("off", "hub")}
    say(f"summary: ops plane on gpt2-xl bf16 serving (phase 5's cell), runs "
        f"{' / '.join(OPS_RUNS)}, tokens equal in all: each run's median decode step "
        + "; ".join(f"{k} [{', '.join(f'{v:.3f}' for v in per_run[k])}] ms"
                    for k in ("off", "hub", "scraped"))
        + "; quartiles of the runs' medians " + "; ".join(
            f"{k} {q1:.3f} / {q2:.3f} / {q3:.3f} ms (IQR {(q3 - q1) / q2:.1%} of the median)"
            for k, (q1, q2, q3) in spread.items())
        + f"; hub gap in the median {gap['hub']:+.1%}, in each pair "
        f"[{', '.join(f'{g:+.1%}' for g in pairs)}] (median {statistics.median(pairs):+.1%}); "
        f"scraped {gap['scraped']:+.1%}; median TTFT "
        + "; ".join(f"{k} {med[k]['ttft_ms']:.1f}" for k in ("off", "hub", "scraped"))
        + " ms; tokens/s " + "; ".join(
            f"{k} {', '.join(f'{v:.1f}' for v in med[k]['tokens_per_s'])}"
            for k in ("off", "hub", "scraped")) + f" [{card}]")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(runs=runs, gap=gap, medians=med, pairs=pairs, spread=spread)


def device_events(trace) -> list:
    return [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") in DEVICE_EVENT_CATS]


def ops_train_run(device, card: str, label: str, telemetry=None):
    """OPS_TRAIN_STEPS graphed steps of phase 7's GPT-2 cell (seq 512, micro
    8, bf16) from seed 0; each step timed to the device's drain.  Without
    telemetry each step's loss and grad norm are read after it.  Returns
    the values, the final parameters, times, counts and the engine's
    graph facts."""
    import torch
    from deepspeed_tpu_torch.models.gpt import GPT, gpt_config

    gc.collect()
    torch.cuda.empty_cache()
    cfg = gpt_config("gpt2", n_positions=TRAIN_SEQ, remat=True)
    model = GPT(cfg, device=device, seed=0)
    config = dict(TRAIN_CFG) if telemetry is None else dict(TRAIN_CFG, telemetry=telemetry)
    engine = train_engine(model, config, device)
    engine.graphs.accelerator = KeptGraphs(engine.graphs.accelerator)
    batch = train_batch_of(cfg.vocab_size, device)
    losses, norms = [], []

    def step():
        loss = engine.train_batch(batch=batch)
        if telemetry is None:
            losses.append(float(loss))
            norms.append(engine.get_global_grad_norm())
        return loss
    for _ in range(OPS_TRAIN_WARMUP):
        step()
    torch.cuda.synchronize()
    n = OPS_TRAIN_STEPS - OPS_TRAIN_WARMUP
    ce = kernel_modules()[1].launches_per_call(TRAIN_MICRO * TRAIN_SEQ, cfg.n_embd,
                                               cfg.padded_vocab, torch.bfloat16)
    (_, host_ms, wall_ms), counts = counted(
        f"{label} graphed ({n} steps)",
        train_expect("auto", TRAIN_SEQ, cfg.n_layer, n, ce_launches=ce,
                     adam_launches=adam_launches(engine)),
        lambda: timed_steps(step, n))
    if engine.graphs.captures != 1:
        fail(f"{label}: {engine.graphs.captures} captures for one batch signature")
    nodes, n_nodes = graph_kernel_counts(engine)
    for k, per in nodes.items():
        if counts.get(k, 0) != per * n:
            fail(f"{label}: {k} launched {counts.get(k, 0)} times in {n} replays of a graph "
                 f"with {per} of its kernel nodes")
    params = param_copies(model)
    window = engine.profiler_window
    out = dict(losses=losses, norms=norms, params=params, step_ms=statistics.median(wall_ms),
               host_ms=statistics.median(host_ms), counts=counts, nodes=n_nodes,
               trace_path=window.trace_path if window is not None else None)
    engine.close()
    return out


def phase_ops_train(device, card: str):
    """Phase 36: phase 7's GPT-2 cell (seq 512, micro 8, bf16) through
    ``initialize()`` -> ``train_batch``, OPS_TRAIN_STEPS steps from one seed
    with the ``telemetry`` block off (each step's loss and grad norm read
    after it), then on (JSONL with ``flush_every`` OPS_TRAIN_FLUSH_EVERY,
    metrics, goodput, tracing, a profiler window over OPS_PROFILE_WINDOW):
    losses and parameters bit for bit equal; each step record's loss and
    grad norm equal to the off run's for that step (the static outputs of
    the replay are copied per step); one capture and the launch counters
    equal to the graph's kernel nodes in both; ``EFFICIENCY.json``
    written; the profiler's trace valid Chrome-trace JSON with device
    events.  The graphed step's median with telemetry off and on."""
    import torch

    off = ops_train_run(device, card, "ops plane off: bf16 train gpt2 seq 512")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ops_train_") as tmp:
        jsonl = os.path.join(tmp, "train.jsonl")
        start, end = OPS_PROFILE_WINDOW
        on = ops_train_run(device, card, "ops plane on: bf16 train gpt2 seq 512", telemetry={
            "enabled": True, "jsonl_path": jsonl, "flush_every": OPS_TRAIN_FLUSH_EVERY,
            "metrics": True, "goodput": True, "tracing": True, "trace_dir": tmp,
            "profiler_start_step": start, "profiler_end_step": end,
            "profiler_dir": os.path.join(tmp, "profile")})
        records = [json.loads(line) for line in Path(jsonl).read_text().splitlines()]
        efficiency = Path(tmp, "EFFICIENCY.json")
        if not efficiency.is_file():
            fail("ops plane train: EFFICIENCY.json was not written")
        goodput = json.loads(efficiency.read_text())["ledger"]
        if not on["trace_path"] or not os.path.isfile(on["trace_path"]):
            fail(f"ops plane train: the profiler window wrote no trace ({on['trace_path']})")
        prof = json.loads(Path(on["trace_path"]).read_text())
        spans = json.loads(Path(tmp, "trace_rank0.json").read_text())
    steps = sorted((r for r in records if r.get("kind") == "step"), key=lambda r: r["step"])
    if [r["step"] for r in steps] != list(range(1, OPS_TRAIN_STEPS + 1)):
        fail(f"ops plane train: step records {[r['step'] for r in steps]}")
    bad = [(r["step"], r["loss"], a, r["grad_norm"], b)
           for r, a, b in zip(steps, off["losses"], off["norms"])
           if r["loss"] != a or r["grad_norm"] != b]
    if bad:
        fail(f"ops plane train: step records differ from the off run's own values (step, "
             f"loss, off loss, norm, off norm): {bad[:4]}")
    if not all(torch.equal(on["params"][k], v) for k, v in off["params"].items()):
        fail("ops plane train: the parameters differ with telemetry on")
    dev = device_events(prof)
    names = {e["name"] for e in dev if e.get("cat") == "kernel"}
    ours = {k for k, pat in KERNEL_NAMES.items() if any(re.search(pat, n) for n in names)}
    launches = [e for e in prof.get("traceEvents", []) if "cudaGraphLaunch" in str(e.get("name"))]
    if not dev:
        fail(f"ops plane train: the profiler's trace holds no device event "
             f"({len(prof.get('traceEvents', []))} events)")
    gap = on["step_ms"] / off["step_ms"] - 1.0
    say(f"ops plane train: {len(steps)} step records equal to the off run's loss and grad norm "
        f"bit for bit; parameters bit for bit; 1 capture, {on['nodes']} graph nodes; "
        f"EFFICIENCY.json goodput {goodput.get('goodput_frac')}, conservation "
        f"{goodput.get('conservation', {}).get('ok')}; profiler trace {len(dev)} device events "
        f"({len(names)} kernel names, the port's: {sorted(ours)}), {len(launches)} "
        f"cudaGraphLaunch calls; span trace {len(spans['traceEvents'])} events")
    say(f"summary: ops plane on gpt2 bf16 seq 512 micro 8 graphed training: median step "
        f"{off['step_ms']:.3f} ms off / {on['step_ms']:.3f} ms on ({gap:+.2%}; host "
        f"{off['host_ms']:.3f} / {on['host_ms']:.3f} ms; the off run reads each step's loss "
        f"and norm) [{card}]")
    return dict(off=off, on=on, gap=gap, device_events=len(dev), kernel_names=sorted(ours))


# --------------------------------------------------------------------------- #
# phases 37-39: the training robustness plane on phase 7's GPT-2 cell
# --------------------------------------------------------------------------- #
def host_batch(vocab: int, seed: int):
    """Phase 7's batch shape, ``[1, 8, 512]`` int32 ids, in host memory (a
    host batch is fingerprinted, so it can be quarantined)."""
    ids = np.random.default_rng(seed).integers(0, vocab, (1, TRAIN_MICRO, TRAIN_SEQ))
    return ids.astype(np.int32), ids.astype(np.int32)


def optimizer_state(engine):
    """Host copies of what a skipped step must leave alone: the fp32
    parameters, the moments and the count."""
    import torch
    opt = engine.optimizer
    return ([p.detach().clone() for p in engine._leaves] + [t.clone() for t in opt.mu]
            + [t.clone() for t in opt.nu] + [opt.count.clone()])


def same_state(a, b) -> bool:
    import torch
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def adam_skip_cases(device, card: str):
    """The fused AdamW kernel's skip flag against its plain version: over
    the 148 GPT-2 leaves with the flag set (nothing written, bit for bit)
    and clear (equal to the plain version and to a launch without the
    flag), and on a ``ZeroAdam`` chunk of offloaded moments (host pieces
    unchanged with the flag set).  The flagged launch's time after a
    ``zero_()`` flush, beside the unflagged one's."""
    import torch
    from deepspeed_tpu_torch.models.gpt import gpt_config, init_gpt_params
    from deepspeed_tpu_torch.runtime.optimizers import ZeroAdam
    from deepspeed_tpu_torch.runtime.zero.partition_parameters import FlatStore
    tfo = kernel_modules()[2]
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    tree = init_gpt_params(gpt_config("gpt2", n_positions=TRAIN_SEQ), gen)
    params = [tree[k] for k in ("wte", "wpe", "lnf_g", "lnf_b")] + [
        t for blk in tree["blocks"] for t in blk.values()]
    grads = [torch.randn(p.shape, generator=gen, device=device) * 1e-3 for p in params]
    mus = [torch.randn(p.shape, generator=gen, device=device) * 1e-4 for p in params]
    nus = [(torch.randn(p.shape, generator=gen, device=device) * 1e-3).square() for p in params]
    spec = tfo.spec_from_config("adamw", {"weight_decay": 0.01}, 1e-4)
    neg_lr, bc1, bc2 = tfo.step_scalars(spec, torch.tensor(10, dtype=torch.int32,
                                                           device=device))
    scal = torch.stack([torch.tensor(0.5, device=device), torch.tensor(0.7, device=device),
                        neg_lr, bc1, bc2])
    kw = dict(b1=spec["b1"], b2=spec["b2"], eps=spec["eps"], wd=spec["wd"])
    one = torch.ones((), device=device)
    zero = torch.zeros((), device=device)

    def copies():
        return [[t.clone() for t in ts] for ts in (params, grads, mus, nus)]
    a, b, c = copies(), copies(), copies()
    before = copies()
    table = tfo.AdamTable(*a)
    tfo.fused_adam(table, scal, skip=one, **kw)
    torch.cuda.synchronize()
    set_same = all(torch.equal(x, y) for xs, ys in zip(a, before) for x, y in zip(xs, ys))
    tfo.fused_adam(table, scal, skip=zero, **kw)
    tfo.fused_adam(tfo.AdamTable(*c), scal, **kw)
    tfo.adam_reference(*b, scal, **kw)
    torch.cuda.synchronize()
    clear_plain = all(torch.equal(x, y) for xs, ys in zip(a, b) for x, y in zip(xs, ys))
    clear_noflag = all(torch.equal(x, y) for xs, ys in zip(a, c) for x, y in zip(xs, ys))
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=device)
    ms_flag = median_ms(lambda: tfo.fused_adam(table, scal, skip=zero, **kw), 10,
                        scratch.zero_)
    ms_none = median_ms(lambda: tfo.fused_adam(table, scal, **kw), 10, scratch.zero_)
    ms_set = median_ms(lambda: tfo.fused_adam(table, scal, skip=one, **kw), 10, scratch.zero_)
    del scratch
    # a ZeroAdam over offloaded moments: 2**23 + 5 values in host pieces of 2**22
    n, piece = 2 ** 23 + 5, 2 ** 22
    master = torch.randn(n, generator=gen, device=device) * 0.02
    grad = torch.randn(n, generator=gen, device=device) * 1e-3
    mu, nu = (FlatStore(n, device, host=True, piece=piece) for _ in range(2))
    for s in (mu, nu):
        for t in s.pieces:
            t.copy_(torch.rand(t.shape) * 1e-4)
    zadam = ZeroAdam(spec, [(0, n, master)], grad, mu, nu)
    host_before = [t.clone() for s in (mu, nu) for t in s.pieces] + [master.cpu()]
    zadam.step(torch.tensor(1.0, device=device), torch.tensor(1.0, device=device), skip=one)
    torch.cuda.synchronize()
    host_after = [t.clone() for s in (mu, nu) for t in s.pieces] + [master.cpu()]
    zero_same = (same_state(host_before, host_after) and int(zadam.count) == 0
                 and len(zadam.chunks) > 1)
    # clear: the chunked step against the plain update of the whole shard
    ref = [master.clone()], [grad.clone()], [torch.cat(mu.pieces).to(device)], \
        [torch.cat(nu.pieces).to(device)]
    nl, b1c, b2c = tfo.step_scalars(spec, zadam.count)
    zscal = torch.stack([torch.tensor(1.0, device=device), torch.tensor(1.0, device=device),
                         nl, b1c, b2c]).to(torch.float32)
    tfo.adam_reference(*ref, zscal, **kw)
    zadam.step(torch.tensor(1.0, device=device), torch.tensor(1.0, device=device), skip=zero)
    torch.cuda.synchronize()
    zero_clear = (torch.equal(master, ref[0][0])
                  and torch.equal(torch.cat(mu.pieces).to(device), ref[2][0])
                  and torch.equal(torch.cat(nu.pieces).to(device), ref[3][0])
                  and int(zadam.count) == 1)
    mu.close()
    nu.close()
    say(f"fused_adam skip flag, 148 GPT-2 leaves ({table.numel():,} values): set writes "
        f"nothing {set_same}; clear equals the plain version {clear_plain} and the launch "
        f"without the flag {clear_noflag}; ZeroAdam over {len(zadam.chunks)} chunks of "
        f"offloaded moments: set leaves the host pieces, the master and the count {zero_same}, "
        f"clear equals the plain update {zero_clear}; ms after a zero_() flush: flag clear "
        f"{ms_flag:.4f}, no flag {ms_none:.4f}, flag set {ms_set:.4f} [{card}]")
    if not (set_same and clear_plain and clear_noflag and zero_same and zero_clear):
        fail("fused_adam skip flag: a case differs from its plain version")
    return dict(ms_flag=ms_flag, ms_none=ms_none, ms_set=ms_set)


def anomaly_events(engine):
    engine.telemetry.flush()
    kinds = ("anomaly", "lr_backoff", "auto_rollback", "batch_quarantined")
    return [r for r in engine.telemetry.ring.records if r.get("kind") in kinds]


def phase_stability(device, card: str):
    """Phase 37: the stability sentinel in phase 7's graphed GPT-2 cell
    (seq 512, micro 8, bf16, AdamW, clip 1.0):

    * clean: STABILITY_CLEAN_STEPS steps with the block off and on from one
      seed: parameters bit for bit, one capture each, the launch counters
      equal to the graph's kernel nodes; each setting's median step;
    * a ``train.grads`` nan plan on one step: parameters, moments and count
      after it bit for bit those before it, ``skipped`` 1, the cause code
      on the host at the next boundary (the seam's capture is the plan's
      own: a clean graph keeps its nodes);
    * a run of poisoned steps: ``anomaly`` -> ``lr_backoff`` (the next
      replay moves the parameters half as far as one at the full lr, from
      the same state) -> ``batch_quarantined`` and ``auto_rollback`` into
      the same graphs (no new capture) -> the quarantined batch skipped on
      replay; then clean steps: loss finite and falling;
    * the fused AdamW kernel's skip flag against its plain version."""
    import torch
    from deepspeed_tpu_torch.models.gpt import GPT, gpt_config
    from deepspeed_tpu_torch.testing import fault_injection as fi

    cfg = gpt_config("gpt2", n_positions=TRAIN_SEQ, remat=True)
    n = STABILITY_CLEAN_STEPS
    batches = [host_batch(cfg.vocab_size, 700 + i) for i in range(n + 12)]
    ce = kernel_modules()[1].launches_per_call(TRAIN_MICRO * TRAIN_SEQ, cfg.n_embd,
                                               cfg.padded_vocab, torch.bfloat16)
    runs = {}
    telemetry = {"enabled": True, "flush_every": 10 ** 6}
    for label, extra in (("off", {"telemetry": telemetry}),
                         ("on", {"stability": STABILITY_CFG, "telemetry": telemetry})):
        gc.collect()
        torch.cuda.empty_cache()
        model = GPT(cfg, device=device, seed=0)
        engine = train_engine(model, dict(TRAIN_CFG, **extra), device)
        engine.graphs.accelerator = KeptGraphs(engine.graphs.accelerator)
        engine.train_batch(batch=batches[0])          # warm-up and capture
        torch.cuda.synchronize()
        (_, host_ms, wall_ms), counts = counted(
            f"stability {label}: bf16 train gpt2 seq 512 graphed ({n} steps)",
            train_expect("auto", TRAIN_SEQ, cfg.n_layer, n, ce_launches=ce),
            lambda: timed_steps(lambda: engine.train_batch(batch=batches[1]), n))
        nodes, n_nodes = graph_kernel_counts(engine)
        for k, per in nodes.items():
            if counts.get(k, 0) != per * n:
                fail(f"stability {label}: {k} launched {counts.get(k, 0)} times in {n} replays "
                     f"of a graph with {per} of its kernel nodes")
        if engine.graphs.captures != 1:
            fail(f"stability {label}: {engine.graphs.captures} captures")
        runs[label] = dict(engine=engine, model=model, step_ms=statistics.median(wall_ms),
                           host_ms=statistics.median(host_ms), nodes=n_nodes,
                           params=param_copies(model))
        if label == "off":
            engine.close()
            del runs[label]["engine"], runs[label]["model"], engine, model
    on, off = runs["on"], runs["off"]
    if not all(torch.equal(v, off["params"][k]) for k, v in on["params"].items()):
        fail("stability on: a clean graphed step differs from the step without the block")
    say(f"stability clean: {n} graphed steps off and on, parameters bit for bit; one capture "
        f"each; graph nodes off {off['nodes']}, on {on['nodes']}; median step {off['step_ms']:.3f} "
        f"ms off, {on['step_ms']:.3f} ms on (host {off['host_ms']:.3f} / {on['host_ms']:.3f}) "
        f"[{card}]")
    engine, model = on["engine"], on["model"]
    del runs
    root = tempfile.mkdtemp(prefix="chip_smoke_stability_", dir=ckpt_root())
    try:
        t0 = time.perf_counter()
        engine.save_checkpoint(root)
        save_s = time.perf_counter() - t0
        step0 = engine.global_steps
        # one nan step: nothing of the update lands
        before = optimizer_state(engine)
        fi.install_plan([{"site": "train.grads", "action": "nan", "on_hit": 1}])
        engine.train_batch(batch=batches[2])
        torch.cuda.synchronize()
        after = optimizer_state(engine)
        skipped = engine.skipped_steps
        seen_at_step = [r for r in anomaly_events(engine) if r["kind"] == "anomaly"]
        fi.clear_plan()
        engine.train_batch(batch=batches[3])
        seen_next = [r for r in anomaly_events(engine) if r["kind"] == "anomaly"]
        if not same_state(before, after) or skipped != 1:
            fail(f"stability: the nan step changed the state or skipped {skipped} steps")
        if seen_at_step or len(seen_next) != 1 or seen_next[0]["step"] != step0 + 1 \
                or seen_next[0]["detected_at"] != step0 + 2:
            fail(f"stability: the nan step's cause code was seen {seen_at_step} / {seen_next}")
        say(f"stability nan step {step0 + 1}: parameters, moments and count bit for bit those "
            f"before it; skipped 1; {seen_next[0]['cause']} on the host at step "
            f"{seen_next[0]['detected_at']}; captures {engine.graphs.captures} (the seam's "
            f"own) [{card}]")
        # a run of poisoned steps: backoff at streak 2, rollback at 3
        captures = engine.graphs.captures
        fi.install_plan([{"site": "train.grads", "action": "nan", "on_hit": 1, "times": 2}])
        engine.train_batch(batch=batches[4])
        engine.train_batch(batch=batches[5])
        fi.clear_plan()
        # the step after the second nan judges the first (streak 1 ... ): a
        # clean step now, from this state, at the backed-off lr after the
        # boundary that sees streak 2
        engine.train_batch(batch=batches[6])
        if float(engine._lr_scale_dev) != STABILITY_CFG["lr_backoff_factor"]:
            fail(f"stability: lr scale {float(engine._lr_scale_dev)} after the backoff")
        state = optimizer_state(engine)
        sentinel = [t.clone() for t in engine.sentinel]
        engine.train_batch(batch=batches[7])
        torch.cuda.synchronize()
        half = [p.detach().clone() for p in engine._leaves]
        engine._copy_in(list(zip(list(engine._leaves) + engine.optimizer.mu + engine.optimizer.nu
                                 + [engine.optimizer.count] + list(engine.sentinel),
                                 state + sentinel)))
        engine._lr_scale_dev.fill_(1.0)
        engine.train_batch(batch=batches[7])
        torch.cuda.synchronize()
        full = [p.detach().clone() for p in engine._leaves]
        engine._copy_in(list(zip(engine._leaves, half)))
        engine._lr_scale_dev.fill_(STABILITY_CFG["lr_backoff_factor"])
        num = sum((h - s).double().square().sum().item() for h, s in zip(half, state))
        den = sum((f - s).double().square().sum().item() for f, s in zip(full, state))
        ratio = (num / den) ** 0.5
        if abs(ratio - STABILITY_CFG["lr_backoff_factor"]) > 1e-3:
            fail(f"stability: the backed-off replay moved the parameters {ratio:.6f} as far as "
                 "one at the full lr")
        fi.install_plan([{"site": "train.grads", "action": "nan", "on_hit": 1, "times": 3}])
        for b in batches[8:11]:
            engine.train_batch(batch=b)
        fi.clear_plan()
        engine.train_batch(batch=batches[11])         # judges the third: rollback
        rolled_to = engine.global_steps
        engine.train_batch(batch=batches[9])          # quarantined: skipped
        events = anomaly_events(engine)
        kinds = [r["kind"] + (f":{r['phase']}" if r["kind"] == "batch_quarantined" else "")
                 for r in events]
        order = [kinds.index(k) if k in kinds else -1 for k in (
            "anomaly", "lr_backoff", "batch_quarantined:quarantined", "auto_rollback",
            "batch_quarantined:skipped")]
        if -1 in order or order != sorted(order):
            fail(f"stability: events {kinds}")
        if engine.graphs.captures != captures:
            fail(f"stability: the rollback captured again ({engine.graphs.captures} captures)")
        losses = [float(engine.train_batch(batch=batches[1])) for _ in range(STABILITY_TAIL)]
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            fail(f"stability: after the rollback the loss went {losses}")
        roll = next(r for r in events if r["kind"] == "auto_rollback")
        say(f"stability ladder: events {kinds}; the backed-off replay moved the parameters "
            f"{ratio:.6f} as far as one at the full lr; rollback from step {roll['from_step']} "
            f"to {roll['to_step']} (resumed at {rolled_to}), {roll['quarantined']} fingerprints "
            f"quarantined; captures {engine.graphs.captures} before and after; then "
            f"{STABILITY_TAIL} clean steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}; save "
            f"{save_s:.3f} s [{card}]")
    finally:
        fi.clear_plan()
        engine.close()
        shutil.rmtree(root, ignore_errors=True)
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    adam = adam_skip_cases(device, card)
    say(f"summary: stability on gpt2 bf16 seq 512 micro 8 graphed: median step "
        f"{off['step_ms']:.3f} ms off / {on['step_ms']:.3f} ms on; fused_adam 148 leaves "
        f"{adam['ms_none']:.4f} ms without the flag, {adam['ms_flag']:.4f} with it clear, "
        f"{adam['ms_set']:.4f} set [{card}]")
    return dict(off_ms=off["step_ms"], on_ms=on["step_ms"], adam=adam)


def ckpt_root() -> str:
    """Where large temporary checkpoints go: $TMPDIR or the checkout,
    whichever has more room."""
    here = str(Path(__file__).resolve().parent)
    tmp = tempfile.gettempdir()
    return max((tmp, here), key=lambda d: shutil.disk_usage(d).free)


ROBUST_WORKER = '''\
import hashlib, json, os, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import torch


def process_age():
    """Seconds since this process started (/proc/self/stat's start time)."""
    ticks = os.sysconf("SC_CLK_TCK")
    start = int(open("/proc/self/stat").read().rsplit(")", 1)[1].split()[19]) / ticks
    return float(open("/proc/uptime").read().split()[0]) - start


def main():
    cfgv = json.loads(sys.argv[1])
    starts = os.path.join(cfgv["root"], "starts")
    n = (int(open(starts).read()) if os.path.exists(starts) else 0) + 1
    open(starts, "w").write(str(n))
    times = {{"python_s": process_age()}}
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models.gpt import GPT, gpt_config
    from deepspeed_tpu_torch.testing import fault_injection as fi
    times["import_s"] = process_age()
    cfg = gpt_config("gpt2", n_positions={seq}, remat=True)
    model = GPT(cfg, seed=0)
    torch.cuda.synchronize()
    times["model_s"] = process_age()
    config = dict(cfgv.get("configs", {{}}).get(str(n), cfgv["config"]))
    config["telemetry"] = {{"enabled": True, "flush_every": 1,
                           "jsonl_path": os.path.join(cfgv["root"], "start%d.jsonl" % n)}}
    eng = dst.initialize(model=model, config=config, seed=0)[0]
    times["engine_s"] = process_age()
    ckpt = cfgv.get("ckpt")
    if ckpt and os.path.exists(os.path.join(ckpt, "latest")):
        eng.load_checkpoint(ckpt)
    plan = cfgv.get("plans", {{}}).get(str(n))
    if plan:
        fi.install_plan(plan)
    saves = []
    save = eng.save_checkpoint

    def timed_save(*a, **k):
        t0 = time.perf_counter()
        out = save(*a, **k)
        saves.append(time.perf_counter() - t0)
        return out
    eng.save_checkpoint = timed_save
    times["load_s"] = process_age()
    info = {{"start": n, "resumed_at": eng.global_steps, "times": times}}
    print("WORKER " + json.dumps(info), flush=True)      # a start that is killed
    try:
        while eng.global_steps < cfgv["steps"]:
            ids = np.random.default_rng(900 + eng.global_steps).integers(
                0, cfg.vocab_size, (1, {micro}, {seq})).astype(np.int32)
            eng.train_batch(batch=(ids, ids))
            if "startup_s" not in info:
                torch.cuda.synchronize()
                info["startup_s"] = process_age()
    except SystemExit as e:
        info.update(exit=e.code, saves_s=saves, step=eng.global_steps)
        eff = os.path.join(cfgv["root"], "EFFICIENCY.json")
        if os.path.exists(eff):
            info["ckpt_stall_s"] = json.load(open(eff))["ledger"]["categories"]["ckpt_stall"]
        print("WORKER " + json.dumps(info), flush=True)
        raise
    h = hashlib.sha256()
    for k, t in sorted(eng.get_fp32_params().items()):
        h.update(k.encode())
        h.update(t.numpy().tobytes())
    info.update(exit=0, digest=h.hexdigest(), step=eng.global_steps,
                status=eng.recovery_manager.status() if eng.recovery_manager else None)
    eng.close()
    print("WORKER " + json.dumps(info), flush=True)


main()
'''


def digest_of(engine) -> str:
    import hashlib
    h = hashlib.sha256()
    for k, t in sorted(engine.get_fp32_params().items()):
        h.update(k.encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def run_agent(root: str, cfgv: dict, env: dict, max_restarts: int):
    """The port's elastic agent supervising one worker (``ROBUST_WORKER``)
    through the port's launcher (one process, ``cuda:0``), from this
    checkout.  Returns (exit code, the agent, each start's ``WORKER`` lines
    merged, the agent's sleeps, the workers' log)."""
    from collections import OrderedDict
    from deepspeed_tpu_torch.elasticity.elastic_agent import DSElasticAgent, WorkerSpec
    from deepspeed_tpu_torch.launcher import runner
    here = str(Path(__file__).resolve().parent)
    script = os.path.join(root, "worker.py")
    Path(script).write_text(ROBUST_WORKER.format(repo=here, seq=TRAIN_SEQ, micro=TRAIN_MICRO))
    log = os.path.join(root, "workers.log")
    # the launcher by its file: ``-m`` would import the package, and torch,
    # before the worker does
    cmd = [sys.executable, "-u", os.path.join(here, "deepspeed_tpu_torch", "launcher",
                                              "launch.py"),
           f"--world_info={runner.encode_world_info(OrderedDict(localhost=1))}",
           f"--master_port={free_port_local()}", script, json.dumps(cfgv)]
    shell = ["bash", "-c", " ".join(map(shlex_quote, cmd)) + f" >> {shlex_quote(log)} 2>&1"]
    sleeps = []
    # the workers read the bytecode this process wrote (``main``) and
    # keep there what they compile beyond it
    env = dict(env, PYTHONPATH=here, PYTHONDONTWRITEBYTECODE="",
               PYTHONPYCACHEPREFIX=sys.pycache_prefix)
    agent = DSElasticAgent(WorkerSpec(shell, env=env),
                           max_restarts=max_restarts, monitor_interval=0.5,
                           sleep_fn=lambda s: (sleeps.append(s), time.sleep(s)))
    old = os.getcwd()
    os.chdir(here)
    try:
        rc = agent.run()
    finally:
        os.chdir(old)
    text = Path(log).read_text() if os.path.exists(log) else ""
    starts = {}
    for x in text.splitlines():
        if x.startswith("WORKER "):
            rec = json.loads(x[len("WORKER "):])
            starts.setdefault(rec["start"], {}).update(rec)
    return rc, agent, starts, sleeps, text


def shlex_quote(s: str) -> str:
    import shlex
    return shlex.quote(s)


def free_port_local() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_agent(device, card: str):
    """Phase 38: phase 7's GPT-2 cell at ZeRO-1 (so that the step runs
    collectives on a one-rank NCCL group) under the port's elastic agent
    and launcher (world 1), one agent run of four starts:

    * start 1 trains and is sent SIGTERM at the boundary of step
      PREEMPT_STEP (the ``sigterm`` action at ``train.step``): it saves
      ``preempt_step<N>`` and exits 143; the agent restarts it at once,
      spending no budget;
    * start 2 resumes and dies at the boundary of its first step (a
      ``kill``, exit 9): the agent backs off and spends its one restart;
    * start 3 resumes with the recovery plane and no retry left
      (``max_step_retries`` 0): a ``comm.collective`` wedge at its capture's
      first collective expires the deadline, the worker exits 113 with the
      marker, and the agent consumes it and restarts without budget;
    * start 4 resumes from the preemption checkpoint and finishes, with no
      incident; its parameters equal an uninterrupted in-process run's bit
      for bit.

    Returns the uninterrupted run's collectives a step and its parameters
    after RECOVERY_STEPS steps, which phase 39 holds its wedged run to."""
    import torch
    from deepspeed_tpu_torch.models.gpt import GPT, gpt_config
    cfg = gpt_config("gpt2", n_positions=TRAIN_SEQ, remat=True)
    base = dict(TRAIN_CFG, zero_optimization={"stage": 1})
    gc.collect()
    torch.cuda.empty_cache()
    model = GPT(cfg, device=device, seed=0)
    engine = train_engine(model, base, device)
    per_step = collectives_per_step(engine, host_batch(cfg.vocab_size, 900))
    while engine.global_steps < PREEMPT_TOTAL:
        if engine.global_steps == RECOVERY_STEPS:
            at_recovery_steps = engine.get_fp32_params()
        engine.train_batch(batch=host_batch(cfg.vocab_size, 900 + engine.global_steps))
    want = digest_of(engine)
    engine.close()
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_agent_", dir=ckpt_root())
    try:
        ckpt, rdv = os.path.join(root, "ck"), os.path.join(root, "rdv")
        config = dict(base, fault_tolerance={"preemption_enabled": True,
                                             "preemption_save_dir": ckpt,
                                             "preemption_grace_s": 60.0})
        # a fresh worker's first step runs under the deadline too; the
        # restart after the wedge meets at a rendezvous of its own (a
        # coordinator starts at epoch 0 and would read start 3's abort of
        # that epoch as its own, as the JAX package's does), while start 3
        # writes its marker where the agent reads it (DS_RECOVERY_DIR)
        recovery = dict(RECOVERY_CFG, collective_timeout_s=RECOVERY_WORKER_TIMEOUT_S,
                        max_step_retries=0)
        cfgv = {"root": root, "ckpt": ckpt, "steps": PREEMPT_TOTAL, "config": config,
                "configs": {"3": dict(config, elasticity=dict(recovery, rendezvous_dir=rdv)),
                            "4": dict(config, elasticity=dict(
                                recovery, rendezvous_dir=os.path.join(rdv, "restart")))},
                "plans": {"1": [{"site": "train.step", "action": "sigterm",
                                 "on_hit": PREEMPT_STEP}],
                          "2": [{"site": "train.step", "action": "kill", "exit_code": 9,
                                 "on_hit": 1}],
                          "3": [{"site": "comm.collective", "action": "wedge",
                                 "on_hit": per_step + 1}]}}
        t0 = time.perf_counter()
        rc, agent, by_start, sleeps, log = run_agent(root, cfgv, {"DS_RECOVERY_DIR": rdv},
                                                     max_restarts=1)
        secs = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    starts = [by_start.get(i, {}) for i in (1, 2, 3, 4)]
    last_status = starts[3].get("status") or {}
    ok = (rc == 0 and agent.preemption_count == 1 and agent.recovery_count == 1
          and agent.restart_count == 1 and len(sleeps) == 1
          and starts[0].get("exit") == 143 and starts[0].get("step") == PREEMPT_STEP
          and starts[2].get("exit") == 113 and starts[3].get("exit") == 0
          and all(x.get("resumed_at") == PREEMPT_STEP for x in starts[1:])
          and last_status.get("incidents") == 0 and starts[3].get("digest") == want)
    say(f"preemption, crash and restart exit through the agent and the launcher (gpt2 bf16 "
        f"seq 512 micro 8, ZeRO-1, {secs:.1f} s): exit {rc}; preemptions "
        f"{agent.preemption_count}, recoveries {agent.recovery_count}, restarts "
        f"{agent.restart_count} of 1 (backoff {sleeps}); exits by start "
        f"{[x.get('exit') for x in starts]} (start 2's kill prints none); start 1 at step "
        f"{starts[0].get('step')}, preemption save {starts[0].get('saves_s')} s, ckpt_stall "
        f"{starts[0].get('ckpt_stall_s')} s; start 3's wedge under a "
        f"{RECOVERY_WORKER_TIMEOUT_S} s deadline; start 4's incidents "
        f"{last_status.get('incidents')}; starts resumed at "
        f"{[x.get('resumed_at') for x in starts]}; first-step process age s "
        f"{[round(x['startup_s'], 3) if 'startup_s' in x else None for x in starts]} "
        f"(process age at python, imports, model, engine, load: "
        f"{[x.get('times') for x in starts]}); final parameters equal the uninterrupted "
        f"run's bit for bit {starts[3].get('digest') == want} [{card}]")
    if not ok:
        print(log[-6000:], file=sys.stderr)
        fail("agent run: the exits, the agent's restarts or the resumed run are not as expected")
    return dict(secs=secs, starts=by_start, per_step=per_step, want=at_recovery_steps)


def collectives_per_step(engine, batch) -> int:
    """The ``comm.collective`` hits of one step: a counting rule over a
    first ``train_batch`` (its warm-up step and its capture each run the
    step's host code once)."""
    from deepspeed_tpu_torch.testing import fault_injection as fi
    inj = fi.install_plan([{"site": "comm.collective", "action": "delay", "delay_s": 0.0,
                            "on_hit": 10 ** 9}])
    engine.train_batch(batch=batch)
    fi.clear_plan()
    hits = inj.rules[0].hits
    if hits <= 0 or hits % 2:
        fail(f"recovery: {hits} collective hits in a first step (warm-up and capture)")
    return hits // 2


def phase_recovery(device, card: str, per_step: int, want):
    """Phase 39: collective recovery in process at world 1 (phase 38's
    cell: ZeRO-1 on a one-rank NCCL group, ``per_step`` collectives a
    step): a ``comm.collective`` wedge at the first collective of the
    capture (host code in a graphed step runs at its capture) fires under
    the deadline; the engine abandons the capture (the stream leaves
    capture mode, the graph is dropped), takes the retry rung with one
    incident, books ``comm_recovery`` and captures again; ``/recovery``
    answers mid-run; the parameters after RECOVERY_STEPS steps equal
    ``want``, phase 38's uninterrupted run's."""
    import torch
    import urllib.error
    import urllib.request
    from deepspeed_tpu_torch.models.gpt import GPT, gpt_config
    from deepspeed_tpu_torch.testing import fault_injection as fi
    cfg = gpt_config("gpt2", n_positions=TRAIN_SEQ, remat=True)
    base = dict(TRAIN_CFG, zero_optimization={"stage": 1})
    batches = [host_batch(cfg.vocab_size, 900 + i) for i in range(RECOVERY_STEPS)]
    gc.collect()
    torch.cuda.empty_cache()
    model = GPT(cfg, device=device, seed=0)
    engine = train_engine(model, dict(base, elasticity=dict(RECOVERY_CFG),
                                      telemetry={"enabled": True, "flush_every": 1,
                                                 "ops_server": True}), device)
    try:
        fi.install_plan([{"site": "comm.collective", "action": "wedge",
                          "on_hit": per_step + 1}])
        t0 = time.perf_counter()
        engine.train_batch(batch=batches[0])
        first_s = time.perf_counter() - t0
        capturing = torch.cuda.is_current_stream_capturing()
        fi.clear_plan()
        url = engine.telemetry.obs_server.url
        status = json.loads(urllib.request.urlopen(url + "/recovery", timeout=30).read())
        try:
            health = urllib.request.urlopen(url + "/healthz", timeout=30).status
        except urllib.error.HTTPError as e:         # an unhealthy answer is an answer
            health = e.code
        for b in batches[1:]:
            engine.train_batch(batch=b)
        got = engine.get_fp32_params()
        same = all(torch.equal(got[k], v) for k, v in want.items())
        recovery_s = engine.telemetry.ledger.snapshot()["categories"].get("comm_recovery", 0.0)
        final = engine.recovery_manager.status()
        captures = engine.graphs.captures
    finally:
        fi.clear_plan()
        engine.close()
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    say(f"recovery in process (gpt2 bf16 seq 512 micro 8, ZeRO-1, one-rank NCCL group; "
        f"{per_step} collectives a step; wedge at hit {per_step + 1}, the capture's first): "
        f"first step {first_s:.3f} s (deadline {RECOVERY_CFG['collective_timeout_s']} s); "
        f"stream capturing after it {capturing}; /recovery mid-run: incidents "
        f"{status.get('incidents')}, state {status.get('ladder_state')}; /healthz {health}; "
        f"captures {captures}; comm_recovery {recovery_s:.3f} s; parameters after "
        f"{RECOVERY_STEPS} steps equal the unwedged run's bit for bit {same} [{card}]")
    if (capturing or not same or captures != 1 or final["incidents"] != 1
            or final["recoveries"] != 1 or status.get("incidents") != 1
            or recovery_s < 0.5 * RECOVERY_CFG["collective_timeout_s"]):
        fail(f"recovery in process: {final}")
    return dict(first_s=first_s, recovery_s=recovery_s)



# --------------------------------------------------------------------------- #
# phases 40-41: the autotuner on GPT-2
# --------------------------------------------------------------------------- #
# the user script the autotuner runs (GPT-2 at seq 512 through initialize()
# -> train_batch, AUTOTUNE_STEPS steps; it prints a WORKER line and writes
# launches.json beside its metrics)
AUTOTUNE_WORKER = os.path.join("tests", "torch_autotune_worker.py")
AUTOTUNE_STEPS = 6
AUTOTUNE_CFG = dict(TRAIN_CFG, steps_per_print=3)          # 3 divides the 6 steps
AUTOTUNE_MICROS = [4, 8]
GPT2_BLOCK_PARAMS = 7_087_872       # one GPT-2 block (the closed loop's model_info)
# the kernels the trials' path runs: Queue 2 rows 1-7
AUTOTUNE_KERNELS = ("flash_forward", "flash_backward_dq", "flash_backward_dkv", "ce_forward",
                    "ce_backward_dx", "ce_backward_dhead", "fused_adam")
AUTOTUNE_TIMEOUT_S = 300.0


def autotune_env() -> dict:
    """The children's environment: this checkout on the path, the bytecode
    this process wrote (``main``) read from its prefix, and no autotuning
    variable of the caller's."""
    here = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=here, PYTHONDONTWRITEBYTECODE="",
               PYTHONPYCACHEPREFIX=sys.pycache_prefix)
    for key in ("DS_AUTOTUNING_CONFIG", "DS_AUTOTUNING_METRIC_PATH"):
        env.pop(key, None)
    return env


def worker_lines(text: str) -> list:
    return [json.loads(x[len("WORKER "):]) for x in text.splitlines()
            if x.startswith("WORKER ")]


def child_launches(info: dict, label: str) -> dict:
    """A child's launches of rows 1-7, held to the launches its steps must
    make (``expected``: each flash kernel once per layer per micro-step,
    each cross-entropy kernel once per micro-step, AdamW once a step or a
    chunk) with no plain version called."""
    got = {k: info["launches"][k] for k in AUTOTUNE_KERNELS}
    want = {k: info["expected"][k] for k in AUTOTUNE_KERNELS}
    if got != want or any(v <= 0 for v in got.values()) or any(info["plain_calls"].values()):
        fail(f"{label}: launches {got}, expected {want}; plain calls {info['plain_calls']}")
    return got


def add_counts(total: dict, more: dict) -> dict:
    return {k: total.get(k, 0) + more.get(k, 0) for k in AUTOTUNE_KERNELS}


def phase_autotune_launcher(card: str):
    """Phase 40: ``python -m deepspeed_tpu_torch.launcher.runner --autotuning
    run`` on AUTOTUNE_WORKER with ``autotuning: {zero_stages: [0],
    micro_batch_sizes: [4, 8]}``: two experiments through the
    ``ResourceManager`` (each a process; the engine writes its throughput
    at each ``steps_per_print`` boundary) and the final run through the
    launcher with ``DS_AUTOTUNING_CONFIG`` at ``ds_config_optimal.json``.
    Holds: each experiment's metrics.json has throughput > 0 after 6
    steps; ``ds_config_optimal.json`` is the experiment with the larger
    recorded throughput; the final run's engine reports its micro-batch;
    each child launched rows 1-7 exactly as its steps must."""
    here = str(Path(__file__).resolve().parent)
    root = tempfile.mkdtemp(prefix="chip_smoke_autotune_", dir=ckpt_root())
    try:
        cfg = dict(AUTOTUNE_CFG, autotuning={"zero_stages": [0],
                                             "micro_batch_sizes": AUTOTUNE_MICROS})
        Path(root, "ds.json").write_text(json.dumps(cfg))
        cmd = [sys.executable, "-m", "deepspeed_tpu_torch.launcher.runner", "--autotuning",
               "run", os.path.join(here, AUTOTUNE_WORKER), "--steps", str(AUTOTUNE_STEPS),
               "--deepspeed_config", "ds.json"]
        t0 = time.perf_counter()
        out = subprocess.run(cmd, cwd=root, env=autotune_env(), capture_output=True,
                             text=True, timeout=3 * AUTOTUNE_TIMEOUT_S)
        secs = time.perf_counter() - t0
        if out.returncode != 0:
            print(out.stdout[-6000:] + out.stderr[-6000:], file=sys.stderr)
            fail(f"--autotuning run exited {out.returncode}")
        exps, launches = [], {}
        for d in sorted(Path(root, "autotuning_exps").iterdir()):
            metrics = json.loads((d / "metrics.json").read_text())
            exp_cfg = json.loads((d / "ds_config.json").read_text())
            info = json.loads((d / "launches.json").read_text())
            if (metrics["throughput"] <= 0 or metrics["global_steps"] != AUTOTUNE_STEPS
                    or info["micro_batch"] != exp_cfg["train_micro_batch_size_per_gpu"]):
                fail(f"autotuning experiment {d.name}: metrics {metrics}, micro "
                     f"{info['micro_batch']} of {exp_cfg['train_micro_batch_size_per_gpu']}")
            launches = add_counts(launches, child_launches(info, f"experiment {d.name}"))
            exps.append(dict(name=d.name, throughput=metrics["throughput"], cfg=exp_cfg,
                             info=info))
        optimal = json.loads(Path(root, "autotuning_results", "ds_config_optimal.json")
                             .read_text())
        best = max(exps, key=lambda e: e["throughput"])
        final = worker_lines(out.stdout)
        if (len(exps) != len(AUTOTUNE_MICROS) or optimal != best["cfg"] or len(final) != 1
                or final[0]["micro_batch"] != optimal["train_micro_batch_size_per_gpu"]
                or final[0]["steps"] != AUTOTUNE_STEPS):
            fail(f"--autotuning run: experiments {[(e['name'], e['throughput']) for e in exps]}, "
                 f"optimal micro {optimal.get('train_micro_batch_size_per_gpu')}, final run "
                 f"{final}")
        launches = add_counts(launches, child_launches(final[0], "the final run"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for e in exps + [dict(name="final run", throughput=None, info=final[0])]:
        i = e["info"]
        say(f"autotune launcher {e['name']} (gpt2 bf16 seq {TRAIN_SEQ} micro {i['micro_batch']}, "
            f"ZeRO-0): start-up {i['times']['startup_s']:.2f} s (process age at imports "
            f"{i['times']['import_s']:.2f}, engine {i['times']['engine_s']:.2f}), mean step "
            f"{i['step_ms']:.3f} ms, {i['samples_per_s']:.1f} samples/s"
            + (f", recorded throughput {e['throughput']:.1f}" if e["throughput"] else "")
            + f", loss {i['loss']:.4f} [{card}]")
    say(f"autotune launcher (--autotuning run, {secs:.1f} s): optimal micro "
        f"{optimal['train_micro_batch_size_per_gpu']} (the larger recorded throughput: "
        f"{best['name']}); the final run trained at micro {final[0]['micro_batch']}; children's "
        f"launches {json.dumps(launches)} [{card}]")
    return dict(secs=secs, launches=launches, best=best["name"])


def phase_autotune_loop(card: str):
    """Phase 41, the search: ``ClosedLoopAutotuner`` with
    ``TrialScheduler(cmd=[python, AUTOTUNE_WORKER])`` and GPT-2's
    ``model_info`` (its parameters at seq 512, 12 layers, one block's
    parameters) over ZeRO-3 x ``offload_param`` {none, cpu} x micro {4, 8},
    with ``device_memory_bytes`` between the offloaded layer-window peak and
    the gathered peak of ``memory_model.analytic_step_peaks``: the two
    unoffloaded candidates are pruned (no trial dir, no process), the two
    offloaded ones run and are scored from their ``EFFICIENCY.json``.  It
    starts no kernel in this process.  Returns what ``phase_tuned_patch``
    checks; the caller removes ``root``."""
    from deepspeed_tpu_torch.autotuning import ClosedLoopAutotuner, TrialScheduler
    from deepspeed_tpu_torch.runtime import memory_model
    here = str(Path(__file__).resolve().parent)
    peaks = memory_model.analytic_step_peaks(TRAIN_PARAMS, 1, block_params=GPT2_BLOCK_PARAMS,
                                             n_layer=TRAIN_LAYERS)
    budget = (peaks.window_peak_bytes + peaks.plain_peak_bytes) // 2
    root = tempfile.mkdtemp(prefix="chip_smoke_autoloop_", dir=ckpt_root())
    results = os.path.join(root, "results")
    base = dict(AUTOTUNE_CFG, zero_optimization={"stage": 3}, autotuning={
        "search_space": {"zero_stage": [3], "offload_param": [None, "cpu"],
                         "micro_batch": AUTOTUNE_MICROS},
        "model_info": {"num_params": TRAIN_PARAMS, "n_layer": TRAIN_LAYERS,
                       "block_params": GPT2_BLOCK_PARAMS},
        "device_memory_bytes": budget, "results_dir": results})
    try:
        sched = TrialScheduler(os.path.join(results, "trials"),
                               cmd=[sys.executable, os.path.join(here, AUTOTUNE_WORKER),
                                    "--steps", str(AUTOTUNE_STEPS)],
                               timeout_s=AUTOTUNE_TIMEOUT_S, env=autotune_env())
        loop = ClosedLoopAutotuner(base, scheduler=sched, world=1)
        t0 = time.perf_counter()
        best = loop.tune()
        loop_s = time.perf_counter() - t0
        launches, trials = {}, []
        for t in loop.trials:
            info = (json.loads(Path(t.trial_dir, "launches.json").read_text())
                    if os.path.exists(os.path.join(t.trial_dir, "launches.json")) else None)
            if not t.scored or info is None:
                print(Path(t.trial_dir, "stdout.log").read_text()[-6000:], file=sys.stderr)
                fail(f"closed loop: trial {t.name} {t.status} ({t.error})")
            launches = add_counts(launches, child_launches(info, f"trial {t.name}"))
            trials.append((t, info))
        pruned_dirs = [p.name for p in loop.pruned
                       if os.path.exists(os.path.join(results, "trials", p.name))]
        if (len(loop.pruned) != 2 or pruned_dirs or len(trials) != 2
                or any("offload_param" in p.knobs for p in loop.pruned)
                or best is None or best.knobs.get("offload_param") != "cpu"):
            fail(f"closed loop: pruned {[(p.name, p.knobs) for p in loop.pruned]} (trial dirs "
                 f"{pruned_dirs}), trials {[t.name for t in loop.trials]}, best "
                 f"{best and best.knobs}")
        for t, i in trials:
            say(f"autotune loop trial {t.name} {t.knobs} (gpt2 bf16 seq {TRAIN_SEQ}): start-up "
                f"{i['times']['startup_s']:.2f} s, mean step {i['step_ms']:.3f} ms, "
                f"{i['samples_per_s']:.1f} samples/s, engine throughput "
                f"{i['engine_throughput']:.1f}, score goodput_frac "
                f"{t.score.goodput_frac:.4f} step {t.score.step_time_s:.4f} s (mfu "
                f"{t.score.mfu}), trial {t.duration_s:.1f} s [{card}]")
        pruned = [(p.name, p.prune_reason) for p in loop.pruned]
        say(f"autotune loop ({loop_s:.1f} s): pruned {pruned}; best {best.name} {best.patch}; "
            f"children's launches {json.dumps(launches)} [{card}]")
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise
    return dict(root=root, base=base, best=best, secs=loop_s, launches=launches,
                patch=os.path.join(results, "ds_config_patch.json"))


def phase_tuned_patch(device, card: str, looped):
    """Phase 41, the check at build, in this process: a GPT-2 engine built
    with the search's emitted patch applied and ``stale_policy: refuse``
    builds; with a copy of the patch whose fingerprint says ``num_params:
    1`` it raises ``StaleTuningError`` with no kernel launched."""
    import torch
    from deepspeed_tpu_torch.autotuning import StaleTuningError
    from deepspeed_tpu_torch.autotuning.space import apply_patch
    from deepspeed_tpu_torch.models.gpt import GPT, gpt_config
    best, patch_path = looped["best"], looped["patch"]
    doc = json.loads(Path(patch_path).read_text())
    cfg = apply_patch({k: v for k, v in looped["base"].items() if k != "autotuning"},
                      best.patch)
    gc.collect()
    torch.cuda.empty_cache()
    model = GPT(gpt_config("gpt2", n_positions=TRAIN_SEQ, remat=True), device=device, seed=0)
    t0 = time.perf_counter()
    engine = train_engine(model, dict(cfg, autotuning={"patch": patch_path,
                                                       "stale_policy": "refuse"}), device)
    build_s = time.perf_counter() - t0
    built = (engine.train_micro_batch_size_per_gpu(), engine._zero_stage,
             engine._offload_param)
    engine.close()
    del engine
    doc["fingerprint"]["model"]["num_params"] = 1
    doctored = os.path.join(looped["root"], "doctored_patch.json")
    Path(doctored).write_text(json.dumps(doc))
    for mod in kernel_modules():
        mod.reset_counts()
    try:
        train_engine(model, dict(cfg, autotuning={"patch": doctored,
                                                  "stale_policy": "refuse"}), device)
        refused = None
    except StaleTuningError as e:
        refused = str(e)
    counts, plain = read_counts()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    say(f"autotune loop's patch: fingerprint {doc['fingerprint']['pod']} "
        f"{doc['fingerprint_digest']}; the patched engine (micro, stage, offload_param) {built} "
        f"built under refuse in {build_s:.2f} s; the doctored patch refused: {refused}; launches "
        f"during that build {sum(counts.values())}, plain calls {sum(plain.values())} [{card}]")
    if (refused is None or "model.num_params: tuned on 1, now %d" % TRAIN_PARAMS not in refused
            or any(counts.values()) or any(plain.values())
            or built != (best.knobs["micro_batch"], 3, True)):
        fail("closed loop: the emitted patch's fingerprint check did not hold")


class Beside(threading.Thread):
    """``fn`` in a thread beside this one.  ``result()`` waits for it and
    returns what it returned, or raises what it raised (a ``fail`` in it
    ends the script there).  Not a daemon: a script that fails in the main
    thread waits for it, so that no process it started outlives the
    script."""

    def __init__(self, fn):
        super().__init__(name="chip_smoke_beside")
        self._fn, self._out, self._err = fn, None, None
        self.start()

    def run(self):
        try:
            self._out = self._fn()
        except BaseException as e:        # SystemExit from fail() too
            self._err = e

    def result(self):
        self.join()
        if self._err is not None:
            raise self._err
        return self._out


def main() -> int:
    # the bytecode of what this process imports, written where the
    # processes of phases 38-41 read it: the installed packages come
    # without it, and a process compiling torch's modules spends seconds
    # of its start-up on them
    sys.pycache_prefix = tempfile.mkdtemp(prefix="chip_smoke_pycache_", dir=ckpt_root())
    sys.dont_write_bytecode = False
    atexit.register(shutil.rmtree, sys.pycache_prefix, True)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run",
              file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    try:
        import deepspeed_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    if Path(deepspeed_tpu_torch.__file__).resolve().parent.parent != here:
        print("chip_smoke: deepspeed_tpu_torch is not the checkout's own",
              file=sys.stderr)
        return 2
    from deepspeed_tpu_torch.models.gpt import GPT, gpt_config
    from deepspeed_tpu_torch.ops.cuda import builder

    clock = [time.perf_counter()]
    started = clock[0]

    def phase_done(label: str) -> None:
        now = time.perf_counter()
        say(f"phase {label}: {now - clock[0]:.1f} s")
        clock[0] = now

    # ---- 1. environment ---------------------------------------------------- #
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    say(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {kind}, count "
        f"{torch.cuda.device_count()}")
    phase_done("1")

    # ---- 2. build ------------------------------------------------------------ #
    res = builder.build()
    builder.load_library()
    say(f"build: {res.path.name} in {res.seconds:.2f}s from "
        f"{[p.name for p in builder.sources()]}; each source's nvcc ended at (s) "
        f"{ {k: round(v, 1) for k, v in res.per_source.items()} }")
    for line in res.log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            say(f"  ptxas: {line.strip()}")
    from deepspeed_tpu_torch.ops.cuda import flash_attention as tfa
    occupancy = []
    for kern in ("forward", "dq", "dkv"):
        for dt_name, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            for extras in (False, True):
                for head_dim in tfa.BACKWARD_HEAD_DIMS:
                    n, smem = tfa.kernel_occupancy(kern, dt, extras, head_dim)
                    occupancy.append(f"{kern} {dt_name}{' extras' if extras else ''} D{head_dim} "
                                     f"{n} x {smem} B")
    say("flash blocks per SM x shared memory per block (occupancy query): "
        + ", ".join(occupancy))
    from deepspeed_tpu_torch.ops.cuda import block_sparse_attention as tbs
    nb = SPARSE_SEQ // 64       # the path's layout: 64 blocks, at most 61 listed per row
    occupancy = [(kern, dt_name, *tbs.kernel_occupancy(kern, dt, nb))
                 for kern in ("forward", "dq", "dkv")
                 for dt_name, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32))]
    say("block-sparse blocks per SM x shared memory per block at S 4096 (occupancy query): "
        + ", ".join(f"{kern} {dt_name} {n} x {smem} B" for kern, dt_name, n, smem in occupancy))
    # the kernels this tree redesigned: registers and spills (ptxas), blocks
    # per SM and dynamic shared memory per block (the occupancy query)
    from deepspeed_tpu_torch.ops.cuda import cross_entropy as tce
    redesigned = [("ce_fwd_wgmma_kernel", "ce_fwd_wgmma_kernelILb0E",
                   tce.kernel_occupancy(torch.bfloat16)),
                  ("ce_fwd_kernel (fp32)", "13ce_fwd_kernelE", tce.kernel_occupancy(torch.float32)),
                  ("sparse_fwd_kernel<bf16>", "sparse_fwd_kernelI13__nv_bfloat16",
                   tbs.kernel_occupancy("forward", torch.bfloat16, nb)),
                  ("sparse_fwd_kernel<fp32>", "sparse_fwd_kernelIf",
                   tbs.kernel_occupancy("forward", torch.float32, nb)),
                  ("sparse_dq_wgmma_kernel (bf16)", "sparse_dq_wgmma_kernel",
                   tbs.kernel_occupancy("dq", torch.bfloat16, nb)),
                  ("sparse_dq_kernel<fp32>", "sparse_dq_kernelIf",
                   tbs.kernel_occupancy("dq", torch.float32, nb))]
    say("redesigned kernels (registers, spill stores / loads in bytes, blocks per SM, shared "
        "memory per block): " + "; ".join(
            "{} {} regs, spills {} / {}, {} per SM, {} B".format(
                name, *build_info(res.log, entry), blocks, smem)
            for name, entry, (blocks, smem) in redesigned))
    # the kernels this tree added: the flash kernels at head_dim 128 and the
    # cross-entropy backward's wide path (registers and spills, ptxas)
    added = [(f"flash_{k}_kernel<{dt}, 128{', extras' if x else ''}>",
              f"flash_{k}_kernelI{m}Li128ELb{int(x)}E")
             for k in ("fwd", "dq", "dkv") for dt, m in (("bf16", "13__nv_bfloat16"), ("fp32", "f"))
             for x in (False, True)]
    added += [(f"ce_wide_{k}_kernel<{dt}>", f"ce_wide_{k}_kernelI{m}")
              for k in ("ds", "dx", "dhead")
              for dt, m in (("bf16", "13__nv_bfloat16"), ("fp32", "f"))]
    say("head_dim-128 flash and wide cross-entropy kernels (registers, spill stores / loads in "
        "bytes): " + "; ".join("{} {} regs, spills {} / {}".format(
            name, *build_info(res.log, entry)) for name, entry in added))
    # the kernels at head_dim 96 and 256: the three flash kernels, the
    # decode kernels' decode path (S_q 1 and 4) and prefill path
    served = [(f"flash_{k}_kernel<{dt}, {d}{', extras' if x else ''}>",
               f"flash_{k}_kernelI{m}Li{d}ELb{int(x)}E")
              for k in ("fwd", "dq", "dkv") for d in (96, 256)
              for dt, m in (("bf16", "13__nv_bfloat16"), ("fp32", "f")) for x in (False, True)]
    served += [(f"paged_{k}_kernel<{dt}, {d}{r}>", f"paged_{k}_kernelI{m}Li{d}E{e}")
               for d in (96, 256) for dt, m in (("bf16", "13__nv_bfloat16"), ("fp32", "f"))
               for k, r, e in (("decode", ", 1", "Li1E"), ("decode", ", 4", "Li4E"),
                               ("prefill", "", "EE"))]
    say("head_dim-96 and -256 kernels (registers, spill stores / loads in bytes): "
        + "; ".join("{} {} regs, spills {} / {}".format(name, *build_info(res.log, entry))
                    for name, entry in served))
    say("kernels: paged_attention, decode_attention, flash_forward, flash_backward_dq, "
        "flash_backward_dkv, ce_forward, ce_backward_dx, ce_backward_dhead, fused_adam, "
        "block_sparse_forward, block_sparse_backward_dq, block_sparse_backward_dkv")
    phase_done("2")

    # ---- 3. kernels against their plain versions ----------------------------- #
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=device)
    rows = kernel_cases(device, flush=scratch.zero_,
                        clean_flush=scratch.view(torch.float32).sum)
    del scratch
    phase_done("3")

    # ---- 4. end to end, fp32 ---------------------------------------------------- #
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("fp32 phases: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    cfg = gpt_config("gpt2-xl", dtype="float32")
    t0 = time.perf_counter()
    model = GPT(cfg, device=device, seed=0)
    torch.cuda.synchronize()
    say(f"model: gpt2-xl {cfg.n_layer} layers x {cfg.n_embd}, {cfg.n_head} "
        f"heads, {model.num_params() / 1e9:.3f}B params, seeded init in "
        f"{time.perf_counter() - t0:.1f}s")
    prompts = make_prompts(cfg.vocab_size, PROMPT_LENS)
    fp32 = phase_fp32(model, prompts, device, roomy_blocks=512,
                      small_blocks=40)
    phase_done("4")

    # ---- 5. bf16 serving -------------------------------------------------------- #
    bf16 = phase_bf16(model, prompts, device, blocks=512, card=card)
    say(f"summary: fp32 near-ties {fp32['roomy']['ties']} roomy / "
        f"{fp32['preempting']['ties']} preempting; bf16 "
        f"{bf16['tokens_per_s']:.1f} tokens/s [{card}]")
    say("launches by run: " + json.dumps({
        "fp32 generate()": fp32["generate"]["counts"],
        "fp32 serve (roomy)": fp32["roomy"]["counts"],
        "fp32 serve (preempting)": fp32["preempting"]["counts"],
        "bf16 serve": bf16["counts"]}))

    del model
    torch.cuda.empty_cache()
    phase_done("5")

    # ---- 6. training kernels against their plain versions -------------------- #
    # 10 timed launches a case, not 20: the whole script must finish in
    # 1200 s, and one H100 machine with a slow host took 1141 s
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=device)
    flash_rows = flash_cases(device, scratch.zero_, card, reps=10)
    torch.cuda.empty_cache()
    sparse_rows = sparse_cases(device, scratch.zero_, card, reps=10)
    torch.cuda.empty_cache()
    train_rows = (ce_cases(device, flush=scratch.zero_, reps=10)
                  + adam_case(device, flush=scratch.zero_))
    torch.cuda.empty_cache()
    train_rows += adam_moe_case(device, flush=scratch.zero_)
    report_rows(train_rows)
    torch.cuda.empty_cache()
    train_rows += ce_family_cases(device, scratch.zero_, card)
    del scratch
    torch.cuda.empty_cache()
    phase_done("6")

    # ---- 7. training end to end, bf16 ------------------------------------------- #
    train = phase_train_bf16(device, card)
    torch.cuda.empty_cache()
    short = phase_train_bf16(device, card, seq=SHORT_SEQ, timed=SHORT_TIMED_STEPS,
                             profiled=False)
    torch.cuda.empty_cache()
    phase_done("7")

    # ---- 8. kernel path against the plain path, fp32 ----------------------------- #
    parity = phase_train_fp32_parity(device)
    phase_done("8")
    say(f"summary: bf16 train seq {TRAIN_SEQ} graphed {train['step_ms']:.3f} ms/step "
        f"(host {train['host_ms']:.3f}), {train['samples_per_s']:.2f} samples/s, "
        f"{train['tflops']:.2f} TFLOPs; eager {train['eager_step_ms']:.3f} ms/step (host "
        f"{train['eager_host_ms']:.3f}), {train['eager_samples_per_s']:.2f} samples/s (seq "
        f"{SHORT_SEQ}: graphed {short['step_ms']:.3f}, eager {short['eager_step_ms']:.3f} "
        f"ms/step); fp32 kernel-vs-plain loss rel diff {parity['loss_rel']:.3e} [{card}]")
    torch.cuda.empty_cache()

    # ---- 9. the block-sparse path, bf16, beside the dense step ----------------- #
    register_sparse_attention()
    sparse = phase_train_bf16(device, card, seq=SPARSE_SEQ, timed=SPARSE_TIMED_STEPS,
                              attn_impl="block_sparse", micro=SPARSE_MICRO,
                              config=SPARSE_TRAIN_CFG)
    if sparse["params"] != SPARSE_PARAMS:
        fail(f"sparse path: expected {SPARSE_PARAMS:,} parameters, got {sparse['params']:,}")
    torch.cuda.empty_cache()
    dense = phase_train_bf16(device, card, seq=SPARSE_SEQ, timed=SPARSE_DENSE_STEPS,
                             attn_impl="flash", micro=SPARSE_MICRO, config=SPARSE_TRAIN_CFG)
    torch.cuda.empty_cache()
    phase_done("9")

    # ---- 10. the sparse path in fp32, kernels against plain versions ---------- #
    sparse_parity = phase_train_fp32_parity(device, seq=SPARSE_SEQ, micro=SPARSE_MICRO,
                                            attn_impl="block_sparse", config=SPARSE_TRAIN_CFG)
    phase_done("10")
    say(f"summary: bf16 train seq {SPARSE_SEQ} micro {SPARSE_MICRO}: block_sparse graphed "
        f"{sparse['step_ms']:.3f} ms/step (host {sparse['host_ms']:.3f}), "
        f"{sparse['samples_per_s']:.2f} samples/s, eager {sparse['eager_step_ms']:.3f} ms/step "
        f"(host {sparse['eager_host_ms']:.3f}); flash graphed {dense['step_ms']:.3f} ms/step, "
        f"{dense['samples_per_s']:.2f} samples/s; device ms per graphed step "
        f"{device_ms(sparse):.3f} sparse, {device_ms(dense):.3f} flash; fp32 "
        f"kernel-vs-plain loss rel diff {sparse_parity['loss_rel']:.3e} [{card}]")

    torch.cuda.empty_cache()

    # ---- 11. the other GPT-2 widths, bf16 ------------------------------------------ #
    widths = {}
    for preset, (graphed, eager, loss_steps) in TRAIN_WIDTHS.items():
        widths[preset] = phase_train_bf16(device, card, timed=graphed, profiled=False,
                                          preset=preset, eager=eager, loss_steps=loss_steps)
        torch.cuda.empty_cache()
    say("summary: bf16 train at GPT-2's other widths, seq 512 micro 8: " + "; ".join(
        f"{p} {r['n_layer']} layers x {r['n_embd']}: loss {r['losses'][0]:.4f} -> "
        f"{r['losses'][-1]:.4f}, graphed {r['step_ms']:.3f} ms/step (host {r['host_ms']:.3f}, "
        f"device {device_ms(r):.3f}), eager {r['eager_step_ms']:.3f} (host "
        f"{r['eager_host_ms']:.3f}, device {device_ms(r, 'eager_profile'):.3f}); peak memory "
        f"graphed {r['memory']['graphed_reserved_gib']:.2f} GiB reserved / "
        f"{r['memory']['graphed_alloc_gib']:.2f} allocated, eager "
        f"{r['memory']['eager_alloc_gib']:.2f} allocated"
        for p, r in widths.items()) + f" [{card}]")
    phase_done("11")

    # ---- 12. graphed against eager; checkpoints --------------------------------- #
    graph_parity = phase_graph_parity(device)
    torch.cuda.empty_cache()
    resume = phase_resume(device, card)
    torch.cuda.empty_cache()
    say(f"summary: graphed vs eager fp32 bitwise {graph_parity['bitwise']}; resume bitwise "
        f"{resume['sync']['bitwise']} (sync) / {resume['async']['bitwise']} (async); save "
        f"{resume['sync']['save_s']:.3f} s, load {resume['sync']['load_s']:.3f} s, "
        f"{resume['sync']['bytes']:,} bytes a tag [{card}]")
    phase_done("12")

    # ---- 13-14. the LLaMA and BLOOM families: fp32 identity, bf16 at full size -- #
    families = {}
    for n, name in ((13, "llama3-8b"), (14, "bloom-7b1")):
        gc.collect()
        torch.cuda.empty_cache()
        families[name] = r = phase_family(name, device, card)
        prof = r["bf16"]["profile"]
        say(f"summary: {name} fp32 near-ties {r['fp32']['roomy']['ties']} roomy / "
            f"{r['fp32']['preempting']['ties']} preempting (preemptions "
            f"{r['fp32']['preempting']['preemptions']}); bf16 {r['n_layer']} layers: "
            f"{r['bf16']['tokens_per_s']:.1f} tokens/s, median TTFT {r['bf16']['ttft_ms']:.1f} "
            f"ms, median decode step {r['bf16']['decode_step_ms']:.2f} ms, "
            + ("profiled decode step not measured" if prof is None else
               f"profiled decode step {prof[0]:.3f} ms device, busy {prof[1]:.1%}, paged "
               f"attention {prof[2]:.4f} ms ({prof[3]:.1%})")
            + f", peak memory {r['peak_gib']:.2f} GiB [{card}]")
        phase_done(str(n))
    say("launches by run: " + json.dumps({
        f"{name} {run}": counts for name, r in families.items() for run, counts in (
            ("fp32 generate()", r["fp32"]["generate"]["counts"]),
            ("fp32 serve (roomy)", r["fp32"]["roomy"]["counts"]),
            ("fp32 serve (preempting)", r["fp32"]["preempting"]["counts"]),
            ("bf16 serve", r["bf16"]["counts"]))}))

    # ---- 15-17. the families' training cells -------------------------------------- #
    gc.collect()
    torch.cuda.empty_cache()
    family_train = {"llama3-8b": phase_family_train("llama3-8b", device, card)}
    phase_done("15")
    from deepspeed_tpu_torch.models.gpt import llama_config
    layers, seq, micro = FAMILY_PARITY
    _, kw, _ = FAMILY_CELLS["llama3-8b"]
    family_parity = phase_train_fp32_parity(
        device, seq=seq, micro=micro,
        cfg=llama_config(**dict(kw, n_layer=layers), remat=True, dtype="float32"))
    phase_done("16")
    gc.collect()
    torch.cuda.empty_cache()
    family_train["bloom-7b1"] = phase_family_train("bloom-7b1", device, card)
    phase_done("17")
    for name, r in family_train.items():
        say(f"summary: {name} training at {r['n_layer']} layers x {r['n_embd']}, micro "
            f"{FAMILY_TRAIN_MICRO} x seq {FAMILY_TRAIN_SEQ}, {r['params']:,} params: loss "
            f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}; graphed {r['step_ms']:.3f} ms/step "
            f"(host {r['host_ms']:.3f}, device {device_ms(r):.3f}), {r['samples_per_s']:.3f} "
            f"samples/s, {r['tflops']:.2f} TFLOPs; eager {r['eager_step_ms']:.3f} ms/step; peak "
            f"memory graphed {r['memory']['graphed_alloc_gib']:.2f} GiB allocated / "
            f"{r['memory']['graphed_reserved_gib']:.2f} reserved [{card}]")
    say(f"summary: llama3-8b fp32 kernel-vs-plain at {layers} layers, seq {seq}, micro {micro}: "
        f"loss rel diff {family_parity['loss_rel']:.3e}, params max abs diff "
        f"{family_parity['param_max']:.3e}, relative L2 {family_parity['param_rel_l2']:.3e}")
    say("launches by run: " + json.dumps({
        f"{name} bf16 train graphed": r["counts"] for name, r in family_train.items()}))

    # ---- 18-20. DeepSpeed-MoE 350M+MoE-128 ---------------------------------------- #
    gc.collect()
    torch.cuda.empty_cache()
    moe_serve = phase_moe_serve(device, card)
    prof = moe_serve["bf16"]["profile"]
    f32 = moe_serve["fp32"]
    say(f"summary: moe-350m fp32 near-ties {f32['roomy']['ties']} roomy / "
        f"{f32['preempting']['ties']} preempting (preemptions {f32['preempting']['preemptions']}) "
        f"/ {f32['inference']['ties']} init_inference; bf16 {MOE_CELL['n_layer']} blocks: "
        f"{moe_serve['bf16']['tokens_per_s']:.1f} tokens/s, median TTFT "
        f"{moe_serve['bf16']['ttft_ms']:.1f} ms, median decode step "
        f"{moe_serve['bf16']['decode_step_ms']:.2f} ms, "
        + ("profiled decode step not measured" if prof is None else
           f"profiled decode step {prof[0]:.3f} ms device, busy {prof[1]:.1%}, paged attention "
           f"{prof[2]:.4f} ms ({prof[3]:.1%})")
        + f", weights {moe_serve['weights_gib']:.2f} GiB, peak memory "
        f"{moe_serve['peak_gib']:.2f} GiB [{card}]")
    say("launches by run: " + json.dumps({
        "moe-350m fp32 generate()": f32["generate"]["counts"],
        "moe-350m fp32 serve (roomy)": f32["roomy"]["counts"],
        "moe-350m fp32 serve (preempting)": f32["preempting"]["counts"],
        "moe-350m fp32 init_inference generate": f32["inference"]["counts"],
        "moe-350m bf16 serve": moe_serve["bf16"]["counts"]}))
    phase_done("18")
    gc.collect()
    torch.cuda.empty_cache()
    moe_train = phase_moe_train(device, card)
    r = moe_train
    say(f"summary: moe-350m training at {r['n_layer']} blocks x {r['n_embd']}, micro "
        f"{FAMILY_TRAIN_MICRO} x seq {FAMILY_TRAIN_SEQ}, {r['params']:,} params: loss "
        f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}; graphed {r['step_ms']:.3f} ms/step "
        f"(host {r['host_ms']:.3f}, device {device_ms(r):.3f}), {r['samples_per_s']:.3f} "
        f"samples/s, {r['tflops']:.2f} TFLOPs by the active parameter count; eager "
        f"{r['eager_step_ms']:.3f} ms/step (host {r['eager_host_ms']:.3f}, device "
        f"{device_ms(r, 'eager_profile'):.3f}); peak memory graphed "
        f"{r['memory']['graphed_alloc_gib']:.2f} GiB allocated / "
        f"{r['memory']['graphed_reserved_gib']:.2f} reserved [{card}]")
    say("launches by run: " + json.dumps({"moe-350m bf16 train graphed": r["counts"],
                                          "moe-350m bf16 train eager": r["eager_counts"]}))
    phase_done("19")
    gc.collect()
    torch.cuda.empty_cache()
    moe_parity = phase_moe_parity(device)
    say("summary: moe-350m fp32 kernel-vs-plain at "
        f"{MOE_PARITY_LAYERS} blocks, seq {TRAIN_SEQ}, micro {TRAIN_MICRO}: " + "; ".join(
            f"top-{k}: loss rel diff {r['loss_rel']:.3e}, params max abs diff "
            f"{r['param_max']:.3e}, relative L2 {r['param_rel_l2']:.3e}, own routes differing "
            f"{r['routes_differ']} (smallest gate margin {r['min_margin']:.3e})"
            for k, r in moe_parity.items()))
    phase_done("20")

    # ---- 21. the attention kernels at head_dim 256 and 96 ------------------------ #
    gc.collect()
    torch.cuda.empty_cache()
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=device)
    wide_rows = kernel_cases(device, flush=scratch.zero_,
                             clean_flush=scratch.view(torch.float32).sum, reps=20,
                             plain_reps=5, heads=WIDE_KERNEL_HEADS)
    wide_rows += wide_flash_cases(device, scratch.zero_, card)
    del scratch
    torch.cuda.empty_cache()
    phase_done("21")

    # ---- 22-23. GPT-J-6B and GPT-NeoX-20B served: fp32 identity, bf16 at full size #
    for n, name in ((22, "gptj-6b"), (23, "neox-20b")):
        gc.collect()
        torch.cuda.empty_cache()
        families[name] = r = phase_family(name, device, card)
        prof = r["bf16"]["profile"]
        say(f"summary: {name} fp32 near-ties {r['fp32']['roomy']['ties']} roomy / "
            f"{r['fp32']['preempting']['ties']} preempting (preemptions "
            f"{r['fp32']['preempting']['preemptions']}); bf16 {r['n_layer']} layers: "
            f"{r['bf16']['tokens_per_s']:.1f} tokens/s, median TTFT {r['bf16']['ttft_ms']:.1f} "
            f"ms, median decode step {r['bf16']['decode_step_ms']:.2f} ms, "
            + ("profiled decode step not measured" if prof is None else
               f"profiled decode step {prof[0]:.3f} ms device, busy {prof[1]:.1%}, paged "
               f"attention {prof[2]:.4f} ms ({prof[3]:.1%})")
            + f", peak memory {r['peak_gib']:.2f} GiB [{card}]")
        say("launches by run: " + json.dumps({
            f"{name} {run}": counts for run, counts in (
                ("fp32 generate()", r["fp32"]["generate"]["counts"]),
                ("fp32 serve (roomy)", r["fp32"]["roomy"]["counts"]),
                ("fp32 serve (preempting)", r["fp32"]["preempting"]["counts"]),
                ("bf16 serve", r["bf16"]["counts"]))}))
        phase_done(str(n))

    # ---- 24. module_inject and int8 --------------------------------------------- #
    gc.collect()
    torch.cuda.empty_cache()
    inject = phase_inject(device, card)
    i8 = inject["int8"]
    say(f"summary: module_inject stand-ins fp32 near-ties "
        f"{inject['gptj-6b']['ties']} (gptj-6b) / {inject['neox-20b']['ties']} (neox-20b); "
        f"gptj-6b int8 block weights {i8['int8_gib']:.2f} GiB vs bf16 {i8['bf16_gib']:.2f}, "
        f"decode step int8 {i8['int8']['step_ms']:.2f} ms vs bf16 {i8['bf16']['step_ms']:.2f}, "
        f"agreement {i8['agree']} / {i8['tokens']}, logit distance {i8['logit_dist']:.4f}, "
        f"peak {i8['peak_gib']:.2f} GiB [{card}]")
    say("launches by run: " + json.dumps({
        **{f"{name} fp32 init_inference(stand-in) generate": inject[name]["counts"]
           for name in INJECT_KINDS},
        **{f"{name} bf16 stand-in forward + cached steps": inject[name]["forward_counts"]
           for name in INJECT_KINDS},
        "gptj-6b bf16 init_inference generate": i8["bf16"]["counts"],
        "gptj-6b int8 init_inference generate": i8["int8"]["counts"],
        f"gptj-6b bf16 {INT8_FORWARD}-token forward": i8["flash_counts"]}))
    phase_done("24")

    # ---- 25. flash dQ and dKV at head_dim 256 and 96 -------------------------------- #
    gc.collect()
    torch.cuda.empty_cache()
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=device)
    wide_rows += wide_backward_cases(device, scratch.zero_, card)
    del scratch
    torch.cuda.empty_cache()
    phase_done("25")

    # ---- 26. GPT-J-6B's and GPT-NeoX-20B's training cells ------------------------- #
    wide_train = {}
    for name in ("gptj-6b", "neox-20b"):
        gc.collect()
        torch.cuda.empty_cache()
        wide_train[name] = phase_family_train(name, device, card)
    for name, r in wide_train.items():
        say(f"summary: {name} training at {r['n_layer']} layers x {r['n_embd']}, micro "
            f"{FAMILY_TRAIN_MICRO} x seq {FAMILY_TRAIN_SEQ}, {r['params']:,} params: loss "
            f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}; graphed {r['step_ms']:.3f} ms/step "
            f"(host {r['host_ms']:.3f}, device {device_ms(r):.3f}), {r['samples_per_s']:.3f} "
            f"samples/s, {r['tflops']:.2f} TFLOPs; eager {r['eager_step_ms']:.3f} ms/step (host "
            f"{r['eager_host_ms']:.3f}, device {device_ms(r, 'eager_profile'):.3f}); peak memory "
            f"graphed {r['memory']['graphed_alloc_gib']:.2f} GiB allocated / "
            f"{r['memory']['graphed_reserved_gib']:.2f} reserved, eager "
            f"{r['memory']['eager_alloc_gib']:.2f} allocated [{card}]")
    say("launches by run: " + json.dumps({
        f"{name} bf16 train {path}": r[key] for name, r in wide_train.items()
        for path, key in (("graphed", "counts"), ("eager", "eager_counts"))}))
    phase_done("26")

    # ---- 27. their fp32 kernel paths against the plain paths --------------------- #
    from deepspeed_tpu_torch.models.gpt import GPTConfig
    layers, seq, micro = FAMILY_PARITY
    wide_parity = {}
    for name in ("gptj-6b", "neox-20b"):
        _, kw, _ = FAMILY_CELLS[name]
        gc.collect()
        torch.cuda.empty_cache()
        wide_parity[name] = phase_train_fp32_parity(
            device, seq=seq, micro=micro,
            cfg=GPTConfig(**dict(kw, n_layer=layers), remat=True, dtype="float32"))
    say(f"summary: fp32 kernel-vs-plain at {layers} layers, seq {seq}, micro {micro}: " + "; ".join(
        f"{name} loss rel diff {r['loss_rel']:.3e}, params max abs diff {r['param_max']:.3e}, "
        f"relative L2 {r['param_rel_l2']:.3e}" for name, r in wide_parity.items()))
    phase_done("27")

    # ---- 28. ZeRO stages 0-3 and offload at world size 1 -------------------------- #
    gc.collect()
    torch.cuda.empty_cache()
    zero_runs = phase_zero_stages(device, card)
    say("summary: ZeRO at world size 1 (NCCL), GPT-2 fp32 seq 512 micro 8, 3 graphed steps "
        "against stage 0: " + "; ".join(
            f"{n} bitwise {r['bitwise']}, loss rel {r['loss_rel']:.3e}, params max abs "
            f"{r['param_max']:.3e}, AdamW launches a step {r['adam']}"
            for n, r in zero_runs.items()) + f" [{card}]")
    say("launches by run: " + json.dumps({f"gpt2 fp32 {n} graphed": r["counts"]
                                          for n, r in zero_runs.items()}))
    phase_done("28")

    # ---- 29. GPT-2 XL at stage 3 with both offloads ------------------------------- #
    gc.collect()
    torch.cuda.empty_cache()
    bandwidth = pinned_bandwidth(device)
    warm, timed, eager, loss_steps = ZERO_XL
    xl_offload = phase_zero_offload(
        device, card, "gpt2-xl offload", bandwidth,
        stage0_device_ms=device_ms(widths["gpt2-xl"]), preset="gpt2-xl",
        config=dict(TRAIN_CFG, zero_optimization=ZERO3_OFFLOAD), warmup=warm, timed=timed,
        eager=eager, loss_steps=loss_steps)
    say(f"summary: gpt2-xl bf16 seq 512 micro 8 at ZeRO-3 with both offloads: graphed "
        f"{xl_offload['step_ms']:.3f} ms/step, eager {xl_offload['eager_step_ms']:.3f}, floor "
        f"{xl_offload['after']['floor_ms']:.3f}; phase 11's stage-0 graphed step "
        f"{widths['gpt2-xl']['step_ms']:.3f} ms [{card}]")
    say("launches by run: " + json.dumps({
        f"gpt2-xl offload bf16 train {path}": xl_offload[key]
        for path, key in (("graphed", "counts"), ("eager", "eager_counts"))}))
    phase_done("29")

    # ---- 30. Llama-3-8B's widths past 8 layers at stage 3 with both offloads ------- #
    gc.collect()
    torch.cuda.empty_cache()
    available = mem_available()
    layers, n_llama, host_llama = llama_offload_depth(available)
    _, kw, _ = FAMILY_CELLS["llama3-8b"]
    say(f"model: llama3-8b training at {layers} of {kw['n_layer']} layers at ZeRO-3 with both "
        f"offloads: {n_llama:,} params; MemAvailable {available / 2 ** 30:.2f} GiB; the memory "
        f"model's host state {host_llama / 2 ** 30:.2f} GiB pinned (12 bytes a parameter), "
        f"{(1 - HOST_RESERVE_FRACTION):.0%} of MemAvailable less "
        f"{HOST_RESERVE_BYTES / 2 ** 30:.0f} GiB allowed [{card}]")
    warm, timed, eager = LLAMA_OFFLOAD
    llama_offload = phase_zero_offload(
        device, card, f"llama3-8b {layers} layers offload", bandwidth,
        cfg=llama_config(**dict(kw, n_layer=layers), remat=True, dtype="bfloat16"),
        preset="llama3-8b", seq=FAMILY_TRAIN_SEQ, micro=FAMILY_TRAIN_MICRO,
        config=dict(FAMILY_TRAIN_CFG, zero_optimization=ZERO3_OFFLOAD), warmup=warm,
        timed=timed, eager=eager)
    say(f"summary: llama3-8b widths at {layers} layers, micro {FAMILY_TRAIN_MICRO} x seq "
        f"{FAMILY_TRAIN_SEQ}, ZeRO-3 with both offloads: graphed "
        f"{llama_offload['step_ms']:.3f} ms/step, eager {llama_offload['eager_step_ms']:.3f}, "
        f"floor {llama_offload['after']['floor_ms']:.3f}, {llama_offload['tflops']:.2f} TFLOPs; "
        f"phase 15's 8-layer stage-0 graphed step {family_train['llama3-8b']['step_ms']:.3f} "
        f"ms [{card}]")
    say("launches by run: " + json.dumps({
        f"llama3-8b offload bf16 train {path}": llama_offload[key]
        for path, key in (("graphed", "counts"), ("eager", "eager_counts"))}))
    phase_done("30")

    # ---- 31-32. tiered KV, bounded dispatch and recovery: Llama-3-8B, bf16 ------- #
    gc.collect()
    torch.cuda.empty_cache()
    cell = tiered_cell(device)
    try:
        tier = phase_tiered(cell, device, card)
        phase_done("31")
        bounded = phase_bounded(cell, tier["tiered"], device, card)
    finally:
        shutil.rmtree(cell["root"], ignore_errors=True)
    say("launches by run: " + json.dumps({
        f"llama3-8b bf16 serve ({name})": r["counts"] for name, r in (
            ("roomy", tier["roomy"]), ("tiered", tier["tiered"]),
            ("recompute", tier["recompute"]), ("wedged", bounded["wedged"]),
            ("restage fault", bounded["faulted"]))}))
    tiered_counts = tier["tiered"]["counts"]
    del cell, tier, bounded          # the engines hold the model
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("32")

    # ---- 33. sampled generate() ------------------------------------------------- #
    sampled = phase_sampled(device, card)
    say("launches by run: " + json.dumps({"llama3-8b fp32 sampled generate()":
                                          sampled["counts"]}))
    phase_done("33")

    # ---- 34. phases 31-32's traffic at fp32 ------------------------------------------ #
    tiered32 = phase_tiered_fp32(device, card)
    say("launches by run: " + json.dumps({
        f"llama3-8b fp32 {FP32_TIER_LAYERS}-layer serve ({name})": c
        for name, c in tiered32["counts"].items()}))
    phase_done("34")

    # ---- 35. serving under the ops plane, GPT-2 XL bf16 ----------------------------- #
    ops_serve = phase_ops_serve(device, card)
    say("launches by run: " + json.dumps({
        f"gpt2-xl bf16 serve (ops plane {k}, run {i + 1})": r["counts"]
        for k, rs in ops_serve["runs"].items() for i, r in enumerate(rs)}))
    phase_done("35")

    # ---- 36. graphed training under the ops plane, GPT-2 bf16 ----------------------- #
    ops_train = phase_ops_train(device, card)
    say("launches by run: " + json.dumps({f"gpt2 bf16 train graphed (ops plane {k})":
                                          ops_train[k]["counts"] for k in ("off", "on")}))
    phase_done("36")

    # ---- 37. the stability sentinel in the graphed GPT-2 step ------------------ #
    gc.collect()
    torch.cuda.empty_cache()
    stability = phase_stability(device, card)
    phase_done("37")

    # ---- 38-41. the agent and collective recovery in this thread; beside them,
    # the autotuner's searches (phases 40-41), whose trials are processes of
    # their own that each train a few GPT-2 steps (their start-ups, not the
    # card, take their time) ------------------------------------------------- #
    roots = []

    def searches():
        tuned = phase_autotune_launcher(card)
        looped = phase_autotune_loop(card)
        roots.append(looped["root"])
        return tuned, looped
    beside = Beside(searches)
    try:
        agent_run = phase_agent(device, card)
        phase_done("38 (beside 40-41)")

        recovery = phase_recovery(device, card, agent_run["per_step"], agent_run["want"])
        phase_done("39 (beside 40-41)")
        say(f"summary: robustness plane on gpt2 bf16 seq 512 micro 8: stability median step "
            f"{stability['off_ms']:.3f} ms off / {stability['on_ms']:.3f} ms on; agent run "
            f"(preemption, crash, restart exit) {agent_run['secs']:.1f} s; recovery first step "
            f"{recovery['first_s']:.3f} s under a {RECOVERY_CFG['collective_timeout_s']} s "
            f"deadline, comm_recovery {recovery['recovery_s']:.3f} s [{card}]")

        # ---- 40-41. the launcher's --autotuning run and the closed loop --- #
        tuned, looped = beside.result()
        say(f"phases 40-41 beside 38-39: --autotuning run {tuned['secs']:.1f} s, closed loop "
            f"{looped['secs']:.1f} s")
        phase_done("40-41 (after 39)")
        phase_tuned_patch(device, card, looped)
        phase_done("41 (the patch's check at build)")
    finally:
        beside.join()
        for d in roots:
            shutil.rmtree(d, ignore_errors=True)
    autotune_launches = add_counts(tuned["launches"], looped["launches"])
    say("launches by run: " + json.dumps({"gpt2 bf16 autotuner children (phases 40-41)":
                                          autotune_launches}))

    # ---- 42. GPT-2 XL at ZeRO-3 with its moments on NVMe --------------------------- #
    gc.collect()
    torch.cuda.empty_cache()
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=device)
    nvme_xl = phase_nvme_offload(device, card, xl_offload, scratch.zero_)
    del scratch
    train_rows.append(nvme_xl["row"])
    report_rows([nvme_xl["row"]])
    say("launches by run: " + json.dumps({"gpt2-xl bf16 nvme train (phase 42)":
                                          nvme_xl["counts"]}))
    phase_done("42")

    say(f"total: {time.perf_counter() - started:.1f} s (build and phases 1-42)")

    # ---- report ------------------------------------------------------------------ #
    # each kernel's row: its case at the shape and dtype of the latest
    # slice's run that launches it, and that run's launch count: the
    # Llama-3-8B bf16 tiered serve for the paged kernel (phase 31), GPT-J-6B's bf16
    # init_inference generate for the contiguous one (phase 24); the
    # autotuner's GPT-2 children (phases 40-41, bf16, seq 512, micro 4 and
    # 8: their launches summed) for the flash and cross-entropy kernels, at
    # GPT-2's training shape (phase 6: B 8, S 512; N 4096, E 768); the
    # GPT-2 XL NVMe walk (phase 42: its steps' launches, one a chunk) for
    # AdamW, at one chunk of that walk; the seq-4096 sparse bf16 training
    # run for the block-sparse kernels
    main_case = {"paged_attention": ("llama3-8b-paged-decode", "bfloat16", tiered_counts),
                 "decode_attention": ("gptj-6b-generate-decode", "bfloat16",
                                      i8["bf16"]["counts"]),
                 "flash_forward": ("gpt2-train", "bfloat16", autotune_launches),
                 "flash_backward_dq": ("gpt2-train", "bfloat16", autotune_launches),
                 "flash_backward_dkv": ("gpt2-train", "bfloat16", autotune_launches),
                 "ce_forward": ("gpt2-train", "bfloat16", autotune_launches),
                 "ce_backward_dx": ("gpt2-train", "bfloat16", autotune_launches),
                 "ce_backward_dhead": ("gpt2-train", "bfloat16", autotune_launches),
                 "fused_adam": ("gpt2-xl-nvme-chunk", "float32", nvme_xl["counts"]),
                 "block_sparse_forward": ("gpt2-s4096-fixed", "bfloat16", sparse["counts"]),
                 "block_sparse_backward_dq": ("gpt2-s4096-fixed", "bfloat16", sparse["counts"]),
                 "block_sparse_backward_dkv": ("gpt2-s4096-fixed", "bfloat16",
                                               sparse["counts"])}
    csrc = "deepspeed_tpu_torch/ops/cuda/csrc/"
    source = {"paged_attention": csrc + "decode_attention.cu",
              "decode_attention": csrc + "decode_attention.cu",
              "flash_forward": csrc + "flash_attention.cu",
              "flash_backward_dq": csrc + "flash_attention.cu",
              "flash_backward_dkv": csrc + "flash_attention.cu",
              "ce_forward": csrc + "cross_entropy.cu",
              "ce_backward_dx": csrc + "cross_entropy.cu",
              "ce_backward_dhead": csrc + "cross_entropy.cu",
              "fused_adam": csrc + "fused_optim.cu",
              "block_sparse_forward": csrc + "block_sparse_attention.cu",
              "block_sparse_backward_dq": csrc + "block_sparse_attention.cu",
              "block_sparse_backward_dkv": csrc + "block_sparse_attention.cu"}
    replaces = {"paged_attention": "deepspeed_tpu/ops/pallas/decode_attention.py:230",
                "decode_attention": "deepspeed_tpu/ops/pallas/decode_attention.py:78",
                "flash_forward": "deepspeed_tpu/ops/pallas/flash_attention.py:154",
                "flash_backward_dq": "deepspeed_tpu/ops/pallas/flash_attention.py:249",
                "flash_backward_dkv": "deepspeed_tpu/ops/pallas/flash_attention.py:293",
                "ce_forward": "deepspeed_tpu/ops/pallas/cross_entropy.py:92",
                "ce_backward_dx": "deepspeed_tpu/ops/pallas/cross_entropy.py:182",
                "ce_backward_dhead": "deepspeed_tpu/ops/pallas/cross_entropy.py:205",
                "fused_adam": "deepspeed_tpu/ops/pallas/fused_optim.py:139",
                "block_sparse_forward": "deepspeed_tpu/ops/pallas/block_sparse_attention.py:116",
                "block_sparse_backward_dq": "deepspeed_tpu/ops/pallas/block_sparse_attention.py:195",
                "block_sparse_backward_dkv":
                    "deepspeed_tpu/ops/pallas/block_sparse_attention.py:231"}
    table = []
    for name, (case, dt, counts) in main_case.items():
        r = next(r for r in rows + flash_rows + sparse_rows + train_rows + wide_rows
                 if r["kernel"] == name and r["case"] == case and r["dtype"] == dt)
        table.append({"name": name, "route": "cuda", "source": source[name],
                      "replaces": replaces[name], "launches": counts[name],
                      "max_abs_err": r["err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
