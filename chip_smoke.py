#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. environment: torch / CUDA versions and the card's name and power limit;
2. build: compiles the CUDA kernels from ``deepspeed_tpu_torch/ops/cuda/csrc``;
3. kernels against their plain PyTorch versions at the serving shapes of
   GPT-2 XL (H=25, D=64, block 16), fp32 and bf16: max abs error, median
   kernel and plain times by CUDA events (L2 flushed before each launch),
   the bound (bytes or operations over the H100 SXM's peaks) and, for the
   contiguous kernel, one ``scaled_dot_product_attention`` call as a
   yardstick.  The contiguous kernel runs at batch-8 decode and at
   generate()'s own shapes (a 300-token prefill, a masked decode step);
4. end to end in fp32 (TF32 off): GPT-2 XL at full width and depth, seeded
   weights, served through ``init_serving`` and held token for token
   against the port's ``generate()`` — once with a roomy arena, once with a
   small one that forces preemption and recompute.  A divergence counts as
   a near-tie only where generate()'s top-two logits at the first differing
   position are within 1e-4;
5. bf16 serving of the same requests: tokens/s, median TTFT and median
   decode-step time, finite logits, and the first decode step's logits
   against the plain attention path.

Each run of phases 4-5 (generate(), each serve) zeroes the launch counters
just before it and reads them just after: its kernel must have launched,
the plain versions never.  The kernel table reports the paged kernel's
count from the bf16 serve and the contiguous kernel's from generate().
The last two lines are the kernel table (JSON) and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside this file, it exits non-zero and prints no result.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"float32": 67e12,  # fp32 outside the tensor cores
              "bfloat16": 989e12}
# |kernel - plain| <= TOL * max(1, |plain|): fp32 sums in another order;
# bf16 outputs are rounded to bf16 (2^-8 relative) after a softmax whose p
# the two versions round at different points
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
NEAR_TIE = 1e-4
BF16_LOGIT_TOL = 0.25            # first decode step, kernel vs plain attention

H, D, BS = 25, 64, 16            # GPT-2 XL heads / head_dim, arena block size
MB = 1024 // BS                  # blocks per sequence at n_positions 1024

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


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


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
def paged_inputs(rng, B, Sq, lengths, dtype, device):
    import torch
    NB = B * MB + 1
    kp = rng.standard_normal((NB, BS, H, D), dtype=np.float32)
    vp = rng.standard_normal((NB, BS, H, D), dtype=np.float32)
    ids = np.arange(1, NB, dtype=np.int32)
    rng.shuffle(ids)
    tables = ids[:B * MB].reshape(B, MB)
    q = rng.standard_normal((B, Sq, H, D), dtype=np.float32)

    def dev(a, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)
    return (dev(q), dev(kp), dev(vp), dev(tables, torch.int32),
            dev(np.asarray(lengths, np.int32), torch.int32))


def kernel_cases(device, flush, reps: int = 50, plain_reps: int = 10):
    """Every case x dtype: error, times, bound.  Returns the result rows."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da

    rng = np.random.default_rng(1234)
    decode_lengths = [0, 1, 15, 16, 17, 500, 299, MB * BS - 1]
    rows = []
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        esize = torch.tensor([], dtype=dtype).element_size()
        for case, B, Sq, lengths in (
                ("paged-decode", 8, 1, decode_lengths),
                ("paged-prefill", 1, 64, [MB * BS - 24])):  # len + 64 > MB*BS
            q, kp, vp, tables, lens = paged_inputs(rng, B, Sq, lengths, dtype,
                                                   device)
            out = da.paged_attention(q, kp, vp, tables, lens)
            ref = da.paged_attention_reference(q, kp, vp, tables, lens)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                fail(f"{case} {dtype_name}: non-finite kernel output")
            err, scaled = compare(out, ref)
            live = [min(n + Sq, MB * BS) for n in lengths]
            nbytes = (2 * sum(live) * H * D * esize + 2 * q.numel() * esize
                      + tables.numel() * 4 + lens.numel() * 4)
            flops = 4.0 * sum(min(n + i + 1, MB * BS) for n in lengths
                              for i in range(Sq)) * H * D
            b_ms, b_by = bound(nbytes, flops, dtype_name)
            rows.append(dict(
                kernel="paged_attention", case=case, dtype=dtype_name, err=err,
                scaled=scaled,
                ms=median_ms(lambda: da.paged_attention(q, kp, vp, tables, lens),
                             reps, flush),
                plain_ms=median_ms(lambda: da.paged_attention_reference(
                    q, kp, vp, tables, lens), plain_reps, flush),
                bound_ms=b_ms, bound_by=b_by, library_ms=None))
        for case, B, Sq, T, pos in CONTIGUOUS_CASES:
            q, ck, cv = (torch.from_numpy(rng.standard_normal(
                shape, dtype=np.float32)).to(device, dtype)
                for shape in ((B, Sq, H, D), (B, T, H, D), (B, T, H, D)))
            out = da.decode_attention(q, ck, cv, pos)
            ref = da.decode_attention_reference(q, ck, cv, pos)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                fail(f"{case} {dtype_name}: non-finite kernel output")
            err, scaled = compare(out, ref)
            live = min(pos + Sq, T)
            nbytes = 2 * B * live * H * D * esize + 2 * q.numel() * esize
            flops = 4.0 * B * sum(min(pos + i + 1, T) for i in range(Sq)) * H * D
            b_ms, b_by = bound(nbytes, flops, dtype_name)
            # yardstick: one SDPA call on the same inputs, with the causal
            # mask where it hides a column; the port never calls it
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, ck, cv))
            qpos = pos + torch.arange(Sq, device=device)[:, None]
            keep = torch.arange(T, device=device)[None, :] <= qpos
            mask = None if bool(keep.all()) else keep
            lib = median_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask), reps, flush)
            rows.append(dict(
                kernel="decode_attention", case=case,
                dtype=dtype_name, err=err, scaled=scaled,
                ms=median_ms(lambda: da.decode_attention(q, ck, cv, pos),
                             reps, flush),
                plain_ms=median_ms(lambda: da.decode_attention_reference(
                    q, ck, cv, pos), plain_reps, flush),
                bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    for r in rows:
        tol = TOL[r["dtype"]]
        say(f"kernel {r['kernel']} case={r['case']} dtype={r['dtype']} "
            f"max_abs_err={r['err']:.3e} scaled_err={r['scaled']:.3e} "
            f"tol={tol:g} ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']}) library_ms="
            f"{'null' if r['library_ms'] is None else format(r['library_ms'], '.4f')}")
        if not r["scaled"] <= tol:
            fail(f"{r['kernel']} {r['case']} {r['dtype']}: error "
                 f"{r['scaled']:.3e} x max(1, |plain|) > {tol:g}")
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


def counted(label: str, kernel: str, run):
    """Zero every counter, ``run()``, read the counters at once.  Fails
    unless ``kernel`` launched and no plain version ran.  Returns
    (run's result, launches by kernel)."""
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da

    da.reset_counts()
    result = run()
    counts = {"paged_attention": da.paged_attention.launches,
              "decode_attention": da.decode_attention.launches}
    plain = (da.paged_attention_reference.calls
             + da.decode_attention_reference.calls)
    say(f"{label} launches: {json.dumps(counts)}; plain calls: {plain}")
    if counts[kernel] <= 0:
        fail(f"{label}: {kernel} never launched")
    if plain:
        fail(f"{label}: the plain attention ran {plain} times on the card's path")
    return result, counts


def phase_fp32(model, prompts, device, roomy_blocks: int, small_blocks: int):
    import deepspeed_tpu_torch as dst

    refs, gen_counts = counted("fp32 generate()", "decode_attention", lambda: [
        model.generate([p], NEW_TOKENS)[0, len(p):].tolist() for p in prompts])
    results = {"generate": dict(counts=gen_counts)}
    for label, blocks in (("roomy", roomy_blocks), ("preempting", small_blocks)):
        eng = dst.init_serving(model=model, device=device, config={"serving": dict(
            SERVE_CFG, num_blocks=blocks, dtype="float32")})
        t0 = time.perf_counter()
        futs, counts = counted(f"fp32 serve ({label})", "paged_attention",
                               lambda: serve(eng, prompts, NEW_TOKENS))
        wall = time.perf_counter() - t0
        ties = check_identity(model, prompts, futs, refs, f"fp32 {label}")
        pre = eng.sched.preemption_count
        say(f"fp32 serve ({label}, {blocks} blocks): {len(futs)} requests "
            f"token-identical to generate() except {ties} near-ties; "
            f"preemptions={pre}; {wall:.2f}s")
        if label == "preempting" and pre == 0:
            fail("the small arena did not force a preemption")
        eng.alloc.check_consistent()
        results[label] = dict(ties=ties, preemptions=pre, counts=counts)
        del eng
    return results


def first_decode_logits(model, prompt, use_kernel: bool):
    """Logits of one decode step after prefilling ``prompt`` through the
    paged step, with the kernel or its plain version as attention."""
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
    gpt_mod.paged_attention = (da.paged_attention if use_kernel
                               else da.paged_attention_reference)
    try:
        tok = None
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
            tok = int(gpt_mod.greedy_tokens(cfg, logits[0, n - 1]))
        wb, wo = alloc.write_map("r", len(prompt), 1)
        logits, _, _ = model.paged_step(
            torch.tensor([[tok]], device=dev),
            torch.tensor([len(prompt)], dtype=torch.int32, device=dev), kp, vp,
            table, torch.from_numpy(wb[None]).to(dev),
            torch.from_numpy(wo[None]).to(dev))
        return logits[0, 0]
    finally:
        gpt_mod.paged_attention = saved


def profile_decode(eng, prompts, card: str, steps: int = 8):
    """Device time by kernel over ``steps`` pure decode steps of a full
    batch (torch.profiler), and the device's busy share of the wall time
    (profiling adds host time, so the busy share reads low)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for p in prompts[:eng._config.max_batch_size]:
        eng.submit(p, max_new_tokens=steps + 4)
    while eng.sched.waiting or any(r.needs_prefill
                                   for r in eng.sched.active.values()):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
        return
    launches = sum(e.count for e in device)
    say(f"profile: {steps} decode steps x {eng._config.max_batch_size} rows, "
        f"device busy {total / wall_us:.1%} of {wall_us / 1e3:.2f} ms wall "
        f"({total / steps / 1e3:.3f} ms device, {launches / steps:.0f} device "
        f"ops per step) [{card}]")
    for name, t in rows[:6]:
        say(f"  {t / total:6.1%} {t / steps / 1e3:8.3f} ms/step  {name[:70]}")


def phase_bf16(model, prompts, device, blocks: int, card: str):
    import torch
    import deepspeed_tpu_torch as dst

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
    futs, counts = counted("bf16 serve", "paged_attention",
                           lambda: serve(eng, prompts, NEW_TOKENS, on_step))
    wall = time.perf_counter() - t0
    if not all(bool(f) for f in finite):
        fail("non-finite logits in bf16 serving")
    ntok = sum(len(f.token_ids) for f in futs)
    if any(len(f.token_ids) != NEW_TOKENS for f in futs):
        fail("a bf16 request did not produce all its tokens")
    ttft = [(f.request.first_token_at - f.request.arrival) * 1e3 for f in futs]
    say(f"bf16 serve: {len(futs)} requests, {ntok} tokens in {wall:.3f}s = "
        f"{ntok / wall:.1f} tokens/s; median TTFT {statistics.median(ttft):.1f} ms; "
        f"median decode step {statistics.median(decode_ms):.2f} ms "
        f"({len(decode_ms)} pure decode steps); {len(finite)} dispatches, "
        f"all logits finite [{card}]")
    profile_decode(eng, prompts, card)
    serve_model = eng.module
    del eng
    lk = first_decode_logits(serve_model, prompts[1], use_kernel=True)
    lp = first_decode_logits(serve_model, prompts[1], use_kernel=False)
    err = (lk - lp).abs().max().item()
    say(f"bf16 first decode step logits, kernel vs plain attention: max abs "
        f"diff {err:.4f} (tol {BF16_LOGIT_TOL}; |logits| max "
        f"{lp.abs().max().item():.3f})")
    if not err <= BF16_LOGIT_TOL:
        fail(f"bf16 logits differ by {err:.4f} > {BF16_LOGIT_TOL}")
    return dict(tokens_per_s=ntok / wall, ttft_ms=statistics.median(ttft),
                decode_step_ms=statistics.median(decode_ms), counts=counts)


# --------------------------------------------------------------------------- #
def main() -> int:
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

    # ---- 2. build ------------------------------------------------------------ #
    res = builder.build()
    builder.load_library()
    say(f"build: {res.path.name} in {res.seconds:.2f}s from "
        f"{[p.name for p in builder.sources()]}")
    for line in res.log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            say(f"  ptxas: {line.strip()}")
    say("kernels: paged_attention, decode_attention")

    # ---- 3. kernels against their plain versions ----------------------------- #
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=device)
    rows = kernel_cases(device, flush=scratch.zero_)
    del scratch

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

    # ---- report ------------------------------------------------------------------ #
    # each kernel's row: its case at the shape and dtype of the run that
    # launches it (the bf16 serve for the paged kernel, the fp32 generate()
    # for the contiguous one), and that run's launch count
    main_case = {"paged_attention": ("paged-decode", "bfloat16", bf16["counts"]),
                 "decode_attention": ("generate-decode", "float32",
                                      fp32["generate"]["counts"])}
    source = "deepspeed_tpu_torch/ops/cuda/csrc/decode_attention.cu"
    replaces = {"paged_attention": "deepspeed_tpu/ops/pallas/decode_attention.py:230",
                "decode_attention": "deepspeed_tpu/ops/pallas/decode_attention.py:78"}
    table = []
    for name, (case, dt, counts) in main_case.items():
        r = next(r for r in rows if r["kernel"] == name and r["case"] == case
                 and r["dtype"] == dt)
        table.append({"name": name, "route": "cuda", "source": source,
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
