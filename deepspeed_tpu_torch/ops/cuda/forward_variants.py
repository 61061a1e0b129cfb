"""Design variants of the cross-entropy forward and the block-sparse forward
and dQ, side by side on one card.

    python -m deepspeed_tpu_torch.ops.cuda.forward_variants [--parent DIR] [--only NAME ...]

As ``flash_variants`` does for flash dQ and dKV: each variant below is a
copy of the checkout with a few lines changed (in ``csrc/cross_entropy.cu``,
``csrc/block_sparse_attention.cu`` or their wrappers); the checkout's own
design runs as ``kept``, and ``--parent DIR`` adds another checkout (an
earlier commit, unpacked) as it is.  Every copy is built first, all at once;
then each is timed in its own process, in the order kept, variants, parent,
kept, so a drift of the card over the run shows between the two ``kept``
runs.

Each run prints one JSON line: for each case of CE_CASES and SPARSE_CASES
(bf16) the median time of the forward by CUDA events after a ``zero_()``
flush of 64 MB and its error against the plain version (cross-entropy:
|err| / max(1, |plain|) of lse, against fp32 products; block-sparse: max
|err| / max |plain| of o, against the kernel's rounding), so a variant that
computes something else shows as such; for each case of DQ_CASES the same
of block-sparse dQ (max |err| / max |plain| of dq against the plain
version with the kernel's rounding, on the plain forward's lse).
"""

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

from deepspeed_tpu_torch.ops.cuda.flash_variants import REPO, TIMEOUT_S, copy_checkout, run_in

CSRC = "deepspeed_tpu_torch/ops/cuda/csrc/"
CE = CSRC + "cross_entropy.cu"
CE_PY = "deepspeed_tpu_torch/ops/cuda/cross_entropy.py"
SPARSE = CSRC + "block_sparse_attention.cu"
SPARSE_PY = "deepspeed_tpu_torch/ops/cuda/block_sparse_attention.py"

# the bf16 forward at 128 vocab columns a tile (m64n128k16, 64 accumulators
# a consumer thread) in place of 256
_M64N128 = r'''
#define CE_ACC8(i)                                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[kWgAcc], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : CE_ACC8(0), CE_ACC8(8), CE_ACC8(16), CE_ACC8(24), CE_ACC8(32), CE_ACC8(40), CE_ACC8(48),
        CE_ACC8(56)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
#undef CE_ACC8
'''
CE_128_COLS = [
    (CE, "constexpr int kWgCols = 256;             // vocab columns of a tile (m64n256k16)",
     "constexpr int kWgCols = 128;"),
    (CE, "// The two consumer warpgroups' barrier",
     _M64N128 + "// The two consumer warpgroups' barrier"),
    (CE, "        wgmma_m64n256k16(d, dx + 2 * kk, dh + 2 * kk, ks > 0 || kk > 0);",
     "        wgmma_m64n128k16(d, dx + 2 * kk, dh + 2 * kk, ks > 0 || kk > 0);"),
    (CE_PY, "FWD_COLS = {torch.bfloat16: 256, torch.float32: 128}",
     "FWD_COLS = {torch.bfloat16: 128, torch.float32: 128}"),
]
# name: [(file, line as it is, line in the variant), ...]
VARIANTS = {
    # cross-entropy forward: 128-column tiles; a ring of 3 stages, not 4;
    # fwd_grid with no per-block cost (more, shorter splits in waves)
    "ce-128-cols": CE_128_COLS,
    "ce-3-stages": [(CE, "constexpr int kWgStages = 4;             // ring stages of x and head "
                         "slices", "constexpr int kWgStages = 3;")],
    "ce-no-block-cost": [(CE_PY, "FWD_BLOCK_COST = 0.5", "FWD_BLOCK_COST = 0.0")],
    # a diagnostic, not a design (its lse is wrong): the products and the
    # ring alone, the softmax on the accumulators left out, so the time it
    # saves is what the softmax costs where it does not overlap the products
    "ce-products-only": [(CE, "    const int col0 = t * kWgCols;\n",
                          "    const int col0 = t * kWgCols;\n    if (col0 >= 0) continue;\n")],
    # block-sparse forward: a ring of 3 key / value stages, not 2; 2 blocks
    # per SM (up to 255 registers), not 3; the tasks in (head, query block)
    # order, not longest first
    "sparse-3-stages": [(SPARSE, "constexpr int kFwdStages = 2;           // key / value buffers "
                                 "in the ring", "constexpr int kFwdStages = 3;")],
    "sparse-2-blocks": [(SPARSE, "template <typename T> constexpr int kFwdBlocksPerSm = 3;",
                         "template <typename T> constexpr int kFwdBlocksPerSm = 2;")],
    # block-sparse dQ (bf16 on wgmma): a ring of 3 key / value stages, not
    # 2; 2 blocks per SM (up to 255 registers), not 3; the bf16 kernel on the
    # fp32 kernel's mma.sync tile body (ldmatrix fragments, 32-key score
    # tiles: the design before wgmma).  "sparse-rows-in-order" below changes
    # dQ's order too: dQ walks the forward's work list
    "sparse-dq-3-stages": [
        (SPARSE, "  constexpr int TE = kTileElems<bf16>, L = Tr<bf16>::kLd, NS = kStages, "
                 "SW = kSwTileElems;",
         "  constexpr int TE = kTileElems<bf16>, L = Tr<bf16>::kLd, NS = 3, SW = kSwTileElems;"),
        (SPARSE, "  return 1024 + sizeof(bf16) * (2 * kStages * kSwTileElems + 2 * "
                 "kTileElems<bf16>) +",
         "  return 1024 + sizeof(bf16) * (2 * 3 * kSwTileElems + 2 * kTileElems<bf16>) +")],
    "sparse-dq-2-blocks": [(SPARSE, "template <typename T> constexpr int kDqBlocksPerSm = 3;",
                            "template <typename T> constexpr int kDqBlocksPerSm = 2;")],
    "sparse-dq-mma-sync": [(SPARSE, "template <typename T> constexpr bool kDqWgmma = "
                                    "sizeof(T) == 2;",
                            "template <typename T> constexpr bool kDqWgmma = false;")],
    "sparse-rows-in-order": [(SPARSE_PY, "    order = sorted(range(len(rows)), key=lambda i: "
                                         "-rows[i][3])\n    tasks = np.asarray([rows[i] for i in "
                                         "order], np.int32).reshape(-1, len(FWD_TASK_FIELDS))",
                              "    order = list(range(len(rows)))\n    tasks = np.asarray("
                              "[rows[i] for i in order], np.int32).reshape(-1, "
                              "len(FWD_TASK_FIELDS))")],
}
# cross-entropy (N, E) at V 50304, vocab 50257: the seq-512 step's and the
# sparse step's; block-sparse (B, S, H, sparse_attention block, causal)
CE_CASES = {"ce-n4096": (4096, 768), "ce-n8192": (8192, 768)}
SPARSE_CASES = {
    "sparse-gpt2-s4096-fixed": (2, 4096, 12, {"mode": "fixed", "block": 64,
                                              "num_local_blocks": 4, "num_global_blocks": 1,
                                              "attention": "unidirectional"}, True),
    "sparse-bigbird-s2048": (2, 2048, 12, {"mode": "bigbird", "block": 64,
                                           "num_random_blocks": 2, "num_sliding_window_blocks": 3,
                                           "num_global_blocks": 1, "attention": "bidirectional",
                                           "seed": 3}, False),
}
DQ_CASES = {"dq-" + name.split("-", 1)[1]: case for name, case in SPARSE_CASES.items()}

# Run inside a checkout (its root first on sys.path): build, time, compare.
TIMER = r"""
import inspect, json, statistics, sys
import numpy as np
import torch
from deepspeed_tpu_torch.ops.cuda import builder
from deepspeed_tpu_torch.ops.cuda import block_sparse_attention as tbs
from deepspeed_tpu_torch.ops.cuda import cross_entropy as tce
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import sparsity_config_from_dict

ce_cases, sparse_cases, dq_cases = (json.loads(a) for a in sys.argv[1:4])
builder.build()
dev = torch.device("cuda", 0)
flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)

def median_ms(fn, reps=30):
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    torch.cuda._sleep(100_000_000)
    for a, b in ev:
        flush.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)

times = {}
for name, (N, E) in ce_cases.items():
    rng = np.random.default_rng(4321)
    x = torch.from_numpy(rng.standard_normal((N, E), dtype=np.float32)).to(dev).bfloat16()
    head = (torch.from_numpy(rng.standard_normal((50304, E), dtype=np.float32)) * 0.15).to(
        dev).bfloat16()
    labels = torch.from_numpy(rng.integers(0, 50257, N).astype(np.int32)).to(dev)
    _, lse = tce.ce_forward(x, head, labels, 50257)
    _, rlse = tce.ce_forward_reference(x, head, labels, 50257, fp32_products=True)
    err = ((lse - rlse).abs() / rlse.abs().clamp(min=1.0)).max().item()
    times[name] = {"ms": median_ms(lambda: tce.ce_forward(x, head, labels, 50257)),
                   "err": err}
    del x, head, lse, rlse
for name, (B, S, H, block, causal) in sparse_cases.items():
    layout = sparsity_config_from_dict(block, num_heads=H).make_layout(S)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2025)
    q = (torch.randn((B, S, H, 64), generator=gen, device=dev) * 3.0).bfloat16()
    k, v = (torch.randn((B, S, H, 64), generator=gen, device=dev).bfloat16() for _ in range(2))
    row_lut, row_cnt, _, _ = tbs.device_luts(layout, dev)
    kw = {"work": tbs.fwd_work(layout, causal, dev)} if hasattr(tbs, "fwd_work") else {}
    args = (q, k, v, row_lut, row_cnt, causal, 0.125)
    o, _ = tbs.block_sparse_forward(*args, **kw)
    ro, _ = tbs.block_sparse_forward_reference(*args, kernel_rounding=True)
    err = ((o.float() - ro.float()).abs().max() / ro.float().abs().max()).item()
    times[name] = {"ms": median_ms(lambda: tbs.block_sparse_forward(*args, **kw)), "err": err}
# dQ on the plain forward's lse; an earlier tree's dQ may walk its row LUT
# (no work=)
dq_work = "work" in inspect.signature(tbs.block_sparse_backward_dq).parameters
for name, (B, S, H, block, causal) in dq_cases.items():
    layout = sparsity_config_from_dict(block, num_heads=H).make_layout(S)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2025)
    q = (torch.randn((B, S, H, 64), generator=gen, device=dev) * 3.0).bfloat16()
    k, v, do = (torch.randn((B, S, H, 64), generator=gen, device=dev).bfloat16()
                for _ in range(3))
    row_lut, row_cnt, _, _ = tbs.device_luts(layout, dev)
    ro, rlse = tbs.block_sparse_forward_reference(q, k, v, row_lut, row_cnt, causal, 0.125,
                                                  kernel_rounding=True)
    delta = (ro.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    kw = {"work": tbs.fwd_work(layout, causal, dev)} if dq_work else {}
    args = (q, k, v, do, rlse, delta, row_lut, row_cnt, causal, 0.125)
    dq = tbs.block_sparse_backward_dq(*args, **kw)
    rdq = tbs.block_sparse_backward_dq_reference(*args, kernel_rounding=True)
    err = ((dq.float() - rdq.float()).abs().max() / rdq.float().abs().max()).item()
    times[name] = {"ms": median_ms(lambda: tbs.block_sparse_backward_dq(*args, **kw)),
                   "err": err}
print(json.dumps({"card": torch.cuda.get_device_name(0), "times": times}))
"""


def apply(root: Path, changes) -> None:
    for source, old, new in changes:
        path = root / source
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"forward_variants: the line to change is not in {source} once: "
                             f"{old!r}")
        path.write_text(text.replace(old, new))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="another checkout to time as it is")
    ap.add_argument("--only", nargs="*", default=None, help="variant names (default: all)")
    opts = ap.parse_args()
    names = list(VARIANTS) if opts.only is None else opts.only
    with tempfile.TemporaryDirectory(prefix="forward_variants_") as tmp:
        roots = {"kept": Path(tmp, "kept")}
        copy_checkout(REPO, roots["kept"])
        for name in names:
            roots[name] = Path(tmp, name)
            copy_checkout(REPO, roots[name])
            apply(roots[name], VARIANTS[name])
        if opts.parent is not None:
            roots["parent"] = Path(tmp, "parent")
            copy_checkout(opts.parent.resolve(), roots["parent"])
        build = "from deepspeed_tpu_torch.ops.cuda import builder\nbuilder.build()"
        procs = {name: subprocess.Popen(
            [sys.executable, "-c", f"import sys; sys.path.insert(0, {str(root)!r})\n{build}"],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, root in roots.items()}
        built = set()
        for name, proc in procs.items():
            out, _ = proc.communicate(timeout=TIMEOUT_S)
            if proc.returncode == 0:
                built.add(name)
            else:
                print(f"forward_variants: {name}: build failed\n{out[-4000:]}", flush=True)
        ok = built == set(roots)
        order = ["kept", *names, *(["parent"] if "parent" in roots else []), "kept"]
        for name in (n for n in order if n in built):
            res = run_in(roots[name], TIMER, json.dumps(CE_CASES), json.dumps(SPARSE_CASES),
                         json.dumps(DQ_CASES))
            if res.returncode != 0:
                print(f"forward_variants: {name}: exit {res.returncode}\n{res.stdout[-2000:]}"
                      f"{res.stderr[-4000:]}", flush=True)
                ok = False
                continue
            print(json.dumps({"variant": name, **json.loads(res.stdout.splitlines()[-1])}),
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
