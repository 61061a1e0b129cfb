"""Design variants of the flash dQ and dKV kernels, side by side on one card.

    python -m deepspeed_tpu_torch.ops.cuda.flash_variants [--parent DIR]

For each variant below, copies the checkout into a temporary directory and
changes the tile shape or the blocks per SM that ``__launch_bounds__`` asks
for in ``csrc/flash_attention.cu`` there; the checkout's own design runs as
``kept``.  ``--parent DIR`` adds another checkout as it is (an earlier
commit, unpacked), timed through the same public wrappers.  Every copy is
built first, all at once; then each is timed in its own process, one after
another, in the order kept, variants, parent, kept, so that a drift of the
card over the run shows as a difference between the two ``kept`` runs.

Each run prints one JSON line: the ptxas report of the dQ and dKV kernels
(registers, spills), their blocks per SM and shared memory by CUDA's
occupancy query, and for each case of CASES (bf16) the median time of dQ
and of dKV by CUDA events after a ``zero_()`` flush of 64 MB, with each
output's max |err| / max |plain| against the plain version (a variant that
disagrees is reported, not timed as a design).
"""

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[3]
SOURCE = "deepspeed_tpu_torch/ops/cuda/csrc/flash_attention.cu"
TIMEOUT_S = 600

# name: [(line as it is, line in the variant), ...]
DQ_WARPS = "constexpr int kDqWarps = 4;"
DQ_BLOCKS = "constexpr int kDqBlocksPerSm = 3;"
DQ_COLS = "constexpr int kDqCols = 32;"
DKV_WARPS = "constexpr int kDkvWarps = 4;"
DKV_BLOCKS = "constexpr int kDkvBlocksPerSm = 2;"
DKV_COLS = "  return D == 64 ? 64 : 32;"          # dKV's query columns by head_dim
DKV_32_COLS = [(DKV_COLS, "  return 32;")]
DKV_3_BLOCKS = [(DKV_BLOCKS, "constexpr int kDkvBlocksPerSm = 3;")]
# V's fragments read from shared memory for each score tile, not held in
# registers (16 registers fewer at head_dim 64; head_dim 128 reads both K
# and V so already)
DKV_V_FROM_SMEM = [
    ("  DkvRows<T, D> kf, vf;", "  DkvRows<T, D> kf;"),
    ("      vf.load(sv + rg * 16 * L);\n", ""),
    ("      vf.product_nt(dp, do_cols);",
     "      SharedRows<T, D> v_rows;\n      v_rows.load(sv + rg * 16 * L);\n"
     "      v_rows.product_nt(dp, do_cols);")]
VARIANTS = {
    # blocks per SM of GPT-2's dQ path (registers a thread: 2 -> 255, 3 ->
    # 168, 4 -> 128)
    "dq-2-blocks": [(DQ_BLOCKS, "constexpr int kDqBlocksPerSm = 2;")],
    "dq-4-blocks": [(DQ_BLOCKS, "constexpr int kDqBlocksPerSm = 4;")],
    # a whole 64-key score tile at a time, not two slices of 32
    "dq-64-cols": [(DQ_COLS, "constexpr int kDqCols = 64;")],
    # 128 query rows (8 warps) a block, one block an SM
    "dq-128-rows": [(DQ_WARPS, "constexpr int kDqWarps = 8;"),
                    (DQ_BLOCKS, "constexpr int kDqBlocksPerSm = 1;")],
    # dKV: three blocks an SM (168 registers), 32-query slices, V read from
    # shared memory, 128 key rows (8 warps) at one block an SM
    "dkv-3-blocks": DKV_3_BLOCKS,
    "dkv-32-cols": DKV_32_COLS,
    "dkv-32-cols-3-blocks": DKV_32_COLS + DKV_3_BLOCKS,
    "dkv-v-from-smem-32-cols-3-blocks": DKV_V_FROM_SMEM + DKV_32_COLS + DKV_3_BLOCKS,
    "dkv-128-rows": [(DKV_WARPS, "constexpr int kDkvWarps = 8;"),
                     (DKV_BLOCKS, "constexpr int kDkvBlocksPerSm = 1;")],
    # three buffers for the streamed tiles (copies two tiles ahead, not one)
    "three-stages": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    # the tile index varying fastest in the order blocks are dispatched (each
    # head's tiles together), not slowest (every head's longest walk first)
    "dq-tiles-innermost": [(
        "  const int h = blockIdx.x, b = blockIdx.y, hk = h / p.group;\n"
        "  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;",
        "  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);\n"
        "  const int h = lin / gridDim.z % gridDim.x, b = lin / gridDim.z / gridDim.x, "
        "hk = h / p.group;\n"
        "  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;"),
        ("  const int qt = gridDim.z - 1 - blockIdx.z;\n",
         "  const int qt = gridDim.z - 1 - (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * "
         "blockIdx.z)) % gridDim.z;\n")],
    "dkv-tiles-innermost": [(
        "  const int kt = blockIdx.z, hk = blockIdx.x, b = blockIdx.y;",
        "  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);\n"
        "  const int kt = lin % gridDim.z, hk = lin / gridDim.z % gridDim.x, "
        "b = lin / gridDim.z / gridDim.x;")],
}
# (B, S, H, Hkv, causal): the seq-512 training step's shape and the dense
# seq-4096 step's
CASES = {"gpt2-train": (8, 512, 12, 12, True), "gpt2-s4096": (2, 4096, 12, 12, True)}

# Run inside a checkout (its root first on sys.path): build, report, time.
TIMER = r"""
import json, statistics, sys
import torch
from deepspeed_tpu_torch.ops.cuda import builder
from deepspeed_tpu_torch.ops.cuda import flash_attention as tfa

cases = json.loads(sys.argv[1])
log = builder.build().log
ptxas, entry = {}, None
for line in log.splitlines():
    if "Compiling entry" in line:
        entry = next((k for k in ("flash_dq_kernel", "flash_dkv_kernel") if k in line), None)
        if entry is not None:
            key = entry + ("[bf16" if "bfloat16" in line else "[fp32")
            key += (",extras]" if "Lb1E" in line else "]")
    elif entry is not None and ("registers" in line or "spill" in line):
        ptxas.setdefault(key, []).append(line.split(":", 1)[-1].strip())
occupancy = {}
if hasattr(tfa, "kernel_occupancy"):
    for kernel in ("dq", "dkv"):
        occupancy[kernel] = tfa.kernel_occupancy(kernel, torch.bfloat16)
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
for name, (B, S, H, Hkv, causal) in cases.items():
    gen = torch.Generator(device=dev)
    gen.manual_seed(2024)
    q = (torch.randn((B, S, H, 64), generator=gen, device=dev) * 3.0).bfloat16()
    k, v = (torch.randn((B, S, Hkv, 64), generator=gen, device=dev).bfloat16() for _ in range(2))
    do = torch.randn((B, S, H, 64), generator=gen, device=dev).bfloat16()
    o, lse = tfa.flash_forward(q, k, v, None, None, causal, 0.125)
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, None, None, causal, 0.125)
    got = [tfa.flash_backward_dq(*args), *tfa.flash_backward_dkv(*args)]
    want = [tfa.flash_backward_dq_reference(*args), *tfa.flash_backward_dkv_reference(*args)]
    err = max(((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
              for g, w in zip(got, want))
    del got, want
    times[name] = {"dq_ms": median_ms(lambda: tfa.flash_backward_dq(*args)),
                   "dkv_ms": median_ms(lambda: tfa.flash_backward_dkv(*args)),
                   "max_err": err}
    times[name]["pair_ms"] = times[name]["dq_ms"] + times[name]["dkv_ms"]
print(json.dumps({"ptxas": ptxas, "occupancy": occupancy, "times": times}))
"""


def copy_checkout(src: Path, dst: Path) -> None:
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        ".git", "build_torch", "chip_trees", "__pycache__", ".pytest_cache", "*.pyc"))


def apply(root: Path, changes) -> None:
    path = root / SOURCE
    text = path.read_text()
    for old, new in changes:
        if text.count(old) != 1:
            raise SystemExit(f"flash_variants: the line to change is not in {SOURCE} once: "
                             f"{old!r}")
        text = text.replace(old, new)
    path.write_text(text)


def run_in(root: Path, code: str, *args: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", f"import sys; sys.path.insert(0, {str(root)!r})"
                           f"\n{code}", *args], cwd=root, capture_output=True, text=True,
                          timeout=TIMEOUT_S)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="another checkout to time as it is")
    ap.add_argument("--only", nargs="*", default=None, help="variant names (default: all)")
    opts = ap.parse_args()
    names = list(VARIANTS) if opts.only is None else opts.only
    with tempfile.TemporaryDirectory(prefix="flash_variants_") as tmp:
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
                print(f"flash_variants: {name}: build failed\n{out[-4000:]}", flush=True)
        ok = built == set(roots)
        order = ["kept", *names, *(["parent"] if "parent" in roots else []), "kept"]
        for name in (n for n in order if n in built):
            res = run_in(roots[name], TIMER, json.dumps(CASES))
            if res.returncode != 0:
                print(f"flash_variants: {name}: exit {res.returncode}\n{res.stdout[-2000:]}"
                      f"{res.stderr[-4000:]}", flush=True)
                ok = False
                continue
            print(json.dumps({"variant": name, **json.loads(res.stdout.splitlines()[-1])}),
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
