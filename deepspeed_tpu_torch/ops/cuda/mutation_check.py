"""Mutation check of the redesigned kernels, on a machine with a card.

    python -m deepspeed_tpu_torch.ops.cuda.mutation_check

For each mutation below, copies the checkout into a temporary directory,
breaks one kernel source (or the plan its wrapper makes) there in one known
way, and runs the ``cuda``-marked tests of that kernel's test file against
the copy's own build (the copies build and run side by side): the
decode-attention kernels (``csrc/decode_attention.cu``, with the lane
layouts of head_dim 96 and 256), the flash forward (and its one-buffer
path of fp32 at head_dim 256),
dQ and dKV (``csrc/flash_attention.cu``; at head_dim 128 dKV reads K's rows
from shared memory through ``csrc/attention_tile.cuh``; at 256 dKV's column
halves and fp32 dQ's one K/V buffer, seen by the ``cuda`` tests of
``tests/test_torch_wide_head_training.py``), the cross-entropy
forward and backward, cluster and wide paths (``csrc/cross_entropy.cu``),
the block-sparse forward, dQ and dKV
(``csrc/block_sparse_attention.cu``) and the fused AdamW
(``csrc/fused_optim.cu`` and its plan in ``fused_optim.py``).  The
unmutated checkout runs every one of those test files the same way and
must pass every test; each mutation must fail at least one test in each
dtype its kernel is compiled for (bf16 and fp32; AdamW fp32 only; the
cross-entropy forward's and block-sparse dQ's wgmma kernels bf16 only).
Prints one line per run with the tests that failed, then a JSON summary; exits
non-zero if the checkout fails a test or a mutation goes unseen in a
dtype.
"""

import json
import shutil
import subprocess
import sys
import tempfile
import xml.etree.ElementTree as ET
from pathlib import Path

REPO = Path(__file__).resolve().parents[3]
CSRC = "deepspeed_tpu_torch/ops/cuda/csrc/"
DECODE = (CSRC + "decode_attention.cu", "tests/test_torch_decode_attention.py")
FLASH = (CSRC + "flash_attention.cu", "tests/test_torch_flash_attention.py")
TILE = (CSRC + "attention_tile.cuh", "tests/test_torch_flash_attention.py")
WIDE = (CSRC + "flash_attention.cu", "tests/test_torch_wide_head_training.py")
CROSS_ENTROPY = (CSRC + "cross_entropy.cu", "tests/test_torch_cross_entropy.py")
SPARSE = (CSRC + "block_sparse_attention.cu", "tests/test_torch_sparse_attention.py")
ADAM = (CSRC + "fused_optim.cu", "tests/test_torch_fused_optim.py")
ADAM_PLAN = ("deepspeed_tpu_torch/ops/cuda/fused_optim.py", ADAM[1])
TIMEOUT_S = 900
# the dtypes a mutation must be seen in, by test file: every kernel but
# AdamW is compiled for both; by mutation where it breaks one dtype's kernel
DTYPES = {ADAM[1]: ("float32",)}
MUTATION_DTYPES = {"ce-fwd-drop-last-k-slice": ("bfloat16",),
                   "decode-d256-fp32-part-at-block-start": ("float32",),
                   "flash-fwd-one-buffer-tile-not-reloaded": ("float32",),
                   "flash-dq-d256-one-buffer-tile-not-reloaded": ("float32",),
                   "flash-dkv-d128-k-rows-half-deep": ("bfloat16",),
                   "sparse-dq-wgmma-tiles-unswizzled": ("bfloat16",),
                   "sparse-dq-wgmma-k-step-of-k-major": ("bfloat16",)}
BOTH = ("float32", "bfloat16")

# name: ((source, test file), what it breaks, the line as it is, the line broken);
# a tuple of lines as they are and one of the lines broken change each pair
MUTATIONS = {
    "drop-last-block-of-warp-0": (
        DECODE, "decode path: warp 0 skips the last block of its range",
        "  const int count = warp < n_blocks ? (n_blocks - 1 - warp) / kDecodeWarps + 1 : 0;",
        "  const int count = (warp < n_blocks ? (n_blocks - 1 - warp) / kDecodeWarps + 1 : 0)"
        " - (warp == 0 ? 1 : 0);"),
    "skip-table-end-tile": (
        DECODE, "prefill path: the key tile that crosses the end of the table row (or of the "
        "contiguous cache) is not visited",
        "  const int n_kv = last_col / kTile + 1;",
        "  const int n_kv = last_col / kTile + (last_col == n_cols - 1 && n_cols % kTile ? 0 : 1);"),
    "merge-warps-alpha-1": (
        DECODE, "decode path: the warps' states are merged without rescaling to the row's max",
        "      const float f = exp2_approx(__fsub_rn(s_m[w][r], m));",
        "      const float f = 1.f;"),
    "alibi-sign-flipped": (
        DECODE, "both paths: the ALiBi term is added as slope * (query - key), its sign flipped",
        "  return fmaf(slope2, (float)(key - qpos), __fmul_rn(dot, scale_log2));",
        "  return fmaf(slope2, (float)(qpos - key), __fmul_rn(dot, scale_log2));"),
    "kv-head-off-by-one-group": (
        DECODE, "both kernels: query head h reads kv head h / G + 1 (mod Hkv), the next "
        "group's",
        "  return h / (a.h_count / a.hkv_count);",
        "  return (h / (a.h_count / a.hkv_count) + 1) % a.hkv_count;"),
    "decode-d96-lanes-not-a-power-of-two": (
        DECODE, "decode path at head_dim 96: a key row's 12 (24) chunks over 12 (24) lanes, "
        "so the xor reductions mix two keys' lanes",
        "  static constexpr int kPerKey = pow2_ceil(kChunks / kWide);   "
        "// 8, 16, 16, 32 | 16, 32, 32, 32",
        "  static constexpr int kPerKey = kChunks / kWide;"),
    "decode-d256-fp32-part-at-block-start": (
        DECODE, "decode path, fp32 at head_dim 256: a block's second part of 8 keys is masked "
        "and ALiBi-scored as if it were its first",
        "  const int first = n * kBlock + part * L::kPartKeys;   // the part's first key",
        "  const int first = n * kBlock;"),
    "flash-fwd-one-buffer-tile-not-reloaded": (
        FLASH, "flash forward, fp32 at head_dim 256 (one K/V buffer): the key tiles after the "
        "first are never loaded",
        "      if (NB == 1 && j > 0) {         "
        "// the barrier ending the last tile freed the buffer",
        "      if (NB == 1 && j < 0) {"),
    "flash-lse-in-log2-units": (
        FLASH, "flash forward: lse is saved in log2 units, not converted back by ln 2",
        "      if (row < p.S) lse[row] = __fmul_rn(__fadd_rn(m[r], log2f(l[r])), kLn2);",
        "      if (row < p.S) lse[row] = __fadd_rn(m[r], log2f(l[r]));"),
    "flash-diagonal-unmasked": (
        FLASH, "flash forward: the causal diagonal tile is not masked (only a tile that "
        "crosses S is)",
        "          (p.causal && col0 + kTile - 1 > wrow0) || col0 + kTile > p.S || wrow0 + 16 > p.S;",
        "          col0 + kTile > p.S || wrow0 + 16 > p.S;"),
    "flash-dq-diagonal-unmasked": (
        FLASH, "flash dQ: the causal diagonal tile is not masked (only a tile that crosses S "
        "is)",
        "      const bool diagonal = p.causal && col0 + kDqCols - 1 > wrow0;",
        "      const bool diagonal = false;"),
    "flash-dq-lse-in-natural-units": (
        FLASH, "flash dQ: lse is not converted to log2 units before the exponential",
        "    lse2[r] = row < p.S ? __fmul_rn(p.lse_in[stat0 + row], kLog2e) : 0.f;",
        "    lse2[r] = row < p.S ? p.lse_in[stat0 + row] : 0.f;"),
    "flash-dkv-skip-last-group-head": (
        FLASH, "flash dKV: the last query head of a GQA group (of more than one) is left out "
        "of dK and dV",
        "  const int total = p.group * per_head;",
        "  const int total = (p.group > 1 ? p.group - 1 : 1) * per_head;"),
    "flash-dkv-drop-ragged-query-tile": (
        FLASH, "flash dKV: the ragged last query tile is dropped by every key block but the "
        "last",
        "  const int n_q = cdiv(p.S, kTile), first = p.causal ? key0 / kTile : 0, "
        "per_head = n_q - first;",
        "  const int n_q = max(p.S / kTile, key0 / kTile + 1), first = p.causal ? key0 / kTile "
        ": 0, per_head = n_q - first;"),
    "flash-dkv-d128-drop-second-column-half": (
        FLASH, "flash dKV at head_dim 128: each query tile's second half of columns adds "
        "nothing to dK and dV",
        "    for (int c = 0; c < kTile; c += kDkvCols) {",
        "    for (int c = 0; c < (D == 64 ? kTile : kTile - kDkvCols); c += kDkvCols) {"),
    "flash-dkv-d128-k-rows-half-deep": (
        TILE, "flash dKV at head_dim 128 (bf16): the scores read K's rows from shared memory "
        "only 64 deep",
        "    for (int kk = 0; kk < D / 16; ++kk) {",
        "    for (int kk = 0; kk < D / 32; ++kk) {"),
    "flash-dkv-d256-dv-second-half-reads-first-half": (
        WIDE, "flash dKV at head_dim 256: the warp of a pair that owns dV's second column "
        "half sums p^T . do over do's first half",
        "      pv_tile<D>(dv, s, do_cols + half * DH);           // dv += p^T . do, the warp's "
        "columns",
        "      pv_tile<D>(dv, s, do_cols);"),
    "flash-dq-d256-one-buffer-tile-not-reloaded": (
        WIDE, "flash dQ, fp32 at head_dim 256 (one K/V buffer): the key tiles after the first "
        "are never loaded",
        "      if (j > 0) {   // one K and V buffer: refilled once every warp is done with tile "
        "j - 1",
        "      if (j < 0) {"),
    "ce-wide-dx-wrong-chunk-offset": (
        CROSS_ENTROPY, "cross-entropy wide backward: dx's product reads chunk c's head rows "
        "from half its offset",
        "  const T* head_rows = static_cast<const T*>(a.head) + (long long)a.v0 * a.e;",
        "  const T* head_rows = static_cast<const T*>(a.head) + (long long)(a.v0 / 2) * a.e;"),
    "ce-drop-last-cluster-block": (
        CROSS_ENTROPY, "cross-entropy backward: the last block's slice of E is left out of "
        "every summed score",
        "      if (cc >= C) break;",
        "      if (cc >= C - 1) break;"),
    "ce-skip-last-vocab-tile": (
        CROSS_ENTROPY, "cross-entropy backward: dx never streams the last vocab tile",
        "  const int n_str = cdiv(str_n, B::kStream);                    // streamed tiles",
        "  const int n_str = cdiv(str_n, B::kStream) - (kDhead ? 0 : 1);   // streamed tiles"),
    "ce-fwd-drop-last-k-slice": (
        CROSS_ENTROPY, "cross-entropy forward (bf16, wgmma): the last 64-column slice of E is "
        "never loaded or multiplied",
        "  const int n_k = cdiv(a.e, kWgK);       // the last slice's columns past E are TMA's "
        "zeros",
        "  const int n_k = cdiv(a.e, kWgK) - 1;   // the last slice's columns past E are TMA's "
        "zeros"),
    "ce-fwd-merge-skips-split-0": (
        CROSS_ENTROPY, "cross-entropy forward: the last block of a row tile leaves split 0's sum "
        "and label logit out of the merge",
        "    for (int j = 0; j < splits; ++j) {   // in split order, whatever the order of arrival",
        "    for (int j = 1; j < splits; ++j) {   // in split order, whatever the order of arrival"),
    "sparse-fwd-diagonal-unmasked": (
        SPARSE, "block-sparse forward: the causal diagonal block is not masked",
        "    if (diagonal && it == n - 1) mask_future_keys(s, 0);",
        "    if (false) mask_future_keys(s, 0);"),
    "sparse-fwd-empty-row-lse-by-log2-formula": (
        SPARSE, "block-sparse forward: an empty row's lse goes through the log2 formula (-inf), "
        "not JAX's -1e30",
        "      lse[wrow0 + g + 8 * r] = n > 0 ? row_lse : kNegInf;   // an empty row: JAX's -1e30",
        "      lse[wrow0 + g + 8 * r] = row_lse;"),
    # dQ runs on two kernels, bf16 on wgmma and fp32 on the FMA tile body:
    # a mutation of dQ's semantics breaks both (one line of each, or of a
    # helper they share)
    "sparse-dq-diagonal-unmasked": (
        SPARSE, "block-sparse dQ: the causal diagonal block is not masked (the fp32 body "
        "still skips a warp's columns past its last row)",
        ("      if (diag && c + kDqCols - 1 > warp * 16) mask_future_keys(s, c);",
         "    if (it == n - 1 && diagonal) mask_future_keys(s, 0);"),
        ("      if (false) mask_future_keys(s, c);", "    if (false) mask_future_keys(s, 0);")),
    "sparse-dq-lse-in-natural-units": (
        SPARSE, "block-sparse dQ: lse is not converted to log2 units before the exponential",
        "    lse2[r] = __fmul_rn(p.lse_in[stat + 8 * r], kLog2e);",
        "    lse2[r] = p.lse_in[stat + 8 * r];"),
    "sparse-dq-drop-last-entry": (
        SPARSE, "block-sparse dQ: each task's last key block is staged but adds nothing",
        ("    const bool diag = diagonal && it == n - 1;",
         "    if (it == n - 1 && diagonal) mask_future_keys(s, 0);"),
        ("    if (it == n - 1) continue;   // dropped\n    const bool diag = false;",
         "    if (it == n - 1) continue;   // dropped, wgmma")),
    "sparse-dq-wgmma-tiles-unswizzled": (
        SPARSE, "block-sparse dQ (bf16, wgmma): K and V land unswizzled under the 128-byte-swizzle "
        "descriptors",
        "    copy16_async(dst + r * kD + ((ch ^ (r & 7)) << 3), src + (row0 + r) * ss + "
        "(ch << 3), true);",
        "    copy16_async(dst + r * kD + (ch << 3), src + (row0 + r) * ss + (ch << 3), true);"),
    "sparse-dq-wgmma-k-step-of-k-major": (
        SPARSE, "block-sparse dQ (bf16, wgmma): dq += ds . K steps through K as a K-major "
        "operand (32 bytes a k step), not an MN-major one (2048)",
        "      wgmma_m64n64k16_rs<1>(dq, a[kk], desc_k + 128 * kk, 1);",
        "      wgmma_m64n64k16_rs<1>(dq, a[kk], desc_k + 2 * kk, 1);"),
    "sparse-dkv-sum-drops-split-0": (
        SPARSE, "block-sparse dKV: the last split to arrive leaves split 0's partial out of "
        "its column's sum",
        "  for (int sp = 0; sp < n_split; ++sp) {   // in split order, whatever the order of "
        "arrival",
        "  for (int sp = 1; sp < n_split; ++sp) {   // in split order, whatever the order of "
        "arrival"),
    "sparse-dkv-counter-not-reset": (
        SPARSE, "block-sparse dKV: the last split to arrive leaves the column's counter as it "
        "is, so the next launch never sums that column",
        "    if (last) *arrivals = 0;           // every split has arrived: ready for the next "
        "launch",
        "    // the counter is left at the number of splits"),
    "adam-vector-leaf-drops-tail": (
        ADAM_PLAN, "fused AdamW: the plan sends no scalar chunk for an aligned leaf's n % 4 "
        "tail",
        "        rows += [(leaf, 0, min(chunk, n - s), s) for s in range(n_vec, n, chunk)]",
        "        rows += [(leaf, 0, min(chunk, n - s), s) for s in range(n_vec, n if not n_vec "
        "else n_vec, chunk)]"),
    "adam-skip-first-chunk-of-stride": (
        ADAM, "fused AdamW: each block starts its stride at its second chunk",
        "  int c = blockIdx.x;",
        "  int c = blockIdx.x + gridDim.x;"),
}


def dtype_of(test_id: str) -> str:
    """bf16 for the peaked tests, the 2e-2 cases and the cases named
    bfloat16; fp32 for the rest (the 1e-5 and float32 cases, the
    bit-identity tests)."""
    bf16 = "bf16" in test_id or "bfloat16" in test_id or "-0.02]" in test_id
    return "bfloat16" if bf16 else "float32"


def copy_checkout(dst: Path) -> None:
    shutil.copytree(REPO, dst, ignore=shutil.ignore_patterns(
        ".git", "build_torch", "chip_trees", "__pycache__", ".pytest_cache", "*.pyc"))


def line_pairs(old, new):
    """The (line as it is, line broken) pairs of one mutation."""
    return list(zip(old, new)) if isinstance(old, tuple) else [(old, new)]


def mutate(root: Path, source: str, old: str, new: str) -> None:
    path = root / source
    text = path.read_text()
    if text.count(old) != 1:
        raise SystemExit(f"mutation_check: the line to mutate is not in {source} once: {old!r}")
    path.write_text(text.replace(old, new))


def failed_tests(xml_path: Path):
    """(failed test ids, number of tests run) from pytest's junit XML."""
    root = ET.parse(xml_path).getroot()
    failed, n = [], 0
    for case in root.iter("testcase"):
        if case.find("skipped") is not None:
            continue
        n += 1
        if case.find("failure") is not None or case.find("error") is not None:
            failed.append(case.get("name"))
    return failed, n


def main() -> int:
    runs = {"checkout": None, **MUTATIONS}
    every_test_file = sorted({tests for (_, tests), *_ in MUTATIONS.values()})
    with tempfile.TemporaryDirectory(prefix="kernel_mutations_") as tmp:
        procs = {}
        for name, m in runs.items():
            root = Path(tmp, name)
            copy_checkout(root)
            if m is not None:
                (source, tests), _, old, new = m
                for line, broken in line_pairs(old, new):
                    mutate(root, source, line, broken)
            procs[name] = (root, subprocess.Popen(
                [sys.executable, "-m", "pytest", *([tests] if m else every_test_file), "-m",
                 "cuda", "-q", "-p", "no:cacheprovider", f"--junitxml={root / 'junit.xml'}"],
                cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        summary, ok = {}, True
        for name, (root, proc) in procs.items():
            try:
                out, _ = proc.communicate(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate()
            xml = root / "junit.xml"
            if not xml.is_file():
                print(f"mutation_check: {name}: pytest wrote no report (exit "
                      f"{proc.returncode})\n{out[-4000:]}", flush=True)
                return 1
            failed, n = failed_tests(xml)
            by_dtype = {dt: sorted(t for t in failed if dtype_of(t) == dt)
                        for dt in ("float32", "bfloat16")}
            summary[name] = {"tests": n, "failed": len(failed),
                             "failed_float32": by_dtype["float32"],
                             "failed_bfloat16": by_dtype["bfloat16"]}
            if name == "checkout":
                seen = not failed
            else:
                seen = all(by_dtype[dt] for dt in MUTATION_DTYPES.get(
                    name, DTYPES.get(MUTATIONS[name][0][1], BOTH)))
            ok = ok and seen
            what = "the checkout" if name == "checkout" else MUTATIONS[name][1]
            print(f"mutation_check: {name} ({what}): {len(failed)} of {n} tests failed "
                  f"(fp32 {len(by_dtype['float32'])}, bf16 {len(by_dtype['bfloat16'])}): "
                  f"{'ok' if seen else 'NOT SEEN'}", flush=True)
            for t in failed:
                print(f"  {t}", flush=True)
    print(json.dumps({"mutation_check": summary, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
