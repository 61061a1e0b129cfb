"""Times the tiered-KV spill and restage copies on the card, at chip_smoke.py
phase 31's arena: Llama-3-8B's KV (32 layers, 8 kv heads of 128, bf16) in
193 blocks of 16 tokens, 2 MiB a block, and spills of 12 to 47 blocks,
239 in all, as that phase's seven spills.

For the ``KVTieringManager`` of the tree it is run from (its host cache
large enough that no restage reads the disk), each round spills
every size (host clock until ``spill`` returns, which waits for the
copies), lets the disk writes land, and restages each into other blocks
(host clock until the stream has drained), and checks the restored
bytes.  The first round finds PyTorch's pinned-memory cache empty, as a
serving engine's first spills do.  Beside it, on the same
blocks: an ``index_select`` of K and of V followed by ``.cpu()`` into
fresh pageable memory, and a copy into one pinned buffer made beforehand
(the transfer alone).  One JSON line a round.

Run from a tree's root::

    python3 -m deepspeed_tpu_torch.serving.spill_probe [--label NAME]

To compare two trees on one card, copy this file into the other tree's
``deepspeed_tpu_torch/serving/`` and run it from both roots in one call.
"""

import argparse
import json
import subprocess
import tempfile
import time

SIZES = (12, 47, 40, 35, 30, 38, 37)
LAYERS, BLOCKS, BS, KV_HEADS, HEAD_DIM = 32, 193, 16, 8, 128
HOST_CACHE_BYTES = 1 << 30      # every restage reads host memory
ROUNDS = 3


def main() -> int:
    import torch
    from deepspeed_tpu_torch.serving.kv_tiering import KVTieringManager

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default=".")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("spill_probe: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    shape = (LAYERS, BLOCKS, BS, KV_HEADS, HEAD_DIM)
    kp = torch.randn(shape, device=dev).to(torch.bfloat16)
    vp = torch.randn(shape, device=dev).to(torch.bfloat16)
    stream = torch.cuda.current_stream(dev)
    pinned = {n: torch.empty((2, LAYERS, n, BS, KV_HEADS, HEAD_DIM), dtype=torch.bfloat16,
                             pin_memory=True) for n in set(SIZES)}
    block_bytes = 2 * LAYERS * BS * KV_HEADS * HEAD_DIM * 2

    def pick(n):
        return (torch.randperm(BLOCKS - 1, generator=gen)[:n] + 1).tolist()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="spill_probe_") as root:
        mgr = KVTieringManager(root, host_cache_bytes=HOST_CACHE_BYTES, stream=stream)
        try:
            for r in range(ROUNDS):
                spill_s = restage_s = cpu_s = pinned_s = 0.0
                spilled = {}
                for i, n in enumerate(SIZES):
                    rid = r * len(SIZES) + i
                    blocks = pick(n)
                    spilled[rid] = (blocks, kp[:, blocks].clone(), vp[:, blocks].clone())
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    mgr.spill(rid, blocks, kp, vp, tokens=n * BS)
                    spill_s += time.perf_counter() - t0
                    idx = torch.tensor(blocks, device=dev)
                    _, s = timed(lambda: (kp.index_select(1, idx).cpu(),
                                          vp.index_select(1, idx).cpu()))
                    cpu_s += s
                    _, s = timed(lambda: (
                        pinned[n][0].copy_(kp.index_select(1, idx), non_blocking=True),
                        pinned[n][1].copy_(vp.index_select(1, idx), non_blocking=True)))
                    pinned_s += s
                # the spills' disk writes land first, as they have long before a
                # restage in serving: a restage's remove() would wait for them
                mgr.drain()
                for rid, (blocks, k, v) in spilled.items():
                    dest = pick(len(blocks))
                    mgr.begin_restage(rid)
                    _, s = timed(lambda: mgr.restage(rid, kp, vp, dest))
                    restage_s += s
                    if not (torch.equal(kp[:, dest], k) and torch.equal(vp[:, dest], v)):
                        raise SystemExit(f"spill_probe: restage of {rid} differs")
                gb = sum(SIZES) * block_bytes / 1e9
                print(json.dumps({
                    "label": args.label, "round": r, "gb": gb,
                    "spill_gbs": gb / spill_s, "restage_gbs": gb / restage_s,
                    "index_select_cpu_gbs": gb / cpu_s,
                    "into_pinned_gbs": gb / pinned_s, "card": card}), flush=True)
        finally:
            mgr.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
