"""What a swap path gives the NVMe tier, measured on the machine at hand.

``python -m deepspeed_tpu_torch.runtime.swap_tensor.swap_probe [--dir D]
[--gib N]`` prints, one JSON line each: the filesystem and free bytes of
the candidate directories (``--dir``, else the temporary directory, the
working directory and the home directory; ``tmpfs`` / ``ramfs`` are
listed but never probed), then on the one with the most room (or
``--dir``): ``zlib.crc32``'s rate on one 512 MiB chunk; the staging pool
(``runtime/offload/staging.py``: CRC'd chunk files, an ``fsync`` a chunk)
writing and reading ``N`` GiB in 512 MiB chunks at a few thread counts
and bounce-buffer sizes; ``AIOHandle`` writing and reading 1 GiB of page-
aligned pinned memory with and without ``use_o_direct``; and on a CUDA
machine a 512 MiB copy each way between the card and pageable and pinned
host memory.  Rates are GiB/s by the host clock; a read follows its write
and may come from the page cache (warm).  Every file it writes is removed.
"""

import argparse
import json
import os
import shutil
import tempfile
import time
import zlib

import numpy as np
import torch

from deepspeed_tpu_torch.runtime.offload.staging import StagingPool
from deepspeed_tpu_torch.runtime.swap_tensor.partitioned_param_swapper import (
    MEMORY_FILESYSTEMS, filesystem_type)

CHUNK = 512 << 20
POOL_KNOBS = ((2, 1 << 20), (8, 1 << 20), (8, 8 << 20), (8, 32 << 20))   # threads, bounce bytes


def emit(**rec) -> None:
    print(json.dumps(rec), flush=True)


def candidates(given):
    dirs = given or sorted({tempfile.gettempdir(), os.getcwd(), os.path.expanduser("~")})
    out = []
    for d in dirs:
        if os.path.isdir(d):
            fs, free = filesystem_type(d), shutil.disk_usage(d).free
            emit(what="dir", dir=d, fs=fs, free_bytes=free, writable=os.access(d, os.W_OK))
            if fs not in MEMORY_FILESYSTEMS and os.access(d, os.W_OK):
                out.append((free, d))
    if not out:
        raise SystemExit("no writable directory on a disk among " + ", ".join(dirs))
    return max(out)[1]


def timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def probe_pool(work: str, gib: int) -> None:
    chunk = torch.from_numpy(np.random.default_rng(0).integers(0, 255, CHUNK, dtype=np.uint8))
    emit(what="crc32", gib_s=(CHUNK / 2 ** 30) / timed(lambda: zlib.crc32(chunk.numpy())))
    n = max(1, gib * (2 ** 30) // CHUNK)
    for threads, bounce in POOL_KNOBS:
        folder = os.path.join(work, f"pool_{threads}_{bounce}")
        pool = StagingPool(folder, buffer_count=max(2, threads), buffer_size=bounce,
                           queue_depth=32, thread_count=threads)
        w = timed(lambda: [f.result() for f in [pool.write(f"k{i}", chunk) for i in range(n)]])
        outs = []
        r = timed(lambda: outs.extend(f.result() for f in [pool.read(f"k{i}")
                                                          for i in range(n)]))
        same = all(torch.equal(o, chunk) for o in outs)
        del outs
        pool.close()
        shutil.rmtree(folder)
        emit(what="staging_pool", threads=threads, bounce_bytes=bounce, gib=n * CHUNK / 2 ** 30,
             write_gib_s=n * CHUNK / 2 ** 30 / w, read_gib_s=n * CHUNK / 2 ** 30 / r,
             bytes_equal=same)


def probe_aio(work: str) -> None:
    from deepspeed_tpu_torch.ops.aio import AIOHandle
    pin = torch.cuda.is_available()
    src = torch.randint(0, 256, (1 << 30,), dtype=torch.uint8)
    src = src.pin_memory() if pin else src
    back = torch.empty_like(src)
    for od in (False, True):
        h = AIOHandle(block_size=8 << 20, num_threads=8, use_o_direct=od)
        path = os.path.join(work, f"aio_{int(od)}.bin")
        w = timed(lambda: h.pwrite(src, path))
        r = timed(lambda: h.pread(back, path))
        h.close()
        os.remove(path)
        emit(what="aio", use_o_direct=od, write_gib_s=1 / w, read_gib_s=1 / r,
             bytes_equal=bool(torch.equal(back, src)), aligned=src.data_ptr() % 4096 == 0)


def probe_copies() -> None:
    dev = torch.empty(CHUNK // 4, device="cuda")
    for kind, host in (("pageable", torch.empty(CHUNK // 4)),
                       ("pinned", torch.empty(CHUNK // 4, pin_memory=True))):
        for way, fn in (("h2d", lambda: dev.copy_(host, non_blocking=True)),
                        ("d2h", lambda: host.copy_(dev, non_blocking=True))):
            torch.cuda.synchronize()
            dt = timed(lambda: [fn() for _ in range(5)] + [torch.cuda.synchronize()]) / 5
            emit(what="copy", way=way, host=kind, gib_s=CHUNK / 2 ** 30 / dt)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", action="append", help="a directory to consider (repeatable)")
    ap.add_argument("--gib", type=int, default=4, help="GiB the staging pool writes a setting")
    args = ap.parse_args(argv)
    work = tempfile.mkdtemp(prefix="swap_probe_", dir=candidates(args.dir))
    try:
        probe_pool(work, args.gib)
        probe_aio(work)
        if torch.cuda.is_available():
            probe_copies()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
