"""Builds the package's CUDA kernels into one shared library and loads it.

The JAX package compiles its Pallas kernels through XLA at trace time; the
port compiles ``ops/cuda/csrc/*.cu`` with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded through ``ctypes`` (no
PyTorch headers, so a build takes seconds, not minutes).

* The build happens at first use (``load_library()``), never at import.
* Each source compiles in its own ``nvcc`` process (a source of ``PARTS``
  in one per part), all started together; one link step joins them.  The
  sources of ``SPLIT_FLAGS`` also spread
  their functions over threads (``-split-compile``), in the way that
  leaves each one's SASS as a one-thread build's (compared with
  ``cuobjdump -sass`` under CUDA 12.9: ``nvcc``'s split changes
  ``decode_attention.cu``'s, ``ptxas``'s does not).
* The library lands in ``build_torch/<hash of the sources and flags>/`` at
  the root of the checkout (listed in ``.gitignore``), so a changed source
  builds anew and an unchanged one is reused.
* A missing ``nvcc`` or a failed build raises ``KernelBuildError``.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build_torch"
LIB_NAME = "libdst_torch_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]
BUILD_TIMEOUT_S = 600
SPLIT_FLAGS = {"decode_attention.cu": ["-Xptxas", "-split-compile=0"],
               "flash_attention.cu": ["-split-compile=0"],
               "fused_optim.cu": ["-split-compile=0"]}
# sources compiled as several objects at once, one per set of flags:
# decode_attention.cu's float32 kernels (with its entry points) and its
# bfloat16 kernels (without them, their build bounded the whole one's)
PARTS = {"decode_attention.cu": (["-DDST_DECODE_DTYPE=0"], ["-DDST_DECODE_DTYPE=1"])}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or a kernel source failed to build."""


def find_nvcc() -> str:
    """``nvcc`` on ``PATH``, else under ``$CUDA_HOME`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise KernelBuildError(
        "nvcc not found (looked on PATH, $CUDA_HOME and /usr/local/cuda); the "
        "CUDA kernels of deepspeed_tpu_torch cannot be built on this machine")


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SPLIT_FLAGS.items())).encode())
    h.update(repr(sorted(PARTS.items())).encode())
    for src in sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


class BuildResult:
    """Where the library is, how long the build took (0 when reused), when
    each source's ``nvcc`` ended (seconds from the start; empty when
    reused) and what ``nvcc`` printed (register and shared-memory use per
    kernel)."""

    def __init__(self, path: Path, seconds: float, log: str, per_source=None):
        self.path = path
        self.seconds = seconds
        self.log = log
        self.per_source = per_source or {}


def build() -> BuildResult:
    """Compile every ``csrc/*.cu`` in parallel and link one library, unless
    the library of these sources is already built."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        log_path = out_dir / "build.log"
        return BuildResult(lib, 0.0, log_path.read_text() if log_path.is_file() else "")
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in sources():
            parts = PARTS.get(src.name, ([],))
            for i, flags in enumerate(parts):
                name = f"{src.name}[{i}]" if len(parts) > 1 else src.name
                stem = f"{src.stem}.{i}" if len(parts) > 1 else src.stem
                obj, out = Path(tmp, stem + ".o"), Path(tmp, stem + ".log")
                cmd = [nvcc, *NVCC_FLAGS, *SPLIT_FLAGS.get(src.name, []), *flags, "-c",
                       str(src), "-o", str(obj)]
                with open(out, "w") as f:
                    procs.append((name, obj, cmd, out, subprocess.Popen(
                        cmd, stdout=f, stderr=subprocess.STDOUT)))
        per_source = {}
        while len(per_source) < len(procs) and time.perf_counter() - t0 < BUILD_TIMEOUT_S:
            for name, _, _, _, proc in procs:
                if name not in per_source and proc.poll() is not None:
                    per_source[name] = time.perf_counter() - t0
            time.sleep(0.05)
        logs, failed = [], []
        for name, obj, cmd, out, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
                failed.append(f"{name}: timed out after {BUILD_TIMEOUT_S}s")
            logs.append(f"$ {' '.join(cmd)}\n{out.read_text()}")
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exit {proc.returncode}")
        if failed:
            raise KernelBuildError("kernel build failed: " + "; ".join(failed)
                                   + "\n" + "\n".join(logs))
        tmp_lib = Path(tmp, LIB_NAME)
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
               *[str(obj) for _, obj, _, _, _ in procs]]
        link = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              timeout=BUILD_TIMEOUT_S)
        logs.append(f"$ {' '.join(cmd)}\n{link.stdout}")
        if link.returncode != 0:
            raise KernelBuildError("kernel link failed:\n" + "\n".join(logs))
        log = "\n".join(logs)
        (out_dir / "build.log").write_text(log)
        os.replace(tmp_lib, lib)      # atomic: a concurrent loader sees all or nothing
    return BuildResult(lib, time.perf_counter() - t0, log, per_source)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dst_paged_attention.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                        ci, ci, ci, ci, ci, ci, ci, cf, ci, vp]
    lib.dst_paged_attention.restype = ci
    lib.dst_decode_attention.argtypes = [vp, vp, vp, vp, vp,
                                         ci, ci, ci, ci, ci, ci, ci, cf, ci, vp]
    lib.dst_decode_attention.restype = ci
    lib.dst_ce_forward.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp,
                                   ci, ci, ci, ci, ci, ci, vp]
    lib.dst_ce_forward.restype = ci
    lib.dst_ce_backward_dx.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp,
                                       ci, ci, ci, ci, ci, ci, vp]
    lib.dst_ce_backward_dx.restype = ci
    lib.dst_ce_backward_dhead.argtypes = [vp, vp, vp, vp, vp, vp,
                                          ci, ci, ci, ci, ci, vp]
    lib.dst_ce_backward_dhead.restype = ci
    lib.dst_ce_forward_occupancy.argtypes = [ci, ctypes.POINTER(ci)]
    lib.dst_ce_forward_occupancy.restype = ci
    lib.dst_ce_backward_active_clusters.argtypes = [ci, ci]
    lib.dst_ce_backward_active_clusters.restype = ci
    lib.dst_ce_wide_ds.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp,
                                   ci, ci, ci, ci, ci, ci, ci, ci, vp]
    lib.dst_ce_wide_ds.restype = ci
    lib.dst_ce_wide_dx.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ci, vp]
    lib.dst_ce_wide_dx.restype = ci
    lib.dst_ce_wide_dhead.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp]
    lib.dst_ce_wide_dhead.restype = ci
    lib.dst_fused_adam.argtypes = [vp, ci, vp, ci, ci, vp, vp,
                                   cf, cf, cf, cf, cf, cf, ci, vp]
    lib.dst_fused_adam.restype = ci
    strides = ctypes.POINTER(ctypes.c_longlong)
    lib.dst_flash_forward.argtypes = [vp, vp, vp, vp, vp, vp, vp, strides,
                                      ci, ci, ci, ci, ci, cf, ci, ci, vp]
    lib.dst_flash_forward.restype = ci
    lib.dst_flash_backward_dq.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, strides,
                                          ci, ci, ci, ci, ci, cf, ci, ci, vp]
    lib.dst_flash_backward_dq.restype = ci
    lib.dst_flash_backward_dkv.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, strides,
                                           ci, ci, ci, ci, ci, cf, ci, ci, vp]
    lib.dst_flash_backward_dkv.restype = ci
    lib.dst_flash_occupancy.argtypes = [ci, ci, ci, ci, ctypes.POINTER(ci)]
    lib.dst_flash_occupancy.restype = ci
    lib.dst_sparse_forward.argtypes = [vp, vp, vp, vp, vp, ci, vp, vp, strides,
                                       ci, ci, ci, cf, ci, ci, vp]
    lib.dst_sparse_forward.restype = ci
    lib.dst_sparse_backward_dq.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, vp, strides,
                                           ci, ci, ci, cf, ci, ci, vp]
    lib.dst_sparse_backward_dq.restype = ci
    lib.dst_sparse_backward_dkv.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, vp, ci, vp, ci,
                                            vp, vp, strides, ci, ci, ci, cf, ci, ci, vp]
    lib.dst_sparse_backward_dkv.restype = ci
    lib.dst_sparse_occupancy.argtypes = [ci, ci, ci, ctypes.POINTER(ci)]
    lib.dst_sparse_occupancy.restype = ci
    lib.dst_fused_adam_chunk.argtypes = []
    lib.dst_fused_adam_chunk.restype = ci
    lib.dst_fused_adam_grid.argtypes = []
    lib.dst_fused_adam_grid.restype = ci
    lib.dst_error_string.argtypes = [ci]
    lib.dst_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    return _declare(ctypes.CDLL(str(build().path)))


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = lib.dst_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
