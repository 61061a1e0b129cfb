"""Python binding of the native async file-I/O engine (counterpart of
``deepspeed_tpu/ops/aio/aio_handle.py``).

The engine is ``csrc/dst_aio.cpp`` beside this file: the port's copy of
the repo's ``csrc/aio/dst_aio.cpp`` (a ``pread`` / ``pwrite`` thread pool
behind a flat C interface, which splits a request into ``block_size``
pieces so several workers share one large tensor), the same code with the
headers it uses included, since GCC 13 does not compile the original
(``std::string`` is incomplete without ``<string>``).  It is compiled with
``g++`` at first use (never at import) into ``build_torch/aio-<hash of the
source and flags>/libdst_aio.so`` at the root of the checkout
(git-ignored), apart from the JAX package's ``build/libdst_aio.so``, and
driven through ``ctypes``.

``AIOHandle`` is the reference's ``aio_handle``: synchronous and
asynchronous ``pread`` / ``pwrite`` of a buffer against a file at an
offset, and ``wait``.  A buffer is a C-contiguous CPU tensor (pinned or
not) or numpy array; an asynchronous request holds a reference to its
buffer until it is joined.  A missing ``g++`` or a failed build raises
``AIOBuildError``; a failed request raises ``OSError`` with the errno the
engine reported.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

REPO_ROOT = Path(__file__).resolve().parents[3]
SOURCE = Path(__file__).resolve().parent / "csrc" / "dst_aio.cpp"
BUILD_ROOT = REPO_ROOT / "build_torch"
LIB_NAME = "libdst_aio.so"
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17", "-pthread"]
BUILD_TIMEOUT_S = 300

_lib = None
_lib_lock = threading.Lock()


class AIOBuildError(RuntimeError):
    """``g++`` is missing or ``dst_aio.cpp`` failed to build."""


def library_path() -> Path:
    """Where the engine for the checkout's source and flags lands."""
    if not SOURCE.is_file():
        raise AIOBuildError(f"the aio engine's source {SOURCE} is missing")
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_ROOT / f"aio-{digest[:16]}" / LIB_NAME


def build() -> Path:
    """Compile the engine unless the library for this source exists."""
    so = library_path()
    if so.is_file():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise AIOBuildError("g++ is not on PATH: the aio engine cannot be built")
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise AIOBuildError(f"g++ failed to build {SOURCE} (exit {proc.returncode}):\n"
                            f"{proc.stderr.strip()}")
    os.replace(tmp, so)
    return so


def load_library():
    """The engine's ``ctypes`` library, built first if need be."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.dst_aio_create.restype = ctypes.c_void_p
        lib.dst_aio_create.argtypes = [ctypes.c_int, ctypes.c_long, ctypes.c_int]
        lib.dst_aio_destroy.argtypes = [ctypes.c_void_p]
        for fn in (lib.dst_aio_submit_read, lib.dst_aio_submit_write):
            fn.restype = ctypes.c_long
            fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
                           ctypes.c_long, ctypes.c_long]
        lib.dst_aio_wait.restype = ctypes.c_int
        lib.dst_aio_wait.argtypes = [ctypes.c_void_p, ctypes.c_long]
        for fn in (lib.dst_aio_sync_pread, lib.dst_aio_sync_pwrite):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
                           ctypes.c_long, ctypes.c_long]
        _lib = lib
        return _lib


class AsyncIOBuilder:
    """The reference's ``OpBuilder`` surface over the engine's build."""

    NAME = "async_io"

    def is_compatible(self) -> bool:
        return shutil.which("g++") is not None and SOURCE.is_file()

    def load(self):
        return load_library()

    @staticmethod
    def so_path() -> str:
        return str(library_path())


def _address(buffer):
    """(pointer, bytes) of a C-contiguous CPU tensor or numpy array."""
    if isinstance(buffer, torch.Tensor):
        if buffer.device.type != "cpu":
            raise ValueError(f"aio buffers live in host memory; got one on {buffer.device}")
        if not buffer.is_contiguous():
            raise ValueError("aio buffers must be contiguous")
        return ctypes.c_void_p(buffer.data_ptr()), buffer.numel() * buffer.element_size()
    if not isinstance(buffer, np.ndarray):
        raise TypeError(f"aio buffers are CPU tensors or numpy arrays, not {type(buffer)}")
    if not buffer.flags["C_CONTIGUOUS"]:
        raise ValueError("aio buffers must be contiguous")
    return buffer.ctypes.data_as(ctypes.c_void_p), buffer.nbytes


class AIOHandle:
    """Synchronous and asynchronous reads and writes of host buffers
    against files; ``wait`` joins asynchronous requests.  ``block_size``
    splits a request among the ``num_threads`` workers (``single_submit``
    keeps it whole); ``use_o_direct`` opens with ``O_DIRECT`` where the
    buffer, offset and size are 512-byte aligned and the filesystem takes
    it.  ``queue_depth`` and ``overlap_events`` are the reference's knobs,
    kept on the handle; the engine's queue is unbounded."""

    def __init__(self, block_size: int = 1 << 20, queue_depth: int = 32,
                 single_submit: bool = False, overlap_events: bool = True,
                 num_threads: int = 4, use_o_direct: bool = False):
        self.block_size = int(block_size)
        self.queue_depth = int(queue_depth)
        self.single_submit = bool(single_submit)
        self.overlap_events = bool(overlap_events)
        self.num_threads = int(num_threads)
        self.use_o_direct = bool(use_o_direct)
        self._lib = load_library()
        block = 0 if single_submit else self.block_size
        self._h = self._lib.dst_aio_create(self.num_threads, block, int(self.use_o_direct))
        self._pending: Dict[int, object] = {}     # request id -> its buffer, kept alive

    def close(self) -> None:
        """Join every request and stop the engine's workers."""
        if getattr(self, "_h", None):
            try:
                self.wait()
            finally:
                self._lib.dst_aio_destroy(self._h)
                self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @staticmethod
    def _check(rc: int, what: str, path: str) -> None:
        if rc != 0:
            raise OSError(rc, f"aio {what} of {path!r} failed: {os.strerror(rc) if rc > 0 else rc}",
                          path)

    # ---- sync ---------------------------------------------------------- #
    def pread(self, buffer, path: str, offset: int = 0) -> None:
        ptr, n = _address(buffer)
        self._check(self._lib.dst_aio_sync_pread(self._h, str(path).encode(), ptr, n, offset),
                    "pread", path)

    def pwrite(self, buffer, path: str, offset: int = 0) -> None:
        ptr, n = _address(buffer)
        self._check(self._lib.dst_aio_sync_pwrite(self._h, str(path).encode(), ptr, n, offset),
                    "pwrite", path)

    # ---- async --------------------------------------------------------- #
    def async_pread(self, buffer, path: str, offset: int = 0) -> int:
        ptr, n = _address(buffer)
        rid = int(self._lib.dst_aio_submit_read(self._h, str(path).encode(), ptr, n, offset))
        self._pending[rid] = buffer
        return rid

    def async_pwrite(self, buffer, path: str, offset: int = 0) -> int:
        ptr, n = _address(buffer)
        rid = int(self._lib.dst_aio_submit_write(self._h, str(path).encode(), ptr, n, offset))
        self._pending[rid] = buffer
        return rid

    def wait(self, request_id: Optional[int] = None) -> int:
        """Join one request (or all); the number joined.  The first failed
        request raises once every one asked for is joined."""
        ids = [request_id] if request_id is not None else sorted(self._pending)
        failed = None
        for rid in ids:
            rc = self._lib.dst_aio_wait(self._h, rid)
            self._pending.pop(rid, None)
            if rc != 0 and failed is None:
                failed = (rc, rid)
        if failed is not None:
            rc, rid = failed
            raise OSError(rc, f"aio request {rid} failed: "
                              f"{os.strerror(rc) if rc > 0 else rc}")
        return len(ids)
