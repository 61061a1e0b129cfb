"""The port's NVMe I/O layer against ``deepspeed_tpu``'s, on the CPU.

* ``AIOHandle`` (``ops/aio/``, its copy of the repo's
  ``csrc/aio/dst_aio.cpp`` built into ``build_torch/``, not the JAX
  package's ``build/``) against JAX's on
  the same files: sync and async round trips written by one and read by
  the other, offsets, a failed read raising ``OSError`` in both, a failed
  build raising.
* Chunks the port's swappers write are read byte for byte by JAX's
  ``StagingPool`` (fp32, bf16 and int32 leaves, a per-block chunked
  stack), and JAX's swappers' chunks by the port's.
* JAX's swapper tests (``tests/unit/ops/test_aio.py:64-100``) run on both
  packages' swappers with the same inputs: equal results.
* The ``aio`` and ``offload_*`` knobs reach the pools (JAX's
  ``TestOffloadOptimizerConfigHonored``), and a swap path that cannot hold
  the tier (not writable, in memory, too small) raises at ``initialize``.
* The tiered store reads a key whose uncached write is in flight only
  after that write lands.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

import deepspeed_tpu_torch as dst
from deepspeed_tpu.ops.aio import AIOHandle as JAIOHandle
from deepspeed_tpu.runtime.offload.staging import StagingPool as JStagingPool
from deepspeed_tpu.runtime.swap_tensor import (AsyncPartitionedParameterSwapper as JParamSwapper,
                                               AsyncTensorSwapper as JTensorSwapper,
                                               PartitionedOptimizerSwapper as JOptSwapper,
                                               get_aio_config as j_get_aio_config)
from deepspeed_tpu_torch.models.simple import SimpleModel
from deepspeed_tpu_torch.ops import aio as taio
from deepspeed_tpu_torch.ops.aio import aio_handle as taio_handle
from deepspeed_tpu_torch.runtime.offload.staging import StagingError, StagingPool
from deepspeed_tpu_torch.runtime.offload.store import TieredStore
from deepspeed_tpu_torch.runtime.swap_tensor import (AsyncPartitionedParameterSwapper,
                                                     AsyncTensorSwapper,
                                                     PartitionedOptimizerSwapper,
                                                     get_aio_config)
from deepspeed_tpu_torch.runtime.swap_tensor import partitioned_param_swapper as tpps


@pytest.fixture(scope="module")
def handles():
    assert taio.AsyncIOBuilder().is_compatible(), "g++ toolchain required"
    port, jax_ = taio.AIOHandle(num_threads=4), JAIOHandle(num_threads=4)
    yield port, jax_
    port.close()


# --------------------------------------------------------------------------- #
# AIOHandle
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sync_roundtrip_across_packages(handles, tmp_path, writer):
    port, jax_ = handles
    x = np.random.default_rng(0).standard_normal(1 << 16).astype(np.float32)
    path = str(tmp_path / "a.bin")
    if writer == "port":
        port.pwrite(torch.from_numpy(x), path)
        y = np.zeros_like(x)
        jax_.pread(y, path)
    else:
        jax_.pwrite(x, path)
        y = torch.zeros(x.shape, dtype=torch.float32)
        port.pread(y, path)
        y = y.numpy()
    np.testing.assert_array_equal(x, y)


def test_async_overlap_and_wait_match_jax(handles, tmp_path):
    port, jax_ = handles
    xs = [np.full((1 << 14,), i, np.float32) for i in range(8)]
    ids = [port.async_pwrite(torch.from_numpy(x), str(tmp_path / f"w{i}.bin"))
           for i, x in enumerate(xs)]
    assert port.wait() == len(ids)
    z = np.zeros((1 << 14,), np.float32)
    rid = jax_.async_pread(z, str(tmp_path / "w5.bin"))
    jax_.wait(rid)
    np.testing.assert_array_equal(z, xs[5])
    t = torch.zeros(1 << 14)
    rid = port.async_pread(t, str(tmp_path / "w3.bin"))
    assert port.wait(rid) == 1
    np.testing.assert_array_equal(t.numpy(), xs[3])


def test_offsets_match_jax(handles, tmp_path):
    port, jax_ = handles
    path = str(tmp_path / "off.bin")
    a = np.arange(1024, dtype=np.int64)
    jax_.pwrite(a, path)
    part, jpart = torch.zeros(256, dtype=torch.int64), np.zeros(256, np.int64)
    port.pread(part, path, offset=256 * 8)
    jax_.pread(jpart, path, offset=256 * 8)
    np.testing.assert_array_equal(part.numpy(), a[256:512])
    np.testing.assert_array_equal(jpart, a[256:512])
    port.pwrite(torch.full((16,), -1, dtype=torch.int64), path, offset=8 * 8)
    back = np.zeros(1024, np.int64)
    jax_.pread(back, path)
    np.testing.assert_array_equal(back[8:24], -1)
    np.testing.assert_array_equal(back[24:], a[24:])


def test_failed_read_raises_in_both(handles, tmp_path):
    port, jax_ = handles
    missing = str(tmp_path / "missing.bin")
    with pytest.raises(OSError):
        jax_.pread(np.zeros(8, np.float32), missing)
    with pytest.raises(OSError) as err:
        port.pread(torch.zeros(8), missing)
    assert err.value.errno == 2
    rid = port.async_pread(torch.zeros(8), missing)
    with pytest.raises(OSError):
        port.wait(rid)


def test_buffers_must_be_contiguous_host_memory(handles, tmp_path):
    port, _ = handles
    with pytest.raises(ValueError, match="contiguous"):
        port.pwrite(torch.zeros(8, 2).t(), str(tmp_path / "t.bin"))
    with pytest.raises(TypeError):
        port.pwrite([1, 2, 3], str(tmp_path / "t.bin"))


def test_builder_builds_into_the_ports_own_directory():
    b = taio.AsyncIOBuilder()
    assert b.is_compatible() and b.load() is not None
    so = b.so_path()
    assert os.path.exists(so)
    repo = taio_handle.REPO_ROOT
    assert os.path.dirname(os.path.dirname(so)) == str(repo / "build_torch")
    assert taio_handle.SOURCE == repo / "deepspeed_tpu_torch" / "ops" / "aio" / "csrc" / \
        "dst_aio.cpp"


def test_failed_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "dst_aio.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(taio_handle, "SOURCE", bad)
    monkeypatch.setattr(taio_handle, "BUILD_ROOT", tmp_path / "build_torch")
    with pytest.raises(taio.AIOBuildError, match="failed to build"):
        taio_handle.build()
    monkeypatch.setattr(taio_handle.shutil, "which", lambda name: None)
    with pytest.raises(taio.AIOBuildError, match="g\\+\\+ is not on PATH"):
        taio_handle.build()


# --------------------------------------------------------------------------- #
# chunks across packages
# --------------------------------------------------------------------------- #
def opt_tree(torch_side: bool):
    """An optimizer-state-like tree: fp32 moments by the port's block
    layout, a bf16 leaf, an int32 count and a stack of 3 blocks."""
    rng = np.random.default_rng(7)
    mu = rng.standard_normal((4, 6)).astype(np.float32)
    stack = rng.standard_normal((3, 5)).astype(np.float32)
    half = rng.standard_normal(9).astype(ml_dtypes.bfloat16)
    count = np.array(5, np.int32)
    if torch_side:
        return {"mu": {"blocks": [{"w": torch.from_numpy(mu)}]},
                "half": torch.from_numpy(half.view(np.uint16).copy()).view(torch.bfloat16),
                "stack": {"blocks": {"w": torch.from_numpy(stack)}},
                "count": torch.from_numpy(count)}
    return {"mu": {"blocks": [{"w": mu}]}, "half": half, "stack": {"blocks": {"w": stack}},
            "count": count}


def raw(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def chunk_bytes(path):
    return {name: (path / name).read_bytes() for name in sorted(os.listdir(path))
            if name.endswith(".chunk")}


def test_port_swapper_chunks_read_by_jax_pool(tmp_path):
    sw = PartitionedOptimizerSwapper(str(tmp_path / "port"))
    tree = opt_tree(torch_side=True)
    sw.swap_out(tree)
    keys = sw._swapper.pool.keys()
    assert "opt__stack__blocks__w__blk2" in keys and "opt__mu__blocks__0__w" in keys
    jpool = JStagingPool(str(tmp_path / "port"))
    for key in keys:
        got, host = jpool.read_sync(key), sw._swapper.store.get(key)
        assert got.tobytes() == raw(host), key
        assert list(got.shape) == list(host.shape), key
        assert str(got.dtype) == str(host.dtype).removeprefix("torch."), key


def test_jax_swapper_chunks_read_by_port(tmp_path):
    jsw = JOptSwapper(str(tmp_path / "jax"))
    jsw.swap_out(jax.tree.map(jnp.asarray, opt_tree(torch_side=False)))
    pool = StagingPool(str(tmp_path / "jax"))
    jpool = JStagingPool(str(tmp_path / "jax"))
    keys = jpool.keys()
    assert keys == pool.keys() and any("__blk2" in k for k in keys)
    for key in keys:
        got, want = pool.read_sync(key), jpool.read_sync(key)
        assert raw(got) == want.tobytes(), key
        assert list(got.shape) == list(want.shape), key
    pool.close()


def test_same_tree_gives_the_same_chunk_bytes(tmp_path):
    """A flat tree of the same leaves: identical chunk files, key by key."""
    rng = np.random.default_rng(3)
    leaves = {"a": rng.standard_normal((4, 4)).astype(np.float32),
              "b": rng.integers(0, 9, 7).astype(np.int32)}
    sw = AsyncPartitionedParameterSwapper(str(tmp_path / "port"))
    sw.swap_out_tree({k: torch.from_numpy(v) for k, v in leaves.items()}, prefix="param")
    jsw = JParamSwapper(str(tmp_path / "jax"))
    jsw.swap_out_tree({k: jnp.asarray(v) for k, v in leaves.items()}, prefix="param")
    assert chunk_bytes(tmp_path / "port") == chunk_bytes(tmp_path / "jax")
    sw.close()


# --------------------------------------------------------------------------- #
# JAX's swapper tests on both packages
# --------------------------------------------------------------------------- #
def test_async_tensor_swapper(tmp_path):
    x = np.random.default_rng(1).standard_normal((64, 64)).astype(np.float32)
    out = {}
    for name, cls, arr in (("port", AsyncTensorSwapper, torch.from_numpy(x)),
                           ("jax", JTensorSwapper, x)):
        sw = cls(swap_folder=str(tmp_path / name))
        sw.swap_out("t0", arr)
        sw.synchronize()
        out[name] = np.asarray(sw.swap_in("t0", x.shape, x.dtype))
        assert sw.bytes_swapped == x.nbytes
        rid, _ = sw.async_swap_in("t0")
        np.testing.assert_array_equal(np.asarray(sw.fetch(rid)), x)
    np.testing.assert_array_equal(out["port"], x)
    np.testing.assert_array_equal(out["jax"], x)
    sw = AsyncTensorSwapper(swap_folder=str(tmp_path / "port"))
    with pytest.raises(ValueError, match="staged shape"):
        sw.swap_in("t0", (2, 2))


def test_partitioned_param_swapper_tree(tmp_path):
    jtree = {"a": jnp.arange(16, dtype=jnp.float32).reshape(4, 4),
             "b": {"c": jnp.ones((8,), jnp.bfloat16)}}
    jsw = JParamSwapper(str(tmp_path / "jax"))
    jsw.swap_out_tree(jtree)
    template = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jtree)
    jsw.prefetch_tree(template)
    jback = jsw.swap_in_tree(template)
    tree = {"a": torch.arange(16, dtype=torch.float32).reshape(4, 4),
            "b": {"c": torch.ones(8, dtype=torch.bfloat16)}}
    sw = AsyncPartitionedParameterSwapper(str(tmp_path / "port"))
    sw.swap_out_tree(tree)
    sw.prefetch_tree(tree)
    back = sw.swap_in_tree(tree)
    np.testing.assert_array_equal(back["a"].numpy(), np.asarray(jback["a"]))
    np.testing.assert_array_equal(back["b"]["c"].float().numpy(),
                                  np.asarray(jback["b"]["c"], np.float32))
    assert sw.stats()["ring_hits"] == 2
    # remove drops the cached and staged copies: nothing comes back
    sw.remove("p")
    assert sw.pool.keys() == [] and sw.stats()["host_keys"] == 0
    sw.close()


def test_optimizer_swapper_roundtrip(tmp_path):
    jstate = {"mu": jnp.arange(32, dtype=jnp.float32), "nu": jnp.ones((4, 8), jnp.float32)}
    jsw = JOptSwapper(str(tmp_path / "jax"))
    jsw.swap_out(jstate)
    jsw.prefetch()
    jback = jsw.swap_in()
    state = {"mu": torch.arange(32, dtype=torch.float32), "nu": torch.ones(4, 8)}
    sw = PartitionedOptimizerSwapper(str(tmp_path / "port"))
    sw.swap_out(state)
    assert sw.is_swapped and sw.swapped_bytes() == jsw.swapped_bytes() > 0
    sw.prefetch()
    back = sw.swap_in()
    np.testing.assert_array_equal(back["mu"].numpy(), np.asarray(jback["mu"]))
    np.testing.assert_array_equal(back["nu"].numpy(), np.asarray(jback["nu"]))
    assert sw.template["nu"].shape == (4, 8) and sw.template["nu"].device.type == "meta"
    sw.invalidate()
    assert not sw.is_swapped and sw._swapper.pool.keys() == []
    sw.close()


def test_aio_config_defaults():
    for cfg in (get_aio_config({"aio": {"thread_count": 9}}),
                j_get_aio_config({"aio": {"thread_count": 9}})):
        assert cfg["thread_count"] == 9 and cfg["block_size"] == 1 << 20
    assert get_aio_config({}) == j_get_aio_config({})


def test_store_reads_an_inflight_uncached_write_after_it_lands(tmp_path):
    """A prefetch of a key whose uncached write is still queued reads the
    new bytes, not the old chunk (the walk's pipelined write-back)."""
    pool = StagingPool(str(tmp_path), thread_count=2)
    store = TieredStore(pool, max_in_cpu=0)
    store.put_uncached("k", torch.zeros(1 << 18))
    store.drain()
    new = torch.arange(1 << 18, dtype=torch.float32)
    fut = store.put_uncached("k", new)
    store.prefetch(["k"])
    assert torch.equal(store.get("k"), new)
    assert fut.done
    pool.close()


def test_store_reads_into_a_callers_buffer(tmp_path):
    """A prefetch into a caller's buffer fills it and ``get`` returns it,
    kept by no LRU; a write that supersedes such a read waits for it, so
    no forgotten read lands in the buffer later; a buffer that does not
    fit the chunk raises."""
    pool = StagingPool(str(tmp_path), thread_count=2)
    store = TieredStore(pool, max_in_cpu=None)
    data = torch.arange(1 << 16, dtype=torch.float32)
    store.put_uncached("k", data)
    buf = torch.zeros(1 << 16)
    store.prefetch(["k"], into={"k": buf})
    got = store.get("k", out=buf)
    assert got.data_ptr() == buf.data_ptr() and torch.equal(buf, data)
    stats = store.stats()
    assert stats["host_keys"] == 0 and stats["ring_hits"] + stats["ring_misses"] == 1
    other = torch.zeros(1 << 16)
    store.prefetch(["k"], into={"k": other})
    store.put_uncached("k", data + 1)        # supersedes the read into ``other``
    assert torch.equal(other, data)          # that read had landed before the put returned
    assert torch.equal(store.get("k", out=other), data + 1)
    with pytest.raises(StagingError, match="does not fit"):
        pool.read_sync("k", out=torch.zeros(10))
    pool.close()


def test_walk_cycles_under_thread_pressure_lose_no_update(tmp_path):
    """The optimizer walk's use of an NVMe store, with more staging threads
    than cores and a short switch interval: each round reads every piece
    into a slot (the next one prefetched), adds 1 on the "device" buffer,
    copies it back into the slot and writes it from there without joining
    (``pipeline_write``), so reads chain behind in-flight writes and slots
    come back while writes drain.  After the rounds every value counts
    them all: no write lost, none read back stale."""
    import sys
    from deepspeed_tpu_torch.runtime.zero.partition_parameters import NvmeFlatStore
    sw = PartitionedOptimizerSwapper(str(tmp_path), {"thread_count": 2 * (os.cpu_count() or 1) + 2,
                                                     "block_size": 4096}, max_in_cpu=0,
                                     pipeline_write=True, buffer_count=2)
    store = NvmeFlatStore(16 * 1024 + 100, "cpu", 1024, sw, "mu", slots=3)
    buf = torch.empty(1024)
    rounds, interval = 6, sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(rounds):
            n_pieces = len(store.lengths)
            store.prefetch_piece(0)
            for k in range(n_pieces):
                if k + 1 < n_pieces:
                    store.prefetch_piece(k + 1)
                view = buf[:store.lengths[k]]
                store.load_piece(k, view)
                view.add_(1.0)
                store.save_piece(k, view)
                store.write_saved()
            store.end_walk()
    finally:
        sys.setswitchinterval(interval)
    got = store.read_into(torch.empty(store.numel), 0)
    assert torch.equal(got, torch.full((store.numel,), float(rounds)))
    store.close()
    sw.close()


# --------------------------------------------------------------------------- #
# the knobs reach the pools; the swap path is checked
# --------------------------------------------------------------------------- #
AIO = {"block_size": 4096, "queue_depth": 3, "thread_count": 3, "single_submit": True,
       "overlap_events": False, "use_o_direct": True}


def simple_engine(zero, **extra):
    model = SimpleModel(hidden_dim=16, device="cpu")
    return dst.initialize(model=model, device="cpu", config=dict(
        {"train_batch_size": 8, "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
         "zero_optimization": zero}, **extra))[0]


def test_offload_optimizer_config_honored(tmp_path):
    oc = {"device": "nvme", "nvme_path": str(tmp_path), "pipeline_write": True,
          "buffer_count": 3, "max_in_cpu": 1 << 20}
    eng = simple_engine({"stage": 1, "offload_optimizer": oc}, aio=AIO)
    sw = eng.optimizer_swapper
    pool = sw._swapper.pool
    assert sw.pipeline_write is True and sw.aio_config == AIO
    assert pool.folder == str(tmp_path / "optimizer")
    assert pool._bounce.buffer_size == 4096 and pool._bounce.budget == 3 * 4096
    assert len(pool._workers) == 3 and pool._depth._value == 3
    assert sw.store.max_in_cpu == 1 << 20
    eng.close()
    # the JAX engine's defaults: synchronous write-back, max_in_cpu 0
    eng = simple_engine({"stage": 1, "offload_optimizer": {"device": "nvme",
                                                            "nvme_path": str(tmp_path)}})
    sw = eng.optimizer_swapper
    assert sw.pipeline_write is False and sw.store.max_in_cpu == 0
    assert sw._swapper.pool._bounce.budget == 4 * (1 << 20)      # buffer_count 4
    eng.close()


def test_offload_param_config_honored(tmp_path):
    from deepspeed_tpu_torch.models.gpt import GPT, gpt_config
    pc = {"device": "nvme", "nvme_path": str(tmp_path), "buffer_count": 6,
          "max_in_cpu": 12345}
    eng = dst.initialize(model=GPT(gpt_config("tiny", dtype="float32"), device="cpu"),
                         device="cpu", config={
                             "train_micro_batch_size_per_gpu": 1, "aio": AIO,
                             "zero_optimization": {"stage": 3, "offload_param": pc}})[0]
    sw = eng.param_swapper
    assert sw.swap_folder == str(tmp_path / "params") and sw.aio_config == AIO
    assert sw.store.max_in_cpu == 12345 and sw.pool._bounce.budget == 6 * 4096
    assert eng.optimizer_swapper is None and eng.zero.master.host
    eng.close()
    assert sorted(os.listdir(tmp_path / "params"))[:2] == [
        "STAGING_MANIFEST.json", "param__blocks__0__fc_b.chunk"]


@pytest.mark.parametrize("fault", ["not-a-directory", "in-memory", "too-small"])
def test_swap_path_that_cannot_hold_the_tier_raises(tmp_path, monkeypatch, fault):
    path = tmp_path / "swap"
    if fault == "not-a-directory":
        path.write_text("a file")
        match = "cannot be made"
    elif fault == "in-memory":
        monkeypatch.setattr(tpps, "filesystem_type", lambda p: "tmpfs")
        match = "on tmpfs"
    else:
        usage = shutil.disk_usage(tmp_path)
        monkeypatch.setattr(tpps.shutil, "disk_usage",
                            lambda p: usage._replace(free=1000))
        match = "bytes of room"
    with pytest.raises(tpps.SwapPathError, match=match):
        simple_engine({"stage": 0, "offload_optimizer": {"device": "nvme",
                                                         "nvme_path": str(path)}})


def test_filesystem_type_reads_the_longest_mount():
    assert tpps.filesystem_type("/proc/self") == "proc"
    assert tpps.filesystem_type("/") != "unknown"
