"""Tiered KV of the port (``deepspeed_tpu_torch/runtime/offload/{staging,
store}.py``, ``serving/kv_tiering.py``) against ``deepspeed_tpu``'s, on the
CPU.

* The staging pool and the tiered store round-trip fp32, bf16 and int8
  tensors bit for bit; a flipped byte in a chunk file raises
  ``StagingError``; the host LRU drops to the chunk tier past its budget,
  key for key as JAX's store does.
* A chunk folder written by either package's pool is read by the other's
  with equal bytes (same files, same manifest).
* ``KVTieringManager`` spills and restages arena blocks bit for bit, as
  JAX's manager does on the same arena, with epoch keys: a superseded or
  restaged key never comes back.
* The serving engines of both packages serve the same prompts under arena
  pressure with ``kv_tiering`` (and the prefix cache; a zero spill budget
  falls back to recompute) with equal tokens and equal preemption, spill
  and restage counts (``tests/unit/serving/test_tiering_e2e.py``'s two
  cases, on both packages).

The copies' stream ordering on the card is held by
``tests/test_torch_resilience_cuda.py``.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu_torch as dst
from deepspeed_tpu.runtime.offload import StagingError as JStagingError
from deepspeed_tpu.runtime.offload import StagingPool as JStagingPool
from deepspeed_tpu.runtime.offload import TieredStore as JTieredStore
from deepspeed_tpu.serving import DeepSpeedServingConfig as JServingConfig
from deepspeed_tpu.serving import ServingEngine as JServingEngine
from deepspeed_tpu.serving.kv_tiering import KVTieringManager as JKVTieringManager
from deepspeed_tpu_torch.runtime.offload import (TIER_HOST, TIER_NVME, StagingError,
                                                 StagingPool, TieredStore, staging)
from deepspeed_tpu_torch.serving.kv_tiering import KVTieringManager
from deepspeed_tpu_torch.testing.fault_injection import bitflip_file
from tests.torch_serving_common import counts, drive, prompts_of, settle_io, tiny_models

DTYPES = {"float32": (torch.float32, np.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "int8": (torch.int8, np.int8)}


def tensor_of(dtype: str, shape=(3, 5, 7), seed: int = 0) -> torch.Tensor:
    x = np.random.default_rng(seed).normal(0, 40.0, shape).astype(np.float32)
    return torch.from_numpy(x).to(DTYPES[dtype][0])


def raw(x) -> bytes:
    """The bytes of a torch tensor or a numpy array (ml_dtypes bf16 too)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8).tobytes()


# --------------------------------------------------------------------------- #
# staging pool and tiered store
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_staging_and_store_round_trip(dtype, tmp_path, monkeypatch):
    t = tensor_of(dtype)
    monkeypatch.setattr(staging, "BUFFER_SIZE", 64)         # many bounce chunks
    pool = StagingPool(str(tmp_path))
    try:
        pool.write("kvseq/1/1", t).result()
        for back in (pool.read("kvseq/1/1").result(), pool.read_sync("kvseq/1/1")):
            assert back.dtype == t.dtype and back.shape == t.shape
            assert raw(back) == raw(t)
        info = pool.chunk_info("kvseq/1/1")
        assert info["dtype"] == dtype and info["shape"] == [3, 5, 7]
        store = TieredStore(pool, max_in_cpu=0)      # every read from the chunk tier
        store.put("a", t)
        store.drain()
        assert store.residency("a") == (TIER_NVME,)
        assert raw(store.get("a")) == raw(t)
        scalar = tensor_of(dtype, shape=())
        store.put("s", scalar)
        store.drain()
        back = store.staging.read_sync("s")
        assert back.shape == () and raw(back) == raw(scalar)
        with pytest.raises(StagingError, match="host tensors"):
            pool.write("meta", torch.empty(2, device="meta"))
    finally:
        pool.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_chunk_folders_cross_both_ways(writer, dtype, tmp_path):
    """One package's pool writes a folder (chunks and the fsync'd
    manifest); a fresh pool of the other reads every chunk with equal
    bytes, dtype and shape."""
    t = tensor_of(dtype, shape=(4, 3, 2, 5), seed=1)
    arr = np.asarray(jnp.asarray(t.float().numpy(), DTYPES[dtype][1]))
    assert raw(arr) == raw(t)
    make, read = ((JStagingPool, StagingPool) if writer == "jax" else
                  (StagingPool, JStagingPool))
    pool = make(str(tmp_path))
    pool.write("kvseq/7/3", arr if writer == "jax" else t).result()
    pool.sync_manifest()
    pool.close()
    other = read(str(tmp_path))
    try:
        back = other.read_sync("kvseq/7/3")
        assert raw(back) == raw(t)
        assert tuple(back.shape) == tuple(t.shape)
        assert str(back.dtype).removeprefix("torch.") == dtype
    finally:
        other.close()


def test_crc_mismatch_raises_staging_error_in_both(tmp_path):
    pool = StagingPool(str(tmp_path))
    pool.write("k", tensor_of("float32")).result()
    pool.sync_manifest()
    chunk = os.path.join(str(tmp_path), "k.chunk")
    bitflip_file(chunk)
    with pytest.raises(StagingError, match="CRC mismatch"):
        pool.read_sync("k")
    with pytest.raises(StagingError, match="CRC mismatch"):
        pool.read("k").result()
    pool.close()
    jpool = JStagingPool(str(tmp_path))
    with pytest.raises(JStagingError, match="CRC mismatch"):
        jpool.read_sync("k")
    jpool.close()


def test_host_lru_spills_to_disk_key_for_key_with_jax(tmp_path):
    """A host budget of two tensors: the oldest durable copies leave the
    LRU for the chunk tier, in the same order in both stores; every key
    still reads back its own bytes."""
    ts = [tensor_of("float32", shape=(16, 16), seed=i) for i in range(5)]
    nbytes = ts[0].numel() * 4
    pool, jpool = StagingPool(str(tmp_path / "port")), JStagingPool(str(tmp_path / "jax"))
    store = TieredStore(pool, max_in_cpu=2 * nbytes)
    jstore = JTieredStore(jpool, max_in_cpu=2 * nbytes)
    try:
        for i, t in enumerate(ts):
            store.put(f"k{i}", t)
            jstore.put(f"k{i}", t.numpy())
        store.drain()
        jstore.drain()
        assert store.host_bytes() <= 2 * nbytes
        for i in range(5):
            assert store.residency(f"k{i}") == jstore.residency(f"k{i}")
        assert store.residency("k0") == (TIER_NVME,)
        assert store.residency("k4") == (TIER_HOST, TIER_NVME)
        for i, t in enumerate(ts):
            assert raw(store.get(f"k{i}")) == raw(t)
        store.remove("k1")
        assert store.residency("k1") == () and "k1" not in pool.keys()
    finally:
        pool.close()
        jpool.close()


# --------------------------------------------------------------------------- #
# the KV tiering manager
# --------------------------------------------------------------------------- #
def arena(dtype: str, L=2, NB=12, BS=4, H=2, D=8, seed=3):
    k = tensor_of(dtype, (L, NB, BS, H, D), seed)
    v = tensor_of(dtype, (L, NB, BS, H, D), seed + 1)
    return k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_manager_spill_restage_bitwise_with_epoch_keys(dtype, tmp_path):
    """Spills to the host tier and, past the host budget, to disk; every
    restage scatters the spilled bytes exactly; JAX's manager on the same
    arena lands in the same tiers and restores the same arena."""
    kp, vp = arena(dtype)
    block = 2 * kp.shape[0] * kp[0, 0].numel() * kp.element_size()     # K and V, all layers
    mgr = KVTieringManager(str(tmp_path / "port"), host_cache_bytes=3 * block)
    jk, jv = (jnp.asarray(np.asarray(jnp.asarray(t.float().numpy(), DTYPES[dtype][1])))
              for t in (kp, vp))
    jmgr = JKVTieringManager(str(tmp_path / "jax"), host_cache_bytes=3 * block,
                             spill_chunk_blocks=2, ring_depth=2)
    try:
        want = {1: [3, 5, 7], 2: [1, 2, 4, 6, 8]}
        saved = {rid: (kp[:, b].clone(), vp[:, b].clone()) for rid, b in want.items()}
        tiers = [mgr.spill(rid, b, kp, vp, tokens=4 * len(b)) for rid, b in want.items()]
        jtiers = [jmgr.spill(rid, b, jk, jv, tokens=4 * len(b)) for rid, b in want.items()]
        assert tiers == jtiers == [TIER_HOST, TIER_NVME]
        assert mgr.chunk_bytes(kp, 3) == jmgr.chunk_bytes(jk, 3) == 3 * block
        # respill of rid 1 under a new epoch drops the old key everywhere
        old_key = "kvseq/1/1"
        assert mgr.store.residency(old_key)
        mgr.spill(1, want[1], kp, vp, tokens=12)
        jmgr.spill(1, want[1], jk, jv, tokens=12)
        assert mgr.store.residency(old_key) == () and old_key not in mgr.staging.keys()
        # wipe the arena, restage into other blocks
        kp.zero_()
        vp.zero_()
        jk, jv = jnp.zeros_like(jk), jnp.zeros_like(jv)
        dests = {1: [9, 10, 11], 2: [1, 3, 5, 7, 2]}
        for rid, dest in dests.items():
            mgr.begin_restage(rid)
            jmgr.begin_restage(rid)
            kp, vp, info = mgr.restage(rid, kp, vp, dest)
            jk, jv, jinfo = jmgr.restage(rid, jk, jv, dest)
            for key in ("source", "bytes", "blocks", "tokens"):
                assert info[key] == jinfo[key], key
            assert raw(kp[:, dest]) == raw(saved[rid][0])
            assert raw(vp[:, dest]) == raw(saved[rid][1])
            with pytest.raises(KeyError):
                mgr.restage(rid, kp, vp, dest)
        assert raw(kp) == raw(np.asarray(jk)) and raw(vp) == raw(np.asarray(jv))
        assert mgr.restage_sources == {TIER_HOST: 1, TIER_NVME: 1}
        assert mgr.staging.keys() == [] and mgr.store.host_bytes() == 0
        st, jst = mgr.stats(), jmgr.stats()
        for key in ("kv_spilled_seqs", "kv_spilled_bytes", "kv_spills", "kv_restages"):
            assert st[key] == jst[key], key
        # a discarded spill never resurfaces
        mgr.spill(5, [2, 3], kp, vp, tokens=6)
        assert mgr.discard(5) and not mgr.discard(5)
        assert not mgr.is_spilled(5) and mgr.staging.keys() == []
        assert mgr.spill(6, [], kp, vp, tokens=0) is None
    finally:
        mgr.close()
        jmgr.close()


def test_manager_spill_budget_and_owned_tempdir():
    kp, vp = arena("float32")
    mgr = KVTieringManager(spill_budget_bytes=1)
    folder = mgr.offload_dir
    assert os.path.isdir(folder)
    assert mgr.spill(1, [1, 2], kp, vp, tokens=5) is None
    mgr.close()
    mgr.close()
    assert not os.path.exists(folder)


# --------------------------------------------------------------------------- #
# the serving engines, both packages
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def models():
    return tiny_models(seed=0)


def serve_both(models, serving, prompts, mnts, first):
    jmodel, jparams, port = models
    jeng = JServingEngine(jmodel, config=JServingConfig(**serving), params=jparams)
    teng = dst.init_serving(model=port, config={"serving": serving}, device="cpu")
    for eng in (jeng, teng):
        settle_io(eng)
    try:
        jfuts = drive(jeng, prompts, mnts, first)
        tfuts = drive(teng, prompts, mnts, first)
        return jfuts, tfuts, counts(jeng), counts(teng), teng
    finally:
        jeng.close()
        teng.close()


def test_tiered_spill_restage_prefix_matches_jax_engine(models, tmp_path):
    """test_tiering_e2e.py's acceptance case on both packages: an arena a
    fraction of the working set, a host cache smaller than one block (every
    spill goes to disk), a shared system prompt in the prefix cache."""
    _, _, port = models
    rng = np.random.default_rng(7)
    system = [int(t) for t in rng.integers(1, 128, size=32)]
    prompts = [system + [int(t) for t in rng.integers(1, 128, size=n)]
               for n in (3, 7, 5, 9, 4, 6)]
    mnts = [12, 10, 14, 8, 12, 10]
    serving = dict(block_size=4, num_blocks=15, max_batch_size=4, prefill_chunk=8,
                   max_blocks_per_seq=16, dtype="float32", kv_tiering=True,
                   kv_host_cache_bytes=1024, prefix_cache=True)
    jfuts, tfuts, jc, tc, teng = serve_both(models, dict(serving, kv_offload_dir=str(
        tmp_path / "kv")), prompts, mnts, first=3)
    for i, (p, m, jf, tf) in enumerate(zip(prompts, mnts, jfuts, tfuts)):
        assert tf.token_ids == jf.token_ids, i
        assert tf.token_ids == port.generate([p], m)[0, len(p):].tolist(), i
    assert tc == jc
    assert tc["spills"] >= 1 and tc["restages"] >= 1
    assert teng.tiering.restage_sources[TIER_NVME] >= 1, "a full disk round trip"
    assert teng.prefix.hits >= 1
    teng.alloc.check_consistent()


def test_zero_spill_budget_falls_back_to_recompute_as_jax(models):
    _, _, port = models
    prompts = prompts_of(9, (10, 14, 6, 12, 9, 16))
    mnts = [20, 16, 24, 12, 18, 14]
    serving = dict(block_size=4, num_blocks=10, max_batch_size=4, prefill_chunk=8,
                   max_blocks_per_seq=9, dtype="float32", kv_tiering=True,
                   kv_spill_budget_bytes=1)
    jfuts, tfuts, jc, tc, teng = serve_both(models, serving, prompts, mnts, first=6)
    for p, m, jf, tf in zip(prompts, mnts, jfuts, tfuts):
        assert tf.token_ids == jf.token_ids
        assert tf.token_ids == port.generate([p], m)[0, len(p):].tolist()
    assert tc == jc and tc["preemptions"] > 0 and tc["spills"] == 0
    assert not os.path.exists(teng.tiering.offload_dir), "close() removes the owned tempdir"
