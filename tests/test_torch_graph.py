"""The graphed train step (``runtime/step_graph.py``) and the storage it
holds pointers to, on the CPU with a stand-in graph, and on the card.

* ``FusedAdam.step`` and ``load_state_dict`` keep ``count``'s storage; a
  checkpoint load keeps every parameter's, moment's and gradient view's
  ``data_ptr()``.
* The launch counters: a capture counts nothing, each replay adds what
  the capture's calls added, and a failed capture raises with its cause
  and leaves the counters as they were.  The warm-up's cached blocks are
  freed before the capture; a capture holds the cached device buffers
  its kernels read, and dropping it frees them.
* On the CPU ``train_batch`` runs the graphed step's body, bit for bit
  the ``forward`` / ``backward`` / ``step`` trajectory.
* The engine's graphed path, driven on the CPU through a stand-in
  accelerator whose capture undoes what the step did to the engine (a
  capture launches nothing) and whose replay runs the captured step again
  into the static outputs: one capture per batch signature, distinct
  returned losses, the eager trajectory bit for bit, and a load into the
  graphed engine that the next replay trains on with no new capture.
* ``cuda``-marked: the same against the real graph on the card.
"""

import contextlib

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.models.gpt import GPT, GPTConfig
from deepspeed_tpu_torch.ops.cuda import cross_entropy as tce
from deepspeed_tpu_torch.ops.cuda import flash_attention as tfa
from deepspeed_tpu_torch.ops.cuda import fused_optim as tfo
from deepspeed_tpu_torch.runtime import step_graph
from deepspeed_tpu_torch.runtime.optimizers import FusedAdam
from deepspeed_tpu_torch.runtime.step_graph import StepGraphs

DIMS = dict(vocab_size=300, n_positions=64, n_embd=32, n_layer=2, n_head=4)
GAS, MICRO, SEQ = 2, 2, 16


def engine_config(**extra):
    return dict({"train_micro_batch_size_per_gpu": MICRO, "gradient_accumulation_steps": GAS,
                 "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
                 "scheduler": {"type": "WarmupLR", "params": {
                     "warmup_num_steps": 4, "warmup_max_lr": 1e-3, "warmup_type": "linear"}},
                 "gradient_clipping": 1.0, "steps_per_print": 10 ** 9}, **extra)


def make_engine(device="cpu", dtype="float32", seed=0, remat=True):
    model = GPT(GPTConfig(dtype=dtype, remat=remat, **DIMS), device=device, seed=seed)
    return dst.initialize(model=model, config=engine_config(), device=device)[0]


def batches(n, seed=0, vocab=DIMS["vocab_size"]):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, (GAS, MICRO, SEQ)).astype(np.int32)
        out.append((ids, np.roll(ids, -1, axis=-1)))
    return out


def storage(engine):
    """Every tensor a captured step holds a pointer to."""
    opt = engine.optimizer
    return (list(engine._leaves) + list(engine._grads) + [p.grad for p in engine._leaves]
            + opt.mu + opt.nu + [opt.count] + list(engine.scaler))


def pointers(engine):
    return [t.data_ptr() for t in storage(engine)]


# --------------------------------------------------------------------------- #
# in-place state
# --------------------------------------------------------------------------- #
def test_fused_adam_step_keeps_the_count_storage():
    p = [torch.ones(8), torch.ones(3)]
    g = [torch.full((8,), 0.5), torch.full((3,), -0.25)]
    opt = FusedAdam(p, g, {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "wd": 0.0, "lr": 1e-2})
    ptr = opt.count.data_ptr()
    for n in range(1, 4):
        opt.step(torch.tensor(1.0), torch.tensor(1.0))
        assert opt.count.data_ptr() == ptr and int(opt.count) == n
    assert opt.count.dtype == torch.int32 and opt.count.shape == ()


def test_fused_adam_load_state_dict_copies_count_and_moments_in_place():
    p = [torch.ones(8), torch.ones(3)]
    g = [torch.zeros(8), torch.zeros(3)]
    opt = FusedAdam(p, g, {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "wd": 0.0, "lr": 1e-2},
                    names=["a", "b"])
    before = [t.data_ptr() for t in opt.mu + opt.nu + [opt.count]]
    opt.load_state_dict({"mu": {"a": torch.full((8,), 2.0), "b": torch.full((3,), 3.0)},
                         "nu": {"a": torch.full((8,), 4.0), "b": torch.full((3,), 5.0)},
                         "count": 7})
    assert [t.data_ptr() for t in opt.mu + opt.nu + [opt.count]] == before
    assert int(opt.count) == 7 and opt.count.dtype == torch.int32
    assert float(opt.mu[1][0]) == 3.0 and float(opt.nu[0][0]) == 4.0
    # the kernel's table still holds the moments it was built over
    assert opt.table.leaves[2][0] is opt.mu[0] and opt.table.leaves[3][1] is opt.nu[1]


def test_load_checkpoint_keeps_every_pointer(tmp_path):
    src = make_engine(seed=1)
    for b in batches(2, seed=3):
        src.train_batch(batch=b)
    src.save_checkpoint(str(tmp_path))
    dst_engine = make_engine(seed=2)
    before = pointers(dst_engine)
    path, _ = dst_engine.load_checkpoint(str(tmp_path))
    assert path is not None
    assert pointers(dst_engine) == before
    for a, b in zip(src._leaves, dst_engine._leaves):
        assert torch.equal(a, b)
    assert int(dst_engine.optimizer.count) == 2
    for p, g in zip(dst_engine._leaves, dst_engine._grads):
        assert p.grad.data_ptr() == g.data_ptr()


# --------------------------------------------------------------------------- #
# launch counters on a stand-in graph
# --------------------------------------------------------------------------- #
class StandInGraph:
    def __init__(self):
        self.replays = 0


class CounterAccelerator:
    """Streams and graphs that do nothing: what the step graphs see of a
    device whose capture launches nothing and whose replay calls nothing."""

    def Stream(self, **_):
        return None

    def stream(self, _):
        return contextlib.nullcontext()

    def current_stream(self, _=None):
        return None

    def create_graph(self):
        return StandInGraph()

    def empty_cache(self):
        pass

    def capture_to_graph(self, graph, **_):
        return contextlib.nullcontext()

    def replay_graph(self, graph):
        graph.replays += 1


@pytest.fixture
def clean_counts():
    for mod in (tfa, tce, tfo):
        mod.reset_counts()
    yield
    for mod in (tfa, tce, tfo):
        mod.reset_counts()


def fake_step(inputs):
    """Calls standing in for wrappers: what each call adds to a counter."""
    tfa.flash_forward.launches += 3
    tce.ce_forward.launches += 1
    tfo.adam_reference.calls += 1
    return (inputs[0].float().sum(),)


def counts():
    return (tfa.flash_forward.launches, tce.ce_forward.launches, tfo.adam_reference.calls)


def test_capture_counts_nothing_and_each_replay_adds_the_capture_increase(clean_counts):
    graphs = StepGraphs(CounterAccelerator(), torch.device("cpu"))
    x = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    out = graphs.run([x], fake_step)            # warm-up (real calls) + capture
    assert counts() == (3, 1, 1) and graphs.captures == 1 and graphs.replays == 0
    assert float(out[0]) == 15.0
    step = graphs.steps[step_graph.signature([x])]
    assert step.increase[[fn for fn, _ in step.counters].index(tfa.flash_forward)] == 3
    for n in range(1, 4):
        static = graphs.run([x + n], fake_step)
        assert counts() == (3 + 3 * n, 1 + n, 1 + n)
        assert step.graph.replays == n and graphs.replays == n and graphs.captures == 1
        assert static is step.outputs           # the replay's outputs are the static ones
        assert torch.equal(step.inputs[0], x + n)   # the batch went into the static buffer


def test_a_new_signature_gets_its_own_capture(clean_counts):
    graphs = StepGraphs(CounterAccelerator(), torch.device("cpu"))
    graphs.run([torch.zeros(2, 3, dtype=torch.int32)], fake_step)
    graphs.run([torch.zeros(2, 4, dtype=torch.int32)], fake_step)
    graphs.run([[torch.zeros(3, dtype=torch.int32), torch.ones(3, dtype=torch.int32)]],
               fake_step)                       # GAS micro-batches: the [2, 3] capture
    assert graphs.captures == 2 and graphs.replays == 1
    assert torch.equal(graphs.steps[(((2, 3), torch.int32),)].inputs[0][1],
                       torch.ones(3, dtype=torch.int32))


def test_a_failed_capture_raises_with_its_cause_and_counts_nothing(clean_counts):
    class Failing(CounterAccelerator):
        @contextlib.contextmanager
        def capture_to_graph(self, graph, **_):
            yield
            raise RuntimeError("operation not permitted when stream is capturing")

    graphs = StepGraphs(Failing(), torch.device("cpu"))
    with pytest.raises(RuntimeError, match="capturing the train step.*not permitted"):
        graphs.run([torch.zeros(2, 3)], fake_step)
    assert counts() == (3, 1, 1) and graphs.captures == 0 and not graphs.steps


def test_the_warm_up_cache_is_emptied_before_the_capture():
    events = []

    class Recording(CounterAccelerator):
        def empty_cache(self):
            events.append("empty_cache")

        def capture_to_graph(self, graph, **_):
            events.append("capture")
            return contextlib.nullcontext()

    def step(inputs):
        events.append("body")
        return (inputs[0].sum(),)

    graphs = StepGraphs(Recording(), torch.device("cpu"))
    graphs.run([torch.ones(2, 3)], step)
    graphs.run([torch.ones(2, 3)], step)
    assert events == ["body", "empty_cache", "capture", "body"]


def test_a_capture_holds_the_cached_buffers_its_kernels_read(clean_counts):
    import weakref
    from deepspeed_tpu_torch.ops.cuda import capture

    cached = {"table": torch.arange(4)}

    def step(inputs):
        capture.hold(cached["table"])               # as a wrapper hands out a cached table
        capture.hold(cached["table"])
        return (inputs[0].sum(),)

    graphs = StepGraphs(CounterAccelerator(), torch.device("cpu"))
    graphs.run([torch.ones(2, 3)], step)
    held = next(iter(graphs.steps.values())).held
    assert len(held) == 1 and held[0] is cached["table"]
    del held
    ref = weakref.ref(cached.pop("table"))          # the cache evicts it: the capture keeps it
    assert ref() is not None
    graphs.clear()                                  # dropping the capture frees it
    assert ref() is None
    assert capture.hold("outside a capture") == "outside a capture"


def test_the_kernel_caches_are_bounded_and_held_by_a_capture():
    from deepspeed_tpu_torch.ops.cuda import block_sparse_attention as tbs
    from deepspeed_tpu_torch.ops.cuda import capture

    for cached in (tbs._device_luts_cached, tbs._fwd_work_cached, tbs._dkv_work_cached):
        assert cached.cache_info().maxsize is not None
    layout = np.tril(np.ones((2, 4, 4), np.int32))
    with capture.holding() as held:
        luts = tbs.device_luts(layout, "cpu")
        work = tbs.fwd_work(layout, True, "cpu")
        counters = tce._fwd_counters(torch.device("cpu"), 8)
    assert {id(luts), id(work), id(counters)} == set(held)
    assert tce._fwd_counters(torch.device("cpu"), 8) is counters


def test_launch_counters_find_every_wrapper_and_plain_version_once():
    found = {(fn.__name__, attr) for fn, attr in step_graph.launch_counters()}
    for name in ("flash_forward", "flash_backward_dq", "flash_backward_dkv", "ce_forward",
                 "ce_backward_dx", "ce_backward_dhead", "fused_adam", "block_sparse_forward",
                 "block_sparse_backward_dq", "block_sparse_backward_dkv", "paged_attention",
                 "decode_attention"):
        assert (name, "launches") in found and (name + "_reference", "calls") in found \
            or (name == "fused_adam" and ("adam_reference", "calls") in found)
    assert len(found) == len(step_graph.launch_counters()) == 24


# --------------------------------------------------------------------------- #
# the engine's graphed path on the CPU, through a stand-in graph
# --------------------------------------------------------------------------- #
class EmulatedAccelerator(CounterAccelerator):
    """A capture that undoes what the step did to the engine's storage (a
    capture launches nothing) and a replay that runs the captured step
    again into the static outputs, calling nothing as far as the counters
    see."""

    def __init__(self, engine):
        self.engine = engine

    @contextlib.contextmanager
    def capture_to_graph(self, graph, **_):
        saved = [t.clone() for t in storage(self.engine)]
        yield
        with torch.no_grad():
            for t, s in zip(storage(self.engine), saved):
                t.copy_(s)

    def replay_graph(self, graph):
        super().replay_graph(graph)
        step = next(s for s in self.engine.graphs.steps.values() if s.graph is graph)
        counters = step_graph.launch_counters()
        before = step_graph.read_counters(counters)
        outputs = self.engine._graph_step(step.inputs)
        step_graph.add_counters(counters, [b - a for a, b in
                                           zip(step_graph.read_counters(counters), before)])
        for static, out in zip(step.outputs, outputs):
            static.copy_(out)


def graphed(engine):
    engine.graphs = StepGraphs(EmulatedAccelerator(engine), engine.device,
                               engine._static_dtype)
    return engine


def test_graphed_train_batch_returns_distinct_losses_and_captures_once():
    engine = graphed(make_engine())
    losses = [engine.train_batch(batch=b) for b in batches(4, seed=9)]
    assert engine.graphs.captures == 1 and engine.graphs.replays == 3
    assert len({id(t) for t in losses}) == 4 and len({t.data_ptr() for t in losses}) == 4
    static = next(iter(engine.graphs.steps.values())).outputs[0]
    assert all(t.data_ptr() != static.data_ptr() for t in losses)
    assert len({float(t) for t in losses}) == 4       # each keeps its own step's value
    assert engine.global_steps == 4 and engine.micro_steps == 4 * GAS
    assert int(engine.optimizer.count) == 4 and engine.lr_scheduler.last_batch_iteration == 3


def micro_step_api(engine, batch):
    """One optimizer step through ``forward`` / ``backward`` / ``step``;
    the mean loss."""
    total = None
    for i in range(GAS):
        loss = engine.backward(engine.forward(batch[0][i], batch[1][i])).detach()
        engine.step()
        total = loss if total is None else total + loss
    return total / GAS


def test_graphed_train_batch_equals_eager_bitwise():
    eager, graph = make_engine(seed=4), graphed(make_engine(seed=4))
    for b in batches(3, seed=5):
        assert torch.equal(micro_step_api(eager, b), graph.train_batch(batch=b))
        assert eager.get_global_grad_norm() == graph.get_global_grad_norm()
    for a, b in zip(eager._leaves, graph._leaves):
        assert torch.equal(a, b)
    for a, b in zip(eager.optimizer.mu + eager.optimizer.nu, graph.optimizer.mu + graph.optimizer.nu):
        assert torch.equal(a, b)


def test_cpu_train_batch_runs_the_graphed_body_and_equals_the_micro_step_api():
    api, cpu = make_engine(seed=6), make_engine(seed=6)
    assert cpu.graphs is None
    bodies = []
    body = cpu._graph_step
    cpu._graph_step = lambda leaves: bodies.append(len(leaves)) or body(leaves)
    for b in batches(3, seed=8):
        assert torch.equal(micro_step_api(api, b), cpu.train_batch(batch=b))
        assert api.get_global_grad_norm() == cpu.get_global_grad_norm()
    assert bodies == [2, 2, 2]
    for a, b in zip(api._leaves, cpu._leaves):
        assert torch.equal(a, b)
    assert (api.global_steps, api.micro_steps, int(api.optimizer.count)) == (
        cpu.global_steps, cpu.micro_steps, int(cpu.optimizer.count)) == (3, 3 * GAS, 3)
    assert api.lr_scheduler.state_dict() == cpu.lr_scheduler.state_dict()


def test_train_batch_in_eval_mode_raises_on_every_path():
    for engine in (make_engine(), graphed(make_engine())):
        engine.eval()
        with pytest.raises(RuntimeError, match="eval mode"):
            engine.train_batch(batch=batches(1)[0])
        assert engine.global_steps == 0


def test_graphed_data_iter_fills_the_same_static_buffers():
    engine = graphed(make_engine())
    bs = batches(3, seed=6)
    engine.train_batch(batch=bs[0])
    micro = iter([(ids[i], labels[i]) for ids, labels in bs[1:] for i in range(GAS)])
    for ids, labels in bs[1:]:
        engine.train_batch(data_iter=micro)
        step = next(iter(engine.graphs.steps.values()))
        assert torch.equal(step.inputs[0], torch.from_numpy(ids))
    assert engine.graphs.captures == 1 and engine.graphs.replays == 2


def test_load_into_a_graphed_engine_replays_on_the_restored_state(tmp_path):
    bs = batches(6, seed=11)
    ref = make_engine(seed=3)
    want = [float(ref.train_batch(batch=b)) for b in bs]
    engine = graphed(make_engine(seed=3))
    got = [float(engine.train_batch(batch=b)) for b in bs[:3]]
    engine.save_checkpoint(str(tmp_path))
    for b in bs[3:5]:                            # wander off, then come back
        engine.train_batch(batch=b)
    before = pointers(engine)
    engine.load_checkpoint(str(tmp_path))
    assert pointers(engine) == before and engine.global_steps == 3
    got += [float(engine.train_batch(batch=b)) for b in bs[3:]]
    assert engine.graphs.captures == 1
    assert got == want
    for a, b in zip(ref._leaves, engine._leaves):
        assert torch.equal(a, b)


def test_close_drops_the_captures():
    engine = graphed(make_engine())
    engine.train_batch(batch=batches(1)[0])
    assert engine.graphs.steps
    engine.close()
    engine.close()
    assert not engine.graphs.steps and engine.get_global_grad_norm() > 0


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
def cuda_engine(seed, dtype="float32"):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dims = dict(DIMS, vocab_size=512, n_embd=128, n_head=2)     # head_dim 64 for the kernels
    model = GPT(GPTConfig(dtype=dtype, remat=True, **dims), device="cuda", seed=seed)
    return dst.initialize(model=model, config=engine_config(), device="cuda")[0]


@pytest.mark.cuda
def test_cuda_graphed_train_batch_equals_eager_micro_steps():
    graph, eager = cuda_engine(7), cuda_engine(7)
    for b in batches(4, seed=12, vocab=512):
        got = graph.train_batch(batch=b)
        losses = []
        for i in range(GAS):
            loss = eager.forward(b[0][i], b[1][i])
            eager.backward(loss)
            eager.step()
            losses.append(loss.detach())
        want = (losses[0] + losses[1]) / GAS
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    assert graph.graphs.captures == 1 and graph.graphs.replays == 3
    for a, b in zip(graph._leaves, eager._leaves):
        torch.testing.assert_close(a, b, rtol=0, atol=3e-5)


@pytest.mark.cuda
def test_cuda_load_into_a_graphed_engine_needs_no_new_capture(tmp_path):
    bs = batches(6, seed=13, vocab=512)
    engine = cuda_engine(8)
    first = [float(engine.train_batch(batch=b)) for b in bs[:3]]
    engine.save_checkpoint(str(tmp_path))
    after = [float(engine.train_batch(batch=b)) for b in bs[3:]]
    before = pointers(engine)
    engine.load_checkpoint(str(tmp_path))
    again = [float(engine.train_batch(batch=b)) for b in bs[3:]]
    assert pointers(engine) == before and engine.graphs.captures == 1
    assert again == after and len(first) == 3
    engine.close()
