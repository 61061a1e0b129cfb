"""Continuous-batching serving engine over the paged KV arena (counterpart
of ``deepspeed_tpu/serving/engine.py``).

Requests join and leave the decode batch every step.  Each step runs at
most two dispatches of one step function, each an eager call of
``model.paged_step`` plus the greedy argmax under the padded-vocab mask:

* **prefill**: ``[1, prefill_chunk]`` tokens — one prompt chunk per step
  (chunked prefill), so a long prompt never stalls the decode batch for
  more than one chunk's latency;
* **decode**: ``[max_batch_size, 1]`` tokens over the arena — every active
  sequence advances one token; idle slots carry trash-block write
  coordinates and all-trash block tables.

Block tables, positions and write maps are int32 tensors built by the host
:class:`PagedKVAllocator` / :class:`ServingScheduler`; the arena is updated
in place.  The e2e contract: greedy outputs are token-identical to
sequential ``generate()``, even across preempt -> evict -> recompute cycles,
because recompute re-prefills a prefix of the identical deterministic
stream.

Ported: ``submit``/``step``/``run``/``close``, ``snapshot``/``restore``,
deadline expiry, the admission ladder (queue-age signal) and the prefix
cache.  Not ported yet, and refused when asked for: tiered KV
(``kv_tiering``), bounded dispatch (``serve_step_timeout_s > 0``), a
telemetry hub and a tracer (ROADMAP.md, Queue 1).  Fault injection has no
hook here.
"""

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import resolve_device
from deepspeed_tpu_torch.models.gpt import model_in
from deepspeed_tpu_torch.ops.cuda.decode_attention import (KERNEL_HEAD_DIMS,
                                                           KERNEL_TILE)
from deepspeed_tpu_torch.serving.config import DeepSpeedServingConfig
from deepspeed_tpu_torch.serving.kv_cache import (ArenaExhausted,
                                                  PagedKVAllocator, init_arena)
from deepspeed_tpu_torch.serving.prefix_cache import PrefixCache
from deepspeed_tpu_torch.serving.scheduler import (DECODE, EXPIRED, FINISHED,
                                                   SLO_PRIORITY,
                                                   AdmissionController,
                                                   DeadlineExceeded, Request,
                                                   ServingScheduler, ShedError)
from deepspeed_tpu_torch.utils.logging import log_dist

_LATER = "ROADMAP.md, Queue 1: serving features"


class ServeFuture:
    """Handle for one submitted request.  ``result()`` drives the engine's
    step loop until this request finishes (single-threaded serving — there
    is no background thread; whoever waits, steps)."""

    def __init__(self, engine: "ServingEngine", request: Request):
        self._engine = engine
        self.request = request

    @property
    def done(self) -> bool:
        return self.request.state == FINISHED

    @property
    def token_ids(self) -> List[int]:
        """Generated tokens so far (excludes the prompt)."""
        return list(self.request.generated)

    def result(self, max_steps: int = 100_000,
               timeout_s: Optional[float] = None) -> List[int]:
        """Drive until this request finishes.  ``timeout_s`` bounds the
        wait in wall-clock seconds (checked at step boundaries).  Raises
        :class:`DeadlineExceeded` if the request's own SLO deadline
        cancelled it."""
        deadline = (None if timeout_s is None
                    else self._engine._clock() + float(timeout_s))
        for _ in range(max_steps):
            if self.done:
                return self.token_ids
            if self.request.state == EXPIRED:
                raise DeadlineExceeded(
                    f"request {self.request.rid} missed its "
                    f"{self.request.slo!r}-class deadline and was cancelled")
            if deadline is not None and self._engine._clock() >= deadline:
                raise TimeoutError(
                    f"request {self.request.rid} unfinished after "
                    f"{timeout_s}s")
            self._engine.step()
        raise TimeoutError(
            f"request {self.request.rid} unfinished after {max_steps} steps")


class ServingEngine:
    """``submit()/step()/run()`` over a model implementing ``paged_step``
    (the GPT family, ``models/gpt.py:gpt_paged_step``: GPT-2, LLaMA-style
    with grouped-query attention, BLOOM with ALiBi).  The arena holds the
    model's ``kv_heads`` heads.

    ``device`` defaults to the current CUDA device and raises where there is
    none.  The model is served in the configured dtype on ``device``: when
    its weights differ in either (or ``params``, a state dict, is given),
    the engine builds its own copy and leaves the caller's model alone."""

    def __init__(self, model, config: Optional[DeepSpeedServingConfig] = None,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 device=None, telemetry=None, tracer=None):
        cfg = config or DeepSpeedServingConfig()
        if telemetry is not None or tracer is not None:
            raise NotImplementedError(
                f"serving telemetry and tracing are not ported yet ({_LATER})")
        if cfg.kv_tiering:
            raise NotImplementedError(
                f"kv_tiering is not ported yet ({_LATER})")
        if cfg.serve_step_timeout_s and cfg.serve_step_timeout_s > 0.0:
            raise NotImplementedError(
                f"serve_step_timeout_s > 0 (bounded dispatch) is not ported "
                f"yet ({_LATER})")
        if not (hasattr(model, "paged_step") and hasattr(model, "cfg")):
            raise TypeError("ServingEngine needs a model with .cfg and "
                            ".paged_step(...) (the GPT family)")
        self._config = cfg
        self.device = resolve_device(device)
        head_dim = model.cfg.n_embd // model.cfg.n_head
        if self.device.type == "cuda" and (
                cfg.block_size != KERNEL_TILE or head_dim not in KERNEL_HEAD_DIMS):
            raise ValueError(
                f"the CUDA paged-attention kernel is compiled for block_size "
                f"{KERNEL_TILE} and head_dim {' or '.join(map(str, KERNEL_HEAD_DIMS))}; "
                f"got block_size {cfg.block_size}, head_dim {head_dim}")
        self.dtype = cfg.torch_dtype
        self.module = model_in(model, self.dtype, self.device, params)
        mcfg = self.module.cfg

        # ---- paged arena + control plane --------------------------------- #
        self.max_blocks_per_seq = (cfg.max_blocks_per_seq
                                   or -(-mcfg.n_positions // cfg.block_size))
        self.alloc = PagedKVAllocator(cfg.num_blocks, cfg.block_size,
                                      self.max_blocks_per_seq)
        self.sched = ServingScheduler(cfg, self.alloc, cfg.max_batch_size)
        self._k_pages, self._v_pages = init_arena(
            mcfg, cfg.num_blocks, cfg.block_size, dtype=self.dtype,
            device=self.device)
        self.prefix: Optional[PrefixCache] = None
        if cfg.prefix_cache:
            self.prefix = PrefixCache(self.alloc,
                                      max_blocks=cfg.prefix_cache_blocks)
            self.sched.prefix_cache = self.prefix
        self._vmask = (torch.arange(mcfg.padded_vocab, device=self.device)
                       < mcfg.vocab_size)

        self._clock = time.monotonic
        self.admission = AdmissionController(cfg)
        self._rid_counter = 0
        self.step_count = 0
        self.tokens_generated = 0
        self._started = time.monotonic()
        log_dist(
            f"ServingEngine ready: slots={cfg.max_batch_size}, "
            f"arena={cfg.num_blocks}x{cfg.block_size} tok "
            f"(max {self.max_blocks_per_seq} blocks/seq), "
            f"prefill_chunk={cfg.prefill_chunk}, dtype={self.dtype}, "
            f"device={self.device}", ranks=[0])

    # ---- request lifecycle robustness --------------------------------- #
    def _expire_deadlines(self):
        """Cancel every request whose per-class deadline has passed, at the
        step boundary; frees its arena blocks."""
        if not self._config.deadline_ms:
            return
        for req in self.sched.expired(self._clock()):
            self.sched.cancel(req)

    def _update_admission(self):
        """Advance the shed ladder from the queue-age signal (the TTFT burn
        signal needs the telemetry hub, not ported yet)."""
        self.admission.evaluate(self.sched.oldest_wait_s(self._clock()))

    # ------------------------------------------------------------------ #
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               slo: str = "standard", temperature: float = 0.0) -> ServeFuture:
        """Queue one request; returns a :class:`ServeFuture`."""
        if temperature:
            raise NotImplementedError(
                "serving is greedy-only (temperature=0)")
        if slo not in SLO_PRIORITY:
            raise ValueError(
                f"unknown slo class {slo!r}; expected one of "
                f"{sorted(SLO_PRIORITY)}")
        cfg, mcfg = self._config, self.module.cfg
        if not self.admission.admit_ok(slo):
            raise ShedError(
                f"admission ladder at {self.admission.level_name!r} is "
                f"shedding {slo!r}-class requests (retry later or raise "
                "the class)", slo=slo, level=self.admission.level)
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        mnt = int(max_new_tokens or cfg.max_new_tokens_default)
        # brownout rung: degrade before rejecting
        mnt = self.admission.cap_new_tokens(mnt)
        total = len(prompt) + mnt
        if total > mcfg.n_positions:
            raise ValueError(f"prompt+max_new_tokens {total} exceeds "
                             f"n_positions {mcfg.n_positions}")
        ceiling = min(cfg.num_blocks - 1, self.max_blocks_per_seq)
        if self.alloc.blocks_for_tokens(total) > ceiling:
            raise ArenaExhausted(
                f"request needs {self.alloc.blocks_for_tokens(total)} blocks; "
                f"arena ceiling is {ceiling}")
        self._rid_counter += 1
        req = Request(rid=self._rid_counter, prompt=prompt,
                      max_new_tokens=mnt, slo=slo, arrival=self._clock())
        dl = float((cfg.deadline_ms or {}).get(slo, 0.0) or 0.0)
        if dl > 0.0:
            req.deadline_at = req.arrival + dl / 1e3
        self.sched.submit(req)
        return ServeFuture(self, req)

    # ------------------------------------------------------------------ #
    def step(self) -> Dict[str, Any]:
        """One engine step: expire deadlines, advance the shed ladder,
        admit, run one prefill chunk, run one decode step over every
        decode-ready sequence.  Returns the step stats."""
        self._expire_deadlines()
        self._update_admission()
        self.sched.admit()
        prefill_tokens = 0
        pf = self.sched.next_prefill()
        if pf is not None:
            req, start, n = pf
            self._run_prefill(req, start, n)
            prefill_tokens = n
        # growth pass, oldest/strongest first: each decode step writes one
        # token per sequence, so capacity must exist before the batch is
        # built; eviction here removes victims from `active`
        decode = sorted(self.sched.decode_batch(),
                        key=lambda r: (r.priority, r.admit_seq))
        for r in decode:
            if r.state == DECODE:      # not evicted by an earlier r
                self.sched.ensure_capacity(r, r.prefilled + 1)
        decode = self.sched.decode_batch()
        if decode:
            self._run_decode(decode)
        self.step_count += 1
        stats = dict(self.sched.stats(), decode_batch=len(decode),
                     prefill_tokens=prefill_tokens,
                     tokens_generated=self.tokens_generated,
                     shed_level=self.admission.level,
                     elapsed_ms=(time.monotonic() - self._started) * 1000.0)
        if self.prefix is not None:
            stats.update(self.prefix.stats())
        return stats

    def run(self, max_steps: int = 1_000_000) -> int:
        """Drive until every queued/active request finishes (expired
        requests leave the queue by cancellation).  Returns the number of
        completed engine steps."""
        start = self.step_count
        while self.sched.has_work:
            if self.step_count - start >= max_steps:
                raise TimeoutError(f"serving drain exceeded {max_steps} steps")
            self.step()
        return self.step_count - start

    def close(self):
        """Kept for the JAX engine's surface: this engine holds no worker,
        tiering ring or telemetry hub, so there is nothing to release."""

    # ---- warm restart -------------------------------------------------- #
    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready warm-restart state: the scheduler queue + per-request
        progress — prompts, generated-so-far, remaining deadline — but NOT
        KV bytes (recompute on restore keeps the snapshot tiny and the
        token streams identical).  Take it between steps."""
        now = self._clock()
        in_flight = sorted(
            list(self.sched.waiting) + list(self.sched.active.values()),
            key=lambda r: r.submit_seq)
        reqs = []
        for r in in_flight:
            reqs.append({
                "rid": r.rid,
                "prompt": [int(t) for t in r.prompt],
                "generated": [int(t) for t in r.generated],
                "max_new_tokens": int(r.max_new_tokens),
                "slo": r.slo,
                "age_s": now - r.arrival,
                "deadline_remaining_s": (
                    None if r.deadline_at is None else r.deadline_at - now),
                "preemptions": int(r.preemptions),
            })
        return {"schema": 1, "requests": reqs,
                "rid_counter": int(self._rid_counter),
                "step_count": int(self.step_count)}

    def restore(self, snap: Dict[str, Any]) -> List[ServeFuture]:
        """Resume a :meth:`snapshot` on this (idle) engine: every request
        re-enters the waiting queue with ``prefilled=0`` — admission
        re-prefills prompt + generated-so-far, so greedy decoding
        continues the identical stream.  Remaining deadlines are
        re-anchored to this engine's clock.  Returns the new futures in
        submit order."""
        if self.sched.waiting or self.sched.active:
            raise RuntimeError("restore() needs an idle engine (fresh or "
                               "fully drained)")
        now = self._clock()
        futures = []
        for d in snap.get("requests", []):
            req = Request(rid=int(d["rid"]),
                          prompt=[int(t) for t in d["prompt"]],
                          max_new_tokens=int(d["max_new_tokens"]),
                          slo=str(d.get("slo", "standard")),
                          arrival=now - float(d.get("age_s", 0.0)))
            req.generated = [int(t) for t in d.get("generated", [])]
            req.preemptions = int(d.get("preemptions", 0))
            rem = d.get("deadline_remaining_s")
            if rem is not None:
                req.deadline_at = now + float(rem)
            self.sched.submit(req)
            futures.append(ServeFuture(self, req))
        self._rid_counter = max(self._rid_counter,
                                int(snap.get("rid_counter", 0)))
        return futures

    # ------------------------------------------------------------------ #
    def _dispatch(self, ids, positions, tables, wb, wo) -> np.ndarray:
        """One step of the model over the arena (updated in place) and the
        greedy argmax under the padded-vocab mask; tokens come back to the
        host as a ``[B, S]`` int32 array."""
        dev = self.device

        def put(a):
            return torch.from_numpy(a).to(dev)
        with torch.no_grad():
            logits, self._k_pages, self._v_pages = self.module.paged_step(
                put(ids), put(positions), self._k_pages, self._v_pages,
                put(tables), put(wb), put(wo))
            logits = torch.where(self._vmask, logits, -1e30)
            return logits.argmax(dim=-1).to(torch.int32).cpu().numpy()

    def _run_prefill(self, req: Request, start: int, n: int):
        C = self._config.prefill_chunk
        ctx = req.context
        ids = np.zeros((1, C), np.int32)
        ids[0, :n] = ctx[start:start + n]
        positions = np.asarray([start], np.int32)
        tables = self.alloc.block_table(req.rid)[None]           # [1, MB]
        wb, wo = self.alloc.write_map(req.rid, start, C, n_valid=n)
        tokens = self._dispatch(ids, positions, tables, wb[None], wo[None])
        req.prefilled += n
        if req.prefilled >= req.prefill_len:
            if self.prefix is not None and not self.admission.brownout:
                # the prompt's full blocks now hold valid KV: pin them for
                # later requests sharing this prefix (paused under
                # brownout — pinning competes with admission for blocks)
                self.prefix.insert(req.prompt,
                                   self.alloc.owned_blocks(req.rid))
            # the chunk holding the last context token also yields the next
            # token — first-token latency includes no extra decode step
            req.state = DECODE
            self._append_token(req, int(tokens[0, n - 1]))

    def _run_decode(self, reqs: List[Request]):
        B = self._config.max_batch_size
        MB = self.max_blocks_per_seq
        ids = np.zeros((B, 1), np.int32)
        positions = np.zeros((B,), np.int32)
        tables = np.zeros((B, MB), np.int32)      # trash-only for idle slots
        wb = np.zeros((B, 1), np.int32)
        wo = np.zeros((B, 1), np.int32)
        for r in reqs:
            s = r.slot
            ids[s, 0] = r.context[-1]
            positions[s] = r.prefilled
            tables[s] = self.alloc.block_table(r.rid)
            wb[s], wo[s] = self.alloc.write_map(r.rid, r.prefilled, 1)
        tokens = self._dispatch(ids, positions, tables, wb, wo)
        for r in reqs:
            r.prefilled += 1          # the fed token's KV is now resident
            self._append_token(r, int(tokens[r.slot, 0]))

    def _append_token(self, req: Request, tok: int):
        req.generated.append(tok)
        self.tokens_generated += 1
        if req.first_token_at is None:
            req.first_token_at = self._clock()
        if req.done(self._config.eos_token_id):
            req.finished_at = self._clock()
            self.sched.finish(req)


def init_serving(model=None, config=None, **kwargs):
    """Module-level helper in the ``deepspeed.init_inference`` style: merge
    a ``{"serving": {...}}`` (or flat) config dict + kwargs.  The nested
    form is collapsed FIRST and kwargs applied after, so engine kwargs
    (``params=``, ``device=``, ...) are never discarded by a full ds_config
    — and explicit kwargs always win over config keys."""
    cfg_dict = dict(config or {})
    if "serving" in cfg_dict:
        cfg_dict = dict(cfg_dict["serving"])
    cfg_dict.update(kwargs)
    params = cfg_dict.pop("params", None)
    device = cfg_dict.pop("device", None)
    telemetry = cfg_dict.pop("telemetry", None)
    tracer = cfg_dict.pop("tracer", None)
    if cfg_dict.pop("model_seed", None) is not None:
        raise TypeError("model_seed: the port's GPT carries its own weights; "
                        "seed it at construction, GPT(cfg, seed=...)")
    cfg = DeepSpeedServingConfig(**cfg_dict)
    return ServingEngine(model, config=cfg, params=params, device=device,
                         telemetry=telemetry, tracer=tracer)
