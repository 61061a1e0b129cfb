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

Ported, besides ``submit``/``step``/``run``/``close``,
``snapshot``/``restore``, deadline expiry, the admission ladder
(queue-age signal) and the prefix cache — the resilience plane:

* **tiered KV** (``kv_tiering: true``): a preempted sequence's written
  blocks are spilled by :class:`KVTieringManager` to pinned host memory
  and, past ``kv_host_cache_bytes``, to CRC-framed chunk files, and
  restored bit for bit on re-admission instead of being recomputed;
* **bounded dispatch** (``serve_step_timeout_s > 0``): each model step and
  the copy of its tokens to the host run on a worker thread
  (``comm/bounded.py``, on the engine's device and stream) under the
  deadline; a step past it raises :class:`ServeStepTimeout` after
  in-process recovery — a fresh arena and allocator, the prefix cache
  rebuilt, every in-flight request requeued for recompute.  The first
  dispatch of each phase runs inline (on the card it may build the
  kernels).  Recovery frees a host thread that was parked; a CUDA kernel
  that never returns leaves the context unusable, and no rebuild inside
  the process can clear that;
* **fault sites** (``testing/fault_injection.py``): ``serve.step`` first
  in every dispatch, ``serve.restage`` before a restore (a failure there
  falls back to recompute).

The observability half of the JAX engine (``deepspeed_tpu/serving/
engine.py:180-335,385-410,636-652,830-852``), with ``telemetry=`` (a
``TelemetryHub``, or a ``telemetry`` config dict through ``init_serving``,
which builds a hub the engine owns and closes) and ``tracer=``:

* every event at its JAX site, through :meth:`ServingEngine._emit`:
  ``serve_request`` (submitted, finished), ``serve_step`` every
  ``telemetry_every`` steps, ``serve_preempt``, ``prefix_hit``,
  ``serve_shed`` (rung changes, rejections), ``serve_expired``,
  ``serve_incident``, ``kv_spill``, ``kv_restage``;
* the registry's gauges (``serve_queue_depth``, ``serve_active``,
  ``serve_blocks_in_use``, ``serve_blocks_total``, the tier bytes,
  ``prefix_hit_rate``) and step-time histograms, set from host counts and
  the host clock; the event-derived metrics (TTFT, latency, preemptions)
  reach the registry through the hub's flush at the ``telemetry_every``
  cadence;
* the goodput ledger in serve mode (``slo_ttft_bound_ms``; a restage's
  wait counts as offload stall), the ``serve_arena`` and
  ``serve_incident`` health checks, and the TTFT-burn admission signal
  (the SLO monitor's state of ``serve_ttft_ms`` beside the queue age);
* the ``serve.step``, ``serve.prefill`` and ``serve.decode`` spans (on
  ``tracer``, else the global tracer).  A dict with ``tracing: true``
  also gets a tracer of the engine's own, exported to ``trace_dir`` as
  ``trace_rank0.json`` on ``close()``.

The hub reads only host state: with it the engine launches the same
kernels and gives the same tokens.  Decoding is greedy, as in the JAX
engine: ``submit(temperature > 0)`` raises.
"""

import contextlib
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import resolve_device
from deepspeed_tpu_torch.comm.bounded import BoundedCollective, CollectiveTimeout
from deepspeed_tpu_torch.models.gpt import model_in
from deepspeed_tpu_torch.ops.cuda.decode_attention import (KERNEL_HEAD_DIMS,
                                                           KERNEL_TILE)
from deepspeed_tpu_torch.runtime.offload import StagingError
from deepspeed_tpu_torch.serving.config import DeepSpeedServingConfig
from deepspeed_tpu_torch.serving.kv_cache import (ArenaExhausted,
                                                  PagedKVAllocator, init_arena)
from deepspeed_tpu_torch.serving.kv_tiering import KVTieringManager
from deepspeed_tpu_torch.serving.prefix_cache import PrefixCache
from deepspeed_tpu_torch.serving.scheduler import (DECODE, EXPIRED, FINISHED,
                                                   SHED_LEVELS, SLO_PRIORITY,
                                                   AdmissionController,
                                                   DeadlineExceeded, Request,
                                                   ServingScheduler, ShedError)
from deepspeed_tpu_torch.telemetry.hub import telemetry_from_arg
from deepspeed_tpu_torch.telemetry.tracing import maybe_span
from deepspeed_tpu_torch.testing.fault_injection import (FaultInjected, fault_point,
                                                         release_wedges)
from deepspeed_tpu_torch.utils.logging import log_dist


class ServeStepTimeout(RuntimeError):
    """A serve step (decode or prefill dispatch) exceeded
    ``serve_step_timeout_s``.  Raised *after* the engine has recovered
    in-process (arena rebuilt, every in-flight request requeued for
    recompute) — ``run()``/``result()`` keep driving; a bare ``step()``
    caller sees the incident."""

    def __init__(self, message, op=None, deadline_s=None, step=None):
        super().__init__(message)
        self.op = op
        self.deadline_s = deadline_s
        self.step = step


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
        wait in wall-clock seconds (checked at step boundaries — pair it
        with ``serve_step_timeout_s`` so a wedged dispatch cannot park the
        caller inside one step forever).  Raises
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
            try:
                self._engine.step()
            except ServeStepTimeout:
                # the engine already recovered (state requeued for
                # recompute); keep driving under the same bounds
                continue
        raise TimeoutError(
            f"request {self.request.rid} unfinished after {max_steps} steps")


class _TieringAdapter:
    """Bridges the scheduler's request-level spill/restage hooks to the
    :class:`KVTieringManager`'s rid/block-level API, and owns the
    ``kv_spill``/``kv_restage`` events.  Only blocks a sequence has
    actually *written* (``blocks_for_tokens(prefilled)``) are spilled —
    a growth block allocated for the next token holds garbage."""

    def __init__(self, engine: "ServingEngine"):
        self.engine = engine
        self.mgr = engine.tiering

    def spill(self, req: Request):
        eng = self.engine
        n = eng.alloc.blocks_for_tokens(req.prefilled)
        blocks = eng.alloc.owned_blocks(req.rid)[:n]
        tier = self.mgr.spill(req.rid, blocks, eng._k_pages, eng._v_pages,
                              req.prefilled)
        if tier is not None:
            eng._emit("kv_spill", {
                "rid": req.rid, "slo": req.slo, "tier": tier,
                "blocks": len(blocks), "tokens": req.prefilled,
                "bytes": self.mgr.chunk_bytes(eng._k_pages, len(blocks)),
            }, step=eng.step_count)
        return tier

    def begin_restage(self, req: Request) -> None:
        self.mgr.begin_restage(req.rid)

    def restage_ready(self, req: Request) -> bool:
        return self.mgr.restage_ready(req.rid)

    def restage(self, req: Request) -> bool:
        eng = self.engine
        n = eng.alloc.blocks_for_tokens(req.spilled_tokens)
        dest = eng.alloc.owned_blocks(req.rid)[:n]
        try:
            fault_point("serve.restage", rid=req.rid)
            eng._k_pages, eng._v_pages, info = self.mgr.restage(
                req.rid, eng._k_pages, eng._v_pages, dest)
        except (KeyError, StagingError, FaultInjected) as e:
            # unreadable/missing chunk: drop the record and recompute —
            # the destructive-evict contract still yields identical tokens
            self.mgr.discard(req.rid)
            eng._emit("kv_restage", {"rid": req.rid, "ok": False,
                                     "error": str(e)}, step=eng.step_count)
            return False
        eng._emit("kv_restage", {
            "rid": req.rid, "ok": True, "source": info["source"],
            "ready": info["ready"], "wait_ms": info["wait_s"] * 1000.0,
            "blocks": info["blocks"], "tokens": info["tokens"],
            "bytes": info["bytes"],
        }, step=eng.step_count)
        return True

    def discard(self, req: Request) -> None:
        self.mgr.discard(req.rid)

    def describe_tiers(self) -> str:
        return self.mgr.describe()


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
        if not (hasattr(model, "paged_step") and hasattr(model, "cfg")):
            raise TypeError("ServingEngine needs a model with .cfg and "
                            ".paged_step(...) (the GPT family)")
        self._config = cfg
        self.telemetry = telemetry
        self.tracer = tracer
        # live metrics plane: gauges + step-time histograms are updated
        # directly (host clock / scheduler counts, no device read);
        # event-derived metrics (TTFT, preemptions, restages) flow through
        # the hub's MetricsSink on the periodic flush in step() — one
        # source of truth per metric, no double counting
        self.registry = getattr(telemetry, "registry", None)
        if self.registry is not None:
            r = self.registry
            self._g_queue = r.gauge("serve_queue_depth")
            self._g_active = r.gauge("serve_active")
            self._g_blocks = r.gauge("serve_blocks_in_use")
            self._g_blocks_total = r.gauge("serve_blocks_total")
            self._g_blocks_total.set(cfg.num_blocks)
            self._g_host_bytes = r.gauge("serve_kv_host_bytes")
            self._g_nvme_bytes = r.gauge("serve_kv_nvme_bytes")
            self._g_prefix_rate = r.gauge("prefix_hit_rate")
            self._h_step = r.histogram("serve_step_ms")
            self._h_decode = r.histogram("serve_decode_step_ms")
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
        self.sched.on_preempt = self._on_preempt
        self._k_pages, self._v_pages = init_arena(
            mcfg, cfg.num_blocks, cfg.block_size, dtype=self.dtype,
            device=self.device)
        # every device call of the engine (dispatch worker and KV copies
        # included) is ordered on this stream
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)

        # ---- tiered spill/restage + prefix sharing (both opt-in) ---------- #
        self.tiering: Optional[KVTieringManager] = None
        self.prefix: Optional[PrefixCache] = None
        if cfg.kv_tiering:
            self.tiering = KVTieringManager(
                offload_dir=cfg.kv_offload_dir,
                host_cache_bytes=cfg.kv_host_cache_bytes,
                spill_budget_bytes=cfg.kv_spill_budget_bytes, stream=self._stream)
            self.sched.tiering = _TieringAdapter(self)
        if cfg.prefix_cache:
            self.prefix = PrefixCache(self.alloc,
                                      max_blocks=cfg.prefix_cache_blocks)
            self.sched.prefix_cache = self.prefix
            self.sched.on_prefix_hit = self._on_prefix_hit
        self._vmask = (torch.arange(mcfg.padded_vocab, device=self.device)
                       < mcfg.vocab_size)

        # ---- resilience plane -------------------------------------------- #
        self._clock = time.monotonic
        self.admission = AdmissionController(cfg)
        # bounded step dispatch: a wedged step raises ServeStepTimeout
        # instead of parking the engine thread forever.  on_timeout
        # releases fault-injection wedges so the abandoned worker drains
        # instead of leaking.
        self._bounded: Optional[BoundedCollective] = None
        if cfg.serve_step_timeout_s and cfg.serve_step_timeout_s > 0.0:
            self._bounded = BoundedCollective(
                deadline_s=float(cfg.serve_step_timeout_s),
                on_timeout=lambda err: release_wedges(),
                device=self.device if self.device.type == "cuda" else None,
                stream=self._stream)
        # phases whose first dispatch has run: the first of each phase runs
        # inline (unbounded), since on the card it may build the kernels
        self._warm_phases: set = set()
        self.incident_count = 0
        self.last_recovery_s = 0.0
        self._incident: Optional[Dict[str, Any]] = None  # /healthz latch
        self._closed = False

        self._rid_counter = 0
        self.step_count = 0
        self.tokens_generated = 0
        self._started = time.monotonic()
        self._owned_telemetry = None    # init_serving sets it for a dict-built hub
        # goodput ledger: the hub's, in serve mode — step() attributes wall
        # time, finished requests feed the per-SLO tokens-within-TTFT-bound
        # accounting
        self.ledger = getattr(telemetry, "ledger", None)
        self._restage_wait_ms = 0.0
        if self.ledger is not None:
            self.ledger.mode = "serve"
            self.ledger.slo_ttft_bounds_ms.update(
                {str(k): float(v) for k, v in (cfg.slo_ttft_bound_ms or {}).items()})
            self.ledger.mark()
        obs = getattr(telemetry, "obs_server", None)
        if obs is not None:
            obs.add_health_check("serve_arena", self._arena_health)
            obs.add_health_check("serve_incident", self._incident_health)
        log_dist(
            f"ServingEngine ready: slots={cfg.max_batch_size}, "
            f"arena={cfg.num_blocks}x{cfg.block_size} tok "
            f"(max {self.max_blocks_per_seq} blocks/seq), "
            f"prefill_chunk={cfg.prefill_chunk}, dtype={self.dtype}, "
            f"device={self.device}", ranks=[0])

    # ------------------------------------------------------------------ #
    def _emit(self, kind, payload, step=None):
        if (self.ledger is not None and kind == "kv_restage"
                and payload.get("ok")):
            # exposed restage wait attributes to offload_stall on next step
            self._restage_wait_ms += float(payload.get("wait_ms", 0.0))
        if self.telemetry is not None:
            self.telemetry.emit(kind, payload, step=step)

    def _arena_health(self):
        """`/healthz` contribution: arena + tier occupancy (always ``ok``
        on its own — oversubscription is a designed-for state; the gauges
        give the operator the occupancy picture)."""
        st = self.sched.stats()
        total = int(self._config.num_blocks)
        used = int(st.get("blocks_in_use", 0))
        out = {"ok": True, "blocks_in_use": used, "blocks_total": total,
               "occupancy": round(used / total, 4) if total else 0.0,
               "active": int(st.get("active", 0)),
               "queue_depth": int(st.get("queue_depth", 0))}
        if self.tiering is not None:
            ts = self.tiering.stats()
            for key in ("kv_host_bytes", "kv_nvme_bytes"):
                if key in ts:
                    out[key] = ts[key]
        return out

    def _incident_health(self):
        """`/healthz` contribution: unhealthy while a serve incident is
        latched — a wedged step recovered in-process but the engine has
        not yet completed a clean step."""
        out = {"ok": self._incident is None,
               "incidents": self.incident_count,
               "last_recovery_s": round(self.last_recovery_s, 4)}
        if self._incident is not None:
            out.update({k: self._incident[k] for k in ("step", "phase")})
        return out

    # ---- request lifecycle robustness --------------------------------- #
    def _expire_deadlines(self):
        """Cancel every request whose per-class deadline has passed, at the
        step boundary; frees its arena blocks and books its prefill as
        wasted compute."""
        if not self._config.deadline_ms:
            return
        now = self._clock()
        for req in self.sched.expired(now):
            wasted = req.prefilled
            self.sched.cancel(req)
            if self.ledger is not None:
                self.ledger.note_serve_expired(req.slo, wasted)
            self._emit("serve_expired", {
                "rid": req.rid, "slo": req.slo,
                "age_ms": (now - req.arrival) * 1000.0,
                "deadline_ms": (req.deadline_at - req.arrival) * 1000.0,
                "generated": len(req.generated),
                "wasted_prefill_tokens": wasted,
            }, step=self.step_count)

    def _update_admission(self):
        """Advance the shed ladder from the queue-age and TTFT-burn
        signals (the SLO monitor's state of ``serve_ttft_ms``); rung
        changes are telemetered (and gauge-fed via the MetricsSink on
        flush)."""
        age = self.sched.oldest_wait_s(self._clock())
        state = "ok"
        mon = getattr(self.telemetry, "slo_monitor", None)
        if mon is not None:
            try:
                state = mon.state_for_metric("serve_ttft_ms")
            except Exception:
                state = "ok"
        prev = self.admission.level
        level = self.admission.evaluate(age, state)
        if level != prev:
            self._emit("serve_shed", {
                "event": "level", "level": level,
                "from": SHED_LEVELS[prev], "to": self.admission.level_name,
                "queue_age_ms": age * 1000.0, "ttft_state": state,
            }, step=self.step_count)

    def _on_preempt(self, victim: Request):
        if self.ledger is not None and not victim.spilled:
            # eviction without a spill record: the prefill is recomputed
            # from scratch on resume — those tokens are wasted work
            self.ledger.note_wasted_prefill(victim.slo, victim.prefilled)
        self._emit("serve_preempt", {
            "rid": victim.rid, "slo": victim.slo,
            "generated": len(victim.generated),
            "preemptions": victim.preemptions,
            "spilled": victim.spilled,
        }, step=self.step_count)

    def _on_prefix_hit(self, req: Request, blocks: List[int]):
        self._emit("prefix_hit", {
            "rid": req.rid, "slo": req.slo, "blocks": len(blocks),
            "tokens": len(blocks) * self._config.block_size,
            "prompt_tokens": len(req.prompt),
        }, step=self.step_count)

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
            self._emit("serve_shed", {
                "event": "rejected", "slo": slo,
                "level": self.admission.level,
                "level_name": self.admission.level_name,
                "queue_depth": len(self.sched.waiting),
            }, step=self.step_count)
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
        self._emit("serve_request", {
            "event": "submitted", "rid": req.rid, "slo": slo,
            "prompt_tokens": len(prompt), "max_new_tokens": mnt,
            "queue_depth": len(self.sched.waiting),
        }, step=self.step_count)
        return ServeFuture(self, req)

    # ------------------------------------------------------------------ #
    def step(self) -> Dict[str, Any]:
        """One engine step: expire deadlines, advance the shed ladder,
        admit, run one prefill chunk, run one decode step over every
        decode-ready sequence.  Returns the step stats.  A wedged dispatch
        raises :class:`ServeStepTimeout` *after* in-process recovery (see
        :meth:`_recover_incident`)."""
        self._expire_deadlines()
        self._update_admission()
        self.sched.admit()
        prefill_tokens = 0
        t_step = time.monotonic() if self.registry is not None else 0.0
        try:
            with maybe_span("serve.step", tracer=self.tracer, step=self.step_count):
                pf = self.sched.next_prefill()
                if pf is not None:
                    req, start, n = pf
                    with maybe_span("serve.prefill", tracer=self.tracer, rid=req.rid,
                                    start=start, tokens=n):
                        self._run_prefill(req, start, n)
                    prefill_tokens = n
                # growth pass, oldest/strongest first: each decode step
                # writes one token per sequence, so capacity must exist
                # before the batch is built; eviction here removes victims
                # from `active`
                decode = sorted(self.sched.decode_batch(),
                                key=lambda r: (r.priority, r.admit_seq))
                for r in decode:
                    if r.state == DECODE:      # not evicted by an earlier r
                        self.sched.ensure_capacity(r, r.prefilled + 1)
                decode = self.sched.decode_batch()
                if decode:
                    t_dec = time.monotonic() if self.registry is not None else 0.0
                    with maybe_span("serve.decode", tracer=self.tracer, batch=len(decode)):
                        self._run_decode(decode)
                    if self.registry is not None:
                        self._h_decode.observe((time.monotonic() - t_dec) * 1e3)
        except ServeStepTimeout as err:
            self._recover_incident(err)
            raise
        if self._incident is not None:
            # first clean step after an incident: release the latch
            self._emit("serve_incident", {
                "event": "cleared", "phase": self._incident["phase"],
                "incident_step": self._incident["step"],
            }, step=self.step_count)
            self._incident = None
        self.step_count += 1
        if self.ledger is not None:
            self.ledger.on_step(self.step_count,
                                offload_wait_s=self._restage_wait_ms / 1e3)
            self._restage_wait_ms = 0.0
        stats = dict(self.sched.stats(), decode_batch=len(decode),
                     prefill_tokens=prefill_tokens,
                     tokens_generated=self.tokens_generated,
                     shed_level=self.admission.level,
                     incidents=self.incident_count,
                     elapsed_ms=(time.monotonic() - self._started) * 1000.0)
        if self.tiering is not None:
            stats.update(self.tiering.stats())
        if self.prefix is not None:
            stats.update(self.prefix.stats())
        if self.registry is not None:
            self._h_step.observe((time.monotonic() - t_step) * 1e3)
            for gauge, key in ((self._g_queue, "queue_depth"),
                               (self._g_active, "active"),
                               (self._g_blocks, "blocks_in_use"),
                               (self._g_host_bytes, "kv_host_bytes"),
                               (self._g_nvme_bytes, "kv_nvme_bytes")):
                v = stats.get(key)
                if isinstance(v, (int, float)):
                    gauge.set(v)
            lookups = stats.get("prefix_lookups")
            if lookups:
                self._g_prefix_rate.set(int(stats.get("prefix_hits", 0)) / int(lookups))
        if (self.telemetry is not None and self._config.telemetry_every
                and self.step_count % self._config.telemetry_every == 0):
            self._emit("serve_step", stats, step=self.step_count)
            if self.registry is not None:
                # drain the emit buffer so event-derived metrics (TTFT,
                # restage, preemption) stay live for /metrics scrapes,
                # then run the pod fold at its own cadence
                self.telemetry.flush()
                self.telemetry.maybe_snapshot(self.step_count)
        return stats

    def run(self, max_steps: int = 1_000_000) -> int:
        """Drive until every queued/active request finishes (expired
        requests leave the queue by cancellation).  A ServeStepTimeout
        incident does not abort the drain — the engine recovered before
        raising, so the loop keeps going; the step bound still applies
        (wedged attempts count toward it).  Returns the number of
        completed engine steps."""
        start = self.step_count
        steps = 0
        while self.sched.has_work:
            if steps >= max_steps:
                raise TimeoutError(f"serving drain exceeded {max_steps} steps")
            try:
                self.step()
            except ServeStepTimeout:
                pass       # recovered in-process; requests are requeued
            steps += 1
        return self.step_count - start

    def close(self):
        """Release the resilience and tiering backends: stop the bounded
        dispatch worker, drain the staging pool's writes, close it and
        remove the tempdir the tiering manager made; close a hub that
        ``init_serving`` built (final flush, ops-server shutdown) and
        export a tracer it built.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self._bounded is not None:
            self._bounded.shutdown()
        if self.tiering is not None:
            self.tiering.close()
        if self._owned_telemetry is not None:
            self._owned_telemetry.close()

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
    # ---- bounded dispatch + incident recovery -------------------------- #
    def _on_stream(self):
        """The engine's stream as the current one (the caller's may be
        another); nothing on the CPU."""
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def _dispatch(self, phase: str, ids, positions, tables, wb, wo) -> np.ndarray:
        """One step of the model over the arena (updated in place) and the
        greedy argmax under the padded-vocab mask; tokens come back to the
        host as a ``[B, S]`` int32 array.  Under ``serve_step_timeout_s``
        the whole of it — the ``serve.step`` fault site, the step and the
        token row's copy to the host, where a wedged step parks the
        thread — runs on the bounded worker; the first dispatch of each
        phase runs inline.  The worker holds the arena it was given: after
        a timeout the engine has swapped in a new one and drops the
        worker's result."""
        dev = self.device
        kp, vp = self._k_pages, self._v_pages

        def put(a):
            return torch.from_numpy(a).to(dev)

        def work():
            fault_point("serve.step", step=self.step_count, phase=phase)
            with torch.no_grad():
                logits, k, v = self.module.paged_step(
                    put(ids), put(positions), kp, vp, put(tables), put(wb), put(wo))
                logits = torch.where(self._vmask, logits, -1e30)
                return logits.argmax(dim=-1).to(torch.int32).cpu().numpy(), k, v

        if self._bounded is None or phase not in self._warm_phases:
            with self._on_stream():
                tokens, k, v = work()
            self._warm_phases.add(phase)
        else:
            try:
                tokens, k, v = self._bounded.run(work, op=phase, noun="serve step")
            except CollectiveTimeout as e:
                raise ServeStepTimeout(
                    f"serve {phase} step {self.step_count} exceeded its "
                    f"{e.deadline_s:.3f}s deadline", op=phase,
                    deadline_s=e.deadline_s, step=self.step_count) from e
        self._k_pages, self._v_pages = k, v
        return tokens

    def _recover_incident(self, err: ServeStepTimeout):
        """In-process recovery from a wedged step: drain the staging pool,
        drop the arena (the abandoned worker keeps its own reference and
        may still write into it), rebuild a fresh arena, allocator and
        prefix cache, and requeue every in-flight request with
        ``prefilled=0`` — the preemption recompute contract, so the token
        streams continue identically.  Spilled host/NVMe copies of
        *waiting* requests survive (they never touch the device arena).
        Latches ``/healthz`` unhealthy until the first clean step."""
        t0 = self._clock()
        self.incident_count += 1
        cfg, mcfg = self._config, self.module.cfg
        self._emit("serve_incident", {
            "event": "begin", "phase": err.op, "step": self.step_count,
            "deadline_s": err.deadline_s, "incident": self.incident_count,
            "in_flight": len(self.sched.active),
        }, step=self.step_count)
        if self.ledger is not None:
            # resident KV is about to be discarded: its prefill recomputes
            for r in self.sched.active.values():
                self.ledger.note_wasted_prefill(r.slo, r.prefilled)
        if self.tiering is not None:
            # spill writes and prefetch reads in flight finish first, as in
            # the JAX engine (none of them touches the arena)
            self.tiering.drain()
        self._warm_phases.clear()
        self.alloc = PagedKVAllocator(cfg.num_blocks, cfg.block_size,
                                      self.max_blocks_per_seq)
        with self._on_stream():
            self._k_pages, self._v_pages = init_arena(
                mcfg, cfg.num_blocks, cfg.block_size, dtype=self.dtype,
                device=self.device)
        if self.prefix is not None:
            # cached pins point at pre-incident arena content: rebuild
            self.prefix = PrefixCache(self.alloc,
                                      max_blocks=cfg.prefix_cache_blocks)
            self.sched.prefix_cache = self.prefix
        requeued = self.sched.requeue_for_recovery(self.alloc)
        self._incident = {"at": t0, "step": self.step_count,
                          "phase": err.op}
        self.last_recovery_s = self._clock() - t0
        if self.ledger is not None:
            # the wedge wait (the expired deadline) plus the rebuild are
            # incident seconds, not productive step time
            self.ledger.note_comm_recovery((err.deadline_s or 0.0) + self.last_recovery_s)
        self._emit("serve_incident", {
            "event": "recovered", "phase": err.op, "step": self.step_count,
            "requeued": len(requeued), "lost": 0,
            "recovery_s": self.last_recovery_s,
            "deadline_s": err.deadline_s, "incident": self.incident_count,
        }, step=self.step_count)

    def _run_prefill(self, req: Request, start: int, n: int):
        C = self._config.prefill_chunk
        ctx = req.context
        ids = np.zeros((1, C), np.int32)
        ids[0, :n] = ctx[start:start + n]
        positions = np.asarray([start], np.int32)
        tables = self.alloc.block_table(req.rid)[None]           # [1, MB]
        wb, wo = self.alloc.write_map(req.rid, start, C, n_valid=n)
        tokens = self._dispatch("prefill", ids, positions, tables, wb[None], wo[None])
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
        tokens = self._dispatch("decode", ids, positions, tables, wb, wo)
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
            ttft = req.first_token_at - req.arrival
            latency = req.finished_at - req.arrival
            if self.ledger is not None:
                self.ledger.note_serve_request(req.slo, ttft * 1000.0, len(req.generated))
            self._emit("serve_request", {
                "event": "finished", "rid": req.rid, "slo": req.slo,
                "prompt_tokens": len(req.prompt),
                "new_tokens": len(req.generated),
                "ttft_ms": ttft * 1000.0,
                "latency_ms": latency * 1000.0,
                "tokens_per_sec": len(req.generated) / max(latency, 1e-9),
                "preemptions": req.preemptions,
            }, step=self.step_count)


def init_serving(model=None, config=None, **kwargs):
    """Module-level helper in the ``deepspeed.init_inference`` style: merge
    a ``{"serving": {...}}`` (or flat) config dict + kwargs.  The nested
    form is collapsed FIRST and kwargs applied after, so engine kwargs
    (``params=``, ``device=``, ``telemetry=``, ...) are never discarded by
    a full ds_config — and explicit kwargs always win over config keys.
    ``telemetry`` is a ``TelemetryHub`` or a ``telemetry`` config dict
    (``DeepSpeedTelemetryConfig``'s keys): a hub built from a dict has no
    other owner, so the engine closes it on ``close()``; with ``tracing:
    true`` and no ``tracer=`` the engine also gets a tracer of its own,
    exported to ``trace_dir`` on ``close()``."""
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
    telemetry, tracer, owned = telemetry_from_arg(telemetry, tracer, resolve_device(device))
    try:
        eng = ServingEngine(model, config=cfg, params=params, device=device,
                            telemetry=telemetry, tracer=tracer)
    except BaseException:
        if owned is not None:
            owned.close()
        raise
    eng._owned_telemetry = owned
    return eng
