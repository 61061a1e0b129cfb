"""Request queue + continuous-batching scheduler (counterpart of
``deepspeed_tpu/serving/scheduler.py``, the same host Python).

Pure-host control plane for ``serving/engine.py``: admission, the
prefill/decode split with chunked prefill, and SLO-class preemption.  The
scheduler owns request state and drives the :class:`PagedKVAllocator`; it
never touches the device, so every policy below is unit-testable on CPU in
microseconds.  The tiering hooks stay (duck-typed, ``None`` by default);
the port's engine does not install a tiering manager yet.

Scheduling policy (see README § Serving):

* **Admission** is continuous: whenever a decode slot and enough arena
  blocks are free, the best waiting request — ordered by (SLO priority,
  submit order) — is admitted.  Head-of-line blocking on an arena-full
  condition is deliberate: skipping ahead would starve long prompts.
* **Chunked prefill**: one prompt chunk (``prefill_chunk`` tokens) is
  processed per engine step, so a long prompt never stalls the decode
  batch for more than one chunk's latency.
* **Preemption** frees a victim's blocks (eviction) and requeues it for
  *recompute* — on resume the prompt + generated-so-far is re-prefilled,
  which under greedy decoding continues the identical token stream.
  Victim order is weakest SLO class first, then youngest admission, and
  never the requester — so the oldest admitted request always progresses
  and the eviction loop terminates.
* **Tiering** (engine-installed, optional): reclamation is a ladder, least
  destructive rung first — (1) release prefix-cache pins, (2) *spill* the
  victim's KV to host/NVMe before its blocks are reclaimed (recompute
  becomes restore), (3) destructive evict when the spill budget refuses.
  A spilled request's restage is prefetched while it waits and it is
  admitted only once its bytes are resident — unless the engine is
  otherwise idle, when blocking on the restage beats doing nothing.
  ``ArenaExhausted`` still means the requester alone cannot hold its
  window in the *device* arena (host/NVMe cannot substitute for decode
  residency); with tiering on, every other sequence has been spilled —
  not destroyed — first, and the error reports tier occupancy.
"""

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from deepspeed_tpu_torch.serving.kv_cache import ArenaExhausted, PagedKVAllocator

# SLO classes, strongest first; lower number = higher priority.
SLO_PRIORITY = {"realtime": 0, "standard": 1, "batch": 2}

WAITING = "waiting"
PREFILL = "prefill"
DECODE = "decode"
FINISHED = "finished"
EXPIRED = "expired"      # deadline passed; cancelled at a step boundary


class QueueFull(Exception):
    """submit() past ``max_queue`` — shed load at the front door."""


class ShedError(Exception):
    """429-style rejection from the adaptive admission ladder: the engine
    is shedding this request's SLO class until pressure clears.  Distinct
    from :class:`QueueFull` (the static bound) so callers can retry-later
    vs. downshift-class deliberately."""

    def __init__(self, message, slo=None, level=None):
        super().__init__(message)
        self.slo = slo
        self.level = level


class DeadlineExceeded(TimeoutError):
    """The request's per-class deadline passed before it finished; it was
    cancelled at a step boundary and its blocks freed."""


# Adaptive admission ladder rungs, mildest first.  ``brownout`` degrades
# (cap max_new_tokens, pause prefix-cache inserts); the shed rungs reject
# outright, weakest SLO class first — realtime is never ladder-shed.
SHED_LEVELS = ("ok", "brownout", "shed_batch", "shed_standard")


class AdmissionController:
    """Pure-host shed ladder over two pressure signals: the TTFT burn
    state (the PR 13 ``SLOMonitor`` state machine for the
    ``serve_ttft_ms`` rule) and the oldest-waiting queue age vs. the
    configured watermark.  Escalation is immediate; de-escalation steps
    one rung down only after ``shed_recovery_steps`` consecutive calm
    evaluations — hysteresis, so the ladder doesn't flap at the boundary.
    """

    def __init__(self, cfg):
        self.cfg = cfg
        # config is static for the controller's lifetime — coerce once so
        # the per-step evaluate()/cap path stays free of conversion calls
        self._watermark_s = float(cfg.queue_age_watermark_ms or 0.0) / 1e3
        self._recovery_steps = max(int(cfg.shed_recovery_steps), 1)
        self._brownout_cap = int(cfg.brownout_max_new_tokens or 0)
        self.level = 0                  # index into SHED_LEVELS
        self._calm = 0
        self.shed_counts: Dict[str, int] = {}

    @property
    def level_name(self) -> str:
        return SHED_LEVELS[self.level]

    @property
    def brownout(self) -> bool:
        return self.level >= 1

    def evaluate(self, queue_age_s: float, ttft_state: str = "ok") -> int:
        """Advance the ladder from the current signals; returns the new
        level.  ``ttft_state`` is an SLOMonitor rule state
        (``ok``/``burn_slow``/``burn_fast``)."""
        wm = self._watermark_s
        target = 0
        if ttft_state == "burn_slow" or (wm > 0.0 and queue_age_s > wm):
            target = 1
        if ttft_state == "burn_fast" or (wm > 0.0 and queue_age_s > 2 * wm):
            target = 2
        if wm > 0.0 and queue_age_s > 4 * wm:
            target = 3
        if target >= self.level:
            # pressure at (or above) the current rung is not calm — the
            # de-escalation counter restarts
            self.level = target
            self._calm = 0
        else:
            self._calm += 1
            if self._calm >= self._recovery_steps:
                self.level -= 1
                self._calm = 0
        return self.level

    def admit_ok(self, slo: str) -> bool:
        """Whether a request of ``slo`` passes the current rung.  Level 2
        sheds ``batch`` (priority 2); level 3 sheds ``standard`` too;
        ``realtime`` only ever hits the static ``max_queue`` bound."""
        if self.level < 2:
            return True
        prio = SLO_PRIORITY.get(slo, SLO_PRIORITY["standard"])
        floor = 2 if self.level == 2 else 1
        if prio >= floor:
            self.shed_counts[slo] = self.shed_counts.get(slo, 0) + 1
            return False
        return True

    def cap_new_tokens(self, max_new_tokens: int) -> int:
        """Brownout rung: cap the token budget of admitted requests."""
        cap = self._brownout_cap
        if self.brownout and cap > 0:
            return min(max_new_tokens, cap)
        return max_new_tokens


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    slo: str = "standard"
    arrival: float = 0.0               # host clock, supplied by the engine
    state: str = WAITING
    generated: List[int] = field(default_factory=list)
    prefilled: int = 0                 # context tokens with KV in the arena
    prefill_len: int = 0               # prefill target, set at admission
    slot: int = -1                     # decode-batch slot while active
    submit_seq: int = -1               # FIFO key (stable across preemption)
    admit_seq: int = -1                # youngest-victim key, per admission
    preemptions: int = 0
    spilled: bool = False              # KV sits in the tiered store
    spilled_tokens: int = 0            # context tokens the spill covers
    spills: int = 0
    restages: int = 0
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    deadline_at: Optional[float] = None   # host clock; None = no deadline

    @property
    def priority(self) -> int:
        return SLO_PRIORITY.get(self.slo, SLO_PRIORITY["standard"])

    @property
    def context(self) -> List[int]:
        """Tokens whose KV must exist before the next decode step."""
        return self.prompt + self.generated

    @property
    def needs_prefill(self) -> bool:
        return self.state == PREFILL and self.prefilled < self.prefill_len

    def done(self, eos_token_id: Optional[int]) -> bool:
        if len(self.generated) >= self.max_new_tokens:
            return True
        return (eos_token_id is not None and self.generated
                and self.generated[-1] == eos_token_id)


class ServingScheduler:
    def __init__(self, cfg, allocator: PagedKVAllocator, num_slots: int):
        self.cfg = cfg
        self.alloc = allocator
        self.num_slots = int(num_slots)
        self.waiting: deque = deque()
        self.active: Dict[int, Request] = {}      # slot -> request
        self._free_slots: List[int] = list(range(self.num_slots - 1, -1, -1))
        self._submit_counter = itertools.count()
        self._admit_counter = itertools.count()
        self.preemption_count = 0
        self.finished_count = 0
        self.expired_count = 0
        self.spill_count = 0
        self.restage_count = 0
        # engine hook: called with the victim after each eviction (telemetry)
        self.on_preempt = None
        # engine-installed tiering adapter (duck-typed: spill(req)->tier|None,
        # begin_restage/restage_ready/restage(req), discard(req),
        # describe_tiers()); None = destructive evict+recompute only
        self.tiering = None
        # engine-installed PrefixCache + hit callback(req, blocks)
        self.prefix_cache = None
        self.on_prefix_hit = None

    # ---- intake ----------------------------------------------------------- #
    def submit(self, req: Request) -> Request:
        if len(self.waiting) >= self.cfg.max_queue:
            raise QueueFull(f"waiting queue at max_queue={self.cfg.max_queue}")
        req.submit_seq = next(self._submit_counter)
        req.state = WAITING
        self.waiting.append(req)
        return req

    def _pop_best_waiting(self) -> Optional[Request]:
        """Best admittable waiting request.  A spilled request whose
        restage has not landed is *skipped* (its prefetch is kicked here),
        hiding the NVMe read behind decode of whoever comes next — the one
        deliberate departure from strict head-of-line order.  When nothing
        else is active the best request is taken regardless: blocking on
        its restage beats idling the engine."""
        if not self.waiting:
            return None
        order = sorted(self.waiting, key=lambda r: (r.priority, r.submit_seq))
        best = None
        if self.tiering is None:
            best = order[0]
        else:
            for req in order:
                if req.spilled and not self.tiering.restage_ready(req):
                    self.tiering.begin_restage(req)
                    continue
                best = req
                break
            if best is None and not self.active:
                best = order[0]
        if best is None:
            return None
        self.waiting.remove(best)
        return best

    # ---- admission -------------------------------------------------------- #
    def admit(self) -> List[Request]:
        """Fill free decode slots from the waiting queue.  Returns the
        newly admitted requests (their prefill starts next step)."""
        admitted = []
        while self._free_slots:
            req = self._pop_best_waiting()
            if req is None:
                break
            target = len(req.context)
            prefix_blocks: List[int] = []
            if (self.prefix_cache is not None and not req.spilled
                    and not req.generated
                    and not self.alloc.owned_blocks(req.rid)):
                prefix_blocks = self.prefix_cache.lookup(req.prompt)
                if prefix_blocks:
                    self.alloc.adopt(req.rid, prefix_blocks)
            fits = True
            while not self.alloc.allocate(req.rid, target):
                if self._reclaim_prefix(req, target):
                    continue
                victim = self._admission_victim(req)
                if victim is None:
                    fits = False
                    break
                self.preempt(victim)
            if not fits:
                # Arena full and nothing evictable below this class:
                # head-of-line blocks until decode frees capacity.  Drop
                # adopted prefix refs — the cache keeps its own pins, so
                # the re-attach on the next attempt is just as free.
                if prefix_blocks:
                    self.alloc.free(req.rid)
                self.waiting.appendleft(req)
                return admitted
            req.slot = self._free_slots.pop()
            req.admit_seq = next(self._admit_counter)
            req.prefill_len = target
            if req.spilled:
                self._resume_from_spill(req)
            elif prefix_blocks:
                req.prefilled = len(prefix_blocks) * self.alloc.block_size
                if self.on_prefix_hit is not None:
                    self.on_prefix_hit(req, prefix_blocks)
            else:
                req.prefilled = 0
            req.state = PREFILL
            self.active[req.slot] = req
            admitted.append(req)
        return admitted

    def _reclaim_prefix(self, req: Request, n_tokens: int) -> bool:
        """First rung of the reclamation ladder: release LRU prefix-cache
        pins to cover the shortfall.  Blocks the requester itself adopted
        are not freed by this (it holds its own reference)."""
        if self.prefix_cache is None:
            return False
        need = (self.alloc.blocks_for_tokens(n_tokens)
                - len(self.alloc.owned_blocks(req.rid))
                - self.alloc.free_blocks)
        return need > 0 and self.prefix_cache.release(need) > 0

    def _resume_from_spill(self, req: Request) -> None:
        """Restore a spilled request's KV into its fresh allocation; a
        failed restage (unreadable chunk) falls back to full recompute —
        the pre-tiering path, still token-identical."""
        ok = self.tiering is not None and self.tiering.restage(req)
        if ok:
            req.prefilled = req.spilled_tokens
            req.restages += 1
            self.restage_count += 1
        else:
            req.prefilled = 0
        req.spilled = False
        req.spilled_tokens = 0

    # ---- preemption ------------------------------------------------------- #
    def _victim_order(self, candidates: List[Request]) -> List[Request]:
        # weakest SLO class first, then youngest admission
        return sorted(candidates, key=lambda r: (-r.priority, -r.admit_seq))

    def _admission_victim(self, incoming: Request) -> Optional[Request]:
        if not self.cfg.slo_preemption:
            return None
        weaker = [r for r in self.active.values()
                  if r.priority > incoming.priority]
        order = self._victim_order(weaker)
        return order[0] if order else None

    def _growth_victim(self, requester: Request) -> Optional[Request]:
        others = [r for r in self.active.values() if r is not requester]
        order = self._victim_order(others)
        return order[0] if order else None

    def preempt(self, victim: Request) -> None:
        """Reclaim ``victim``'s blocks and requeue it.  With tiering, the
        spill rung runs first — the victim's written KV is captured to
        host/NVMe so re-admission restores instead of recomputes; a
        refused spill (budget, or nothing written yet) degrades to the
        destructive pre-tiering evict.  ``prefilled`` resets to 0 either
        way: until the restage actually lands, the arena holds nothing
        for this request."""
        assert victim.slot in self.active and self.active[victim.slot] is victim
        del self.active[victim.slot]
        self._free_slots.append(victim.slot)
        tier = None
        if self.tiering is not None and victim.prefilled > 0:
            tier = self.tiering.spill(victim)
        victim.spilled = tier is not None
        victim.spilled_tokens = victim.prefilled if victim.spilled else 0
        if victim.spilled:
            victim.spills += 1
            self.spill_count += 1
        self.alloc.evict(victim.rid)
        victim.slot = -1
        victim.prefilled = 0
        victim.state = WAITING
        victim.preemptions += 1
        self.preemption_count += 1
        self.waiting.appendleft(victim)   # submit_seq keeps its FIFO place
        if self.on_preempt is not None:
            self.on_preempt(victim)

    def ensure_capacity(self, req: Request, n_tokens: int) -> None:
        """Guarantee ``req`` owns blocks for ``n_tokens`` context tokens,
        walking the reclamation ladder under arena pressure.  The victim
        order excludes the requester, so the loop strictly shrinks the
        active set and terminates; if the requester alone exceeds the
        arena we raise — host/NVMe tiers cannot substitute for device
        residency of the decode window, so this holds even when every
        other sequence has been spilled rather than destroyed."""
        while not self.alloc.allocate(req.rid, n_tokens):
            if self._reclaim_prefix(req, n_tokens):
                continue
            victim = self._growth_victim(req)
            if victim is None:
                tiers = ("" if self.tiering is None else
                         f"; tiers: {self.tiering.describe_tiers()}")
                raise ArenaExhausted(
                    f"request {req.rid} needs "
                    f"{self.alloc.blocks_for_tokens(n_tokens)} blocks; arena "
                    f"has {self.alloc.num_blocks - 1} usable{tiers}")
            self.preempt(victim)

    # ---- per-step work selection ------------------------------------------ #
    def next_prefill(self) -> Optional[Tuple[Request, int, int]]:
        """One (request, start, n_tokens) prompt chunk for this step, or
        None.  Strongest class / oldest admission goes first."""
        pending = [r for r in self.active.values() if r.needs_prefill]
        if not pending:
            return None
        req = min(pending, key=lambda r: (r.priority, r.admit_seq))
        start = req.prefilled
        n = min(self.cfg.prefill_chunk, req.prefill_len - start)
        return req, start, n

    def decode_batch(self) -> List[Request]:
        return [r for r in self.active.values() if r.state == DECODE]

    # ---- completion ------------------------------------------------------- #
    def finish(self, req: Request) -> None:
        assert req.slot in self.active and self.active[req.slot] is req
        del self.active[req.slot]
        self._free_slots.append(req.slot)
        self.alloc.free(req.rid)
        req.slot = -1
        req.state = FINISHED
        self.finished_count += 1
        if self.tiering is not None:
            # defensively drop any staged copy (e.g. a restage that fell
            # back to recompute): finished bytes must never be readable
            # under a later epoch of a reused block id
            self.tiering.discard(req)

    # ---- deadlines -------------------------------------------------------- #
    def expired(self, now: float) -> List[Request]:
        """Every request (waiting or active) whose deadline has passed.
        Pure scan — cancellation is a separate step so the engine can book
        the wasted work before the state is torn down."""
        out = [r for r in self.waiting
               if r.deadline_at is not None and now >= r.deadline_at]
        out.extend(r for r in self.active.values()
                   if r.deadline_at is not None and now >= r.deadline_at)
        return out

    def cancel(self, req: Request) -> None:
        """Cancel an expired request at the step boundary: free its slot
        and arena blocks, drop any staged tier copy, mark it EXPIRED.
        ``free``/``discard`` are idempotent, so a request that never owned
        blocks (still waiting) cancels cleanly too."""
        if req.slot >= 0 and self.active.get(req.slot) is req:
            del self.active[req.slot]
            self._free_slots.append(req.slot)
        elif req in self.waiting:
            self.waiting.remove(req)
        self.alloc.free(req.rid)
        if self.tiering is not None:
            self.tiering.discard(req)
        req.slot = -1
        req.spilled = False
        req.spilled_tokens = 0
        req.state = EXPIRED
        self.expired_count += 1

    def oldest_wait_s(self, now: float) -> float:
        """Age of the oldest waiting request — the queue-age pressure
        signal for the admission ladder."""
        if not self.waiting:
            return 0.0
        return max(0.0, now - min(r.arrival for r in self.waiting))

    # ---- wedge recovery --------------------------------------------------- #
    def requeue_for_recovery(self, allocator: PagedKVAllocator
                             ) -> List[Request]:
        """Adopt a freshly rebuilt allocator (the arena was reinitialized
        after a wedged step) and return every in-flight request to the
        waiting queue with ``prefilled=0`` — the preemption recompute
        contract, so greedy decoding resumes token-identical.  Spill
        records of *waiting* requests survive (host/NVMe bytes are
        untouched by an arena rebuild); active requests were resident-only
        and simply recompute.  Returns the requeued requests."""
        self.alloc = allocator
        requeued = sorted(self.active.values(), key=lambda r: r.submit_seq)
        self.active.clear()
        self._free_slots = list(range(self.num_slots - 1, -1, -1))
        for req in reversed(requeued):
            req.slot = -1
            req.prefilled = 0
            req.spilled = False
            req.spilled_tokens = 0
            req.state = WAITING
            self.waiting.appendleft(req)   # submit_seq keeps its FIFO place
        return requeued

    # ---- introspection ---------------------------------------------------- #
    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.active)

    def stats(self) -> Dict[str, int]:
        return {
            "queue_depth": len(self.waiting),
            "active": len(self.active),
            "free_slots": len(self._free_slots),
            "blocks_in_use": self.alloc.blocks_in_use,
            "blocks_free": self.alloc.free_blocks,
            "preemptions": self.preemption_count,
            "finished": self.finished_count,
            "expired": self.expired_count,
            "spills": self.spill_count,
            "restages": self.restage_count,
        }
