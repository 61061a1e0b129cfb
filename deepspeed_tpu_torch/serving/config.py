"""Serving config — the ``"serving"`` block of the ds_config document
(counterpart of ``deepspeed_tpu/serving/config.py``; ``torch_dtype`` takes
the place of ``jnp_dtype``).

The reference snapshot (v0.8.3) predates DeepSpeed-FastGen, so there is no
reference config surface to mirror; the knobs follow the same shape
philosophy as the rest of ``runtime/config.py``: one pydantic block, safe
defaults, every field documented where it is consumed.

Sizing guidance (README § Serving): ``block_size`` trades internal
fragmentation (last-block waste, avg block_size/2 tokens per sequence)
against block-table length and scatter/gather granularity — 16 suits toy
and CPU runs, 32–64 suits real HBM arenas.  ``num_blocks`` bounds the
arena: total KV bytes = 2 * n_layer * num_blocks * block_size * kv_heads *
head_dim * dtype_bytes.
"""

from typing import Dict, Optional

from pydantic import Field

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel


class DeepSpeedServingConfig(DeepSpeedConfigModel):
    """``serving`` block — continuous batching + paged KV cache
    (``deepspeed_tpu_torch/serving/``).  See README § Serving."""
    enabled: bool = False
    # ---- paged KV arena -------------------------------------------------- #
    block_size: int = 16          # tokens per physical KV block
    num_blocks: int = 256         # arena capacity in blocks (incl. trash)
    max_blocks_per_seq: int = 0   # 0 -> ceil(n_positions / block_size)
    # ---- continuous batching --------------------------------------------- #
    max_batch_size: int = 8       # decode slots (fixed compiled batch shape)
    prefill_chunk: int = 64       # chunked-prefill tokens per engine step
    max_queue: int = 1024         # waiting-queue bound; submit raises past it
    # ---- scheduling ------------------------------------------------------ #
    slo_preemption: bool = True   # higher SLO classes may evict lower ones
    # per-class TTFT bounds (ms) for the goodput ledger's tokens-within-
    # bound accounting; unset classes use telemetry/ledger.py defaults
    slo_ttft_bound_ms: Dict[str, float] = Field(default_factory=dict)
    max_new_tokens_default: int = 64
    eos_token_id: Optional[int] = None
    # ---- tiered KV (serving/kv_tiering.py) -------------------------------- #
    kv_tiering: bool = False          # spill preempted KV to host/NVMe
    kv_offload_dir: Optional[str] = None   # None -> private tempdir
    kv_host_cache_bytes: int = 1 << 30     # host-LRU tier budget
    kv_spill_budget_bytes: int = 0         # total spill cap; 0 = unbounded
    # JAX's copy-ring chunk (blocks) and outstanding D2H gathers; the
    # port copies a spill in one stream-ordered gather (serving/kv_tiering.py)
    kv_spill_chunk_blocks: int = 8
    kv_ring_depth: int = 2
    # ---- prefix cache (serving/prefix_cache.py) --------------------------- #
    prefix_cache: bool = False        # share full prompt blocks, refcounted
    prefix_cache_blocks: int = 0      # pinned-block cap; 0 = unbounded
    # ---- resilience (README § Serving resilience) -------------------------- #
    # per-class request deadline (ms from arrival); an expired request is
    # cancelled at the next step boundary, its blocks freed and its prefill
    # booked as wasted.  Unset/0 classes have no deadline.
    deadline_ms: Dict[str, float] = Field(default_factory=dict)
    # bounded step dispatch (comm/bounded.py): a compiled serve step that
    # exceeds this raises ServeStepTimeout and triggers in-process
    # recovery instead of hanging the engine forever.  0 = inline dispatch.
    serve_step_timeout_s: float = 0.0
    # adaptive admission ladder (scheduler.AdmissionController): the
    # oldest-waiting age that trips brownout; 2x trips batch-class shed,
    # 4x sheds standard too.  0 disables the queue-age signal (the
    # SLOMonitor TTFT-burn signal still drives the ladder when wired).
    queue_age_watermark_ms: float = 0.0
    brownout_max_new_tokens: int = 0  # brownout cap on max_new_tokens; 0 = off
    shed_recovery_steps: int = 16     # calm step evaluations per rung down
    # ---- numerics / misc ------------------------------------------------- #
    dtype: str = "bfloat16"
    seed: int = 0
    telemetry_every: int = 8      # serve_step gauge cadence (engine steps)

    @property
    def torch_dtype(self):
        from deepspeed_tpu_torch.models.gpt import as_torch_dtype
        return as_torch_dtype(self.dtype)
