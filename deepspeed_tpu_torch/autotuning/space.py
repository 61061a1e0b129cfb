"""Typed search space over the config knobs (counterpart of
``deepspeed_tpu/autotuning/space.py``: the same catalog, guards, default
space, candidates and patches).

Each tunable axis is a :class:`Knob` with its dotted ``ds_config`` path,
candidate values and an optional coherence guard, so the cartesian product
never emits configs the engine would reject for structural (not memory)
reasons.  Three path namespaces:

* ``a.b.c``  — nested ``ds_config`` key, applied with ``set_nested``;
* ``env.X``  — an environment variable for the trial subprocess (the
  fused-kernel gates ``DST_PALLAS_*`` are env-scoped, not config keys);
* ``mesh``   — the whole mesh-axes dict (one knob whose value is the axis
  mapping).

The port's one rule of its own: a ``kind="kernel"`` knob may not list
``"0"``.  In the JAX package ``"0"`` picks XLA's plain path; the port keeps
no plain path on the card (a kernel wrapper launches its kernel or
raises), so such a space is refused with :class:`PlainPathKnobError`
rather than tuning an axis that changes nothing.  ``"1"`` is accepted and
changes nothing: the kernels are the only path.

A :class:`Candidate` is the normalized patch (dependent knobs whose guard
is off are dropped, then duplicates collapse), which is also the
provenance unit: the manifest records every candidate's patch verbatim, and
the winning patch is what ``ds_config_patch.json`` carries.
"""

import copy
import itertools
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from deepspeed_tpu_torch.autotuning.utils import set_nested

#: trial-subprocess env namespace inside a patch
ENV_PREFIX = "env."

#: the value of a kernel knob that picks the plain path in the JAX package
PLAIN_PATH_VALUE = "0"


@dataclass(frozen=True)
class Knob:
    """One tunable axis: a name, the config path it patches, and the
    candidate values.  ``only_if`` guards coherence: a dict of
    ``{other_knob_name: allowed values}`` — when violated the knob is
    dropped from the candidate (not the candidate from the space)."""
    name: str
    path: str
    values: Tuple[Any, ...]
    kind: str = "runtime"            # mesh|zero|batch|offload|kernel|serving
    only_if: Optional[Dict[str, Tuple[Any, ...]]] = None

    def guard_ok(self, chosen: Dict[str, Any]) -> bool:
        if not self.only_if:
            return True
        for other, allowed in self.only_if.items():
            if other in chosen and chosen[other] not in allowed:
                return False
        return True


#: the knob catalog, the JAX package's: ``SearchSpace.from_config`` picks
#: the subset a run varies
KNOB_CATALOG: Tuple[Knob, ...] = (
    # mesh shape: the whole axes dict is one value
    Knob("mesh_shape", "mesh", (), kind="mesh"),
    # ZeRO stage + ZeRO++ compression
    Knob("zero_stage", "zero_optimization.stage", (1, 2, 3), kind="zero"),
    Knob("qwz", "zero_optimization.zero_quantized_weights", (False, True),
         kind="zero", only_if={"zero_stage": (3,)}),
    Knob("qwz_bits", "zero_optimization.zero_quantized_weights_bits", (8, 4),
         kind="zero", only_if={"qwz": (True,)}),
    Knob("qgz", "zero_optimization.zero_quantized_gradients", (False, True),
         kind="zero", only_if={"zero_stage": (3,)}),
    Knob("qgz_bits", "zero_optimization.zero_quantized_gradients_bits", (8, 4),
         kind="zero", only_if={"qgz": (True,)}),
    Knob("hpz_partition_size", "zero_optimization.zero_hpz_partition_size",
         (1, 2, 4), kind="zero", only_if={"zero_stage": (3,)}),
    Knob("quant_block_size", "zero_optimization.zero_quantization_block_size",
         (64, 256, 1024), kind="zero"),
    # batch shape
    Knob("micro_batch", "train_micro_batch_size_per_gpu",
         (1, 2, 4, 8, 16), kind="batch"),
    Knob("gas", "gradient_accumulation_steps", (1, 2, 4), kind="batch"),
    # beyond-HBM residency
    Knob("prefetch_depth", "zero_optimization.prefetch_depth", (1, 2, 4),
         kind="offload"),
    Knob("hbm_budget_bytes", "zero_optimization.hbm_budget_bytes", (0,),
         kind="offload"),
    Knob("offload_param", "zero_optimization.offload_param.device",
         (None, "cpu", "nvme"), kind="offload", only_if={"zero_stage": (3,)}),
    Knob("offload_optimizer", "zero_optimization.offload_optimizer.device",
         (None, "cpu", "nvme"), kind="offload", only_if={"zero_stage": (3,)}),
    # fused-kernel gates (env-scoped; "0" is refused in the port, see above)
    Knob("pallas_ce", "env.DST_PALLAS_CE", ("0", "1"), kind="kernel"),
    Knob("pallas_fused_opt", "env.DST_PALLAS_FUSED_OPT", ("0", "1"),
         kind="kernel"),
    # serving arena / chunked prefill
    Knob("serve_num_blocks", "serving.num_blocks", (128, 256, 512),
         kind="serving"),
    Knob("serve_prefill_chunk", "serving.prefill_chunk", (32, 64, 128),
         kind="serving"),
)

_CATALOG_BY_NAME = {k.name: k for k in KNOB_CATALOG}


class UnknownKnobError(ValueError):
    """A search_space entry names no catalog knob — refuse instead of
    silently tuning nothing."""


class PlainPathKnobError(ValueError):
    """A kernel knob lists ``"0"``, the JAX package's plain path, which the
    port does not have on the card."""


class SearchSpace:
    """The knob subset one tuning run varies.

    ``knobs`` maps knob name -> value tuple (overriding the catalog's
    candidates); every name must exist in :data:`KNOB_CATALOG` so typos
    fail loudly at construction, not as a silently-constant axis.
    """

    def __init__(self, knobs: Dict[str, Sequence[Any]]):
        self.knobs: List[Knob] = []
        for name, values in knobs.items():
            base = _CATALOG_BY_NAME.get(name)
            if base is None:
                raise UnknownKnobError(
                    f"unknown knob {name!r}; catalog: "
                    f"{sorted(_CATALOG_BY_NAME)}")
            vals = tuple(values) if not isinstance(values, tuple) else values
            if not vals:
                raise UnknownKnobError(f"knob {name!r} has no values")
            if base.kind == "kernel" and any(str(v) == PLAIN_PATH_VALUE for v in vals):
                raise PlainPathKnobError(
                    f"kernel knob {name!r} lists {PLAIN_PATH_VALUE!r}, the plain path: the "
                    f"port has no plain path on the card (each kernel wrapper launches its "
                    f"hand-written kernel or raises; ROADMAP.md, North star), so this axis "
                    f"would tune nothing; list only '1'")
            self.knobs.append(Knob(base.name, base.path, vals, base.kind,
                                   base.only_if))

    @classmethod
    def from_config(cls, autotuning_cfg: Dict) -> "SearchSpace":
        """Build from the ``autotuning.search_space`` config block; when
        absent, a small default over the highest-leverage knobs."""
        space = (autotuning_cfg or {}).get("search_space")
        if not space:
            space = {"zero_stage": (1, 3), "micro_batch": (1, 4, 16),
                     "qwz": (False, True), "qgz": (False, True),
                     "prefetch_depth": (1, 2)}
        return cls(space)

    def enumerate(self) -> List["Candidate"]:
        """Cartesian product over the knob values, coherence-guarded and
        deduplicated (a knob whose guard is off is dropped from the
        patch, so e.g. ``qwz_bits`` never multiplies the qwZ-off half of
        the space)."""
        names = [k.name for k in self.knobs]
        out: List[Candidate] = []
        seen = set()
        for combo in itertools.product(*[k.values for k in self.knobs]):
            chosen = dict(zip(names, combo))
            patch: Dict[str, Any] = {}
            kept: Dict[str, Any] = {}
            for k in self.knobs:
                if not k.guard_ok(chosen):
                    continue
                v = chosen[k.name]
                if v is None:
                    continue             # None = leave the base config's value
                patch[k.path] = v
                kept[k.name] = v
            cand = Candidate(cid=f"c{len(out):04d}", patch=patch, knobs=kept)
            if cand.key() in seen:
                continue
            seen.add(cand.key())
            out.append(cand)
        return out


@dataclass
class Candidate:
    """One point of the search space: the normalized config patch."""
    cid: str
    patch: Dict[str, Any]            # dotted path -> value (incl. env.*)
    knobs: Dict[str, Any] = field(default_factory=dict)   # name -> value

    def key(self) -> str:
        return json.dumps(self.patch, sort_keys=True, default=str)

    def env(self) -> Dict[str, str]:
        """The env-var slice of the patch (trial subprocess scope)."""
        return {p[len(ENV_PREFIX):]: str(v)
                for p, v in self.patch.items()
                if p.startswith(ENV_PREFIX) and v is not None}

    def config_patch(self) -> Dict[str, Any]:
        """The ds_config slice of the patch (dotted paths)."""
        return {p: v for p, v in self.patch.items()
                if not p.startswith(ENV_PREFIX)}


def apply_patch(base_config: Dict, patch: Dict[str, Any]) -> Dict:
    """Base ds_config + dotted-path patch -> the trial config (deep copy;
    ``env.*`` entries are skipped — they scope to the subprocess, and a
    ``mesh`` whole-dict value replaces the mesh block)."""
    cfg = copy.deepcopy(base_config)
    for path, value in patch.items():
        if path.startswith(ENV_PREFIX):
            continue
        if path == "mesh" and isinstance(value, dict):
            cfg["mesh"] = dict(value)
            continue
        set_nested(cfg, path, value)
    return cfg


def patch_diff(base_config: Dict, patch: Dict[str, Any]) -> Dict[str, Dict]:
    """Reviewable JSON diff: for each patched path, the base config's
    value (``None`` when unset) and the patch's."""
    def _get(cfg, dotted):
        cur = cfg
        for part in dotted.split("."):
            if not isinstance(cur, dict) or part not in cur:
                return None
            cur = cur[part]
        return cur

    diff = {}
    for path, value in sorted(patch.items()):
        if path.startswith(ENV_PREFIX):
            diff[path] = {"from": None, "to": value}
        else:
            diff[path] = {"from": _get(base_config, path), "to": value}
    return diff
