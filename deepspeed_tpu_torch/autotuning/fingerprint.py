"""Retune fingerprint: is an emitted patch still valid for THIS run?
(counterpart of ``deepspeed_tpu/autotuning/fingerprint.py``: the same
document, comparison, digest and policies).

A tuned config is hardware- and model-specific, so the closed loop stamps
every emitted ``ds_config_patch.json`` with a fingerprint of the
environment it was tuned on — pod shape (device count, platform, mesh
axes, process count), model dims (``model_info``) and the framework's
version — and :func:`check` compares it at engine build: a patch tuned on a
different environment triggers a retune warning (default) or an outright
:class:`StaleTuningError` refusal (``autotuning.stale_policy: refuse``).

Where the JAX package reads ``jax.devices()``, the port reads torch:
``pod.platform`` is ``"gpu"`` on CUDA and ``"cpu"`` otherwise,
``pod.device_count`` is ``torch.cuda.device_count()`` on CUDA (else 1),
``pod.process_count`` the world size, and ``pod.mesh_shape`` the mesh the
JAX engine would report for the same data-parallel run
(:func:`data_parallel_mesh`).  ``torch_version`` stands where JAX's
document has ``jax_version``.  The comparison runs over the keys both
sides carry, so a patch tuned by the JAX package is never stale for a key
only one side has, and :func:`fingerprint_digest` of one document is the
same in both packages.
"""

import hashlib
import json
import os
from typing import Any, Dict, List, Optional

from deepspeed_tpu_torch.utils.logging import logger

FINGERPRINT_SCHEMA = 1

#: emitted-patch artifact filename inside a results dir
PATCH_BASENAME = "ds_config_patch.json"

#: the JAX engine's mesh axes, in its order (``deepspeed_tpu/parallel/mesh.py``)
MESH_AXES = ("pipe", "data", "fsdp", "expert", "seq", "tensor")


class StaleTuningError(RuntimeError):
    """The applied autotuner patch was tuned on a different environment
    and ``autotuning.stale_policy`` is ``refuse``."""


def data_parallel_mesh(world: int, zero_stage: int) -> Dict[str, int]:
    """The mesh the JAX engine builds for a data-parallel run over
    ``world`` devices (``MeshSpec.from_config``): the devices on ``data``
    at ZeRO-0, on ``fsdp`` at ZeRO >= 1, every other axis 1."""
    mesh = dict.fromkeys(MESH_AXES, 1)
    mesh["fsdp" if int(zero_stage) >= 1 else "data"] = max(1, int(world))
    return mesh


def environment_fingerprint(mesh_shape: Optional[Dict[str, int]] = None,
                            model_dims: Optional[Dict[str, Any]] = None,
                            extra: Optional[Dict[str, Any]] = None,
                            device=None) -> Dict:
    """Fingerprint of the live environment: pod shape, model dims, torch
    version.  ``model_dims`` is whatever the caller can state about the
    model (``num_params`` at minimum); comparison is per present key, so
    a richer producer never invalidates a leaner consumer.  ``device``
    (default: CUDA when it is available) decides the platform."""
    import torch
    from deepspeed_tpu_torch import comm
    cuda = (torch.cuda.is_available() if device is None
            else torch.device(device).type == "cuda")
    fp = {
        "schema": FINGERPRINT_SCHEMA,
        "pod": {
            "device_count": int(torch.cuda.device_count()) if cuda else 1,
            "process_count": int(comm.env_world_size()),
            "platform": "gpu" if cuda else "cpu",
            "mesh_shape": {str(k): int(v)
                           for k, v in (mesh_shape or {}).items()},
        },
        "model": dict(model_dims or {}),
        "torch_version": torch.__version__,
    }
    if extra:
        fp["extra"] = dict(extra)
    return fp


def fingerprint_digest(fp: Dict) -> str:
    """Stable short digest of a fingerprint document."""
    blob = json.dumps(fp, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def compare(stored: Dict, current: Dict) -> List[str]:
    """Mismatch descriptions between a stored and the current
    fingerprint.  Leaf-wise over the keys BOTH sides carry (an absent
    key is unknowable, not stale); empty list = still valid."""
    out: List[str] = []

    def _walk(a, b, path):
        if isinstance(a, dict) and isinstance(b, dict):
            for k in sorted(set(a) & set(b)):
                _walk(a[k], b[k], f"{path}.{k}" if path else str(k))
            return
        if a != b:
            out.append(f"{path}: tuned on {a!r}, now {b!r}")

    stored = {k: v for k, v in (stored or {}).items() if k != "schema"}
    current = {k: v for k, v in (current or {}).items() if k != "schema"}
    _walk(stored, current, "")
    return out


def resolve_patch_path(autotuning_cfg: Dict) -> Optional[str]:
    """The patch artifact a config points at: ``autotuning.patch``
    directly, else ``autotuning.results_dir``/ds_config_patch.json."""
    cfg = autotuning_cfg or {}
    if cfg.get("patch"):
        return str(cfg["patch"])
    if cfg.get("results_dir"):
        return os.path.join(str(cfg["results_dir"]), PATCH_BASENAME)
    return None


def check(patch_doc_or_path,
          current_fp: Dict,
          policy: str = "warn") -> List[str]:
    """Compare a patch artifact's stored fingerprint against the current
    environment.  Returns the mismatch list; ``policy`` is ``off`` (skip),
    ``warn`` (log each mismatch, default) or ``refuse`` (raise
    :class:`StaleTuningError`).  A missing/unreadable artifact is a
    warning, never a refusal — the run simply has nothing to validate."""
    if policy == "off":
        return []
    if isinstance(patch_doc_or_path, str):
        try:
            with open(patch_doc_or_path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            logger.warning(
                f"autotune.check: cannot read patch artifact "
                f"{patch_doc_or_path}: {e}")
            return []
    else:
        doc = patch_doc_or_path or {}
    stored = doc.get("fingerprint")
    if not isinstance(stored, dict):
        logger.warning("autotune.check: patch artifact carries no "
                       "fingerprint; cannot validate staleness")
        return []
    mismatches = compare(stored, current_fp)
    if not mismatches:
        return []
    detail = "; ".join(mismatches)
    if policy == "refuse":
        raise StaleTuningError(
            "autotuned config is stale — the environment changed since the "
            f"tune ({detail}); re-run the autotuner or set "
            "autotuning.stale_policy to 'warn'")
    logger.warning(
        f"autotune.check: tuned config may be stale ({detail}); consider "
        "re-running the autotuner")
    return mismatches


def check_engine(autotuning_cfg: Dict,
                 mesh_shape: Dict[str, int],
                 params=None,
                 num_params: Optional[int] = None,
                 device=None) -> List[str]:
    """The engine-build hook: when the ds_config applies a tuned patch
    (``autotuning.patch`` / ``autotuning.results_dir``), validate its
    fingerprint against the live mesh + model + torch version.  ``params``
    is a tree of tensors, counted when ``num_params`` is not given."""
    path = resolve_patch_path(autotuning_cfg)
    if path is None:
        return []
    if num_params is None and params is not None:
        num_params = sum(int(t.numel()) for t in _leaves(params))
    dims = {}
    if num_params is not None:
        dims["num_params"] = int(num_params)
    current = environment_fingerprint(mesh_shape=mesh_shape, model_dims=dims, device=device)
    policy = str((autotuning_cfg or {}).get("stale_policy", "warn"))
    return check(path, current, policy=policy)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]
