"""Typed-config plumbing (counterpart of
``deepspeed_tpu/runtime/config_utils.py``).

``DeepSpeedConfigModel`` is a pydantic v2 base class that tolerates (and
records) unknown keys, so a config written for the JAX package parses here
unchanged.
"""

from typing import Any

from pydantic import BaseModel, ConfigDict

from deepspeed_tpu_torch.utils.logging import logger


class DeepSpeedConfigModel(BaseModel):
    """Base for all sub-configs parsed out of the user's JSON document.

    Extra keys are allowed (collected into ``model_extra``); unknown keys
    are logged instead of failing hard.
    """

    model_config = ConfigDict(
        extra="allow",
        populate_by_name=True,
        validate_default=True,
        validate_assignment=True,
        use_enum_values=True,
        arbitrary_types_allowed=True,
        protected_namespaces=(),
    )

    def __init__(self, strict: bool = False, **data: Any) -> None:
        if not strict:
            data = {k: v for k, v in data.items() if (v != "auto" or k == "replace_method")}
        super().__init__(**data)
        extra = getattr(self, "model_extra", None) or {}
        for key in extra:
            logger.debug(f"Config key {key}={extra[key]} not recognized; carried as-is.")

    def get(self, key, default=None):
        return getattr(self, key, default)

    def __getitem__(self, key):
        return getattr(self, key)

    def dict(self, **kwargs):  # pydantic-v1-style alias
        return self.model_dump(**kwargs)


def dict_raise_error_on_duplicate_keys(ordered_pairs):
    """``json.load`` object_pairs_hook that rejects duplicate keys."""
    d = dict((k, v) for k, v in ordered_pairs)
    if len(d) != len(ordered_pairs):
        counter = {}
        for k, _ in ordered_pairs:
            counter[k] = counter.get(k, 0) + 1
        keys = [k for k, v in counter.items() if v > 1]
        raise ValueError(f"Duplicate keys in DeepSpeed config: {keys}")
    return d
