"""Tuning-space enumeration and feature mapping (counterpart of
``deepspeed_tpu/autotuning/utils.py``, the same functions).

Reference: ``deepspeed/autotuning/tuner/utils.py`` (gen_combinations /
flatten / feature mapping) and ``autotuning/utils.py``.
"""

import itertools
from typing import Any, Dict, List


def flatten(d: Dict, parent_key: str = "", sep: str = "_") -> Dict:
    """Nested config dict → flat {joined_key: value}."""
    out = {}
    for k, v in d.items():
        key = f"{parent_key}{sep}{k}" if parent_key else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key, sep))
        else:
            out[key] = v
    return out


def gen_combinations(space: Dict) -> List[Dict]:
    """Cartesian product of every list-valued entry in a (nested) tuning
    space; scalar entries pass through."""
    keys, value_lists = [], []
    for k, v in space.items():
        if isinstance(v, dict):
            subs = gen_combinations(v)
            keys.append(k)
            value_lists.append(subs)
        else:
            keys.append(k)
            value_lists.append(v if isinstance(v, list) else [v])
    out = []
    for combo in itertools.product(*value_lists):
        out.append(dict(zip(keys, combo)))
    return out


def dict_to_feature(flat: Dict, keys: List[str]) -> List[float]:
    """Numeric feature vector for the cost model (non-numeric → hash-ish)."""
    feat = []
    for k in keys:
        v = flat.get(k, 0)
        if isinstance(v, bool):
            feat.append(float(v))
        elif isinstance(v, (int, float)):
            feat.append(float(v))
        else:
            feat.append(float(abs(hash(str(v))) % 1000) / 1000.0)
    return feat


def set_nested(d: Dict, dotted_key: str, value: Any, sep: str = "."):
    parts = dotted_key.split(sep)
    cur = d
    for p in parts[:-1]:
        cur = cur.setdefault(p, {})
    cur[parts[-1]] = value
