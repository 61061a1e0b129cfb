"""The ``aio`` block (counterpart of
``deepspeed_tpu/runtime/swap_tensor/aio_config.py``): ``block_size``,
``queue_depth``, ``thread_count``, ``single_submit``, ``overlap_events``
and ``use_o_direct``, with the JAX package's defaults.  The swappers'
staging pools take the first three (bounce-buffer size, in-flight depth,
worker threads) and keep the whole block (``aio_config``); ``ops/aio``'s
``AIOHandle`` takes all six."""

from typing import Dict

AIO_DEFAULTS = {
    "block_size": 1 << 20,
    "queue_depth": 32,
    "thread_count": 4,
    "single_submit": False,
    "overlap_events": True,
    "use_o_direct": False,
}


def get_aio_config(param_dict: Dict) -> Dict:
    """The defaults updated by ``param_dict["aio"]``."""
    cfg = dict(AIO_DEFAULTS)
    cfg.update(param_dict.get("aio", {}) or {})
    return cfg
