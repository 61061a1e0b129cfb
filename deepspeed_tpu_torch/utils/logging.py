"""Rank-aware logging (counterpart of ``deepspeed_tpu/utils/logging.py``).

``logger`` is the package logger; ``log_dist(msg, ranks)`` logs only on the
listed ranks.  The rank is ``torch.distributed``'s when a process group is
up, else 0.
"""

import logging
import os
import sys

LOG_LEVEL_DEFAULT = logging.INFO

log_levels = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


class LoggerFactory:

    @staticmethod
    def create_logger(name=None, level=LOG_LEVEL_DEFAULT):
        if name is None:
            raise ValueError("name for logger cannot be None")
        formatter = logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(filename)s:%(lineno)d:%(funcName)s] %(message)s")
        logger_ = logging.getLogger(name)
        logger_.setLevel(level)
        logger_.propagate = False
        if not logger_.handlers:
            ch = logging.StreamHandler(stream=sys.stdout)
            ch.setLevel(level)
            ch.setFormatter(formatter)
            logger_.addHandler(ch)
        return logger_


logger = LoggerFactory.create_logger(
    name="deepspeed_tpu_torch",
    level=log_levels.get(os.environ.get("DS_TPU_LOG_LEVEL", "info"), logging.INFO))


def _rank() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message, ranks=None, level=logging.INFO):
    """Log ``message`` only on the given ranks (default: all).

    ``ranks=[-1]`` or ``None`` means every rank.
    """
    my_rank = _rank()
    if ranks is None or -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")
