"""Utilities (counterpart of ``deepspeed_tpu/utils/``)."""
