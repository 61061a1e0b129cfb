"""Operators (counterpart of ``deepspeed_tpu/ops/``)."""
