"""Runtime plumbing (counterpart of ``deepspeed_tpu/runtime/``)."""
