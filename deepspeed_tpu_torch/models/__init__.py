"""Models (counterpart of ``deepspeed_tpu/models/``)."""
