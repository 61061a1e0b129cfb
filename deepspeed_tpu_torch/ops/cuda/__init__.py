"""Hand-written CUDA kernels for Hopper (counterpart of
``deepspeed_tpu/ops/pallas/``).  Sources live in ``csrc/``; ``builder``
compiles them at first use."""
