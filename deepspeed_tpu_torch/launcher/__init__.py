"""Launcher (counterpart of ``deepspeed_tpu/launcher/``): the CLI
(``runner.py``: resource parsing, multi-node dispatch, the elastic agent),
the per-node spawner (``launch.py``: one process a GPU, the
``torch.distributed`` env wired, failures propagated) and the multi-node
transports (``multinode_runner.py``: pdsh / mpi / slurm command lines).
"""
