"""Per-node launcher (counterpart of ``deepspeed_tpu/launcher/launch.py``;
reference ``deepspeed/launcher/launch.py:120``).

Decodes ``--world_info`` (base64 JSON host→slots, the JAX package's
format), determines this node's rank, forks one child per local slot with
the ``torch.distributed`` env wired (``RANK`` / ``LOCAL_RANK`` /
``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``), streams output, and
propagates failures: if any child dies, the whole tree is killed and the
launcher exits non-zero (reference ``launch.py:106,295``).

One process a GPU: a node's slots are its GPUs, and child ``LOCAL_RANK``
binds ``cuda:LOCAL_RANK`` (``accelerator/real_accelerator.py:
resolve_device``) before it makes its NCCL group.  The JAX package's
``jax.distributed`` aliases (``PROCESS_ID``, ``NUM_PROCESSES``,
``COORDINATOR_ADDRESS``) are not set.  A SIGTERM to the launcher is passed
on to every child (a preemption notice reaches each rank's handler), and
the launcher then exits with the first non-zero code a child gave, so an
elastic agent above it sees a child's preemption exit (143) as it is.
"""

import argparse
import base64
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import time
from typing import List

# stdlib only, the package's log format: the launcher imports no torch, so
# ``python deepspeed_tpu_torch/launcher/launch.py`` starts in a fraction of
# a second (``-m`` imports the package, and with it torch, first)
logger = logging.getLogger("deepspeed_tpu_torch.launcher")
if not logger.handlers:
    _handler = logging.StreamHandler(stream=sys.stdout)
    _handler.setFormatter(logging.Formatter(
        "[%(asctime)s] [%(levelname)s] [%(filename)s:%(lineno)d:%(funcName)s] %(message)s"))
    logger.addHandler(_handler)
    logger.setLevel(logging.INFO)
    logger.propagate = False


# seconds the children get after a SIGTERM before they are killed: a
# preempted rank's final synchronous checkpoint (GPT-2: ~5 s on an H100)
# must fit in it
TERM_GRACE_S = 60.0


def parse_args(args=None):
    parser = argparse.ArgumentParser(prog="dst-torch-launch")
    parser.add_argument("--world_info", type=str, required=True,
                        help="base64 JSON of host → slot count")
    parser.add_argument("--node_rank", type=int, default=-1,
                        help="This node's rank; derived from hostname or "
                             "scheduler env when -1")
    parser.add_argument("--master_addr", type=str, default="127.0.0.1")
    parser.add_argument("--master_port", type=int, default=29500)
    parser.add_argument("--num_procs", type=int, default=-1,
                        help="Override processes on this node")
    parser.add_argument("--enable_each_rank_log", type=str, default="",
                        help="Directory for per-rank log files")
    parser.add_argument("user_script", type=str)
    parser.add_argument("user_args", nargs=argparse.REMAINDER)
    return parser.parse_args(args=args)


def decode_world_info(encoded: str):
    return json.loads(base64.urlsafe_b64decode(encoded.encode()).decode())


def resolve_node_rank(args, hosts: List[str]) -> int:
    if args.node_rank >= 0:
        return args.node_rank
    for env in ("SLURM_NODEID", "OMPI_COMM_WORLD_RANK", "PMI_RANK"):
        if env in os.environ:
            return int(os.environ[env])
    hostname = socket.gethostname()
    for i, h in enumerate(hosts):
        if h in (hostname, hostname.split(".")[0], "localhost", "127.0.0.1"):
            return i
    raise RuntimeError(f"cannot determine node rank: hostname {hostname!r} "
                       f"not in world {hosts}")


def main(args=None):
    args = parse_args(args)
    world = decode_world_info(args.world_info)
    hosts = list(world.keys())
    node_rank = resolve_node_rank(args, hosts)
    local_procs = args.num_procs if args.num_procs > 0 else world[hosts[node_rank]]
    global_rank_offset = sum(
        (args.num_procs if args.num_procs > 0 else world[h])
        for h in hosts[:node_rank])
    world_size = sum((args.num_procs if args.num_procs > 0 else world[h])
                     for h in hosts)

    log_dir = args.enable_each_rank_log
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)

    processes = []
    for local_rank in range(local_procs):
        rank = global_rank_offset + local_rank
        env = dict(os.environ)
        env.update(
            RANK=str(rank),
            LOCAL_RANK=str(local_rank),
            WORLD_SIZE=str(world_size),
            MASTER_ADDR=args.master_addr,
            MASTER_PORT=str(args.master_port),
        )
        cmd = [sys.executable, "-u", args.user_script] + list(args.user_args)
        if log_dir:
            out = open(os.path.join(log_dir, f"rank_{rank}.log"), "w")
            proc = subprocess.Popen(cmd, env=env, stdout=out, stderr=subprocess.STDOUT)
        else:
            proc = subprocess.Popen(cmd, env=env)
        processes.append(proc)
        logger.info(f"dst-torch-launch: rank {rank} (local {local_rank}) pid={proc.pid}")

    def kill_all(signum=None, frame=None):
        for p in processes:
            if p.poll() is None:
                p.terminate()
        deadline = time.time() + TERM_GRACE_S
        for p in processes:
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()

    signal.signal(signal.SIGTERM, kill_all)
    signal.signal(signal.SIGINT, kill_all)

    # monitor: first non-zero exit kills the tree (reference launch.py:295)
    rc = 0
    try:
        while processes:
            for p in list(processes):
                ret = p.poll()
                if ret is None:
                    continue
                processes.remove(p)
                if ret != 0:
                    logger.error(f"dst-torch-launch: pid {p.pid} exited rc={ret}; "
                                 f"killing remaining processes")
                    kill_all()
                    return ret
            time.sleep(0.1)
    finally:
        kill_all()
    return rc


if __name__ == "__main__":
    sys.exit(main())
