"""The launcher CLI (counterpart of ``deepspeed_tpu/launcher/runner.py``;
reference ``deepspeed/launcher/runner.py``), run as ``python -m
deepspeed_tpu_torch.launcher.runner`` or ``dst-torch``.

Responsibilities (reference line cites):
* resource parsing: hostfile ``host slots=N`` (``runner.py:179-232``),
  ``--include``/``--exclude`` filters (``:234-324``);
* local GPU discovery when there is no hostfile: one slot per GPU this
  host shows (``CUDA_VISIBLE_DEVICES`` honoured), in place of the JAX
  package's TPU pod discovery (one process per host);
* single-node: exec ``deepspeed_tpu_torch.launcher.launch`` directly
  (``runner.py:466-484``);
* multi-node: build a pdsh/mpirun/srun command that re-invokes the per-node
  launcher on every host (``runner.py:487-498``) — command construction is
  unit-testable without ssh;
* ``.deepspeed_env`` propagation (``runner.py:36,514-520``);
* ``--autotuning tune|run`` (``runner.py:439``): the ``Autotuner`` runs
  experiments of the user script through a ``ResourceManager``
  (``autotuning_exps/``, ``autotuning_results/`` in the working directory)
  and writes ``ds_config_optimal.json``; ``run`` then launches the job with
  ``DS_AUTOTUNING_CONFIG`` pointing at it.
"""

import argparse
import base64
import json
import os
import shlex
import subprocess
import sys
from collections import OrderedDict
from typing import Dict, List, Optional

from deepspeed_tpu_torch.launcher.multinode_runner import (MPICHRunner, OpenMPIRunner,
                                                           PDSHRunner, SlurmRunner)
from deepspeed_tpu_torch.utils.logging import logger

DLTS_HOSTFILE = "/job/hostfile"
EXPORT_ENVS = ["PYTHON", "PATH", "LD_LIBRARY", "CUDA", "NCCL", "TORCH",
               "DST", "DS_"]  # DS_: the elastic and recovery contract
DEEPSPEED_ENVIRONMENT_NAME = ".deepspeed_env"


def parse_args(args=None):
    parser = argparse.ArgumentParser(
        prog="dst-torch",
        description="dst-torch: distributed training launcher for deepspeed_tpu_torch")
    parser.add_argument("-H", "--hostfile", type=str, default=DLTS_HOSTFILE,
                        help="Hostfile path: lines of '<host> slots=<n>'")
    parser.add_argument("-i", "--include", type=str, default="",
                        help="Host filter, e.g. 'worker-0@worker-1:0,2'")
    parser.add_argument("-e", "--exclude", type=str, default="",
                        help="Host exclusion filter, same syntax as --include")
    parser.add_argument("--num_nodes", type=int, default=-1,
                        help="Limit the number of nodes used")
    parser.add_argument("--num_procs", "--num_gpus", dest="num_procs", type=int, default=-1,
                        help="Processes per node (default: the hostfile's slots, "
                             "else one per local GPU)")
    parser.add_argument("--master_addr", type=str, default="",
                        help="torch.distributed rendezvous address (MASTER_ADDR)")
    parser.add_argument("--master_port", type=int, default=29500,
                        help="torch.distributed rendezvous port (MASTER_PORT)")
    parser.add_argument("--launcher", type=str, default="pdsh",
                        choices=["pdsh", "openmpi", "mpich", "slurm"],
                        help="Multi-node transport")
    parser.add_argument("--launcher_args", type=str, default="",
                        help="Extra flags for the multi-node transport")
    parser.add_argument("--force_multi", action="store_true",
                        help="Treat as multi-node even for a single host")
    parser.add_argument("--autotuning", type=str, default="",
                        choices=["", "tune", "run"],
                        help="Run the autotuner to discover config values")
    parser.add_argument("--enable_elastic_training", action="store_true",
                        help="Supervise workers with the elastic agent: "
                             "restart on failure / membership change")
    parser.add_argument("--max_elastic_restarts", type=int, default=3,
                        help="Elastic agent restart budget")
    parser.add_argument("user_script", type=str, help="User training script")
    parser.add_argument("user_args", nargs=argparse.REMAINDER,
                        help="User script arguments")
    return parser.parse_args(args=args)


# --------------------------------------------------------------------------- #
# Resource discovery
# --------------------------------------------------------------------------- #
def fetch_hostfile(hostfile_path: str) -> "OrderedDict[str, int]":
    """Parse ``host slots=N`` lines (reference ``runner.py:179``)."""
    if not os.path.isfile(hostfile_path):
        return OrderedDict()
    resources: "OrderedDict[str, int]" = OrderedDict()
    with open(hostfile_path) as fd:
        for line in fd:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                host, slots = line.split()
                key, count = slots.split("=")
                if key != "slots":
                    raise ValueError(f"expected slots=<n>, got {slots!r}")
                resources[host] = int(count)
            except ValueError as e:
                raise ValueError(f"Hostfile error: bad line {line!r} "
                                 f"(want '<host> slots=<n>')") from e
    return resources


def local_gpu_count(env: Optional[Dict[str, str]] = None) -> int:
    """GPUs this host shows to its processes: the entries of
    ``CUDA_VISIBLE_DEVICES`` when it is set (empty or ``-1``: none), else
    the lines of ``nvidia-smi -L``; 0 without a GPU."""
    env = os.environ if env is None else env
    visible = env.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        ids = [v.strip() for v in visible.split(",") if v.strip()]
        if ids and ids[0].startswith("-"):
            return 0
        return len(ids)
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return 0
    if out.returncode != 0:
        return 0
    return sum(1 for line in out.stdout.splitlines() if line.startswith("GPU "))


def discover_local_gpus(env: Optional[Dict[str, str]] = None) -> "OrderedDict[str, int]":
    """``{"localhost": n}`` for this host's n GPUs (one process a GPU), or
    empty without one."""
    n = local_gpu_count(env)
    return OrderedDict({"localhost": n}) if n > 0 else OrderedDict()


def _parse_filter(spec: str) -> Dict[str, Optional[List[int]]]:
    """'w0@w1:0,2' → {'w0': None, 'w1': [0, 2]} (None = all slots)."""
    out: Dict[str, Optional[List[int]]] = {}
    for part in spec.split("@"):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            host, slots = part.split(":")
            out[host.strip()] = [int(s) for s in slots.split(",")]
        else:
            out[part] = None
    return out


def parse_inclusion_exclusion(resources: "OrderedDict[str, int]",
                              include: str, exclude: str) -> "OrderedDict[str, int]":
    """Apply --include/--exclude (reference ``runner.py:324``).  Slot-level
    filters adjust counts; host-level filters drop hosts."""
    assert not (include and exclude), "--include and --exclude are mutually exclusive"
    if include:
        inc = _parse_filter(include)
        for host in inc:
            assert host in resources, f"--include host {host!r} not in resources"
        return OrderedDict(
            (h, len(inc[h]) if inc[h] is not None else resources[h])
            for h in resources if h in inc)
    if exclude:
        exc = _parse_filter(exclude)
        out = OrderedDict()
        for h, n in resources.items():
            if h not in exc:
                out[h] = n
            elif exc[h] is not None:
                remaining = n - len(exc[h])
                if remaining > 0:
                    out[h] = remaining
        return out
    return OrderedDict(resources)


def encode_world_info(resources: "OrderedDict[str, int]") -> str:
    return base64.urlsafe_b64encode(
        json.dumps(dict(resources)).encode()).decode()


def collect_env_exports(cwd: str = ".",
                        env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Env vars to propagate to remote nodes: the EXPORT_ENVS prefixes plus
    anything listed in a ``.deepspeed_env`` file (reference ``runner.py:36``).
    ``env`` overrides the process environment (elastic restarts pass the
    per-start env so the exports match it)."""
    exports = {}
    for key, val in (env if env is not None else os.environ).items():
        if any(key.startswith(p) for p in EXPORT_ENVS):
            exports[key] = val
    env_file = os.path.join(cwd, DEEPSPEED_ENVIRONMENT_NAME)
    if not os.path.isfile(env_file):
        env_file = os.path.join(os.path.expanduser("~"), DEEPSPEED_ENVIRONMENT_NAME)
    if os.path.isfile(env_file):
        with open(env_file) as fd:
            for line in fd:
                line = line.strip()
                if line and not line.startswith("#") and "=" in line:
                    k, v = line.split("=", 1)
                    exports[k.strip()] = v.strip()
    return exports


# --------------------------------------------------------------------------- #
def build_launch_cmd(args, resources: "OrderedDict[str, int]") -> List[str]:
    """The single-node command: python -m deepspeed_tpu_torch.launcher.launch
    ... (reference ``runner.py:466-484``)."""
    world_info = encode_world_info(resources)
    cmd = [sys.executable, "-u", "-m", "deepspeed_tpu_torch.launcher.launch",
           f"--world_info={world_info}",
           f"--master_addr={args.master_addr or '127.0.0.1'}",
           f"--master_port={args.master_port}"]
    if args.num_procs > 0:
        cmd.append(f"--num_procs={args.num_procs}")
    cmd.append(args.user_script)
    cmd.extend(args.user_args)
    return cmd


def _find_user_config(user_args):
    """Pull the --deepspeed_config path out of the user script args."""
    for i, a in enumerate(user_args):
        if a == "--deepspeed_config" and i + 1 < len(user_args):
            return user_args[i + 1]
        if a.startswith("--deepspeed_config="):
            return a.split("=", 1)[1]
    return None


def resolve_resources(args) -> "OrderedDict[str, int]":
    """hostfile / local GPU discovery + include/exclude + --num_nodes, the
    single source of truth for the target host set (initial launch AND
    elastic restarts resolve through here)."""
    resources = fetch_hostfile(args.hostfile)
    if not resources:
        resources = discover_local_gpus()
    if not resources:
        resources = OrderedDict({"localhost": 1})
    resources = parse_inclusion_exclusion(resources, args.include, args.exclude)
    assert resources, "no usable hosts after include/exclude filtering"
    if args.num_nodes > 0:
        resources = OrderedDict(list(resources.items())[:args.num_nodes])
    return resources


def main(args=None):
    args = parse_args(args)

    if args.autotuning:
        # the launcher hands off to the autotuner, which runs experiments
        # of the user script (each reads its mutated config through
        # DS_AUTOTUNING_CONFIG, which initialize() honours) and writes the
        # optimal config; 'run' then launches the real job with it
        # (deepspeed_tpu/launcher/runner.py:226-249)
        from deepspeed_tpu_torch.autotuning import Autotuner, ResourceManager
        from deepspeed_tpu_torch.autotuning.scheduler import CONFIG_PATH_ENV
        cfg_path = _find_user_config(args.user_args)
        if not cfg_path:
            raise ValueError("--autotuning needs --deepspeed_config <json> in the user "
                             "script arguments")
        with open(cfg_path) as f:
            user_config = json.load(f)
        cmd = [sys.executable, args.user_script] + list(args.user_args)
        rm = ResourceManager("autotuning_exps", cmd=cmd,
                             metric=user_config.get("autotuning", {}).get("metric", "throughput"))
        tuner = Autotuner(user_config, resource_manager=rm)
        best = tuner.tune()
        if args.autotuning == "tune" or best is None:
            logger.info(f"autotuning done; best config: {best}")
            return 0
        os.environ[CONFIG_PATH_ENV] = os.path.abspath(
            os.path.join(tuner.results_dir, "ds_config_optimal.json"))

    resources = resolve_resources(args)

    multi_node = args.force_multi or len(resources) > 1
    if not multi_node:
        cmd = build_launch_cmd(args, resources)
        logger.info(f"dst single-node: {' '.join(map(shlex.quote, cmd))}")
        if args.enable_elastic_training:
            from deepspeed_tpu_torch.elasticity.elastic_agent import (DSElasticAgent,
                                                                      WorkerSpec)
            cfg_path = _find_user_config(args.user_args)
            ds_cfg = json.load(open(cfg_path)) if cfg_path else {}
            agent = DSElasticAgent(WorkerSpec(cmd), ds_config=ds_cfg,
                                   max_restarts=args.max_elastic_restarts)
            return agent.run()
        result = subprocess.run(cmd)
        return result.returncode

    runner_cls = {"pdsh": PDSHRunner, "openmpi": OpenMPIRunner,
                  "mpich": MPICHRunner, "slurm": SlurmRunner}[args.launcher]
    runner = runner_cls(args, resources)
    exports = collect_env_exports()
    cmd = runner.get_cmd(exports, resources)
    logger.info(f"dst multi-node ({args.launcher}): "
                f"{' '.join(map(shlex.quote, cmd))}")
    if args.enable_elastic_training:
        from deepspeed_tpu_torch.elasticity.elastic_agent import (DSElasticAgent,
                                                                  WorkerSpec)
        cfg_path = _find_user_config(args.user_args)
        ds_cfg = json.load(open(cfg_path)) if cfg_path else {}

        def build_cmd(env):
            # re-read the hostfile and re-collect env (incl. DS_ELASTIC_*)
            # so each restart targets the live membership
            res = resolve_resources(args)
            return runner_cls(args, res).get_cmd(
                collect_env_exports(env=env), res)

        agent = DSElasticAgent(
            WorkerSpec(build_cmd), ds_config=ds_cfg,
            max_restarts=args.max_elastic_restarts,
            world_size_fn=lambda: sum(resolve_resources(args).values()))
        return agent.run()
    result = subprocess.run(cmd)
    return result.returncode


if __name__ == "__main__":
    sys.exit(main())
