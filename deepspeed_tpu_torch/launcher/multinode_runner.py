"""Multi-node transport command builders (counterpart of
``deepspeed_tpu/launcher/multinode_runner.py``; reference
``deepspeed/launcher/multinode_runner.py:51,107,160,208``).

Each runner turns (args, resources, exports) into ONE command line that
re-invokes ``deepspeed_tpu_torch.launcher.launch`` on every node, which
forks one process per GPU there.  Pure command
construction — unit-testable without ssh/mpi installed (the reference tests
them the same way, ``tests/unit/launcher/test_multinode_runner.py``)."""

import os
import shlex
import sys
from abc import ABC, abstractmethod
from typing import Dict, List

class MultiNodeRunner(ABC):
    def __init__(self, args, resources):
        self.args = args
        self.resources = resources
        self.user_script = args.user_script
        self.user_args = list(args.user_args)

    @abstractmethod
    def get_cmd(self, environment: Dict[str, str], resources) -> List[str]:
        ...

    @property
    def name(self) -> str:
        return type(self).__name__.replace("Runner", "").lower()

    def backend_exists(self) -> bool:
        import shutil
        return shutil.which(self._probe_binary) is not None

    def _launch_tail(self, resources) -> List[str]:
        from deepspeed_tpu_torch.launcher import runner as runner_mod  # circular at module load
        world_info = runner_mod.encode_world_info(resources)
        master = self.args.master_addr or next(iter(resources))
        # node rank is resolved on each node (scheduler env / hostname
        # position in world_info — launch.resolve_node_rank), so the tail is
        # identical on every host and needs no per-transport substitution
        tail = [sys.executable, "-u", "-m", "deepspeed_tpu_torch.launcher.launch",
                f"--world_info={world_info}",
                f"--master_addr={master}",
                f"--master_port={self.args.master_port}"]
        if self.args.num_procs > 0:
            tail.append(f"--num_procs={self.args.num_procs}")
        tail.append(self.user_script)
        tail.extend(self.user_args)
        return tail


class PDSHRunner(MultiNodeRunner):
    """pdsh fan-out (reference ``multinode_runner.py:51``)."""

    _probe_binary = "pdsh"

    def get_cmd(self, environment, resources):
        env_exports = [f"export {k}={shlex.quote(v)};" for k, v in
                       sorted(environment.items())]
        hosts = ",".join(resources.keys())
        tail = self._launch_tail(resources)
        remote_cmd = " ".join(env_exports + ["cd", shlex.quote(os.getcwd()), ";"]
                              + [shlex.quote(t) for t in tail])
        extra = shlex.split(self.args.launcher_args) if self.args.launcher_args else []
        return ["pdsh", "-S", "-f", "1024", "-w", hosts] + extra + [remote_cmd]


class OpenMPIRunner(MultiNodeRunner):
    """mpirun fan-out, one rank per host (reference ``multinode_runner.py:107``)."""

    _probe_binary = "mpirun"

    def get_cmd(self, environment, resources):
        total = len(resources)
        hosts = ",".join(f"{h}:1" for h in resources)
        cmd = ["mpirun", "-n", str(total), "--host", hosts,
               "--mca", "btl", "^openib", "--mca", "btl_tcp_if_include", "eth0"]
        for k, v in sorted(environment.items()):
            cmd += ["-x", f"{k}={v}"]
        extra = shlex.split(self.args.launcher_args) if self.args.launcher_args else []
        tail = self._launch_tail(resources)
        # under mpi the launcher reads OMPI_COMM_WORLD_RANK for node_rank
        return cmd + extra + tail


class MPICHRunner(MultiNodeRunner):
    """mpiexec (MPICH) fan-out (reference ``multinode_runner.py:160``)."""

    _probe_binary = "mpiexec"

    def get_cmd(self, environment, resources):
        total = len(resources)
        hosts = ",".join(resources.keys())
        cmd = ["mpiexec", "-n", str(total), "-hosts", hosts]
        for k, v in sorted(environment.items()):
            cmd += ["-genv", k, v]
        extra = shlex.split(self.args.launcher_args) if self.args.launcher_args else []
        tail = self._launch_tail(resources)
        return cmd + extra + tail


class SlurmRunner(MultiNodeRunner):
    """srun fan-out (reference ``multinode_runner.py:208``)."""

    _probe_binary = "srun"

    def get_cmd(self, environment, resources):
        total = len(resources)
        cmd = ["srun", "-n", str(total), "--nodes", str(len(resources)),
               "--ntasks-per-node", "1"]
        if environment:
            cmd += ["--export",
                    "ALL," + ",".join(f"{k}={v}" for k, v in sorted(environment.items()))]
        extra = shlex.split(self.args.launcher_args) if self.args.launcher_args else []
        tail = self._launch_tail(resources)
        # under slurm the launcher reads SLURM_NODEID for node_rank
        return cmd + extra + tail
