"""``ssh`` / ``elastic`` — the reference's ``bin/`` utility belt
(counterpart of ``deepspeed_tpu/cli_utils.py``), run as ``python -m
deepspeed_tpu_torch.cli_utils ssh|elastic ...``.

Reference: ``bin/ds_ssh`` (run a command on every hostfile host) and
``bin/ds_elastic`` (query the elastic batch/GPU solver for a config).
``ssh`` shells out to plain ``ssh`` with a thread per host; ``elastic``
prints the solver's results from ``deepspeed_tpu_torch.elasticity``.
"""

import argparse
import json
import os
import shlex
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor


def _host_key_checking_mode(insecure_flag: bool) -> str:
    """``accept-new`` trusts a host's key on first contact but still rejects
    a CHANGED key (the MITM case the old blanket ``no`` waved through).
    The blanket-disable escape hatch stays for ephemeral pools whose hosts
    are re-imaged (and re-keyed) constantly: ``--insecure-host-keys`` or
    ``DST_SSH_INSECURE_HOST_KEYS=1``."""
    if insecure_flag or os.environ.get("DST_SSH_INSECURE_HOST_KEYS", "") in (
            "1", "true", "yes"):
        return "no"
    return "accept-new"


def dst_ssh_main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="dst-torch-ssh", description="run a command on every hostfile host")
    parser.add_argument("-f", "--hostfile", default="/job/hostfile")
    parser.add_argument("--insecure-host-keys", action="store_true",
                        help="disable host-key verification entirely "
                             "(StrictHostKeyChecking=no); default is "
                             "accept-new. Also via DST_SSH_INSECURE_HOST_KEYS=1")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="command to run on each host")
    args = parser.parse_args(argv)
    if not args.command:
        parser.error("no command given")
    from deepspeed_tpu_torch.launcher.runner import fetch_hostfile
    resources = fetch_hostfile(args.hostfile)
    if not resources:
        print(f"no hosts in {args.hostfile}", file=sys.stderr)
        return 1
    cmd = shlex.join(args.command)   # preserve arg quoting remotely
    hkc = _host_key_checking_mode(args.insecure_host_keys)

    def run(host):
        p = subprocess.run(
            ["ssh", "-o", f"StrictHostKeyChecking={hkc}", host, cmd],
            capture_output=True, text=True)
        return host, p.returncode, p.stdout, p.stderr

    rc = 0
    with ThreadPoolExecutor(max_workers=min(32, len(resources))) as pool:
        for host, code, out, err in pool.map(run, resources):
            for line in out.splitlines():
                print(f"{host}: {line}")
            for line in err.splitlines():
                print(f"{host}: {line}", file=sys.stderr)
            rc = rc or code
    return rc


def dst_elastic_main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="dst-torch-elastic", description="query the elastic batch solver")
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("-w", "--world-size", type=int, default=0)
    args = parser.parse_args(argv)
    with open(args.config) as f:
        ds_config = json.load(f)
    from deepspeed_tpu_torch.elasticity import compute_elastic_config
    from deepspeed_tpu_torch.version import __version__
    print("Elasticity config:")
    print(json.dumps(ds_config.get("elasticity", {}), indent=4,
                     sort_keys=True))
    if args.world_size > 0:
        batch, gpus, micro = compute_elastic_config(
            ds_config, target_deepspeed_version=__version__,
            world_size=args.world_size, return_microbatch=True)
        print(f"final_batch_size .... {batch}")
        print(f"valid_gpus .......... {gpus}")
        print(f"micro_batch_size .... {micro}")
    else:
        batch, gpus = compute_elastic_config(
            ds_config, target_deepspeed_version=__version__)
        print(f"final_batch_size .... {batch}")
        print(f"valid_gpus .......... {gpus}")
    return 0


def main(argv=None) -> int:
    """``python -m deepspeed_tpu_torch.cli_utils ssh|elastic ARGS``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    tools = {"ssh": dst_ssh_main, "elastic": dst_elastic_main}
    if not argv or argv[0] not in tools:
        print(f"usage: python -m deepspeed_tpu_torch.cli_utils {{{'|'.join(tools)}}} ...",
              file=sys.stderr)
        return 2
    return tools[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
