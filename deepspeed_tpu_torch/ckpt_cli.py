"""Offline checkpoint tooling for the port's checkpoints (counterpart of
``deepspeed_tpu/ckpt_cli.py``); no engine and no GPU needed::

    python -m deepspeed_tpu_torch.ckpt_cli export  <ckpt_dir> <out.pt|out.npz> [--tag TAG]
    python -m deepspeed_tpu_torch.ckpt_cli inspect <ckpt_dir> [--tag TAG]
    python -m deepspeed_tpu_torch.ckpt_cli verify  <ckpt_dir> [--tag TAG] [--all] [--shallow]

``export`` writes the saved fp32 master parameters as a state dict
(``utils/zero_to_fp32.py``), equal to a live ``engine.get_fp32_params()``.
``inspect`` prints the tags, the training counters and every parameter's
name, shape and dtype, with totals.  ``verify`` is the walk and the exit
codes of the JAX package's ``tools/verify_checkpoint.py`` (0 verified, 1
corrupt, 2 usage) over the port's copy of ``manifest.py``: a save dir's
``latest`` tag by default, one ``--tag``, or ``--all``; ``--shallow``
skips the CRC-32.  (That tool verifies port checkpoints too, but it loads
``deepspeed_tpu``, whose package imports JAX.)
"""

import argparse
import json
import os
import sys

from deepspeed_tpu_torch.runtime.checkpoint_engine.manifest import MANIFEST_FILE, verify_manifest
from deepspeed_tpu_torch.runtime.checkpointing import LATEST_FILE, list_tags
from deepspeed_tpu_torch.utils.zero_to_fp32 import (convert_zero_checkpoint_to_fp32_state_dict,
                                                    load_state, resolve_tag)


def cmd_export(args) -> int:
    convert_zero_checkpoint_to_fp32_state_dict(args.checkpoint_dir, args.output_file, args.tag)
    return 0


def cmd_inspect(args) -> int:
    ckpt_dir = args.checkpoint_dir
    tags = sorted(d for d in os.listdir(ckpt_dir)
                  if not d.startswith(".") and os.path.isdir(os.path.join(ckpt_dir, d)))
    tag = resolve_tag(ckpt_dir, args.tag)
    print(f"checkpoint dir: {ckpt_dir}")
    print(f"tags: {', '.join(tags) or '(none)'}   [inspecting: {tag}]")
    meta_path = os.path.join(ckpt_dir, tag, "client_state.json")
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        for key in ("global_steps", "global_samples", "micro_steps", "zero_stage",
                    "world_size", "mesh_shape"):
            if key in meta:
                print(f"  {key}: {meta[key]}")
    params = load_state(ckpt_dir, tag)["params"]
    total = 0
    for name in sorted(params):
        t = params[name]
        total += t.numel()
        print(f"  {name:60s} {str(tuple(t.shape)):24s} {t.dtype}")
    print(f"  -- {len(params)} tensors, {total:,} parameters ({total * 4 / 2**20:.1f} MiB fp32)")
    return 0


def _verify_targets(path: str, tag, verify_all: bool):
    """(list of (tag, dir) to verify, error or None)."""
    if not os.path.isdir(path):
        return [], f"{path}: not a directory"
    if tag is None and not verify_all and os.path.isfile(os.path.join(path, MANIFEST_FILE)):
        return [(os.path.basename(os.path.normpath(path)), path)], None
    if tag is not None:
        d = os.path.join(path, tag)
        return ([(tag, d)], None) if os.path.isdir(d) else ([], f"tag {tag!r} not found")
    if verify_all:
        tags = list_tags(path)
        return ([(t, os.path.join(path, t)) for t in tags],
                None if tags else f"no checkpoint tags under {path}")
    latest = os.path.join(path, LATEST_FILE)
    if not os.path.isfile(latest):
        return [], f"{path}: neither a tag dir nor a save dir with a '{LATEST_FILE}' file"
    with open(latest) as f:
        t = f.read().strip()
    d = os.path.join(path, t)
    return ([(t, d)], None) if os.path.isdir(d) else ([], f"'latest' names missing tag {t!r}")


def cmd_verify(args) -> int:
    targets, err = _verify_targets(args.checkpoint_dir, args.tag, args.verify_all)
    if err:
        print(json.dumps({"error": err}), file=sys.stderr)
        return 2
    reports = [dict(verify_manifest(d, deep=not args.shallow), tag=t) for t, d in targets]
    corrupt = sum(r["status"] == "corrupt" for r in reports)
    print(json.dumps({"path": args.checkpoint_dir, "deep": not args.shallow,
                      "verified": sum(r["status"] == "verified" for r in reports),
                      "no_manifest": sum(r["status"] == "no_manifest" for r in reports),
                      "corrupt": corrupt, "ok": not corrupt, "reports": reports},
                     indent=2, sort_keys=True))
    return 1 if corrupt else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="ckpt_cli", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_exp = sub.add_parser("export", help="write the fp32 parameters as a .pt or .npz")
    p_exp.add_argument("checkpoint_dir")
    p_exp.add_argument("output_file")
    p_exp.add_argument("--tag", default=None)
    p_exp.set_defaults(fn=cmd_export)
    p_ins = sub.add_parser("inspect", help="print tags, counters and the parameters")
    p_ins.add_argument("checkpoint_dir")
    p_ins.add_argument("--tag", default=None)
    p_ins.set_defaults(fn=cmd_inspect)
    p_ver = sub.add_parser("verify", help="check tags against their MANIFEST.json")
    p_ver.add_argument("checkpoint_dir")
    p_ver.add_argument("--tag", default=None)
    p_ver.add_argument("--all", action="store_true", dest="verify_all")
    p_ver.add_argument("--shallow", action="store_true")
    p_ver.set_defaults(fn=cmd_verify)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
