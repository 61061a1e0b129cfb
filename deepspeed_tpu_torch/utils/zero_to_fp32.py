#!/usr/bin/env python
"""Offline checkpoint -> fp32 state dict (counterpart of
``deepspeed_tpu/utils/zero_to_fp32.py``, the script the reference copies
into every checkpoint directory).

The port's checkpoints hold the fp32 master parameters by name in one file
per tag (``<tag>/state.pt``, or ``state.npz`` from the ``"local"``
engine), so consolidation is a read.  The engine copies this file into
each save dir; it needs only torch and numpy:

    python zero_to_fp32.py <checkpoint_dir> <output_file> [--tag TAG]

Output: a ``torch.save`` state dict ``{name: fp32 tensor}`` (``.pt``), or
an ``.npz`` of the same arrays when the output name ends in ``.npz``.
"""

import argparse
import os
import re
import sys


def resolve_tag(checkpoint_dir: str, tag=None) -> str:
    """The tag to read: explicit > the 'latest' pointer > the newest tag
    dir by natural sort (global_step10 beats global_step9)."""
    if tag is not None:
        return str(tag)
    latest = os.path.join(checkpoint_dir, "latest")
    if os.path.isfile(latest):
        with open(latest) as f:
            return f.read().strip()
    tags = [d for d in os.listdir(checkpoint_dir)
            if not d.startswith(".") and os.path.isdir(os.path.join(checkpoint_dir, d))]
    if not tags:
        raise FileNotFoundError(f"no checkpoints under {checkpoint_dir}")
    return max(tags, key=lambda s: [int(p) if p.isdigit() else p
                                    for p in re.split(r"(\d+)", s)])


def load_state(checkpoint_dir: str, tag=None) -> dict:
    """The saved state tree of a tag, as CPU tensors."""
    import torch
    tag_dir = os.path.join(checkpoint_dir, resolve_tag(checkpoint_dir, tag))
    pt, npz = os.path.join(tag_dir, "state.pt"), os.path.join(tag_dir, "state.npz")
    if os.path.isfile(pt):
        return torch.load(pt, map_location="cpu", weights_only=True)
    if os.path.isfile(npz):
        import numpy as np
        tree: dict = {}
        with np.load(npz) as data:
            for key in data.files:
                node = tree
                *parents, leaf = key.split("/")
                for p in parents:
                    node = node.setdefault(p, {})
                node[leaf] = torch.from_numpy(data[key])
        return tree
    raise FileNotFoundError(f"no checkpoint state (state.pt or state.npz) in {tag_dir}")


def get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir: str, tag=None) -> dict:
    """``{name: fp32 tensor}`` of the saved master parameters."""
    import torch
    return {name: t.to(torch.float32)
            for name, t in load_state(checkpoint_dir, tag)["params"].items()}


def convert_zero_checkpoint_to_fp32_state_dict(checkpoint_dir: str, output_file: str,
                                               tag=None) -> None:
    sd = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag)
    if output_file.endswith(".npz"):
        import numpy as np
        np.savez(output_file, **{k: v.numpy() for k, v in sd.items()})
    else:
        import torch
        torch.save(sd, output_file)
    print(f"saved {len(sd)} fp32 tensors to {output_file}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("checkpoint_dir")
    parser.add_argument("output_file")
    parser.add_argument("--tag", default=None)
    args = parser.parse_args(argv)
    convert_zero_checkpoint_to_fp32_state_dict(args.checkpoint_dir, args.output_file, args.tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
