"""Each kernel's SASS from a source of ``builder.PARTS``, compiled whole and
in its parts, compared kernel by kernel.

    python -m deepspeed_tpu_torch.ops.cuda.sass_parts [SOURCE]

SOURCE is a file name under ``csrc/`` (default: every source of
``builder.PARTS``).  Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit).
The source compiles once without a part's flags (the whole file) and once
per part, all at once, with the build's flags; ``cuobjdump -sass`` of each
object gives each kernel's instructions (addresses and encodings dropped).
One JSON line a source: the kernels of the whole file and of the parts, how
many are identical, and the names of those missing from the parts or
differing (names with the translation unit's anonymous-namespace hash
taken out, which differs between two compilations of one file).
"""

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List

from deepspeed_tpu_torch.ops.cuda import builder

_TU_HASH = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+")
_ADDRESS = re.compile(r"/\*[0-9a-f]{4}\*/")


def kernel_name(mangled: str) -> str:
    """``mangled`` without its translation unit's anonymous-namespace hash."""
    return _TU_HASH.sub("_GLOBAL__N_", mangled)


def parse_sass(text: str) -> Dict[str, List[str]]:
    """``cuobjdump -sass`` output -> {kernel: its instructions}."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
            out[name] = []
        elif name is not None and _ADDRESS.search(line):
            out[name].append(_ADDRESS.sub("", line.split(";")[0]).strip())
    return out


def compare(whole: Dict[str, List[str]], parts: Dict[str, List[str]]) -> dict:
    return {"whole": len(whole), "parts": len(parts),
            "identical": sum(whole[k] == parts.get(k) for k in whole),
            "missing": sorted(set(whole) - set(parts)),
            "differing": sorted(k for k in whole if k in parts and whole[k] != parts[k])}


def check(source: str) -> dict:
    nvcc = builder.find_nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    src = builder.CSRC_DIR / source
    flags = builder.NVCC_FLAGS + builder.SPLIT_FLAGS.get(source, [])
    jobs = [("whole", [])] + [(f"part{i}", f) for i, f in enumerate(builder.PARTS[source])]
    with tempfile.TemporaryDirectory() as tmp:
        procs = [(name, Path(tmp, name + ".o"), subprocess.Popen(
            [nvcc, *flags, *extra, "-c", str(src), "-o", str(Path(tmp, name + ".o"))],
            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)) for name, extra in jobs]
        sass = {}
        for name, obj, proc in procs:
            if proc.wait(timeout=builder.BUILD_TIMEOUT_S) != 0:
                raise builder.KernelBuildError(f"{source} ({name}): nvcc exit {proc.returncode}")
            sass[name] = parse_sass(subprocess.run([cuobjdump, "-sass", str(obj)],
                                                   capture_output=True, text=True,
                                                   check=True).stdout)
    parts = {}
    for name, _ in jobs[1:]:
        parts.update(sass[name])
    return dict(source=source, **compare(sass["whole"], parts))


def main(argv=None) -> int:
    sources = (argv if argv is not None else sys.argv[1:]) or sorted(builder.PARTS)
    ok = True
    for source in sources:
        report = check(source)
        print(json.dumps(report))
        ok &= not report["missing"] and not report["differing"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
