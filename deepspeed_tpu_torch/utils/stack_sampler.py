"""Where a Python program's time goes: its main thread's stack, sampled from
a thread beside it.

    python -m deepspeed_tpu_torch.utils.stack_sampler --out FILE SCRIPT [ARGS ...]
    python -m deepspeed_tpu_torch.utils.stack_sampler --report FILE [--by FUNCTION]

The first form runs SCRIPT in this process (``runpy``, as ``__main__``,
with ARGS as its ``sys.argv[1:]``) while a thread reads the main thread's
frames every ``--interval`` seconds (0.2 by default).  Each sample keeps
the innermost frame and the frames of files under SCRIPT's directory; the
samples go to FILE as JSON lines when the script ends, and the script's
exit code is this one's.  A frame running C code (a CUDA synchronize, a
kernel launch, a child process's wait) holds the sample, so the counts
take the host's view: the seconds each line of Python spent, whatever it
waited for.

The second form prints seconds (samples x interval) by the line of
FUNCTION (``main`` by default) that was running, in line order, then the
lines where the time was spent inside the script's files, with the
innermost frames they spent it in.
"""

import argparse
import collections
import json
import os
import runpy
import sys
import threading
import time


class StackSampler:
    """Samples the calling thread's stack from a daemon thread."""

    def __init__(self, root: str, interval: float = 0.2):
        self.root, self.interval = os.path.abspath(root) + os.sep, interval
        self.samples = []
        self._target = threading.get_ident()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="stack_sampler", daemon=True)

    def _run(self):
        while not self._stop.wait(self.interval):
            frame = sys._current_frames().get(self._target)
            if frame is None:
                continue
            leaf, stack = None, []
            while frame is not None:
                path = frame.f_code.co_filename
                where = f"{frame.f_code.co_name}:{frame.f_lineno}"
                if leaf is None:
                    leaf = f"{os.path.basename(path)}:{where}"
                if path.startswith(self.root):
                    stack.append(f"{path[len(self.root):]}:{where}")
                frame = frame.f_back
            self.samples.append((time.perf_counter(), leaf, stack[::-1]))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            for sample in self.samples:
                f.write(json.dumps(sample) + "\n")


def report(samples, by: str = "main", interval: float = 0.2, top: int = 40) -> str:
    """Seconds by the line of ``by`` that was running, then by the
    innermost line in the script's files (with the innermost frames)."""
    by_line, inner = collections.Counter(), collections.Counter()
    leaves = collections.defaultdict(collections.Counter)
    for _, leaf, stack in samples:
        hit = next((s for s in stack if s.rsplit(":", 2)[1] == by), None)
        if hit is not None:
            by_line[int(hit.rsplit(":", 1)[1])] += 1
        if stack:
            inner[stack[-1]] += 1
            leaves[stack[-1]][leaf.rsplit(":", 1)[0]] += 1
    lines = [f"seconds by the line of {by}():"]
    lines += [f"{n * interval:9.1f}  line {ln}" for ln, n in sorted(by_line.items())]
    lines.append("seconds by the innermost line in the script's files:")
    lines += [f"{n * interval:9.1f}  {where}  {leaves[where].most_common(2)}"
              for where, n in inner.most_common(top)]
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="stack_sampler")
    parser.add_argument("--out", help="where the samples go (JSON lines)")
    parser.add_argument("--report", help="a samples file to report on")
    parser.add_argument("--by", default="main")
    parser.add_argument("--interval", type=float, default=0.2)
    parser.add_argument("script", nargs="?")
    parser.add_argument("args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    if args.report:
        with open(args.report) as f:
            samples = [json.loads(line) for line in f]
        print(report(samples, args.by, args.interval))
        return 0
    if not (args.out and args.script):
        parser.error("--out FILE SCRIPT, or --report FILE")
    script = os.path.abspath(args.script)
    sys.argv = [script] + args.args
    sys.path.insert(0, os.path.dirname(script))
    code = 0
    with StackSampler(os.path.dirname(script), args.interval) as sampler:
        try:
            runpy.run_path(script, run_name="__main__")
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
    sampler.write(args.out)
    return code


if __name__ == "__main__":
    sys.exit(main())
