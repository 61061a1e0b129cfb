"""The build's parts and the tools that measure the card runs, on the CPU:
``builder.PARTS`` splits ``decode_attention.cu`` by dtype with every entry
point in one part; ``ops/cuda/sass_parts.py`` reads ``cuobjdump -sass``
text and names kernels without their translation unit's hash (its
compilation needs the toolkit, on the card's machine); and
``utils/stack_sampler.py`` attributes a script's time to its lines."""

import json
import subprocess
import sys
import textwrap

from deepspeed_tpu_torch.ops.cuda import builder
from deepspeed_tpu_torch.ops.cuda import sass_parts as sp
from deepspeed_tpu_torch.utils import stack_sampler as ss


def test_decode_parts_split_by_dtype_with_the_entry_points_in_one():
    flags = builder.PARTS["decode_attention.cu"]
    assert [f for f in flags] == [["-DDST_DECODE_DTYPE=0"], ["-DDST_DECODE_DTYPE=1"]]
    text = (builder.CSRC_DIR / "decode_attention.cu").read_text()
    for entry in ("int dst_paged_attention(", "int dst_decode_attention(",
                  "const char* dst_error_string("):
        assert text.count(entry) == 1
        # every entry point lies in the block the float32 part compiles
        assert text.index("#ifdef DST_DECODE_ENTRY") < text.index(entry)
    assert set(builder.PARTS) <= {p.name for p in builder.sources()}


def test_sass_is_parsed_and_names_lose_the_unit_hash():
    name = "_ZN52_GLOBAL__N__{}_19_decode_attention_cu_{}19paged_decode_kernelIfLi64ELi1EEEvNS_4ArgsIT_EE"
    text = textwrap.dedent(f"""
        code for sm_90a
            Function : {name.format("8c69f8b1", "e103b3ff")}
        .headerflags    @"EF_CUDA_SM90"
                /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
                /*0010*/                   S2R R0, SR_TID.X ;              /* 0x0000000000007919 */
        """)
    other = text.replace("8c69f8b1", "0badcafe").replace("e103b3ff", "12345678")
    a, b = sp.parse_sass(text), sp.parse_sass(other)
    assert list(a) == list(b) and len(a) == 1
    assert next(iter(a.values())) == ["LDC R1, c[0x0][0x28]", "S2R R0, SR_TID.X"]
    report = sp.compare(a, b)
    assert report == {"whole": 1, "parts": 1, "identical": 1, "missing": [], "differing": []}
    b[next(iter(b))] = ["NOP"]
    assert sp.compare(a, b)["differing"] == list(a)


def test_stack_sampler_finds_the_line_that_takes_the_time(tmp_path):
    script = tmp_path / "slow.py"
    script.write_text(textwrap.dedent("""
        import sys, time

        def main():
            time.sleep(0.05)
            time.sleep(1.0)
            return 3

        if __name__ == "__main__":
            sys.exit(main())
        """))
    out = tmp_path / "samples.jsonl"
    run = subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.utils.stack_sampler",
                          "--out", str(out), "--interval", "0.05", str(script)],
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 3, run.stderr
    samples = [json.loads(line) for line in out.read_text().splitlines()]
    lines = [int(stack[-1].rsplit(":", 1)[1]) for _, _, stack in samples if stack]
    assert lines.count(6) >= 10 and lines.count(6) > 3 * lines.count(5)
    text = ss.report(samples, "main", 0.05)
    assert "line 6" in text and "slow.py:main:6" in text
