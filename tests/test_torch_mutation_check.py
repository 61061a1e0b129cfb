"""The decode kernels' mutation check (``deepspeed_tpu_torch/ops/cuda/
mutation_check.py``) on the CPU: each mutation still names a line of
``csrc/decode_attention.cu`` exactly once (so an edit of the kernel cannot
leave the check mutating nothing), and the report reading sorts the
``cuda`` tests of ``tests/test_torch_decode_attention.py`` by dtype.  The
check itself runs on the card."""

import pytest

from deepspeed_tpu_torch.ops.cuda import mutation_check as mc


@pytest.mark.parametrize("name", sorted(mc.MUTATIONS))
def test_each_mutation_names_one_line_of_the_kernel(name):
    _, old, new = mc.MUTATIONS[name]
    source = (mc.REPO / mc.SOURCE).read_text()
    assert source.count(old) == 1
    assert old != new


def test_mutate_applies_the_change_to_a_copy(tmp_path):
    name = sorted(mc.MUTATIONS)[0]
    _, old, new = mc.MUTATIONS[name]
    path = tmp_path / mc.SOURCE
    path.parent.mkdir(parents=True)
    path.write_text((mc.REPO / mc.SOURCE).read_text())
    mc.mutate(tmp_path, old, new)
    text = path.read_text()
    assert old not in text and text.count(new) == 1
    with pytest.raises(SystemExit):
        mc.mutate(tmp_path, old, new)          # no longer there: refused


@pytest.mark.parametrize("test_id,dtype", [
    ("test_cuda_paged_kernel_matches_plain[mha-decode-dtype0-1e-05]", "float32"),
    ("test_cuda_paged_kernel_matches_plain[mha-decode-dtype1-0.02]", "bfloat16"),
    ("test_cuda_decode_kernel_bf16_peaked[decode]", "bfloat16"),
    ("test_cuda_paged_and_contiguous_kernels_agree_bitwise", "float32"),
    ("test_cuda_prefill_rows_do_not_depend_on_chunking", "float32"),
])
def test_dtype_of_test_ids(test_id, dtype):
    assert mc.dtype_of(test_id) == dtype


def test_failed_tests_reads_junit_xml(tmp_path):
    xml = tmp_path / "junit.xml"
    xml.write_text(
        '<testsuites><testsuite name="pytest">'
        '<testcase classname="t" name="a"/>'
        '<testcase classname="t" name="b"><failure message="x"/></testcase>'
        '<testcase classname="t" name="c"><skipped message="no card"/></testcase>'
        '<testcase classname="t" name="d"><error message="y"/></testcase>'
        '</testsuite></testsuites>')
    assert mc.failed_tests(xml) == (["b", "d"], 3)
