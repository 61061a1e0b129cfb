"""The kernels' mutation check (``deepspeed_tpu_torch/ops/cuda/
mutation_check.py``) on the CPU: each mutation still names each line it
breaks of its kernel source exactly once (so an edit of a kernel cannot
leave the check mutating nothing) and names an existing test file, and the report reading
sorts the ``cuda`` tests of the decode, flash, cross-entropy, block-sparse
and AdamW test files by dtype.  The check itself runs on the card."""

import pytest

from deepspeed_tpu_torch.ops.cuda import mutation_check as mc


@pytest.mark.parametrize("name", sorted(mc.MUTATIONS))
def test_each_mutation_names_one_line_of_the_kernel(name):
    (source, tests), _, old, new = mc.MUTATIONS[name]
    for line, broken in mc.line_pairs(old, new):
        assert (mc.REPO / source).read_text().count(line) == 1
        assert line != broken
    assert (mc.REPO / tests).is_file()


def test_every_redesigned_kernel_has_two_mutations():
    """Counted by the kernels' test files (AdamW's two mutations are one in
    its kernel and one in the plan its wrapper makes)."""
    by_tests = {}
    for (_, tests), *_ in mc.MUTATIONS.values():
        by_tests[tests] = by_tests.get(tests, 0) + 1
    assert set(by_tests) == {mc.DECODE[1], mc.FLASH[1], mc.WIDE[1], mc.CROSS_ENTROPY[1],
                             mc.SPARSE[1], mc.ADAM[1]}
    assert min(by_tests.values()) >= 2
    sources = {source for (source, _), *_ in mc.MUTATIONS.values()}
    assert {mc.SPARSE[0], mc.ADAM[0], mc.ADAM_PLAN[0]} <= sources
    assert mc.DTYPES == {mc.ADAM[1]: ("float32",)}


def test_mutate_applies_the_change_to_a_copy(tmp_path):
    check_mutation_applies(tmp_path, sorted(mc.MUTATIONS)[0])


@pytest.mark.parametrize("name", sorted(mc.MUTATIONS))
def test_every_mutation_applies_to_a_copy(tmp_path, name):
    check_mutation_applies(tmp_path, name)


def check_mutation_applies(tmp_path, name):
    (source, _), _, old, new = mc.MUTATIONS[name]
    path = tmp_path / source
    path.parent.mkdir(parents=True)
    path.write_text((mc.REPO / source).read_text())
    for line, broken in mc.line_pairs(old, new):
        mc.mutate(tmp_path, source, line, broken)
        text = path.read_text()
        assert line not in text and text.count(broken) == 1
        with pytest.raises(SystemExit):
            mc.mutate(tmp_path, source, line, broken)    # no longer there: refused


@pytest.mark.parametrize("test_id,dtype", [
    ("test_cuda_paged_kernel_matches_plain[mha-decode-dtype0-1e-05]", "float32"),
    ("test_cuda_paged_kernel_matches_plain[mha-decode-dtype1-0.02]", "bfloat16"),
    ("test_cuda_decode_kernel_bf16_peaked[decode]", "bfloat16"),
    ("test_cuda_paged_and_contiguous_kernels_agree_bitwise", "float32"),
    ("test_cuda_prefill_rows_do_not_depend_on_chunking", "float32"),
    ("test_cuda_kernels_match_plain[e1024-vocab-tail-bfloat16]", "bfloat16"),
    ("test_cuda_kernels_match_plain[e1024-vocab-tail-float32]", "float32"),
    ("test_cuda_forward_bf16_peaked[causal]", "bfloat16"),
    ("test_cuda_saved_lse_gives_the_plain_forwards_gradients[alibi-float32]", "float32"),
    ("test_cuda_kernels_match_plain[fixed-causal-s4096-split-bfloat16]", "bfloat16"),
    ("test_cuda_dkv_is_deterministic_across_calls[float32]", "float32"),
    ("test_cuda_flat_gradient_views_match_plain_bitwise[0.01]", "float32"),
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
