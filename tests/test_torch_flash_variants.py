"""The flash design-variant tool (``deepspeed_tpu_torch/ops/cuda/
flash_variants.py``) on the CPU: each variant still changes lines that its
kernel source holds exactly once, so an edit of the kernels cannot leave a
variant timing the kept design under another name.  The timing itself runs
on the card."""

import pytest

from deepspeed_tpu_torch.ops.cuda import flash_variants as fv


@pytest.mark.parametrize("name", sorted(fv.VARIANTS))
def test_each_variant_applies_to_a_copy(tmp_path, name):
    path = tmp_path / fv.SOURCE
    path.parent.mkdir(parents=True)
    original = (fv.REPO / fv.SOURCE).read_text()
    path.write_text(original)
    fv.apply(tmp_path, fv.VARIANTS[name])
    text = path.read_text()
    assert text != original
    for old, new in fv.VARIANTS[name]:
        assert old not in text and new in text
    with pytest.raises(SystemExit):
        fv.apply(tmp_path, fv.VARIANTS[name])          # no longer there: refused


def test_cases_are_the_training_shapes():
    assert fv.CASES["gpt2-train"] == (8, 512, 12, 12, True)
    assert fv.CASES["gpt2-s4096"] == (2, 4096, 12, 12, True)
