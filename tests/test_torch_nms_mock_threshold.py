"""The suppression kernels' mocked build (``tests/test_torch_nms_mock.py``
says what the mock holds): the IoU test exact at the threshold on random
pairs, and the planted faults, which build patched copies of the source.
Without g++ the tests skip.
"""

import numpy as np
import pytest
import torch

from podtpu_torch.ops.boxes import pairwise_iou
from podtpu_torch.ops.kernels import nms_kernel as nk
from tests.nms_mock_common import (  # noqa: F401 (lib is a fixture)
    MUTANTS,
    SOURCE,
    THR,
    _build,
    _case,
    _offset_boxes,
    _suppress,
    lib,
)


@pytest.mark.parametrize("seed", range(4))
def test_mocked_iou_test_is_exact_at_the_threshold(lib, seed):
    """For random overlapping pairs, class offsets up to ~3e5 included, the
    threshold set to the pair's float32 IoU and to the floats either side
    of it: the kernel's IoU and compare must decide as the plain
    version's (kept, removed, kept): one rounding apart flips them."""
    rng = np.random.default_rng(seed)
    valid = torch.ones((1, 2), dtype=torch.bool)
    for _ in range(20):
        a = _offset_boxes(rng, 1, 1, extent=50.0, classes=20)
        b = a.clone()
        b[..., :2] += torch.from_numpy(rng.uniform(-20, 20, (1, 1, 2)).astype(np.float32))
        b[..., 2:] += torch.from_numpy(rng.uniform(-20, 20, (1, 1, 2)).astype(np.float32))
        boxes = torch.cat([a, b], 1)
        iou = np.float32(pairwise_iou(boxes, boxes)[0, 0, 1])
        for t, want in ((iou, True),
                        (np.nextafter(iou, np.float32(-1)), False),
                        (np.nextafter(iou, np.float32(2)), True)):
            got = _suppress(lib, boxes, valid, float(t))
            assert torch.equal(got, nk.greedy_suppress_reference(
                boxes, valid, float(t)))
            assert bool(got[0, 1]) is want


@pytest.mark.parametrize("mutant", sorted(MUTANTS))
def test_planted_faults_fail(tmp_path, mutant):
    """Each planted fault gives another keep mask than the reference on the
    cases above (and the patch still applies to the source)."""
    old, new = MUTANTS[mutant]
    with open(SOURCE) as f:
        text = f.read()
    assert text.count(old) == 1, f"{mutant}: the patched line moved"
    path = tmp_path / f"{mutant}.cu"
    path.write_text(text.replace(old, new))
    bad = _build(str(path), str(tmp_path / f"{mutant}.so"))
    differs = []
    for name in ("random_K512", "chain_within_a_word", "dense_cluster"):
        boxes, valid = _case(name)
        differs.append(not torch.equal(
            _suppress(bad, boxes, valid),
            nk.greedy_suppress_reference(boxes, valid, THR)))
    assert all(differs), differs
