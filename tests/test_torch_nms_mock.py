"""The suppression kernels' CUDA source, compiled by g++ as host C++ against
the mock of the CUDA runtime in ``tools/cuda_mock`` and run on CPU threads,
against the plain PyTorch version.

The mock runs one thread per CUDA thread with real barriers and emulates
the ballot and ``cp.async`` (a copy lands only at the wait that covers its
group), so this holds the IoU bitmask's indexing, the scan's order and its
staging of the next word; it says nothing of what nvcc accepts or how fast
the card runs them (``tests/test_torch_cuda.py`` and ``chip_smoke.py`` do).
Keep masks must equal ``greedy_suppress_reference``'s exactly, and two
planted faults must fail. Without g++ the tests skip.
"""

import numpy as np
import pytest
import torch

from podtpu_torch.ops.boxes import pairwise_iou
from podtpu_torch.ops.kernels import nms_kernel as nk
from tests.nms_mock_common import (  # noqa: F401 (lib is a fixture)
    CASES,
    THR,
    _case,
    _suppress,
    lib,
)


@pytest.mark.parametrize("name", CASES)
def test_mocked_keep_masks_equal_reference(lib, name):
    boxes, valid = _case(name)
    want = nk.greedy_suppress_reference(boxes, valid, THR)
    got = _suppress(lib, boxes, valid)
    assert torch.equal(got, want)
    if name == "no_valid_box":
        assert not got[1].any() and got[0].any()
    if name == "one_image_no_valid":
        assert not got.any()
    if name.startswith("chain"):
        # A removes B, B would have removed C: C is kept
        assert got[0, 0::2].all() and not got[0, 1::2].any()
    if name in ("random_K512", "dense_cluster", "class_offsets_data_stride",
                "one_image_K512", "yolov1_K49", "yolov2_K512_of_845"):
        assert 0 < int(got.sum()) < int(valid.sum())  # something is removed


def test_mocked_iou_exactly_at_threshold_is_kept(lib):
    """A pair whose IoU in float32 is exactly the threshold: not above it,
    so both are kept; one ulp lower a threshold removes the second. The
    IoU is computed as the kernel and pairwise_iou compute it."""
    boxes = torch.tensor([[[0.0, 0.0, 10.0, 10.0], [3.0, 1.0, 13.5, 11.25]]])
    valid = torch.ones((1, 2), dtype=torch.bool)
    iou = pairwise_iou(boxes, boxes)[0, 0, 1]
    thr = float(iou)
    below = float(np.nextafter(np.float32(thr), np.float32(0.0)))
    for t, want in ((thr, [True, True]), (below, [True, False])):
        assert nk.greedy_suppress_reference(boxes, valid, t)[0].tolist() == want
        assert _suppress(lib, boxes, valid, t)[0].tolist() == want


def test_mocked_mask_words_are_the_upper_triangle(lib):
    """The IoU half alone: every word at or above the diagonal holds bit u
    iff j = 64 c + u has j > i, j < K and iou > thr; then the scan half on
    it gives the reference's keep mask."""
    boxes, valid = _case("random_K200")
    b, k = valid.shape
    w = nk.mask_words(k)
    mask = torch.zeros((b, k, w), dtype=torch.int64)
    assert lib.podtpu_nms_iou_mask(boxes.data_ptr(), mask.data_ptr(), b, k,
                                   THR, None) == 0
    sup = (pairwise_iou(boxes, boxes) > THR).numpy()
    sup &= np.triu(np.ones((k, k), bool), 1)
    bits = np.zeros((b, k, w * 64), bool)
    bits[..., :k] = sup
    want = np.packbits(bits.reshape(b, k, w, 64)[..., ::-1], axis=-1)
    want = want.view(">u8")[..., 0].astype(np.uint64)
    got = mask.numpy().view(np.uint64)
    for r in range(w):
        rows = slice(64 * r, 64 * (r + 1))
        np.testing.assert_array_equal(got[:, rows, r:], want[:, rows, r:])
    keep = torch.zeros((b, k), dtype=torch.bool)
    assert lib.podtpu_nms_scan(mask.data_ptr(), valid.data_ptr(),
                               keep.data_ptr(), b, k, None) == 0
    assert torch.equal(keep, nk.greedy_suppress_reference(boxes, valid, THR))


def test_mocked_entry_points_reject_bad_arguments(lib):
    boxes = torch.zeros(8 * 4 + 1)[1:]
    assert boxes.data_ptr() % 16
    mask = torch.zeros((1, 8, 1), dtype=torch.int64)
    keep, valid = torch.zeros(8, dtype=torch.bool), torch.ones(8, dtype=torch.bool)
    args = [valid.data_ptr(), mask.data_ptr(), keep.data_ptr()]
    good = torch.zeros((1, 8, 4))
    assert lib.podtpu_nms_suppress(good.data_ptr(), *args, 1, 8, THR, None) == 0
    assert lib.podtpu_nms_suppress(boxes.data_ptr(), *args, 1, 8, THR, None) != 0
    assert lib.podtpu_nms_suppress(good.data_ptr(), *args, 1, nk.MAX_K + 1,
                                   THR, None) != 0
    assert lib.podtpu_nms_suppress(good.data_ptr(), *args, -1, 8, THR,
                                   None) != 0
    # nothing to do is no error
    assert lib.podtpu_nms_suppress(good.data_ptr(), *args, 0, 8, THR, None) == 0
