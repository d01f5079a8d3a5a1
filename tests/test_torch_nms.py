"""The port's NMS against podtpu's (CPU): the suppression kernel's plain
version against the Pallas kernel (interpreter) and the numpy oracle, and
the whole batched NMS against podtpu's XLA backend. Keep masks, validity
and class ids must be exactly equal; the detections are copies of the same
input rows, so they must be too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from podtpu.ops.nms import batched_class_aware_nms as podtpu_nms
from podtpu.ops.pallas.nms_kernel import pallas_greedy_suppress
from podtpu_torch.ops.kernels.nms_kernel import (
    greedy_suppress,
    greedy_suppress_cuda,
    greedy_suppress_reference,
)
from podtpu_torch.ops.nms import batched_class_aware_nms, nms_padded
from tests.test_nms import greedy_oracle

SPAN = 16385.0  # podtpu's class stride for boxes inside +-8192 px


def offset_boxes(rng, b, k, extent=400.0, classes=20):
    """[b, k, 4] class-offset xyxy boxes as NMS hands them to suppression:
    coordinates up to ~3e5, where float32 keeps ~1/32 px."""
    c = rng.uniform(0, extent, (b, k, 2))
    wh = rng.uniform(5, 120, (b, k, 2))
    cls = rng.integers(0, classes, (b, k, 1))
    xyxy = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    return (xyxy + cls.astype(np.float32) * np.float32(SPAN)).astype(np.float32)


@pytest.mark.parametrize("k", [64, 512])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_matches_pallas_and_oracle(seed, k):
    rng = np.random.default_rng(seed)
    # few classes over a small extent: many overlaps, many suppressions
    boxes = offset_boxes(rng, 3, k, extent=200.0, classes=3)
    n_valid = rng.integers(k // 2, k, 3)
    valid = np.arange(k)[None, :] < n_valid[:, None]  # score-sorted prefix
    valid[1] = False  # an image with no candidate
    got = greedy_suppress_reference(torch.from_numpy(boxes),
                                    torch.from_numpy(valid), 0.45).numpy()
    pallas = np.asarray(pallas_greedy_suppress(
        jnp.asarray(boxes), jnp.asarray(valid.astype(np.float32)), 0.45,
        interpret=True)) > 0.5
    np.testing.assert_array_equal(got, pallas)
    assert not got[1].any()
    assert 0 < got.sum() < valid.sum()  # the case suppresses something
    for i in (0, 2):
        np.testing.assert_array_equal(got[i],
                                      greedy_oracle(boxes[i], valid[i], 0.45))


def _candidates(seed, b=2, n=2000, ties=False, huge=False):
    rng = np.random.default_rng(seed)
    boxes = np.zeros((b, n, 6), np.float32)
    boxes[..., 0:2] = rng.uniform(0, 416, (b, n, 2))
    boxes[..., 2:4] = rng.uniform(8, 160, (b, n, 2))
    if huge:  # untrained exp() boxes: the class span comes from the data
        boxes[:, :50, 2:4] = rng.uniform(2e4, 6e4, (b, 50, 2))
    if ties:  # few distinct scores, as bf16 or untrained heads give
        boxes[..., 4] = rng.choice([0.1, 0.5, 0.5, 0.625, 0.75], (b, n))
    else:
        boxes[..., 4] = rng.uniform(0, 1, (b, n))
    boxes[..., 5] = rng.integers(0, 20, (b, n))
    return boxes


@pytest.mark.parametrize("case", [
    dict(seed=0), dict(seed=1, ties=True), dict(seed=2, ties=True, n=300),
    dict(seed=3, huge=True), dict(seed=4, n=60),
])
def test_batched_nms_matches_podtpu_xla(case):
    boxes = _candidates(**case)
    kw = dict(conf_threshold=0.25, iou_threshold=0.45, top_k=512,
              max_detections=100)
    want_out, want_valid = podtpu_nms(jnp.asarray(boxes), backend="xla", **kw)
    out, valid = batched_class_aware_nms(torch.from_numpy(boxes), **kw)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want_out))
    assert valid.numpy().sum() > 0


def test_nms_padded_pads_past_k():
    boxes = _candidates(5, b=1, n=20)[0]
    out, valid = nms_padded(torch.from_numpy(boxes), max_detections=32)
    assert out.shape == (32, 6) and valid.shape == (32,)
    assert not valid[20:].any() and not out[20:].any()
    want_out, want_valid = podtpu_nms(jnp.asarray(boxes)[None], backend="xla",
                                      max_detections=32)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want_out)[0])


def test_cuda_entry_point_raises_on_cpu_tensor():
    boxes = torch.zeros(1, 8, 4)
    valid = torch.ones(1, 8, dtype=torch.bool)
    before = greedy_suppress.launches
    with pytest.raises(ValueError, match="CUDA"):
        greedy_suppress_cuda(boxes, valid, 0.45)
    assert greedy_suppress.launches == before


@pytest.mark.parametrize("boxes,valid,err", [
    (torch.zeros(1, 8, 4, dtype=torch.float64),
     torch.ones(1, 8, dtype=torch.bool), TypeError),
    (torch.zeros(1, 8, 4), torch.ones(1, 8), TypeError),
    (torch.zeros(1, 8, 5), torch.ones(1, 8, dtype=torch.bool), ValueError),
    (torch.zeros(1, 8, 4), torch.ones(1, 7, dtype=torch.bool), ValueError),
])
def test_suppress_rejects_bad_inputs(boxes, valid, err):
    with pytest.raises(err):
        greedy_suppress(boxes, valid, 0.45)
