"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a card they skip. This file imports neither JAX nor
podtpu, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from podtpu_torch.ops.kernels.nms_kernel import (
    greedy_suppress,
    greedy_suppress_reference,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _offset_boxes(rng, b, k):
    """Score-sorted class-offset xyxy boxes (20 classes at podtpu's stride)
    with a valid prefix of random length per image."""
    c = rng.uniform(0, 300, (b, k, 2))
    wh = rng.uniform(5, 120, (b, k, 2))
    cls = rng.integers(0, 20, (b, k, 1)).astype(np.float32)
    xyxy = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    boxes = (xyxy + cls * np.float32(16385.0)).astype(np.float32)
    valid = np.arange(k)[None, :] < rng.integers(0, k + 1, (b, 1))
    return torch.from_numpy(boxes), torch.from_numpy(valid)


@pytest.mark.cuda
@pytest.mark.parametrize("b,k", [(8, 512), (64, 512), (3, 4096), (2, 1)])
def test_suppress_kernel_matches_reference(cuda, b, k):
    boxes, valid = _offset_boxes(np.random.default_rng(k + b), b, k)
    boxes, valid = boxes.to(cuda), valid.to(cuda)
    before = greedy_suppress.launches
    got = greedy_suppress(boxes, valid, 0.45)
    torch.cuda.synchronize()
    assert greedy_suppress.launches == before + 1
    assert torch.equal(got, greedy_suppress_reference(boxes, valid, 0.45))


@pytest.mark.cuda
def test_suppress_kernel_rejects_non_contiguous(cuda):
    boxes = torch.zeros(2, 4, 8, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        greedy_suppress(boxes, torch.ones(2, 8, dtype=torch.bool,
                                          device=cuda), 0.45)
