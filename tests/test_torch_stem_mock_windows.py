"""The stem's mocked build (``tests/test_torch_stem_mock.py`` says what
the mock holds), bf16: the forward kernels give the same bits twice, and
the forward and the backward agree on every pool window at each shape.
A file of their own: with the other mocked files they take minutes on
the mock's CPU threads. Without g++ they skip.
"""

import pytest
import torch

from tests.stem_mock_common import (  # noqa: F401 (lib is a fixture)
    SHAPES,
    _bwd,
    _emit,
    _operands,
    _stats,
    lib,
)


def test_mocked_forward_kernels_give_the_same_bits_twice(lib):
    """No atomics and fixed orders in stats; emit stores each element once."""
    x, wt, _, vecs, _, _ = _operands((3, 40, 70), torch.bfloat16)
    assert torch.equal(_stats(lib, x, wt), _stats(lib, x, wt))
    assert torch.equal(_emit(lib, x, wt, *vecs[:2]),
                       _emit(lib, x, wt, *vecs[:2]))


@pytest.mark.parametrize("shape", SHAPES)
def test_mocked_forward_and_backward_agree_on_every_window(lib, shape):
    """With a cotangent of ones bwd_sums' first row counts the pool windows
    of a channel whose max is positive (small integers, exact in float32).
    They are the windows emit wrote as positive, in all 32 channels: both
    kernels make pre and y by one instruction sequence."""
    x, wt, g, vecs, _, _ = _operands(shape, torch.bfloat16)
    pooled = _emit(lib, x, wt, *vecs[:2])
    positive = _bwd(lib, "bwd_sums", x, wt, vecs, torch.ones_like(g),
                    64).view(2, 32)[0]
    emitted = (pooled > 0).sum(dim=(0, 1, 2)).float()
    assert 0 < float(emitted.min())
    assert float(emitted.max()) < pooled[..., 0].numel()
    assert torch.equal(positive, emitted)
