"""The stem's mocked build (``tests/test_torch_stem_mock.py`` says what
the mock holds): the bf16 forward kernels at the ragged and the
448-px-wide shapes, and the bf16 backward kernels at the 448-px-wide one,
against their plain versions. They take minutes on the mock's CPU
threads, so they run in a file of their own. Without g++ they skip.
"""

import pytest

from tests.stem_mock_common import (  # noqa: F401 (lib is a fixture)
    cases,
    check_backward,
    check_forward,
    lib,
)


@pytest.mark.parametrize("shape,dtype",
                         cases("shape1-dtype1", "shape2-dtype1"))
def test_mocked_forward_kernels_match_plain_versions(lib, dtype, shape):
    """:func:`tests.stem_mock_common.check_forward`."""
    check_forward(lib, dtype, shape)


@pytest.mark.parametrize("shape,dtype", cases("shape2-dtype1"))
def test_mocked_backward_kernels_match_plain_versions(lib, dtype, shape):
    """:func:`tests.stem_mock_common.check_backward`."""
    check_backward(lib, dtype, shape)
