"""The stem's mocked build (``tests/test_torch_stem_mock.py`` says what
the mock holds): the bf16 backward kernels at the ragged shape (3 x 3
tiles an image) against their plain versions. The slowest case on the
mock's CPU threads, so it runs in a file of its own. Without g++ it
skips.
"""

import pytest

from tests.stem_mock_common import (  # noqa: F401 (lib is a fixture)
    cases,
    check_backward,
    lib,
)


@pytest.mark.parametrize("shape,dtype", cases("shape1-dtype1"))
def test_mocked_backward_kernels_match_plain_versions(lib, dtype, shape):
    """:func:`tests.stem_mock_common.check_backward`."""
    check_backward(lib, dtype, shape)
