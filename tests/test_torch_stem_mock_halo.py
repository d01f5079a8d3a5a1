"""The stem's mocked build (``tests/test_torch_stem_mock.py`` says what
the mock holds): the four kernels on a block of rows with its halo (the
spatial layout) against the whole image. A file of its own: with the
other mocked files it takes minutes on the mock's CPU threads. Without
g++ it skips.
"""

import pytest
import torch

from podtpu_torch.ops.kernels import stem_kernel as sk
from tests.stem_mock_common import (  # noqa: F401 (lib is a fixture)
    _bwd,
    _emit,
    _operands,
    _rel,
    _stats,
    lib,
)


def _blocks(x, n, zero_halo=False):
    """The n row blocks of NHWC x, each with one row of its neighbours
    above and below (zeros at the image's edge, or everywhere with
    ``zero_halo``): the kernels' ``halo`` input."""
    xp = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 1, 1)).to(x.dtype)
    k = x.shape[1] // n
    out = []
    for i in range(n):
        blk = xp[:, i * k:(i + 1) * k + 2].clone()
        if zero_halo:
            blk[:, 0].zero_()
            blk[:, -1].zero_()
        out.append(blk.contiguous())
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mocked_kernels_with_a_halo_match_the_whole_image(lib, dtype):
    """Two row blocks of a (2, 32, 40) image (ragged column tiles), each
    with its halo: the four kernels on each block against their plain
    twins on it (as the forward and backward tests hold them), the pooled
    blocks bit for bit the whole image's pooled rows, and the blocks'
    sums and dW, added, the whole image's (1e-5 of the max in float32,
    1e-3 in bf16). A halo of zeros in place of the neighbour's rows
    changes the pooled rows at the block edge."""
    x, wt, g, vecs, s_r, u_r = _operands((2, 32, 40), dtype)
    blocks = _blocks(x, 2)
    gs = g.chunk(2, dim=1)
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    stats = [_stats(lib, b, wt, halo=1) for b in blocks]
    pooled = [_emit(lib, b, wt, *vecs[:2], halo=1) for b in blocks]
    sums = [_bwd(lib, "bwd_sums", b, wt, vecs, gi.contiguous(), 64, halo=1)
            for b, gi in zip(blocks, gs)]
    dws = [_bwd(lib, "bwd_dw", b, wt, vecs, gi.contiguous(), 864, halo=1)
           for b, gi in zip(blocks, gs)]
    for b, gi, s, u, d in zip(blocks, gs, stats, sums, dws):
        gi = gi.contiguous()
        assert _rel(s, sk.stem_stats_reference(b, wt, halo=True)) <= tol
        assert _rel(u.view(2, 32), sk.stem_bwd_sums_reference(
            b, wt, *vecs[:4], gi, halo=True)) <= 2e-3
        assert _rel(d.view(3, 3, 3, 32), sk.stem_bwd_dw_reference(
            b, wt, *vecs, gi, halo=True)) <= 2e-3
    whole = _emit(lib, x, wt, *vecs[:2])
    assert torch.equal(torch.cat(pooled, dim=1), whole)
    assert _rel(stats[0] + stats[1], _stats(lib, x, wt)) <= tol
    assert _rel((sums[0] + sums[1]).view(2, 32), u_r) <= 2e-3
    assert _rel(dws[0] + dws[1], _bwd(lib, "bwd_dw", x, wt, vecs, g, 864)
                ) <= tol * 10
    zeroed = [_emit(lib, b, wt, *vecs[:2], halo=1)
              for b in _blocks(x, 2, zero_halo=True)]
    assert not torch.equal(torch.cat(zeroed, dim=1), whole)
