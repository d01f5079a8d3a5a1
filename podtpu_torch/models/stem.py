"""The fused Darknet stem (``podtpu/models/stem.py``): stage0's conv + BN +
ReLU and layer1's leading 2x2 pool as one op in train mode.

The op reads its parameters from ``backbone.stage0.conv0`` itself (the
``ConvBnAct`` of the stock path), so the ``state_dict`` keys, the weight
carrier (``export/weights.py``) and eval mode are the same with or without
it. On a CUDA tensor it runs the four kernels of ``csrc/stem_fused.cu``;
on a CPU tensor their plain version (``ops/kernels/stem_kernel.py``): the
device is the switch, where ``podtpu`` reads ``PODTPU_STEM``.
"""

from __future__ import annotations

import torch

from podtpu_torch.models.layers import ConvBnAct
from podtpu_torch.ops.kernels.stem_kernel import stem_fused
from podtpu_torch.parallel.mesh import world


def stem_fusable(x: torch.Tensor, training: bool, out_indices) -> bool:
    """The fused op covers exactly conv3x3(3 -> C) + 2x2/2 pool in train
    mode, with H a multiple of 8 and W even, and no consumer of the
    pre-pool stage0 feature. x is NCHW. (QAT, which has no fused form, is
    excluded by the caller, ``models/darknet.py``, as in ``podtpu``.)"""
    return (
        training
        and 0 not in out_indices
        and x.dim() == 4
        and x.shape[1] == 3
        and x.shape[2] % 8 == 0
        and x.shape[3] % 2 == 0
    )


def fused_stem_pool(block: ConvBnAct, x: torch.Tensor) -> torch.Tensor:
    """``max_pool_2x2(block(x))`` in train mode through the fused op.

    x is NCHW (an NHWC batch permuted, so its memory is NHWC); the result
    is NCHW with channels_last strides. Updates the block's BN running
    statistics as its own train-mode forward would."""
    bn = block.bn
    # NHWC; no copy when x's memory is NHWC, as the model's input is
    xh = x.to(block.dtype).permute(0, 2, 3, 1).contiguous()
    w = block.conv.weight.permute(2, 3, 1, 0)   # OIHW -> HWIO
    pooled, mean, var = stem_fused(xh, w, bn.weight, bn.bias, bn.eps,
                                   block.dtype)
    # the statistics are the global batch's under data parallelism
    bn.update_running_stats(mean, var, xh.numel() // xh.shape[-1] * world())
    # The kernels take the ReLU as a max with 0, which maps a NaN to 0;
    # the plain version and podtpu carry it on. A NaN or inf input makes
    # the batch statistics non-finite, and this add makes the output NaN
    # then too (a rejected step under skip_nonfinite); a finite output is
    # left bit for bit.
    pooled = pooled + (mean.sum() + var.sum()).detach() * 0.0
    return pooled.permute(0, 3, 1, 2)
