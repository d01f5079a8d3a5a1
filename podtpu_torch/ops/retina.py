"""RetinaNet anchors, target assignment, loss and decode
(``podtpu/ops/retina.py``).

Fixed-shape and batched: assignment is one [B, A, T] IoU tensor per batch
(A = 49,104 anchors at 512 px, T = max_annots), each ANCHOR taking its best
GT (IoU >= 0.5 positive, < 0.4 negative, in between ignored), with no
Python loop over the images and no host synchronisation.

Anchor layout per level: 3 octave scales (2^0, 2^(1/3), 2^(2/3)) x 3 aspect
ratios (0.5, 1, 2), base size 4x the stride, h-major over the cells, then
octave-major, ratio-minor within a cell. Box regression uses the standard
(dx, dy, dw, dh) parameterisation relative to the anchor.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist

from podtpu_torch.losses.focal import focal_loss
from podtpu_torch.ops.boxes import WH_CLAMP
from podtpu_torch.parallel.mesh import data_parallel, world

OCTAVES = (0.0, 1.0 / 3.0, 2.0 / 3.0)
RATIOS = (0.5, 1.0, 2.0)
POS_IOU = 0.5
NEG_IOU = 0.4
STRIDES = (8, 16, 32, 64, 128)


def level_anchors(stride: int, h: int, w: int) -> torch.Tensor:
    """[H*W*9, 4] cxcywh anchors for one pyramid level (input-pixel
    scale), float32 on the CPU."""
    base = 4.0 * stride
    shapes = []
    for octave in OCTAVES:
        size = base * (2.0 ** octave)
        for ratio in RATIOS:
            shapes.append((size * math.sqrt(1.0 / ratio),
                           size * math.sqrt(ratio)))
    shapes = torch.tensor(shapes, dtype=torch.float32)  # [9, 2]
    ys, xs = torch.meshgrid(
        (torch.arange(h, dtype=torch.float32) + 0.5) * stride,
        (torch.arange(w, dtype=torch.float32) + 0.5) * stride,
        indexing="ij")
    centers = torch.stack([xs, ys], dim=-1).reshape(-1, 1, 2)  # [HW, 1, 2]
    anchors = torch.cat([centers.expand(h * w, 9, 2),
                         shapes[None].expand(h * w, 9, 2)], dim=-1)
    return anchors.reshape(-1, 4)


def all_anchors(input_size: int, strides: Sequence[int] = STRIDES
                ) -> torch.Tensor:
    """[A_total, 4] anchors across the pyramid, float32 on the CPU.

    Level sizes use CEILING division: each stride-2 conv of the backbone
    and of P6/P7 computes ``ceil(h/2)`` (k3 s2 pad1), and iterated ceil
    halving equals ``ceil(input/stride)`` (at 64 px P7 is 1x1, not 0x0)."""
    parts = []
    for s in strides:
        hw = -(-input_size // s)
        parts.append(level_anchors(s, hw, hw))
    return torch.cat(parts, dim=0)


_ANCHORS: dict = {}  # (device, input size, strides) -> all_anchors there


def anchors_on(device: torch.device, input_size: int,
               strides: Sequence[int] = STRIDES) -> torch.Tensor:
    """:func:`all_anchors` on ``device``, made once per (device, input size,
    strides) and shared by the loss and the decoder. A trace
    (``torch.export``) neither reads nor fills the cache, so no traced
    tensor outlives it."""
    key = (torch.device(device), int(input_size), tuple(strides))
    if torch.compiler.is_compiling():
        return all_anchors(input_size, strides).to(key[0])
    if key not in _ANCHORS:
        _ANCHORS[key] = all_anchors(input_size, strides).to(key[0])
    return _ANCHORS[key]


def _iou_cxcywh(anchors: torch.Tensor, gts: torch.Tensor) -> torch.Tensor:
    """[A, 4] x [B, T, 4] center-format -> [B, A, T] IoU."""
    ax1 = (anchors[:, 0] - anchors[:, 2] / 2)[:, None]
    ay1 = (anchors[:, 1] - anchors[:, 3] / 2)[:, None]
    ax2 = (anchors[:, 0] + anchors[:, 2] / 2)[:, None]
    ay2 = (anchors[:, 1] + anchors[:, 3] / 2)[:, None]
    bx1 = (gts[..., 0] - gts[..., 2] / 2)[:, None, :]
    by1 = (gts[..., 1] - gts[..., 3] / 2)[:, None, :]
    bx2 = (gts[..., 0] + gts[..., 2] / 2)[:, None, :]
    by2 = (gts[..., 1] + gts[..., 3] / 2)[:, None, :]
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp_min(0.0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp_min(0.0)
    inter = iw * ih
    union = ((ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1)
             - inter + 1e-6)
    return inter / union


@torch.no_grad()
def assign_targets(anchors: torch.Tensor, target: torch.Tensor,
                   num_classes: int, input_size: int):
    """Anchor assignment for a batch.

    Args:
      anchors: [A, 4] cxcywh pixels.
      target: [B, T, 5] normalized padded annotations (padding rows -1).

    Returns (cls_t [B, A, C], box_t [B, A, 4] deltas, pos [B, A], valid
    [B, A]), float32: pos = the anchor has a GT; valid = it counts in the
    class loss (positives and confident negatives; the 0.4-0.5 band is
    ignored). An anchor's best GT is the first of the largest IoU, as
    ``jnp.argmax`` takes it.
    """
    target = target.float()
    gt_valid = target.sum(dim=-1) > 0  # [B, T]
    boxes = target[..., :4] * input_size  # cxcywh pixels
    cls = target[..., 4].long().clamp(0, num_classes - 1)  # [B, T]

    iou = _iou_cxcywh(anchors, boxes)  # [B, A, T]
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)
    best_gt = iou.argmax(dim=2)  # [B, A]
    best_iou = torch.gather(iou, 2, best_gt[..., None])[..., 0]

    pos = best_iou >= POS_IOU
    valid = pos | (best_iou < NEG_IOU)

    gt_box = torch.gather(boxes, 1, best_gt[..., None].expand(-1, -1, 4))
    gt_cls = torch.gather(cls, 1, best_gt)  # [B, A]

    eps = 1e-6
    awh = anchors[:, 2:4] + eps
    dxy = (gt_box[..., 0:2] - anchors[:, 0:2]) / awh
    # wh clipped to 1: an empty image's "best GT" is a padding row, and its
    # deltas must stay finite so that 0 * box_t is 0
    dwh = torch.log(gt_box[..., 2:4].clamp_min(1.0) / awh)
    box_t = torch.cat([dxy, dwh], dim=-1)

    classes = torch.arange(num_classes, device=target.device)
    cls_t = ((gt_cls[..., None] == classes) & pos[..., None]).float()
    return cls_t, box_t, pos.float(), valid.float()


def _flatten_heads(outputs, num_classes: int):
    """List of (cls [B, 9*C, H, W], box [B, 9*4, H, W]) -> ([B, A_tot, C],
    [B, A_tot, 4]) float32. NHWC first: anchor (h*W + w)*9 + a holds class
    c in channel a*C + c."""
    cls_list, box_list = [], []
    for cls, box in outputs:
        b, _, h, w = cls.shape
        cls_list.append(cls.permute(0, 2, 3, 1).reshape(b, h * w * 9,
                                                        num_classes))
        box_list.append(box.permute(0, 2, 3, 1).reshape(b, h * w * 9, 4))
    return (torch.cat(cls_list, dim=1).float(),
            torch.cat(box_list, dim=1).float())


def retinanet_loss(outputs, target: torch.Tensor, num_classes: int,
                   input_size: int, strides: Sequence[int] = STRIDES,
                   alpha: float = 0.25, gamma: float = 2.0,
                   box_weight: float = 1.0) -> torch.Tensor:
    """Focal class loss + smooth-L1 box loss, normalized by the number of
    positives (under data parallelism, the global batch's)."""
    cls_p, box_p = _flatten_heads(outputs, num_classes)
    anchors = anchors_on(cls_p.device, input_size, strides)
    cls_t, box_t, pos, valid = assign_targets(anchors, target, num_classes,
                                              input_size)

    # focal loss on valid anchors
    focal = focal_loss(cls_p, cls_t, alpha, gamma, reduction="none")
    cls_loss = (focal * valid[..., None]).sum()

    # smooth-L1 on positive anchors
    diff = (box_p - box_t).abs()
    sl1 = torch.where(diff < 1.0 / 9.0, 4.5 * diff ** 2, diff - 1.0 / 18.0)
    box_loss = (sl1 * pos[..., None]).sum() * box_weight

    if not data_parallel():
        num_pos = pos.sum().clamp_min(1.0)
        return (cls_loss + box_loss) / num_pos
    # podtpu divides by the global batch's positives: summed over the ranks
    # (no gradient through it), and the rank's loss scaled by the ranks, so
    # that its mean over them (what the train step's averaged gradients
    # and ``validate`` take) is the global loss
    num_pos = pos.sum().detach().clone()
    dist.all_reduce(num_pos)
    return (cls_loss + box_loss) * float(world()) / num_pos.clamp_min(1.0)


def decode_retinanet(outputs, num_classes: int, input_size: int,
                     strides: Sequence[int] = STRIDES) -> torch.Tensor:
    """Heads -> [B, A_tot, 6] rows [cx, cy, w, h, conf, cls] (pixel
    scale); ``cls`` is the first of the largest class probabilities."""
    cls_p, box_p = _flatten_heads(outputs, num_classes)
    anchors = anchors_on(cls_p.device, input_size, strides)
    probs = torch.sigmoid(cls_p)
    cls = probs.argmax(dim=-1, keepdim=True)
    conf = torch.gather(probs, -1, cls)
    cxy = anchors[None, :, 0:2] + box_p[..., 0:2] * anchors[None, :, 2:4]
    wh = (torch.exp(box_p[..., 2:4].clamp(-WH_CLAMP, WH_CLAMP))
          * anchors[None, :, 2:4])
    return torch.cat([cxy, wh, conf, cls.float()], dim=-1)
