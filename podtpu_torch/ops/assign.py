"""YOLO target assignment on the device (``podtpu/ops/assign.py``, the dense
backends of ``encode_anchor_targets`` and ``encode_yolov1_targets``).

Ground truth -> grid targets with the reference's write order, and no
sequential loop:

* a later GT falling in the same (cell, anchor) slot overwrites an earlier
  one (the reference loop's last write wins): the slot's owner is the
  highest annotation order among those writing it, a ``scatter_reduce``
  with ``amax``, and its values are a ``gather`` from the owner;
* v3: a GT contributes to a layer only when its globally-best anchor (over
  all 9, matched in input pixels) belongs to that layer's triplet;
* the noobj ignore mask is an OR over annotations, again an ``amax``
  scatter;
* v1: the FIRST GT in a cell wins (the reference's loop skips occupied
  cells), an ``amin`` scatter of the annotation order.

``podtpu`` selects the owner's values and the ignore mask with one-hot
matmuls, which suit the TPU's matrix unit; here gathers and integer
scatters are exact and deterministic, so the targets equal ``podtpu``'s bit
for bit without depending on how float32 matmuls are rounded.

Grid layout is [B, H, W, A]. Annotations are [B, T, 5] rows
``[cx, cy, w, h, cid]`` normalized to [0, 1], padded with -1 rows; a row is
valid iff its sum > 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from podtpu_torch.ops.boxes import wh_iou


class AnchorTargets(NamedTuple):
    """Targets for one anchor-grid layer; all [B, H, W, A] unless noted."""

    mask: torch.Tensor        # 1 where a GT is assigned
    noobj_mask: torch.Tensor  # 1 where the no-object loss applies
    tbox: torch.Tensor        # [B, H, W, A, 4]: (x_off, y_off, w/aw, h/ah)
    tconf: torch.Tensor       # objectness target (== mask)
    tcls: torch.Tensor        # [B, H, W, A, C] one-hot / label-smoothed


def _f32(t, device) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32, device=device)


def encode_anchor_targets(
    target: torch.Tensor,
    num_classes: int,
    scaled_anchors,
    layer_w: int,
    layer_h: int,
    ignore_threshold: float = 0.5,
    match_anchors=None,
    layer_anchor_slice: tuple[int, int] | None = None,
    match_scale: tuple[float, float] | None = None,
    cls_pos: float = 1.0,
    cls_neg: float = 0.0,
    cls_accumulate: bool = False,
) -> AnchorTargets:
    """Encode GT boxes onto one anchor grid.

    Args:
      target: [B, T, 5] padded annotations (normalized cxcywh + cid).
      num_classes: C.
      scaled_anchors: [A, 2] anchors in this layer's grid units (the tbox
        w/h ratios).
      layer_w, layer_h: grid size.
      ignore_threshold: anchors whose wh-IoU with the GT exceeds this get
        noobj_mask = 0 at the GT's cell.
      match_anchors: [M, 2] anchors of the best-anchor argmax; defaults to
        ``scaled_anchors`` (YOLOv2). YOLOv3 passes all 9 in input pixels.
      layer_anchor_slice: (start, end) into ``match_anchors`` owned by this
        layer; a GT whose global argmax falls outside is skipped (YOLOv3
        layer gating). The ignore IoUs are the sliced local triplet.
      match_scale: (sx, sy) multiplying normalized GT w/h for the match IoU;
        defaults to (layer_w, layer_h).
      cls_pos, cls_neg: class target values (label smoothing).
      cls_accumulate: the reference's unsmoothed encoders set only the
        class bit, so two GTs colliding on one slot leave both bits set;
        requires cls_pos=1, cls_neg=0. False is the full-row overwrite.
    """
    if cls_accumulate and not (cls_pos == 1.0 and cls_neg == 0.0):
        raise ValueError("cls_accumulate models the reference's unsmoothed "
                         "bit-set writes; it requires cls_pos=1, cls_neg=0")
    dev = target.device
    target = target.float()
    b, t, _ = target.shape
    scaled_anchors = _f32(scaled_anchors, dev)
    num_anchors = scaled_anchors.shape[0]
    match_anchors = (scaled_anchors if match_anchors is None
                     else _f32(match_anchors, dev))
    if match_scale is None:
        match_scale = (float(layer_w), float(layer_h))

    valid = target.sum(dim=-1) > 0.0  # [B, T]
    gx = target[..., 0] * layer_w
    gy = target[..., 1] * layer_h
    gw = target[..., 2] * layer_w
    gh = target[..., 3] * layer_h
    gi = gx.to(torch.int64).clamp(0, layer_w - 1)  # truncates toward 0
    gj = gy.to(torch.int64).clamp(0, layer_h - 1)
    cid = target[..., 4].to(torch.int64).clamp(0, num_classes - 1)

    match_wh = torch.stack([target[..., 2] * match_scale[0],
                            target[..., 3] * match_scale[1]], dim=-1)
    iou = wh_iou(match_wh.reshape(b * t, 2), match_anchors).reshape(b, t, -1)
    best = iou.argmax(dim=-1)  # the first of equal maxima, as jnp.argmax
    if layer_anchor_slice is not None:
        lo, hi = layer_anchor_slice
        valid = valid & (best >= lo) & (best < hi)
        best = best - lo
        iou = iou[..., lo:hi]
    best = best.clamp(0, num_anchors - 1)

    tbox_gt = torch.stack([gx - gi.float(), gy - gj.float(),
                           gw / scaled_anchors[best, 0],
                           gh / scaled_anchors[best, 1]], dim=-1)
    c_idx = torch.arange(num_classes, device=dev)
    tcls_gt = torch.where(cid[..., None] == c_idx, cls_pos,
                          cls_neg).float()  # [B, T, C]

    hw = layer_h * layer_w
    n_slots = hw * num_anchors
    cell = gj * layer_w + gi
    slot = cell * num_anchors + best                       # [B, T]
    order = torch.arange(1, t + 1, device=dev).expand(b, t) * valid

    # slot owner: the highest annotation order writing it (0 = none)
    winner = torch.zeros((b, n_slots), dtype=torch.int64, device=dev)
    winner.scatter_reduce_(1, slot, order, "amax")
    assigned = winner > 0
    mask = assigned.float()
    idx = (winner - 1).clamp(0, t - 1)
    feats = torch.cat([tbox_gt, tcls_gt], dim=-1)          # [B, T, 4+C]
    vals = torch.gather(feats, 1, idx[..., None].expand(-1, -1, 4 + num_classes))
    vals = vals * mask[..., None]

    # noobj: zero every (cell, anchor) where a valid GT in that cell has
    # wh-IoU > threshold with that anchor
    a_idx = torch.arange(num_anchors, device=dev)
    ignore = (valid[..., None] & (iou > ignore_threshold)).to(torch.int64)
    hit = torch.zeros((b, n_slots), dtype=torch.int64, device=dev)
    hit.scatter_reduce_(1, (cell[..., None] * num_anchors + a_idx).reshape(b, -1),
                        ignore.reshape(b, -1), "amax")
    noobj = (hit == 0).float()

    tcls = vals[..., 4:]
    if cls_accumulate:
        # every valid GT hitting the slot sets its class bit
        bits = torch.zeros((b, n_slots * num_classes), dtype=torch.float32,
                           device=dev)
        bits.scatter_reduce_(
            1, (slot[..., None] * num_classes + c_idx).reshape(b, -1),
            (tcls_gt * valid[..., None]).reshape(b, -1), "amax")
        tcls = bits.reshape(b, n_slots, num_classes)

    grid = (b, layer_h, layer_w, num_anchors)
    return AnchorTargets(
        mask=mask.reshape(grid),
        noobj_mask=noobj.reshape(grid),
        tbox=vals[..., :4].reshape(grid + (4,)),
        tconf=mask.reshape(grid),
        tcls=tcls.reshape(grid + (num_classes,)),
    )


class Yolov1Targets(NamedTuple):
    mask: torch.Tensor  # [B, S, S] 1 where the cell holds a GT
    tbox: torch.Tensor  # [B, S, S, 4]: (x_off, y_off, w_norm, h_norm)
    tcls: torch.Tensor  # [B, S, S, C] one-hot


def encode_yolov1_targets(target: torch.Tensor, num_classes: int,
                          grid_size: int = 7) -> Yolov1Targets:
    """YOLOv1 grid encoding: the first GT of a cell wins; w/h stay
    normalized to the image (the reference stores them raw). Bit-identical
    to ``podtpu``'s ``dense`` and ``scan`` backends."""
    dev = target.device
    target = target.float()
    b, t, _ = target.shape
    s = grid_size
    valid = target.sum(dim=-1) > 0.0  # [B, T]

    gx = target[..., 0] * s
    gy = target[..., 1] * s
    gi = gx.to(torch.int64).clamp(0, s - 1)  # truncates toward 0
    gj = gy.to(torch.int64).clamp(0, s - 1)
    cid = target[..., 4].to(torch.int64).clamp(0, num_classes - 1)
    tbox_gt = torch.stack([gx - gi.float(), gy - gj.float(),
                           target[..., 2], target[..., 3]], dim=-1)
    c_idx = torch.arange(num_classes, device=dev)
    tcls_gt = (cid[..., None] == c_idx).float()             # [B, T, C]

    # cell owner: the lowest annotation order writing it (t + 1 = none)
    cell = gj * s + gi                                      # [B, T]
    order = torch.where(valid, torch.arange(1, t + 1, device=dev), t + 1)
    winner = torch.full((b, s * s), t + 1, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(1, cell, order, "amin")
    mask = (winner <= t).float()
    idx = (winner - 1).clamp(0, t - 1)
    feats = torch.cat([tbox_gt, tcls_gt], dim=-1)          # [B, T, 4+C]
    vals = torch.gather(feats, 1,
                        idx[..., None].expand(-1, -1, 4 + num_classes))
    vals = vals * mask[..., None]
    return Yolov1Targets(
        mask=mask.reshape(b, s, s),
        tbox=vals[..., :4].reshape(b, s, s, 4),
        tcls=vals[..., 4:].reshape(b, s, s, num_classes),
    )
