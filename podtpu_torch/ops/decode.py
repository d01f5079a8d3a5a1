"""Vectorized YOLO grid decoding (``podtpu/ops/decode.py``).

Anchor heads are NHWC ([B, H, W, A*(5+C)]); the flattened candidate order
is [H, W, A], as in ``podtpu``. Outputs are [B, N, 6] rows of
``[cx, cy, w, h, conf, class_idx]`` in input-pixel scale, single-label
class via argmax; every argmax keeps the first of equal maxima, as
``jnp.argmax`` does.
"""

from __future__ import annotations

import torch

from podtpu_torch.ops.boxes import WH_CLAMP


def _grid_xy(layer_h: int, layer_w: int, device=None) -> torch.Tensor:
    """[H, W, 2] float32 grid of (x, y) cell indices."""
    ys, xs = torch.meshgrid(
        torch.arange(layer_h, dtype=torch.float32, device=device),
        torch.arange(layer_w, dtype=torch.float32, device=device),
        indexing="ij")
    return torch.stack([xs, ys], dim=-1)


def decode_anchor_head(pred: torch.Tensor, num_classes: int,
                       anchors_grid: torch.Tensor,
                       input_size: int) -> torch.Tensor:
    """Decode one anchor-grid head (one YOLOv3 scale).

    Args:
      pred: [B, H, W, A*(5+C)] raw head output (NHWC).
      num_classes: C.
      anchors_grid: [A, 2] float32 anchors in grid units of this layer, on
        ``pred``'s device.
      input_size: model input resolution (pixels).

    Returns [B, H*W*A, 6] rows ``[cx, cy, w, h, conf, cls]``.
    """
    b, layer_h, layer_w, _ = pred.shape
    num_anchors = anchors_grid.shape[0]
    pred = pred.float().reshape(b, layer_h, layer_w, num_anchors,
                                5 + num_classes)
    stride_w = input_size / layer_w
    stride_h = input_size / layer_h

    grid = _grid_xy(layer_h, layer_w, device=pred.device)[:, :, None, :]
    pxy = torch.sigmoid(pred[..., 0:2]) + grid
    pwh = torch.exp(pred[..., 2:4].clamp(-WH_CLAMP, WH_CLAMP)) * anchors_grid
    # scale by the float32 strides, x and y apart (no host tensor per call)
    pbox = torch.stack([pxy[..., 0] * stride_w, pxy[..., 1] * stride_h,
                        pwh[..., 0] * stride_w, pwh[..., 1] * stride_h],
                       dim=-1)
    pconf = torch.sigmoid(pred[..., 4:5])
    # argmax(sigmoid(x)) == argmax(x); torch.argmax takes the first max
    pcls = torch.argmax(pred[..., 5:], dim=-1, keepdim=True).float()
    out = torch.cat([pbox, pconf, pcls], dim=-1)
    return out.reshape(b, layer_h * layer_w * num_anchors, 6)


def layer_anchors(anchors, preds_hw, input_size: int,
                  device=None) -> list[torch.Tensor]:
    """Global pixel anchors -> per-layer [3, 2] anchors in grid units.

    Divides in float32, as ``podtpu`` does; one host->device copy, so
    callers build these once and reuse them.
    """
    anchors = torch.as_tensor(anchors, dtype=torch.float32)
    out = []
    for idx, (layer_h, layer_w) in enumerate(preds_hw):
        stride = torch.tensor([input_size / layer_w, input_size / layer_h],
                              dtype=torch.float32)
        out.append((anchors[3 * idx:3 * idx + 3] / stride).to(device))
    return out


def decode_yolov3(preds, num_classes: int, anchors, input_size: int,
                  anchors_grid: list[torch.Tensor] | None = None):
    """YOLOv3: decode [p3, p4, p5]; global ``anchors`` are in input pixels,
    split 3 per layer and rescaled to each layer's grid units.
    ``anchors_grid`` (from :func:`layer_anchors`) skips that rescale."""
    if anchors_grid is None:
        anchors_grid = layer_anchors(
            anchors, [p.shape[1:3] for p in preds], input_size,
            device=preds[0].device)
    outs = [decode_anchor_head(pred, num_classes, a, input_size)
            for pred, a in zip(preds, anchors_grid)]
    return torch.cat(outs, dim=1)


def decode_yolov2(pred: torch.Tensor, num_classes: int,
                  anchors_grid: torch.Tensor, input_size: int) -> torch.Tensor:
    """YOLOv2: the single 13x13 head; ``anchors_grid`` [A, 2] float32 are
    the config's ``scaled_anchors`` (already grid units) on ``pred``'s
    device."""
    return decode_anchor_head(pred, num_classes, anchors_grid, input_size)


def decode_yolov1(pred: torch.Tensor, num_classes: int, num_boxes: int,
                  input_size: int, grid_size: int = 7) -> torch.Tensor:
    """YOLOv1: the [B, S*S*(5*NB+C)] fully-connected head -> [B, S*S, 6].

    Per cell, the box of the best sigmoided confidence (the first on a tie:
    at random weights saturated sigmoids tie); w/h are normalized to the
    whole image. The class is the argmax of the sigmoided class scores, as
    ``podtpu`` takes it (equal logits may round to one sigmoid)."""
    s = grid_size
    b = pred.shape[0]
    p = torch.sigmoid(pred.float().reshape(b, s, s, num_boxes * 5
                                           + num_classes))
    stride = input_size / s

    boxes = p[..., num_classes:].reshape(b, s, s, num_boxes, 5)  # conf, xywh
    best = torch.argmax(boxes[..., 0], dim=-1, keepdim=True)    # [B, S, S, 1]
    pick = torch.gather(boxes, 3, best[..., None].expand(-1, -1, -1, 1, 5))
    pconf, pbox = pick[..., 0, 0:1], pick[..., 0, 1:5]

    grid = _grid_xy(s, s, device=pred.device)
    pxy = (pbox[..., 0:2] + grid) * stride
    pwh = pbox[..., 2:4] * float(s) * stride
    pcls = torch.argmax(p[..., :num_classes], dim=-1, keepdim=True).float()
    out = torch.cat([pxy, pwh, pconf, pcls], dim=-1)
    return out.reshape(b, s * s, 6)
