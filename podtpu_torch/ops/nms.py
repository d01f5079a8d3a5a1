"""Fixed-shape class-aware NMS (``podtpu/ops/nms.py``).

The same padded three-stage pipeline as ``podtpu``:

  1. **select**: scores at/below ``conf_threshold`` are masked (set to -1),
     then the best K candidates are kept. A stable descending sort stands in
     for ``jax.lax.top_k`` so that ties keep the lower index first, as there
     (``torch.topk`` promises no order among ties, and ties are common:
     bf16 heads, masked scores, untrained heads all near 0.5);
  2. **suppress**: greedy class-aware suppression through a per-class
     coordinate offset — the CUDA kernel for CUDA tensors, its plain
     version for CPU tensors (``ops/kernels/nms_kernel.py``);
  3. **finalize**: survivors gathered into a fixed [max_det, 6] buffer +
     validity mask, sorted by descending confidence.

``merge``, ``agnostic`` and ``classes`` (and multi-label decoding) are not
ported yet and raise.
"""

from __future__ import annotations

import torch

from podtpu_torch.ops.boxes import cxcywh_to_xyxy
from podtpu_torch.ops.kernels.nms_kernel import greedy_suppress

# Floor for the class-separation stride (see _select_candidates).
_CLASS_OFFSET = 8192.0


def _top(score: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: ties keep the lower index."""
    values, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _select_candidates(boxes: torch.Tensor, conf_threshold: float,
                       top_k: int):
    """[B, N, 6] -> (cand [B, K, 6], cand_valid [B, K], offset_boxes [B, K, 4])."""
    k = min(top_k, boxes.shape[1])
    conf = boxes[..., 4]
    score = torch.where(conf > conf_threshold, conf, -1.0)
    top_scores, top_idx = _top(score, k)
    cand = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 6))
    cand_valid = top_scores > 0.0

    xyxy = cxcywh_to_xyxy(cand[..., 0:4])
    # Shift each class into its own disjoint coordinate region so one IoU
    # matrix implements class-aware suppression. The stride must exceed the
    # image's full coordinate span — untrained heads can emit exp() boxes
    # far larger than the image — so it is derived per image from the data.
    span = xyxy.abs().amax(dim=(1, 2), keepdim=True).clamp_min(
        _CLASS_OFFSET) * 2.0 + 1.0
    offset_boxes = xyxy + cand[..., 5:6] * span
    return cand, cand_valid, offset_boxes


def _finalize(cand: torch.Tensor, keep: torch.Tensor, max_detections: int):
    k = cand.shape[1]
    kept_score = torch.where(keep, cand[..., 4], -1.0)
    out_scores, out_idx = _top(kept_score, min(max_detections, k))
    out = torch.gather(cand, 1, out_idx[..., None].expand(-1, -1, 6))
    valid = out_scores > 0.0
    if max_detections > k:
        pad = max_detections - k
        out = torch.nn.functional.pad(out, (0, 0, 0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    out = torch.where(valid[..., None], out, 0.0)
    return out, valid


def batched_class_aware_nms(
    boxes: torch.Tensor,
    conf_threshold: float = 0.25,
    iou_threshold: float = 0.45,
    top_k: int = 512,
    max_detections: int = 100,
    agnostic: bool = False,
    merge: bool = False,
    classes: tuple[int, ...] | None = None,
):
    """[B, N, 6] float32 candidates -> ([B, max_det, 6], [B, max_det] valid)."""
    if agnostic or merge or classes is not None:
        raise NotImplementedError(
            "nms_options agnostic / merge / classes are not ported yet "
            "(ROADMAP.md queue 1, item 4: the rest of NMS)")
    cand, cand_valid, offset_boxes = _select_candidates(
        boxes, conf_threshold, top_k)
    keep = greedy_suppress(offset_boxes.contiguous(), cand_valid,
                           iou_threshold)
    return _finalize(cand, keep, max_detections)


def nms_padded(boxes: torch.Tensor, conf_threshold: float = 0.25,
               iou_threshold: float = 0.45, top_k: int = 512,
               max_detections: int = 100):
    """Single-image NMS: [N, 6] -> ([max_det, 6], [max_det] valid)."""
    out, valid = batched_class_aware_nms(
        boxes[None], conf_threshold, iou_threshold, top_k, max_detections)
    return out[0], valid[0]
