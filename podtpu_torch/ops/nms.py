"""Fixed-shape class-aware NMS (``podtpu/ops/nms.py``).

The same padded three-stage pipeline as ``podtpu``:

  1. **select**: scores at/below ``conf_threshold`` (and, with ``classes``,
     of any other class) are masked (set to -1), then the best K
     candidates are kept. A stable descending sort stands in for
     ``jax.lax.top_k`` so that ties keep the lower index first, as there
     (``torch.topk`` promises no order among ties, and ties are common:
     bf16 heads, masked scores, untrained heads all near 0.5);
  2. **suppress**: greedy suppression of the score-sorted boxes, class-aware
     through a per-class coordinate offset (``agnostic``: no offset) — the
     CUDA kernel for CUDA tensors, its plain version for CPU tensors
     (``ops/kernels/nms_kernel.py``); with ``merge`` the first
     ``max_detections`` survivors then become the score-weighted mean of
     the candidates overlapping them (:func:`_merge_kept`);
  3. **finalize**: survivors gathered into a fixed [max_det, 6] buffer +
     validity mask, sorted by descending confidence.

``backend`` takes ``podtpu``'s four names and raises on any other; the
device of the boxes picks the suppression all the same.
"""

from __future__ import annotations

import torch

from podtpu_torch.ops.boxes import cxcywh_to_xyxy, pairwise_iou
from podtpu_torch.ops.kernels.nms_kernel import greedy_suppress

# Floor for the class-separation stride (see _select_candidates).
_CLASS_OFFSET = 8192.0

# podtpu's suppression backends; here the boxes' device chooses
BACKENDS = ("xla", "xla_early", "pallas", "pallas_interpret")


def _top(score: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: ties keep the lower index."""
    values, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _select_candidates(boxes: torch.Tensor, conf_threshold: float,
                       top_k: int, agnostic: bool = False,
                       classes: tuple[int, ...] | None = None):
    """[B, N, 6] -> (cand [B, K, 6], cand_valid [B, K], offset_boxes [B, K, 4])."""
    k = min(top_k, boxes.shape[1])
    conf = boxes[..., 4]
    score = torch.where(conf > conf_threshold, conf, -1.0)
    if classes is not None:
        # keep-only class filter on the float class id, as podtpu's isin
        # (compared with each id in turn: no host tensor to copy over)
        allowed = torch.zeros_like(score, dtype=torch.bool)
        for c in classes:
            allowed |= boxes[..., 5] == float(c)
        score = torch.where(allowed, score, -1.0)
    top_scores, top_idx = _top(score, k)
    cand = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 6))
    cand_valid = top_scores > 0.0

    xyxy = cxcywh_to_xyxy(cand[..., 0:4])
    if agnostic:
        return cand, cand_valid, xyxy
    # Shift each class into its own disjoint coordinate region so one IoU
    # matrix implements class-aware suppression. The stride must exceed the
    # image's full coordinate span — untrained heads can emit exp() boxes
    # far larger than the image — so it is derived per image from the data.
    span = xyxy.abs().amax(dim=(1, 2), keepdim=True).clamp_min(
        _CLASS_OFFSET) * 2.0 + 1.0
    offset_boxes = xyxy + cand[..., 5:6] * span
    return cand, cand_valid, offset_boxes


def _merge_kept(cand: torch.Tensor, cand_valid: torch.Tensor,
                offset_boxes: torch.Tensor, keep: torch.Tensor,
                iou_threshold: float):
    """Merge-NMS: each survivor becomes the score-weighted mean (cxcywh,
    linear in xyxy) of every valid candidate overlapping it above the
    threshold (same-class overlap, on the offset boxes), and a survivor
    with no second contributor is dropped; an image with a single valid
    candidate is returned unmerged. The [B, K, K] @ [B, K, 4] product is
    float32 (``torch.bmm``; TF32 is off unless the caller turns it on)."""
    iou = pairwise_iou(offset_boxes, offset_boxes) > iou_threshold
    contrib = iou & cand_valid[:, None, :]
    w = contrib * torch.where(cand_valid, cand[..., 4], 0.0)[:, None, :]
    merged = torch.bmm(w, cand[..., 0:4]) / w.sum(
        -1, keepdim=True).clamp_min(1e-12)
    several = cand_valid.sum(1, keepdim=True) > 1  # [B, 1]
    boxes4 = torch.where((several & keep)[..., None], merged, cand[..., 0:4])
    keep = keep & torch.where(several, contrib.sum(-1) > 1, True)
    return torch.cat([boxes4, cand[..., 4:]], dim=-1), keep


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
    backend: str | None = None,
    agnostic: bool = False,
    merge: bool = False,
    classes: tuple[int, ...] | None = None,
):
    """[B, N, 6] float32 candidates -> ([B, max_det, 6], [B, max_det] valid).

    ``agnostic``: suppression across classes; ``merge``: merge-NMS box
    fusion; ``classes``: keep only these class ids. All stay fixed-shape
    (masking, not filtering)."""
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"unknown NMS backend {backend!r}; "
                         f"choose from {BACKENDS}")
    cand, cand_valid, offset_boxes = _select_candidates(
        boxes, conf_threshold, top_k, agnostic, classes)
    keep = greedy_suppress(offset_boxes.contiguous(), cand_valid,
                           iou_threshold)
    if merge:
        # the first max_det survivors in score order merge; later ranks
        # neither merge nor fill the slots the redundancy filter frees
        keep = keep & (torch.cumsum(keep, dim=1) <= max_detections)
        cand, keep = _merge_kept(cand, cand_valid, offset_boxes, keep,
                                 iou_threshold)
    return _finalize(cand, keep, max_detections)


def nms_padded(boxes: torch.Tensor, conf_threshold: float = 0.25,
               iou_threshold: float = 0.45, top_k: int = 512,
               max_detections: int = 100, backend: str | None = None,
               agnostic: bool = False, merge: bool = False,
               classes: tuple[int, ...] | None = None):
    """Single-image NMS: [N, 6] -> ([max_det, 6], [max_det] valid)."""
    out, valid = batched_class_aware_nms(
        boxes[None], conf_threshold, iou_threshold, top_k, max_detections,
        backend, agnostic, merge, classes)
    return out[0], valid[0]
