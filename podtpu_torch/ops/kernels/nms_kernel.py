"""Greedy NMS suppression: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``podtpu/ops/pallas/nms_kernel.py``
(``pallas_greedy_suppress``). The kernel is ``csrc/nms_suppress.cu``; its
source says what bounds it and how the design answers that.

* :func:`greedy_suppress` — the entry point of the NMS path. A CUDA tensor
  goes to the kernel (or the call raises); a CPU tensor goes to
  :func:`greedy_suppress_reference`.
* :func:`greedy_suppress_cuda` — the kernel launch. Counts its launches in
  ``greedy_suppress.launches``.
* :func:`greedy_suppress_reference` — the plain PyTorch version: the dense
  greedy loop of ``podtpu``'s ``_xla_suppress``. The CPU path and the tests
  use it, and the card's path never does.
"""

from __future__ import annotations

import ctypes

import torch

from podtpu_torch.ops.boxes import pairwise_iou

# shared memory per block is 21 bytes a box (box, area, keep byte); 8192
# boxes fit in the 227 KB a block may use on Hopper
MAX_K = 8192

_FN = None


def _kernel():
    global _FN
    if _FN is None:
        from podtpu_torch.ops.kernels.build import load

        fn = load("nms_suppress").podtpu_nms_suppress
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_void_p]
        _FN = fn
    return _FN


def _check(boxes: torch.Tensor, valid: torch.Tensor):
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be [B, K, 4], got {tuple(boxes.shape)}")
    if valid.shape != boxes.shape[:2]:
        raise ValueError(f"valid must be [B, K] = {tuple(boxes.shape[:2])}, "
                         f"got {tuple(valid.shape)}")
    if boxes.dtype != torch.float32:
        raise TypeError(f"boxes must be float32, got {boxes.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if valid.device != boxes.device:
        raise ValueError(f"boxes on {boxes.device}, valid on {valid.device}")


def greedy_suppress_reference(boxes: torch.Tensor, valid: torch.Tensor,
                              iou_threshold: float) -> torch.Tensor:
    """Dense greedy loop: ``keep <- keep & ~(keep[i] & sup[i])`` for i in
    index order, from ``keep = valid``. Returns bool [B, K]."""
    _check(boxes, valid)
    k = boxes.shape[1]
    iou = pairwise_iou(boxes, boxes)
    eye = torch.eye(k, dtype=torch.bool, device=boxes.device)
    suppress = (iou > iou_threshold) & ~eye
    keep = valid.clone()
    for i in range(k):
        keep &= ~(keep[:, i:i + 1] & suppress[:, i])
    return keep


def greedy_suppress_cuda(boxes: torch.Tensor, valid: torch.Tensor,
                         iou_threshold: float) -> torch.Tensor:
    """Launch ``csrc/nms_suppress.cu`` on PyTorch's current stream."""
    _check(boxes, valid)
    if boxes.device.type != "cuda":
        raise ValueError(f"greedy_suppress_cuda takes CUDA tensors, got "
                         f"{boxes.device}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("boxes and valid must be contiguous")
    b, k = valid.shape
    if k > MAX_K:
        raise ValueError(f"K={k} exceeds the kernel's shared-memory limit "
                         f"of {MAX_K} boxes per image")
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0 or k == 0:
        return keep
    fn = _kernel()
    with torch.cuda.device(boxes.device):
        err = fn(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, k,
                 float(iou_threshold),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"nms_suppress launch failed: cudaError {err}")
    greedy_suppress.launches += 1
    return keep


def greedy_suppress(boxes: torch.Tensor, valid: torch.Tensor,
                    iou_threshold: float) -> torch.Tensor:
    """Batched greedy suppression of score-sorted, class-offset xyxy boxes.

    Args:
      boxes: [B, K, 4] float32 contiguous.
      valid: [B, K] bool candidate validity.

    Returns bool [B, K] keep mask.
    """
    if boxes.device.type == "cpu":
        return greedy_suppress_reference(boxes, valid, iou_threshold)
    return greedy_suppress_cuda(boxes, valid, iou_threshold)


greedy_suppress.launches = 0
