"""Greedy NMS suppression: the CUDA kernels' wrapper and its plain version.

Replaces the Pallas TPU kernel ``podtpu/ops/pallas/nms_kernel.py``
(``pallas_greedy_suppress``). The kernels are ``csrc/nms_suppress.cu``: a
bitmask of every IoU test over the whole card (``iou_mask_kernel``), then
one warp per image scanning it in index order (``scan_kernel``); its source
says what bounds them and how the design answers that.

* :func:`greedy_suppress` — the entry point of the NMS path. A CUDA tensor
  goes to the kernels (or the call raises); a CPU tensor goes to
  :func:`greedy_suppress_reference`.
* :func:`greedy_suppress_cuda` — both kernels, one C call. Counts its
  launches in ``greedy_suppress.launches``, one a call.
* :func:`greedy_suppress_reference` — the plain PyTorch version: the dense
  greedy loop of ``podtpu``'s ``_xla_suppress``. The CPU path and the tests
  use it, and the card's path never does.
"""

from __future__ import annotations

import ctypes

import torch

from podtpu_torch.ops.boxes import pairwise_iou

# The bitmask scratch grows as K^2 / 8 bytes an image (K rows of
# ceil(K / 64) words): 8 MB an image at 8192 boxes.
MAX_K = 8192

_FNS: dict = {}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # boxes, valid, mask, keep, b, k, thr, stream
    "suppress": [_P, _P, _P, _P, _I, _I, _F, _P],
    # boxes, mask, b, k, thr, stream
    "iou_mask": [_P, _P, _I, _I, _F, _P],
    # mask, valid, keep, b, k, stream
    "scan": [_P, _P, _P, _I, _I, _P],
}


def _kernel(name: str = "suppress"):
    """The C entry point ``podtpu_nms_<name>`` of ``csrc/nms_suppress.cu``."""
    fn = _FNS.get(name)
    if fn is None:
        from podtpu_torch.ops.kernels.build import load

        fn = getattr(load("nms_suppress"), f"podtpu_nms_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
        _FNS[name] = fn
    return fn


def mask_words(k: int) -> int:
    """Words of the IoU bitmask per box row, 64 boxes a word: ceil(K / 64)."""
    return (k + 63) // 64


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
    """Launch ``csrc/nms_suppress.cu``'s two kernels on PyTorch's current
    stream, in one C call.

    The IoU bitmask between them is scratch from ``torch.empty``: int64
    [B, K, ceil(K / 64)], 256 KB at B=8, K=512 and 8 MB an image at
    K = ``MAX_K``."""
    _check(boxes, valid)
    if boxes.device.type != "cuda":
        raise ValueError(f"greedy_suppress_cuda takes CUDA tensors, got "
                         f"{boxes.device}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("boxes and valid must be contiguous")
    b, k = valid.shape
    if k > MAX_K:
        raise ValueError(f"K={k} exceeds {MAX_K} boxes per image, the bound "
                         f"of the kernels' K^2 / 8-byte bitmask scratch")
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0 or k == 0:
        return keep
    mask = torch.empty((b, k, mask_words(k)), dtype=torch.int64,
                       device=boxes.device)
    fn = _kernel()
    with torch.cuda.device(boxes.device):
        err = fn(boxes.data_ptr(), valid.data_ptr(), mask.data_ptr(),
                 keep.data_ptr(), b, k, float(iou_threshold),
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
