"""Host-side image augmentations (numpy / cv2): the port's copy of
``podtpu/data/augment.py``. Same draws from the same generator in the same
order, same cv2 calls, so a sample is bit-identical to ``podtpu``'s
(``tests/test_torch_data.py``).

Independent implementations of the two augmentation pipelines the reference
uses (SURVEY.md §2.3):

* the Ultralytics-style **letterbox pipeline** that produced the published
  YOLOv3 numbers — aspect-preserving resize, pad-to-square with gray 114,
  random affine (translate 0.1 / scale 0.5), HSV jitter (0.015/0.7/0.4),
  horizontal flip p=0.5 (dataset/detection/datasets.py:33-91,
  augmentations.py:47-210);
* the **simple pipeline** used by the v1/v2/v4-tiny recipes — hflip, CLAHE,
  color jitter (0.5/0.2/0.5/0.1), random-resized-crop scale (0.5, 1) ratio
  (0.4, 1.6) with min_visibility 0.3, /255 normalize
  (dataset/detection/yolo_dataset.py:58-76).

All functions take an explicit ``np.random.Generator`` so a sample is a pure
function of (image, labels, seed) — deterministic, resumable, and
shardable across hosts. Boxes are [N, 5] rows; the letterbox path uses
``[cls, x1, y1, x2, y2]`` pixels mid-pipeline, the public batch format is
``[cx, cy, w, h, cls]`` normalized.

Provenance note: the letterbox/affine/box-filter *distributions* (matrix
pipeline, gray-114 fill, candidate thresholds) deliberately match the
reference's Ultralytics-derived augmentations
(dataset/detection/augmentations.py, GPL-3.0-tagged upstream) because
matching the published VOC numbers requires matching those exact output
distributions — they are the parity surface, locked by oracle tests in
tests/test_data.py. The code here is an independent reimplementation
(explicit generator threading, no perspective/segment branches, different
structure), not a copy.
"""

from __future__ import annotations

import math

import cv2
import numpy as np

GRAY = 114


# --------------------------------------------------------------------------
# letterbox pipeline pieces
# --------------------------------------------------------------------------

def load_resized(path: str, target: int, augment: bool):
    """Read BGR image and pre-resize so max(h, w) == target.

    INTER_AREA for downscale at eval, INTER_LINEAR when augmenting
    (datasets.py:172-182 behavior).
    """
    im = cv2.imread(path)
    if im is None:
        raise FileNotFoundError(f"image not found: {path}")
    h0, w0 = im.shape[:2]
    r = target / max(h0, w0)
    if r != 1:
        interp = cv2.INTER_AREA if (r < 1 and not augment) else cv2.INTER_LINEAR
        im = cv2.resize(im, (int(w0 * r), int(h0 * r)), interpolation=interp)
    return im, (h0, w0), im.shape[:2]


def letterbox(im: np.ndarray, new_size: int, scaleup: bool = True):
    """Pad-to-square with gray borders; returns (img, ratio, (dw, dh))."""
    h, w = im.shape[:2]
    r = min(new_size / h, new_size / w)
    if not scaleup:
        r = min(r, 1.0)
    new_w, new_h = int(round(w * r)), int(round(h * r))
    dw = (new_size - new_w) / 2
    dh = (new_size - new_h) / 2
    if (w, h) != (new_w, new_h):
        im = cv2.resize(im, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    im = cv2.copyMakeBorder(
        im, top, bottom, left, right, cv2.BORDER_CONSTANT,
        value=(GRAY, GRAY, GRAY),
    )
    return im, (r, r), (dw, dh)


def box_survivors(before: np.ndarray, after: np.ndarray, scale: float,
                  wh_thr: float = 2.0, ar_thr: float = 20.0,
                  area_thr: float = 0.1) -> np.ndarray:
    """Which warped boxes remain valid (min size / aspect / area-retention)."""
    eps = 1e-16
    w1 = (before[:, 2] - before[:, 0]) * scale
    h1 = (before[:, 3] - before[:, 1]) * scale
    w2 = after[:, 2] - after[:, 0]
    h2 = after[:, 3] - after[:, 1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (
        (w2 > wh_thr)
        & (h2 > wh_thr)
        & (w2 * h2 / (w1 * h1 + eps) > area_thr)
        & (ar < ar_thr)
    )


def draw_affine_params(
    im_shape: tuple[int, int],
    rng: np.random.Generator,
    degrees: float = 0.0,
    translate: float = 0.1,
    scale: float = 0.5,
    shear: float = 0.0,
    border: tuple[int, int] = (0, 0),
):
    """Draw the affine transform ``(m, s, (height, width))`` without
    applying it. The rng draw order (angle, scale, shear x2, translate x2)
    is the contract: :func:`random_affine` and the device-geometry path
    (``device_geom``) both consume this stream, so the same sample seed
    yields the same transform either way."""
    height = im_shape[0] + border[0] * 2
    width = im_shape[1] + border[1] * 2

    # Build the combined 3x3 transform: translate(center) -> rot/scale ->
    # shear -> translate(random). Draw order matches a natural pipeline; the
    # distributions are the ones the active recipe uses.
    c = np.eye(3)
    c[0, 2] = -im_shape[1] / 2
    c[1, 2] = -im_shape[0] / 2

    r = np.eye(3)
    angle = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    rot = cv2.getRotationMatrix2D(angle=angle, center=(0, 0), scale=s)
    r[:2] = rot

    sh = np.eye(3)
    sh[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    sh[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)

    t = np.eye(3)
    t[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * width
    t[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * height

    return t @ sh @ r @ c, s, (height, width)


def affine_boxes(boxes_xyxy: np.ndarray, m: np.ndarray, s: float,
                 width: int, height: int) -> np.ndarray:
    """Transform+clip [N,5] ``[cls,x1,y1,x2,y2]`` boxes by ``m`` and drop
    non-survivors (same corner-hull + survivor math as the warp path)."""
    n = len(boxes_xyxy)
    if n:
        corners = np.ones((n * 4, 3))
        corners[:, :2] = boxes_xyxy[:, [1, 2, 3, 4, 1, 4, 3, 2]].reshape(n * 4, 2)
        warped = (corners @ m.T)[:, :2].reshape(n, 8)
        xs = warped[:, [0, 2, 4, 6]]
        ys = warped[:, [1, 3, 5, 7]]
        new = np.stack(
            [xs.min(1), ys.min(1), xs.max(1), ys.max(1)], axis=1
        )
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
        keep = box_survivors(boxes_xyxy[:, 1:5], new, s)
        boxes_xyxy = boxes_xyxy[keep]
        boxes_xyxy[:, 1:5] = new[keep]
    return boxes_xyxy


def random_affine(
    im: np.ndarray,
    boxes_xyxy: np.ndarray,
    rng: np.random.Generator,
    degrees: float = 0.0,
    translate: float = 0.1,
    scale: float = 0.5,
    shear: float = 0.0,
    border: tuple[int, int] = (0, 0),
):
    """Random rotation/scale/shear/translation of image + pixel-xyxy boxes.

    boxes_xyxy: [N, 5] rows [cls, x1, y1, x2, y2].

    ``border`` shrinks (negative) or grows the output canvas relative to the
    input: output dims are ``im.shape + 2*border``. The mosaic path passes
    ``border=(-s//2, -s//2)`` so the warp *crops* the 2S canvas down to S —
    the reference's ``random_perspective(..., border=self.mosaic_border)``
    semantics (augmentations.py:124-133, datasets.py:231-239) — instead of
    resizing, which would produce a different scale distribution.
    """
    m, s, (height, width) = draw_affine_params(
        im.shape[:2], rng, degrees, translate, scale, shear, border)
    if border != (0, 0) or not np.allclose(m, np.eye(3)):
        im = cv2.warpAffine(im, m[:2], dsize=(width, height),
                            borderValue=(GRAY, GRAY, GRAY))

    return im, affine_boxes(boxes_xyxy, m, s, width, height)


def augment_hsv(im: np.ndarray, rng: np.random.Generator,
                hgain: float = 0.015, sgain: float = 0.7, vgain: float = 0.4
                ) -> np.ndarray:
    """In-place style HSV jitter via channel LUTs (BGR input)."""
    gains = rng.uniform(-1, 1, 3) * (hgain, sgain, vgain) + 1
    hue, sat, val = cv2.split(cv2.cvtColor(im, cv2.COLOR_BGR2HSV))
    x = np.arange(256, dtype=gains.dtype)
    lut_h = ((x * gains[0]) % 180).astype(im.dtype)
    lut_s = np.clip(x * gains[1], 0, 255).astype(im.dtype)
    lut_v = np.clip(x * gains[2], 0, 255).astype(im.dtype)
    hsv = cv2.merge((cv2.LUT(hue, lut_h), cv2.LUT(sat, lut_s),
                     cv2.LUT(val, lut_v)))
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)


def pixel_ops(im: np.ndarray, rng: np.random.Generator,
              p: float = 0.01) -> np.ndarray:
    """The reference's Albumentations wrapper: Blur / MedianBlur / ToGray /
    CLAHE, each applied independently with probability ``p`` = 0.01
    (dataset/detection/augmentations.py:24-32; active in the published runs —
    the package is a declared dependency, README.md:19).

    Pixel-only, label-free (the other three transforms in that Compose have
    p=0.0). Math mirrors albumentations 1.0.3's cv2 calls, including feeding
    the BGR working buffer into RGB-convention conversions exactly like the
    reference does (Ultralytics keeps images BGR until tensor conversion):

    * Blur / MedianBlur: kernel size drawn from {3, 5, 7} (blur_limit 7);
    * ToGray: RGB2GRAY weights on the BGR buffer, replicated to 3 channels;
    * CLAHE: clip limit ~ U(1, 4), 8x8 tiles, applied to LAB's L channel
      via the RGB2LAB conversion on the BGR buffer.

    ``rng`` must be a stream independent of the sample's geometry/HSV draws
    (the dataset derives one per sample) so enabling/disabling this never
    shifts the locked augmentation draw stream.
    """
    if rng.random() < p:  # Blur
        k = int(rng.choice((3, 5, 7)))
        im = cv2.blur(im, (k, k))
    if rng.random() < p:  # MedianBlur
        k = int(rng.choice((3, 5, 7)))
        im = cv2.medianBlur(np.ascontiguousarray(im), k)
    if rng.random() < p:  # ToGray
        gray = cv2.cvtColor(im, cv2.COLOR_RGB2GRAY)
        im = cv2.cvtColor(gray, cv2.COLOR_GRAY2RGB)
    if rng.random() < p:  # CLAHE
        clip = float(rng.uniform(1.0, 4.0))
        op = cv2.createCLAHE(clipLimit=clip, tileGridSize=(8, 8))
        lab = cv2.cvtColor(im, cv2.COLOR_RGB2LAB)
        lab[:, :, 0] = op.apply(lab[:, :, 0])
        im = cv2.cvtColor(lab, cv2.COLOR_LAB2RGB)
    return im


# --------------------------------------------------------------------------
# simple pipeline pieces (v1/v2/v4-tiny recipes)
# --------------------------------------------------------------------------

def clahe(im: np.ndarray) -> np.ndarray:
    """Contrast-limited adaptive histogram equalization on the luma channel."""
    lab = cv2.cvtColor(im, cv2.COLOR_RGB2LAB)
    op = cv2.createCLAHE(clipLimit=4.0, tileGridSize=(8, 8))
    lab[:, :, 0] = op.apply(lab[:, :, 0])
    return cv2.cvtColor(lab, cv2.COLOR_LAB2RGB)


def color_jitter(im: np.ndarray, rng: np.random.Generator,
                 brightness: float = 0.5, contrast: float = 0.2,
                 saturation: float = 0.5, hue: float = 0.1) -> np.ndarray:
    """Random brightness/contrast/saturation/hue (RGB uint8)."""
    img = im.astype(np.float32)
    b = rng.uniform(max(0, 1 - brightness), 1 + brightness)
    img *= b
    c = rng.uniform(max(0, 1 - contrast), 1 + contrast)
    mean = img.mean()
    img = (img - mean) * c + mean
    img = np.clip(img, 0, 255).astype(np.uint8)

    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV).astype(np.float32)
    s = rng.uniform(max(0, 1 - saturation), 1 + saturation)
    hsv[:, :, 1] = np.clip(hsv[:, :, 1] * s, 0, 255)
    h_shift = rng.uniform(-hue, hue) * 180
    hsv[:, :, 0] = (hsv[:, :, 0] + h_shift) % 180
    return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)


def random_resized_crop(
    im: np.ndarray,
    boxes: np.ndarray,
    rng: np.random.Generator,
    out_size: int,
    scale: tuple[float, float] = (0.5, 1.0),
    ratio: tuple[float, float] = (0.4, 1.6),
    min_visibility: float = 0.3,
):
    """Random crop (area in ``scale``, aspect in ``ratio``) resized to square.

    boxes: [N, 5] normalized [cx, cy, w, h, cls]; boxes keeping less than
    ``min_visibility`` of their area are dropped (the bbox_params contract of
    the reference's transform: yolo_dataset.py:70).
    """
    h, w = im.shape[:2]
    x0, y0, cw, ch = draw_rrc_params(h, w, rng, scale, ratio)
    crop = im[y0:y0 + ch, x0:x0 + cw]
    crop = cv2.resize(crop, (out_size, out_size), interpolation=cv2.INTER_LINEAR)
    return crop, rrc_boxes(boxes, x0, y0, cw, ch, h, w, min_visibility)


def draw_rrc_params(h: int, w: int, rng: np.random.Generator,
                    scale: tuple[float, float] = (0.5, 1.0),
                    ratio: tuple[float, float] = (0.4, 1.6)):
    """Draw a RandomResizedCrop rect ``(x0, y0, cw, ch)`` in image pixels.

    Same draw stream as :func:`random_resized_crop` (which calls this), so
    the ``device_geom`` path reproduces identical crops from the same seed.
    """
    area = h * w
    for _ in range(10):
        target_area = rng.uniform(*scale) * area
        aspect = math.exp(rng.uniform(math.log(ratio[0]), math.log(ratio[1])))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            x0 = int(rng.integers(0, w - cw + 1))
            y0 = int(rng.integers(0, h - ch + 1))
            return x0, y0, cw, ch
    cw = ch = min(h, w)
    return (w - cw) // 2, (h - ch) // 2, cw, ch


def rrc_boxes(boxes: np.ndarray, x0: int, y0: int, cw: int, ch: int,
              h: int, w: int, min_visibility: float = 0.3) -> np.ndarray:
    """Crop-rect box transform + min-visibility filter for normalized
    ``[cx, cy, w, h, cls]`` rows (the tail of :func:`random_resized_crop`)."""
    if len(boxes):
        x1 = boxes[:, 0] * w - boxes[:, 2] * w / 2
        y1 = boxes[:, 1] * h - boxes[:, 3] * h / 2
        x2 = boxes[:, 0] * w + boxes[:, 2] * w / 2
        y2 = boxes[:, 1] * h + boxes[:, 3] * h / 2
        full = (x2 - x1) * (y2 - y1)
        cx1 = np.clip(x1 - x0, 0, cw)
        cy1 = np.clip(y1 - y0, 0, ch)
        cx2 = np.clip(x2 - x0, 0, cw)
        cy2 = np.clip(y2 - y0, 0, ch)
        vis = (cx2 - cx1).clip(0) * (cy2 - cy1).clip(0) / (full + 1e-9)
        keep = vis >= min_visibility
        out = np.zeros((keep.sum(), 5), np.float32)
        out[:, 0] = (cx1[keep] + cx2[keep]) / 2 / cw
        out[:, 1] = (cy1[keep] + cy2[keep]) / 2 / ch
        out[:, 2] = (cx2[keep] - cx1[keep]) / cw
        out[:, 3] = (cy2[keep] - cy1[keep]) / ch
        out[:, 4] = boxes[keep, 4]
        boxes = out
    return boxes


def mosaic4(images, boxes_list, out_size: int, rng: np.random.Generator):
    """4-image mosaic (the reference defines it unwired: datasets.py:185-239).

    images: 4 BGR/RGB arrays already pre-resized so max side == out_size;
    boxes_list: 4 x [n, 5] rows [cls, x1, y1, x2, y2] in each image's pixels.
    Returns (canvas [2S, 2S, 3], boxes [m, 5] canvas pixels).
    """
    s = out_size
    yc = int(rng.uniform(s // 2, 3 * s // 2))
    xc = int(rng.uniform(s // 2, 3 * s // 2))
    canvas = np.full((2 * s, 2 * s, 3), GRAY, dtype=images[0].dtype)
    out_boxes = []
    for i, (img, boxes) in enumerate(zip(images, boxes_list)):
        h, w = img.shape[:2]
        if i == 0:  # top-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
        elif i == 1:  # top-right
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, 2 * s), yc
            x1b, y1b = 0, h - (y2a - y1a)
        elif i == 2:  # bottom-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(2 * s, yc + h)
            x1b, y1b = w - (x2a - x1a), 0
        else:  # bottom-right
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, 2 * s), min(2 * s, yc + h)
            x1b, y1b = 0, 0
        canvas[y1a:y2a, x1a:x2a] = img[y1b:y1b + (y2a - y1a),
                                       x1b:x1b + (x2a - x1a)]
        if len(boxes):
            b = boxes.copy()
            b[:, [1, 3]] += x1a - x1b
            b[:, [2, 4]] += y1a - y1b
            out_boxes.append(b)
    boxes = (np.concatenate(out_boxes)
             if out_boxes else np.zeros((0, 5), np.float32))
    if len(boxes):
        boxes[:, 1:] = boxes[:, 1:].clip(0, 2 * s)
        wh_ok = (boxes[:, 3] - boxes[:, 1] > 2) & (boxes[:, 4] - boxes[:, 2] > 2)
        boxes = boxes[wh_ok]
    return canvas, boxes


def mixup(im1, boxes1, im2, boxes2, rng: np.random.Generator):
    """Beta(32, 32) image blend, union of labels (augmentations.py:264-269
    semantics)."""
    r = rng.beta(32.0, 32.0)
    im = (im1.astype(np.float32) * r + im2.astype(np.float32) * (1 - r))
    im = im.astype(im1.dtype)
    boxes = np.concatenate([boxes1, boxes2]) if len(boxes1) or len(boxes2) \
        else np.zeros((0, boxes1.shape[1] if boxes1.ndim == 2 else 5),
                      np.float32)
    return im, boxes


def cutout(im: np.ndarray, boxes: np.ndarray, rng: np.random.Generator,
           max_obscure: float = 0.6):
    """Random rectangular erasures; drops labels that get mostly covered
    (augmentations.py:237-261 semantics). boxes: [n,5] [cls,x1,y1,x2,y2]."""
    h, w = im.shape[:2]
    scales = [0.5] + [0.25] * 2 + [0.125] * 4 + [0.0625] * 8
    for s in scales:
        mh = int(rng.integers(1, max(2, int(h * s))))
        mw = int(rng.integers(1, max(2, int(w * s))))
        x1 = max(0, int(rng.integers(0, w)) - mw // 2)
        y1 = max(0, int(rng.integers(0, h)) - mh // 2)
        x2, y2 = min(w, x1 + mw), min(h, y1 + mh)
        im[y1:y2, x1:x2] = rng.integers(64, 191, 3)
        if len(boxes) and s > 0.03:
            bx1, by1, bx2, by2 = boxes[:, 1], boxes[:, 2], boxes[:, 3], boxes[:, 4]
            iw = (np.minimum(bx2, x2) - np.maximum(bx1, x1)).clip(0)
            ih = (np.minimum(by2, y2) - np.maximum(by1, y1)).clip(0)
            area = ((bx2 - bx1) * (by2 - by1)) + 1e-9
            boxes = boxes[(iw * ih / area) < max_obscure]
    return im, boxes


def hist_equalize(im: np.ndarray, use_clahe: bool = True) -> np.ndarray:
    """Y-channel histogram equalization in YUV space.

    Dormant-variant parity with the reference's ``hist_equalize``
    (dataset/detection/augmentations.py:63-71): equalize only luma (CLAHE
    clip 2.0 / 8x8 tiles, or global equalizeHist), leave chroma untouched.
    RGB in, RGB out.
    """
    yuv = cv2.cvtColor(im, cv2.COLOR_RGB2YUV)
    if use_clahe:
        op = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
        yuv[:, :, 0] = op.apply(yuv[:, :, 0])
    else:
        yuv[:, :, 0] = cv2.equalizeHist(yuv[:, :, 0])
    return cv2.cvtColor(yuv, cv2.COLOR_YUV2RGB)


def replicate(im: np.ndarray, boxes: np.ndarray,
              rng: np.random.Generator):
    """Duplicate the smaller half of the boxes at random free offsets.

    Dormant-variant parity with the reference's ``replicate``
    (dataset/detection/augmentations.py:74-88): the half of the labels with
    the smallest mean side length are copied — pixels pasted at a uniformly
    random in-bounds offset, a new label row appended per copy. Boxes here
    are ``[cls, x1, y1, x2, y2]`` pixel rows (the letterbox-pipeline
    mid-format the reference uses at this stage).
    """
    if boxes.shape[0] == 0:
        return im, boxes
    h, w = im.shape[:2]
    xyxy = boxes[:, 1:].astype(int)
    x1, y1, x2, y2 = xyxy.T
    side = ((x2 - x1) + (y2 - y1)) / 2
    new_rows = []
    for i in side.argsort()[: round(side.size * 0.5)]:
        x1b, y1b, x2b, y2b = xyxy[i]
        bh, bw = y2b - y1b, x2b - x1b
        if bh <= 0 or bw <= 0 or bh >= h or bw >= w:
            continue
        yc = int(rng.uniform(0, h - bh))
        xc = int(rng.uniform(0, w - bw))
        im[yc:yc + bh, xc:xc + bw] = im[y1b:y2b, x1b:x2b]
        new_rows.append([boxes[i, 0], xc, yc, xc + bw, yc + bh])
    if new_rows:
        boxes = np.concatenate(
            [boxes, np.asarray(new_rows, boxes.dtype)], axis=0)
    return im, boxes


def bbox_ioa(box: np.ndarray, boxes: np.ndarray,
             eps: float = 1e-7) -> np.ndarray:
    """Intersection of ``box`` with each of ``boxes``, over the *boxes* area.

    Same statistic as the reference's occlusion gate
    (utils/metrics.py:258-281): how much of each existing label the
    candidate rectangle would cover. All boxes are x1y1x2y2.
    """
    if boxes.shape[0] == 0:
        return np.zeros((0,), np.float32)
    iw = (np.minimum(box[2], boxes[:, 2])
          - np.maximum(box[0], boxes[:, 0])).clip(0)
    ih = (np.minimum(box[3], boxes[:, 3])
          - np.maximum(box[1], boxes[:, 1])).clip(0)
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]) + eps
    return iw * ih / area


def copy_paste(im: np.ndarray, boxes: np.ndarray, segments: list,
               rng: np.random.Generator, p: float = 0.5):
    """Mirror copy-paste (arXiv:2012.07177, the simplified mirror variant
    the reference wires into its mosaic path —
    dataset/detection/augmentations.py:213-234, datasets.py:230).

    A ``round(p * n)`` random sample of polygon-labelled objects is
    considered; each candidate's horizontally-mirrored footprint is
    accepted only if it covers every label placed so far by < 30% IoA.
    Accepted objects have their pixels mirrored across the vertical axis
    onto the image, and a mirrored label + polygon appended.

    ``boxes``: [n, 5] ``[cls, x1, y1, x2, y2]`` pixel rows (the letterbox
    mid-format); ``segments``: list of [k, 2] xy polygons, one per row.
    Returns ``(im, boxes, segments)``. With no polygons this is a no-op —
    exactly the reference's behavior on yolo-txt data, whose 5-field label
    files carry no segmentation (datasets.py::_get_labels); podtpu's
    dataset therefore synthesizes rectangle polygons when the cfg knob is
    set (see ``Dataset._mosaic_sample``) so the knob is actually usable.
    """
    n = len(segments)
    if not p or not n:
        return im, boxes, segments
    h, w = im.shape[:2]
    mask = np.zeros((h, w), np.uint8)
    segments = list(segments)
    any_accepted = False
    for j in rng.permutation(n)[: round(p * n)]:
        cls, x1, y1, x2, y2 = boxes[j]
        mirrored = np.array([w - x2, y1, w - x1, y2], boxes.dtype)
        if (bbox_ioa(mirrored, boxes[:, 1:5]) < 0.30).all():
            boxes = np.concatenate(
                [boxes, [[cls, *mirrored]]], axis=0).astype(boxes.dtype)
            seg = segments[j]
            segments.append(
                np.concatenate([w - seg[:, :1], seg[:, 1:2]], axis=1))
            cv2.fillPoly(mask, [segments[j].astype(np.int32)], 255)
            any_accepted = True
    if any_accepted:
        donor = cv2.flip(cv2.bitwise_and(im, im, mask=mask), 1)
        keep = donor > 0
        im = im.copy()
        im[keep] = donor[keep]
    return im, boxes, segments


def hflip(im: np.ndarray, boxes: np.ndarray):
    """Horizontal flip; boxes normalized [cx, cy, w, h, cls]."""
    im = np.ascontiguousarray(im[:, ::-1])
    if len(boxes):
        boxes = boxes.copy()
        boxes[:, 0] = 1.0 - boxes[:, 0]
    return im, boxes
