"""YOLO-txt file-list datasets with the two reference pipelines (the port's
copy of ``podtpu/data/dataset.py``: the same draws in the same order, so a
sample is bit-identical to ``podtpu``'s).

A dataset is a list of image paths (one per line in ``train.txt``/``val.txt``)
with sibling ``.txt`` label files of ``cid cx cy w h`` normalized rows.

``pipeline='letterbox'`` is the Ultralytics-style path that trained the
published YOLOv3 numbers; ``pipeline='simple'`` is the v1/v2/v4-tiny path.
Samples are pure functions of (index, seed): the loader derives one seed per
(epoch, index) so augmentation is reproducible and host-shardable.

Output per sample: ``img`` [H, W, 3] float32 RGB in [0, 1] (or uint8 with
``output_uint8``), NHWC, and ``boxes`` [n, 5] normalized
``[cx, cy, w, h, cls]``.

With cfg ``device_augment`` (``photometric=False``) the host skips its
photometric stages and their draws, which then run in the train step
(``data/device_aug.py``); with ``device_geom`` the random affine (letterbox)
or the resized crop (simple) is drawn here, its boxes transformed here, and
the pixels ship un-warped beside a per-sample ``geom`` row
``(sx, sy, bx, by)`` that the train step applies as a separable warp.
"""

from __future__ import annotations

import cv2
import numpy as np

from podtpu_torch.data import augment as A

# device_geom identity row (sx, sy, bx, by): the sample needs no device warp
IDENTITY_GEOM = np.array([1.0, 1.0, 0.0, 0.0], np.float32)


def read_yolo_labels(label_path: str) -> np.ndarray:
    """[N, 5] rows [cls, cx, cy, w, h] (raw file order)."""
    rows = []
    try:
        with open(label_path, "r") as f:
            for line in f.read().splitlines():
                if not line.strip():
                    continue
                cid, cx, cy, w, h = map(float, line.split())
                rows.append([cid, cx, cy, w, h])
    except FileNotFoundError:
        pass
    return np.asarray(rows, np.float32).reshape(-1, 5)


def label_path_for(img_path: str) -> str:
    for ext in (".jpg", ".jpeg", ".png", ".bmp"):
        if img_path.lower().endswith(ext):
            return img_path[: -len(ext)] + ".txt"
    return img_path + ".txt"


class YoloTxtDataset:
    def __init__(self, list_file: str, input_size: int, augment: bool,
                 pipeline: str = "letterbox", mosaic: float = 0.0,
                 copy_paste: float = 0.0,
                 cache_images: bool = False, output_uint8: bool = False,
                 photometric: bool = True, device_geom: bool = False,
                 pixel_ops: bool = True):
        with open(list_file, "r") as f:
            self.imgs = [l for l in f.read().splitlines() if l.strip()]
        self.input_size = input_size
        self.augment = augment
        assert pipeline in ("letterbox", "simple")
        self.pipeline = pipeline
        # 4-image mosaic probability (opt-in via cfg `mosaic`)
        self.mosaic = mosaic
        # mirror copy-paste probability on the mosaic canvas; yolo-txt
        # labels carry no polygons, so rectangle polygons are synthesized
        # from the boxes
        self.copy_paste = copy_paste
        # opt-in in-RAM cache of decoded+pre-resized images (+ labels)
        self._cache: dict[int, tuple] | None = {} if cache_images else None
        # ship uint8 RGB and let the device cast+/255: 4x less to copy
        self.output_uint8 = output_uint8
        # False with cfg device_augment: the HSV jitter and the flip run on
        # the batch's device (data/device_aug.py); the host keeps geometry
        self.photometric = photometric
        # cfg device_geom: the random affine also moves to the device. The
        # samples ship un-warped pixels and a (sx, sy, bx, by) row; boxes
        # are still transformed here with the same draw stream, so labels
        # equal the host-warp path's. Mosaic samples keep the host warp
        # (their canvas is 2S) and ship an identity row.
        self.device_geom = device_geom
        if device_geom and photometric:
            raise ValueError("device_geom requires device_augment "
                             "(photometric=False)")
        # the reference's Albumentations wrapper (Blur/MedianBlur/ToGray/
        # CLAHE, each p=0.01) runs in its letterbox pipeline only; draws
        # come from a per-sample stream derived independently of the main
        # one, so toggling it never shifts the geometry/HSV draw stream
        self.pixel_ops = bool(pixel_ops) and pipeline == "letterbox"

    def _load_resized_cached(self, index: int):
        if self._cache is not None and index in self._cache:
            return self._cache[index]
        path = self.imgs[index]
        im, orig, resized = A.load_resized(path, self.input_size, self.augment)
        labels = read_yolo_labels(label_path_for(path))
        entry = (im, orig, resized, labels)
        if self._cache is not None:
            self._cache[index] = entry
        return entry

    def __len__(self) -> int:
        return len(self.imgs)

    def get(self, index: int, seed: int):
        rng = np.random.default_rng(seed)
        if self.pipeline == "letterbox":
            rng_px = (np.random.default_rng((seed, 0x414C42))
                      if (self.augment and self.pixel_ops) else None)
            if self.augment and self.mosaic > 0 and rng.random() < self.mosaic:
                return self._mosaic_sample(index, rng, rng_px)
            return self._letterbox_sample(index, rng, rng_px)
        return self._simple_sample(index, rng)

    def _mosaic_sample(self, index: int, rng: np.random.Generator,
                       rng_px: np.random.Generator | None = None):
        size = self.input_size
        indices = [index] + list(rng.integers(0, len(self.imgs), 3))
        imgs, boxes_px = [], []
        for i in indices:
            im, _, (h, w), labels = self._load_resized_cached(int(i))
            if len(labels):
                cx = labels[:, 1] * w
                cy = labels[:, 2] * h
                bw = labels[:, 3] * w
                bh = labels[:, 4] * h
                b = np.stack([labels[:, 0], cx - bw / 2, cy - bh / 2,
                              cx + bw / 2, cy + bh / 2], axis=1)
            else:
                b = np.zeros((0, 5), np.float32)
            imgs.append(im)
            boxes_px.append(b)
        canvas, boxes = A.mosaic4(imgs, boxes_px, size, rng)
        if self.copy_paste > 0 and len(boxes):
            segs = [np.array([[b[1], b[2]], [b[3], b[2]],
                              [b[3], b[4]], [b[1], b[4]]], np.float32)
                    for b in boxes]
            canvas, boxes, _ = A.copy_paste(canvas, boxes, segs, rng,
                                            p=self.copy_paste)
        # the affine CROPS the 2S canvas down to S via border=-S/2
        im, boxes = A.random_affine(canvas, boxes, rng,
                                    degrees=0.0, translate=0.1,
                                    scale=0.5, shear=0.0,
                                    border=(-size // 2, -size // 2))
        out = np.zeros((len(boxes), 5), np.float32)
        if len(boxes):
            hh, ww = im.shape[:2]
            x1 = boxes[:, 1].clip(0, ww - 1e-3)
            y1 = boxes[:, 2].clip(0, hh - 1e-3)
            x2 = boxes[:, 3].clip(0, ww - 1e-3)
            y2 = boxes[:, 4].clip(0, hh - 1e-3)
            out[:, 0] = (x1 + x2) / 2 / ww
            out[:, 1] = (y1 + y2) / 2 / hh
            out[:, 2] = (x2 - x1) / ww
            out[:, 3] = (y2 - y1) / hh
            out[:, 4] = boxes[:, 0]
        if rng_px is not None:
            im = A.pixel_ops(im, rng_px)
        if self.photometric:
            im = A.augment_hsv(im, rng)
            if rng.random() < 0.5:
                im, out = self._flip_bgr(im, out)
        im = self._finalize(im, bgr=True)
        if self.device_geom:
            # warped on the host (2S canvas): identity device geometry
            return im, out, IDENTITY_GEOM
        return im, out

    # -- letterbox (v3) path ------------------------------------------------
    def _letterbox_sample(self, index: int, rng: np.random.Generator,
                          rng_px: np.random.Generator | None = None):
        size = self.input_size
        im, (h0, w0), (h, w), labels = self._load_resized_cached(index)
        im, ratio, pad = A.letterbox(im, size, scaleup=self.augment)
        # labels: [n,5] cls,cx,cy,w,h normalized
        if len(labels):
            # normalized cxcywh -> pixel xyxy in the letterboxed frame
            cx = labels[:, 1] * (ratio[0] * w) + pad[0]
            cy = labels[:, 2] * (ratio[1] * h) + pad[1]
            bw = labels[:, 3] * (ratio[0] * w)
            bh = labels[:, 4] * (ratio[1] * h)
            boxes = np.stack(
                [labels[:, 0], cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                axis=1,
            )
        else:
            boxes = np.zeros((0, 5), np.float32)

        geom = None
        if self.augment:
            if self.device_geom:
                # random_affine's draws, but the pixels ship un-warped: the
                # train step warps them (scale + translate; no rotation or
                # shear in this recipe)
                m, s, _ = A.draw_affine_params(
                    im.shape[:2], rng, degrees=0.0, translate=0.1,
                    scale=0.5, shear=0.0)
                boxes = A.affine_boxes(boxes, m, s, size, size)
                geom = np.array([m[0, 0], m[1, 1], m[0, 2], m[1, 2]],
                                np.float32)
            else:
                im, boxes = A.random_affine(im, boxes, rng,
                                            degrees=0.0, translate=0.1,
                                            scale=0.5, shear=0.0)

        # back to normalized cxcywh (+ clip, like xyxy2xywhn(clip=True))
        hh, ww = im.shape[:2]
        out = np.zeros((len(boxes), 5), np.float32)
        if len(boxes):
            x1 = boxes[:, 1].clip(0, ww - 1e-3)
            y1 = boxes[:, 2].clip(0, hh - 1e-3)
            x2 = boxes[:, 3].clip(0, ww - 1e-3)
            y2 = boxes[:, 4].clip(0, hh - 1e-3)
            out[:, 0] = (x1 + x2) / 2 / ww
            out[:, 1] = (y1 + y2) / 2 / hh
            out[:, 2] = (x2 - x1) / ww
            out[:, 3] = (y2 - y1) / hh
            out[:, 4] = boxes[:, 0]

        if rng_px is not None:
            # reference order: geometry -> Albumentations wrapper -> HSV ->
            # flip. Under device_geom the (p=0.01) pixel ops land before
            # the warp, which they commute with up to one interpolation
            im = A.pixel_ops(im, rng_px)
        if self.augment and self.photometric:
            im = A.augment_hsv(im, rng)
            if rng.random() < 0.5:
                im, out = self._flip_bgr(im, out)

        im = self._finalize(im, bgr=True)
        if self.device_geom:
            return im, out, (geom if geom is not None else IDENTITY_GEOM)
        return im, out

    def _finalize(self, im, bgr: bool = False):
        """uint8 bytes for the device-normalize path, or float32 in [0,1].
        ``bgr=True`` converts with cv2.cvtColor (SIMD, far faster than a
        reversed-channel numpy copy)."""
        if bgr:
            im = cv2.cvtColor(np.ascontiguousarray(im), cv2.COLOR_BGR2RGB)
        if self.output_uint8:
            return np.ascontiguousarray(im, dtype=np.uint8)
        return np.ascontiguousarray(im, dtype=np.float32) / 255.0

    @staticmethod
    def _flip_bgr(im, boxes):
        im = cv2.flip(im, 1)  # SIMD horizontal flip
        if len(boxes):
            boxes = boxes.copy()
            boxes[:, 0] = 1.0 - boxes[:, 0]
        return im, boxes

    # -- simple (v1/v2/v4-tiny) path -----------------------------------------
    def _load_square_cached(self, index: int):
        """(square S x S RGB image, (h0, w0), labels) for the simple
        pipeline's device-geometry path: the square resize ships, and the
        crop rect is drawn in original (h0, w0) coordinates."""
        if self._cache is not None and index in self._cache:
            return self._cache[index]
        path = self.imgs[index]
        im = cv2.imread(path)
        if im is None:
            raise FileNotFoundError(f"image not found: {path}")
        im = cv2.cvtColor(im, cv2.COLOR_BGR2RGB)
        h0, w0 = im.shape[:2]
        size = self.input_size
        im = cv2.resize(im, (size, size), interpolation=cv2.INTER_LINEAR)
        entry = (im, (h0, w0), read_yolo_labels(label_path_for(path)))
        if self._cache is not None:
            self._cache[index] = entry
        return entry

    def _simple_sample(self, index: int, rng: np.random.Generator):
        size = self.input_size
        if self.augment and self.device_geom:
            # resize, then crop on the device: the square-resized image
            # ships and the RandomResizedCrop rect becomes an anisotropic
            # separable warp. Same draws and box math as
            # random_resized_crop (in original coordinates), so labels
            # equal the host path's; pixels pay one more interpolation.
            im, (h0, w0), labels = self._load_square_cached(index)
            boxes = np.zeros((len(labels), 5), np.float32)
            if len(labels):
                boxes[:, :4] = labels[:, 1:5]
                boxes[:, 4] = labels[:, 0]
            x0, y0, cw, ch = A.draw_rrc_params(h0, w0, rng)
            boxes = A.rrc_boxes(boxes, x0, y0, cw, ch, h0, w0)
            geom = np.array([w0 / cw, h0 / ch,
                             -x0 * size / cw, -y0 * size / ch], np.float32)
            return self._finalize(im), boxes, geom

        path = self.imgs[index]
        im = cv2.imread(path)
        if im is None:
            raise FileNotFoundError(f"image not found: {path}")
        im = cv2.cvtColor(im, cv2.COLOR_BGR2RGB)

        labels = read_yolo_labels(label_path_for(path))
        boxes = np.zeros((len(labels), 5), np.float32)
        if len(labels):
            boxes[:, :4] = labels[:, 1:5]
            boxes[:, 4] = labels[:, 0]

        if self.augment:
            if self.photometric:
                if rng.random() < 0.5:
                    im, boxes = A.hflip(im, boxes)
                if rng.random() < 0.5:
                    im = A.clahe(im)
                if rng.random() < 0.5:
                    im = A.color_jitter(im, rng)
            im, boxes = A.random_resized_crop(im, boxes, rng, size)
        else:
            im = cv2.resize(im, (size, size), interpolation=cv2.INTER_LINEAR)

        im = self._finalize(im)
        if self.device_geom:
            return im, boxes, IDENTITY_GEOM
        return im, boxes


def build_datasets(cfg: dict):
    """(train_ds, val_ds) with the reference's model->pipeline wiring:
    yolov3 (and full yolov4, which follows the v3 recipe) uses the letterbox
    pipeline, v1/v2/v4-tiny the simple one."""
    pipeline = cfg.get(
        "pipeline",
        "letterbox" if cfg["model"] in ("yolov3", "yolov4") else "simple"
    )
    cache = bool(cfg.get("cache_images", False))
    u8 = bool(cfg.get("uint8_batches", True))
    photometric = not bool(cfg.get("device_augment", False))
    device_geom = bool(cfg.get("device_geom", False))
    if device_geom and photometric:
        raise ValueError("device_geom: true requires device_augment: true")
    train = YoloTxtDataset(cfg["train_list"], cfg["input_size"], True,
                           pipeline, mosaic=float(cfg.get("mosaic", 0.0)),
                           copy_paste=float(cfg.get("copy_paste", 0.0)),
                           cache_images=cache, output_uint8=u8,
                           photometric=photometric, device_geom=device_geom,
                           pixel_ops=bool(cfg.get("pixel_ops", True)))
    val = YoloTxtDataset(cfg["val_list"], cfg["input_size"], False, pipeline,
                         cache_images=cache, output_uint8=u8)
    return train, val
