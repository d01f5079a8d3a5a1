"""Batch augmentation on the batch's device (``podtpu/data/device_aug.py``).

The host pipeline (cv2) keeps decode and the geometry that needs per-image
shapes (letterbox, mosaic). With cfg ``device_augment`` the photometric
jitter and the horizontal flip run here, on the card, right before the
train step; with ``device_geom`` the letterbox pipeline's random affine
(scale + translate) and the simple pipeline's resized crop run here as a
separable bilinear warp (:func:`separable_affine`).

The augmentation is split in two:

* :func:`draw_augment`: per-image gains [B, 3] and flips [B] from a
  ``torch.Generator`` on the batch's device (``podtpu`` draws from
  threefry; the law is the same, the values differ);
* :func:`apply_augment`: a pure function of (images, annots, gains, flips),
  which ``podtpu``'s own draws can be handed to.

``device_hsv: exact`` is cv2's 8u HSV math with its 12-bit division tables
(bit for bit ``podtpu``'s); ``approx`` (the default) is a float RGB-space
approximation with the same gain ranges. Nothing here leaves the device:
the tables are cached on it and the draws are made on it.
"""

from __future__ import annotations

import torch

# the gains' half-ranges (h, s, v) and the flip probability: podtpu's
# make_device_augment, the reference's augment_hsv defaults
HSV_GAINS = (0.015, 0.7, 0.4)
FLIP_P = 0.5
# cv2's BORDER_CONSTANT gray (114) of the letterbox and the affine warp
FILL = 114.0 / 255.0


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] in [0, 1] -> HSV with H in [0, 1)."""
    r, g, b = rgb.unbind(-1)
    maxc = rgb.amax(-1)
    minc = rgb.amin(-1)
    v = maxc
    delta = maxc - minc
    zero = rgb.new_zeros(())
    s = torch.where(maxc > 0, delta / maxc.clamp_min(1e-12), zero)
    safe = delta.clamp_min(1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), zero)
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)
    # jnp.select's cases in order; the sector is always one of them
    cases = [i == k for k in range(6)]

    def select(values):
        out = values[-1]
        for cond, val in zip(cases[-2::-1], values[-2::-1]):
            out = torch.where(cond, val, out)
        return out

    return torch.stack([select([v, q, p, p, t, v]),
                        select([t, v, v, q, p, p]),
                        select([p, p, t, v, v, q])], dim=-1)


# ---------------------------------------------------------------------------
# cv2-exact uint8 HSV math (cv2.cvtColor BGR2HSV / HSV2BGR on 8-bit images:
# fixed point with 12-bit division tables). cfg ``device_hsv: exact``.
# ---------------------------------------------------------------------------

_HSV_SHIFT = 12
_TABLES: dict = {}  # device -> (sdiv, hdiv, sector_data)


def _hsv_div_tables(device: torch.device):
    """cv2's 8u division tables (and HSV2BGR's per-sector (b, g, r) picks)
    as int tensors on ``device``, made once a device."""
    device = torch.device(device)
    if device not in _TABLES:
        i = torch.arange(256, dtype=torch.float64)
        sdiv = torch.zeros(256, dtype=torch.int32)
        hdiv = torch.zeros(256, dtype=torch.int32)
        sdiv[1:] = torch.round((255 << _HSV_SHIFT) / i[1:]).to(torch.int32)
        hdiv[1:] = torch.round((180 << _HSV_SHIFT) / (6.0 * i[1:])) \
            .to(torch.int32)
        # OpenCV's sector_data: tab indices of (b, g, r) per hue sector
        sector_data = torch.tensor([[1, 3, 0], [1, 0, 2], [3, 0, 1],
                                    [0, 2, 1], [0, 1, 3], [2, 1, 0]])
        _TABLES[device] = tuple(t.to(device) for t in
                                (sdiv, hdiv, sector_data))
    return _TABLES[device]


def bgr_hsv_u8(rgb_u8: torch.Tensor):
    """[..., 3] RGB uint8 -> (h, s, v) int32, cv2 ``COLOR_BGR2HSV`` 8u math
    (h in [0, 180)). The BGR convention matches the host pipeline, which
    jitters before its final BGR->RGB conversion."""
    x = rgb_u8.to(torch.int32)
    r, g, b = x.unbind(-1)
    v = torch.maximum(torch.maximum(b, g), r)
    vmin = torch.minimum(torch.minimum(b, g), r)
    diff = v - vmin
    sdiv, hdiv, _ = _hsv_div_tables(rgb_u8.device)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * sdiv[v.long()] + half) >> _HSV_SHIFT
    h_raw = torch.where(v == r, g - b,
                        torch.where(v == g, b - r + 2 * diff,
                                    r - g + 4 * diff))
    # an arithmetic shift of the (possibly negative) int32 product, as jnp's
    h = (h_raw * hdiv[diff.long()] + half) >> _HSV_SHIFT
    return torch.where(h < 0, h + 180, h), s, v


def hsv_bgr_u8(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor
               ) -> torch.Tensor:
    """(h [0, 180), s, v uint8-ranged ints) -> [..., 3] RGB uint8, cv2
    ``COLOR_HSV2BGR`` 8u math: s and v normalised by ``* (1/255)``, the
    float sector kernel, ``* 255`` and truncation; each float32 operation
    in ``podtpu``'s order, so the bytes are its bytes."""
    r255 = 1.0 / 255.0
    hf = h.to(torch.float32) * (6.0 / 180.0)
    sf = s.to(torch.float32) * r255
    vf = v.to(torch.float32) * r255
    sector = torch.floor(hf).to(torch.int32).clamp(0, 5)
    frac = hf - sector.to(torch.float32)
    tab = torch.stack([vf, vf * (1.0 - sf), vf * (1.0 - sf * frac),
                       vf * (1.0 - sf * (1.0 - frac))], dim=-1)
    _, _, sector_data = _hsv_div_tables(h.device)
    idx = sector_data[sector.long()]                   # [..., 3] b, g, r
    bgr = torch.gather(tab, -1, idx)
    rgb = bgr.flip(-1)
    return torch.trunc(rgb * 255.0).clamp(0, 255).to(torch.uint8)


def exact_hsv_jitter_u8(rgb_u8: torch.Tensor, gains: torch.Tensor
                        ) -> torch.Tensor:
    """The reference's LUT jitter on cv2 8u HSV: per-image ``gains``
    [B, 3] multiply (h % 180, clip s, clip v) with truncation."""
    h, s, v = bgr_hsv_u8(rgb_u8)
    gh = gains[:, 0, None, None]
    gs = gains[:, 1, None, None]
    gv = gains[:, 2, None, None]
    h2 = torch.floor(torch.remainder(h.to(torch.float32) * gh, 180.0))
    s2 = torch.floor((s.to(torch.float32) * gs).clamp(0.0, 255.0))
    v2 = torch.floor((v.to(torch.float32) * gv).clamp(0.0, 255.0))
    return hsv_bgr_u8(h2.to(torch.int32), s2.to(torch.int32),
                      v2.to(torch.int32))


def draw_augment(batch: int, generator: torch.Generator):
    """(gains [B, 3] float32, flips [B] bool) on the generator's device:
    each gain uniform in [1 - g, 1 + g] for g in ``HSV_GAINS`` (h, s, v),
    each flip with probability ``FLIP_P``."""
    device = generator.device
    u = torch.rand((batch, 3), generator=generator, device=device) * 2.0 - 1.0
    flips = torch.rand((batch,), generator=generator, device=device) < FLIP_P
    # a gain a column: a host tensor of the half-ranges would be a copy
    return torch.stack([1.0 + u[:, k] * g for k, g in enumerate(HSV_GAINS)],
                       dim=1), flips


def apply_augment(images: torch.Tensor, annots: torch.Tensor,
                  gains: torch.Tensor, flips: torch.Tensor,
                  hsv: str = "approx"):
    """Per-image HSV jitter and horizontal flip with the given draws.

    images: [B, H, W, 3] uint8, or float32 in [0, 1]; annots: [B, T, 5]
    normalized (cx flips with the image; padding rows stay untouched).
    ``hsv='exact'`` runs the cv2 8u math on the images re-quantized to
    uint8 (a uint8 batch goes in as it is: ``round(u8 / 255 * 255)`` is
    ``u8`` for every byte); ``'approx'`` the float RGB-space approximation.
    Returns (images float32 in [0, 1], annots)."""
    if hsv == "exact":
        u8 = images if images.dtype == torch.uint8 else \
            torch.round(images * 255.0).clamp(0, 255).to(torch.uint8)
        # a true division on every device: CUDA divides by a host scalar
        # as a multiply by its reciprocal, which moves some results an ulp
        out = exact_hsv_jitter_u8(u8, gains).to(torch.float32)
        images = out / out.new_full((), 255.0)
    elif hsv == "approx":
        if images.dtype == torch.uint8:
            images = images.float() / 255.0
        hsv_img = rgb_to_hsv(images)
        g = gains[:, None, None, :]
        h = torch.remainder(hsv_img[..., 0] * g[..., 0], 1.0)
        s = (hsv_img[..., 1] * g[..., 1]).clamp(0.0, 1.0)
        v = (hsv_img[..., 2] * g[..., 2]).clamp(0.0, 1.0)
        images = hsv_to_rgb(torch.stack([h, s, v], dim=-1))
    else:
        raise ValueError(f"device_hsv must be 'exact' or 'approx', not "
                         f"{hsv!r}")
    images = torch.where(flips[:, None, None, None], images.flip(2), images)
    cx = annots[..., 0]
    valid = annots.sum(-1) > 0
    new_cx = torch.where(flips[:, None] & valid, 1.0 - cx, cx)
    annots = torch.cat([new_cx[..., None], annots[..., 1:]], dim=-1)
    return images, annots


def separable_affine(images: torch.Tensor, geom: torch.Tensor
                     ) -> torch.Tensor:
    """Batched scale + translate bilinear warp as two batched products.

    The letterbox recipe's random affine has no rotation and no shear, so
    the warp is separable: ``out[y, x] = sum_h sum_w Wy[y, h] Wx[x, w]
    im[h, w]`` with per-sample interpolation matrices from three scalars.

    images: [B, H, W, C] float in [0, 1] (letterboxed, un-warped).
    geom:   [B, 4] rows ``(sx, sy, bx, by)`` of the forward map
            ``dst = (sx*x + bx, sy*y + by)``; identity rows ``(1, 1, 0, 0)``
            pass through exactly.
    Out-of-image taps blend with the gray ``FILL``, as
    ``cv2.warpAffine(borderValue=114)`` does (float-exact coordinates).
    The products run in float32: TF32 would round the images to 10 bits.
    """
    b, h, w, _ = images.shape
    dev = images.device
    cols = torch.arange(w, dtype=torch.float32, device=dev)
    rows = torch.arange(h, dtype=torch.float32, device=dev)
    # inverse map: src = (dst - t) / s, per axis
    src_x = (cols[None, :] - geom[:, 2:3]) / geom[:, 0:1]
    src_y = (rows[None, :] - geom[:, 3:4]) / geom[:, 1:2]
    # bilinear weight matrices [B, out, in]: a hat function around src
    wx = (1.0 - (src_x[:, :, None] - cols).abs()).clamp(0.0, 1.0)
    wy = (1.0 - (src_y[:, :, None] - rows).abs()).clamp(0.0, 1.0)
    tmp = torch.einsum("boh,bhwc->bowc", wy, images)    # contract src rows
    out = torch.einsum("bxw,bowc->boxc", wx, tmp)       # contract src cols
    # taps outside the source blend with the border fill: the total weight
    # at (y, x) is rowsum(wy)[y] * rowsum(wx)[x]
    cover = wy.sum(-1)[:, :, None] * wx.sum(-1)[:, None, :]
    return out + (1.0 - cover)[..., None] * FILL


def make_device_augment(cfg: dict):
    """Config -> ``fn(images, annots, generator, rows=None) -> (images,
    annots)``, or None when cfg ``device_augment`` is off."""
    if not cfg.get("device_augment", False):
        return None
    hsv = str(cfg.get("device_hsv", "approx"))
    if hsv not in ("exact", "approx"):
        raise ValueError(f"device_hsv must be 'exact' or 'approx', not "
                         f"{hsv!r}")

    def augment(images, annots, generator, rows=None):
        # rows: (the global batch, this rank's rows of it or None), from
        # parallel/mesh.py::global_rows: under data parallelism the draws
        # are the global batch's, as one process running it whole draws
        n, part = rows or (images.shape[0], None)
        gains, flips = draw_augment(n, generator)
        if part is not None:
            gains, flips = gains[part], flips[part]
        return apply_augment(images, annots, gains, flips, hsv)

    return augment
