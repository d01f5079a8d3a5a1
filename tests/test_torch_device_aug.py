"""The port's device augmentation against podtpu's (CPU): the cv2 8u HSV
math bit for bit, the approximate HSV path and the separable warp, the
apply on podtpu's own draws, the port's draw law, the datasets and loader
with ``photometric=False`` / ``device_geom``, the train step, the stats
step and the K-step group with a ``geom`` batch, and a 1-epoch run of a
64 px copy of ``configs/yolov4_synth.yaml``."""

import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from podtpu.data import device_aug as J
from podtpu.data.dataset import YoloTxtDataset as JDataset
from podtpu.data.dataset import build_datasets as podtpu_build_datasets
from podtpu.data.loader import Loader as JLoader
from podtpu.train.state import create_train_state as podtpu_create_state
from podtpu.train.steps import make_train_step as podtpu_make_train_step
from podtpu_torch.config import get_configs
from podtpu_torch.data import device_aug as T
from podtpu_torch.data.dataset import YoloTxtDataset, build_datasets
from podtpu_torch.data.loader import Loader, pad_annotations
from podtpu_torch.data.synthetic import generate
from podtpu_torch.export.weights import flat_from_state_dict
from podtpu_torch.train.state import create_train_state
from podtpu_torch.train.steps import (
    augment_seed,
    make_multi_train_step,
    make_stats_step,
    make_train_step,
)
from tests.torch_parity import (
    SEP,
    flax_variables,
    image_batch,
    podtpu_flat_weights,
    yolo_cfg,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAINS = (0.015, 0.7, 0.4)


@functools.partial(jax.jit, static_argnums=1)
def podtpu_draws(rng, b):
    """podtpu's device_augment draws from ``rng``, in its own expressions:
    (gains [B, 3], flips [B])."""
    k_h, k_s, k_v, k_f = jax.random.split(rng, 4)
    gains = [1.0 + jax.random.uniform(k, (b, 1, 1), minval=-1.0,
                                      maxval=1.0) * g
             for k, g in zip((k_h, k_s, k_v), GAINS)]
    flips = jax.random.uniform(k_f, (b,)) < 0.5
    return jnp.concatenate([g[:, :, 0] for g in gains], axis=1), flips


def _images(b=3, size=32, seed=0):
    r = np.random.default_rng(seed)
    im = r.integers(0, 256, (b, size, size, 3), dtype=np.uint8)
    im[:, :4] = r.integers(0, 256, (b, 1, 1, 3), dtype=np.uint8)  # flat
    im[:, 4:6, :, :] = 255                                        # white
    return im


def _annots(b=3, seed=1):
    r = np.random.default_rng(seed)
    boxes = [np.concatenate([r.uniform(0.1, 0.9, (n, 4)),
                             r.integers(0, 4, (n, 1))], 1).astype(np.float32)
             for n in (2, 0, 4)[:b]]
    return pad_annotations(boxes, 6)


# ---- cv2's 8u HSV math, bit for bit ----------------------------------------

def test_hsv_bgr_u8_full_grid_bit_identical():
    """Every (h, s, v) of cv2's 8u HSV space, a hue band at a time."""
    s, v = np.meshgrid(np.arange(256, dtype=np.int32),
                       np.arange(256, dtype=np.int32), indexing="ij")
    s, v = s.ravel(), v.ravel()
    for h0 in range(0, 180, 30):
        h = np.repeat(np.arange(h0, h0 + 30, dtype=np.int32), s.size)
        ss, vv = np.tile(s, 30), np.tile(v, 30)
        want = np.asarray(J.hsv_bgr_u8(jnp.asarray(h), jnp.asarray(ss),
                                       jnp.asarray(vv)))
        got = T.hsv_bgr_u8(torch.from_numpy(h), torch.from_numpy(ss),
                           torch.from_numpy(vv))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)


def test_bgr_hsv_u8_bit_identical_with_negative_raw_hue():
    r = np.random.default_rng(2)
    grid = np.stack(np.meshgrid(*[np.arange(0, 256, 5)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)
    rgb = np.concatenate([grid, _images().reshape(-1, 3),
                          r.integers(0, 256, (4096, 3))]).astype(np.uint8)
    x = rgb.astype(np.int32)
    # the raw hue g - b of a red maximum is negative where b > g: the
    # shift must be arithmetic in both packages
    v = x.max(-1)
    assert ((v == x[:, 0]) & (x[:, 1] < x[:, 2])).sum() > 1000
    want = J.bgr_hsv_u8(jnp.asarray(rgb))
    got = T.bgr_hsv_u8(torch.from_numpy(rgb))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_exact_hsv_jitter_bit_identical():
    im = _images(4)
    gains = (1.0 + np.random.default_rng(3).uniform(-1, 1, (4, 3))
             * np.array(GAINS)).astype(np.float32)
    gains[0] = (1.015, 1.7, 1.4)  # hue past 180 wraps; s and v clip
    gains[1] = (0.985, 0.3, 0.6)
    want = np.asarray(J.exact_hsv_jitter_u8(jnp.asarray(im),
                                            jnp.asarray(gains)))
    got = T.exact_hsv_jitter_u8(torch.from_numpy(im),
                                torch.from_numpy(gains))
    np.testing.assert_array_equal(got.numpy(), want)


def test_uint8_batch_enters_the_exact_path_as_podtpu_requantizes_it():
    """podtpu's exact path takes ``round(img * 255)`` of ``u8 / 255``; the
    port takes a uint8 batch as it is: the same bytes for all 256."""
    u8 = torch.arange(256, dtype=torch.uint8)
    back = torch.round(u8.float() / 255.0 * 255.0).clamp(0, 255)
    assert torch.equal(back.to(torch.uint8), u8)
    jax_back = jnp.clip(jnp.round(jnp.arange(256, dtype=jnp.uint8).astype(
        jnp.float32) / 255.0 * 255.0), 0, 255).astype(jnp.uint8)
    np.testing.assert_array_equal(np.asarray(jax_back), u8.numpy())


# ---- the approximate path and the warp ---------------------------------------

def test_approx_hsv_matches_podtpu():
    rgb = _images(2).astype(np.float32) / 255.0
    rgb[0, 10:12] = 0.0  # black: no hue, no saturation
    want = np.asarray(J.rgb_to_hsv(jnp.asarray(rgb)))
    got = T.rgb_to_hsv(torch.from_numpy(rgb)).numpy()
    assert np.abs(got - want).max() <= 1e-6
    back = T.hsv_to_rgb(torch.from_numpy(want.copy())).numpy()
    assert np.abs(back - np.asarray(J.hsv_to_rgb(jnp.asarray(want)))).max() \
        <= 1e-6


def test_separable_affine_matches_podtpu_and_identity_is_exact():
    img = _images(4, 48).astype(np.float32) / 255.0
    geom = np.array([[1.0, 1.0, 0.0, 0.0],          # identity
                     [1.3, 1.3, -7.5, -3.25],        # letterbox zoom
                     [0.6, 0.6, 11.0, 9.0],          # shrink, gray border
                     [1.8, 0.7, -20.0, 4.0]],        # anisotropic crop
                    np.float32)
    want = np.asarray(J.separable_affine(jnp.asarray(img), jnp.asarray(geom)))
    got = T.separable_affine(torch.from_numpy(img), torch.from_numpy(geom))
    assert got.shape == img.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5
    np.testing.assert_array_equal(got[0].numpy(), img[0])
    # the shrunk image's border is the fill
    assert np.allclose(got[2, 0, 0].numpy(), 114.0 / 255.0)


# ---- the apply with podtpu's own draws ----------------------------------------

def _podtpu_eager_augment(x, annot, geom, key, hsv="exact"):
    """podtpu's device_geom + device_augment lines, op by op with podtpu's
    own functions and its draws from ``key``: the warp (``geom`` not None),
    the jitter (the exact path re-quantizes), the flip of images and
    boxes. (Inside a jitted step XLA rewrites some of the 8u float math,
    which moves a share of the bytes by one; op by op is the arithmetic
    the reference's cv2 path was matched with.)"""
    img = jnp.asarray(x)
    if geom is not None:
        img = J.separable_affine(img, jnp.asarray(geom))
    gains, flips = podtpu_draws(key, x.shape[0])
    if hsv == "exact":
        u8 = jnp.clip(jnp.round(img * 255.0), 0, 255).astype(jnp.uint8)
        img = J.exact_hsv_jitter_u8(u8, gains).astype(jnp.float32) / 255.0
    else:
        g = gains[:, None, None, :]
        hsv_img = J.rgb_to_hsv(img)
        img = J.hsv_to_rgb(jnp.stack(
            [(hsv_img[..., 0] * g[..., 0]) % 1.0,
             jnp.clip(hsv_img[..., 1] * g[..., 1], 0.0, 1.0),
             jnp.clip(hsv_img[..., 2] * g[..., 2], 0.0, 1.0)], axis=-1))
    img = jnp.where(flips[:, None, None, None], img[:, :, ::-1, :], img)
    annot = jnp.asarray(annot)
    valid = jnp.sum(annot, axis=-1) > 0
    cx = jnp.where(flips[:, None] & valid, 1.0 - annot[..., 0],
                   annot[..., 0])
    return (np.asarray(img), np.asarray(annot.at[..., 0].set(cx)),
            (gains, flips))


@pytest.mark.parametrize("hsv", ["exact", "approx"])
def test_apply_with_podtpu_draws_matches_device_augment(hsv):
    """The port's apply on podtpu's draws against podtpu's augmentation:
    op by op, the exact path bit for bit and the approximate one to 1e-6;
    against podtpu's jitted ``device_augment`` (XLA rewrites the 8u float
    math there: ``(v * (1/255)) * 255`` and the multiply-subtracts of the
    sector table, so truncation lands one lower or higher on a share of
    the bytes) to one byte. Boxes bit for bit, padding untouched."""
    im, annots = _images(3), _annots(3)
    x = im.astype(np.float32) / 255.0
    key = jax.random.PRNGKey(0)
    want_im, want_an, (gains, flips) = _podtpu_eager_augment(
        x, annots, None, key, hsv)
    assert 0 < int(flips.sum()) < 3  # both branches of the flip
    src = torch.from_numpy(im) if hsv == "exact" else torch.from_numpy(x)
    got_im, got_an = T.apply_augment(
        src, torch.from_numpy(annots), torch.from_numpy(np.asarray(gains)),
        torch.from_numpy(np.asarray(flips)), hsv)
    assert got_im.dtype == torch.float32
    if hsv == "exact":
        np.testing.assert_array_equal(got_im.numpy(), want_im)
    else:
        assert np.abs(got_im.numpy() - want_im).max() <= 1e-6
    np.testing.assert_array_equal(got_an.numpy(), want_an)
    pad = annots[..., 0] == -1
    np.testing.assert_array_equal(got_an.numpy()[pad], annots[pad])
    jit_im, jit_an = J.device_augment(key, jnp.asarray(x),
                                      jnp.asarray(annots), hsv=hsv)
    tol = 1.0 / 255.0 + 1e-6 if hsv == "exact" else 1e-6
    assert np.abs(got_im.numpy() - np.asarray(jit_im)).max() <= tol
    np.testing.assert_array_equal(got_an.numpy(), np.asarray(jit_an))


def test_draw_law_and_its_seeding():
    g = torch.Generator().manual_seed(augment_seed(0, 5))
    gains, flips = T.draw_augment(20000, g)
    assert gains.shape == (20000, 3) and flips.dtype == torch.bool
    for k, half in enumerate(GAINS):
        col = gains[:, k]
        assert col.min() >= 1 - half and col.max() <= 1 + half
        assert abs(float(col.mean()) - 1.0) <= 0.05 * half
    # a binomial(20000, 0.5) share: 5 sigma is 0.0177
    assert abs(float(flips.float().mean()) - 0.5) <= 5 * (0.25 / 20000) ** 0.5
    again = T.draw_augment(20000, torch.Generator().manual_seed(
        augment_seed(0, 5)))
    assert torch.equal(again[0], gains) and torch.equal(again[1], flips)
    other = T.draw_augment(20000, torch.Generator().manual_seed(
        augment_seed(0, 6)))
    assert not torch.equal(other[0], gains)
    assert augment_seed(0, 5) != augment_seed(1, 5)
    assert augment_seed(0, 5) != (0 << 32) + 5  # not the dropout's stream


def test_make_device_augment_reads_the_config():
    assert T.make_device_augment({}) is None
    with pytest.raises(ValueError, match="device_hsv"):
        T.make_device_augment({"device_augment": True, "device_hsv": "hsl"})
    aug = T.make_device_augment({"device_augment": True,
                                 "device_hsv": "exact"})
    im, annots = _images(3), _annots(3)
    out = aug(torch.from_numpy(im), torch.from_numpy(annots),
              torch.Generator().manual_seed(1))
    gains, flips = T.draw_augment(3, torch.Generator().manual_seed(1))
    want = T.apply_augment(torch.from_numpy(im), torch.from_numpy(annots),
                           gains, flips, "exact")
    for a, b in zip(out, want):
        assert torch.equal(a, b)


# ---- datasets and loader -----------------------------------------------------

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    out = tmp_path_factory.mktemp("synth")
    return generate(str(out), n_train=8, n_val=4, size=96, num_classes=4,
                    max_objects=4, seed=2)


DATASET_CASES = {
    "letterbox_no_photometric": dict(photometric=False),
    "letterbox_geom": dict(photometric=False, device_geom=True),
    "mosaic_geom": dict(photometric=False, device_geom=True, mosaic=1.0),
    "mosaic_no_photometric": dict(photometric=False, mosaic=1.0),
    "simple_no_photometric": dict(pipeline="simple", photometric=False),
    "simple_geom": dict(pipeline="simple", photometric=False,
                        device_geom=True, cache_images=True),
}


@pytest.mark.parametrize("case", sorted(DATASET_CASES))
def test_dataset_samples_bit_identical(synth, case):
    kw = DATASET_CASES[case]
    got_ds = YoloTxtDataset(synth["train_list"], 64, True, output_uint8=True,
                            **kw)
    want_ds = JDataset(synth["train_list"], 64, True, output_uint8=True, **kw)
    n_geom = 0
    for i in range(len(got_ds)):
        got, want = got_ds.get(i, 31 * i + 5), want_ds.get(i, 31 * i + 5)
        assert len(got) == len(want) == (3 if kw.get("device_geom") else 2)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        if len(got) == 3:
            n_geom += not np.array_equal(got[2], [1, 1, 0, 0])
    if kw.get("device_geom"):
        # mosaic is warped on the host: identity rows only
        assert (n_geom == 0) == bool(kw.get("mosaic"))


def test_build_datasets_and_loader_carry_geom(synth):
    cfg = dict(model="yolov3", input_size=64, train_list=synth["train_list"],
               val_list=synth["val_list"], device_augment=True,
               device_geom=True)
    (got_tr, got_va), (want_tr, want_va) = (build_datasets(cfg),
                                            podtpu_build_datasets(cfg))
    assert (got_tr.photometric, got_tr.device_geom) == (False, True)
    assert (got_va.photometric, got_va.device_geom) == (True, False)
    kw = dict(batch_size=3, shuffle=True, max_annots=6, workers=2, seed=4)
    got_l, want_l = Loader(got_tr, **kw), JLoader(want_tr, **kw)
    for got, want in zip(list(got_l), list(want_l)):
        assert set(got) == set(want) == {"img", "annot", "n_valid", "geom"}
        for k in ("img", "annot", "geom"):
            np.testing.assert_array_equal(got[k], want[k])
        assert got["geom"].shape == (3, 4)
    val = next(iter(Loader(got_va, batch_size=2, shuffle=False)))
    assert "geom" not in val
    for build in (build_datasets, podtpu_build_datasets):
        with pytest.raises(ValueError, match="device_augment"):
            build(dict(cfg, device_augment=False))


# ---- the steps ---------------------------------------------------------------

def _step_cfg(**extra):
    return yolo_cfg("float32", 64, optimizer="sgd",
                    optimizer_options={"lr": 1e-3, "momentum": 0.9,
                                       "weight_decay": 1e-2,
                                       "nesterov": True},
                    scheduler=None, max_annots=8, device_augment=True,
                    device_geom=True, **extra)


GEOM = np.array([[1.2, 1.2, -5.0, -3.0], [0.8, 0.8, 6.0, 4.5]], np.float32)


def _step_batch(cfg):
    r = np.random.default_rng(9)
    boxes = [np.asarray([[*r.uniform(0.2, 0.8, 2), *r.uniform(0.1, 0.6, 2),
                          r.integers(0, 20)] for _ in range(5)], np.float32)
             for _ in range(2)]
    return image_batch(cfg, batch=2, seed=9), pad_annotations(boxes, 8)


def _jax_flat(jstate):
    out = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                getattr(jstate, coll))[0]:
            out[SEP.join([coll] + [str(p.key) for p in path])] = \
                np.asarray(leaf)
    return out


def _update(after, before):
    return np.concatenate([(after[k] - before[k]).ravel()
                           for k in sorted(before) if k.startswith("params")])


def test_train_step_with_device_augment_and_geom_matches_podtpu(monkeypatch):
    """One step of YOLOv3 at 64 px, float32, with ``device_geom`` and
    ``device_augment`` (exact): the port's model sees, bit for bit, the
    batch podtpu's warp and jitter make from podtpu's draws for step 0
    (``fold_in(fold_in(rng, 0), 1)``, handed to the port's apply), and its
    update is held against podtpu's step on that batch. The update at
    random weights is ill-conditioned (tests/test_torch_train.py): a 1e-7
    relative nudge of the batch moves podtpu's own update; the port is
    held to 8x that witness, the loss to 1e-4 and the BN statistics to
    1e-4 beyond 8x their witness."""
    cfg = _step_cfg(device_hsv="exact")
    flat = podtpu_flat_weights(cfg, seed=3)
    img, annot = _step_batch(cfg)
    rng = jax.random.PRNGKey(1)
    x_aug, annot_aug, (gains, flips) = _podtpu_eager_augment(
        img.astype(np.float32) / 255.0, annot, GEOM,
        jax.random.fold_in(jax.random.fold_in(rng, 0), 1))
    assert not np.array_equal(annot_aug, annot)  # a flip moved boxes
    plain = dict(cfg, device_augment=False, device_geom=False)
    jstep = podtpu_make_train_step(plain, donate=False)
    variables = flax_variables(flat)
    base = podtpu_create_state(plain, jax.random.PRNGKey(0)).replace(
        params=variables["params"], batch_stats=variables["batch_stats"])
    nudge = np.random.default_rng(1).standard_normal(x_aug.shape) * 1e-7
    want = []
    for xi in (x_aug, (x_aug * (1 + nudge)).astype(np.float32)):
        jstate, m = jstep(base, {"img": jnp.asarray(xi),
                                 "annot": jnp.asarray(annot_aug)}, rng)
        want.append((float(m["loss"]), _jax_flat(jstate)))
    (want_loss, want), (_, nudged) = want

    draws = (torch.from_numpy(np.asarray(gains)),
             torch.from_numpy(np.asarray(flips)))
    monkeypatch.setattr(T, "draw_augment", lambda b, g: draws)
    state = create_train_state(cfg, "cpu", weights=flat)
    seen = []
    state.model.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].detach().clone()))
    state, m = make_train_step(cfg)(state, {
        "img": torch.from_numpy(img), "annot": torch.from_numpy(annot),
        "geom": torch.from_numpy(GEOM)})
    np.testing.assert_array_equal(seen[0].numpy(), x_aug)
    got = flat_from_state_dict(state.model)
    assert float(m["loss"]) == pytest.approx(want_loss, rel=1e-4)
    for k in want:
        if k.startswith("batch_stats"):
            w = float(np.abs(nudged[k] - want[k]).max())
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-4 + 8.0 * w, err_msg=k)
    up_j = _update(want, flat)
    witness = np.linalg.norm(_update(nudged, flat) - up_j)
    assert 0 < witness <= 0.05 * np.linalg.norm(up_j)
    assert np.linalg.norm(_update(got, flat) - up_j) <= 8.0 * witness


def test_stats_step_warps_the_batch():
    cfg = _step_cfg()
    flat = podtpu_flat_weights(cfg, seed=3)
    img, annot = _step_batch(cfg)
    state = create_train_state(cfg, "cpu", weights=flat)
    batch = {"img": torch.from_numpy(img), "annot": torch.from_numpy(annot),
             "geom": torch.from_numpy(GEOM)}
    got = make_stats_step(cfg)(state, batch)
    warped = T.separable_affine(batch["img"].float() / 255.0, batch["geom"])
    plain = dict(cfg, device_geom=False)
    want = make_stats_step(plain)(state, {"img": warped, "annot": batch[
        "annot"]})
    unwarped = make_stats_step(plain)(state, batch)
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert any(not torch.equal(got[k], unwarped[k]) for k in got)


def test_multi_train_step_with_geom_equals_single_steps():
    """K=2 steps with the exact jitter and the warp in one group against
    two single steps: the draws follow the step, so the same bits."""
    cfg = _step_cfg(device_hsv="exact")
    flat = podtpu_flat_weights(cfg, seed=4)
    img, annot = _step_batch(cfg)
    imgs = np.stack([img, img[::-1]])
    annots = np.stack([annot, annot[::-1]])
    geoms = np.stack([GEOM, GEOM[::-1]])
    singles = create_train_state(cfg, "cpu", weights=flat)
    step = make_train_step(cfg)
    losses = []
    for i in range(2):
        singles, m = step(singles, {"img": torch.from_numpy(imgs[i]),
                                    "annot": torch.from_numpy(annots[i]),
                                    "geom": torch.from_numpy(geoms[i])})
        losses.append(m["loss"])
    group = create_train_state(cfg, "cpu", weights=flat)
    group, m = make_multi_train_step(cfg)(group, {
        "img": torch.from_numpy(imgs), "annot": torch.from_numpy(annots),
        "geom": torch.from_numpy(geoms)})
    assert torch.equal(m["loss"], torch.stack(losses))
    assert group.step == singles.step == 2
    g, s = group.model.state_dict(), singles.model.state_dict()
    for k in g:
        assert torch.equal(g[k], s[k]), k


def test_yolov4_synth_config_trains_and_scores(tmp_path):
    """configs/yolov4_synth.yaml as shipped (device_augment on), with its
    lists pointing at a synthetic set, 64 px, float32, B=4 and 1 epoch
    validated: train.run, then cli.test on ``last`` scores it as fit's
    validation did."""
    from podtpu_torch.cli import test as test_cli
    from podtpu_torch.train import run

    cfg = get_configs(os.path.join(REPO, "configs", "yolov4_synth.yaml"))
    assert cfg["device_augment"] and cfg["num_classes"] == 4
    data = generate(str(tmp_path / "data"), n_train=4, n_val=4, size=96,
                    num_classes=4, max_objects=4, seed=3)
    cfg.update(train_list=data["train_list"], val_list=data["val_list"],
               names=data["names"], input_size=64,
               compute_dtype="float32", batch_size=4, workers=2, epochs=1,
               save_dir=str(tmp_path / "runs"),
               trainer_options={"check_val_every_n_epoch": 1})
    try:
        trainer = run.train(cfg, device="cpu")
        row = trainer.history[-1]
        assert row["step"] == 1 and np.isfinite(row["train_loss"])
        last = os.path.join(trainer.run_dir, "checkpoints", "last")
        scored = test_cli.evaluate(cfg, last, device="cpu")
        assert scored["val_loss"] == pytest.approx(row["val_loss"],
                                                   rel=1e-5)
        assert scored["val_mAP"] == pytest.approx(row["val_mAP"], abs=1e-6)
    finally:
        shutil.rmtree(tmp_path / "runs", ignore_errors=True)
