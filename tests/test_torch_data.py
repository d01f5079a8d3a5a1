"""The port's host data path against podtpu's (CPU): the synthetic set, the
augmentations, ``YoloTxtDataset`` in both pipelines and ``Loader``. The
port keeps a copy of this host code, so every output must be equal, bit
for bit, from the same seeds."""

import filecmp
import os

import numpy as np
import pytest

from podtpu.data import augment as JA
from podtpu.data.dataset import YoloTxtDataset as JDataset
from podtpu.data.dataset import build_datasets as podtpu_build_datasets
from podtpu.data.dataset import label_path_for as podtpu_label_path_for
from podtpu.data.dataset import read_yolo_labels as podtpu_read_labels
from podtpu.data.loader import Loader as JLoader
from podtpu.data.synthetic import generate as podtpu_generate
from podtpu_torch.data import augment as TA
from podtpu_torch.data.dataset import (
    YoloTxtDataset,
    build_datasets,
    label_path_for,
    read_yolo_labels,
)
from podtpu_torch.data.loader import Loader
from podtpu_torch.data.synthetic import generate


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    out = tmp_path_factory.mktemp("synth")
    return generate(str(out), n_train=10, n_val=5, size=96, num_classes=4,
                    max_objects=4, seed=2)


def test_synthetic_generate_writes_identical_files(tmp_path):
    got = generate(str(tmp_path / "port"), n_train=4, n_val=2, size=96,
                   num_classes=3, max_objects=3, seed=5)
    want = podtpu_generate(str(tmp_path / "ref"), n_train=4, n_val=2,
                           size=96, num_classes=3, max_objects=3, seed=5)
    assert got["num_classes"] == want["num_classes"]
    root_g, root_w = tmp_path / "port" / "images", tmp_path / "ref" / "images"
    names = sorted(os.listdir(root_w))
    assert sorted(os.listdir(root_g)) == names and len(names) == 12
    for n in names:
        assert filecmp.cmp(root_g / n, root_w / n, shallow=False), n
    for key in ("train_list", "val_list", "names"):
        with open(got[key]) as f, open(want[key]) as g:
            assert (f.read().replace(str(tmp_path / "port"), "")
                    == g.read().replace(str(tmp_path / "ref"), ""))


# ---- augmentations, each on the same inputs and the same generator ---------

def _aug_inputs(seed=0):
    r = np.random.default_rng(seed)
    im = r.integers(0, 256, (72, 96, 3), dtype=np.uint8)
    im[10:40, 20:60] = (200, 60, 40)
    px = np.array([[0, 10, 12, 50, 44], [1, 40, 30, 90, 70],
                   [2, 5, 50, 30, 71], [3, 60, 2, 70, 20]], np.float32)
    norm = np.array([[0.4, 0.5, 0.3, 0.4, 1], [0.7, 0.3, 0.2, 0.3, 2]],
                    np.float32)
    return im, px, norm


def _mosaic(A, rng):
    r = np.random.default_rng(1)
    imgs = [r.integers(0, 256, (64, 48 + 8 * i, 3), dtype=np.uint8)
            for i in range(4)]
    boxes = [np.array([[i, 2, 3, 30, 40]], np.float32) for i in range(3)]
    return A.mosaic4(imgs, boxes + [np.zeros((0, 5), np.float32)], 64, rng)


def _copy_paste(A, im, px, rng):
    segs = [np.array([[b[1], b[2]], [b[3], b[2]], [b[3], b[4]], [b[1], b[4]]],
                     np.float32) for b in px]
    return A.copy_paste(im, px, segs, rng, p=1.0)[:2]


AUGMENTS = {
    "letterbox": lambda A, im, px, nm, rng: A.letterbox(im, 64)[0],
    "random_affine": lambda A, im, px, nm, rng: A.random_affine(
        im, px.copy(), rng, degrees=5.0, translate=0.1, scale=0.5, shear=2.0),
    "random_affine_crop_border": lambda A, im, px, nm, rng: A.random_affine(
        im, px.copy(), rng, border=(-16, -24)),
    "augment_hsv": lambda A, im, px, nm, rng: A.augment_hsv(im, rng),
    "pixel_ops_all": lambda A, im, px, nm, rng: A.pixel_ops(im, rng, p=1.0),
    "clahe": lambda A, im, px, nm, rng: A.clahe(im),
    "color_jitter": lambda A, im, px, nm, rng: A.color_jitter(im, rng),
    "random_resized_crop": lambda A, im, px, nm, rng: A.random_resized_crop(
        im, nm, rng, 48),
    "mosaic4": lambda A, im, px, nm, rng: _mosaic(A, rng),
    "mixup": lambda A, im, px, nm, rng: A.mixup(im, px, im[::-1].copy(),
                                                px[:2], rng),
    "cutout": lambda A, im, px, nm, rng: A.cutout(im.copy(), px.copy(), rng),
    "hist_equalize": lambda A, im, px, nm, rng: A.hist_equalize(im),
    "hist_equalize_global": lambda A, im, px, nm, rng: A.hist_equalize(
        im, use_clahe=False),
    "replicate": lambda A, im, px, nm, rng: A.replicate(im.copy(), px.copy(),
                                                        rng),
    "copy_paste": lambda A, im, px, nm, rng: _copy_paste(A, im.copy(), px,
                                                         rng),
    "hflip": lambda A, im, px, nm, rng: A.hflip(im, nm),
}


@pytest.mark.parametrize("name", sorted(AUGMENTS))
def test_augment_bit_identical(name):
    outs = []
    for A in (TA, JA):
        im, px, nm = _aug_inputs()
        rng = np.random.default_rng(11)
        out = AUGMENTS[name](A, im, px, nm, rng)
        outs.append((out if isinstance(out, tuple) else (out,),
                     rng.random()))  # the generator advanced alike
    (got, g_next), (want, w_next) = outs
    assert g_next == w_next
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# ---- YoloTxtDataset -------------------------------------------------------

DATASET_CASES = {
    "letterbox_augment": dict(augment=True),
    "letterbox_eval": dict(augment=False),
    "simple_augment": dict(augment=True, pipeline="simple"),
    "simple_eval": dict(augment=False, pipeline="simple"),
    "mosaic": dict(augment=True, mosaic=1.0),
    "mosaic_copy_paste": dict(augment=True, mosaic=1.0, copy_paste=1.0),
    "pixel_ops_off": dict(augment=True, pixel_ops=False),
    "cache_images": dict(augment=True, cache_images=True, mosaic=0.5),
    "float_output": dict(augment=True, output_uint8=False),
}


@pytest.mark.parametrize("case", sorted(DATASET_CASES))
def test_dataset_samples_bit_identical(synth, case):
    kw = dict(DATASET_CASES[case])
    augment = kw.pop("augment")
    kw.setdefault("output_uint8", True)
    got_ds = YoloTxtDataset(synth["train_list"], 64, augment, **kw)
    want_ds = JDataset(synth["train_list"], 64, augment, **kw)
    assert len(got_ds) == len(want_ds) == 10
    n_boxes = 0
    for rep in range(2):  # twice: the image cache is filled, then read
        for i in range(len(got_ds)):
            seed = 1000 * rep + 7 * i
            g_im, g_box = got_ds.get(i, seed)
            w_im, w_box = want_ds.get(i, seed)
            assert g_im.dtype == w_im.dtype and g_im.shape == (64, 64, 3)
            np.testing.assert_array_equal(g_im, w_im)
            assert g_box.dtype == w_box.dtype == np.float32
            np.testing.assert_array_equal(g_box, w_box)
            n_boxes += len(g_box)
    assert n_boxes > 0


def test_read_yolo_labels_and_label_path(synth, tmp_path):
    with open(synth["train_list"]) as f:
        paths = f.read().split()
    for p in paths[:4]:
        lab = label_path_for(p)
        assert lab == p[:-4] + ".txt"
        np.testing.assert_array_equal(read_yolo_labels(lab),
                                      podtpu_read_labels(lab))
    odd = tmp_path / "odd.txt"
    odd.write_text("1 0.5 0.5 0.2 0.2\n\n  \n3 0.1 0.2 0.3 0.4\n")
    for path in (str(odd), str(tmp_path / "missing.txt")):
        got, want = read_yolo_labels(path), podtpu_read_labels(path)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for name in ("a.PNG", "b.jpeg", "c.bmp", "d.tif"):
        assert label_path_for(name) == podtpu_label_path_for(name)


@pytest.mark.parametrize("model,extra", [
    ("yolov3", {}),
    ("yolov2", {"cache_images": True}),
    ("yolov3", {"mosaic": 1.0, "copy_paste": 0.5, "pixel_ops": False,
                "uint8_batches": False}),
])
def test_build_datasets_matches_podtpu(synth, model, extra):
    cfg = dict(model=model, input_size=64, train_list=synth["train_list"],
               val_list=synth["val_list"], **extra)
    for got, want in zip(build_datasets(cfg), podtpu_build_datasets(cfg)):
        assert got.imgs == want.imgs
        for attr in ("input_size", "augment", "pipeline", "mosaic",
                     "copy_paste", "output_uint8", "pixel_ops"):
            assert getattr(got, attr) == getattr(want, attr), attr
        assert (got._cache is None) == (want._cache is None)
        g, w = got.get(1, 3), want.get(1, 3)
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])


# ---- Loader ---------------------------------------------------------------

LOADER_CASES = {
    "shuffle": dict(shuffle=True, batch_size=4),
    "no_shuffle": dict(shuffle=False, batch_size=4),
    "ragged_final_batch": dict(shuffle=False, batch_size=4, drop_last=False),
    "two_hosts": dict(shuffle=True, batch_size=2, host_id=1, host_count=2),
    "process_mode": dict(shuffle=True, batch_size=4, worker_mode="process"),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_loader_batches_bit_identical(synth, case):
    kw = dict(LOADER_CASES[case], max_annots=6, workers=2, seed=4)
    mode = kw.pop("worker_mode", "thread")
    got_ds = YoloTxtDataset(synth["train_list"], 64, True, output_uint8=True)
    want_ds = JDataset(synth["train_list"], 64, True, output_uint8=True)
    got_l = Loader(got_ds, worker_mode=mode, **kw)
    # podtpu's process mode gives its thread mode's batches (its own tests)
    want_l = JLoader(want_ds, **kw)
    assert len(got_l) == len(want_l) > 0
    for epoch in (0, 1):
        got_l.set_epoch(epoch)
        want_l.set_epoch(epoch)
        got, want = list(got_l), list(want_l)
        assert len(got) == len(want) == len(got_l)
        for g, w in zip(got, want):
            assert set(g) == set(w) == {"img", "annot", "n_valid"}
            assert g["n_valid"] == w["n_valid"]
            assert g["img"].shape == (kw["batch_size"], 64, 64, 3)
            np.testing.assert_array_equal(g["img"], w["img"])
            np.testing.assert_array_equal(g["annot"], w["annot"])
    if case == "ragged_final_batch":
        assert [b["n_valid"] for b in got] == [4, 4, 2]
        # the padding repeats the last real sample
        np.testing.assert_array_equal(got[-1]["img"][2], got[-1]["img"][1])


def test_loader_producer_exception_reaches_consumer(synth):
    class Broken(YoloTxtDataset):
        def get(self, index, seed):
            if index == 5:
                raise ValueError("bad sample 5")
            return super().get(index, seed)

    loader = Loader(Broken(synth["train_list"], 64, False), batch_size=2,
                    shuffle=False, workers=2)
    seen = 0
    with pytest.raises(ValueError, match="bad sample 5"):
        for _ in loader:
            seen += 1
    assert seen == 2  # batches [0, 1] and [2, 3] came before [4, 5]


def test_loader_close_joins_producer(synth):
    import threading

    loader = Loader(YoloTxtDataset(synth["train_list"], 64, True),
                    batch_size=2, shuffle=True, workers=2, prefetch=1)
    before = threading.active_count()
    it = iter(loader)
    next(it)
    it.close()  # the generator's finally drains and joins the producer
    assert threading.active_count() <= before
