"""Shared inputs for the parity tests of the PyTorch port against podtpu.

Weights are made once with numpy from a seed, in podtpu's flat ``.npz``
layout, and handed to both packages: the JAX side as Flax variables, the
port through ``podtpu_torch.export.weights``. The key set comes from
``jax.eval_shape`` of podtpu's own ``init``, so it is podtpu's tree without
paying for a real init.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.traverse_util import unflatten_dict

from tests.helpers import VOC_ANCHORS

SEP = "::"


def yolo_cfg(dtype: str = "float32", size: int = 64, **extra) -> dict:
    cfg = dict(model="yolov3", num_classes=20, anchors=VOC_ANCHORS,
               input_size=size, compute_dtype=dtype, conf_threshold=0.25,
               nms_iou_threshold=0.45, top_k_candidates=512,
               max_detections=100)
    cfg.update(extra)
    return cfg


def podtpu_flat_weights(cfg: dict, seed: int = 0) -> dict[str, np.ndarray]:
    """Seeded weights in podtpu's flat layout for ``cfg``'s model at its
    input size (:func:`module_flat_weights`)."""
    from podtpu.models.factory import build_model

    size = cfg["input_size"]
    return module_flat_weights(build_model(cfg),
                               jnp.zeros((1, size, size, 3), jnp.float32),
                               seed)


def module_flat_weights(module, x, seed: int = 0) -> dict[str, np.ndarray]:
    """Seeded weights in podtpu's flat layout for a Flax ``module`` applied
    to ``x``: He-normal kernels (so activations keep their scale through
    the depth and heads spread), and non-trivial BN affine and running
    statistics."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(seed)
    flat = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes[coll])[0]:
            key = SEP.join([coll] + [str(p.key) for p in path])
            shape = leaf.shape
            if key.endswith("kernel"):
                fan_in = int(np.prod(shape[:-1]))
                arr = rng.normal(0.0, np.sqrt(2.0 / fan_in), shape)
            elif key.endswith("scale"):
                arr = rng.uniform(0.5, 1.5, shape)
            elif key.endswith("var"):
                arr = rng.uniform(0.5, 2.0, shape)
            else:  # bn bias, running mean
                arr = rng.normal(0.0, 0.1, shape)
            flat[key] = arr.astype(np.float32)
    return flat


def flax_variables(flat: dict[str, np.ndarray]) -> dict:
    out = {}
    for coll in ("params", "batch_stats"):
        out[coll] = unflatten_dict({
            tuple(k.split(SEP)[1:]): jnp.asarray(v)
            for k, v in flat.items() if k.startswith(coll + SEP)})
    return out


def image_batch(cfg: dict, batch: int = 2, seed: int = 0) -> np.ndarray:
    size = cfg["input_size"]
    return np.random.default_rng(seed).integers(
        0, 256, (batch, size, size, 3), dtype=np.uint8)


# cfg keys that do not reach podtpu's train state (model, optimizer, schedule)
_RUN_KEYS = ("train_list", "val_list", "names", "save_dir", "epochs",
             "swa", "log_images", "save_freq", "trainer_options")


@pytest.fixture(scope="module")
def cached_podtpu_states():
    """Within a module: podtpu's ``create_train_state`` (about 7 s of model
    init on the CPU a call) built once per config and handed out as
    copies, so its trainers' donating train steps never free the cached
    arrays. Test code reaches it as ``podtpu.train.state
    .create_train_state``."""
    import json

    import podtpu.train.state as jstate
    import podtpu.train.trainer as jtrainer

    orig = jstate.create_train_state
    cache = {}

    def cached(cfg, rng):
        key = json.dumps({k: v for k, v in cfg.items() if k not in _RUN_KEYS},
                         sort_keys=True, default=str) + repr(
                             np.asarray(rng).tolist())
        if key not in cache:
            cache[key] = orig(cfg, rng)
        return jax.tree_util.tree_map(jnp.copy, cache[key])

    mp = pytest.MonkeyPatch()
    mp.setattr(jstate, "create_train_state", cached)
    mp.setattr(jtrainer, "create_train_state", cached)
    yield cached
    mp.undo()


def recipe_cfg(synth: dict, save_dir, **extra) -> dict:
    """configs/yolov3_voc.yaml's recipe (nesterov SGD, yolo_lr with burn-in
    1000, 20 classes) at 64 px, float32, B=4 on a synthetic set of 8 train
    and 6 val images: 2 train steps an epoch and a ragged second val batch
    (6 = 4 + 2); validated every epoch, no periodic checkpoints."""
    import os

    from podtpu_torch.config import get_configs

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = get_configs(os.path.join(repo, "configs", "yolov3_voc.yaml"))
    cfg.update(input_size=64, compute_dtype="float32", batch_size=4,
               workers=2, max_annots=8, epochs=2, save_freq=100,
               trainer_options={"check_val_every_n_epoch": 1},
               train_list=synth["train_list"], val_list=synth["val_list"],
               names=synth["names"], save_dir=str(save_dir))
    cfg.update(extra)
    return cfg


class RecordingWriter:
    """A TensorBoard writer that records ``add_scalar`` / ``add_image``."""

    def __init__(self):
        self.scalars, self.images = [], []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), int(step)))

    def add_image(self, tag, img, step, dataformats="CHW"):
        self.images.append((tag, img, int(step), dataformats))

    def flush(self):
        pass


@pytest.fixture
def recording_writer(monkeypatch):
    """Each port ``Trainer`` of the test writes to a
    :class:`RecordingWriter` (importing TensorBoard costs seconds); the
    writers, in order of creation."""
    from podtpu_torch.train.trainer import Trainer

    writers = []

    def make(trainer):
        if trainer._writer is None:
            trainer._writer = RecordingWriter()
            writers.append(trainer._writer)
        return trainer._writer

    monkeypatch.setattr(Trainer, "writer", property(make))
    return writers


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """8 train and 6 val synthetic JPEGs at 80 px with YOLO labels."""
    from podtpu_torch.data.synthetic import generate

    out = tmp_path_factory.mktemp("synth")
    return generate(str(out), n_train=8, n_val=6, size=80, num_classes=20,
                    max_objects=3, seed=1)


def fake_voc_run(root) -> tuple[str, str, object]:
    """A fabricated VOCdevkit under ``root`` converted to YOLO lists, a
    YOLOv4-tiny config at 64 px on it and a checkpoint of seeded weights:
    ``(config path, checkpoint, root)``."""
    import os
    import sys

    import yaml

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(repo, "tools"))
    from make_fake_vocdevkit import fabricate
    from voc_to_yolo import convert

    from podtpu_torch.cli import convert_checkpoint as cli_convert
    from podtpu_torch.config import get_configs

    fabricate(str(root / "devkit"), n_2007_train=2, n_2007_val=4, n_2012=1,
              size=96, seed=5)
    lists = convert(str(root / "devkit"), str(root / "yolo"))
    cfg = get_configs(os.path.join(repo, "configs", "yolov4-tiny_voc.yaml"))
    cfg.update(input_size=64, compute_dtype="float32", batch_size=2,
               workers=1, max_annots=8, save_dir=str(root),
               train_list=lists["train_list"], val_list=lists["val_list"],
               names=lists["names"], conf_threshold=0.05)
    path = root / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    npz = str(root / "w.npz")
    np.savez(npz, **podtpu_flat_weights(cfg, seed=8))
    cli_convert.main(["--cfg", str(path), "--ckpt", npz, "--out",
                      str(root / "ckpt"), "--device", "cpu"])
    return str(path), str(root / "ckpt" / "converted"), root
