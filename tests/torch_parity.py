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
    """Seeded weights in podtpu's flat layout: He-normal kernels (so
    activations keep their scale through the depth and heads spread), and
    non-trivial BN affine and running statistics."""
    from podtpu.models.factory import build_model

    size = cfg["input_size"]
    shapes = jax.eval_shape(build_model(cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3), jnp.float32))
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
