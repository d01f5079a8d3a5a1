"""The port's YOLOv3 forward and weight carry-over against podtpu (CPU).

Same seeded weights in both packages (podtpu's flat ``.npz`` layout carried
into the port by ``podtpu_torch.export.weights``), same seeded input at
64 px, eval mode.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from podtpu.export.weights import save_npz_weights
from podtpu.models.factory import build_model as podtpu_build_model
from podtpu_torch.export.weights import (
    flat_from_state_dict,
    load_flat_weights,
    load_npz_weights,
)
from podtpu_torch.models.factory import build_model
from tests.torch_parity import (
    flax_variables,
    image_batch,
    podtpu_flat_weights,
    yolo_cfg,
)


@pytest.fixture(scope="module")
def flat():
    # the weights are f32 whatever the compute dtype, so one set serves both
    return podtpu_flat_weights(yolo_cfg("float32"), seed=0)


def _heads(cfg, flat):
    x = image_batch(cfg, batch=2).astype(np.float32) / 255.0
    want = podtpu_build_model(cfg).apply(flax_variables(flat), jnp.asarray(x),
                                         train=False)
    model = load_flat_weights(build_model(cfg, device="cpu"), flat)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_yolov3_heads_match_podtpu(flat, dtype):
    want, got = _heads(yolo_cfg(dtype), flat)
    for w, g in zip(want, got):
        assert g.dtype == np.float32 and g.shape == w.shape
        if dtype == "float32":
            # ~20 convs deep, f32: only the convolutions' summation order
            # differs between XLA:CPU and PyTorch's CPU kernels
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
        else:
            # bf16 compute: the two frameworks round the conv output and the
            # BN multiply-add at different places; each rounding is half a
            # bf16 ulp (2^-9 relative), and 23 layers compound it. At this
            # seed the error is max 0.6% and mean 0.06% of the head's largest
            # magnitude; the bounds leave ~3x room for other CPU kernels.
            scale = np.abs(w).max()
            assert np.abs(g - w).max() <= 0.02 * scale
            assert np.abs(g - w).mean() <= 0.002 * scale


def test_weights_round_trip_every_key(flat):
    model = load_flat_weights(build_model(yolo_cfg(), device="cpu"), flat)
    back = flat_from_state_dict(model)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


def test_npz_written_by_podtpu_loads(flat, tmp_path):
    variables = flax_variables(flat)
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables["batch_stats"])
    path = save_npz_weights(state, str(tmp_path / "w.npz"))
    model = load_npz_weights(build_model(yolo_cfg(), device="cpu"), path)
    conv = model.backbone.stage2.conv1.conv.weight.detach().numpy()
    np.testing.assert_array_equal(
        conv.transpose(2, 3, 1, 0),
        flat["params::backbone::stage2::conv1::conv::kernel"])
    np.testing.assert_array_equal(
        model.p3_head.expand.bn.running_var.numpy(),
        flat["batch_stats::p3_head::expand::bn::var"])


def test_weights_missing_key_raises(flat):
    partial = dict(flat)
    del partial["batch_stats::c4_route::bn::mean"]
    with pytest.raises(KeyError, match="missing"):
        load_flat_weights(build_model(yolo_cfg(), device="cpu"), partial)


def test_weights_extra_key_raises(flat):
    extra = dict(flat)
    extra["params::c4_route::conv::bias"] = np.zeros(128, np.float32)
    with pytest.raises(KeyError, match="no place"):
        load_flat_weights(build_model(yolo_cfg(), device="cpu"), extra)


def test_weights_shape_mismatch_raises(flat):
    bad = dict(flat)
    bad["params::c4_route::bn::scale"] = np.ones(64, np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_flat_weights(build_model(yolo_cfg(), device="cpu"), bad)


@pytest.mark.parametrize("model", ["retinanet"])
def test_unported_families_raise(model):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(yolo_cfg(model=model), device="cpu")
