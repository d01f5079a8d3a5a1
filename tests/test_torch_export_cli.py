"""The export-path CLIs against podtpu's root scripts loaded by path (CPU,
64 px, float32, YOLOv4-tiny on 20 classes, seeded weights):
``export_model`` (serving, ``--fold-bn --annotate``, ``--quantize
int8``), ``convert_checkpoint`` both ways, ``pruning_test`` and
``exported_inference``."""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from podtpu_torch.cli import convert_checkpoint as cli_convert
from podtpu_torch.cli import export_model as cli_export
from podtpu_torch.cli import exported_inference as cli_bench
from podtpu_torch.cli import pruning_test as cli_prune
from podtpu_torch.config import get_configs
from podtpu_torch.export.runner import artifact_runner
from podtpu_torch.models.darknet import Darknet19
from tests.torch_parity import (  # noqa: F401  (fixtures)
    SEP,
    cached_podtpu_states,
    flax_variables,
    module_flat_weights,
    podtpu_flat_weights,
    synth,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Six workers share the cores: two intra-op threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _root_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"podtpu_root_{name}", os.path.join(REPO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_root(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [mod.__name__] + list(argv))
    return mod.main()


@pytest.fixture(scope="module")
def env(synth, tmp_path_factory, cached_podtpu_states):
    """configs/yolov4-tiny_voc.yaml at 64 px float32 on the synthetic set,
    as a YAML file; seeded weights as a ``.npz``."""
    import yaml

    root = tmp_path_factory.mktemp("export_cli")
    cfg = get_configs(os.path.join(REPO, "configs", "yolov4-tiny_voc.yaml"))
    cfg.update(input_size=64, compute_dtype="float32", batch_size=2,
               workers=1, max_annots=8, save_dir=str(root),
               train_list=synth["train_list"], val_list=synth["val_list"],
               names=synth["names"])
    path = root / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    flat = podtpu_flat_weights(cfg, seed=6)
    npz = str(root / "w.npz")
    np.savez(npz, **flat)
    return cfg, str(path), flat, npz, root


@pytest.fixture(scope="module")
def root_export(env):
    """podtpu's ``export_model.py`` with its restore handing it the seeded
    weights."""
    _, _, flat, _, _ = env
    mod = _root_script("export_model")
    variables = flax_variables(flat)
    mod.restore_eval_weights = lambda ckpt, state, cfg, use_ema=None: \
        state.replace(params=variables["params"],
                      batch_stats=variables["batch_stats"])
    return mod


def _exports(env, root_export, monkeypatch, tag, flags):
    """Both CLIs with ``flags``; returns (podtpu's path, the port's)."""
    _, cfg_path, _, npz, root = env
    jpath, tpath = str(root / f"{tag}.stablehlo"), str(root / f"{tag}.pt2")
    _run_root(root_export, ["--cfg", cfg_path, "--ckpt", "w", "--out", jpath,
                            "--platforms", "cpu", "--platform", "cpu"]
              + [f.replace("DIR", str(root)) for f in flags], monkeypatch)
    # the port reads the same weights from its own checkpoint format
    ckpt = str(root / "ckpt")
    if not os.path.isdir(os.path.join(ckpt, "converted")):
        cli_convert.main(["--cfg", cfg_path, "--ckpt", npz, "--out", ckpt,
                          "--device", "cpu"])
    cli_export.main(["--cfg", cfg_path, "--ckpt",
                     os.path.join(ckpt, "converted"), "--out", tpath,
                     "--device", "cpu"]
                    + [f.replace("DIR", str(root)).replace(
                        ".json", ".port.json") for f in flags])
    return jpath, tpath


def _batch(seed=3, b=2):
    return np.random.default_rng(seed).uniform(0, 1, (b, 64, 64, 3)).astype(
        np.float32)


def test_export_model_serving_matches_podtpu(env, root_export, monkeypatch):
    """``--with-postprocess --batch 2``: the two artifacts' detections on
    one batch (valid masks and classes equal; boxes and scores to the
    float32 heads' rounding)."""
    from podtpu.export.stablehlo import load_exported

    jpath, tpath = _exports(env, root_export, monkeypatch, "serve",
                            ["--with-postprocess", "--batch", "2"])
    x = _batch()
    jdets, jvalid = (np.asarray(a) for a in load_exported(jpath)(
        jnp.asarray(x)))
    run, batch = artifact_runner(tpath)
    dets, valid = run(x)
    assert batch == 2 and valid.any()
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_array_equal(dets[valid][:, 5], jdets[jvalid][:, 5])
    np.testing.assert_allclose(dets[valid][:, :4], jdets[jvalid][:, :4],
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(dets[valid][:, 4], jdets[jvalid][:, 4],
                               atol=1e-5)


def _heads(jpath, tpath, x):
    from podtpu.export.stablehlo import load_exported

    from podtpu_torch.export.program import load_exported as port_load

    want = [np.asarray(h) for h in load_exported(jpath)(jnp.asarray(x))]
    got = [h.numpy() for h in port_load(tpath)(torch.from_numpy(x))]
    return got, want


def test_export_model_fold_bn_annotate_matches_podtpu(env, root_export,
                                                      monkeypatch):
    """``--fold-bn --annotate``: the heads of the two folded forward
    artifacts within 1e-5 of their scale (measured 7.9e-7); both maps
    count 24 convolutions and 3 pools."""
    jpath, tpath = _exports(env, root_export, monkeypatch, "fold",
                            ["--fold-bn", "--annotate", "DIR/ann.json"])
    got, want = _heads(jpath, tpath, _batch(b=1))
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
    _, _, _, _, root = env
    with open(root / "ann.json") as f:
        jann = json.load(f)
    with open(root / "ann.port.json") as f:
        tann = json.load(f)
    count = lambda ann, kind: sum(l["name"].startswith(kind)  # noqa: E731
                                  for l in ann["layers"])
    assert count(tann, "conv") == count(jann, "conv") == 24
    assert count(tann, "pool") == count(jann, "pool") == 3
    assert tann["num_layers"] == jann["num_layers"]


def test_export_model_int8_matches_podtpu(env, root_export, monkeypatch):
    """``--quantize int8 --calib-batches 2`` on the val images: the two
    quantized forward artifacts' heads. Each calibrates in its own float32
    forward, so a scale can differ in its last bits and an element near a
    quantization step could round the other way; measured: relative max
    error 6.2e-7, correlation 1 - 5e-14. Held to 1e-5 and 0.99999."""
    jpath, tpath = _exports(env, root_export, monkeypatch, "int8",
                            ["--quantize", "int8", "--calib-batches", "2",
                             "--batch", "2"])
    got, want = _heads(jpath, tpath, _batch(seed=4))
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
        assert np.corrcoef(g.ravel(), w.ravel())[0, 1] > 0.99999
    from podtpu_torch.export.program import inspect_exported

    assert "aten.round" in inspect_exported(tpath)["ops"]


def test_convert_checkpoint_both_ways_matches_podtpu(env, monkeypatch):
    """``--to-torch`` from the same ``.npz``: the same reference-layout
    state_dict; ``--from-torch`` of it: the same ``.npz``; and ``.npz``
    -> checkpoint -> ``.npz`` gives the weights back."""
    cfg, cfg_path, flat, npz, root = env
    root_convert = _root_script("convert_checkpoint")
    _run_root(root_convert, ["--cfg", cfg_path, "--ckpt", npz, "--to-torch",
                             str(root / "j.pt"), "--platform", "cpu"],
              monkeypatch)
    cli_convert.main(["--cfg", cfg_path, "--ckpt", npz, "--to-torch",
                      str(root / "t.pt"), "--device", "cpu"])
    want = torch.load(root / "j.pt", weights_only=False)
    got = torch.load(root / "t.pt", weights_only=False)
    assert list(got) == list(want)
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            # 0-dim as torch keeps it (podtpu's script writes shape [1])
            assert got[k].shape == () and int(got[k]) == int(v) == 0
            continue
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k

    _run_root(root_convert, ["--cfg", cfg_path, "--from-torch",
                             str(root / "j.pt"), "--out",
                             str(root / "j.npz"), "--platform", "cpu"],
              monkeypatch)
    cli_convert.main(["--cfg", cfg_path, "--from-torch", str(root / "t.pt"),
                      "--out", str(root / "t.npz"), "--device", "cpu"])
    with np.load(root / "j.npz") as j, np.load(root / "t.npz") as t:
        assert set(j.files) == set(t.files) == set(flat)
        for k in j.files:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)

    cli_convert.main(["--cfg", cfg_path, "--ckpt", npz, "--out",
                      str(root / "rt"), "--device", "cpu"])
    cli_convert.main(["--cfg", cfg_path, "--ckpt",
                      str(root / "rt" / "converted"), "--out",
                      str(root / "rt.npz"), "--device", "cpu"])
    with np.load(root / "rt.npz") as back:
        for k, v in flat.items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_pruning_zeroes_podtpus_channels(capsys):
    """``prune_channels`` at amount 0.5 zeroes the same output channels of
    every Darknet-19 kernel as podtpu's; the CLI runs and prints both
    timings."""
    from podtpu.models import Darknet19 as JDarknet19

    from podtpu_torch.export.weights import (
        flat_from_state_dict,
        load_flat_weights,
    )

    root_prune = _root_script("pruning_test")
    flat = module_flat_weights(JDarknet19(out_indices=(5,)),
                               jnp.zeros((1, 64, 64, 3)), seed=8)
    jpruned = root_prune.prune_channels(flax_variables(flat)["params"], 0.5)
    model = load_flat_weights(Darknet19(out_indices=(5,)), flat)
    model.load_state_dict(cli_prune.prune_channels(model.state_dict(), 0.5))
    got = flat_from_state_dict(model)
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(jpruned)[0]:
        key = SEP.join(["params"] + [str(p.key) for p in path])
        w = np.asarray(leaf)
        if key.endswith("kernel"):
            zeroed = np.abs(w).sum(axis=(0, 1, 2)) == 0
            np.testing.assert_array_equal(
                np.abs(got[key]).sum(axis=(0, 1, 2)) == 0, zeroed)
            assert zeroed.sum() == w.shape[-1] // 2
            n += 1
        np.testing.assert_array_equal(got[key], w, err_msg=key)
    assert n == 18
    res = cli_prune.main(["--size", "64", "--iters", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "dense:" in out and "pruned:" in out
    assert 0.3 < res["zero_frac"] < 0.6


def test_exported_inference_times_an_artifact(env, root_export,
                                              monkeypatch, capsys):
    _, _, _, _, root = env
    path = str(root / "serve.pt2")
    if not os.path.exists(path):
        _exports(env, root_export, monkeypatch, "serve",
                 ["--with-postprocess", "--batch", "2"])
    res = cli_bench.main(["--model", path, "--iters", "2"])
    assert res["batch"] == 2 and res["ms"] > 0 and res["device"] == "cpu"
    assert "avg latency:" in capsys.readouterr().out
    # a SavedModel is exported and timed on the CPU (a .tflite is timed in
    # tests/test_torch_tflite.py); --quantize refused for it, as podtpu
    saved = str(root / "serve.savedmodel")
    cli_export.main(["--cfg", env[1], "--format", "savedmodel",
                     "--with-postprocess", "--out", saved, "--device",
                     "cpu"])
    res = cli_bench.main(["--model", saved, "--iters", "2", "--device",
                          "cpu"])
    assert res["batch"] == 1 and res["ms"] > 0 and res["device"] == "cpu"
    with pytest.raises(SystemExit):
        cli_export.main(["--cfg", env[1], "--format", "savedmodel",
                         "--quantize", "int8"])
