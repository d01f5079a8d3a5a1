"""The port's training run through its options and its CLI
(``tests/test_torch_trainer.py`` holds the run against podtpu's): early
stopping by validation rounds, the eval step's refused options, and
``cli.train`` on the CPU."""

import os

import pytest
import torch

from podtpu_torch.train.run import make_loaders
from podtpu_torch.train.steps import make_eval_step
from podtpu_torch.train.trainer import Trainer
from tests.torch_parity import podtpu_flat_weights
from tests.trainer_common import (  # noqa: F401 (fixtures)
    _cfg,
    drop_checkpoints,
    quiet,
    recording_writer,
    synth,
)


def test_early_stopping_counts_validation_rounds(synth, tmp_path,
                                                 monkeypatch):
    """Patience 1: the first round that does not lower val_loss stops the
    run; ``best`` is saved on each new low."""
    cfg = _cfg(synth, tmp_path, early_stopping_patience=1, save_freq=100)
    train_loader, val_loader = make_loaders(cfg)
    trainer = Trainer(cfg, device="cpu", log=quiet)
    losses = iter([3.0, 2.0, 2.5, 1.0])
    saved = []
    monkeypatch.setattr(trainer, "validate",
                        lambda _: {"val_loss": next(losses), "val_mAP": 0.0})
    save = trainer.ckpt.save
    monkeypatch.setattr(trainer.ckpt, "save",
                        lambda name, st: (saved.append((name, st.step)),
                                          save(name, st)))
    history = trainer.fit(train_loader, val_loader, epochs=10)
    assert [r["val_loss"] for r in history] == [3.0, 2.0, 2.5]
    assert [s for s in saved if s[0] == "best"] == [("best", 2), ("best", 4)]
    assert [s for s in saved if s[0] == "last"] == [("last", 2), ("last", 4),
                                                    ("last", 6)]


def test_unported_eval_options_raise(synth, tmp_path):
    """``make_eval_step(extra_variables={"quant": ...})`` (the int8 eval of
    ``cli.test --quantize``, no longer refused): the quant state is in
    place for the call only (the state's keys and mode come back), its
    detections are those of the model with the state installed, and they
    differ from the float model's; another collection raises."""
    from podtpu_torch.export import quantize
    from podtpu_torch.train.state import create_train_state
    from podtpu_torch.train.trainer import put_batch

    cfg = _cfg(synth, tmp_path)
    # seeded He-normal weights: torch's default init shrinks the heads to
    # ~0, where int8 and float agree to the bit
    state = create_train_state(cfg, "cpu",
                               weights=podtpu_flat_weights(cfg, seed=2))
    batch = next(iter(make_loaders(cfg)[1]))
    batch.pop("n_valid", None)
    batch = put_batch(batch, torch.device("cpu"))
    qvars = quantize.build_quant_variables(
        state.model, quantize.calibrate(state.model,
                                        [batch["img"].float() / 255.0]))
    keys = set(state.model.state_dict())
    loss, dets, valid = make_eval_step(cfg, extra_variables=qvars)(state,
                                                                   batch)
    assert set(state.model.state_dict()) == keys and state.model.training
    assert torch.isfinite(loss)
    with quantize.quant_scope(state.model, qvars["quant"]):
        want = make_eval_step(cfg)(state, batch)
    assert torch.equal(loss, want[0]) and torch.equal(dets, want[1])
    assert torch.equal(valid, want[2])
    float_loss = make_eval_step(cfg)(state, batch)[0]
    assert not torch.equal(loss, float_loss)
    with pytest.raises(ValueError, match="quant"):
        make_eval_step(cfg, extra_variables={"quant_stats": {}})


def test_cli_trains_on_the_cpu(synth, tmp_path, monkeypatch, capsys):
    """``python -m podtpu_torch.train.run --cfg ... --device cpu`` on a
    synthetic set (its ``main``, in this process): one epoch, validated,
    checkpoints written."""
    import sys

    import yaml

    from podtpu_torch.train import run

    cfg = _cfg(synth, tmp_path / "runs", epochs=1)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.setattr(sys, "argv", ["run", "--cfg", str(path),
                                      "--device", "cpu"])
    run.main()
    out = capsys.readouterr().out
    assert "Total trainable params" in out
    assert "epoch 0:" in out and "val_mAP=" in out
    ckpts = tmp_path / "runs" / "yolov3_voc" / "version_0" / "checkpoints"
    assert {"last", "best", "epoch_0000"} <= set(os.listdir(ckpts))
