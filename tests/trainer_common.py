"""What the tests of the port's training run share
(``tests/test_torch_trainer*.py``): a writer that records scalars in
place of TensorBoard, the cleanup of each test's checkpoints, the
synthetic files, and ``configs/yolov3_voc.yaml``'s recipe at 64 px."""

import os
import shutil

import pytest

from podtpu_torch.config import get_configs
from podtpu_torch.data.synthetic import generate
from podtpu_torch.export.weights import load_flat_weights
from podtpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
quiet = lambda *_: None  # noqa: E731

class _Scalars:
    """A TensorBoard writer that records ``add_scalar`` calls."""

    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), int(step)))

    def flush(self):
        pass

@pytest.fixture(autouse=True)
def recording_writer(monkeypatch):
    """Each Trainer of this file writes its scalars to a :class:`_Scalars`
    (importing TensorBoard costs seconds); ``test_writer_*`` check the
    real property."""
    writers = []

    def make(trainer):
        if trainer._writer is None:
            trainer._writer = _Scalars()
            writers.append(trainer._writer)
        return trainer._writer

    monkeypatch.setattr(Trainer, "writer", property(make))
    return writers

@pytest.fixture(autouse=True)
def drop_checkpoints(tmp_path):
    """A checkpoint of the 64 px model is ~280 MB: each test's files go
    when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    out = tmp_path_factory.mktemp("synth")
    return generate(str(out), n_train=8, n_val=6, size=80, num_classes=20,
                    max_objects=3, seed=1)

def _cfg(synth, save_dir, **extra):
    """configs/yolov3_voc.yaml's recipe (nesterov SGD, yolo_lr with burn-in
    1000, 20 classes) at 64 px, float32, B=4: 2 train steps an epoch, and
    a ragged second val batch (6 = 4 + 2)."""
    cfg = get_configs(os.path.join(REPO, "configs", "yolov3_voc.yaml"))
    cfg.update(input_size=64, compute_dtype="float32", batch_size=4,
               workers=2, max_annots=8, epochs=2, save_freq=1,
               trainer_options={"check_val_every_n_epoch": 1},
               train_list=synth["train_list"], val_list=synth["val_list"],
               names=synth["names"], save_dir=str(save_dir))
    cfg.update(extra)
    return cfg

def _port_trainer(cfg, flat, **kw):
    trainer = Trainer(cfg, device="cpu", log=quiet, **kw)
    load_flat_weights(trainer.state.model, flat)
    return trainer

def _state_tensors(state):
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for i, (p, st) in enumerate(state.optimizer.state.items()):
        out[f"momentum.{i}"] = st["momentum_buffer"]
    return out
