"""The reference's torch weights in the port, and back
(``podtpu/export/torch_port.py``).

The reference (myungsanglee/PyTorch-Object-Detection) stores weights as a
torch ``state_dict``, plain (``lightning2torch.py:52-63``) or inside a
Lightning ``.ckpt`` under ``state_dict`` with a ``model.`` prefix. This
module maps its names onto the port's module names (``podtpu``'s, so
``backbone/stage0/conv0`` is ``backbone.stage0.conv0``) and back, for
yolov1, yolov2, yolov3, yolov4-tiny and the Darknet-19 classifier:

* Darknet-19 inside a detector: ``backbone_features_module.<stage>.<slot>``
  (a ``FeatureListNet`` of six ``Sequential``s) -> ``backbone.stage<i>
  .conv<j>``, where ``<j>`` counts the convs only (a max pool holds a slot
  but no weights); the classifier names its stages (``stem``,
  ``layer1``, ...);
* a conv-BN block: ``conv.weight`` (OIHW in both) and BN ``weight``,
  ``bias``, ``running_mean``, ``running_var`` carry over as they are;
  ``num_batches_tracked`` is dropped (and comes back as 0);
* YOLOv1's ``Linear`` reads an NCHW flatten in the reference and an NHWC
  one in the port (``podtpu``'s order), so its weight is permuted through
  ``[out, C, H, W] <-> [out, H, W, C]``.

Any mapped key missing raises, and so does any parameter left unmapped.
"""

from __future__ import annotations

import importlib
import os
import sys
import types
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# the reference checkout: only where the environment names one, never a
# path guessed outside this repository
REFERENCE_ROOT = os.environ.get("PODTPU_REFERENCE_ROOT")

# (reference prefix, port module path, kind): "convbn" a conv-BN block,
# "conv" a bare bias-free nn.Conv2d (a prediction head), "linear" YOLOv1's
# nn.Linear after an NCHW flatten

# darknet.py:53-94: each stage Sequential's slots, 1 for a conv, 0 a pool
_DARKNET_STAGES = (
    ("stem", (1,)),
    ("layer1", (0, 1)),
    ("layer2", (0, 1, 1, 1)),
    ("layer3", (0, 1, 1, 1)),
    ("layer4", (0, 1, 1, 1, 1, 1)),
    ("layer5", (0, 1, 1, 1, 1, 1)),
)
# YOLOv1's flatten input [B, 256, 7, 7] (yolov1.py:32-34)
_FC_CHW = (256, 7, 7)


def _darknet_entries(prefix_fmt: str) -> List[Tuple[str, str, str]]:
    entries = []
    for i, (stage_name, slots) in enumerate(_DARKNET_STAGES):
        stage = prefix_fmt.format(i=i, name=stage_name)
        conv_idx = 0
        for slot, is_conv in enumerate(slots):
            if is_conv:
                entries.append((f"{stage}.{slot}",
                                f"backbone.stage{i}.conv{conv_idx}", "convbn"))
                conv_idx += 1
    return entries


def _backbone_entries():
    return _darknet_entries("backbone_features_module.{i}")


def _yolov1_entries():
    e = _backbone_entries()
    e += [(f"yolov1_head.{j}", f"head{j}", "convbn") for j in range(5)]
    # slots 5 / 6 are Flatten / Dropout; 7 is the Linear (yolov1.py:34-38)
    e.append(("yolov1_head.7", "fc", "linear"))
    return e


def _yolov2_entries():
    return _backbone_entries() + [
        ("b4_layer.0", "b4_layer", "convbn"),
        ("b5_layer.0", "b5_layer0", "convbn"),
        ("b5_layer.1", "b5_layer1", "convbn"),
        ("yolov2_head.0", "head_conv", "convbn"),
        ("yolov2_head.1", "head.conv", "conv"),
    ]


def _yolov3_entries():
    e = _backbone_entries()
    for k in (3, 4, 5):
        e += [(f"c{k}_conv.{j}", f"c{k}_conv.c{j}", "convbn")
              for j in range(3)]
    e += [("c4_route.0", "c4_route", "convbn"),
          ("c5_route.0", "c5_route", "convbn")]
    for k in (3, 4, 5):
        e += [(f"p{k}_head.0", f"p{k}_head.expand", "convbn"),
              (f"p{k}_head.1", f"p{k}_head.pred.conv", "conv")]
    return e


def _yolov4_tiny_entries():
    e = [
        ("stem.0", "stem", "convbn"),
        ("layer1.0", "layer1_0", "convbn"),
        ("layer1.1", "layer1_1", "convbn"),
        ("layer2.1", "layer2", "convbn"),     # slot 0 is a max pool
        ("layer3.1", "layer3", "convbn"),
        ("layer4.1", "layer4_0", "convbn"),
        ("layer4.2", "layer4_1", "convbn"),
        ("b4_conv", "b4_conv", "convbn"),
        ("b4_route.0", "b4_route", "convbn"),
        ("b5_route.0", "b5_route", "convbn"),
        ("p3_head.0", "p3_expand", "convbn"),
        ("p3_head.1", "p3_pred.conv", "conv"),
        ("p4_head", "p4_pred.conv", "conv"),  # a bare Conv2d (yolov4_tiny.py:73)
        ("p5_head.0", "p5_expand", "convbn"),
        ("p5_head.1", "p5_pred.conv", "conv"),
    ]
    for n in (1, 2, 3):
        e += [(f"tiny_block{n}.conv{j}", f"tiny_block{n}.conv{j}", "convbn")
              for j in (1, 2, 3)]
    return e


def _darknet19_classifier_entries():
    return _darknet_entries("{name}") + [
        ("classifier.0", "classifier", "convbn")]


MODEL_ENTRIES = {
    "yolov1": _yolov1_entries,
    "yolov2": _yolov2_entries,
    "yolov3": _yolov3_entries,
    "yolov4-tiny": _yolov4_tiny_entries,
    "darknet19": _darknet19_classifier_entries,
}

_BN = ("weight", "bias", "running_mean", "running_var")


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def strip_lightning_prefix(state_dict: Dict) -> Dict:
    """``model.``-prefixed Lightning state_dict -> plain."""
    out = OrderedDict()
    for k, v in state_dict.items():
        out[k[len("model."):] if k.startswith("model.") else k] = v
    return out


def torch_to_port(state_dict: Dict, model_name: str
                  ) -> "OrderedDict[str, torch.Tensor]":
    """Reference ``state_dict`` (plain or ``model.``-prefixed; tensors or
    arrays) -> the port's ``state_dict`` for ``model_name``."""
    state_dict = strip_lightning_prefix(state_dict)
    consumed, out = set(), OrderedDict()

    def take(key: str) -> torch.Tensor:
        if key not in state_dict:
            raise KeyError(f"{model_name}: torch key {key!r} missing")
        consumed.add(key)
        return _tensor(state_dict[key])

    for tp, pp, kind in MODEL_ENTRIES[model_name]():
        if kind == "convbn":
            out[f"{pp}.conv.weight"] = take(f"{tp}.conv.weight")
            for leaf in _BN:
                out[f"{pp}.bn.{leaf}"] = take(f"{tp}.bn.{leaf}")
            consumed.add(f"{tp}.bn.num_batches_tracked")
        elif kind == "conv":
            out[f"{pp}.weight"] = take(f"{tp}.weight")
        elif kind == "linear":
            w = take(f"{tp}.weight")  # [out, C*H*W], an NCHW flatten
            out[f"{pp}.weight"] = w.reshape(w.shape[0], *_FC_CHW).permute(
                0, 2, 3, 1).reshape(w.shape[0], -1).contiguous()
            out[f"{pp}.bias"] = take(f"{tp}.bias")
        else:  # pragma: no cover
            raise ValueError(kind)
    leftovers = [k for k in state_dict if k not in consumed
                 and not k.endswith("num_batches_tracked")]
    if leftovers:
        raise KeyError(f"{model_name}: unmapped torch keys: {leftovers[:8]}"
                       f"{'...' if len(leftovers) > 8 else ''}")
    return out


def port_to_torch(state_dict: Dict, model_name: str
                  ) -> "OrderedDict[str, torch.Tensor]":
    """The port's ``state_dict`` -> the reference's layout, loadable with
    ``load_state_dict(strict=True)`` (``num_batches_tracked`` 0)."""
    out = OrderedDict()

    def get(key: str) -> torch.Tensor:
        if key not in state_dict:
            raise KeyError(f"{model_name}: port key {key!r} missing")
        return _tensor(state_dict[key])

    for tp, pp, kind in MODEL_ENTRIES[model_name]():
        if kind == "convbn":
            out[f"{tp}.conv.weight"] = get(f"{pp}.conv.weight")
            for leaf in _BN:
                out[f"{tp}.bn.{leaf}"] = get(f"{pp}.bn.{leaf}")
            out[f"{tp}.bn.num_batches_tracked"] = torch.tensor(
                0, dtype=torch.int64)
        elif kind == "conv":
            out[f"{tp}.weight"] = get(f"{pp}.weight")
        elif kind == "linear":
            w = get(f"{pp}.weight")  # [out, H*W*C], an NHWC flatten
            c, h, ww = _FC_CHW
            out[f"{tp}.weight"] = w.reshape(w.shape[0], h, ww, c).permute(
                0, 3, 1, 2).reshape(w.shape[0], -1).contiguous()
            out[f"{tp}.bias"] = get(f"{pp}.bias")
    return out


# ---------------------------------------------------------------------------
# Reference-module import shims
# ---------------------------------------------------------------------------

def install_reference_shims():
    """Stub ``torchinfo``, ``torchvision.ops`` and ``pkg_resources`` so the
    reference's model and loss modules import where those are absent
    (none is on the forward or loss path: ``torchinfo.summary`` prints,
    ``torchvision.ops.batched_nms`` is the reference's eval NMS, and
    ``pkg_resources`` checks versions)."""
    if "torchinfo" not in sys.modules:
        ti = types.ModuleType("torchinfo")
        ti.summary = lambda *a, **k: None
        sys.modules["torchinfo"] = ti
    if "torchvision" not in sys.modules:
        def _nms(boxes, scores, iou_threshold):
            """Greedy NMS with ``torchvision.ops.nms``'s semantics."""
            order = torch.argsort(scores, descending=True)
            keep = []
            while order.numel() > 0:
                i = order[0]
                keep.append(i.item())
                if order.numel() == 1:
                    break
                rest = order[1:]
                xy1 = torch.maximum(boxes[i, :2], boxes[rest, :2])
                xy2 = torch.minimum(boxes[i, 2:], boxes[rest, 2:])
                inter = (xy2 - xy1).clamp(min=0).prod(dim=1)
                area_i = (boxes[i, 2:] - boxes[i, :2]).clamp(min=0).prod()
                area_r = (boxes[rest, 2:] - boxes[rest, :2]).clamp(
                    min=0).prod(dim=1)
                iou = inter / (area_i + area_r - inter + 1e-16)
                order = rest[iou <= iou_threshold]
            return torch.as_tensor(keep, dtype=torch.long)

        def _batched_nms(boxes, scores, idxs, iou_threshold):
            if boxes.numel() == 0:
                return torch.empty((0,), dtype=torch.long)
            offsets = idxs.to(boxes) * (boxes.max() + 1)
            return _nms(boxes + offsets[:, None], scores, iou_threshold)

        tv = types.ModuleType("torchvision")
        ops = types.ModuleType("torchvision.ops")
        ops.nms = _nms
        ops.batched_nms = _batched_nms
        tv.ops = ops
        sys.modules["torchvision"] = tv
        sys.modules["torchvision.ops"] = ops
    if "pkg_resources" not in sys.modules:
        pr = types.ModuleType("pkg_resources")

        def _parse_version(v):
            # int-only tuples ('1.9.0+cpu' against '1.9.0'): each part
            # contributes its leading digits
            import re

            parts = []
            for x in str(v).split("."):
                m = re.match(r"\d+", x)
                parts.append(int(m.group()) if m else 0)
            return tuple(parts)

        pr.parse_version = _parse_version
        pr.parse_requirements = lambda f: iter(())
        pr.require = lambda r: None
        sys.modules["pkg_resources"] = pr


def import_reference(module_name: str, root: Optional[str] = None):
    """Import a module of the reference tree (``models.detector.yolov3``)
    from ``root``, by default ``$PODTPU_REFERENCE_ROOT``."""
    root = root or REFERENCE_ROOT
    if not root:
        raise ValueError("no reference checkout: set PODTPU_REFERENCE_ROOT")
    install_reference_shims()
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module(module_name)
